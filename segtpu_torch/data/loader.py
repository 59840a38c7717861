"""Device-resident dataset and batches (port of
``segtpu/data/loader.py``).

The whole dataset lives on the device as (N, 1, S, S) float32 tensors,
built once by ``CellSegmentationDataset.materialize`` from image paths
(decode, resize, normalise); an epoch's batches are a device-side
permutation (``torch.randperm`` from an explicit ``torch.Generator``)
split into full batches plus a remainder.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.data.preprocess import (load_canonical,
                                          normalize_canonical,
                                          scale_canonical)


class CellSegmentationDataset:
    """Path-holding dataset with microscopy normalisation (reference:
    dataset.py:17-66) on ``device`` (default ``cuda``; raises without it
    unless ``device='cpu'``). ``materialize()`` builds the device tensors
    once; ``__getitem__`` gives one sample as numpy, for inspection."""

    def __init__(self, image_paths: Sequence[str], mask_paths: Sequence[str],
                 img_size: Tuple[int, int] = (256, 256),
                 normalize: bool = True,
                 canonical: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 *, device="cuda"):
        self.image_paths = list(image_paths)
        self.mask_paths = list(mask_paths)
        self.img_size = tuple(img_size)
        self.normalize = normalize
        self.device = resolve_device(device)
        self._canonical = canonical   # optional resized uint8 (imgs, masks)
        self._arrays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __len__(self) -> int:
        return len(self.image_paths) if self._canonical is None \
            else len(self._canonical[0])

    def materialize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images (N, 1, S, S) float32 in [0, 1], masks (N, 1, S, S)
        float32 in {0, 1}) on the device."""
        if self._arrays is None:
            if self._canonical is not None:
                ci, cm = self._canonical
            else:
                ci, cm = load_canonical(self.image_paths, self.mask_paths,
                                        self.img_size, device=self.device)
            ci = torch.as_tensor(np.asarray(ci)).to(self.device)
            imgs = normalize_canonical(ci) if self.normalize \
                else scale_canonical(ci)
            cm = torch.as_tensor(np.asarray(cm)).to(self.device)
            self._arrays = (imgs, (cm > 0).to(torch.float32)[:, None])
        return self._arrays

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        imgs, masks = self.materialize()
        return imgs[idx].cpu().numpy(), masks[idx].cpu().numpy()


class DeviceDataLoader:
    """Batches over device tensors ``images``/``masks`` (N, 1, S, S).

    ``batches(generator)`` gives (full (nf, B, 1, S, S) pair, remainder
    (R, 1, S, S) pair or None); ``__iter__`` yields numpy batches.
    """

    def __init__(self, images: torch.Tensor, masks: torch.Tensor,
                 batch_size: int = 2, shuffle: bool = True, seed: int = 0):
        if images.shape[0] != masks.shape[0]:
            raise ValueError(f"images/masks length mismatch: "
                             f"{images.shape[0]} vs {masks.shape[0]}")
        if masks.device != images.device:
            raise ValueError(f"masks on {masks.device}, images on "
                             f"{images.device}")
        self.images, self.masks = images, masks
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._seed = seed
        self._epoch = 0

    @classmethod
    def from_arrays(cls, images, masks, batch_size: int = 2,
                    shuffle: bool = True, seed: int = 0, *,
                    device="cuda") -> "DeviceDataLoader":
        """Loader over (N, 1, S, S) tensors or arrays, moved to
        ``device`` (default ``cuda``; raises without CUDA unless
        ``device='cpu'``)."""
        dev = resolve_device(device)
        return cls(torch.as_tensor(images).to(dev),
                   torch.as_tensor(masks).to(dev), batch_size, shuffle, seed)

    @property
    def device(self) -> torch.device:
        return self.images.device

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    def __len__(self) -> int:  # number of batches (DataLoader parity)
        return -(-self.n // self.batch_size)

    def batches(self, generator: Optional[torch.Generator] = None):
        """Shuffled (on the device) full-batch stack + remainder. Without
        a generator the loader seeds one from ``seed`` + its epoch count."""
        n, b = self.n, self.batch_size
        imgs, msks = self.images, self.masks
        if self.shuffle:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(
                    self._seed + self._epoch)
                self._epoch += 1
            perm = torch.randperm(n, generator=generator, device=self.device)
            imgs, msks = imgs[perm], msks[perm]
        nf = n // b
        full = (imgs[: nf * b].reshape(nf, b, *imgs.shape[1:]),
                msks[: nf * b].reshape(nf, b, *msks.shape[1:]))
        rem = (imgs[nf * b:], msks[nf * b:]) if n % b else None
        return full, rem

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        (fi, fm), rem = self.batches()
        fi, fm = fi.cpu().numpy(), fm.cpu().numpy()
        for i in range(fi.shape[0]):
            yield fi[i], fm[i]
        if rem is not None:
            yield rem[0].cpu().numpy(), rem[1].cpu().numpy()


def prepare_data(image_paths: Sequence[str], mask_paths: Sequence[str],
                 batch_size: int = 2, img_size: Tuple[int, int] = (256, 256),
                 shuffle: bool = True,
                 canonical: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 *, device="cuda") -> DeviceDataLoader:
    """The loader of a path list (reference: dataset.py:121-138), on
    ``device``."""
    ds = CellSegmentationDataset(image_paths, mask_paths, img_size=img_size,
                                 canonical=canonical, device=device)
    return DeviceDataLoader(*ds.materialize(), batch_size=batch_size,
                            shuffle=shuffle)
