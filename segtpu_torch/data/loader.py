"""Device-resident dataset batches (port of ``DeviceDataLoader`` in
``segtpu/data/loader.py``).

The whole dataset lives on the device as (N, 1, S, S) float32 tensors;
an epoch's batches are a device-side permutation (``torch.randperm`` from
an explicit ``torch.Generator``) split into full batches plus a
remainder. The path-holding ``CellSegmentationDataset`` and
``prepare_data`` wait for the port's data layer (ROADMAP A12).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from segtpu_torch import resolve_device


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
