"""Tiled sliding-window inference with overlap blending (port of
``segtpu/infer/tiled.py``).

Large images (2048²-class slides) run as overlapping tiles through any
``apply_fn`` that maps an NHWC batch (B, t, t, C_in) to (B, t, t, C_out),
the JAX package's contract; images are (H, W[, C]) and a stack of them
(N, H, W, C). Two modes, as in the JAX package:

- ``"blend"``: overlapping tiles, cosine-ramp overlap-add of the outputs,
  normalised by the per-pixel weight total, which the host computes once
  per geometry;
- ``"halo"``: a non-overlapping output grid; each forward reads
  ``overlap/2`` pixels of context per side and only the centre crop is
  kept.

JAX runs the loop as a ``lax.scan`` over tile batches; here it is an eager
Python loop over batches of tiles, cut from the padded images on their
device with slices whose origins the host computed, and put back with
slice adds (blend) or slice writes (halo), so nothing waits on the device
per tile. Tiles of all images of a call are batched together
(``make_tiled_predictor_many``), so the device sees one large batch even
when each image has few tiles.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from segtpu_torch import resolve_device
from segtpu_torch.infer.predict import (model_param, nhwc_forward,
                                        output_activation)


@lru_cache(maxsize=32)
def _blend_window(tile: int, overlap: int) -> np.ndarray:
    """Separable 2-D blending window: cosine ramp of width ``overlap`` at
    each border, flat 1.0 in the interior. Overlapping windows sum to ~1
    with stride = tile - overlap."""
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(overlap) + 0.5) / overlap)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return np.outer(w, w).astype(np.float32)


def _tile_origins(size: int, tile: int, stride: int) -> np.ndarray:
    """Tile top-left offsets covering [0, size)."""
    if size <= tile:
        return np.array([0], np.int32)
    starts = list(range(0, size - tile, stride)) + [size - tile]
    return np.unique(np.array(starts, np.int32))


def _blend_weight_sum(ph: int, pw: int, tile: int, overlap: int,
                      ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Total blend weight each output pixel receives: fixed by the tile
    geometry, so computed once on the host rather than accumulated tile by
    tile on the device."""
    win = _blend_window(tile, overlap)
    wsum = np.zeros((ph, pw, 1), np.float32)
    for oy in ys:
        for ox in xs:
            wsum[oy:oy + tile, ox:ox + tile, 0] += win
    return np.maximum(wsum, 1e-8)


#: ``batch_tiles=None`` resolves to min(n_tiles, _AUTO_BATCH_CAP): one
#: forward per image when the tile count is modest (routing halo mode to
#: its reshape assembly), capped so that large images cannot blow up peak
#: device memory.
_AUTO_BATCH_CAP = 32
#: blend geometries (image size, device) whose weights a predictor keeps
_GEOMETRIES = 8


def _tile_batches(origins: np.ndarray, batch_tiles: Optional[int]):
    """Origins (n, 2) cut into equal batches: ``bt = ceil(n / ceil(n /
    cap))`` with cap = ``batch_tiles`` (default min(n, 32)), the last
    batch padded with duplicates of the last origin. Returns (origins
    (n_batches, bt, 2), valid (n_batches, bt) with 0 on the duplicates)."""
    n = origins.shape[0]
    cap = batch_tiles if batch_tiles is not None else min(n, _AUTO_BATCH_CAP)
    n_batches = -(-n // cap)
    bt = -(-n // n_batches)
    n_pad = (-n) % bt
    origins = np.concatenate([origins, np.tile(origins[-1:], (n_pad, 1))])
    valid = np.concatenate([np.ones(n, np.float32),
                            np.zeros(n_pad, np.float32)])
    return origins.reshape(-1, bt, 2), valid.reshape(-1, bt)


def _pad(images: torch.Tensor, top: int, bottom: int, left: int,
         right: int, mode: str) -> torch.Tensor:
    """numpy's ``reflect``/``edge`` padding of (N, H, W, C) images."""
    if not (top or bottom or left or right):
        return images
    x = images.permute(0, 3, 1, 2)
    x = F.pad(x, (left, right, top, bottom),
              mode="reflect" if mode == "reflect" else "replicate")
    return x.permute(0, 2, 3, 1)


def _gather(padded: torch.Tensor, orgs: np.ndarray, size: int
            ) -> torch.Tensor:
    """The (N·bt, size, size, C) NHWC-contiguous batch of each image's
    windows at ``orgs`` (bt, 2), image-major."""
    tiles = torch.stack([padded[:, oy:oy + size, ox:ox + size]
                         for oy, ox in orgs.tolist()], dim=1)
    return tiles.reshape(-1, *tiles.shape[2:])


def _as_images(images) -> torch.Tensor:
    x = torch.as_tensor(images)
    if x.dim() != 4:
        raise ValueError(f"expected (N, H, W, C) images, got shape "
                         f"{tuple(x.shape)}")
    return x


def _blend_many(apply_fn: Callable, tile: int, overlap: int,
                batch_tiles: Optional[int]):
    stride = tile - overlap
    geometry = {}

    def predict_many(images) -> torch.Tensor:
        images = _as_images(images)
        n_img, h, w, _ = images.shape
        ph, pw = max(tile, h), max(tile, w)
        if ph > h or pw > w:
            # reflect padding needs pad width < dim; images smaller than
            # about half the tile take edge replication
            pad_mode = "reflect" if (ph - h < h and pw - w < w) else "edge"
            images = _pad(images, 0, ph - h, 0, pw - w, pad_mode)
        ys = _tile_origins(ph, tile, stride)
        xs = _tile_origins(pw, tile, stride)
        origins = np.stack(np.meshgrid(ys, xs, indexing="ij"),
                           axis=-1).reshape(-1, 2)
        batches, valid = _tile_batches(origins, batch_tiles)
        dev = images.device
        key = (ph, pw, str(dev))
        if key not in geometry:
            # the window, the batches' validity (duplicates weigh 0) and
            # the weight total: made once per geometry, copied to the
            # device once, the last _GEOMETRIES kept
            if len(geometry) >= _GEOMETRIES:
                geometry.pop(next(iter(geometry)))
            geometry[key] = tuple(torch.from_numpy(a).to(dev) for a in (
                _blend_window(tile, overlap), valid,
                _blend_weight_sum(ph, pw, tile, overlap, ys, xs)))
        window, valid, wsum = geometry[key]
        acc = None
        for b, orgs in enumerate(batches):
            logits = apply_fn(_gather(images, orgs, tile))
            logits = logits.reshape(n_img, len(orgs), *logits.shape[1:])
            # one window·validity product for the whole batch
            logits = logits * (window[None, :, :, None]
                               * valid[b][:, None, None, None])
            if acc is None:
                acc = torch.zeros((n_img, ph, pw, logits.shape[-1]),
                                  dtype=torch.float32, device=dev)
            for i, (oy, ox) in enumerate(orgs.tolist()):
                acc[:, oy:oy + tile, ox:ox + tile] += logits[:, i]
        return (acc / wsum)[:, :h, :w]

    return predict_many


def _halo_many(apply_fn: Callable, tile: int, halo: int,
               batch_tiles: Optional[int]):
    """Halo tiling: a non-overlapping ``tile``-sized output grid; each
    forward sees ``halo`` pixels of extra context per side and only the
    centre crop is kept. No blend arithmetic, disjoint writes, redundancy
    ((tile + 2·halo)/tile)²."""
    tin = tile + 2 * halo

    def predict_many(images) -> torch.Tensor:
        images = _as_images(images)
        n_img, h, w, _ = images.shape
        ny, nx = -(-h // tile), -(-w // tile)
        ph, pw = ny * tile, nx * tile
        pad_mode = ("reflect" if (ph - h + halo < h and pw - w + halo < w
                                  and halo < h and halo < w) else "edge")
        padded = _pad(images, halo, ph - h + halo, halo, pw - w + halo,
                      pad_mode)
        origins = np.stack(np.meshgrid(np.arange(ny) * tile,
                                       np.arange(nx) * tile,
                                       indexing="ij"), -1).reshape(-1, 2)
        batches, _ = _tile_batches(origins, batch_tiles)

        def forward_batch(orgs):
            # an origin is in output coordinates; the padded image is
            # offset by the halo, so the input window starts at it exactly
            out = apply_fn(_gather(padded, orgs, tin))
            out = out.reshape(n_img, len(orgs), *out.shape[1:])
            return out[:, :, halo:halo + tile, halo:halo + tile]

        if len(batches) == 1:
            # one forward holds every tile (no duplicates then): the
            # disjoint grid assembles by transpose and reshape
            crop = forward_batch(batches[0])
            c = crop.shape[-1]
            out = crop.reshape(n_img, ny, nx, tile, tile, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n_img, ph, pw, c).float()
            return out[:, :h, :w]
        acc = None
        for orgs in batches:
            crop = forward_batch(orgs)
            if acc is None:
                acc = torch.zeros((n_img, ph, pw, crop.shape[-1]),
                                  dtype=torch.float32, device=images.device)
            # duplicates rewrite the same disjoint region with the same
            # values
            for i, (oy, ox) in enumerate(orgs.tolist()):
                acc[:, oy:oy + tile, ox:ox + tile] = crop[:, i]
        return acc[:, :h, :w]

    return predict_many


def _check_mode(mode: str) -> None:
    if mode not in ("blend", "halo"):
        raise ValueError(f"mode must be 'blend' or 'halo', got {mode!r}")


def _halo(tile: int, overlap: int) -> int:
    halo = overlap // 2
    if tile % 32 == 0 and halo:
        # keep the model input (tile + 2·halo) divisible by the U-Net's
        # total stride (32): rounding up only ever adds context
        halo = -(-halo // 16) * 16
    return halo


def _sharded_apply(apply_fn: Callable, axis: str) -> Callable:
    """``apply_fn`` over the ranks of ``axis`` of the mesh current at the
    call."""
    from segtpu_torch.core.dist import (all_gather_rows, current_mesh,
                                        process_rows)

    def apply(x: torch.Tensor) -> torch.Tensor:
        mesh = current_mesh()
        if mesh is None or axis not in (mesh.mesh_dim_names or ()):
            raise RuntimeError(
                f"shard_tiles_axis={axis!r} needs a current mesh with that "
                f"dimension: call the predictor inside `with mesh:` "
                f"(segtpu_torch.core.dist.create_mesh)")
        group = mesh.get_group(axis)
        n, bt = group.size(), x.shape[0]
        padded = -(-bt // n) * n
        if padded > bt:
            x = torch.cat([x, x[-1:].expand(padded - bt, *x.shape[1:])])
        mine = x[process_rows(padded, n, group.rank())]
        return all_gather_rows(apply_fn(mine), padded, group)[:bt]

    return apply


def make_tiled_predictor_many(apply_fn: Callable, tile: int = 512,
                              overlap: int = 64,
                              batch_tiles: Optional[int] = None,
                              mode: str = "blend"):
    """Stream-batched tiled inference: images (N, H, W, C) → (N, H, W,
    C_out) float32, on the images' device. Each forward takes the same
    tile positions of every image, so it runs N·bt tiles (bt from
    ``batch_tiles`` as in :func:`make_tiled_predictor`)."""
    _check_mode(mode)
    if mode == "halo":
        return _halo_many(apply_fn, tile, _halo(tile, overlap), batch_tiles)
    return _blend_many(apply_fn, tile, overlap, batch_tiles)


def make_tiled_predictor(apply_fn: Callable, tile: int = 512,
                         overlap: int = 64,
                         batch_tiles: Optional[int] = None,
                         shard_tiles_axis: Optional[str] = None,
                         mode: str = "blend"):
    """A tiled predictor ``predict(image (H, W, C_in)) -> (H, W, C_out)``
    float32 on the image's device.

    ``apply_fn(x: (B, t, t, C_in)) -> (B, t, t, C_out)``, NHWC tensors,
    typically a model forward (t = ``tile`` in blend mode, ``tile +
    2·halo`` in halo mode; both must be valid model input sizes).
    ``batch_tiles=None`` auto-sizes to min(tile count, 32): one forward
    per image at 2048²-class sizes, which in halo mode also makes the
    assembly a reshape; pass an int to bound peak memory.

    ``mode``: ``"blend"`` (overlapping tiles, cosine-ramp overlap-add;
    redundancy 1.56× at 2048²/512/64) or ``"halo"`` (non-overlapping
    output grid, ``overlap/2`` context per side, rounded up to a multiple
    of 16 when ``tile`` is a multiple of 32; redundancy 1.27×; exact
    against the dense forward for any model whose receptive radius is at
    most the halo).

    ``shard_tiles_axis``: the name of a dimension of the current mesh
    (``with mesh:``, ``segtpu_torch.core.dist.create_mesh``) over whose
    ranks each tile batch is split: each rank forwards its block of tiles
    (the batch padded with copies of its last tile to a multiple of the
    ranks) and the logits are gathered, so that every rank returns the
    whole image, as the JAX package's global array."""
    _check_mode(mode)
    if shard_tiles_axis is not None:
        apply_fn = _sharded_apply(apply_fn, shard_tiles_axis)
    many = make_tiled_predictor_many(apply_fn, tile=tile, overlap=overlap,
                                     batch_tiles=batch_tiles, mode=mode)

    def predict(image) -> torch.Tensor:
        image = torch.as_tensor(image)
        if image.dim() != 3:
            raise ValueError(f"expected an (H, W, C) image, got shape "
                             f"{tuple(image.shape)}")
        return many(image[None])[0]

    return predict


def tiled_predict(model, image, tile: int = 512, overlap: int = 64,
                  batch_tiles: Optional[int] = None, tta: bool = False,
                  mode: str = "blend", *, device="cuda") -> np.ndarray:
    """One-call tiled inference on one large image (H, W) or (H, W, 1).

    Returns probabilities (H, W, n_classes) float32: blended logits through
    the sigmoid (channel softmax for multiclass). ``tta=True`` runs each
    square tile through its D4 average in probability space before
    blending (8× tile compute, the same peak memory). The model runs in
    eval mode under ``inference_mode`` on ``device``, in whatever autocast
    the caller holds."""
    dev = resolve_device(device)
    p = model_param(model, dev)
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    act = output_activation(model, dim=-1)

    def apply_fn(x):
        return nhwc_forward(model, x.to(p.dtype))

    if tta:
        from segtpu_torch.infer.tta import d4_average_apply
        apply_fn, act = d4_average_apply(apply_fn, out_transform=act), None
    predictor = make_tiled_predictor(apply_fn, tile=tile, overlap=overlap,
                                     batch_tiles=batch_tiles, mode=mode)
    model.eval()
    with torch.inference_mode():
        out = predictor(torch.from_numpy(img).to(p.device))
        if act is not None:
            out = act(out)
        return out.float().cpu().numpy()
