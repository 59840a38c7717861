"""Row-sharded (halo-exchange) inference of one large image (port of
``segtpu/parallel/spatial.py``), and the row bands of training on a
(data × spatial) mesh.

The image is cut into N row bands, one per rank of the mesh axis; each
rank holds an ``(H/N, W)`` band, receives ``halo`` rows from each
neighbour by point-to-point sends and receives
(``torch.distributed.batch_isend_irecv``; never a gather of the image),
runs the model on its haloed band and keeps the centre crop. The image's
own top and bottom edges are padded by edge replication, as the JAX
package does. The result equals the dense forward wherever the model's
receptive radius is at most ``halo``.

Per forward each rank pair moves 2·halo·W·C values, whatever N. On a
gloo group (two ranks on one card) the halo rows go through host memory
explicitly; NCCL takes them on the device.

Training on a batch placed over ``("data", "spatial")`` (``Shard(0)``
and ``Shard(2)``, the counterpart of the JAX package's
``P("data", "spatial")``, where GSPMD cuts each convolution along the
rows) runs every layer on the bands (``Bands``, ``on_bands``): each layer
whose window spans more than one row takes exactly the rows it needs
from the neighbouring bands, layer by layer, with its own padding (zeros
for a conv, −inf for the max-pool) at the images' edges; the channel
attention pools the whole image; the BatchNorms count the global
height. So the bands' outputs are the rows of the whole image's, and the
step equals the single-device step on the whole batch. Each band is
``STRIDE``-aligned, so that every level of the encoders cuts at a row
that the whole image's forward cuts at too.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from segtpu_torch.core.dist import (all_gather_rows, all_reduce_sum,
                                    amax_over_ranks, batch_sharding,
                                    exchange_rows, gather_rows, halo_rows)
from segtpu_torch.infer.predict import nhwc_forward, output_activation
from segtpu_torch.models.attention import ChannelAttention
from segtpu_torch.models.backbones import Conv2d, MaxPool

# The encoders' output stride: a band height must be a multiple of it.
STRIDE = 32
# The layers that run on bands (their ``bands`` attribute).
BAND_LAYERS = (Conv2d, MaxPool, ChannelAttention)


class Bands:
    """Training's view of its images' rows on the ranks of ``group``:
    each rank holds a band of ``height // group.size()`` of their
    ``height`` rows, top to bottom in rank order. The band height must be
    a multiple of ``STRIDE``; any other is refused (nothing is padded or
    cropped around it)."""

    def __init__(self, group, height: int):
        n = group.size()
        if height % n or (height // n) % STRIDE:
            raise ValueError(
                f"row bands: {height} image rows over {n} ranks of the "
                f"spatial axis give bands of {height / n:g} rows; a band "
                f"must be a whole multiple of {STRIDE} rows (the encoders' "
                f"stride)")
        self.group, self.height, self.n = group, int(height), n

    def pad_rows(self, x: torch.Tensor, kernel: int, stride: int,
                 padding: int, dilation: int = 1,
                 fill: float = 0.0) -> torch.Tensor:
        """``x`` (N, C, h, W) with the halo rows a window of ``kernel``
        rows (``stride``, ``padding`` on top, ``dilation``) needs on this
        band: ``padding`` rows on top and what the window reaches past
        the bottom row, from the neighbours' bands, ``fill`` at the
        images' edges. The layer then runs with no row padding."""
        if x.shape[2] % stride:
            raise ValueError(f"row bands: a band of {x.shape[2]} rows at "
                             f"stride {stride}")
        bottom = max(0, dilation * (kernel - 1) + 1 - stride - padding)
        return halo_rows(x, padding, bottom, fill, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over dims (2, 3) of the whole images (N, C, 1, 1): the
        bands' sums (in float32 at least) over the global H·W."""
        xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
        total = all_reduce_sum(xf.sum((2, 3), keepdim=True), self.group)
        return (total / (self.n * x.shape[2] * x.shape[3])).to(x.dtype)

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over dims (2, 3) of the whole images."""
        return amax_over_ranks(x, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole images of the bands ``t`` (..., h, W), on every rank,
        with autograd (each rank's backward keeps its own band)."""
        return gather_rows(t.movedim(-2, 0), self.height,
                           self.group).movedim(0, -2)


def _spans_rows(mod: nn.Module) -> bool:
    """A layer (not a band layer) whose window spans more than one row of
    its input, so that it cannot run band by band on its own."""
    if isinstance(mod, nn.Conv2d):
        return mod.kernel_size[0] > 1
    if isinstance(mod, nn.ConvTranspose2d):     # overlapping windows
        return (mod.kernel_size[0] > mod.stride[0]
                or mod.padding[0] != 0)
    return isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d, nn.AdaptiveAvgPool2d,
                            nn.AdaptiveMaxPool2d, nn.Upsample))


@contextlib.contextmanager
def on_bands(model: nn.Module, bands: Optional[Bands]):
    """Within it, ``model``'s forwards (train or eval mode) run on the row
    bands of ``bands``: every band layer (``BAND_LAYERS``) takes it; with
    ``bands`` None, nothing changes. A layer whose window spans more than
    one row and which is not a band layer is refused here, before any
    forward, rather than run on its band alone. Hold it over the backward
    too where a checkpointed forward is re-run there."""
    mods = []
    if bands is not None:
        for name, mod in model.named_modules():
            if isinstance(mod, BAND_LAYERS):
                mods.append(mod)
            elif _spans_rows(mod):
                raise ValueError(
                    f"row bands: {name} ({type(mod).__name__}) spans more "
                    f"than one row and takes no halo rows; it cannot run "
                    f"on a band")
    for mod in mods:
        mod.bands = bands
    try:
        yield
    finally:
        for mod in mods:
            mod.bands = None


def _exchange(band: torch.Tensor, halo: int, group):
    """(rows from the rank above, rows from the rank below) of ``band``
    (h, W, C): each rank sends its top ``halo`` rows up and its bottom
    ones down; the first and last ranks replicate their edge row."""
    h = band.shape[0]
    from_above, from_below = exchange_rows(band[:halo], band[h - halo:],
                                           group)
    top = band[:1].expand(halo, *band.shape[1:]) if from_above is None \
        else from_above.to(band.device)
    bottom = band[h - 1:].expand(halo, *band.shape[1:]) \
        if from_below is None else from_below.to(band.device)
    return top, bottom


def make_spatial_sharded_predictor(apply_fn: Callable, mesh: DeviceMesh,
                                   axis: str = "data", halo: int = 32):
    """A row-sharded predictor over ``mesh[axis]``.

    ``apply_fn(x: (1, h, W, C_in)) -> (1, h, W, C_out)``, NHWC tensors: a
    model forward that accepts the haloed band height ``H/N + 2·halo``
    (for the stride-32 U-Nets, ``H/N + 2·halo`` and ``W`` divisible by
    32).

    Returns ``predict(image)``: ``image`` is the whole (H, W, C_in) image
    (the same on every rank, each keeping its band) or a ``DTensor`` of
    the bands placed ``Shard(0)``; the result is this rank's output band
    as a ``DTensor`` of global shape (H, W, C_out). The rows must divide
    evenly by N, and ``halo`` be at most the band height."""
    group = mesh.get_group(axis)
    n, rank = group.size(), group.rank()
    if halo < 0:
        raise ValueError(f"halo must be ≥ 0, got {halo}")

    def predict(image) -> DTensor:
        h = image.shape[0]
        if h % n:
            raise ValueError(
                f"image rows {h} must divide evenly over {n} devices")
        if halo > h // n:
            raise ValueError(
                f"halo {halo} exceeds the per-device band height "
                f"{h // n} ({h} rows / {n} devices) — use fewer devices, "
                f"a smaller halo, or a taller image")
        hb = h // n
        band = image.to_local() if isinstance(image, DTensor) \
            else torch.as_tensor(image)[rank * hb:(rank + 1) * hb]
        if halo:
            top, bottom = _exchange(band, halo, group)
            band = torch.cat([top, band, bottom])
        out = apply_fn(band[None])[0]
        if halo:
            out = out[halo:halo + hb]
        shape = torch.Size((h, *out.shape[1:]))
        return DTensor.from_local(
            out, mesh, batch_sharding(mesh, axis), run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())

    return predict


def spatial_predict(model, state, image, mesh: DeviceMesh,
                    axis: str = "data", halo: int = 32) -> np.ndarray:
    """One-call row-sharded inference of one large image (H, W) or
    (H, W, 1) with ``state.model`` (a ``TrainState``) or, with ``state``
    None, ``model``: probabilities (H, W, n_classes) float32 on every
    rank, the bands' probabilities gathered at the end. The model runs in
    eval mode under ``inference_mode`` on the device of its parameters,
    in whatever autocast the caller holds."""
    net = state.model if state is not None else model
    p = next(net.parameters())
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    act = output_activation(net, dim=-1)
    predictor = make_spatial_sharded_predictor(
        lambda x: nhwc_forward(net, x.to(p.dtype)), mesh, axis=axis,
        halo=halo)
    net.eval()
    with torch.inference_mode():
        band = predictor(torch.from_numpy(img).to(p.device))
        probs = act(band.to_local().float())
        full = all_gather_rows(probs, band.shape[0], mesh.get_group(axis))
        return full.cpu().numpy()
