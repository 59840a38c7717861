"""Row-sharded (halo-exchange) inference of one large image (port of
``segtpu/parallel/spatial.py``).

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
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from segtpu_torch.core.dist import all_gather_rows, batch_sharding
from segtpu_torch.infer.predict import nhwc_forward, output_activation


def _exchange(band: torch.Tensor, halo: int, group):
    """(rows from the rank above, rows from the rank below) of ``band``
    (h, W, C): each rank sends its top ``halo`` rows up and its bottom
    ones down; the first and last ranks replicate their edge row."""
    n, r = group.size(), group.rank()
    h = band.shape[0]
    host = dist.get_backend(group) == "gloo" and band.device.type != "cpu"
    stage = (lambda t: t.cpu()) if host else (lambda t: t)
    up, down = stage(band[:halo].contiguous()), \
        stage(band[h - halo:].contiguous())
    from_above = torch.empty_like(down) if r > 0 else None
    from_below = torch.empty_like(up) if r < n - 1 else None
    ops = []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, up, peer, group),
                dist.P2POp(dist.irecv, from_above, peer, group)]
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, down, peer, group),
                dist.P2POp(dist.irecv, from_below, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
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
