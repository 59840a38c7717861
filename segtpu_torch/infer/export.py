"""Serving export: the fitted model as a self-contained ``torch.export``
artifact (port of ``segtpu/infer/export.py``).

The whole inference graph, normalised input (N, H, W, 1) → U-Net forward
in eval mode → sigmoid (channel softmax for multiclass) → (N, H, W, C)
float32, is traced by ``torch.export`` with the weights in it:

- the artifact is a directory with ``model.pt2`` (``torch.export.save``)
  and ``meta.json`` (the JAX package's keys, plus the port's), readable
  without any model code;
- the batch is a ``torch.export.Dim`` unless ``batch`` is given, so one
  artifact serves any batch; a fixed-batch artifact refuses any other;
- the gate and the upsample are the ops ``segtpu_torch::attention_gate``
  and ``segtpu_torch::upsample2x_concat`` in the graph, so the artifact
  launches their kernels wherever it runs on a card and their plain
  versions on the CPU. Loading it needs ``segtpu_torch.kernels`` (which
  registers the ops), never ``segtpu_torch.models``;
- an artifact exported on either device loads on either (``platforms``):
  the loader moves the weights and every device the trace wrote into the
  graph, the autocast region's device type included.

Three things shape the trace. The serving module enters the compute
dtype's autocast inside its own ``forward``, because ``torch.export``
keeps an autocast entered there (a ``wrap_with_autocast`` region) and
drops one the caller holds. The trace runs with grad enabled, where the
attention gates fold their BatchNorms afresh: their no-grad fold cache,
keyed on storage pointers, is neither read nor written. And the upsample
routing (``UNetWithBackbone._fused_level``) is decided per level at a
nominal batch (``batch``, or 16) in place of the symbolic one, so the
trace adds no guard on the batch; ``meta.json`` lists the fused levels.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

import segtpu_torch.kernels  # noqa: F401  (registers the kernels' ops)
from segtpu_torch import resolve_device

FORMAT_VERSION = 1
_ARTIFACT = "model.pt2"
_META = "meta.json"
PLATFORMS = ("cpu", "cuda")
# The batch at which a symbolic-batch export decides the upsample routing:
# the serving requests' batch.
NOMINAL_BATCH = 16
# The largest batch a symbolic-batch artifact takes.
MAX_BATCH = 65535


def output_activation_name(model) -> str:
    """'sigmoid' for binary heads, 'softmax' for n_classes > 1: recorded
    in meta.json so ServingModel decodes masks the right way."""
    return "softmax" if getattr(model, "n_classes", 1) > 1 else "sigmoid"


class _Serving(torch.nn.Module):
    """(N, H, W, 1) normalised input → (N, H, W, C) float32 probabilities
    (or logits), the model's forward under the compute dtype's autocast."""

    def __init__(self, model, with_sigmoid: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.with_sigmoid = with_sigmoid
        self.softmax = getattr(model, "n_classes", 1) > 1
        self.compute_dtype = compute_dtype
        self.param_dtype = next(model.parameters()).dtype

    def forward(self, x):
        x = x.to(self.param_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        if self.compute_dtype == self.param_dtype:
            logits = self.model(x)
        else:
            with torch.autocast(x.device.type, dtype=self.compute_dtype):
                logits = self.model(x)
        logits = logits.float().permute(0, 2, 3, 1)
        if not self.with_sigmoid:
            return logits
        if self.softmax:
            return torch.softmax(logits, dim=-1)
        return torch.sigmoid(logits)


def make_serving_fn(model, with_sigmoid: bool = True,
                    compute_dtype: Optional[torch.dtype] = None):
    """The inference graph served in production as a module: the model in
    eval mode (running BatchNorm statistics) and the output activation the
    live API applies (``with_sigmoid`` keeps the JAX package's name and
    means "apply the model's output activation"; False gives raw logits),
    computed under autocast to ``compute_dtype`` (default: the parameters'
    dtype, no autocast)."""
    model.eval()
    dt = compute_dtype or next(model.parameters()).dtype
    return _Serving(model, with_sigmoid, dt).eval()


def export_serving(model, img_size: Tuple[int, int],
                   batch: Optional[int] = None, dtype=torch.float32,
                   platforms: Optional[Sequence[str]] = None,
                   with_sigmoid: bool = True,
                   compute_dtype: Optional[torch.dtype] = None):
    """Export the model's serving graph on the model's device; returns the
    ``torch.export.ExportedProgram``.

    ``batch=None`` (default) exports a symbolic batch: the artifact takes
    any batch size. ``dtype`` is the input's dtype; ``platforms`` the
    devices the artifact is meant for (default both); ``compute_dtype``
    the autocast dtype of the forward (default the parameters')."""
    return _export(model, img_size, batch, dtype, platforms, with_sigmoid,
                   compute_dtype)[0]


def _export(model, img_size, batch, dtype, platforms, with_sigmoid,
            compute_dtype):
    """(ExportedProgram, the decoder levels whose upsample it fuses)."""
    _platforms(platforms)
    serve = make_serving_fn(model, with_sigmoid=with_sigmoid,
                            compute_dtype=compute_dtype)
    dev = next(model.parameters()).device
    x = torch.zeros((2 if batch is None else int(batch), *img_size, 1),
                    dtype=dtype, device=dev)
    # a symbolic batch up to CUDA's 65535 grid rows, which some of the
    # card's kernels index by batch (torch 2.11's trace guards on it)
    dynamic = None if batch is not None else (
        {0: torch.export.Dim("batch", max=MAX_BATCH)},)
    routing = model.routing_at_batch(NOMINAL_BATCH if batch is None
                                     else int(batch))
    # grad enabled: the gates fold afresh instead of reading their no-grad
    # cache (whose key reads storage pointers, which fake tensors lack)
    with routing as fused, torch.enable_grad():
        ep = torch.export.export(serve, (x,), dynamic_shapes=dynamic)
    return ep, sorted(fused)


def _platforms(platforms) -> list:
    out = list(PLATFORMS if platforms is None else platforms)
    bad = [p for p in out if p not in PLATFORMS]
    if bad or not out:
        raise ValueError(f"platforms must be a non-empty subset of "
                         f"{PLATFORMS}; got {platforms!r}")
    return out


def save_serving(path: str, model, img_size: Tuple[int, int],
                 batch: Optional[int] = None, dtype=torch.float32,
                 platforms: Optional[Sequence[str]] = None,
                 compute_dtype: Optional[torch.dtype] = None) -> str:
    """Export and write the serving artifact directory; returns ``path``."""
    ep, fused = _export(model, img_size, batch, dtype, platforms, True,
                        compute_dtype)
    os.makedirs(path, exist_ok=True)
    torch.export.save(ep, os.path.join(path, _ARTIFACT))
    activation = output_activation_name(model)
    cdt = compute_dtype or next(model.parameters()).dtype
    meta = {
        "format_version": FORMAT_VERSION,
        "img_size": list(img_size),
        "batch": batch,
        "dtype": str(dtype).removeprefix("torch."),
        "platforms": _platforms(platforms),
        "activation": activation,
        "n_classes": int(getattr(model, "n_classes", 1)),
        "input": "normalized float (N, H, W, 1), values in [0, 1]",
        "output": f"{activation} probabilities (N, H, W, n_classes) "
                  f"float32",
        "compute_dtype": str(cdt).removeprefix("torch."),
        "exported_on": next(model.parameters()).device.type,
        "fused_upsample_levels": fused,
        "routing_batch": NOMINAL_BATCH if batch is None else int(batch),
        "torch": torch.__version__,
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _retarget(ep, device: torch.device):
    """``ep`` with its weights, constants and every device its graph
    names on ``device``, and its autocast regions for ``device``'s type:
    a trace on the CPU writes ``cpu`` into tensor-metadata asserts and into
    the ``wrap_with_autocast`` region, whose autocast would otherwise leave
    the card's ops in f32."""
    from torch.export.passes import move_to_device_pass
    ep = move_to_device_pass(ep, str(device))
    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if (node.op == "call_function"
                    and "wrap_with_autocast" in str(node.target)
                    and node.args[0] != device.type):
                node.args = (device.type, *node.args[1:])
        gm.recompile()
    return ep


class ServingModel:
    """A deployed artifact: loads the exported graph and serves batches.

    Needs torch, numpy and ``segtpu_torch.kernels`` (for the ops), no
    model code and no checkpoint::

        sm = ServingModel("artifact_dir", device="cuda")
        probs = sm.predict_proba(batch)       # any batch size
        masks = sm.predict(batch)             # 0.5-threshold uint8
    """

    def __init__(self, path: str, device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(path, _META)) as f:
            self.meta: Dict = json.load(f)
        if self.meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta['format_version']} is newer "
                f"than this library supports ({FORMAT_VERSION})")
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(f"the artifact was exported for "
                             f"{self.meta['platforms']}, not "
                             f"{self.device.type}")
        ep = torch.export.load(os.path.join(path, _ARTIFACT))
        self._module = _retarget(ep, self.device).module()
        self.img_size = tuple(self.meta["img_size"])
        self.batch = self.meta.get("batch")
        self.activation = self.meta.get("activation", "sigmoid")
        self.n_classes = int(self.meta.get("n_classes", 1))
        self._in_dtype = getattr(torch, self.meta["dtype"])
        self._tiled_cache: Dict = {}

    def _call(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._module(x.to(self._in_dtype))

    def predict_proba(self, images) -> np.ndarray:
        """(N, H, W[, 1]) normalised float images → (N, H, W, C) float32
        probabilities (sigmoid, or channel softmax for multiclass
        artifacts: ``meta["activation"]``)."""
        x = np.asarray(images)
        if x.ndim == 3:
            x = x[..., None]
        if tuple(x.shape[1:3]) != self.img_size:
            raise ValueError(
                f"expected {self.img_size} images, got {x.shape[1:3]}: "
                f"resize/preprocess to the exported size first")
        if x.ndim != 4 or x.shape[-1] != 1:
            raise ValueError(
                f"expected grayscale (N, H, W[, 1]) input, got {x.shape}: "
                f"the artifact was exported for 1-channel images")
        if self.batch is not None and x.shape[0] != self.batch:
            raise ValueError(f"the artifact was exported for a fixed batch "
                             f"of {self.batch}; got {x.shape[0]}")
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._call(t).cpu().numpy()

    def predict(self, images, threshold: float = 0.5) -> np.ndarray:
        """Binary artifacts: masks at ``threshold`` (the reference's 0.5).
        Multiclass artifacts: the softmax argmax class per pixel, (N, H,
        W, 1) uint8; ``threshold`` does not apply."""
        return self._decode(self.predict_proba(images), threshold)

    def _decode(self, probs: np.ndarray, threshold: float) -> np.ndarray:
        if self.activation == "softmax":
            return np.argmax(probs, axis=-1).astype(np.uint8)[..., None]
        return (probs > threshold).astype(np.uint8)

    # ---- whole-slide serving: tiled inference on the artifact ----------

    def _tiled_fn(self, overlap: int, mode: str, batch_tiles):
        """A (cached) tiled predictor over a request's images whose tile
        forward is the artifact itself.

        The artifact's spatial size is fixed at export, so the tile grid
        derives from it: halo mode crops ``overlap//2`` of context per
        side off each ``img_size`` forward (output grid ``img_size −
        2·(overlap//2)``); blend mode overlap-adds whole ``img_size``
        tiles of probabilities. The tiles of all images of a request run
        together in each forward (the artifact's batch is symbolic)."""
        key = (int(overlap), mode, batch_tiles)
        fn = self._tiled_cache.get(key)
        if fn is not None:
            return fn
        s0, s1 = self.img_size
        if s0 != s1:
            raise ValueError(
                f"tiled serving needs a square artifact, got img_size "
                f"{self.img_size}: re-export at a square tile size")
        from segtpu_torch.infer import tiled
        if mode == "halo":
            halo = int(overlap) // 2
            tile = s0 - 2 * halo
            if halo <= 0 or tile <= 0:
                raise ValueError(
                    f"halo overlap {overlap} is invalid for a {s0}² "
                    f"artifact (need 0 < overlap//2 < {s0 // 2})")
            # the artifact pins the model input to s0, so the tile is the
            # derived size and the stride-32 halo rounding must not move it
            fn = tiled._halo_many(self._call, tile, halo, batch_tiles)
        elif mode == "blend":
            fn = tiled.make_tiled_predictor_many(
                self._call, tile=s0, overlap=int(overlap),
                batch_tiles=batch_tiles, mode="blend")
        else:
            raise ValueError(f"mode must be 'halo' or 'blend', got {mode!r}")
        self._tiled_cache[key] = fn
        return fn

    def predict_proba_tiled(self, images, overlap: int = 32,
                            mode: str = "halo",
                            batch_tiles=None) -> np.ndarray:
        """(N, H, W[, 1]) images of any spatial size → (N, H, W, C)
        probabilities by sliding-window tiling over the fixed-size
        artifact. ``mode="halo"`` (default, the whole-slide throughput
        preset): a non-overlapping output grid, each forward sees
        ``overlap//2`` pixels of context per side and only the centre crop
        is kept, so the result is the artifact's own output tile by tile.
        ``mode="blend"``: cosine-ramp overlap-add of probabilities,
        smoother seams."""
        x = np.asarray(images)
        if x.ndim == 3:
            x = x[..., None]
        if x.ndim != 4 or x.shape[-1] != 1:
            raise ValueError(
                f"expected grayscale (N, H, W[, 1]) input, got {x.shape}")
        fn = self._tiled_fn(overlap, mode, batch_tiles)
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with torch.inference_mode():
            return fn(t.to(self._in_dtype)).cpu().numpy()

    def predict_tiled(self, images, threshold: float = 0.5,
                      overlap: int = 32, mode: str = "halo",
                      batch_tiles=None) -> np.ndarray:
        """Tiled counterpart of ``predict``: binary masks at ``threshold``
        (or per-pixel argmax class ids for softmax artifacts)."""
        return self._decode(self.predict_proba_tiled(
            images, overlap=overlap, mode=mode, batch_tiles=batch_tiles),
            threshold)


def load_serving(path: str, device="cuda") -> ServingModel:
    return ServingModel(path, device=device)
