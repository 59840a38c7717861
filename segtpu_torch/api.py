"""High-level fit / predict / evaluate API (port of ``segtpu/api.py``).

``Segmenter`` wraps the training engine, the training loop, whole-image
inference and checkpoints behind one object, on ``device`` (default
``cuda``; raises without CUDA unless ``device='cpu'``). Inputs are lists
of image (and mask) paths, uint8 arrays (N, H, W), resized to
``img_size`` on the device where they are not at it, or, for the
predict calls, normalised float arrays (N, S, S[,1]).

``save`` writes the model's ``state_dict`` under the reference's key
names (``{name}.pt``), which ``segtpu.models.torch_convert
.load_reference_checkpoint`` reads, and a ``{name}_config.json`` sidecar
with the JAX package's keys.

``predict_proba(tta=True)`` averages over the D4 symmetries
(``infer/tta.py``), ``predict_tiled`` runs sliding-window inference on
one large image (``infer/tiled.py``), and ``export`` writes a
``torch.export`` serving artifact (``infer/export.py``) that
``ServingModel`` and the HTTP server (``infer/serve.py``) load without
the model code; each runs in the configured compute dtype.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.data.loader import DeviceDataLoader
from segtpu_torch.data.preprocess import (_round_u8, load_canonical_images,
                                          normalize_canonical)
from segtpu_torch.infer.export import save_serving
from segtpu_torch.infer.predict import predict_proba
from segtpu_torch.infer.tiled import tiled_predict
from segtpu_torch.infer.tta import tta_predict_proba
from segtpu_torch.models.torch_convert import load_pretrained
from segtpu_torch.ops.resize import resize_area
from segtpu_torch.train.engine import TrainState, get_engine
from segtpu_torch.train.loop import _materialize, _to_canonical, quick_train


class Segmenter:
    """Binary cell-segmentation model with the reference's architecture
    options behind fit/predict/evaluate.

    Example::

        seg = Segmenter(backbone="resnet34", use_attention=True)
        data = load_original_data("manual_labels", "W")
        seg.fit(data["image_paths"], data["mask_paths"],
                augmentations_per_image=3)
        masks = seg.predict(test_paths)            # (N, S, S, 1) uint8
        metrics = seg.evaluate(test_paths, test_mask_paths)
        seg.save("ckpt_dir")
    """

    def __init__(self, backbone: str = "resnet34", use_attention: bool = True,
                 n_classes: int = 1, config: Optional[Dict] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = dict(config or {})
        self.config.update({"backbone": backbone,
                            "use_attention": use_attention,
                            "n_classes": n_classes})
        self.config.setdefault("img_size", (128, 128))
        self.config.setdefault("batch_size", 4)
        self.config.setdefault("loss_fn", "combo")
        self.engine = get_engine(self.config, device=self.device)
        self.state: Optional[TrainState] = None
        self.history: Optional[Dict] = None

    # ------------------------------------------------------------- train

    def fit(self, train_images, train_masks, val_images=None, val_masks=None,
            augmentations_per_image: int = 0, **config_overrides
            ) -> "Segmenter":
        """Train with the reference's standard setup (quick_train,
        train.py:301-364) on path lists or canonical uint8 arrays, with
        ``augmentations_per_image`` augmented copies of every training
        image; with no validation split given, the last fifth (at least
        one image) is held out."""
        cfg = dict(self.config)
        cfg.update(config_overrides)
        if val_images is None:
            n = len(train_images)
            k = max(1, n // 5)
            val_images, val_masks = train_images[-k:], train_masks[-k:]
            train_images, train_masks = train_images[:-k], train_masks[:-k]
        results = quick_train(
            model=self.engine, train_images=train_images,
            train_masks=train_masks, val_images=val_images,
            val_masks=val_masks, config=cfg, device=self.device,
            augmentations_per_image=augmentations_per_image)
        self.history = results
        self.state = results["state"]
        return self

    # ----------------------------------------------------------- predict

    def _require_state(self) -> TrainState:
        if self.state is None:
            raise RuntimeError("Model is not fitted/loaded yet")
        return self.state

    def _prep_images(self, images) -> np.ndarray:
        """Paths, uint8 arrays (resized to ``img_size`` where they are not
        at it, and normalised, on the device) or preprocessed float arrays
        → (N, S, S, 1) float32 model inputs, on the host."""
        img_size = tuple(self.config["img_size"])
        if isinstance(images, str):
            raise TypeError("images must be a list of paths or an array, "
                            "not a single string")
        if len(images) == 0:
            raise ValueError("empty image set")
        if isinstance(images[0], str):
            arr = load_canonical_images(list(images), img_size,
                                        device=self.device)
        else:
            arr = np.asarray(images)
        if arr.dtype == np.uint8:
            if arr.ndim == 4:
                arr = arr[..., 0]
            x = torch.from_numpy(arr).to(self.device)
            if tuple(arr.shape[1:3]) != img_size:
                x = _round_u8(resize_area(x, img_size))
            x = normalize_canonical(x)
            return x[:, 0, :, :, None].cpu().numpy()
        if arr.ndim == 3:
            arr = arr[..., None]
        return arr.astype(np.float32)

    def predict_proba(self, images, tta: bool = False,
                      chunk: Optional[int] = None) -> np.ndarray:
        """Probability maps (N, S, S, n_classes) float32: per-pixel
        sigmoid for binary models, channel softmax for n_classes > 1, in
        the configured compute dtype. ``tta=True`` averages them over the
        exact D4 symmetries of the image plane (``infer/tta.py``): 8
        forwards per image. ``chunk``: at most ``chunk`` images per
        forward."""
        state = self._require_state()
        x = self._prep_images(images)
        step = x.shape[0] if chunk is None else int(chunk)
        fn = tta_predict_proba if tta else predict_proba
        with self.engine.autocast():
            return np.concatenate([
                fn(state.model, x[i:i + step], device=self.device)
                for i in range(0, x.shape[0], step)])

    def predict(self, images, threshold: float = 0.5,
                post_process_min_size: Optional[int] = None,
                tta: bool = False, chunk: Optional[int] = None) -> np.ndarray:
        """Predicted masks (N, S, S, 1) uint8: thresholded probabilities
        for binary models (optionally with connected-component cleanup),
        the softmax argmax for n_classes > 1."""
        probs = self.predict_proba(images, tta=tta, chunk=chunk)
        if int(self.config.get("n_classes", 1)) > 1:
            if post_process_min_size is not None:
                raise ValueError(
                    "post_process_min_size removes small BINARY components; "
                    "for multiclass, post-process the argmax mask per class")
            return np.argmax(probs, axis=-1).astype(np.uint8)[..., None]
        masks = (probs > threshold).astype(np.uint8)
        if post_process_min_size is not None:
            from segtpu_torch.metrics import post_process
            masks = np.stack([post_process(m[..., 0], post_process_min_size)
                              for m in masks])[..., None]
        return masks

    def predict_tiled(self, image, tile: int = 512, overlap: int = 64,
                      batch_tiles: Optional[int] = None, tta: bool = False,
                      mode: str = "blend") -> np.ndarray:
        """Sliding-window inference on one large normalised image (H, W)
        or (H, W, 1): probabilities (H, W, n_classes) float32.
        ``mode="blend"`` (default) cosine-blends overlapping tiles;
        ``mode="halo"`` keeps each tile's centre crop of a wider input
        window (less compute). ``tta=True`` D4-averages each tile."""
        state = self._require_state()
        with self.engine.autocast():
            return tiled_predict(state.model, image, tile=tile,
                                 overlap=overlap, batch_tiles=batch_tiles,
                                 tta=tta, mode=mode, device=self.device)

    # ---------------------------------------------------------- evaluate

    def evaluate(self, images, masks) -> Dict[str, float]:
        """Sample-weighted loss and confusion metrics on a dataset (paths
        or canonical uint8 arrays; train.py:71-112); macro-averaged for
        n_classes > 1."""
        state = self._require_state()
        ci, cm = _to_canonical(images, masks, tuple(self.config["img_size"]),
                               device=self.device)
        imgs, m = _materialize(ci, cm, int(self.config.get("n_classes", 1)),
                               device=self.device)
        loader = DeviceDataLoader(imgs, m, self.config["batch_size"],
                                  shuffle=False)
        return self.engine.run_eval_epoch(state, loader)

    def sweep_threshold(self, images, masks, thresholds=None,
                        metric: str = "iou", tta: bool = False,
                        chunk: Optional[int] = None) -> Dict:
        """Metrics at every binarisation threshold and the
        ``metric``-optimal one (``segtpu_torch.metrics.threshold``);
        inputs as :meth:`evaluate`."""
        self._require_state()
        if int(self.config.get("n_classes", 1)) != 1:
            raise ValueError("sweep_threshold is a binary-segmentation "
                             "helper (n_classes == 1)")
        ci, cm = _to_canonical(images, masks, tuple(self.config["img_size"]),
                               device=self.device)
        imgs, m = _materialize(ci, cm, device=self.device)
        if chunk is None:
            chunk = int(self.config.get("batch_size", 4))
        probs = self.predict_proba(imgs[:, 0, :, :, None].cpu().numpy(),
                                   tta=tta, chunk=chunk)
        from segtpu_torch.metrics.threshold import sweep_thresholds
        return sweep_thresholds(probs, m.permute(0, 2, 3, 1).cpu(),
                                thresholds=thresholds, metric=metric)

    # ------------------------------------------------------- persistence

    def save(self, path: str, name: str = "segmenter") -> str:
        """``{name}.pt``: the model's state_dict (reference key names);
        ``{name}_config.json``: the config, so ``from_checkpoint`` rebuilds
        the architecture."""
        state = self._require_state()
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, f"{name}.pt")
        torch.save({k: v.detach().cpu()
                    for k, v in state.model.state_dict().items()}, out)
        cfg = {k: (list(v) if isinstance(v, tuple) else v)
               for k, v in self.config.items()
               if isinstance(v, (str, int, float, bool, list, tuple))
               or v is None}
        with open(os.path.join(path, f"{name}_config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        return out

    # sidecar keys load() restores: what determines the architecture
    # (the model keys get_engine reads) and img_size; training settings
    # stay the caller's
    _ARCH_KEYS = ("backbone", "use_attention", "n_classes", "img_size",
                  "dtype", "final_bias_prior", "fuse", "remat",
                  "reparam_in_train", "fuse_gate")

    def load(self, path: str, name: str = "segmenter") -> "Segmenter":
        """Restore weights saved by :meth:`save`; a sidecar that names
        another architecture rebuilds the engine to match."""
        cfg_path = os.path.join(path, f"{name}_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            if "img_size" in cfg:
                cfg["img_size"] = tuple(cfg["img_size"])
            self.config.update({k: cfg[k] for k in self._ARCH_KEYS
                                if k in cfg})
            self.engine = get_engine(self.config, device=self.device)
        sd = torch.load(os.path.join(path, f"{name}.pt"),
                        map_location="cpu", weights_only=True)
        model = self.engine.build_model()
        model.load_state_dict(sd, strict=True)
        self.state = TrainState(model)
        return self

    @classmethod
    def from_checkpoint(cls, path: str, name: str = "segmenter", *,
                        device="cuda") -> "Segmenter":
        """Architecture from the sidecar, weights from ``{name}.pt``."""
        cfg_path = os.path.join(path, f"{name}_config.json")
        kw = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            if "img_size" in cfg:
                cfg["img_size"] = tuple(cfg["img_size"])
            kw = {k: cfg[k] for k in ("backbone", "use_attention",
                                      "n_classes") if k in cfg}
            kw["config"] = cfg
        return cls(**kw, device=device).load(path, name=name)

    def export(self, path: str, batch: Optional[int] = None,
               dtype=torch.float32,
               platforms: Optional[Sequence[str]] = None) -> str:
        """Write a self-contained serving artifact (``torch.export``,
        weights inside, symbolic batch unless ``batch`` is given, the
        configured compute dtype's autocast inside) that
        ``segtpu_torch.infer.load_serving`` loads with no model code on
        either device of ``platforms`` (default both). Returns ``path``."""
        state = self._require_state()
        return save_serving(path, state.model,
                            tuple(self.config["img_size"]), batch=batch,
                            dtype=dtype, platforms=platforms,
                            compute_dtype=self.engine.compute_dtype)

    def load_pretrained_encoder(self, checkpoint_path: str) -> "Segmenter":
        """pretrained=True: the config's seed's fresh init with a local
        torchvision checkpoint's encoder laid over it
        (advanced_models.py:73-139), and a fresh optimizer at the config's
        learning rate and weight decay."""
        model = load_pretrained(
            self.engine.build_model(),
            torch.Generator().manual_seed(int(self.config.get("seed", 0))),
            checkpoint_path, kind="torchvision")
        opt = self.engine.make_optimizer(
            model, float(self.config.get("learning_rate", 1e-3)),
            float(self.config.get("weight_decay", 1e-5)))
        self.state = TrainState(model, opt)
        return self
