"""The ``train_folds`` kind of traffic: the K-fold cross-validation
sweep of the reference's experiments, as back-to-back folds in a closed
loop. The seed gives ``n_images`` images and masks; fold k holds out
images [k·n_val, (k+1)·n_val) for validation (k cycles over n_images /
n_val folds) and trains on the rest. A fold is one
``segtpu_torch.train.fused_run.run_training_fused`` call: ``epochs``
epochs of Adam (``learning_rate``, ``weight_decay``), the combo loss,
ReduceLROnPlateau, early stopping that cannot trigger before the last
epoch, every fold from the seed's weights and a fresh optimizer, its
epoch permutations from a generator seeded per fold.

Set-up runs fold 0 for ``CHECK_EPOCHS`` epoch through the same call, at
``CHECK_LR``: it builds and captures the runner that the window's folds
replay, and its results are the check's. The LR is a value the runner
loads at each run, not part of its graphs; a small one keeps the first
epoch's eight Adam steps from amplifying rounding (at the mix's LR an
Adam step moves each weight by about the LR whatever the sign of its
gradient, so the last bits decide the trajectory). After the window the
reference follows that fold's first epoch step by step from the same
weights and batches, and its validation forward, and the last window
fold's first epoch at the mix's LR.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, Optional

import torch

from portbench import check, data
from portbench.reference import follow

_WEIGHTS, _DATA, _CALIB = 1, 2, 3
# the set-up fold, whose results the check compares: one epoch at a small LR
CHECK_LR = 1e-5
CHECK_EPOCHS = 1


class Traffic:

    def __init__(self, model_cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.p, self.seed = model_cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.engine = None

    def _perm_seed(self, fold_run: int) -> int:
        return (self.seed * 7_919 + fold_run) % (1 << 62)

    def _split(self, k: int):
        nv = int(self.p["n_val"])
        n = self.images.shape[0]
        val = torch.arange(k * nv, (k + 1) * nv, device=self.device)
        keep = torch.ones(n, dtype=torch.bool, device=self.device)
        keep[val] = False
        train = keep.nonzero().flatten()
        return (self.images[train], self.masks[train], self.images[val],
                self.masks[val])

    # ------------------------------------------------------------ set-up

    def make_inputs(self) -> None:
        """The images, masks and weights, from the seed."""
        p, dev = self.p, self.device
        s = int(p["image_size"])
        self.images, self.masks = data.blob_images(
            data.generator(self.seed, _DATA, dev), int(p["n_images"]), s,
            p["images"], dev)
        calib, _ = data.blob_images(data.generator(self.seed, _CALIB, dev),
                                    int(p["calib_images"]), s, p["images"],
                                    dev)
        self.weights = data.make_weights(
            self.cfg, data.generator(self.seed, _WEIGHTS, dev), calib, dev)
        self.folds = int(p["n_images"]) // int(p["n_val"])

    def setup(self) -> None:
        """The inputs, the program's engine and model, and the set-up
        fold, whose results the check compares."""
        from segtpu_torch.train.engine import get_engine
        self.make_inputs()
        p, dev = self.p, self.device
        self.engine = get_engine(
            {"backbone": self.cfg["backbone"],
             "use_attention": self.cfg["use_attention"],
             "n_classes": self.cfg["n_classes"], "dtype": self.cfg["dtype"],
             "loss_fn": p["loss_fn"], "optimizer": p["optimizer"]},
            device=dev)
        self.model = self.engine.build_model()
        out = self.fold(0, CHECK_EPOCHS, self._perm_seed(0), CHECK_LR)
        self.setup_fold = self._program_epoch(out, with_weights=True)
        self.runs = 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def fold(self, k: int, epochs: int, perm_seed: int,
             lr: Optional[float] = None) -> Dict:
        """One fold: fold k's split, the seed's weights, a fresh
        optimizer, ``epochs`` epochs through the fused run at ``lr``
        (default: the mix's ``learning_rate``)."""
        from segtpu_torch.train.engine import TrainState
        from segtpu_torch.train.fused_run import run_training_fused
        p = self.p
        lr = float(p["learning_rate"]) if lr is None else lr
        self.model.load_state_dict(self.weights)
        opt = self.engine.make_optimizer(self.model, lr,
                                         float(p["weight_decay"]))
        ti, tm, vi, vm = self._split(k)
        return run_training_fused(
            self.engine, TrainState(self.model, opt), ti, tm, vi, vm,
            batch_size=int(p["batch_size"]), num_epochs=int(epochs),
            lr0=lr,
            generator=torch.Generator(self.device).manual_seed(perm_seed),
            scheduler_params=dict(p["scheduler"]),
            es_patience=int(p["early_stopping_patience"]),
            es_min_delta=float(p["early_stopping_min_delta"]))

    @torch.no_grad()
    def _program_epoch(self, out: Dict, with_weights: bool) -> Dict:
        """The program's first epoch of a fold's results: its train loss,
        and with ``with_weights`` its validation loss, the BatchNorms'
        running statistics it ends with, and per parameter the norm of
        its change (final weights against the seed's), the steps'
        gradient norms as Adam's state holds them (``follow.grad_norm``)
        and Adam's first moment itself, on the host."""
        got = {"train_loss": out["train_history"][0]["loss"]}
        if with_weights:
            got["val_loss"] = out["val_history"][0]["loss"]
            got["stats"] = {
                n: t.detach().clone() for n, t in
                out["final_state"].model.state_dict().items()
                if n.endswith(("running_mean", "running_var"))}
            opt = out["state"].optimizer
            params = dict(out["state"].model.named_parameters())
            got["change"] = {
                n: (p.detach() - self.weights[n]).norm().item()
                for n, p in out["final_state"].model.named_parameters()}
            got["grad"] = {n: follow.grad_norm(opt.state.get(p, {}))
                           for n, p in params.items()}
            got["moment"] = {n: opt.state[p]["exp_avg"].detach().cpu()
                             for n, p in params.items()}
        return got

    # ------------------------------------------------------------ window

    def window(self, seconds: float, tracer, traced_units: int = 0) -> Dict:
        """Folds back to back until ``seconds`` have passed; the first
        ``traced_units`` folds profiled."""
        p = self.p
        epochs = int(p["epochs"])
        n_train = int(p["n_images"]) - int(p["n_val"])
        failed = done = 0
        t0 = time.perf_counter()
        t_end = t_traced = t0
        last = None
        fold_s = []
        if traced_units:
            tracer.start()
        while t_end - t0 < seconds:
            run = self.runs
            k = run % self.folds
            with tracer.span("portbench.fold"):
                try:
                    out = self.fold(k, epochs, self._perm_seed(run))
                    last = (k, run, self._program_epoch(out, False))
                    del out
                except RuntimeError as e:
                    print(f"portbench: fold run {run} raised: {e}")
                    failed += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            fold_s.append(time.perf_counter() - t_end)
            t_end = time.perf_counter()
            self.runs += 1
            done += 1
            if traced_units and done == traced_units:
                tracer.stop()
                t_traced = time.perf_counter()
        if traced_units and done < traced_units:
            tracer.stop()
        self.traced_folds = min(done, traced_units)
        # the folds after the profiled ones, timed without the profiler
        self.untraced = (done - self.traced_folds,
                         t_end - t_traced if done > traced_units else 0.0)
        self._counters = self.counters()
        self.last_fold = last
        if fold_s:
            print(f"portbench: {done} folds, seconds a fold: min "
                  f"{min(fold_s):.4f} median {statistics.median(fold_s):.4f}"
                  f" max {max(fold_s):.4f}", file=sys.stderr, flush=True)
        return {"attempted": done, "failed": failed,
                "metrics": {"train_img_per_s": (done - failed) * epochs
                            * n_train / (t_end - t0)}}

    def counters(self) -> Dict:
        """The fused runner's counters (``FusedRunner.stats``) of the
        cached runner, read through the runners' cache."""
        try:
            from segtpu_torch.train.fused_run import RUNNERS
            runners = [RUNNERS.get(k) for k in list(RUNNERS.keys())]
            return dict(runners[-1].stats) if runners else {}
        except (ImportError, AttributeError):
            return {}

    def free(self) -> None:
        from segtpu_torch.train.fused_run import RUNNERS
        self.engine = self.model = None
        RUNNERS.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _reference_epoch(self, k: int, perm_seed: int, lr: float,
                         with_weights: bool, quantize=None,
                         fault=None) -> Dict:
        p = self.p
        ref = follow.build(self.cfg, self.weights, self.device)
        if quantize is not None:
            ref.set_quantize(quantize)
        ti, tm, vi, vm = self._split(k)
        gen = torch.Generator(self.device).manual_seed(perm_seed)
        perm = torch.randperm(ti.shape[0], generator=gen,
                              device=self.device)
        got = follow.follow_epoch(ref, ti, tm, perm,
                                  int(p["batch_size"]), lr,
                                  float(p["weight_decay"]), fault=fault)
        if not with_weights:
            return {"train_loss": got["train_loss"]}
        got["val_loss"] = follow.val_loss(ref, vi, vm, int(p["batch_size"]),
                                          fault=fault)
        return got

    def reference_numbers(self, quantize=None, fault=None) -> Dict[str, float]:
        """The numbers read for the check, program against reference. Of
        the set-up fold's first epoch (at ``CHECK_LR``): the relative gap
        of its train loss (``loss_gap``) and of its validation loss
        (``val_loss_gap``: the eval-mode forwards with the running
        statistics the epoch left); the median BatchNorm statistic's
        (each ``running_mean`` and ``running_var`` a leaf) norm of the
        difference (``stats_gap_median``); over the parameters, the
        median leaf's gap of the steps' gradient norms
        (``grad_gap_median``), the worst leaf's gap of the norms of the
        parameter's change (``change_gap``) and the median leaf's norm of
        the difference of Adam's first moments (``moment_diff_median``).
        Of the last window fold's first epoch (at ``learning_rate``): the
        relative gap of its train loss (``window_loss_gap``).
        ``quantize`` or ``fault`` put the reference so changed in the
        program's place (the control's and the faults' readings)."""
        lr = float(self.p["learning_rate"])
        ref0 = self._reference_epoch(0, self._perm_seed(0), CHECK_LR, True)
        if quantize is None and fault is None:
            got0 = self.setup_fold
        else:
            got0 = self._reference_epoch(0, self._perm_seed(0), CHECK_LR,
                                         True, quantize, fault)
        leaves = check.counted_leaves(ref0["grad0"])
        out = {
            "loss_gap": check.rel_gap(got0["train_loss"],
                                      ref0["train_loss"]),
            "val_loss_gap": check.rel_gap(got0["val_loss"],
                                          ref0["val_loss"]),
            "stats_gap_median": statistics.median(
                check.leaf_diffs(got0["stats"], ref0["stats"],
                                 ref0["stats"])),
            "grad_gap_median": statistics.median(
                check.leaf_gaps(got0["grad"], ref0["grad"], leaves)),
            "change_gap": max(
                check.leaf_gaps(got0["change"], ref0["change"], leaves)),
            "moment_diff_median": statistics.median(
                check.leaf_diffs(got0["moment"], ref0["moment"], leaves)),
        }
        # the window's folds: the last one's first epoch, at the mix's LR
        if quantize is None and fault is None:
            if self.last_fold is None:
                out["window_loss_gap"] = float("nan")
                return out
            k, run, got = self.last_fold
        else:
            k, run = 1, 1
            got = self._reference_epoch(k, self._perm_seed(run), lr, False,
                                        quantize, fault)
        ref = self._reference_epoch(k, self._perm_seed(run), lr, False)
        out["window_loss_gap"] = check.rel_gap(got["train_loss"],
                                               ref["train_loss"])
        return out

    def context(self) -> Dict:
        p = self.p
        epochs = int(p["epochs"])
        return {"units": self.traced_folds,
                "untraced_units": self.untraced[0],
                "untraced_s": self.untraced[1],
                "trained_per_unit": epochs * (int(p["n_images"])
                                              - int(p["n_val"])),
                "validated_per_unit": epochs * int(p["n_val"]),
                "counters": self._counters}
