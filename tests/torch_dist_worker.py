"""Ranks of the port's multi-process tests (gloo on the CPU).

``launch(scenario, world, tmp)`` starts ``world`` processes of this file,
which meet at ``file://<tmp>/rdzv_<scenario>`` (no TCP port, so that test
processes running side by side cannot collide), each on one intra-op
thread, run ``scenario`` on the inputs the test wrote to
``<tmp>/inputs.pt`` and write ``<tmp>/<scenario>_<rank>.pt``. It waits
for them with a deadline of its own and kills every rank when it
passes, so that a hung collective fails one test.

This module imports torch and segtpu_torch only (never the test modules,
which import JAX):

    python tests/torch_dist_worker.py <scenario> <world> <rank> <tmp>
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402


def launch(scenario: str, world: int, tmp, timeout: float = 90.0) -> list:
    """Run ``scenario`` on ``world`` ranks; their results, by rank."""
    tmp = str(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(world),
         str(r), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{scenario}: ranks still running after "
                             f"{timeout} s; killed")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"{scenario} rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(os.path.join(tmp, f"{scenario}_{r}.pt"),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------- scenarios

def _engine(cfg):
    from segtpu_torch.train.engine import get_engine
    return get_engine({"backbone": "resnet_tiny", "loss_fn": "combo",
                       **cfg}, device="cpu")


def _state(engine, inputs, dtype=torch.float64):
    from segtpu_torch.train.engine import TrainState
    model = engine.build_model()
    model.load_state_dict(inputs["state_dict"])
    model.to(dtype)
    return TrainState(model, engine.make_optimizer(model, inputs["lr"],
                                                   inputs["wd"]))


def _sd(state):
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def scenario_dp(inputs, rank, world):
    """Mesh and input placement, one float64 DP step, an accumulated step,
    replicate_state, and a DP epoch over sharded loaders (the references
    are the single-device port on rank 0)."""
    from segtpu_torch.core.dist import create_mesh
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.parallel import (DataParallel, global_batch_from_local,
                                       process_local_slice, replicate_state)

    out = {}
    mesh = create_mesh(device="cpu")
    out["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)
    mesh2 = create_mesh(axis_sizes=(world, 1), axis_names=("data", "spatial"),
                        device="cpu")
    out["mesh2"] = (tuple(mesh2.shape), mesh2.mesh_dim_names)
    x, y = inputs["x"], inputs["y"]
    sl = process_local_slice(10)
    out["slice"] = (sl.start, sl.stop)
    gb = global_batch_from_local(x[process_local_slice(x.shape[0])], mesh)
    out["global"] = (tuple(gb.shape), torch.equal(
        gb.to_local(), x[process_local_slice(x.shape[0])]))

    dp = DataParallel(mesh)
    for key in ("cfg", "cfg_adam"):
        engine = _engine(inputs[key])
        st = _state(engine, inputs)
        st, m = engine.train_step(st, dp.shard(x), dp.shard(y))
        out[key] = {"sd": _sd(st), "metrics": {k: float(v) for k, v in
                                               m.items()}}
    if rank == 0:
        ref = _state(engine, inputs)
        ref, m = engine.train_step(ref, x, y)
        out["adam_ref"] = {"sd": _sd(ref), "metrics": {
            k: float(v) for k, v in m.items()}}

    # accumulation: A=2 micro-batches of 4 rows, rows split per rank
    xa = torch.stack([x, inputs["ex"][:4]])
    ya = torch.stack([y, inputs["ey"][:4]])
    st = _state(engine, inputs)
    st, m = engine.train_step_accum(st, dp.shard(xa, dim=1),
                                    dp.shard(ya, dim=1))
    out["accum"] = {"sd": _sd(st), "metrics": torch.stack(list(m.values()))}
    if rank == 0:
        ref = _state(engine, inputs)
        ref, mr = engine.train_step_accum(ref, xa, ya)
        out["accum_ref"] = {"sd": _sd(ref),
                            "metrics": torch.stack(list(mr.values()))}

    # replicate_state: rank 1's weights and moments perturbed, then rank
    # 0's broadcast
    st = _state(engine, inputs)
    st, _ = engine.train_step(st, x, y)
    before = {**_sd(st), **{f"opt{i}": t.clone() for i, t in enumerate(
        v for s in st.optimizer.state.values() for v in s.values())}}
    if rank == 1:
        with torch.no_grad():
            for p in st.model.parameters():
                p.add_(1.0)
            for s in st.optimizer.state.values():
                for v in s.values():
                    v.add_(1.0)
    replicate_state(st, mesh)
    after = {**_sd(st), **{f"opt{i}": t.clone() for i, t in enumerate(
        v for s in st.optimizer.state.values() for v in s.values())}}
    out["replicate"] = {"before": before, "after": after}

    # an epoch and a validation pass over sharded loaders (f64, the
    # validation forwards without the gate kernel, which takes f32/bf16)
    ecfg = dict(inputs["cfg"], fuse_gate=False)
    engine = _engine(ecfg)
    tr = DeviceDataLoader(inputs["ex"], inputs["ey"], batch_size=4)
    va = DeviceDataLoader(inputs["vx"], inputs["vy"], batch_size=4,
                          shuffle=False)
    st = _state(engine, inputs)
    st, tt, vt = engine.run_train_and_eval_epoch_async(
        st, dp.shard_loader(tr), dp.shard_loader(va), inputs["lr"],
        torch.Generator().manual_seed(3))
    out["epoch"] = {"sd": _sd(st), "tt": tt, "vt": vt}
    if rank == 0:
        ref = _state(engine, inputs)
        ref, rt, rv = engine.run_train_and_eval_epoch_async(
            ref, tr, va, inputs["lr"], torch.Generator().manual_seed(3))
        out["epoch_ref"] = {"sd": _sd(ref), "tt": rt, "vt": rv}
    return out


def scenario_uneven(inputs, rank, world):
    """A float64 DP epoch whose batches leave ranks uneven and empty,
    against the single-device epoch on rank 0."""
    from segtpu_torch.core.dist import create_mesh
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.parallel import shard_loader

    engine = _engine(dict(inputs["cfg"], fuse_gate=False))
    tr = DeviceDataLoader(inputs["ex"], inputs["ey"],
                          batch_size=inputs["batch"])
    st = _state(engine, inputs)
    st, m = engine.run_train_epoch(st, shard_loader(tr, create_mesh(
        device="cpu")), inputs["lr"], torch.Generator().manual_seed(5))
    out = {"sd": _sd(st), "metrics": m}
    if rank == 0:
        ref = _state(engine, inputs)
        ref, mr = engine.run_train_epoch(ref, tr, inputs["lr"],
                                         torch.Generator().manual_seed(5))
        out["ref"] = {"sd": _sd(ref), "metrics": mr}
    return out


def scenario_profile(inputs, rank, world):
    """A profiled DP step (float32): the collectives it recorded."""
    from segtpu_torch.core import hlo_profile
    from segtpu_torch.core.dist import create_mesh
    from segtpu_torch.parallel import DataParallel

    dp = DataParallel(create_mesh(device="cpu"))
    engine = _engine(inputs["cfg"])
    st = _state(engine, inputs, torch.float32)
    x, y = dp.shard(inputs["x"].float()), dp.shard(inputs["y"].float())
    with torch.profiler.profile(record_shapes=True) as prof:
        engine.train_step(st, x, y)
    return {"summary": hlo_profile.collective_summary(prof),
            "collectives": hlo_profile.extract_collectives(prof),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in st.model.parameters()),
            "n_bn": sum(type(m).__name__ == "BatchNorm2d"
                        for m in st.model.modules()),
            "bn_channels": sum(m.num_features for m in st.model.modules()
                               if type(m).__name__ == "BatchNorm2d")}


def _conv_stack(k1, k2):
    import torch.nn.functional as F

    def apply_fn(x):  # NHWC → NHWC, two 3×3 'same' convs
        h = torch.tanh(F.conv2d(x.permute(0, 3, 1, 2), k1, padding=1))
        return F.conv2d(h, k2, padding=1).permute(0, 2, 3, 1)
    return apply_fn


def scenario_spatial(inputs, rank, world):
    """The row-sharded predictor's contract and the flagship-architecture
    model through ``spatial_predict``."""
    from segtpu_torch.core import hlo_profile
    from segtpu_torch.core.dist import create_mesh
    from segtpu_torch.models.unet import UNetWithBackbone
    from segtpu_torch.parallel import (make_spatial_sharded_predictor,
                                       spatial_predict)

    mesh = create_mesh(device="cpu")
    out = {}
    img = inputs["img"]
    out["identity"] = make_spatial_sharded_predictor(
        lambda x: x * 2.0, mesh, halo=4)(img).to_local()
    out["conv"] = make_spatial_sharded_predictor(
        _conv_stack(inputs["k1"], inputs["k2"]), mesh,
        halo=4)(inputs["img2"]).to_local()
    out["halo0"] = make_spatial_sharded_predictor(
        lambda x: x + 1.0, mesh, halo=0)(torch.ones(16, 8, 1)).to_local()
    errors = {}
    for name, call in (
            ("uneven", lambda: make_spatial_sharded_predictor(
                lambda x: x, mesh, halo=0)(torch.zeros(31, 8, 1))),
            ("band", lambda: make_spatial_sharded_predictor(
                lambda x: x, mesh, halo=32)(torch.zeros(32, 8, 1))),
            ("negative", lambda: make_spatial_sharded_predictor(
                lambda x: x, mesh, halo=-1))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    pred = make_spatial_sharded_predictor(lambda x: x * 2.0, mesh, halo=4)
    with torch.profiler.profile(record_shapes=True) as prof:
        pred(img)
    out["ops"] = sorted({c["opcode"] for c in
                         hlo_profile.extract_collectives(prof)})
    model = UNetWithBackbone(backbone="resnet_tiny", use_attention=True,
                             device="cpu")
    model.load_state_dict(inputs["state_dict"])
    out["probs"] = spatial_predict(model, None, inputs["slide"], mesh,
                                   halo=16)
    return out


def scenario_tiled(inputs, rank, world):
    """Tile batches sharded over the mesh against the unsharded tiler:
    blend, and halo with both assembly paths."""
    from segtpu_torch.core.dist import create_mesh
    from segtpu_torch.infer.tiled import make_tiled_predictor

    from segtpu_torch.infer.predict import nhwc_forward
    from segtpu_torch.models.unet import UNetWithBackbone

    img = inputs["img"]
    fns = {"tanh": lambda x: torch.tanh(x * 1.5 + 0.1)}
    if "state_dict" in inputs:      # a U-Net's forward
        model = UNetWithBackbone(backbone="resnet_tiny", use_attention=True,
                                 device="cpu").eval()
        model.load_state_dict(inputs["state_dict"])
        fns["unet"] = lambda x: nhwc_forward(model, x)
    mesh = create_mesh(device="cpu")
    out = {}
    # 16 blend tiles in batches of 8 or (batch_tiles=3) 3, odd; 9 halo
    # tiles in batches of 5 (scatter assembly) or one of 9 (reshape)
    for name, fn in fns.items():
        for mode, bt in (("blend", 8), ("blend", 3), ("halo", 8),
                         ("halo", 16)):
            with torch.inference_mode():
                ref = make_tiled_predictor(fn, tile=32, overlap=8,
                                           batch_tiles=bt, mode=mode)(img)
                sharded = make_tiled_predictor(fn, tile=32, overlap=8,
                                               batch_tiles=bt, mode=mode,
                                               shard_tiles_axis="data")
                with mesh:
                    got = sharded(img)
            out[(name, mode, bt)] = float((got - ref).abs().max())
    return out


def _bands_mesh(world):
    """The (data × spatial) mesh: 2×2 on 4 ranks, 1×2 on 2."""
    from segtpu_torch.core.dist import create_mesh
    return create_mesh(axis_sizes=(world // 2, 2),
                       axis_names=("data", "spatial"), device="cpu")


def _on_mesh(mesh, *tensors):
    """Each tensor placed [Shard(rows), Shard(image rows)] over the
    mesh, by ``distribute_tensor`` (a batch (B, 1, H, W) or stacked
    micro-batches (A, B, 1, H, W))."""
    from torch.distributed.tensor import Shard, distribute_tensor
    return [distribute_tensor(t, mesh, [Shard(t.ndim - 4), Shard(t.ndim - 2)])
            for t in tensors]


def _stepped(engine, inputs, x, y, sd=None, accum=False, model=None):
    """(state_dict, metrics, gradients) after one step from the inputs'
    weights (or ``sd``), on a new model (or ``model``, in float64)."""
    sd = sd or inputs["state_dict"]
    if model is None:
        st = _state(engine, dict(inputs, state_dict=sd))
    else:
        from segtpu_torch.train.engine import TrainState
        model.load_state_dict(sd)
        st = TrainState(model, engine.make_optimizer(model, inputs["lr"],
                                                     inputs["wd"]))
    step = engine.train_step_accum if accum else engine.train_step
    st, m = step(st, x, y)
    return {"sd": _sd(st), "metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: p.grad.clone()
                      for k, p in st.model.named_parameters()}}


def _digest(sd) -> dict:
    """Each tensor's bytes, hashed: equal digests are equal tensors."""
    import hashlib
    return {k: hashlib.sha1(v.detach().contiguous().numpy().tobytes())
            .hexdigest() for k, v in sd.items()}


def _rel(got, want, keys) -> float:
    return max(float((got[k] - want[k]).abs().max()) for k in keys) / max(
        float(want[k].abs().max()) for k in keys)


def _errors(got, want):
    """Relative errors of a step against another (dicts of ``sd``,
    ``metrics`` and, where both have them, ``grads``): parameters (and
    gradients) against the largest of each, the worst running statistic
    against its tensor's largest entry, the worst of loss and metrics
    against itself."""
    sd, ref = got["sd"], want["sd"]
    params = [k for k in ref if ref[k].is_floating_point()
              and "running" not in k]
    out = {"params": _rel(sd, ref, params),
           "stats": max(_rel(sd, ref, [k]) for k in ref if "running" in k),
           "metrics": max(abs(got["metrics"][k] - v) / abs(v)
                          for k, v in want["metrics"].items())}
    if "grads" in got and "grads" in want:
        out["grads"] = _rel(got["grads"], want["grads"], list(want["grads"]))
    return out


def _edge_replicated(self, x, kernel, stride, padding, dilation=1,
                     fill=0.0):
    """Negative control for ``Bands.pad_rows``: each band's own edge rows
    replicated in place of the neighbours' rows (what the inference
    predictor does at the image's edges)."""
    bottom = max(0, dilation * (kernel - 1) + 1 - stride - padding)
    return torch.cat([x[:, :, :1].expand(-1, -1, padding, -1), x,
                      x[:, :, -1:].expand(-1, -1, bottom, -1)], dim=2)


def _rank_local_mean(self, x):
    """Negative control for ``Bands.mean``: the band's own mean."""
    return x.mean(dim=(2, 3), keepdim=True)


def scenario_mesh2d(inputs, rank, world):
    """On a 2×2 (data × spatial) mesh, a batch placed [Shard(0),
    Shard(2)]: the float64 step and the two controls against the JAX
    package's step (``inputs["want"]``, computed by the test), the
    accumulated and the eval steps against the one-process port on rank
    0, every rank's state digests, and the refusal of a band height that
    is not a multiple of 32. Only errors and digests are returned."""
    from unittest import mock
    from segtpu_torch.parallel.spatial import Bands

    mesh = _bands_mesh(world)
    engine = _engine(inputs["cfg"])
    x, y = inputs["x"], inputs["y"]
    xd, yd = _on_mesh(mesh, x, y)
    got = {"step": _stepped(engine, inputs, xd, yd)}
    for name, patch in (("edge_replicated", ("pad_rows", _edge_replicated)),
                        ("rank_local_mean", ("mean", _rank_local_mean))):
        with mock.patch.object(Bands, *patch):
            got[name] = _stepped(engine, inputs, xd, yd)
    out = {"digest": _digest(got["step"]["sd"]), "tracked": [
        int(v) for k, v in got["step"]["sd"].items()
        if k.endswith("num_batches_tracked")]}

    xa = torch.stack([x, inputs["x2"]])
    ya = torch.stack([y, inputs["y2"]])
    accum = _stepped(engine, inputs, *_on_mesh(mesh, xa, ya), accum=True)
    out["accum_digest"] = _digest(accum["sd"])
    if rank == 0:
        out["accum"] = _errors(accum, _stepped(engine, inputs, xa, ya,
                                               accum=True))
    del accum

    # the eval step in float64 without the gate kernel (its plain version
    # takes f32), and in f32 with it, against one process
    for name, cfg, dtype in (("eval", dict(inputs["cfg"], fuse_gate=False),
                              torch.float64),
                             ("eval_f32", inputs["cfg"], torch.float32)):
        eng = _engine(cfg)
        st = _state(eng, inputs, dtype)
        xe, ye = x.to(dtype), y.to(dtype)
        out[name] = eng._eval_step_vec(st, *_on_mesh(mesh, xe, ye))
        if rank == 0:
            out[name + "_ref"] = eng._eval_step_vec(st, xe, ye)

    try:
        xs, ys = _on_mesh(mesh, x[:, :, :32, :32], y[:, :, :32, :32])
        _stepped(engine, inputs, xs, ys)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)

    # a batch placed over ``data`` alone (``shard_loader``'s placement)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from segtpu_torch.parallel.data_parallel import local_batch
    xr = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    sync = local_batch(xr, xr)[2]
    out["data_only"] = (sync.group.size(), sync.bands is not None)

    for name in ("step", "edge_replicated", "rank_local_mean"):
        out[name] = _errors(got[name], inputs["want"])
    return out


def _forward_backward(engine, model, x, y):
    """A train-mode forward of ``model`` on ``x`` (plain or sharded) and
    one backward of the loss of its (gathered) logits: the loss, the
    running statistics, and the gradients, summed over the mesh, of the
    stem and of every parameter of at most 4096 values (the BatchNorms'
    and the biases: one per layer, each carrying its layer's
    backward)."""
    from segtpu_torch.parallel.data_parallel import local_batch
    xl, yl, sync = local_batch(x, y)
    model.train()
    model.zero_grad(set_to_none=True)
    vec = engine._micro_step(model, xl, yl, 1.0, sync)
    params = [(k, p) for k, p in model.named_parameters()
              if k == "input_conv.weight" or p.numel() <= 4096]
    if sync is not None:
        sync.reduce_gradients([p for _, p in params])
    return {"loss": float(vec[-1]),
            "grads": {k: p.grad.clone() for k, p in params},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k}}


def scenario_bands(inputs, rank, world):
    """On a 1×2 (data × spatial) mesh (bands of 32 rows, B=2, float64):
    the ``reparam_in_train`` step of resnet_tiny, and a forward and a
    backward of resnet50 and densenet121 (attention, fresh weights from
    seed 0), each against the one-process port on rank 0."""
    from segtpu_torch.train.engine import get_engine

    mesh = _bands_mesh(world)
    x, y = inputs["x"][:2], inputs["y"][:2]
    xd, yd = _on_mesh(mesh, x, y)
    engine = _engine(dict(inputs["cfg"], reparam_in_train=True))
    got = _stepped(engine, inputs, xd, yd)
    out = {"reparam_digest": _digest(got["sd"])}
    if rank == 0:
        out["reparam"] = _errors(got, _stepped(engine, inputs, x, y))
    del got
    for backbone in ("resnet50", "densenet121"):
        engine = get_engine({"backbone": backbone, "use_attention": True,
                             "loss_fn": "combo"}, device="cpu")
        torch.manual_seed(0)
        model = engine.build_model().double()
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        out[backbone] = _forward_backward(engine, model, xd, yd)
        if rank == 0:
            model.load_state_dict(sd)
            out[backbone + "_ref"] = _forward_backward(engine, model, x, y)
        del model, sd
    return out


def _fused(engine, inputs, size="", **kw):
    """``run_training_fused`` from the inputs' float64 weights on the
    inputs' training and validation sets (``size`` picks the 64² ones):
    its decisions and histories, and the final and the returned (best)
    weights."""
    from segtpu_torch.train.fused_run import run_training_fused
    out = run_training_fused(
        engine, _state(engine, inputs, inputs["dtype"]), inputs["ti" + size],
        inputs["tm" + size], inputs["vi" + size], inputs["vm" + size],
        generator=torch.Generator().manual_seed(inputs["seed"]),
        **inputs["run"], **kw)
    res = {k: out[k] for k in ("train_history", "val_history", "lr_history",
                               "best_iou", "best_found", "best_epoch",
                               "epochs_ran")}
    res["sd"] = _sd(out["final_state"])
    res["best_sd"] = _sd(out["state"])
    return res


def _run_digest(res) -> dict:
    """A run's decisions and histories, and its weights hashed."""
    return {**{k: v for k, v in res.items() if not k.endswith("sd")},
            "sd": _digest(res["sd"]), "best_sd": _digest(res["best_sd"])}


def _run_errors(got, want) -> dict:
    """A run's final weights against another's: parameters against the
    largest parameter, the worst running statistic against its tensor's
    largest entry."""
    sd, ref = got["sd"], want["sd"]
    params = [k for k in ref if ref[k].is_floating_point()
              and "running" not in k]
    return {"params": _rel(sd, ref, params),
            "stats": max(_rel(sd, ref, [k]) for k in ref if "running" in k)}


def scenario_fused_dp(inputs, rank, world):
    """The data-parallel fused run (float64): on the world's 1-D ``data``
    mesh from ``with mesh:`` and again with ``mesh=``, on the 1×2 (data ×
    spatial) mesh at 64², the two controls (rank-local BatchNorm
    statistics; the gradients' mean in place of their sum), the 1-D
    mesh's run again after the process group is made anew, and the
    one-process runs the test holds them to; the runner cache after each.
    Rank 0 returns the runs, every rank their digests."""
    from unittest import mock
    from segtpu_torch.core.dist import create_mesh, init_process_group
    from segtpu_torch.parallel.data_parallel import StepSync
    from segtpu_torch.train import fused_run

    engine = _engine(inputs["cfg"])
    mesh = create_mesh(device="cpu")
    runs, cache = {}, {}
    with mesh:
        runs["dp"] = _fused(engine, inputs)
    runs["dp_again"] = _fused(engine, inputs, mesh=mesh)
    (dp_key,) = fused_run.RUNNERS.keys()
    cache["dp"] = dict(fused_run.RUNNERS[dp_key].stats)
    runs["one"] = _fused(engine, inputs)
    cache["keys"] = len(fused_run.RUNNERS.keys())
    cache["one_runs"] = fused_run.RUNNERS[fused_run.RUNNERS.keys()[-1]] \
        .stats["runs"]
    cache["dp_runs_after"] = fused_run.RUNNERS[dp_key].stats["runs"]

    # each rank's own count (1 on an empty rank, whose sums are zeros)
    local = lambda self, x: max(1, x.shape[0] * x.shape[2] * x.shape[3])
    summed = StepSync.reduce_gradients

    def averaged(self, params):
        params = list(params)       # the engine passes a generator
        summed(self, params)
        for p in params:
            if p.grad is not None:
                p.grad.div_(world)

    with mock.patch.object(StepSync, "all_reduce", lambda self, t: t), \
            mock.patch.object(StepSync, "count", local):
        runs["rank_local_stats"] = _fused(engine, inputs, mesh=mesh)
    with mock.patch.object(StepSync, "reduce_gradients", averaged):
        runs["mean_gradients"] = _fused(engine, inputs, mesh=mesh)

    bands = _bands_mesh(world)
    runs["bands"] = _fused(engine, inputs, "64", mesh=bands,
                           spatial_axis="spatial")
    if rank == 0:
        runs["bands_one"] = _fused(engine, inputs, "64")

    # the process group destroyed and made anew, a mesh of the same shape
    # on it: its run gets a runner of its own, not the cached one that
    # holds the destroyed group
    _fused(engine, inputs, mesh=mesh)
    last = lambda: fused_run.RUNNERS[fused_run.RUNNERS.keys()[-1]]
    stale = last()
    stale_runs = stale.stats["runs"]
    torch.distributed.destroy_process_group()
    init_process_group(f"file://{inputs['tmp']}/rdzv_fused_dp_anew", world,
                       rank, device="cpu")
    runs["anew"] = _fused(engine, inputs, mesh=create_mesh(device="cpu"))
    cache["anew"] = dict(own_runner=last() is not stale,
                         runs=last().stats["runs"],
                         stale_run_again=stale.stats["runs"] != stale_runs)
    out = {"digests": {k: _run_digest(v) for k, v in runs.items()},
           "cache": cache}
    if rank == 0:
        out["runs"] = {k: runs[k] for k in ("dp", "one", "rank_local_stats",
                                            "mean_gradients")}
        out["bands"] = _run_errors(runs["bands"], runs["bands_one"])
        out["bands_decisions"] = {
            k: (runs["bands"][k], runs["bands_one"][k])
            for k in ("lr_history", "best_epoch", "epochs_ran",
                      "best_found")}
    return out


def scenario_fused_dp_jax(inputs, rank, world):
    """The data-parallel fused run of ``tests/test_torch_fused_run.py``'s
    JAX comparison (f32): its histories and decisions on every rank, with
    its weights hashed, and rank 0's one-process run."""
    from segtpu_torch.core.dist import create_mesh
    engine = _engine(inputs["cfg"])
    dp = _fused(engine, inputs, mesh=create_mesh(device="cpu"))
    out = {"dp": _run_digest(dp)}
    if rank == 0:
        out["dp_run"] = dp
        out["one"] = _fused(engine, inputs)
    return out


def main(argv) -> int:
    scenario, world, rank, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    from segtpu_torch.core.dist import init_process_group
    init_process_group(f"file://{tmp}/rdzv_{scenario}", world, rank,
                       device="cpu")
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    inputs["tmp"] = tmp
    try:
        out = globals()[f"scenario_{scenario}"](inputs, rank, world)
        torch.save(out, os.path.join(tmp, f"{scenario}_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
