"""The port's float32 train step against the JAX package's, the
BatchNorm update, accumulation, remat, the ``reparam_in_train`` float64
step, checkpoints and the gates' folds in training
(``tests/test_torch_train.py``'s helpers and bars). A file of its own,
so that this float32 step and the float64 ones
(``tests/test_torch_train_f64.py``) compile on different test workers."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu_torch.models.backbones import BatchNorm2d
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from segtpu_torch.train.engine import METRIC_KEYS, TrainState, get_engine
from segtpu_torch.train.loop import plot_training_history
from segtpu_torch.train.optim import ReduceLROnPlateau
from test_torch_train import (LR, WD, _batch,  # noqa: F401
                              _bottom_level_vars, _gate_spy, _jax_init,
                              _jax_step, _nchw, _one_torch_thread,
                              _port_state, _port_step, _step_init,
                              _to_port_f64)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_train_step_matches_jax_in_float32(use_attention):
    """The f32 step: loss, logits and the BatchNorm statistics, which
    hold the biased-variance update (at the 1×1 bottom level, B=2, the
    unbiased one is twice as large)."""
    x, y = _batch()
    # the JAX model's own initial weights: the f32 bars below were
    # measured on them
    jl, jlg, _, jbs, jp = _jax_step(use_attention, x, y, jnp.float32,
                                    init=_jax_init)
    tl, tlg, _, tsd = _port_step(use_attention, x, y, torch.float32,
                                 init=_jax_init)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tlg, jlg, atol=2e-4)
    want = state_dict_from_jax(jp, jbs, "resnet_tiny", use_attention,
                               device="cpu")
    for k, v in tsd.items():
        if k.endswith("running_var"):
            torch.testing.assert_close(v, want[k], rtol=1e-5, atol=0)
        elif k.endswith("running_mean"):
            torch.testing.assert_close(
                v, want[k], rtol=0, atol=1e-4 * float(want[k].abs().max()))
    # the check sees the fault it is there for: torch's unbiased update
    # (n = 2 at the 1×1 level) misses the bar by far
    for k, v in _bottom_level_vars(want).items():
        unbiased = 0.9 + 2.0 * (v - 0.9)
        assert ((unbiased - v).abs() > 1e-3 * v).any(), k


def test_batchnorm_updates_with_the_biased_variance():
    torch.manual_seed(0)
    bn = BatchNorm2d(3, device="cpu")
    x = torch.randn(2, 3, 1, 1)
    bn.train()(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean,
                               0.1 * x.mean(dim=(0, 2, 3)))
    assert int(bn.num_batches_tracked) == 1
    ref = torch.nn.BatchNorm2d(3).train()
    ref.load_state_dict({**bn.state_dict(), "running_mean": torch.zeros(3),
                         "running_var": torch.ones(3),
                         "num_batches_tracked": torch.tensor(0)})
    torch.testing.assert_close(bn(x), ref(x))      # same normalisation


def test_train_step_accum_of_identical_micro_batches_equals_plain_step():
    """float64, so Adam's sign-like first step sees the same signs: three
    identical micro-batches give the plain step's parameters and loss,
    and the running statistics of three train-mode forwards."""
    x, y = _batch()
    xt, yt = _nchw(x, torch.float64), _nchw(y, torch.float64)
    eng, plain = _port_state(False, torch.float64)
    _, accum = _port_state(False, torch.float64)
    thrice = copy.deepcopy(accum.model).train()
    with torch.no_grad():
        for _ in range(3):
            thrice(xt)
    _, mp = eng.train_step(plain, xt, yt)
    _, ma = eng.train_step_accum(accum, torch.stack([xt] * 3),
                                 torch.stack([yt] * 3))
    for k in METRIC_KEYS:
        torch.testing.assert_close(ma[k], mp[k], rtol=1e-6, atol=1e-7)
    p_plain = dict(plain.model.named_parameters())
    for k, p in accum.model.named_parameters():
        torch.testing.assert_close(p, p_plain[k], rtol=0, atol=1e-12)
    for k, v in thrice.state_dict().items():
        if "running" in k or k.endswith("num_batches_tracked"):
            torch.testing.assert_close(accum.model.state_dict()[k], v)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_remat_full_matches_plain_step_and_updates_stats_once(
        use_attention):
    x, y = _batch()
    xt, yt = _nchw(x), _nchw(y)
    eng, plain = _port_state(use_attention)
    eng_r, remat = _port_state(use_attention, remat="full")
    assert eng_r is not eng and eng_r.remat == "full"
    _, mp = eng.train_step(plain, xt, yt)
    _, mr = eng_r.train_step(remat, xt, yt)
    assert float(mr["loss"]) == float(mp["loss"])
    rp = dict(remat.model.named_parameters())
    for k, p in plain.model.named_parameters():
        torch.testing.assert_close(rp[k].grad, p.grad, rtol=1e-6,
                                   atol=1e-9)
    rsd = remat.model.state_dict()
    for k, v in plain.model.state_dict().items():
        torch.testing.assert_close(rsd[k], v, rtol=1e-6, atol=1e-9)
        if k.endswith("num_batches_tracked"):
            assert int(rsd[k]) == 1


def test_reparam_in_train_step_matches_jax_in_float64(monkeypatch):
    """``get_engine({"reparam_in_train": True})`` trains: one float64 SGD
    step of resnet_tiny with attention and the combo loss, through the
    s2d stem and the contracted head, equals the JAX package's
    ``_train_step`` with the same key on the same weights: parameters
    within 1e-9 of the largest, each running statistic within 1e-9 of its
    tensor's largest entry, the loss within 1e-12 of itself."""
    from segtpu.train.engine import get_engine as jax_get_engine
    from segtpu_torch.models import backbones
    cfg = {"backbone": "resnet_tiny", "use_attention": True,
           "loss_fn": "combo", "optimizer": "sgd", "reparam_in_train": True}
    x, y = _batch()
    _, (p, s) = _step_init(True)
    with jax.enable_x64(True):
        p, s = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                for t in (p, s))
        eng = jax_get_engine({**cfg, "dtype": "float64"})
        st, m = eng._train_step(eng.state_from(p, s, LR, WD),
                                jnp.asarray(x, jnp.float64),
                                jnp.asarray(y, jnp.float64))
        want = _to_port_f64(jax.device_get(st.params),
                            jax.device_get(st.batch_stats), True)
        want_loss = float(m["loss"])
    stems = []
    weight = backbones.stem_s2d_weight
    monkeypatch.setattr(backbones, "stem_s2d_weight",
                        lambda w: stems.append(w.shape) or weight(w))
    engine = get_engine(cfg, device="cpu")
    model = engine.build_model()
    model.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny", True,
                                              device="cpu"))
    model.double()
    assert model.reparam_in_train and model.stem_s2d
    state = TrainState(model, engine.make_optimizer(model, LR, WD))
    _, got_m = engine.train_step(state, _nchw(x, torch.float64),
                                 _nchw(y, torch.float64))
    assert stems == [(64, 1, 7, 7)]       # the train step's stem was s2d
    assert abs(float(got_m["loss"]) - want_loss) <= 1e-12 * abs(want_loss)
    sd = model.state_dict()
    params = [k for k in want if "running" not in k
              and not k.endswith("num_batches_tracked")]
    pmax = max(float(want[k].abs().max()) for k in params)
    for k in params:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=1e-9 * pmax)
    for k in (k for k in want if "running" in k):
        torch.testing.assert_close(sd[k], want[k], rtol=0,
                                   atol=1e-9 * float(want[k].abs().max()))


def test_checkpoint_round_trip_restores_model_optimizer_scheduler(
        tmp_path):
    x, y = _batch()
    xt, yt = _nchw(x), _nchw(y)
    eng, st = _port_state(True)
    eng.train_step(st, xt, yt)
    sched = ReduceLROnPlateau(1e-3, patience=1)
    for v in (0.3, 0.2, 0.1):
        sched.step(v)
    path = save_checkpoint(str(tmp_path), st, "ck", scheduler=sched)
    assert path.endswith("ck.pt")
    _, back = _port_state(True)
    sched2 = ReduceLROnPlateau(1.0)
    load_checkpoint(str(tmp_path), "ck", state=back, scheduler=sched2)
    assert vars(sched2) == vars(sched)
    for k, v in st.model.state_dict().items():
        torch.testing.assert_close(back.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    # the restored optimizer continues as the original does
    eng.train_step(st, xt, yt)
    eng.train_step(back, xt, yt)
    for (k, p), q in zip(st.model.named_parameters(),
                         back.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0)
    plot_training_history([{"loss": 1.0, "iou": 0.1}] * 2,
                          [{"loss": 1.1, "iou": 0.2}] * 2, [1e-3, 5e-4],
                          {"save_dir": str(tmp_path)})
    assert (tmp_path / "training_curves.png").stat().st_size > 0


@pytest.mark.parametrize("foreach", [False, True],
                         ids=["for-loop", "foreach"])
def test_gate_fold_cache_follows_an_optimizer_step(foreach):
    """An optimizer step alone, with no forward, bumps the version counter
    of every gate parameter and of no BatchNorm statistic, so the next
    no-grad fold is new and equals a fresh one. After a whole train step
    (a train-mode forward and an optimizer step) the fused model equals
    the unfused one. ``foreach=True`` is torch.optim.Adam's default on
    CUDA."""
    x, y = _batch()
    xt, yt = _nchw(x), _nchw(y)
    eng, st = _port_state(True)
    st.optimizer = torch.optim.Adam(st.model.parameters(), lr=1e-2,
                                    foreach=foreach)
    model = st.model.eval()
    gates = (model.attention4, model.attention1)

    def folds_are_fresh(old):
        with torch.no_grad():
            for gate, prev in zip(gates, old):
                cached = gate.folded(torch.float32)
                assert cached is not prev
                for a, b in zip(cached, gate.fold(torch.float32)):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
        return [g._folded for g in gates]

    with torch.no_grad():
        model(xt)
        before = [g.folded(torch.float32) for g in gates]
        assert all(g.folded(torch.float32) is b
                   for g, b in zip(gates, before))
    params = [p for g in gates for p in g.parameters()]
    stats = [b for g in gates for b in g.buffers()]
    p_ver = [p._version for p in params]
    s_ver = [b._version for b in stats]
    gen = torch.Generator().manual_seed(3)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    st.optimizer.step()
    assert all(p._version > v for p, v in zip(params, p_ver))
    assert [b._version for b in stats] == s_ver
    before = folds_are_fresh(before)

    eng.train_step(st, xt, yt)
    model.eval()
    folds_are_fresh(before)
    with torch.no_grad():
        fused = model(xt)
        model.fuse_gate = False
        unfused = model(xt)
    torch.testing.assert_close(fused, unfused, rtol=0, atol=2e-5)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_autocast_eval_reaches_the_kernel_wrappers(monkeypatch,
                                                   use_attention):
    """Under bf16 autocast (f32 parameters) an eval forward hands the
    gate and upsample wrappers bf16 activations and bf16 weights; no
    dtype error, no route round the kernel. The bf16 logits stay within
    the f32 logits' 10% bar of chip_smoke.py."""
    calls = _gate_spy(monkeypatch)
    eng, st = _port_state(use_attention, dtype=torch.float32)
    model = st.model.eval()
    model.fuse_min_cin = model.fuse_min_work = 0
    x, _ = _batch()
    xt = _nchw(x)
    with torch.no_grad():
        want = model(xt)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = model(xt)
    name = "gate" if use_attention else "upsample"
    mine = [dts for n, dts in calls if n == name]
    assert len(mine) == 2 * 4
    for dts in mine[4:]:
        want_dts = ((torch.bfloat16,) * 4 + (torch.float32,
                                             torch.bfloat16, torch.float32)
                    if use_attention else
                    (torch.bfloat16, torch.bfloat16, torch.float32,
                     torch.bfloat16))
        assert dts == want_dts
    assert got.dtype == torch.bfloat16
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 0.1 * scale
