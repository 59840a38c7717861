"""The port's optimizers against optax and one float64 train step
against the JAX package's, on the same weights and inputs
(``tests/test_torch_train.py``'s helpers and bars): with and without
attention, at batch one (ROADMAP C1) and with three classes. A file of
its own, so that these float64 steps and the float32 one
(``tests/test_torch_train_f32.py``) compile on different test workers."""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from segtpu.train.optim import make_optimizer as jax_make_optimizer
from segtpu_torch.train.optim import make_optimizer
from test_torch_train import (OPTIMIZERS, _batch,  # noqa: F401
                              _bottom_level_vars, _check_step_in_float64,
                              _one_torch_thread)


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["adam", "adamw", "sgd", "sgd-nesterov", "lamb"])
def test_optimizer_matches_optax_chain(name, kw):
    r = np.random.default_rng(2)
    w0 = [r.normal(size=(5, 3)).astype(np.float32),
          r.normal(size=(4,)).astype(np.float32)]
    grads = [[r.normal(size=w.shape).astype(np.float32) for w in w0]
             for _ in range(3)]
    tx = jax_make_optimizer(name, 1e-2, 1e-2, **kw)
    params = [jnp.asarray(w) for w in w0]
    st = tx.init(params)
    ts = [torch.tensor(w, requires_grad=True) for w in w0]
    opt = make_optimizer(name, ts, 1e-2, 1e-2, **kw)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, params)
        params = optax.apply_updates(params, upd)
        for t, x in zip(ts, g):
            t.grad = torch.from_numpy(x)
        opt.step()
    for t, p in zip(ts, params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p),
                                   atol=1e-6)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_train_step_matches_jax_in_float64(use_attention):
    _check_step_in_float64(use_attention, *_batch())


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_train_step_at_batch_one_matches_jax_in_float64(use_attention):
    """ROADMAP C1: one 32² image reaches the bottom level at 1×1, so each
    BatchNorm there normalises one value per channel. flax does it with
    variance 0 (the output is the shift, the running variance moves
    toward 0); torch's own batch norm refuses the input."""
    x, y = _batch()
    tsd = _check_step_in_float64(use_attention, x[:1], y[:1])
    bottom = _bottom_level_vars(tsd)
    assert bottom
    for k, v in bottom.items():           # 0.9·1 + 0.1·0, exactly
        assert bool((v == 0.9).all()), k


def test_multiclass_train_step_matches_jax_in_float64():
    """n_classes=3 (softmax head, the multiclass combo loss and metrics),
    labels 0..2, with attention: the same float64 bars as the binary
    step."""
    x, _ = _batch()
    r = np.random.default_rng(9)
    y = r.integers(0, 3, x.shape).astype(np.float32)
    _check_step_in_float64(True, x, y, n_classes=3)
