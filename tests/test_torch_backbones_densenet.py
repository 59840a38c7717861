"""The densenet121 U-Nets of the port against the JAX package's
(``tests/test_torch_backbones.py``'s checks, weights and bars, over
densenet121's cases; resnet50's run there, so that the two backbones'
compiles run on two test workers)."""

import pytest

from test_torch_backbones import (FORWARD_CASES, STEP_CASES,  # noqa: F401
                                  _eval_forward, _one_torch_thread,
                                  _round_trip, _train_mode_forward,
                                  _train_step, cases)


@pytest.mark.parametrize("backbone,use_attention", **cases("densenet121"))
def test_state_dict_round_trips_through_both_converters(backbone,
                                                        use_attention):
    _round_trip(backbone, use_attention)


@pytest.mark.parametrize("backbone,use_attention", **cases("densenet121"))
def test_unet_eval_forward_matches_jax_in_f32(backbone, use_attention):
    _eval_forward(backbone, use_attention)


@pytest.mark.parametrize("backbone,use_attention",
                         **cases("densenet121", FORWARD_CASES))
def test_unet_train_mode_forward_matches_jax_in_float64(backbone,
                                                        use_attention):
    _train_mode_forward(backbone, use_attention)


@pytest.mark.parametrize("backbone,use_attention",
                         **cases("densenet121", STEP_CASES))
def test_train_step_matches_jax_in_float64(backbone, use_attention):
    _train_step(backbone, use_attention)
