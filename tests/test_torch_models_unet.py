"""The resnet_tiny U-Net of the port against the JAX package's eval
forward at 64², over ``tests/test_torch_models.py``'s cases (attention
on/off × gate kernel on/off × upsample kernel on/off, the head
contraction on/off, the bias prior, 2 classes; its helpers and bar). A
file of its own, so that these compiles and that file's run on different
test workers."""

import numpy as np
import pytest
import torch

from test_torch_models import ATOL, _jit_apply, _models, _nchw, _nhwc

# resnet_tiny at 64²: attention on/off × gate kernel on/off × upsample
# kernel on/off, the head contraction on/off, the bias prior, 2 classes.
UNET_CASES = {
    "attn-gatekernel": dict(use_attention=True),
    "attn-gateplain": dict(use_attention=True, fuse_gate=False),
    "attn-gatekernel-headplain": dict(use_attention=True, fuse_head=False),
    "noattn-upkernel": dict(use_attention=False),
    "noattn-upplain-headplain": dict(use_attention=False, fuse_kernel=False,
                                     fuse_head=False),
    "attn-prior": dict(use_attention=True, final_bias_prior=0.1),
    "noattn-2class": dict(use_attention=False, n_classes=2),
}


@pytest.mark.parametrize("case", list(UNET_CASES), ids=list(UNET_CASES))
def test_unet_matches_jax(rng, case):
    jm, jv, tm = _models("resnet_tiny", **UNET_CASES[case])
    x = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(_jit_apply(jm, jv, x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert np.abs(ref).max() > 50 * ATOL      # the comparison is not vacuous
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


def test_unet_return_features_matches_jax(rng):
    jm, jv, tm = _models("resnet_tiny", use_attention=True)
    x = rng.normal(size=(1, 64, 64, 1)).astype(np.float32)
    ref_out, ref_feat = _jit_apply(jm, jv, x, return_features=True)
    with torch.no_grad():
        out, feat = tm(_nchw(x), return_features=True)
    assert feat.shape == (1, 64 + 128, 8, 8)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(_nhwc(feat), np.asarray(ref_feat), atol=ATOL)
