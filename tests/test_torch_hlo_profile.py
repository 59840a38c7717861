"""The port's profile reader and scaling models
(segtpu_torch.core.hlo_profile) against the JAX package's
(segtpu.core.hlo_profile).

- The four scaling models on the same explicit arguments, the link rate
  included (the JAX package's ``predict_dp_scaling`` has its v5e rate
  built in, so the port's gets that rate explicitly): within 1e-12
  relative.
- ``collective_summary`` of a profiled 2-rank data-parallel step (gloo,
  the CPU): the gradient all-reduce carries exactly the parameters'
  bytes, one all-reduce per BatchNorm forward and backward carries 2·C
  values, and two all-gathers gather the logits and the masks.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from segtpu.core import hlo_profile as jh
from segtpu_torch.core import hlo_profile as th
from torch_dist_worker import launch

LINK = 45e9


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            assert ra[k] == pytest.approx(rb[k], rel=1e-12, abs=0), k


def test_scaling_models_match_the_jax_package():
    assert th.ring_allreduce_time(9.8e7, 4, 3 * LINK) == pytest.approx(
        jh.ring_allreduce_time(9.8e7, 4, 3 * LINK), rel=1e-12)
    assert th.ring_allreduce_time(1e6, 1) == 0.0
    _same(th.predict_dp_scaling(9.8e7, 0.05, (2, 4, 8), 0.3, link_gbps=LINK),
          jh.predict_dp_scaling(9.8e7, 0.05, (2, 4, 8), 0.3))
    _same(th.predict_2d_mesh_scaling(9.8e7, 2.7e8, 8, 0.4,
                                     link_gbps=LINK, ag_bytes=1.66e9),
          jh.predict_2d_mesh_scaling(9.8e7, 2.7e8, 8, 0.4,
                                     link_gbps=LINK, ag_bytes=1.66e9))
    _same(th.predict_spatial_inference_scaling((2048, 2048), 32, 1, 0.03,
                                               link_gbps=LINK),
          jh.predict_spatial_inference_scaling((2048, 2048), 32, 1, 0.03,
                                               link_gbps=LINK))


def test_default_link_is_nvlink_not_the_tpu_ici():
    assert th.H100_NVLINK_GBPS == 450e9
    assert th.predict_dp_scaling(1e8, 0.1)[0]["t_allreduce_1d_ms"] == \
        pytest.approx(2 * 1e8 * 0.5 / (2 * 450e9) * 1e3, rel=1e-12)


def test_kernel_kinds():
    assert th.kernel_kind("gate_bf16_kernel<64>") == "port_kernel"
    assert th.kernel_kind("void conv_wgmma_kernel<64, 2>(__nv_bfloat16 "
                          "const*)") == "port_kernel"
    assert th.kernel_kind("void conv_f32_kernel<float, 64>(float const*)"
                          ) == "port_kernel"
    assert th.kernel_kind("void pair_bf16_kernel<8, 16, 2>(__nv_bfloat16 "
                          "const*)") == "port_kernel"
    assert th.kernel_kind("sm90_xmma_dgrad_implicit_gemm") == "conv_dgrad"
    assert th.kernel_kind("sm90_xmma_wgrad_implicit_gemm") == "conv_wgrad"
    assert th.kernel_kind("sm90_xmma_fprop_implicit_gemm") == "conv_fwd"
    assert th.kernel_kind("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "batchnorm"
    assert th.kernel_kind("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == \
        "collective"


def test_port_kernels_name_every_cuda_kernel():
    """Every ``__global__`` function of the port's CUDA sources is named in
    ``PORT_KERNELS`` and counted as the port's, not as cuDNN's."""
    src = Path(th.__file__).resolve().parents[1] / "csrc"
    names = set()
    for f in sorted(src.glob("*.cu")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", f.read_text()))
    assert len(names) == 10
    assert names == set(th.PORT_KERNELS)
    for n in names:
        assert th.kernel_kind(f"void {n}<64>(float const*)") == "port_kernel"


def test_collective_summary_of_a_profiled_dp_step(tmp_path):
    r = np.random.default_rng(0)
    x = r.uniform(0, 1, (4, 1, 32, 32))
    from segtpu_torch.train.engine import get_engine
    model = get_engine({"backbone": "resnet_tiny"},
                       device="cpu").build_model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save({"state_dict": model.state_dict(),
                "x": torch.from_numpy(x), "y": torch.from_numpy(
                    (x > 0.6).astype(np.float64)),
                "lr": 1e-3, "wd": 1e-5, "cfg": {"use_attention": True}},
               tmp_path / "inputs.pt")
    for res in launch("profile", 2, tmp_path):
        summary, coll = res["summary"], res["collectives"]
        ar = [c for c in coll if c["opcode"] == "all-reduce"]
        assert max(c["payload_bytes"] for c in ar) == res["param_bytes"]
        assert len(ar) == 1 + 2 * res["n_bn"]
        bn = sorted(c["payload_bytes"] for c in ar)[:-1]
        assert sum(bn) == 2 * 2 * res["bn_channels"] * 4
        assert summary["per_op"]["all-gather"]["count"] == 2
        assert summary["per_op"]["all-reduce"]["payload_bytes"] == \
            res["param_bytes"] + sum(bn)
        assert summary["count"] == len(coll)
