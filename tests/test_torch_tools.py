"""The port's bench entry points (``segtpu_torch.tools``): they refuse to
run without CUDA unless given ``--device cpu``, their per-shape functions
run on the CPU through the plain versions (host-clock times, labelled as
such), they count their kernel calls, and ``--out`` is the only file they
write (never ``FUSED_BLOCK_BENCH.json``, the JAX package's TPU record).
"""

import json
from pathlib import Path

import pytest
import torch

from segtpu_torch.kernels import launch_counts
from segtpu_torch.tools import fused_block_bench, kernel_bench

ROOT = Path(__file__).resolve().parent.parent
TOOLS = [kernel_bench, fused_block_bench]
TOOL_IDS = ["kernel_bench", "fused_block_bench"]


@pytest.mark.parametrize("tool", TOOLS, ids=TOOL_IDS)
def test_default_entry_point_needs_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


# Each per-shape function at a reduced width: (function, args, wrapper).
CASES = {
    "conv": (kernel_bench.bench_conv, (2, 8, 12, 8), "conv3x3_bn_relu"),
    "conv-ragged-32": (kernel_bench.bench_conv, (1, 7, 5, 32),
                       "conv3x3_bn_relu"),
    "ups": (kernel_bench.bench_ups, (2, 4, 16, 8, 8), "upsample2x_concat"),
    "ups-cs-2co": (kernel_bench.bench_ups, (2, 4, 8, 4, 8),
                   "upsample2x_concat"),
    "pair": (fused_block_bench.bench_pair, (2, 8, 12, 8),
             "conv_pair_bn_relu"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_per_shape_function_runs_on_cpu(case):
    fn, args, wrapper = CASES[case]
    before = launch_counts()
    rec = fn(*args, device="cpu", iters=2)
    assert launch_counts() == before        # the plain path launches nothing
    assert rec["device"] == "cpu" and rec["clock"] == "host"
    assert rec["dtype"] == "bfloat16"
    # one checked call, 3 warm-up calls and 2 timed ones
    assert rec["calls"] == {wrapper: 6}
    # on the CPU the wrapper is the plain version: identical results
    assert rec["max_abs_err"] == 0.0 and rec["ref_max_abs"] > 0
    assert rec["kernel_ms"] > 0 and rec["library_ms"] > 0


@pytest.fixture
def tiny_shapes(monkeypatch):
    monkeypatch.setattr(kernel_bench, "CONV_SHAPES", [(8, 8, 16)])
    monkeypatch.setattr(kernel_bench, "UPS_SHAPES", [(4, 8, 4, 8)])
    monkeypatch.setattr(fused_block_bench, "SHAPES", [(8, 8, 16),
                                                      (9, 16, 8)])


def _bench_records():
    """The repo root's bench records (FUSED_BLOCK_BENCH.json and its
    kind), which the JAX tools write and the port's never may."""
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes())
            for p in ROOT.glob("*BENCH*.json")}


@pytest.mark.parametrize("tool", TOOLS, ids=TOOL_IDS)
def test_out_is_the_only_file_written(tool, tiny_shapes, tmp_path,
                                      monkeypatch):
    run_dir = tmp_path / "cwd"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    before = _bench_records()
    assert "FUSED_BLOCK_BENCH.json" in before

    res = tool.main(["--device", "cpu"])
    assert list(run_dir.iterdir()) == []

    out = tmp_path / "result.json"
    res_out = tool.main(["--device", "cpu", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["rows"] and saved["calls"] == res_out["calls"]
    assert res["calls"] == res_out["calls"]
    assert sum(res["calls"].values()) == sum(
        n for row in res["rows"] for n in row["calls"].values())

    assert list(run_dir.iterdir()) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cwd",
                                                          "result.json"]
    assert _bench_records() == before
