"""The per-layer readers' and the trace reduction's arithmetic on
hand-made profiles."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from rehearsal import ROOT


def _module(name):
    from portbench.spec import load_module
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                       "metric")


def _reader(name):
    return _module(name).read


def _trace(device_by_name, busy_s=0.6, window_s=1.0, ops=()):
    from portbench.trace import Trace
    return Trace(window_s=window_s, busy_s=busy_s,
                 device_ops=[(n, 0.0, t) for n, t in device_by_name.items()],
                 ops=list(ops), device_by_name=dict(device_by_name))


def _ctx(trace, **kw):
    base = dict(trace=trace, units=2, untraced_units=8, untraced_s=4.0,
                trained_per_unit=10, validated_per_unit=2,
                forward_flops=1e12, counters={},
                model_cfg=json.loads((ROOT / "portbench" / "configs"
                                      / "unet-r34-att.json").read_text()),
                traffic={"batch_size": 8, "image_size": 512})
    base.update(kw)
    return SimpleNamespace(**base)


def test_shares_idle_and_mfu():
    tr = _trace({"cudnn_batch_norm_fw_kernel": 0.2,
                 "sm90_xmma_fprop_kernel": 0.3,
                 "Memcpy HtoD (Pageable -> Device)": 0.04,
                 "Memcpy DtoH (Device -> Pageable)": 0.06})
    ctx = _ctx(tr)
    assert _reader("bn_share.train")(ctx) == pytest.approx(100 * 0.2 / 0.6)
    # busy 0.6 s over 2 profiled folds against 0.5 s a fold unprofiled
    assert _reader("device_idle.train")(ctx) == pytest.approx(40.0)
    # (3·10 + 2) forwards of 1 TFLOP a fold, 0.5 s a fold
    assert _reader("mfu.train")(ctx) == pytest.approx(
        100 * 64e12 / 989e12)


def test_readers_with_nothing_to_read_return_none():
    for name in ("bn_share.train", "device_idle.train", "mfu.train",
                 "gate_roofline"):
        assert _reader(name)(_ctx(None)) is None
    empty = _ctx(_trace({}))
    for name in ("bn_share.train", "device_idle.train", "mfu.train",
                 "gate_roofline"):
        assert _reader(name)(empty) is None
    # a window too short to time a fold after the profiled ones
    short = _ctx(_trace({"sm90_xmma_fprop_kernel": 0.3}), untraced_units=0,
                 untraced_s=0.0)
    for name in ("device_idle.train", "mfu.train"):
        assert _reader(name)(short) is None
    assert _reader("capture_s.train")(_ctx(None)) is None
    assert _reader("capture_s.train")(
        _ctx(None, counters={"capture_s": 1.5})) == 1.5


def test_roofline_readers_ask_for_their_ops_shapes():
    assert _module("gate_roofline").ops == ("segtpu_torch::attention_gate",)


def test_gate_roofline_is_the_least_time_over_the_kernel_time():
    from portbench import counts
    shapes = [[16, 32, 32, 256], [16, 32, 32, 256], [256, 128], [256, 128],
              [128], [128], [1]]
    ops = [("segtpu_torch::attention_gate", shapes,
            ["c10::BFloat16"] * 4 + ["float"] * 3)] * 2
    least = counts.bound(*counts.gate_bytes_ops(16 * 32 * 32, 256, 256, 128,
                                                torch.bfloat16),
                         torch.bfloat16)[0] * 1e-3
    tr = _trace({"void gate_bf16_kernel<Cfg>(...)": 4 * least,
                 "other": 1.0}, ops=ops)
    assert _reader("gate_roofline")(_ctx(tr)) == pytest.approx(50.0)


def test_gate_roofline_of_replayed_forwards_takes_the_configs_levels():
    """No recorded calls (the gates ran inside CUDA graph replays): each
    four gate launches are one forward of ``batch_size`` images at the
    configuration's four levels."""
    from portbench import counts
    least = 0.0
    for cg, cx, f, hw in ((256, 256, 128, 32), (128, 128, 64, 64),
                          (64, 64, 32, 128), (32, 64, 32, 256)):
        least += counts.bound(*counts.gate_bytes_ops(
            8 * hw * hw, cg, cx, f, torch.bfloat16), torch.bfloat16)[0]
    name = "void gate_bf16_kernel<Cfg>(...)"
    from portbench.trace import Trace
    tr = Trace(window_s=1.0, busy_s=1.0,
               device_ops=[(name, 0.0, 1e-4)] * 8, ops=[],
               device_by_name={name: 4 * least * 1e-3})
    assert _reader("gate_roofline")(_ctx(tr)) == pytest.approx(50.0)


class _Ev:
    def __init__(self, name, start_us, end_us, cuda):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = SimpleNamespace(start=start_us, end=end_us)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.input_shapes = []


def test_reduce_unions_device_time_and_labels_idle_gaps():
    from portbench.trace import WINDOW_SPAN, breakdown, reduce_events
    evs = [_Ev(WINDOW_SPAN, 0, 100, False),
           _Ev("portbench.fold", 0, 100, False),
           _Ev("portbench.fold", 10, 90, True),     # its device mirror
           _Ev("aten::copy_", 40, 70, False),
           _Ev("k1", 0, 30, True), _Ev("k2", 20, 40, True),
           _Ev("Memcpy HtoD", 70, 90, True), _Ev("k3", 95, 120, True)]
    tr = reduce_events(evs)
    assert tr.window_s == pytest.approx(100e-6)
    # busy: [0,40] ∪ [70,90] ∪ [95,100] inside the window
    assert tr.busy_s == pytest.approx(65e-6)
    assert tr.device_by_name["k2"] == pytest.approx(20e-6)
    assert "portbench.fold" not in tr.device_by_name
    assert tr.idle_by_label == pytest.approx({
        "portbench.fold: aten::copy_": 30e-6,
        "portbench.fold: Python, in no op": 5e-6})
    b = breakdown(tr)
    assert b["device_ops"][0][0] == "k1"
    assert b["idle_gaps"][0][0] == "portbench.fold: aten::copy_"
