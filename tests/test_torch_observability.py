"""The port's observability and plots (segtpu_torch.core.{logging,tboard,
profiling}, the training loop's ``metrics_log`` and ``tensorboard_dir``,
segtpu_torch.viz) against the JAX package's, on the CPU:

- ``TBWriter``: the same file, byte for byte, as the JAX package's for
  the same scalars and wall times; the JAX package's tboard tests
  (tests/test_tboard.py) run on the port's module;
- ``MetricsLogger``: records, tensors turned to floats;
- ``train_model`` with ``metrics_log`` and ``tensorboard_dir`` writes the
  records the JAX loop writes (the same kinds, keys, epochs, steps, tags
  and LRs; metrics within the training tests' bars: loss rtol 1e-4, the
  rest atol 1e-2), both packages from the same weights, 2 epochs, with
  ``ema_decay`` (the ``ema_val/*`` scalars); with SGD, since Adam's
  sign-like first steps part two float32 trainings by more than those
  bars in the second epoch;
- ``StepTimer``, ``trace`` (a Chrome trace naming the ops and the
  annotation) and the three plots, also with matplotlib made
  unimportable.
"""

import json
import os
import struct
import sys
import time

import numpy as np
import pytest
import torch

import jax

from segtpu.core import tboard as jax_tb
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import create_model_state
from segtpu.train.engine import TrainState as JaxTrainState
from segtpu.train.loop import train_model as jax_train_model
from segtpu_torch.core import tboard as tb
from segtpu_torch.core.logging import MetricsLogger
from segtpu_torch.core.profiling import StepTimer, annotate, trace
from segtpu_torch.data import load_original_data, make_synthetic_dataset
from segtpu_torch.data.loader import prepare_data
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.train.engine import TrainState, get_engine
from segtpu_torch.train.loop import train_model
from segtpu_torch.viz import (plot_broadband_vs_fluorescence,
                              plot_class_imbalance, visualize_predictions)

S = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (several share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ TBWriter

def test_event_file_is_the_jax_writers_byte_for_byte(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    blobs = []
    for mod in (jax_tb, tb):
        with mod.TBWriter(str(tmp_path / mod.__name__)) as w:
            w.add_scalars({"lr": 1e-3, "train/loss": 0.6931, "val/iou": 0.5},
                          step=0)
            w.add_scalar("neg", -3.0, step=-2, wall_time=123.5)
            w.add_scalars({"ema_val/iou": np.float32(0.25)}, step=7)
            path = w.path
        assert os.path.basename(path).startswith(
            "events.out.tfevents.1700000000.250000.")
        blobs.append(open(path, "rb").read())
    assert blobs[1] == blobs[0]
    assert tb.encode_scalar_event(42.5, 7, {"a": 0.625}) == \
        jax_tb.encode_scalar_event(42.5, 7, {"a": 0.625})


def test_crc32c_known_answers():
    assert tb.crc32c(b"") == 0
    assert tb.crc32c(b"123456789") == 0xE3069283
    assert tb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tb.crc32c(bytes(range(32))) == 0x46DD794E


def test_roundtrip_own_reader(tmp_path):
    with tb.TBWriter(str(tmp_path / "run")) as w:
        w.add_scalar("val/iou", 0.75, step=0)
        w.add_scalars({"train/loss": 1.5, "val/loss": 2.25}, step=1,
                      wall_time=123.5)
        w.add_scalar("neg", -3.0, step=-2)
    events = list(tb.read_scalar_events(w.path))
    assert len(events) == 3
    assert events[0][1:] == (0, {"val/iou": np.float32(0.75)})
    assert events[1] == (123.5, 1, {"train/loss": 1.5, "val/loss": 2.25})
    assert events[2][1] == -2 and events[2][2]["neg"] == -3.0


def test_empty_scalars_writes_nothing_and_closed_writer_raises(tmp_path):
    with tb.TBWriter(str(tmp_path)) as w:
        w.add_scalars({}, step=0)
    assert list(tb.read_scalar_events(w.path)) == []
    with pytest.raises(ValueError, match="closed"):
        w.add_scalar("x", 1.0, 0)


def _two_events(tmp_path):
    with tb.TBWriter(str(tmp_path)) as w:
        w.add_scalar("a", 1.0, 0)
        w.add_scalar("b", 2.0, 1)
    return w.path, bytearray(open(w.path, "rb").read())


def test_corruption_in_a_non_tail_record_raises(tmp_path):
    path, blob = _two_events(tmp_path)
    blob[12] ^= 0xFF          # inside the file_version record's payload
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="crc"):
        list(tb.read_scalar_events(path))


@pytest.mark.parametrize("tear", ["truncated", "crc"])
def test_torn_tail_yields_the_prefix(tmp_path, tear):
    path, blob = _two_events(tmp_path)
    if tear == "truncated":
        blob = blob[:-5]
    else:
        blob[-6] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.warns(RuntimeWarning, match="torn tail"):
        events = list(tb.read_scalar_events(path))
    assert [e[2] for e in events] == [{"a": 1.0}]


def test_frame_record_layout():
    rec = tb.frame_record(b"hello")
    assert struct.unpack("<Q", rec[:8]) == (5,)
    assert rec[12:17] == b"hello" and len(rec) == 8 + 4 + 5 + 4


def test_proto_bytes_parse_with_tensorboard():
    event_pb2 = pytest.importorskip(
        "tensorboard.compat.proto.event_pb2")
    ev = event_pb2.Event.FromString(
        tb.encode_scalar_event(42.5, 7, {"val/iou": 0.625, "lr": 0.001}))
    assert (ev.wall_time, ev.step) == (42.5, 7)
    vals = {v.tag: v.simple_value for v in ev.summary.value}
    assert vals == {"val/iou": np.float32(0.625), "lr": np.float32(0.001)}


# ------------------------------------------------------- MetricsLogger

def test_metrics_logger_jsonl(tmp_path, capsys):
    path = str(tmp_path / "sub" / "m.jsonl")
    with MetricsLogger(path, echo=True) as log:
        log.log({"epoch": 0, "loss": 0.5}, kind="epoch")
        log.log({"epoch": 1, "loss": torch.tensor(0.25),
                 "iou": np.float32(0.5)}, kind="epoch")
    lines = [json.loads(line) for line in open(path)]
    assert [line["kind"] for line in lines] == ["epoch", "epoch"]
    assert lines[1]["loss"] == 0.25 and lines[1]["iou"] == 0.5
    assert all(isinstance(line["ts"], float) for line in lines)
    assert "[epoch] epoch=1, loss=0.2500, iou=0.5000" in capsys.readouterr(
        ).out


# ------------------------------------------- train_model's logs vs JAX

def _blobs(r, n):
    im = r.normal(70, 12, (n, S, S)).clip(0, 255).astype(np.uint8)
    m = np.zeros((n, S, S), np.uint8)
    yy, xx = np.mgrid[:S, :S]
    for i in range(n):
        cy, cx = r.integers(8, 24, 2)
        b = (yy - cy) ** 2 + (xx - cx) ** 2 < 40
        im[i][b] = np.clip(im[i][b].astype(int) + 90, 0, 255)
        m[i][b] = 1
    return im, m


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """Both packages' train_model from the same weights, 2 epochs of one
    batch of all 4 images (so that the packages' shuffles do not part
    them), with ``metrics_log``, ``tensorboard_dir`` and ``ema_decay``;
    returns per package (result, JSONL records, TB events)."""
    r = np.random.default_rng(4)
    ti, tm = _blobs(r, 4)
    vi, vm = _blobs(r, 2)
    cfg = dict(backbone="resnet_tiny", use_attention=False,
               img_size=(S, S), batch_size=4, verbose=False,
               loss_fn="combo", seed=0, ema_decay=0.5, optimizer="sgd",
               learning_rate=1e-2)
    p, s = create_model_state(JaxUNet(backbone="resnet_tiny",
                                      use_attention=False),
                              jax.random.key(0), (1, S, S, 1))
    out = []
    for pkg in ("jax", "port"):
        root = tmp_path_factory.mktemp(pkg)
        c = dict(cfg, metrics_log=str(root / "m.jsonl"),
                 tensorboard_dir=str(root / "tb"))
        if pkg == "jax":
            res = jax_train_model(None, ti, tm, vi, vm, num_epochs=2,
                                  config=c,
                                  initial_state=JaxTrainState(p, s, None))
        else:
            model = get_engine(c, device="cpu").build_model()
            model.load_state_dict(state_dict_from_jax(
                p, s, "resnet_tiny", False, device="cpu"))
            res = train_model(None, ti, tm, vi, vm, num_epochs=2,
                              device="cpu", config=c,
                              initial_state=TrainState(model))
        recs = [json.loads(line) for line in open(c["metrics_log"])]
        (ev_file,) = os.listdir(c["tensorboard_dir"])
        events = list(tb.read_scalar_events(
            os.path.join(c["tensorboard_dir"], ev_file)))
        out.append((res, recs, events))
    return out


def _close(g, w, key):
    if key.endswith("loss"):
        np.testing.assert_allclose(g, w, rtol=1e-4)
    elif key in ("epoch", "lr"):
        assert g == w
    else:
        np.testing.assert_allclose(g, w, atol=1e-2)


def test_metrics_log_records_match_jax(logged):
    (_, want, _), (res, got, _) = logged
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "epoch", "epoch"]
    for g, w, tr, va in zip(got, want, res["train_metrics"],
                            res["val_metrics"]):
        assert g.keys() == w.keys()
        for key in g.keys() - {"ts", "kind"}:
            _close(g[key], w[key], key)
        assert {k: g[f"train_{k}"] for k in tr} == tr
        assert {k: g[f"val_{k}"] for k in va} == va


def test_tensorboard_events_match_jax(logged):
    (_, _, want), (res, _, got) = logged
    assert [e[1] for e in got] == [e[1] for e in want] == [0, 1, 1]
    for g, w in zip(got, want):
        assert g[2].keys() == w[2].keys()
        for tag in g[2]:
            _close(g[2][tag], w[2][tag],
                    tag.split("/")[-1] if tag != "lr" else "lr")
    assert set(got[2][2]) == {f"ema_val/{k}" for k in res["ema_val_metrics"]}
    assert got[1][2]["val/iou"] == np.float32(res["val_metrics"][1]["iou"])


def test_logs_are_closed_when_an_epoch_raises(tmp_path, monkeypatch):
    r = np.random.default_rng(4)
    ti, tm = _blobs(r, 2)
    opened = []
    real = tb.TBWriter.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        opened.append(self)

    monkeypatch.setattr(tb.TBWriter, "__init__", spy)
    cfg = dict(backbone="resnet_tiny", img_size=(S, S), verbose=False,
               debug_nans=True, optimizer="sgd", learning_rate=1e30,
               metrics_log=str(tmp_path / "m.jsonl"),
               tensorboard_dir=str(tmp_path / "tb"))
    with pytest.raises(FloatingPointError):
        train_model(None, ti, tm, ti, tm, num_epochs=2, device="cpu",
                    config=cfg)
    assert len(opened) == 1 and opened[0]._f.closed


# ------------------------------------------------------------ profiling

def test_step_timer():
    t = StepTimer()
    for _ in range(3):
        with t.phase("a"):
            pass
    with t.phase("b"):
        time.sleep(0.002)
    s = t.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["b"]["mean_ms"] >= 2.0
    assert t.report().splitlines()[0].startswith("b ")


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3)
    with trace(str(tmp_path)) as d:
        with annotate("segtpu-phase"):
            torch.nn.functional.conv2d(x, w)
    (name,) = os.listdir(d)
    assert name.startswith("trace.") and name.endswith(".json")
    text = open(os.path.join(d, name)).read()
    assert "segtpu-phase" in text and "aten::conv2d" in text
    assert "traceEvents" in json.loads(text)


# ---------------------------------------------------------------- plots

@pytest.fixture(scope="module")
def viz_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("viz"))
    make_synthetic_dataset(root, n_images=4, image_type="W",
                           raw_size=(40, 56))
    make_synthetic_dataset(root, n_images=2, image_type="B",
                           raw_size=(40, 56), seed=1)
    return root


def _plots(viz_dir, out):
    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "bce"}, device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), 1e-3, 0.0)
    data = load_original_data(viz_dir, image_type="W")
    loader = prepare_data(data["image_paths"], data["mask_paths"],
                          batch_size=2, img_size=(S, S), shuffle=False,
                          device="cpu")
    return (visualize_predictions(engine, state, loader, num_samples=2,
                                  save_path=str(out / "pred.png")),
            plot_broadband_vs_fluorescence(viz_dir,
                                           save_path=str(out / "cmp.pdf")),
            plot_class_imbalance("W", viz_dir, img_size=(S, S),
                                 save_path=str(out / "imb.pdf"),
                                 device="cpu"))


def test_plots_are_drawn(viz_dir, tmp_path):
    pytest.importorskip("matplotlib")
    fig, cmp_fig, ratio = _plots(viz_dir, tmp_path)
    assert fig is not None and cmp_fig is not None
    assert 0.0 < ratio < 1.0
    assert sorted(os.listdir(tmp_path)) == ["cmp.pdf", "imb.pdf",
                                            "pred.png"]


def test_plots_without_matplotlib(monkeypatch, viz_dir, tmp_path, capsys):
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert _plots(viz_dir, tmp_path) == (None, None, None)
    assert capsys.readouterr().out.count(
        "figure not drawn: matplotlib is not installed") == 3
    assert os.listdir(tmp_path) == []
