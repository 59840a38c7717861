"""The port's HTTP server (segtpu_torch.infer.serve) over a bf16
Segmenter's serving artifact, case for case with the HTTP cases of
tests/test_export.py, and the protocol against the JAX package's server
and client (segtpu.infer.serve): each package's client talks to the
other's server. Also the artifact's bf16 autocast region.

Tolerances, and why:
- an HTTP response against what the server's in-process ``ServingModel``
  computes for the same ``.npy`` body: equal, bit for bit (the server
  adds no arithmetic);
- the bf16 artifact against the live bf16 ``predict_proba``: 2^-8, since
  the artifact applies its sigmoid to f32 logits (as JAX's serving graph
  does) and the live path to bf16 ones, which rounds a probability by up
  to 2^-9; its logits within 1e-4 of their scale of the live bf16
  model's (the f32 sigmoid's inversion) and farther than that from the
  f32 model's (bf16 moves them by about 1e-2 of it).
"""

import json
import os
import threading
from urllib.error import HTTPError
from urllib.request import urlopen

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu.infer import export as jexport
from segtpu.infer import serve as jserve
from segtpu_torch.api import Segmenter
from segtpu_torch.infer import export as texport
from segtpu_torch.infer import serve as tserve
from segtpu_torch.infer.predict import nhwc_forward
from segtpu_torch.train.engine import TrainState

SIZE = 32
# a request cap that fits a 3-image batch, not a 4-image one
CAP = 3 * SIZE * SIZE * 4 + 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(path, **kw):
    server = tserve.make_server(path, device="cpu", **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def segmenter():
    """A bf16 Segmenter of a 32² attention U-Net (resnet_tiny): seeded
    weights, BatchNorm statistics drawn from the same generator."""
    seg = Segmenter(backbone="resnet_tiny", use_attention=True,
                    device="cpu", config={"img_size": (SIZE, SIZE),
                                          "dtype": "bfloat16"})
    gen = torch.Generator().manual_seed(3)
    model = seg.engine.build_model().reset_parameters(gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                n = bn.num_features
                bn.running_mean.copy_(0.05 * torch.randn(n, generator=gen))
                bn.running_var.copy_(0.8 + 0.4 * torch.rand(n,
                                                            generator=gen))
    seg.state = TrainState(model.eval())
    return seg


@pytest.fixture(scope="module")
def artifact(segmenter, tmp_path_factory):
    """The Segmenter exported with a symbolic batch."""
    return segmenter.export(str(tmp_path_factory.mktemp("art") / "a"))


@pytest.fixture(scope="module")
def sm(artifact):
    return texport.ServingModel(artifact, device="cpu")


@pytest.fixture(scope="module")
def server_url(artifact):
    """The direct-path server of the HTTP cases, capped at CAP bytes."""
    server, url = _server(artifact, max_body_bytes=CAP)
    yield url
    _stop(server)


@pytest.fixture(scope="module")
def tiled_url(artifact):
    server, url = _server(artifact, tiled=True, tile_overlap=16)
    yield url
    _stop(server)


def test_http_serving_roundtrip(sm, server_url):
    url = server_url
    health = json.load(urlopen(f"{url}/health", timeout=30))
    assert health["status"] == "ok" and health["img_size"] == [SIZE, SIZE]
    x = np.random.default_rng(2).random((3, SIZE, SIZE, 1), np.float32)
    got = tserve.client_predict(url, x)
    want = sm.predict_proba(x)
    np.testing.assert_array_equal(got, want)
    masks = tserve.client_predict(url, x, threshold=0.5)
    assert masks.dtype == np.uint8
    np.testing.assert_array_equal(masks, (want > 0.5).astype(np.uint8))
    with pytest.raises(HTTPError) as ei:
        tserve.client_predict(url, np.zeros((1, 7, 7, 1), np.float32))
    assert ei.value.code == 400


def test_http_serving_tiled_whole_slide(sm, tiled_url):
    """A tiled server routes other sizes through tiled inference on the
    artifact and exported-size inputs through the direct path; /health
    advertises the tiling."""
    url = tiled_url
    health = json.load(urlopen(f"{url}/health", timeout=30))
    assert health["tiled"]["enabled"] is True
    assert health["tiled"]["mode"] == "halo"
    rng = np.random.default_rng(9)
    big = rng.random((1, 2 * SIZE, SIZE + 8, 1), np.float32)
    want = sm.predict_proba_tiled(big, overlap=16)
    np.testing.assert_array_equal(tserve.client_predict(url, big), want)
    masks = tserve.client_predict(url, big, threshold=0.5)
    np.testing.assert_array_equal(masks, (want > 0.5).astype(np.uint8))
    x = rng.random((2, SIZE, SIZE, 1), np.float32)
    np.testing.assert_array_equal(tserve.client_predict(url, x),
                                  sm.predict_proba(x))


def test_http_serving_concurrent_clients(sm, server_url):
    """Eight threads POST at once and each gets its own answer (the
    single-flight lock serialises the device work)."""
    rng = np.random.default_rng(4)
    inputs = [rng.random((2, SIZE, SIZE, 1), np.float32) for _ in range(8)]
    wants = [sm.predict_proba(x) for x in inputs]
    results, errs = [None] * len(inputs), []

    def worker(i):
        try:
            results[i] = tserve.client_predict(server_url, inputs[i],
                                               timeout=120)
        except Exception as e:  # pragma: no cover - reported below
            errs.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not errs and not any(t.is_alive() for t in threads)
    for got, want in zip(results, wants):
        np.testing.assert_array_equal(got, want)


def test_http_serving_payload_cap(server_url):
    """A Content-Length above the cap gets 413 before the body is read;
    the server goes on answering."""
    url = server_url
    x_ok = np.zeros((2, SIZE, SIZE, 1), np.float32)
    assert tserve.client_predict(url, x_ok).shape == (2, SIZE, SIZE, 1)
    with pytest.raises(HTTPError) as ei:
        tserve.client_predict(url, np.zeros((4, SIZE, SIZE, 1), np.float32))
    assert ei.value.code == 413
    assert "max_body_bytes" in ei.value.read().decode()
    assert tserve.client_predict(url, x_ok).shape == (2, SIZE, SIZE, 1)


class _TinyNet(nn.Module):
    """The JAX server's model: conv, BatchNorm, ReLU, conv (as in
    tests/test_tta.py), enough for the protocol."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Conv(4, (3, 3), padding="SAME")(x)
        x = nn.BatchNorm(use_running_average=not train)(x)
        return nn.Conv(1, (3, 3), padding="SAME")(nn.relu(x))


def test_each_packages_client_talks_to_the_other_server(sm, server_url,
                                                         tmp_path):
    """The JAX client against the port's server and the port's client
    against the JAX server: the same ``.npy`` bodies, thresholds and
    error codes either way."""
    m = _TinyNet()
    v = m.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 1)))
    jax_path = jexport.save_serving(str(tmp_path / "jax"), m, v["params"],
                                    v["batch_stats"], (SIZE, SIZE))
    jax_server = jserve.make_server(jax_path)
    threading.Thread(target=jax_server.serve_forever, daemon=True).start()
    jax_url = f"http://127.0.0.1:{jax_server.server_address[1]}"
    x = np.random.default_rng(10).random((2, SIZE, SIZE, 1), np.float32)
    try:
        want = sm.predict_proba(x)
        np.testing.assert_array_equal(jserve.client_predict(server_url, x),
                                      want)
        np.testing.assert_array_equal(
            jserve.client_predict(server_url, x, threshold=0.5),
            (want > 0.5).astype(np.uint8))
        jwant = jexport.ServingModel(jax_path).predict_proba(x)
        np.testing.assert_array_equal(tserve.client_predict(jax_url, x),
                                      jwant)
        np.testing.assert_array_equal(
            tserve.client_predict(jax_url, x, threshold=0.5),
            (jwant > 0.5).astype(np.uint8))
        bad = np.zeros((1, 7, 7, 1), np.float32)
        for client, url in ((jserve.client_predict, server_url),
                            (tserve.client_predict, jax_url)):
            with pytest.raises(HTTPError) as ei:
                client(url, bad)
            assert ei.value.code == 400
        health = json.load(urlopen(f"{server_url}/health", timeout=30))
        jhealth = json.load(urlopen(f"{jax_url}/health", timeout=30))
        assert set(jhealth) <= set(health)
    finally:
        _stop(jax_server)


def _graph_ops(ep) -> dict:
    ops = {}
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function":
                    ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    return ops


def _logit(p):
    return np.log(p) - np.log1p(-p)


def test_bf16_artifact_holds_an_autocast_region(segmenter, artifact, sm):
    """A bf16 Segmenter's artifact computes in bf16: the graph keeps a
    ``wrap_with_autocast`` region (``torch.export`` drops an autocast the
    caller holds); its probabilities sit within 2^-8 of the live bf16
    ``predict_proba``; its logits (recovered from its f32 sigmoid) sit on
    the live bf16 model's and off the f32 model's."""
    seg = segmenter
    ep = torch.export.load(os.path.join(artifact, "model.pt2"))
    assert _graph_ops(ep).get("wrap_with_autocast") == 1
    assert _graph_ops(ep).get("segtpu_torch.attention_gate.default") == 4
    assert sm.meta["compute_dtype"] == "bfloat16"
    x = np.random.default_rng(6).random((1, SIZE, SIZE, 1), np.float32)
    got = sm.predict_proba(x)
    assert np.abs(got - seg.predict_proba(x)).max() <= 2.0 ** -8
    t = torch.from_numpy(x)
    with torch.inference_mode():
        with seg.engine.autocast():
            bf16 = nhwc_forward(seg.state.model, t).float().numpy()
        f32 = nhwc_forward(seg.state.model, t).numpy()
    scale = np.abs(f32).max()
    err_bf16 = np.abs(_logit(got) - bf16).max() / scale
    err_f32 = np.abs(_logit(got) - f32).max() / scale
    assert err_bf16 <= 1e-4 < err_f32


def test_serve_tool_builds_the_server_from_its_flags(artifact, monkeypatch,
                                                     capsys):
    """``python -m segtpu_torch.tools.serve DIR`` passes its flags to
    ``make_server``, defaults to the card (raising without one) and closes
    the server when serving stops."""
    from segtpu_torch.tools import serve as tool
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main([artifact])
    seen = {}
    real = tserve.make_server

    def make_server(*args, **kw):
        server = real(*args, **kw)
        seen.update(kw, args=args)
        server.serve_forever = lambda: seen.update(served=True)
        return server

    monkeypatch.setattr(tserve, "make_server", make_server)
    tool.main([artifact, "--device", "cpu", "--port", "0", "--tiled",
               "--tile-mode", "blend", "--tile-overlap", "8",
               "--batch-tiles", "4"])
    assert seen["served"] and seen["device"] == "cpu"
    assert (seen["tiled"], seen["tile_mode"], seen["tile_overlap"],
            seen["batch_tiles"]) == (True, "blend", 8, 4)
    assert "tiled=blend/overlap8" in capsys.readouterr().out
