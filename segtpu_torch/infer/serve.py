"""Minimal HTTP inference server over an exported serving artifact (port
of ``segtpu/infer/serve.py``; the protocol is byte for byte the same, so
either package's client talks to either server).

Completes the deployment story of ``segtpu_torch/infer/export.py``: a host
with torch, numpy and ``segtpu_torch.kernels`` (no model code) loads the
``torch.export`` artifact and serves it on ``device``. Stdlib-only
(http.server) around it.

Protocol (binary, zero-copy-friendly — JSON image payloads would be
~4× the bytes):

- ``GET /health``  → 200, JSON ``{"status": "ok", ...artifact meta}``
- ``POST /predict`` with an ``.npy`` body (``numpy.save`` of a
  ``(N, H, W[, 1])`` float array, normalized like the model's training
  inputs) → 200, ``.npy`` body of float32 sigmoid probabilities
  ``(N, H, W, C)``.
- ``POST /predict?threshold=0.5`` → ``.npy`` uint8 binary masks instead.

With ``tiled=True`` (CLI ``--tiled``), images whose spatial size differs
from the exported size are served through sliding-window tiled inference
on the artifact (halo mode by default, the whole-slide throughput
preset); exported-size inputs keep the direct path.

Batching is the client's job (the artifact's symbolic batch dimension
accepts any N); the server itself is intentionally a thin, dependency-
free adapter — front it with a real load balancer in production.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from segtpu_torch.infer.export import ServingModel

_MAX_BODY = 256 << 20  # default request cap: 256 MiB (~1000 512² floats)


def make_server(artifact_dir: str, host: str = "127.0.0.1",
                port: int = 0, max_body_bytes: int = _MAX_BODY,
                single_flight: bool = True, tiled: bool = False,
                tile_overlap: int = 32, tile_mode: str = "halo",
                batch_tiles: Optional[int] = None,
                device="cuda") -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address[1]``). Call ``serve_forever()`` or
    drive it from a thread in tests.

    ``max_body_bytes``: requests larger than this are rejected with 413
    before the body is read — an unbounded cap lets one client OOM the
    host by streaming an arbitrary Content-Length.

    ``single_flight``: serialize device execution across handler threads
    (default). ThreadingHTTPServer accepts requests concurrently, but
    there is ONE accelerator — concurrent dispatches just interleave on
    its queue while each holds its host-side buffers alive, raising peak
    memory for zero throughput. The lock bounds host memory to one
    request's working set; HTTP accept/read/write still overlap.

    ``tiled``: accept images of ANY spatial size — inputs that don't
    match the artifact's exported size are routed through sliding-window
    tiled inference on the artifact itself
    (``ServingModel.predict_proba_tiled``). Exported-size inputs still
    take the direct single-forward path. ``tile_mode="halo"`` +
    ``tile_overlap=32`` is the whole-slide throughput preset;
    ``batch_tiles`` bounds per-request peak device memory.

    ``device``: where the artifact runs (default ``cuda``; raises without
    CUDA unless ``device="cpu"``)."""
    model = ServingModel(artifact_dir, device=device)
    infer_lock = threading.Lock() if single_flight else None
    tiled_cfg = ({"enabled": True, "overlap": int(tile_overlap),
                  "mode": tile_mode, "batch_tiles": batch_tiles}
                 if tiled else {"enabled": False})
    if tiled:
        # fail at startup, not on the first odd-size request
        model._tiled_fn(tile_overlap, tile_mode, batch_tiles)

    class Handler(BaseHTTPRequestHandler):
        # quiet by default; tooling can override
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802
            if self.path.split("?")[0] == "/health":
                self._send_json(200, {"status": "ok", "tiled": tiled_cfg,
                                      **model.meta})
            else:
                self._send_json(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path != "/predict":
                self._send_json(404, {"error": "unknown path"})
                return
            # 400 for malformed requests, 500 for backend faults — load
            # balancers must see server-side failures (relay down, OOM)
            # as 5xx, not as unretryable client errors.
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if n > max_body_bytes:
                # Reject WITHOUT buffering the payload: the size guard is
                # pointless if the oversized body lands in memory. Drain
                # (read-and-discard in small chunks) up to a bounded
                # amount so a client mid-upload can still receive the 413
                # instead of a connection reset; beyond the drain cap we
                # close and the client may see a broken pipe.
                drain_cap = 32 << 20
                remaining = min(n, drain_cap)
                while remaining > 0:
                    got = self.rfile.read(min(remaining, 1 << 20))
                    if not got:
                        break
                    remaining -= len(got)
                if n > drain_cap:
                    self.close_connection = True
                self._send_json(413, {
                    "error": f"payload {n} bytes exceeds the server cap "
                             f"{max_body_bytes} (split the batch, or start "
                             f"the server with a larger max_body_bytes)"})
                return
            try:
                if n <= 0:
                    raise ValueError(f"bad Content-Length {n}")
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                threshold = _query_threshold(query)
            except Exception as e:
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            # whole-slide route: any non-exported spatial size goes through
            # tiled inference on the artifact (tiled servers only)
            use_tiled = (tiled and arr.ndim in (3, 4)
                         and tuple(arr.shape[1:3]) != model.img_size)

            def run():
                if use_tiled:
                    if threshold is None:
                        return model.predict_proba_tiled(
                            arr, overlap=tile_overlap, mode=tile_mode,
                            batch_tiles=batch_tiles)
                    return model.predict_tiled(
                        arr, threshold=threshold, overlap=tile_overlap,
                        mode=tile_mode, batch_tiles=batch_tiles)
                if threshold is None:
                    return model.predict_proba(arr)
                return model.predict(arr, threshold=threshold)

            try:
                if infer_lock is not None:
                    with infer_lock:
                        out = run()
                else:
                    out = run()
            except ValueError as e:   # input validation (size/channels)
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:    # backend fault
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            buf = io.BytesIO()
            np.save(buf, out)
            self._send(200, buf.getvalue(), "application/octet-stream")

    server = ThreadingHTTPServer((host, port), Handler)
    server.artifact_meta = model.meta  # introspection for tooling
    server.tiled_config = tiled_cfg
    return server


def _query_threshold(query: str) -> Optional[float]:
    from urllib.parse import parse_qs
    vals = parse_qs(query).get("threshold")
    return float(vals[0]) if vals else None


def client_predict(url: str, images: np.ndarray,
                   threshold: Optional[float] = None,
                   timeout: float = 60.0) -> np.ndarray:
    """Tiny stdlib client for the protocol above (also used by tests)."""
    from urllib.request import Request, urlopen

    buf = io.BytesIO()
    np.save(buf, np.asarray(images))
    q = f"?threshold={threshold}" if threshold is not None else ""
    req = Request(f"{url}/predict{q}", data=buf.getvalue(),
                  headers={"Content-Type": "application/octet-stream"})
    with urlopen(req, timeout=timeout) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)
