"""HTTP inference endpoint for exported artifacts (stdlib-only).

Production serving surface on top of :mod:`spectralae_torch.io.export`
(the reference's inference is welded to an OpenCV window loop,
source/autoencoder.cpp:121-151): a ``ThreadingHTTPServer`` exposing an
exported :class:`ServingModel` —

- ``GET /healthz`` → JSON: status + artifact manifest summary;
- ``POST /infer`` → body is an ``.npy``-serialized float32 batch
  (``[B, D, H, W]`` or a single ``[D, H, W]`` frame); response is the
  ``.npy``-serialized model output.  Content type
  ``application/octet-stream``.

Device calls are serialized under a lock (one device model, many HTTP
worker threads); request decode/encode runs concurrently.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _BatchItem:
    __slots__ = ("arr", "event", "out", "err", "abandoned")

    def __init__(self, arr):
        self.arr = arr
        self.event = threading.Event()
        self.out = None
        self.err = None
        # set when the waiter timed out: the dispatcher must not spend
        # device time on a request whose client already got an error
        self.abandoned = False


class _DynamicBatcher:
    """Coalesce concurrent inference requests into one device call.

    Handler threads enqueue ``[B_i, ...]`` arrays; a dispatcher thread
    collects whatever arrives within ``window_s`` (up to ``max_batch``
    frames), runs the model ONCE on the concatenated batch, and fans the
    outputs back out.  Requires a batch-polymorphic artifact.  Under
    load this amortizes the per-call dispatch latency across requests —
    the standard dynamic-batching pattern of production inference
    servers; the reference has no serving story at all.
    """

    def __init__(self, model, window_s: float, max_batch: int):
        self._model = model
        self._window = window_s
        self._max = max_batch
        self._q: queue.Queue[_BatchItem] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="infer-batcher")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [] if first.abandoned else [first]
            frames = first.arr.shape[0] if batch else 0
            deadline = time.monotonic() + self._window
            while frames < self._max:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt.abandoned:
                    continue
                batch.append(nxt)
                frames += nxt.arr.shape[0]
            if not batch:
                continue
            try:
                out = np.asarray(self._model(
                    np.concatenate([b.arr for b in batch], axis=0)))
                ofs = 0
                for b in batch:
                    b.out = out[ofs:ofs + b.arr.shape[0]]
                    ofs += b.arr.shape[0]
            except Exception as e:  # pragma: no cover - device failure
                for b in batch:
                    b.err = e
            for b in batch:
                b.event.set()

    def infer(self, arr: np.ndarray, timeout: float = 300.0) -> np.ndarray:
        item = _BatchItem(arr)
        self._q.put(item)
        if not item.event.wait(timeout):
            item.abandoned = True
            raise TimeoutError("inference timed out")
        if item.err is not None:
            raise item.err
        return item.out

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)


class InferenceServer:
    """Wrap a :class:`spectralae_torch.io.export.ServingModel` in an HTTP
    server.

    ``port=0`` picks a free port (read it back from ``.port``).  Use
    :meth:`serve_forever` to block, or :meth:`start`/:meth:`shutdown`
    for a background thread (tests, embedding).  ``warmup`` runs one
    zero-filled inference before the server accepts traffic so the
    first real request doesn't pay one-time device start-up latency
    (kernel build and load, CUDA context and library initialisation).
    ``batch_window_ms > 0`` enables dynamic batching of concurrent
    requests (:class:`_DynamicBatcher`; needs a batch-polymorphic
    artifact — ignored for fixed-batch exports).
    """

    def __init__(self, model, host: str = "127.0.0.1", port: int = 8000,
                 warmup: bool = False,
                 max_request_bytes: int = 256 * 1024 * 1024,
                 batch_window_ms: float = 0.0, max_batch: int = 64):
        self._model = model
        self._lock = threading.Lock()
        self._batcher = None
        if batch_window_ms > 0 and model.manifest.get("batch") is None:
            self._batcher = _DynamicBatcher(model, batch_window_ms / 1e3,
                                            max_batch)
        if warmup:
            d, nx, ny = model.input_shape
            wb = model.manifest.get("batch") or 1
            np.asarray(model(np.zeros((wb, d, nx, ny), np.float32)))
        d, nx, ny = model.input_shape
        manifest = dict(model.manifest)
        summary = {"status": "ok",
                   "what": manifest.get("what"),
                   "domain": manifest.get("domain"),
                   "input_shape": [d, nx, ny],
                   "batch": manifest.get("batch"),
                   "platforms": manifest.get("platforms")}
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; the CLI logs summary lines
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, summary)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/infer":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > max_request_bytes:
                    # reject without BUFFERING (the memory bound), but
                    # drain the body in small chunks first — closing while
                    # the client is mid-write gives them EPIPE instead of
                    # this error response
                    left = n
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 16))
                        if not chunk:
                            break
                        left -= len(chunk)
                    self._json(413, {"error":
                                     f"payload {n} bytes exceeds the "
                                     f"{max_request_bytes}-byte limit"})
                    return
                try:
                    arr = np.load(io.BytesIO(self.rfile.read(n)),
                                  allow_pickle=False)
                except Exception as e:
                    self._json(400, {"error": f"bad npy payload: {e}"})
                    return
                squeeze = arr.ndim == 3
                if squeeze:
                    arr = arr[None]
                want = (d, nx, ny)
                if arr.ndim != 4 or arr.shape[1:] != want:
                    self._json(400, {"error":
                                     f"expected [B, {d}, {nx}, {ny}] "
                                     f"(or one frame), got {arr.shape}"})
                    return
                try:
                    arr = np.ascontiguousarray(arr, np.float32)
                    if server._batcher is not None:
                        out = server._batcher.infer(arr)
                    else:
                        with server._lock:
                            out = np.asarray(server._model(arr))
                except ValueError as e:
                    # e.g. fixed-batch artifact with the wrong batch size
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:  # device/runtime failure
                    self._json(500, {"error": f"inference failed: {e}"})
                    return
                if squeeze:
                    out = out[0]
                buf = io.BytesIO()
                np.save(buf, out)
                self._send(200, buf.getvalue(), "application/octet-stream")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._batcher is not None:
            self._batcher.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
