"""Remote inference serving: a GPU-resident engine server + thin client.

The reference offers remote inference through a Triton gRPC client mode
(`--use_triton_gpu`, reference: clair3/CallVariantsFromCffi.py:201-214):
tensor-creation hosts ship batches to a GPU serving process.  The
port's equivalent is this pair:

* ``python -m clair3_tpu_torch serve --model_path ... --port N`` loads both
  production engines on the GPU host (bf16 + CUDA kernels + compact wire
  forms, exactly `cli call`'s engines) and serves batch predictions over HTTP —
  raw ``.npy`` bodies in, raw ``.npy`` probabilities out, stdlib-only.
* ``RemoteEngine`` implements the engine protocol the pipeline consumes
  (``predict`` / ``predict_async`` / ``gather``), so CPU-only extraction
  hosts run the full cascade with ``call --remote_engines URL`` while the
  forward passes execute on the serving GPU.

Batches are self-describing (dtype + shape ride in the npy header), the
server runs one engine per model kind behind the InferenceEngine's own
submitter thread (one CUDA stream per engine), and prediction is
stateless — any number of calling hosts can share one server.
"""

from __future__ import annotations

import io
import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

_MAX_BODY = 1 << 31  # 2 GiB: a full 4096-candidate FA batch is ~96 MB


class _Coalescer:
    """Cross-request batch coalescing for one engine kind.

    N concurrent clients would otherwise serialize one small forward each
    behind the per-kind lock; instead handler threads enqueue
    (tensor, Future) pairs and a single dispatcher thread concatenates
    everything pending with a matching row shape into ONE forward, then
    splits the probabilities back per request.  Row-independent inference
    (no cross-row ops; batches pad to the same static bucket program)
    makes the coalesced outputs byte-identical to per-request forwards —
    asserted by tests/test_serve.py.

    ``window_s`` is the collection window after the first pending request
    (long enough for in-flight sibling requests to land, short next to a
    forward); ``max_rows`` bounds one coalesced batch.
    """

    def __init__(self, engine, max_rows: int = 8192,
                 window_s: float = 0.003):
        self.engine = engine
        self.max_rows = max_rows
        self.window_s = window_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: List = []  # (array, Future)
        self._closed = False
        # observability for the /stats endpoint and bench
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-coalesce")
        self._thread.start()

    def predict(self, x: np.ndarray) -> np.ndarray:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("server shutting down")
            self._pending.append((x, fut))
            self.requests += 1
            self._cv.notify()
        return fut.result()

    def _take_group(self) -> List:
        """Pop all pending requests whose row shape matches the oldest
        one's, up to max_rows total (others stay for the next batch).

        The oldest request is ALWAYS taken, even when it alone exceeds
        max_rows — otherwise an oversized single request (the pipeline
        ships whole-chunk tensors, which can pass 8192 rows) would never
        form a group and the dispatcher would spin forever."""
        oldest = self._pending[0]
        group, keep = [oldest], []
        rows = oldest[0].shape[0]
        shape = oldest[0].shape[1:]
        for item in self._pending[1:]:
            n = item[0].shape[0]
            if item[0].shape[1:] == shape and rows + n <= self.max_rows:
                group.append(item)
                rows += n
            else:
                keep.append(item)
        self._pending = keep
        return group

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            time.sleep(self.window_s)  # let sibling requests land
            with self._cv:
                group = self._take_group()
            xs = [g[0] for g in group]
            try:
                probs = np.asarray(self.engine.predict(
                    xs[0] if len(xs) == 1 else np.concatenate(xs, axis=0)))
            except Exception as exc:
                for _, fut in group:
                    fut.set_exception(exc)
                continue
            self.batches += 1
            off = 0
            for x, fut in group:
                n = x.shape[0]
                self.rows += n
                fut.set_result(probs[off:off + n])
                off += n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"requests": self.requests, "batches": self.batches,
                    "rows": self.rows}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=10)


def _dump_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _load_npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class EngineServer:
    """HTTP server around loaded inference engines.

    ``engines`` maps kind ("pileup" / "full_alignment") to objects with a
    ``predict(np.ndarray) -> np.ndarray`` method (normally InferenceEngine,
    oracle engines in tests).  Each engine sits behind a :class:`_Coalescer`
    — concurrent clients' batches merge into one forward instead of
    serializing, and the single dispatcher thread per kind means the
    engine's lazy submitter-pool init can never race."""

    def __init__(self, engines: Dict[str, object], host: str = "127.0.0.1",
                 port: int = 0, platform: Optional[str] = None,
                 coalesce_window_s: float = 0.003):
        self.engines = engines
        self._coalescers = {kind: _Coalescer(eng, window_s=coalesce_window_s)
                            for kind, eng in engines.items()}
        info: Dict = {"models": {}}
        if platform is not None:
            info["platform"] = platform
        for kind, eng in engines.items():
            meta = {}
            fa_in = getattr(eng, "fa_input_channels", None)
            if fa_in is not None:
                meta["input_channels"] = int(fa_in)
            info["models"][kind] = meta
        self._info = json.dumps(info).encode()

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/octet-stream"):
                if code != 200:
                    # error replies may leave an unread body on the socket;
                    # close rather than desync a keep-alive connection
                    self.close_connection = True
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if code != 200:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/info":
                    self._reply(200, server._info, "application/json")
                elif self.path == "/stats":
                    body = json.dumps({k: c.stats() for k, c in
                                       server._coalescers.items()}).encode()
                    self._reply(200, body, "application/json")
                else:
                    self._reply(404, b"not found", "text/plain")

            def do_POST(self):
                if not self.path.startswith("/predict/"):
                    self._reply(404, b"not found", "text/plain")
                    return
                kind = self.path[len("/predict/"):]
                eng = server.engines.get(kind)
                if eng is None:
                    self._reply(404, f"no engine {kind!r}".encode(),
                                "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0 or n > _MAX_BODY:
                    self._reply(400, b"bad Content-Length", "text/plain")
                    return
                try:
                    x = _load_npy(self.rfile.read(n))
                    probs = server._coalescers[kind].predict(x)
                except Exception as exc:  # surface to the client
                    self._reply(400, repr(exc).encode(), "text/plain")
                    return
                self._reply(200, _dump_npy(np.asarray(probs)))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def serve_background(self) -> str:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.address

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._httpd.server_close()
        for c in self._coalescers.values():
            c.close()

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-kind coalescing counters (requests / batches / rows)."""
        return {k: c.stats() for k, c in self._coalescers.items()}


class RemoteEngine:
    """Engine-protocol client for an EngineServer.

    ``predict_async`` ships batches from a single background thread so the
    caller's decode of batch i-1 overlaps batch i's network round-trip —
    the same overlap contract as InferenceEngine.predict_async."""

    def __init__(self, url: str, kind: str, timeout: float = 300.0,
                 platform: Optional[str] = None):
        self.url = url.rstrip("/")
        self.kind = kind
        self.timeout = timeout
        self._pool: Optional[ThreadPoolExecutor] = None
        # fail fast at construction (not hours into the pileup phase):
        # the server must actually host this engine kind, and a declared
        # server platform must match the client's
        info = self.info()
        models = info.get("models", {})
        if kind not in models:
            raise RuntimeError(
                f"engine server {self.url} does not serve {kind!r} "
                f"(available: {sorted(models)})")
        self.server_platform = info.get("platform")
        if (platform is not None and self.server_platform is not None
                and platform != self.server_platform):
            raise RuntimeError(
                f"engine server {self.url} serves platform "
                f"{self.server_platform!r}, client asked for {platform!r}")
        ch = models[kind].get("input_channels")
        if ch is not None:
            self.fa_input_channels = int(ch)

    def info(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.url + "/info",
                                    timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def _post(self, x: np.ndarray) -> np.ndarray:
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}/predict/{self.kind}", data=_dump_npy(x),
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return _load_npy(r.read())
        except Exception as exc:
            import urllib.error

            if isinstance(exc, urllib.error.HTTPError):
                raise RuntimeError(
                    f"remote engine {self.kind} failed: "
                    f"{exc.read().decode(errors='replace')}") from exc
            raise

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self._post(np.asarray(x))

    def predict_async(self, x: np.ndarray) -> List:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="remote-engine")
        return [self._pool.submit(self._post, np.asarray(x))]

    @staticmethod
    def gather(handles: List) -> np.ndarray:
        return np.concatenate([h.result() for h in handles], axis=0)


def build_server(model_path: str, platform: str = "ont",
                 compute_dtype: str = "auto", host: str = "127.0.0.1",
                 port: int = 8618, pileup_model: Optional[str] = None,
                 fa_model: Optional[str] = None,
                 pileup_prefix: str = "pileup",
                 fa_prefix: str = "full_alignment",
                 device: str = "cuda") -> EngineServer:
    """Load `cli call`'s production engines on ``device`` and wrap them in
    a server; ``cuda`` splits each batch over every visible card, and
    raises when no GPU is visible."""
    from clair3_tpu_torch.cli import _load_engine, resolve_compute_dtype, resolve_model_file
    from clair3_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    dt = resolve_compute_dtype(compute_dtype, dev)

    engines: Dict[str, object] = {}
    for kind, given, prefix in (("pileup", pileup_model, pileup_prefix),
                                ("full_alignment", fa_model, fa_prefix)):
        path = given
        if path is None and model_path:
            path = resolve_model_file(model_path, prefix)
        if path is None:
            if kind == "pileup":
                raise FileNotFoundError(
                    f"no pileup model under {model_path!r}")
            continue  # FA model optional (pileup-only serving)
        engines[kind] = _load_engine(path, kind, dev, dt)
    return EngineServer(engines, host=host, port=port, platform=platform)
