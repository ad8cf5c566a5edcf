"""HTTP front for the serving engine (port of qtpu/serve/http_front.py).

A dependency-free front over :class:`qtpu_torch.serve.engine.ServingEngine`
on the standard library's ``http.server``: one thread per connection, and
the engine's scheduler batches across them (each image is submitted on its
own, so concurrent clients share rounds; the front adds no batching of its
own).  Numpy ``.npy`` bytes on the wire, self-describing in dtype and
shape:

* ``POST /predict`` — body: one ``.npy`` array of images, (B, H, W, C) or
  one (H, W, C) image; response: the ``.npy`` array of logits.  uint8
  arrays go as they are to a uint8-ingest engine.
* ``GET /stats`` — the engine's ``stats()`` as JSON (numbers as floats,
  ``rounds_per_bucket`` as ``{bucket: rounds}``).
* ``GET /metrics`` — the same in Prometheus' text format 0.0.4: one
  ``qtpu_serving_<stat>`` line per number (``images``, ``batches`` and
  ``rounds_per_bucket`` counters, the rest gauges), one
  ``qtpu_serving_rounds_per_bucket{bucket="8"}`` line per bucket, and
  ``qtpu_serving_healthy``.
* ``GET /healthz`` — 200 while the engine's scheduler lives, 503 after it
  crashed or stopped (``ServingEngine.healthy``).

A non-numeric Content-Length gets a 400.  A body over ``max_body_bytes``
gets a 413 without being buffered: up to 4× the limit it is read away in
1 MiB chunks, so the client sees the 413 and not a broken pipe; beyond
that the connection is closed.  An unhealthy engine gets a 503, also when
it dies during the request; any other failure is the client's (400), and
the engine serves on.

Client sketch::

    buf = io.BytesIO(); np.save(buf, images)
    r = urllib.request.urlopen("http://host:8000/predict", buf.getvalue())
    logits = np.load(io.BytesIO(r.read()))
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

DEFAULT_MAX_BODY_BYTES = 256 << 20   # 256 MiB ≈ B = 1024 of 224² f32 images
COUNTERS = frozenset({"images", "batches", "rounds_per_bucket"})


def stats_json(stats: Mapping[str, Any]) -> Dict[str, Any]:
    """``stats()`` with every number a float and the per-bucket dict as
    ``{"8": rounds, ...}``."""
    return {k: ({str(b): int(n) for b, n in v.items()}
                if isinstance(v, Mapping) else float(v))
            for k, v in stats.items()}


def prometheus_text(stats: Mapping[str, Any], healthy: bool) -> str:
    """The stats in Prometheus' text exposition format 0.0.4."""
    lines = []
    for k, v in stats.items():
        name = f"qtpu_serving_{k}"
        kind = "counter" if k in COUNTERS else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        if isinstance(v, Mapping):
            lines += [f'{name}{{bucket="{b}"}} {int(n)}'
                      for b, n in sorted(v.items())]
        else:
            lines.append(f"{name} {float(v):g}")
    lines += ["# TYPE qtpu_serving_healthy gauge",
              f"qtpu_serving_healthy {int(bool(healthy))}"]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    engine = None                             # set by serve_http
    max_body_bytes = DEFAULT_MAX_BODY_BYTES   # set by serve_http
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):        # quiet
        pass

    @property
    def _healthy(self) -> bool:
        return bool(getattr(self.engine, "healthy", True))

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200 if self._healthy else 503,
                            {"ok": self._healthy})
        elif self.path == "/stats":
            self._send_json(200, stats_json(self.engine.stats()))
        elif self.path == "/metrics":
            self._send(200, prometheus_text(self.engine.stats(),
                                            self._healthy).encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n < 0:       # rfile.read(n < 0) would wait for EOF
                raise ValueError(n)
        except ValueError:
            self.close_connection = True
            self._send_json(400, {"error": "invalid Content-Length header"})
            return
        if n > self.max_body_bytes:
            self.close_connection = True
            if n <= 4 * self.max_body_bytes:
                left = n
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 20))
                    if not chunk:
                        break
                    left -= len(chunk)
            self._send_json(413, {"error": f"body {n} bytes exceeds limit "
                                           f"{self.max_body_bytes}"})
            return
        if not self._healthy:
            self.close_connection = True
            self._send_json(503, {"error": "engine stopped or unhealthy"})
            return
        try:
            arr = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
            if arr.ndim == 3:
                arr = arr[None]
            logits = self.engine.predict(np.ascontiguousarray(arr))
            buf = io.BytesIO()
            np.save(buf, np.asarray(logits))
            self._send(200, buf.getvalue(), "application/octet-stream")
        except Exception as e:      # the engine's or the body's error
            self._send_json(503 if not self._healthy else 400,
                            {"error": str(e)})


def serve_http(engine, host: str = "0.0.0.0", port: int = 8000,
               block: bool = True,
               max_body_bytes: int = DEFAULT_MAX_BODY_BYTES
               ) -> Tuple[ThreadingHTTPServer, Optional[threading.Thread]]:
    """Serve ``engine`` over HTTP; returns ``(server, thread)``.
    ``block=False`` runs the server on a daemon thread; stop it with
    ``server.shutdown()``.  ``port=0`` binds a free port
    (``server.server_address[1]``)."""
    handler = type("BoundHandler", (_Handler,),
                   {"engine": engine, "max_body_bytes": int(max_body_bytes)})
    server = ThreadingHTTPServer((host, port), handler)
    if block:
        server.serve_forever()
        return server, None
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="qtpu-torch-http-front")
    t.start()
    return server, t
