"""HTTP health and metrics (counterpart of ``obs_rvc_tpu/serve/health.py``):
``GET /healthz`` → 200 "ok"; ``GET /metrics`` → the JSON of a
:class:`~obs_rvc_tpu_torch.serve.metrics.MetricsSnapshot`: chunk latency and
counts, and the door's spans (p50/p95), stage times and counters.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def start_health_server(metrics, host: str = "127.0.0.1", port: int = 0, extra=None):
    """Serve on a daemon thread; returns ``(server, bound port)``. Call
    ``server.shutdown()`` and ``server.server_close()`` to stop it.

    ``extra``: an optional zero-argument callable whose dict is merged into
    the ``/metrics`` JSON."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/healthz":
                body, ctype = b"ok", "text/plain"
            elif self.path == "/metrics":
                snap = metrics.snapshot().as_dict()
                if extra is not None:
                    snap.update(extra())
                body, ctype = json.dumps(snap).encode(), "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True, name="rvc-health").start()
    return server, server.server_address[1]
