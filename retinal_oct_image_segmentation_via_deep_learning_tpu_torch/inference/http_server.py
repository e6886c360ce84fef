"""Minimal HTTP serving frontend over the micro-batching ServingLoop.

Stdlib only (``http.server``). Endpoints:

* ``GET  /healthz``  -> ``{"ok": true, "requests_served": N, ...}``
* ``POST /predict``  -> body is a raw ``.npy`` array, either one image
  (H, W, C) or a batch (N, H, W, C); response is the ``.npy`` label map(s)
  (H, W) / (N, H, W). Concurrent requests from many clients coalesce into
  fixed-shape device batches inside ``ServingLoop``.

Run via the CLI (``python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli
serve ...``), or embed ``serve_forever`` / ``make_server`` directly.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .server import ServingLoop


def make_server(loop: ServingLoop, host: str = "127.0.0.1",
                port: int = 8765) -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer bound to the ServingLoop."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; observability via /healthz
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                return self._send_json(404, {"error": "unknown path"})
            self._send_json(200, {
                "ok": True,
                "image_shape": list(loop.image_shape),
                "batch_size": loop.batch_size,
                "requests_served": loop.requests_served,
                "batches_run": loop.batches_run,
                "batch_fill": loop.batch_fill,
                "queue_wait_s": loop.queue_wait_s,
            })

        def do_POST(self):
            if self.path != "/predict":
                return self._send_json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                batched = arr.ndim == len(loop.image_shape) + 1
                imgs = arr if batched else arr[None]
                futs = [loop.submit(np.asarray(im, np.float32))
                        for im in imgs]
                out = np.stack([np.asarray(f.result(timeout=120))
                                for f in futs])
                buf = io.BytesIO()
                np.save(buf, out if batched else out[0])
                self._send(200, buf.getvalue(), "application/octet-stream")
            except (ValueError, RuntimeError) as e:
                self._send_json(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._send_json(500, {"error": repr(e)})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(loop: ServingLoop, host: str = "127.0.0.1",
                  port: int = 8765):
    """Start the loop + HTTP server; blocks until KeyboardInterrupt."""
    loop.warmup().start()
    httpd = make_server(loop, host, port)
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(batch {loop.batch_size}, image {loop.image_shape}, "
          f"device {loop.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        loop.close()


def start_in_background(loop: ServingLoop, host: str = "127.0.0.1",
                        port: int = 0):
    """Test/embedding helper: returns (httpd, thread); port 0 = ephemeral."""
    loop.start()
    httpd = make_server(loop, host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t
