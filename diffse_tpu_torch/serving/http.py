"""HTTP front end of :class:`diffse_tpu_torch.serving.service.EnhanceService`
(port of diffse_tpu/serving/http.py).

Endpoints (stdlib ``ThreadingHTTPServer``: each connection blocks on its own
thread while the shared service batches across them, so concurrent clients
are what fills its flights):

- ``POST /enhance[?est_snr=<float>]``: body a WAV file (PCM16/24/32 or
  float32; the first channel is used). Response: the enhanced mono
  waveform as a float32 WAV at the input's sample rate.
- ``GET /healthz``: ``{"status": "ok"}``.
- ``GET /stats``: the service's counters (``EnhanceService.stats``).

The handler threads hand the service numpy arrays only; the service's
dispatcher is the one thread that touches the device.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..data.wavio import parse_wav, wav_bytes
from .service import EnhanceService, FlightTimeout, RequestTooLarge, ServiceOverloaded


def make_server(service: EnhanceService, host: str = "127.0.0.1", port: int = 0,
                max_body_bytes: int = 64 * 1024 * 1024) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free one
    (``server.server_address`` gives it).

    ``max_body_bytes`` caps the request body (413 before the body is read).
    Service failures map to status codes: RequestTooLarge 413,
    ServiceOverloaded 503 (with Retry-After), FlightTimeout 504, any other
    ValueError (a malformed WAV, an empty waveform) 400, anything else 500;
    a missing or empty body is 411."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102  (/stats is the record)
            pass

        def _send_json(self, code: int, obj, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {"status": "ok"})
            elif path == "/stats":
                self._send_json(200, service.stats())
            else:
                self._send_json(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/enhance":
                self._send_json(404, {"error": f"unknown path {url.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._send_json(411, {"error": "Content-Length required"})
                return
            if length > max_body_bytes:
                self._send_json(413, {"error": f"request body {length} bytes exceeds "
                                               f"max_body_bytes={max_body_bytes}"})
                return
            try:
                raw = self.rfile.read(length)
                data, sr = parse_wav(raw, name="<request>")
                q = parse_qs(url.query)
                est_snr = float(q["est_snr"][0]) if "est_snr" in q else None
                out = service.enhance(data[0], est_snr=est_snr)
            except RequestTooLarge as e:
                self._send_json(413, {"error": str(e)})
                return
            except ServiceOverloaded as e:
                self._send_json(503, {"error": str(e)}, headers=(("Retry-After", "1"),))
                return
            except FlightTimeout as e:
                self._send_json(504, {"error": str(e)})
                return
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 -- the request's boundary: report it
                self._send_json(500, {"error": str(e)})
                return
            body = wav_bytes(out, sr, subtype="float32")
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    """Start ``server.serve_forever`` on a daemon thread; stop it with
    ``server.shutdown()``."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
