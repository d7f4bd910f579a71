"""Shared AF_UNIX HTTP serving scaffold.

One implementation of the unix-socket HTTP server + handler base the
agent's REST API (api/server.py) and the health sidecar's API
(health/standalone.py) both serve on — the cilium.sock /
cilium-health.sock convention of the reference. Kept free of daemon
imports so sidecar processes can use it without pulling in torch."""

from __future__ import annotations

import json
import os
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class UnixHTTPServer(ThreadingHTTPServer):
    address_family = socket.AF_UNIX
    daemon_threads = True
    allow_reuse_address = False

    def server_bind(self):
        path = self.server_address
        if isinstance(path, str) and os.path.exists(path):
            os.unlink(path)
        self.socket.bind(path)

    def server_activate(self):
        self.socket.listen(64)


class UnixHandler(BaseHTTPRequestHandler):
    """Handler base: unix-peer address, quiet logs, JSON/text replies."""

    # BaseHTTPRequestHandler assumes AF_INET client addresses
    def address_string(self) -> str:
        return "unix"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
