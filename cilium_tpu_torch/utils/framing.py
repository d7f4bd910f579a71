"""Shared socket framing: 4-byte little-endian length + JSON payload.

One wire convention for every in-repo socket protocol (xds, monitor,
accesslog, kvstore). The stop-event-aware receivers in xds/server.py
keep their own mid-frame deadline loops — this module covers the
common blocking case.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Optional

HDR = struct.Struct("<I")
MAX_FRAME = 64 << 20


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on EOF/error/timeout."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def send_json(
    sock: socket.socket, obj: dict, wlock: Optional[threading.Lock] = None
) -> None:
    """One frame out; ``wlock`` serializes concurrent writers."""
    data = json.dumps(obj, separators=(",", ":")).encode()
    frame = HDR.pack(len(data)) + data
    if wlock is not None:
        with wlock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def recv_json(sock: socket.socket) -> Optional[dict]:
    """One frame in; None on EOF/error. Raises ValueError on an
    oversized length prefix (protocol desync / wrong service)."""
    hdr = recv_exact(sock, HDR.size)
    if hdr is None:
        return None
    (size,) = HDR.unpack(hdr)
    if size > MAX_FRAME:
        raise ValueError(f"frame of {size} bytes exceeds limit")
    body = recv_exact(sock, size)
    if body is None:
        return None
    return json.loads(body)
