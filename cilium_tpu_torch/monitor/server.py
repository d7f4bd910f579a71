"""Monitor socket: stream events to external listeners.

Reference: the standalone cilium-node-monitor serves the perf-ring
event stream to `cilium monitor` clients over a unix socket with a
length-framed binary payload protocol (monitor/monitor.go:184,
listener1_2.go). Same boundary here: each connected client gets its
own lossy Subscription off the hub; frames are ``u32 length`` +
events.py binary codec.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Iterator, Optional

from .events import decode, encode
from .hub import MonitorHub


class MonitorServer:
    def __init__(self, hub: MonitorHub, socket_path: str) -> None:
        self.hub = hub
        self.socket_path = socket_path
        self._sock: Optional[socket.socket] = None
        self._threads = []
        self._stop = threading.Event()
        self.clients = 0
        # serializes count updates AND their callbacks: two concurrent
        # attach/detach threads must deliver count frames in the order
        # the counts were computed, or the feeder's demand gate sticks
        self._clients_lock = threading.Lock()
        # fn(count) on every client attach/detach — the standalone
        # monitor relays this to the agent so an unwatched datapath
        # skips event construction
        self.on_clients = None

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # daemon client threads are fire-and-forget (they exit on
            # disconnect or stop) — retaining them would leak one
            # Thread object per reconnecting monitor client
            threading.Thread(
                target=self._serve_client, args=(conn,), daemon=True
            ).start()

    def _notify_clients(self, delta: int) -> None:
        with self._clients_lock:
            self.clients += delta
            cb = self.on_clients
            if cb is not None:
                try:
                    cb(self.clients)
                except Exception:
                    pass

    def _serve_client(self, conn: socket.socket) -> None:
        sub = self.hub.subscribe()
        self._notify_clients(+1)
        try:
            while not self._stop.is_set():
                ev = sub.next(timeout=0.2)
                if ev is None:
                    # idle: probe for disconnect — with no events to
                    # send, a closed client would otherwise never be
                    # noticed (the thread and its attach count leak;
                    # clients send nothing, so any bytes are discarded)
                    try:
                        if conn.recv(64, socket.MSG_DONTWAIT) == b"":
                            return
                    except BlockingIOError:
                        pass
                    continue
                # the standalone monitor's feed publishes wire-encoded
                # payloads straight through (no decode/re-encode)
                payload = (
                    ev if isinstance(ev, (bytes, bytearray)) else encode(ev)
                )
                conn.sendall(struct.pack("<I", len(payload)) + payload)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            sub.close()
            self._notify_clients(-1)
            conn.close()

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


def monitor_stream(socket_path: str, timeout: Optional[float] = 1.0) -> Iterator:
    """Client side (`cilium monitor`): connect and yield decoded
    events until the socket closes, or until ``timeout`` idle seconds
    pass (timeout=None blocks forever)."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect(socket_path)
    buf = b""
    try:
        while True:
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= 4:
                (n,) = struct.unpack("<I", buf[:4])
                if len(buf) < 4 + n:
                    break
                yield decode(buf[4:4 + n])
                buf = buf[4 + n:]
    finally:
        s.close()
