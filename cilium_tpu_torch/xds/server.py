"""xDS stream server + ACK tracking over a unix socket.

Reference: pkg/envoy/xds/server.go (ADS-style stream: the client
sends DiscoveryRequests carrying the last version it applied + the
response nonce; the server answers with versioned resource sets and
treats the next request as ACK or NACK), ack.go (AckingResourceMutator:
completions fire when every subscribed node ACKs the version a
mutation produced — endpoint regeneration blocks on that).

Wire format: length-framed JSON messages on a SOCK_STREAM unix
socket (the reference uses gRPC protos over a unix socket; framing
differs, the protocol state machine is the same).

    client → server  {"type_url", "version_info", "response_nonce",
                      "resource_names" | null, "error_detail"?}
    server → client  {"type_url", "version_info", "nonce",
                      "resources": {name: resource}}
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.completion import Completion
from ..utils.logging import get_logger
from .cache import ResourceCache

log = get_logger("xds")


_MAX_FRAME = 64 << 20  # bound allocations against corrupt lengths


def _send_msg(conn: socket.socket, msg: dict) -> None:
    data = json.dumps(msg).encode()
    conn.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(
    conn: socket.socket,
    stop: Optional[threading.Event] = None,
    frame_deadline: float = 30.0,
) -> Optional[dict]:
    """Read one length-framed JSON message. socket.timeout escapes
    ONLY between frames: once any byte of a frame is consumed, a
    timeout mid-frame keeps reading — surfacing it would discard the
    consumed bytes and permanently desync the stream (the next read
    would parse body bytes as a length header). The mid-frame retries
    are bounded: a set ``stop`` event or ``frame_deadline`` seconds
    without completing the frame aborts the connection (a client that
    stalls mid-frame must not pin its server thread forever)."""
    import time as _time

    started: Optional[float] = None  # set when the first byte lands

    def _give_up() -> bool:
        if stop is not None and stop.is_set():
            return True
        return (
            started is not None
            and _time.monotonic() - started > frame_deadline
        )

    hdr = b""
    while len(hdr) < 4:
        # checked every iteration, not just on timeout — a client
        # trickling bytes faster than the socket timeout must not
        # bypass the deadline
        if _give_up():
            return None
        try:
            chunk = conn.recv(4 - len(hdr))
        except socket.timeout:
            if not hdr:
                raise
            continue
        if not chunk:
            return None
        if started is None:
            started = _time.monotonic()
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    if n > _MAX_FRAME:
        raise ValueError(f"xds frame too large ({n})")
    buf = b""
    while len(buf) < n:
        if _give_up():
            return None
        try:
            chunk = conn.recv(n - len(buf))
        except socket.timeout:
            continue  # mid-frame: keep the stream in sync
        if not chunk:
            return None
        buf += chunk
    return json.loads(buf)


class XDSServer:
    """Serves the resource cache to stream clients and tracks ACKs."""

    def __init__(self, cache: ResourceCache, socket_path: str) -> None:
        self.cache = cache
        self.socket_path = socket_path
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._nonce = 0
        # (node, type_url) → highest ACKed version
        self._acked: Dict[Tuple[str, str], int] = {}
        # pending completions: (type_url, version, node) → [Completion]
        self._pending: List[Tuple[str, int, str, Completion]] = []

    # -- ack plumbing (ack.go) ------------------------------------------
    def wait_for_ack(
        self, type_url: str, version: int, node: str, comp: Completion
    ) -> None:
        """Register a completion that fires when ``node`` ACKs
        ``version`` (or any newer one) for ``type_url``."""
        with self._lock:
            if self._acked.get((node, type_url), -1) >= version:
                comp.complete()
                return
            self._pending.append((type_url, version, node, comp))

    def _on_ack(self, node: str, type_url: str, version: int) -> None:
        with self._lock:
            key = (node, type_url)
            if version > self._acked.get(key, -1):
                self._acked[key] = version
            fired, keep = [], []
            for (t, v, n, comp) in self._pending:
                if t == type_url and n == node and version >= v:
                    fired.append(comp)
                else:
                    keep.append((t, v, n, comp))
            self._pending = keep
        for comp in fired:
            comp.complete()

    def _on_nack(self, node: str, type_url: str, version: int,
                 detail: str) -> None:
        log.warning("xds NACK", fields={"node": node, "type": type_url,
                                        "version": version,
                                        "detail": detail})
        with self._lock:
            fired, keep = [], []
            for (t, v, n, comp) in self._pending:
                if t == type_url and n == node and version >= v:
                    fired.append(comp)
                else:
                    keep.append((t, v, n, comp))
            self._pending = keep
        for comp in fired:
            comp.complete(RuntimeError(f"NACK: {detail}"))

    def _fail_node(self, node: str, reason: str) -> None:
        with self._lock:
            fired, keep = [], []
            for (t, v, n, comp) in self._pending:
                (fired if n == node else keep).append((t, v, n, comp))
            self._pending = keep
        for (_t, _v, _n, comp) in fired:
            comp.complete(RuntimeError(f"{node}: {reason}"))

    def acked_version(self, node: str, type_url: str) -> int:
        with self._lock:
            return self._acked.get((node, type_url), -1)

    # -- stream serving --------------------------------------------------
    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_stream, args=(conn,), daemon=True
            ).start()

    def _serve_stream(self, conn: socket.socket) -> None:
        """One ADS-style stream (server.go processRequestStream): the
        client's first message names its node id; each request is an
        ACK/NACK of the previous response and a (re)subscription."""
        node = "unknown"
        try:
            conn.settimeout(0.2)
            hello = None
            while hello is None and not self._stop.is_set():
                try:
                    hello = _recv_msg(conn, self._stop)
                except socket.timeout:
                    continue
                if hello is None:
                    return  # EOF or mid-frame stall: drop the stream
            if not hello:
                return
            node = hello.get("node", "unknown")
            # per-(stream, type) subscription state
            subs: Dict[str, Optional[List[str]]] = {}
            sent_version: Dict[str, int] = {}
            sent_nonce: Dict[str, str] = {}

            def push(type_url: str) -> None:
                version, resources = self.cache.get(
                    type_url, subs[type_url]
                )
                with self._lock:
                    self._nonce += 1
                    nonce = str(self._nonce)
                _send_msg(conn, {
                    "type_url": type_url,
                    "version_info": version,
                    "nonce": nonce,
                    "resources": resources,
                })
                sent_version[type_url] = version
                sent_nonce[type_url] = nonce

            while not self._stop.is_set():
                try:
                    req = _recv_msg(conn, self._stop)
                except socket.timeout:
                    # version moved since last push? re-push
                    # (version() is copy-free — this runs 5×/s)
                    for t in list(subs):
                        if self.cache.version(t) > sent_version.get(t, -1):
                            push(t)
                    continue
                if req is None:
                    return
                t = req["type_url"]
                first = t not in subs
                names_changed = (not first) and subs[t] != req.get(
                    "resource_names"
                )
                subs[t] = req.get("resource_names")
                ver = int(req.get("version_info") or 0)
                if not first and not names_changed:
                    # stale-ACK guard (server.go nonce check): only a
                    # response to our LATEST push counts — a late ACK
                    # of an old response must not mark newer versions
                    # applied
                    if req.get("response_nonce") != sent_nonce.get(t):
                        continue
                    if req.get("error_detail"):
                        self._on_nack(node, t, ver,
                                      str(req["error_detail"]))
                    else:
                        self._on_ack(node, t, ver)
                # initial subscription or re-subscription with a new
                # resource set → push now (a same-version cache would
                # otherwise never deliver the newly requested names)
                if first or names_changed:
                    push(t)
        except (OSError, ValueError, KeyError) as e:
            # protocol failures must be diagnosable — a proxy stuck in
            # a reconnect loop with silent teardown is undebuggable
            log.warning("xds stream error", fields={
                "node": node, "error": f"{type(e).__name__}: {e}",
            })
        finally:
            # a dead stream can never ACK: fail its pending
            # completions instead of hanging wait_for_ack callers
            self._fail_node(node, "stream closed")
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
