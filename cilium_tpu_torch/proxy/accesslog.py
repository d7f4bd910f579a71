"""L7 access-log records + collection.

Reference: pkg/proxy/accesslog/record.go:140,200,223 (LogRecord with
request/response type, verdict, endpoint info, HTTP/Kafka detail) and
pkg/envoy/accesslog_server.go (the unix-socket server receiving entries
from the C++ filter). Here records are produced in-process by the
enforcement hooks and fanned out to subscribers (monitor, logfile).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

TYPE_REQUEST = "Request"
TYPE_RESPONSE = "Response"

VERDICT_FORWARDED = "Forwarded"
VERDICT_DENIED = "Denied"
VERDICT_ERROR = "Error"


@dataclasses.dataclass
class LogRecord:
    type: str
    verdict: str
    timestamp: float
    src_identity: int = 0
    dst_identity: int = 0
    src_ep_id: int = 0
    dst_port: int = 0
    proto: str = ""
    http: Optional[Dict] = None  # {method, path, host, code}
    kafka: Optional[Dict] = None  # {api_key, topic, error_code}

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


class AccessLogServer:
    """In-process record sink with ring buffer + subscriber fan-out."""

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._ring: Deque[LogRecord] = deque(maxlen=capacity)
        self._subs: List[Callable[[LogRecord], None]] = []

    def subscribe(self, fn: Callable[[LogRecord], None]) -> None:
        with self._lock:
            self._subs.append(fn)

    def log(self, record: LogRecord) -> None:
        with self._lock:
            self._ring.append(record)
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(record)
            except Exception:  # noqa: BLE001 — log sinks never break enforcement
                pass

    def recent(self, n: int = 100) -> List[LogRecord]:
        with self._lock:
            return list(self._ring)[-n:]


class AccessLogSocketServer:
    """Unix-socket receiver for records streamed by out-of-process
    proxies (pkg/envoy/accesslog_server.go:50: the agent-side server
    the C++ accesslog sink connects to). Each frame is a JSON LogRecord
    dict; valid records land in the in-process AccessLogServer ring so
    monitor/REST consumers see external-proxy traffic identically to
    in-process enforcement."""

    def __init__(self, sink: AccessLogServer, socket_path: str) -> None:
        import os
        import socket as _socket

        self.sink = sink
        self.socket_path = socket_path
        self._stop = threading.Event()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self) -> "AccessLogSocketServer":
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        import socket as _socket

        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except _socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn) -> None:
        import socket as _socket

        from ..xds.server import _recv_msg

        conn.settimeout(0.2)
        try:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn, self._stop)
                except _socket.timeout:
                    continue
                except (ValueError, OSError):
                    return
                if msg is None:
                    return
                try:
                    known = {f.name for f in dataclasses.fields(LogRecord)}
                    self.sink.log(
                        LogRecord(**{k: v for k, v in msg.items() if k in known})
                    )
                except (TypeError, ValueError):
                    continue  # malformed record: drop, keep the stream
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
