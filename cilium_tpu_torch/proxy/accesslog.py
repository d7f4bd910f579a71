"""L7 access-log records + collection.

Reference: pkg/proxy/accesslog/record.go:140,200,223 (LogRecord with
request/response type, verdict, endpoint info, HTTP/Kafka detail) and
pkg/envoy/accesslog_server.go (the unix-socket server receiving entries
from the C++ filter). Here records are produced in-process by the
enforcement hooks and fanned out to subscribers (monitor, logfile).
The unix-socket receiver for out-of-process proxies
(``AccessLogSocketServer``) waits for the daemon slice of the port.
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
