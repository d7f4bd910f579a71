"""xDS stream client — the external proxy's subscription side.

Reference: the C++ NPDS subscription (envoy/cilium_network_policy.cc)
speaking to pkg/envoy/xds's server: subscribe to a type, apply each
versioned response, ACK it (or NACK with an error detail). The
handler's exception becomes the NACK detail, mirroring how a proto
validation failure NACKs in the reference.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Dict, List, Optional

from .server import _recv_msg, _send_msg

# handler(version, resources) — raise to NACK
Handler = Callable[[int, Dict[str, dict]], None]


class XDSClient:
    def __init__(self, socket_path: str, node: str) -> None:
        self.node = node
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(socket_path)
        _send_msg(self._sock, {"node": node})
        self._handlers: Dict[str, Handler] = {}
        self._subscribed: Dict[str, Optional[List[str]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.applied: Dict[str, int] = {}  # type_url → last ACKed version
        self._applied_cond = threading.Condition()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def subscribe(
        self,
        type_url: str,
        handler: Handler,
        resource_names: Optional[List[str]] = None,
    ) -> None:
        with self._lock:
            self._handlers[type_url] = handler
            self._subscribed[type_url] = resource_names
            # _lock serializes xDS frames onto the one client socket
            # (subscribe vs the ACK loop); the sendall under it is the
            # lock's purpose — control-plane only, never verdict-path
            _send_msg(self._sock, {  # policyd-lint: disable=LOCK002
                "type_url": type_url,
                "version_info": 0,
                "response_nonce": "",
                "resource_names": resource_names,
            })

    def wait_applied(self, type_url: str, version: int,
                     timeout: float = 5.0) -> bool:
        with self._applied_cond:
            return self._applied_cond.wait_for(
                lambda: self.applied.get(type_url, -1) >= version,
                timeout=timeout,
            )

    def _loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                msg = _recv_msg(self._sock)
            except socket.timeout:
                continue
            except OSError:
                return
            if msg is None:
                return
            t = msg["type_url"]
            version = int(msg["version_info"])
            handler = self._handlers.get(t)
            err = None
            try:
                if handler is not None:
                    handler(version, msg.get("resources") or {})
            except Exception as e:  # handler failure → NACK
                err = f"{type(e).__name__}: {e}"
            with self._lock:
                ack = {
                    "type_url": t,
                    "version_info": version,
                    "response_nonce": msg.get("nonce", ""),
                    "resource_names": self._subscribed.get(t),
                }
                if err:
                    ack["error_detail"] = err
                try:
                    # same frame-serialization invariant as subscribe()
                    _send_msg(self._sock, ack)  # policyd-lint: disable=LOCK002
                except OSError:
                    return
            if not err:
                with self._applied_cond:
                    self.applied[t] = version
                    self._applied_cond.notify_all()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
