"""Proxy map: redirected 5-tuple → original destination + source
identity.

Reference: pkg/maps/proxymap (cilium_proxy4/6) written by the datapath
on redirect verdicts and read by the C++ bpf_metadata listener filter
(envoy/cilium_bpf_metadata.cc) to recover where a proxied connection
was originally headed and who sent it. Here the pipeline records
redirected flows and the L7 layer queries by the flow tuple.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

DEFAULT_LIFETIME = 120.0  # proxymap entries are short-lived handoffs


@dataclasses.dataclass(frozen=True)
class ProxyValue:
    """proxymap.go Proxy4Value: original destination + source identity."""

    orig_dst_ip: str
    orig_dst_port: int
    src_identity: int


Key = Tuple[str, int, str, int, int]  # (sip, sport, dip, dport, proto)


class ProxyMap:
    def __init__(self, lifetime: float = DEFAULT_LIFETIME) -> None:
        self.lifetime = lifetime
        self._lock = threading.Lock()
        self._entries: Dict[Key, Tuple[ProxyValue, float]] = {}

    def record(
        self,
        sip: str, sport: int, dip: str, dport: int, proto: int,
        value: ProxyValue,
    ) -> None:
        with self._lock:
            self._entries[(sip, sport, dip, dport, proto)] = (
                value, time.monotonic() + self.lifetime,
            )

    def lookup(
        self, sip: str, sport: int, dip: str, dport: int, proto: int
    ) -> Optional[ProxyValue]:
        """The bpf_metadata getsockopt(SO_ORIGINAL_DST) analog."""
        now = time.monotonic()
        with self._lock:
            hit = self._entries.get((sip, sport, dip, dport, proto))
            if hit is None or hit[1] <= now:
                return None
            return hit[0]

    def items(self) -> list:
        """Readable live entries (cilium bpf proxy list)."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "src": f"{k[0]}:{k[1]}", "dst": f"{k[2]}:{k[3]}",
                    "proto": k[4],
                    "orig_dst": f"{v.orig_dst_ip}:{v.orig_dst_port}",
                    "src_identity": v.src_identity,
                }
                for k, (v, exp) in self._entries.items() if exp > now
            ]

    def gc(self) -> int:
        now = time.monotonic()
        with self._lock:
            stale = [k for k, (_, exp) in self._entries.items() if exp <= now]
            for k in stale:
                del self._entries[k]
            return len(stale)

    def __len__(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for _, exp in self._entries.values() if exp > now)
