"""Per-endpoint realized policymap (reference: pkg/maps/policymap).

The reference's `cilium_policy_%d` BPF hash holds
`PolicyKey{Identity, DestPort, Nexthdr, TrafficDirection}` →
`PolicyEntry{ProxyPort, Packets, Bytes}` (policymap.go:64,73) and is
the unit the endpoint's desired/realized diff writes into
(pkg/endpoint/endpoint.go:2572 syncPolicyMap). Here it is host state:
the authoritative realized map mirrored by the device lookup tables,
with per-entry counters fed back from batch processing.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from ..ops.materialize import PolicyKey


@dataclasses.dataclass
class PolicyEntry:
    proxy_port: int = 0
    packets: int = 0
    bytes: int = 0


class PolicyMap:
    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._entries: Dict[PolicyKey, PolicyEntry] = {}

    def allow(self, key: PolicyKey, proxy_port: int = 0) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = PolicyEntry(proxy_port=proxy_port)
            else:
                e.proxy_port = proxy_port

    def delete(self, key: PolicyKey) -> bool:
        with self._lock:
            return self._entries.pop(key, None) is not None

    def exists(self, key: PolicyKey) -> bool:
        return key in self._entries

    def lookup(self, key: PolicyKey) -> Optional[PolicyEntry]:
        return self._entries.get(key)

    def dump(self) -> List[Tuple[PolicyKey, PolicyEntry]]:
        with self._lock:
            return list(self._entries.items())

    def flush(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def account(self, key: PolicyKey, packets: int, bytes_: int) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.packets += packets
                e.bytes += bytes_
