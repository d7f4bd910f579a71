"""Local-endpoint map: IP → endpoint delivery info.

Reference: pkg/maps/lxcmap (cilium_lxc: EndpointKey IP →
EndpointInfo{ifindex, lxc_id, mac, node_mac}, lxcmap.go) and the boot
sync of daemon/daemon.go:953 syncLXCMap. The datapath consults it to
decide local delivery vs encap (bpf/lib/eps.h lookup_ip4_endpoint).
Here it is the host-authoritative table the pipeline's local-delivery
stage and the CNI plumbing read; synced from the endpoint manager.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import threading
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EndpointInfo:
    """lxcmap.go EndpointInfo."""

    endpoint_id: int
    ifindex: int = 0
    mac: str = ""
    node_mac: str = ""


class LXCMap:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_ip: Dict[str, EndpointInfo] = {}

    @staticmethod
    def _norm(ip: str) -> str:
        return str(ipaddress.ip_address(ip))

    def upsert(self, ip: str, info: EndpointInfo) -> None:
        with self._lock:
            self._by_ip[self._norm(ip)] = info

    def delete(self, ip: str) -> bool:
        with self._lock:
            return self._by_ip.pop(self._norm(ip), None) is not None

    def lookup(self, ip: str) -> Optional[EndpointInfo]:
        with self._lock:
            return self._by_ip.get(self._norm(ip))

    def items(self) -> List[Tuple[str, EndpointInfo]]:
        with self._lock:
            return sorted(self._by_ip.items())

    def sync_endpoints(self, endpoints) -> int:
        """Full resync from endpoint objects (syncLXCMap,
        daemon/daemon.go:953): every endpoint IP maps to its info;
        stale entries are removed. Returns the live entry count."""
        desired: Dict[str, EndpointInfo] = {}
        for ep in endpoints:
            info = EndpointInfo(endpoint_id=ep.id)
            for ip in (ep.ipv4, ep.ipv6):
                if ip:
                    desired[self._norm(ip)] = info
        with self._lock:
            self._by_ip = desired
        return len(desired)

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_ip)
