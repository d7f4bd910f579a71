"""Host-scope IP address management.

Reference: pkg/ipam (allocator.go): a per-node allocator over the
node's pod CIDR — AllocateNext for fresh IPs, Allocate for explicit
ones (restore), Release. The network+broadcast and router addresses
are reserved like the reference does.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, Optional, Set


class IPAMError(ValueError):
    """ValueError subclass so the REST layer maps it to a 400."""


class IPAM:
    def __init__(self, cidr: str, reserve_base: int = 2) -> None:
        """``reserve_base``: how many leading addresses to skip
        (network addr + router IP, pkg/ipam reserveLocalRoutes)."""
        self.net = ipaddress.ip_network(cidr, strict=False)
        self._lock = threading.Lock()
        self._used: Dict[str, str] = {}  # ip → owner
        self._next = reserve_base
        self._released: Set[int] = set()
        self.reserve_base = reserve_base

    @property
    def capacity(self) -> int:
        total = self.net.num_addresses - self.reserve_base
        if self.net.version == 4 and self.net.prefixlen < 31:
            total -= 1  # broadcast
        return max(0, total)

    def allocate_next(self, owner: str = "") -> str:
        """AllocateNext: lowest free address (released ones reused
        first, keeping churn compact)."""
        with self._lock:
            if self._released:
                off = min(self._released)
                self._released.discard(off)
                ip = str(self.net.network_address + off)
                self._used[ip] = owner
                return ip
            while self._next < self.net.num_addresses:
                off = self._next
                self._next += 1
                addr = self.net.network_address + off
                if (
                    self.net.version == 4
                    and self.net.prefixlen < 31
                    and addr == self.net.broadcast_address
                ):
                    continue
                ip = str(addr)
                if ip not in self._used:
                    self._used[ip] = owner
                    return ip
            raise IPAMError(f"pool {self.net} exhausted")

    def allocate(self, ip: str, owner: str = "") -> str:
        """Explicit allocation (endpoint restore path)."""
        addr = ipaddress.ip_address(ip)
        if addr not in self.net:
            raise IPAMError(f"{ip} outside pool {self.net}")
        key = str(addr)
        with self._lock:
            if key in self._used:
                raise IPAMError(f"{ip} already allocated")
            self._used[key] = owner
            self._released.discard(int(addr) - int(self.net.network_address))
            return key

    def release(self, ip: str) -> bool:
        key = str(ipaddress.ip_address(ip))
        with self._lock:
            if self._used.pop(key, None) is None:
                return False
            off = int(ipaddress.ip_address(key)) - int(self.net.network_address)
            if off >= self.reserve_base:
                self._released.add(off)
            return True

    def owner_of(self, ip: str) -> Optional[str]:
        with self._lock:
            return self._used.get(str(ipaddress.ip_address(ip)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._used)
