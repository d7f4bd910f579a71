"""Conntrack table with TTL-based garbage collection.

Reference: pkg/maps/ctmap (ctmap.go:345 GC, :242 dump/filter) over the
kernel tables of bpf/lib/conntrack.h. Here: the host-side flow cache
the datapath front-end consults so established flows skip the full
policy path (the role CT_ESTABLISHED plays in bpf_lxc.c:477), with the
same lifetime/accounting semantics.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

# (src_ip, dst_ip, sport, dport, proto, direction)
FlowTuple = Tuple[int, int, int, int, int, int]

# Single source of truth for CT lifetimes; datapath/conntrack.py (the
# vectorized batch table) imports these.
DEFAULT_LIFETIME_TCP = 21600.0  # CT_CONNECTION_LIFETIME_TCP (6h)
DEFAULT_LIFETIME_OTHER = 60.0


@dataclasses.dataclass
class ConntrackEntry:
    expires: float
    verdict: int = 0
    redirect: bool = False
    packets: int = 0
    bytes: int = 0
    flags_seen: int = 0


class ConntrackMap:
    def __init__(self, max_entries: int = 1 << 18) -> None:
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[FlowTuple, ConntrackEntry] = {}

    def lookup(self, key: FlowTuple) -> Optional[ConntrackEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.expires < time.monotonic():
                return None
            return e

    def create(self, key: FlowTuple, verdict: int, redirect: bool, lifetime: Optional[float] = None) -> ConntrackEntry:
        if lifetime is None:
            lifetime = DEFAULT_LIFETIME_TCP if key[4] == 6 else DEFAULT_LIFETIME_OTHER
        e = ConntrackEntry(expires=time.monotonic() + lifetime, verdict=verdict, redirect=redirect)
        with self._lock:
            if len(self._entries) >= self.max_entries:
                self._gc_locked(time.monotonic())
                # Still full (nothing expired): evict soonest-expiring
                # entries so the cap holds (the kernel map fails the
                # insert; eviction keeps hot flows cached instead).
                if len(self._entries) >= self.max_entries:
                    evict = max(1, self.max_entries // 64)
                    for k in sorted(self._entries, key=lambda k: self._entries[k].expires)[:evict]:
                        del self._entries[k]
            self._entries[key] = e
        return e

    def refresh(self, key: FlowTuple, packets: int = 1, bytes_: int = 0) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.packets += packets
                e.bytes += bytes_
                lifetime = DEFAULT_LIFETIME_TCP if key[4] == 6 else DEFAULT_LIFETIME_OTHER
                e.expires = time.monotonic() + lifetime

    def _gc_locked(self, now: float) -> int:
        stale = [k for k, e in self._entries.items() if e.expires < now]
        for k in stale:
            del self._entries[k]
        return len(stale)

    def gc(self) -> int:
        """Reap expired entries; returns count (ctmap.go GC:345)."""
        with self._lock:
            return self._gc_locked(time.monotonic())

    def flush(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    def __len__(self) -> int:
        return len(self._entries)

    def items(self) -> Iterator[Tuple[FlowTuple, ConntrackEntry]]:
        with self._lock:
            return iter(list(self._entries.items()))
