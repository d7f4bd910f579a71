"""DNS TTL cache for ToFQDNs policy.

Reference: pkg/fqdn/cache.go — per-name IP sets with per-entry expiry;
lookups return only live addresses, and an update reports whether the
live set actually changed (the poller only re-translates rules on
change, dnspoller.go:260).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_MIN_TTL = 60.0  # MinTTL floor (option.Config.ToFQDNsMinTTL)


class DNSCache:
    def __init__(self, min_ttl: float = DEFAULT_MIN_TTL) -> None:
        self.min_ttl = min_ttl
        self._lock = threading.Lock()
        # name → {ip: expiry_monotonic}
        self._entries: Dict[str, Dict[str, float]] = {}

    def update(
        self,
        name: str,
        ips: Iterable[str],
        ttl: float,
        now: Optional[float] = None,
    ) -> bool:
        """Record a lookup result. Returns True if the LIVE address set
        for ``name`` changed (new IPs appeared or stale ones expired) —
        the signal to regenerate ToCIDRSet rules."""
        now = time.monotonic() if now is None else now
        expiry = now + max(float(ttl), self.min_ttl)
        with self._lock:
            cur = self._entries.setdefault(name, {})
            before = {ip for ip, exp in cur.items() if exp > now}
            for ip in ips:
                cur[ip] = max(cur.get(ip, 0.0), expiry)
            # drop fully-expired entries while we're here
            for ip in [ip for ip, exp in cur.items() if exp <= now]:
                del cur[ip]
            after = {ip for ip, exp in cur.items() if exp > now}
            return after != before

    def lookup(self, name: str, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        with self._lock:
            cur = self._entries.get(name, {})
            return sorted(ip for ip, exp in cur.items() if exp > now)

    def expire(self, now: Optional[float] = None) -> List[str]:
        """Drop expired entries; returns names whose live set changed."""
        now = time.monotonic() if now is None else now
        changed = []
        with self._lock:
            for name, cur in self._entries.items():
                stale = [ip for ip, exp in cur.items() if exp <= now]
                if stale:
                    for ip in stale:
                        del cur[ip]
                    changed.append(name)
        return changed

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)
