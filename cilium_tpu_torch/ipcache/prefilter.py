"""XDP prefilter equivalent: revision-guarded CIDR deny sets.

Reference: pkg/policy/prefilter.go — four CIDR maps (v4/v6 ×
dynamic/fixed; :49) updated under a revision counter (:125,162), and
bpf/bpf_xdp.c check_v4/check_v6 (:97-156): LPM deny lookup then exact
deny lookup on the source address, earliest-possible drop.

Here both dyn (prefix) and fix (exact /32 //128) sets live in one
stride-8 trie per family (exact addresses are just max-length
prefixes); the datapath pipeline consults it before the identity
lookup, mirroring the XDP hook position.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Iterable, List, Tuple


class PreFilter:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._revision = 1
        self._dyn: set = set()  # prefix strings
        self._fix: set = set()  # exact address strings

    @property
    def revision(self) -> int:
        return self._revision

    def _split(self, cidrs: Iterable[str]) -> Tuple[List[str], List[str]]:
        dyn, fix = [], []
        for c in cidrs:
            net = ipaddress.ip_network(c, strict=False)
            full = 32 if net.version == 4 else 128
            (fix if net.prefixlen == full else dyn).append(str(net))
        return dyn, fix

    def insert(self, revision: int, cidrs: Iterable[str]) -> int:
        """Revision-guarded add (prefilter.go:125): the caller echoes the
        revision it last observed; a mismatch means a concurrent update
        won and the caller must re-read."""
        with self._lock:
            if revision != self._revision:
                raise ValueError(f"stale prefilter revision {revision} != {self._revision}")
            dyn, fix = self._split(cidrs)
            self._dyn.update(dyn)
            self._fix.update(fix)
            self._revision += 1
            return self._revision

    def delete(self, revision: int, cidrs: Iterable[str]) -> int:
        with self._lock:
            if revision != self._revision:
                raise ValueError(f"stale prefilter revision {revision} != {self._revision}")
            dyn, fix = self._split(cidrs)
            for c in dyn:
                self._dyn.discard(c)
            for c in fix:
                self._fix.discard(c)
            self._revision += 1
            return self._revision

    def dump(self) -> Tuple[int, List[str]]:
        with self._lock:
            return self._revision, sorted(self._dyn | self._fix)

