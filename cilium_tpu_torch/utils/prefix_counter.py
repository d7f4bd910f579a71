"""Prefix-length reference counter.

Reference: pkg/counter (prefixes.go:27,65,136 PrefixLengthCounter):
reference-counts the DISTINCT CIDR prefix lengths the policy uses so
the datapath knows when its LPM structures must be rebuilt (on
non-LPM kernels the reference recompiles the datapath when a new
length appears; here the analog is a forced trie/datapath rebuild).
Add/Delete return True when the set of distinct lengths changed.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple


class PrefixLengthCounter:
    def __init__(self, max_v4: int = 32, max_v6: int = 128) -> None:
        self.max_v4 = max_v4
        self.max_v6 = max_v6
        self._lock = threading.Lock()
        self._v4: Dict[int, int] = {}
        self._v6: Dict[int, int] = {}

    @staticmethod
    def _split(prefix_lengths: Iterable[Tuple[int, int]]):
        """Iterable of (family, length) pairs."""
        v4, v6 = [], []
        for fam, plen in prefix_lengths:
            (v4 if fam == 4 else v6).append(plen)
        return v4, v6

    def add(self, prefix_lengths: Iterable[Tuple[int, int]]) -> bool:
        """Reference the lengths; True if a NEW distinct length
        appeared (prefixes.go Add → datapath rebuild trigger)."""
        v4, v6 = self._split(prefix_lengths)
        changed = False
        with self._lock:
            for plen in v4:
                if not 0 <= plen <= self.max_v4:
                    raise ValueError(f"invalid v4 prefix length {plen}")
                changed |= self._v4.get(plen, 0) == 0
                self._v4[plen] = self._v4.get(plen, 0) + 1
            for plen in v6:
                if not 0 <= plen <= self.max_v6:
                    raise ValueError(f"invalid v6 prefix length {plen}")
                changed |= self._v6.get(plen, 0) == 0
                self._v6[plen] = self._v6.get(plen, 0) + 1
        return changed

    def delete(self, prefix_lengths: Iterable[Tuple[int, int]]) -> bool:
        """Drop references; True if a distinct length disappeared."""
        v4, v6 = self._split(prefix_lengths)
        changed = False
        with self._lock:
            for table, lens in ((self._v4, v4), (self._v6, v6)):
                for plen in lens:
                    cur = table.get(plen, 0)
                    if cur <= 1:
                        if cur == 1:
                            del table[plen]
                            changed = True
                    else:
                        table[plen] = cur - 1
        return changed

    def resync(self, prefix_lengths: Iterable[Tuple[int, int]]) -> bool:
        """Replace the whole multiset (authoritative recount from the
        live rule set — translation/FQDN churn mutates rule CIDRs
        outside add/delete pairs, so incremental tracking drifts).
        Returns True if the DISTINCT length set changed."""
        v4, v6 = self._split(prefix_lengths)
        new_v4: Dict[int, int] = {}
        new_v6: Dict[int, int] = {}
        for plen in v4:
            if not 0 <= plen <= self.max_v4:
                raise ValueError(f"invalid v4 prefix length {plen}")
            new_v4[plen] = new_v4.get(plen, 0) + 1
        for plen in v6:
            if not 0 <= plen <= self.max_v6:
                raise ValueError(f"invalid v6 prefix length {plen}")
            new_v6[plen] = new_v6.get(plen, 0) + 1
        with self._lock:
            changed = set(new_v4) != set(self._v4) or set(new_v6) != set(
                self._v6
            )
            self._v4, self._v6 = new_v4, new_v6
        return changed

    def distinct(self) -> Tuple[List[int], List[int]]:
        """(v4 lengths desc, v6 lengths desc) — the ToBPFData order
        (prefixes.go:136: longest first for sequential-probe kernels)."""
        with self._lock:
            return (
                sorted(self._v4, reverse=True),
                sorted(self._v6, reverse=True),
            )
