"""Monitor hub: lossy per-subscriber event fan-out.

Reference: monitor/monitor.go:184,301 — the node monitor reads the
BPF perf ring and multicasts payloads to however many listeners are
attached; a slow listener loses events (the perf ring overwrites),
never blocks the datapath. Same contract here: publish() is
non-blocking, each subscriber has a bounded queue, overflow increments
a per-subscriber lost counter (the reference reports lost samples the
same way).

The datapath checks ``hub.active`` (O(1)) before building any event
objects, so an unmonitored pipeline pays one attribute read per batch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, List, Optional


class Subscription:
    def __init__(self, hub: "MonitorHub", capacity: int) -> None:
        self._hub = hub
        self._q: Deque = deque(maxlen=capacity)
        self._cond = threading.Condition()
        self.lost = 0
        self.closed = False
        self._passive = False

    # a PASSIVE subscription still receives events but does not count
    # toward hub.active — the standalone-monitor feeder sits here
    # permanently and flips passive by downstream demand, so an
    # unwatched datapath keeps skipping event construction. The flip
    # routes through the hub so ``active`` stays an O(1) counter read.
    @property
    def passive(self) -> bool:
        return self._passive

    @passive.setter
    def passive(self, value: bool) -> None:
        self._hub._set_passive(self, value)

    def _push(self, ev) -> None:
        with self._cond:
            if len(self._q) == self._q.maxlen:
                self.lost += 1  # oldest event falls off (lossy ring)
            self._q.append(ev)
            self._cond.notify()

    def next(self, timeout: Optional[float] = None):
        """Pop the next event (None on timeout/close)."""
        with self._cond:
            if not self._q:
                self._cond.wait(timeout)
            if not self._q:
                return None
            return self._q.popleft()

    def drain(self) -> List:
        with self._cond:
            out = list(self._q)
            self._q.clear()
            return out

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()
        self._hub._remove(self)


class MonitorHub:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: List[Subscription] = []
        self._active_count = 0  # non-passive subscriptions
        self.published = 0

    @property
    def active(self) -> bool:
        return self._active_count > 0  # O(1): read on the batch hot path

    def subscribe(self, capacity: int = 8192) -> Subscription:
        sub = Subscription(self, capacity)
        with self._lock:
            self._subs.append(sub)
            self._active_count += 1
        return sub

    def _set_passive(self, sub: Subscription, value: bool) -> None:
        with self._lock:
            if sub._passive == value or sub not in self._subs:
                sub._passive = value
                return
            sub._passive = value
            self._active_count += -1 if value else 1

    def _remove(self, sub: Subscription) -> None:
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                return
            if not sub._passive:
                self._active_count -= 1

    def publish(self, ev) -> None:
        with self._lock:
            subs = list(self._subs)
            self.published += 1
        for s in subs:
            s._push(ev)

    def publish_many(self, events) -> None:
        with self._lock:
            subs = list(self._subs)
        n = 0
        for ev in events:
            n += 1
            for s in subs:
                s._push(ev)
        with self._lock:
            self.published += n
