"""Mutex wrappers with optional deadlock detection.

Reference: pkg/lock (lock_debug.go build tag): in debug builds, a lock
held longer than a deadline logs a warning with the holder's stack —
the "sanitizer" for lock ordering bugs. Enabled via
``set_deadlock_detection(True)`` (tests / debug runs); production
default is a plain RLock with zero overhead.
"""

from __future__ import annotations

import threading
import traceback
from typing import Optional

from .logging import get_logger

log = get_logger("lock")

_DETECT = False
_TIMEOUT = 10.0


def set_deadlock_detection(on: bool, timeout: float = 10.0) -> None:
    global _DETECT, _TIMEOUT
    _DETECT = on
    _TIMEOUT = timeout


class DebugRLock:
    """RLock that, under detection, logs when acquisition stalls past
    the deadline — including where the current holder took it."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.RLock()
        self._holder_stack: Optional[str] = None
        # reentrancy depth: maintained UNCONDITIONALLY (mutations only
        # happen while the lock is held, so they're race-free) — a
        # detection toggle mid-hold must not desync it
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not _DETECT or not blocking:
            got = self._lock.acquire(blocking, timeout)
        else:
            # the detection deadline must never EXTEND the caller's
            # timeout: probe with min(deadline, timeout), then spend
            # only whatever budget remains
            first = _TIMEOUT if timeout < 0 else min(_TIMEOUT, timeout)
            got = self._lock.acquire(True, first)
            if not got:
                # only a FULL detection deadline is suspicious — a
                # short caller timeout expiring is normal contention,
                # not a deadlock signal
                if first >= _TIMEOUT:
                    log.warning("possible deadlock", fields={
                        "lock": self.name,
                        "waited_s": first,
                        "holder": self._holder_stack or "unknown",
                    })
                if timeout < 0:
                    got = self._lock.acquire(True, -1)
                else:
                    remaining = timeout - first
                    got = (
                        self._lock.acquire(True, remaining)
                        if remaining > 0 else False
                    )
        if got:
            self._depth += 1
            if self._depth == 1 and _DETECT:
                self._holder_stack = "".join(
                    traceback.format_stack(limit=6)
                )
        return got

    def release(self) -> None:
        if self._depth > 0:
            self._depth -= 1
            if self._depth == 0:  # only the OUTERMOST release clears
                self._holder_stack = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
