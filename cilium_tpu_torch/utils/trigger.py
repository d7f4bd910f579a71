"""Debounced trigger with MinInterval + folded reasons.

Reference: pkg/trigger/trigger.go:24,90 — many callers request work;
invocations are serialized, rate-limited to at most one per
min_interval, and the reasons accumulated since the last run are handed
to the function (used for endpoint regeneration triggers).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence


class Trigger:
    def __init__(
        self,
        fn: Callable[[Sequence[str]], None],
        min_interval: float = 0.0,
        name: str = "",
    ) -> None:
        self._fn = fn
        self._min_interval = min_interval
        self.name = name
        self._lock = threading.Lock()
        self._reasons: List[str] = []
        self._pending = False
        self._last_run = 0.0
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.fold_count = 0
        self.run_count = 0

    def trigger(self, reason: str = "") -> None:
        with self._lock:
            if reason:
                self._reasons.append(reason)
            if self._pending:
                self.fold_count += 1
            self._pending = True
        self._wake.set()

    def _loop(self) -> None:
        while True:
            self._wake.wait()
            if self._stop:
                return
            delay = self._last_run + self._min_interval - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            with self._lock:
                if not self._pending:
                    self._wake.clear()
                    continue
                reasons = self._reasons
                self._reasons = []
                self._pending = False
                self._wake.clear()
            self._last_run = time.monotonic()
            self.run_count += 1
            try:
                self._fn(reasons)
            except Exception:  # noqa: BLE001 — trigger loops must survive
                pass

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=1)
