"""Duration accumulator (reference: pkg/spanstat/spanstat.go:23).

Used by endpoint regeneration to attribute wall time to phases
(pkg/endpoint/metrics.go regenerationStatistics)."""

from __future__ import annotations

import time
from typing import Optional


class SpanStat:
    def __init__(self) -> None:
        self.success_total = 0.0
        self.failure_total = 0.0
        self.last_success = 0.0
        self.last_failure = 0.0
        self._start: Optional[float] = None

    def start(self) -> "SpanStat":
        self._start = time.perf_counter()
        return self

    def end(self, success: bool = True) -> "SpanStat":
        if self._start is None:
            return self
        d = time.perf_counter() - self._start
        self._start = None
        if success:
            self.success_total += d
            self.last_success = d
        else:
            self.failure_total += d
            self.last_failure = d
        return self

    def total(self) -> float:
        return self.success_total + self.failure_total

    def __enter__(self) -> "SpanStat":
        return self.start()

    def __exit__(self, exc_type, *_):
        self.end(success=exc_type is None)
