"""Exponential backoff with jitter (reference: pkg/backoff/backoff.go)."""

from __future__ import annotations

import random
import threading
import time
from typing import Optional


class Backoff:
    def __init__(
        self,
        min_s: float = 1.0,
        max_s: float = 60.0,
        factor: float = 2.0,
        jitter: bool = True,
        full_jitter: bool = False,
        max_elapsed_s: Optional[float] = None,
    ) -> None:
        self.min_s = min_s
        self.max_s = max_s
        self.factor = factor
        self.jitter = jitter
        # Full jitter draws uniform(0, d) instead of uniform(d/2, d):
        # under overload many retriers start from the SAME failure
        # instant, and the half-floor of equal-jitter keeps their
        # retries loosely synchronized; the full range decorrelates the
        # storm (AWS "exponential backoff and jitter").
        self.full_jitter = full_jitter
        # Cumulative-sleep cap: once the sum of returned durations
        # reaches the cap, duration() returns 0.0 and `exhausted` flips
        # True so retry loops stop burning time on a down dependency.
        self.max_elapsed_s = max_elapsed_s
        self._attempt = 0
        self._elapsed = 0.0
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self._attempt = 0
            self._elapsed = 0.0

    @property
    def exhausted(self) -> bool:
        """True once the max-elapsed cap has been consumed."""
        with self._lock:
            return (
                self.max_elapsed_s is not None
                and self._elapsed >= self.max_elapsed_s
            )

    def duration(self) -> float:
        """Next wait duration; attempt counter advances. Returns 0.0
        once `max_elapsed_s` worth of waiting has been handed out."""
        with self._lock:
            if (
                self.max_elapsed_s is not None
                and self._elapsed >= self.max_elapsed_s
            ):
                return 0.0
            self._attempt += 1
            attempt = self._attempt
            budget = (
                None
                if self.max_elapsed_s is None
                else self.max_elapsed_s - self._elapsed
            )
        d = min(self.max_s, self.min_s * (self.factor ** (attempt - 1)))
        if self.full_jitter:
            d = random.uniform(0.0, d)
        elif self.jitter:
            d = random.uniform(d / 2, d)
        if budget is not None:
            d = min(d, budget)
            with self._lock:
                self._elapsed += d
        return d

    def wait(self, event: threading.Event) -> bool:
        """Sleep the backoff duration or until event fires; returns True
        when interrupted by the event."""
        d = self.duration()
        if d <= 0.0:
            return event.is_set()
        t0 = time.monotonic()
        fired = event.wait(d)
        if fired and self.max_elapsed_s is not None:
            # Credit back the unslept remainder so an early wake does
            # not consume cap it never spent.
            unspent = d - (time.monotonic() - t0)
            if unspent > 0.0:
                with self._lock:
                    self._elapsed = max(0.0, self._elapsed - unspent)
        return fired
