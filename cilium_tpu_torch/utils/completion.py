"""Context-bound WaitGroup for async ACKs.

Reference: pkg/completion/completion.go:24,49 — endpoint regeneration
waits for proxy (xDS) ACKs with a deadline; completions may fail the
whole group.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class Completion:
    def __init__(self, group: "WaitGroup") -> None:
        self._group = group
        self._done = threading.Event()
        self.err: Optional[Exception] = None

    def complete(self, err: Optional[Exception] = None) -> None:
        self.err = err
        self._done.set()
        self._group._child_done()

    @property
    def completed(self) -> bool:
        return self._done.is_set()


class WaitGroup:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._children: List[Completion] = []
        self._outstanding = 0
        self._all_done = threading.Event()
        self._all_done.set()

    def add(self) -> Completion:
        with self._lock:
            c = Completion(self)
            self._children.append(c)
            self._outstanding += 1
            self._all_done.clear()
            return c

    def _child_done(self) -> None:
        with self._lock:
            self._outstanding -= 1
            if self._outstanding <= 0:
                self._all_done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True when every completion finished in time; raises the first
        completion error if any."""
        ok = self._all_done.wait(timeout)
        for c in self._children:
            if c.err is not None:
                raise c.err
        return ok
