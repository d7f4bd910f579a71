"""Per-key FIFO function queues (reference: pkg/serializer/func_queue.go).

Used to keep ordered processing of watcher events per resource key
while different keys proceed in parallel.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict


class FunctionQueue:
    def __init__(self) -> None:
        self._q: "queue.Queue[Callable[[], None] | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def enqueue(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001
                pass

    def stop(self, wait: bool = True) -> None:
        self._q.put(None)
        if wait:
            self._thread.join(timeout=1)


class KeyedSerializer:
    """One FunctionQueue per key, created lazily."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queues: Dict[str, FunctionQueue] = {}

    def enqueue(self, key: str, fn: Callable[[], None]) -> None:
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = FunctionQueue()
                self._queues[key] = q
        q.enqueue(fn)

    def stop(self) -> None:
        with self._lock:
            for q in self._queues.values():
                q.stop(wait=False)
