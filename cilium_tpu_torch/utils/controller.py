"""Named retrying background loops with backoff + status surfacing.

Reference: pkg/controller/controller.go:43,121,168,282 — every
background sync loop in the daemon is a Controller: it runs a function
periodically (or on demand), retries failures with exponential backoff,
and exposes last-success/last-error for `cilium status
--all-controllers`.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from .backoff import Backoff


class Controller:
    def __init__(
        self,
        name: str,
        do_func: Callable[[], None],
        run_interval: Optional[float] = None,
        error_retry_base: float = 1.0,
    ) -> None:
        self.name = name
        self._do = do_func
        self._interval = run_interval
        self._backoff = Backoff(min_s=error_retry_base, max_s=60.0)
        self._stop_ev = threading.Event()
        self._kick = threading.Event()
        self.success_count = 0
        self.failure_count = 0
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self.last_success_ts: Optional[float] = None
        self.last_failure_ts: Optional[float] = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"ctrl-{name}")
        self._thread.start()

    def trigger(self) -> None:
        """Run as soon as possible (UpdateController re-kick)."""
        self._kick.set()

    def _run_once(self) -> None:
        try:
            self._do()
        except Exception as e:  # noqa: BLE001 — controllers retry anything
            self.failure_count += 1
            self.consecutive_failures += 1
            self.last_error = f"{type(e).__name__}: {e}"
            self.last_failure_ts = time.time()
            if not self._backoff.wait(self._stop_ev):
                pass
            self._kick.set()  # retry
            return
        self.success_count += 1
        self.consecutive_failures = 0
        self.last_error = None
        self.last_success_ts = time.time()
        self._backoff.reset()

    def _loop(self) -> None:
        while not self._stop_ev.is_set():
            timeout = self._interval
            self._kick.wait(timeout=timeout)
            if self._stop_ev.is_set():
                return
            self._kick.clear()
            self._run_once()

    def stop(self) -> None:
        self._stop_ev.set()
        self._kick.set()
        self._thread.join(timeout=2)

    def status(self) -> Dict:
        return {
            "name": self.name,
            "success-count": self.success_count,
            "failure-count": self.failure_count,
            "consecutive-failure-count": self.consecutive_failures,
            "last-failure-msg": self.last_error,
        }


class ControllerManager:
    """Daemon-wide registry (controller.Manager)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._controllers: Dict[str, Controller] = {}

    def update_controller(
        self,
        name: str,
        do_func: Callable[[], None],
        run_interval: Optional[float] = None,
    ) -> Controller:
        with self._lock:
            old = self._controllers.pop(name, None)
        if old is not None:
            old.stop()
        c = Controller(name, do_func, run_interval)
        with self._lock:
            self._controllers[name] = c
        c.trigger()
        return c

    def remove_controller(self, name: str) -> bool:
        with self._lock:
            c = self._controllers.pop(name, None)
        if c is None:
            return False
        c.stop()
        return True

    def remove_all(self) -> None:
        with self._lock:
            cs = list(self._controllers.values())
            self._controllers.clear()
        for c in cs:
            c.stop()

    def statuses(self) -> List[Dict]:
        with self._lock:
            return [c.status() for c in self._controllers.values()]

    def lookup(self, name: str) -> Optional[Controller]:
        return self._controllers.get(name)
