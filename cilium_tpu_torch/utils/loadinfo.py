"""Periodic CPU/memory logging during heavy operations.

Reference: pkg/loadinfo — long-running builds log process load so
operators can see what a slow regeneration is costing. Uses
/proc/self (no psutil in the image).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from .logging import get_logger

log = get_logger("loadinfo")


def snapshot() -> Dict[str, float]:
    """Current process CPU seconds + RSS MB (LogCurrentSystemLoad)."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    # split AFTER the comm field (field 2, parenthesized) — a process
    # name containing spaces would shift every index of a bare split()
    parts = stat[stat.rindex(")") + 2:].split()
    tick = os.sysconf("SC_CLK_TCK")
    # parts[0] is field 3 (state); utime/stime are fields 14/15,
    # rss field 24 → offsets 11/12/21
    utime, stime = int(parts[11]) / tick, int(parts[12]) / tick
    rss_mb = int(parts[21]) * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    return {
        "cpu_user_s": round(utime, 2),
        "cpu_sys_s": round(stime, 2),
        "rss_mb": round(rss_mb, 1),
    }


class LoadReporter:
    """Logs load periodically while a heavy operation runs
    (LogPeriodicSystemLoad). Context-manager:

        with LoadReporter("regeneration", interval=5.0):
            ...heavy work...
    """

    def __init__(self, operation: str, interval: float = 10.0) -> None:
        self.operation = operation
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "LoadReporter":
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                log.info("load during operation",
                         fields={"op": self.operation, **snapshot()})

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        log.info("operation finished",
                 fields={"op": self.operation, **snapshot()})
