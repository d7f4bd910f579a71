"""Gated per-flow debug logging.

Reference: pkg/flowdebug — per-flow debug lines are compiled out of
the hot path unless explicitly enabled (they'd otherwise dominate
datapath cost). The gate is a module-level bool checked before any
formatting happens.
"""

from __future__ import annotations

from .logging import get_logger

_enabled = False
log = get_logger("flowdebug")


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def log_flow(msg: str, **fields) -> None:
    """No-op unless enabled — callers pass raw values, formatting only
    happens behind the gate (pkg/flowdebug.Log)."""
    if _enabled:
        log.debug(msg, fields=fields)
