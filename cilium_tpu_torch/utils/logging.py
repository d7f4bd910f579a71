"""Structured logging: subsystem loggers with bound fields.

Reference: pkg/logging + pkg/logging/logfields — every subsystem logs
through a logger carrying a ``subsys`` field plus structured
key=values; setup selects level and plain/JSON output. Built on
stdlib logging so embedders can re-route handlers.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

ROOT = "cilium_tpu"

# field name constants (pkg/logging/logfields/logfields.go)
ENDPOINT_ID = "endpointID"
IDENTITY = "identity"
POLICY_REVISION = "policyRevision"
IP_ADDR = "ipAddr"
NODE_NAME = "nodeName"


class _StructuredFormatter(logging.Formatter):
    def __init__(self, as_json: bool) -> None:
        super().__init__()
        self.as_json = as_json

    def format(self, record: logging.LogRecord) -> str:
        fields: Dict[str, Any] = dict(getattr(record, "cilium_fields", {}))
        if self.as_json:
            payload = {
                "ts": round(record.created, 3),
                "level": record.levelname.lower(),
                "subsys": record.name.removeprefix(ROOT + "."),
                "msg": record.getMessage(),
                **fields,
            }
            if record.exc_info:
                payload["exc"] = self.formatException(record.exc_info)
            return json.dumps(payload)
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        kv = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        base = (
            f"{ts} {record.levelname[:4].lower():4} "
            f"[{record.name.removeprefix(ROOT + '.')}] {record.getMessage()}"
        )
        out = f"{base} {kv}" if kv else base
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        return out


class SubsysLogger(logging.LoggerAdapter):
    """Logger with bound structured fields; with_fields() derives a
    child carrying more (logrus WithFields pattern)."""

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra["cilium_fields"] = {
            **(self.extra or {}),
            **kwargs.pop("fields", {}),
        }
        return msg, kwargs

    def with_fields(self, **fields) -> "SubsysLogger":
        return SubsysLogger(self.logger, {**(self.extra or {}), **fields})


def get_logger(subsys: str, **fields) -> SubsysLogger:
    return SubsysLogger(logging.getLogger(f"{ROOT}.{subsys}"), fields)


def setup(level: str = "info", *, as_json: bool = False,
          stream=None) -> None:
    """Configure the framework's root logger (pkg/logging SetupLogging).
    Idempotent: replaces the previous framework handler."""
    root = logging.getLogger(ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_StructuredFormatter(as_json))
    root.addHandler(handler)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
