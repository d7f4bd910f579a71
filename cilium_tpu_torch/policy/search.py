"""Search context and verdicts.

Reference: pkg/policy/policy.go (SearchContext, Trace levels) and
pkg/policy/api/decision.go (Decision).
"""

from __future__ import annotations

import dataclasses
import enum
import io
from typing import List, Optional, Tuple

from ..labels import LabelArray


class Decision(enum.IntEnum):
    UNDECIDED = 0
    ALLOWED = 1
    DENIED = 2

    def __str__(self) -> str:  # matches api.Decision.String()
        return {0: "undecided", 1: "allowed", 2: "denied"}[int(self)]


class Trace(enum.IntEnum):
    DISABLED = 0
    ENABLED = 1
    VERBOSE = 2


@dataclasses.dataclass(frozen=True)
class PortContext:
    """One destination port under trace (models.Port equivalent)."""

    port: int
    protocol: str = "ANY"  # "TCP" | "UDP" | "ANY" | ""


@dataclasses.dataclass
class SearchContext:
    """The question being asked of the policy repository: may traffic
    flow From → To (optionally on DPorts)?"""

    src: LabelArray = dataclasses.field(default_factory=LabelArray)
    dst: LabelArray = dataclasses.field(default_factory=LabelArray)
    dports: Tuple[PortContext, ...] = ()
    trace: Trace = Trace.DISABLED
    _log: Optional[io.StringIO] = None

    def __post_init__(self):
        if self.trace != Trace.DISABLED and self._log is None:
            self._log = io.StringIO()

    def policy_trace(self, fmt: str, *args) -> None:
        if self.trace != Trace.DISABLED and self._log is not None:
            self._log.write(fmt % args if args else fmt)
            if not fmt.endswith("\n"):
                self._log.write("\n")

    def policy_trace_verbose(self, fmt: str, *args) -> None:
        if self.trace == Trace.VERBOSE:
            self.policy_trace(fmt, *args)

    def log(self) -> str:
        return self._log.getvalue() if self._log is not None else ""

    def __str__(self) -> str:
        src = " ".join(self.src.to_strings()) or "[no labels]"
        dst = " ".join(self.dst.to_strings()) or "[no labels]"
        ports = ",".join(f"{p.port}/{p.protocol}" for p in self.dports)
        s = f"From: [{src}] => To: [{dst}]"
        if ports:
            s += f" Ports: [{ports}]"
        return s
