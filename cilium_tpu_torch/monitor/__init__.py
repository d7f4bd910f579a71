"""Observability event stream: drop/trace/agent/L7 notifications,
lossy multicast hub, and the monitor socket protocol (the roles of
monitor/ + pkg/monitor in the reference)."""

from .dissect import Dissection, dissect, render_waterfall
from .events import (
    EVENT_AGENT,
    EVENT_CAPTURE,
    EVENT_DROP,
    EVENT_L7,
    EVENT_POLICY_VERDICT,
    EVENT_TRACE,
    EVENT_TRACE_SUMMARY,
    REASON_NO_SERVICE,
    REASON_POLICY,
    REASON_PREFILTER,
    AgentNotify,
    DebugCapture,
    DropNotify,
    L7Notify,
    PolicyVerdictNotify,
    TraceNotify,
    TraceSummary,
    decode,
    encode,
    reason_name,
)
from .hub import MonitorHub, Subscription
from .server import MonitorServer, monitor_stream

__all__ = [
    "AgentNotify",
    "DebugCapture",
    "Dissection",
    "dissect",
    "DropNotify",
    "EVENT_AGENT",
    "EVENT_DROP",
    "EVENT_L7",
    "EVENT_POLICY_VERDICT",
    "EVENT_TRACE",
    "EVENT_TRACE_SUMMARY",
    "L7Notify",
    "PolicyVerdictNotify",
    "TraceSummary",
    "render_waterfall",
    "MonitorHub",
    "MonitorServer",
    "REASON_NO_SERVICE",
    "REASON_POLICY",
    "REASON_PREFILTER",
    "Subscription",
    "TraceNotify",
    "decode",
    "encode",
    "monitor_stream",
    "reason_name",
]
