"""Verdict-path observability: the span tracer, the device profiler and
the sampled flow ring (FlowAttribution).

Import-light by design (stdlib only): the monitor and the flow ring
import this without pulling PyTorch.
"""

from .flows import FlowRecord, FlowRing, SAMPLE_CAP
from .profiler import DeviceProfiler
from .tracer import BatchTrace, NOOP_BATCH, Tracer

__all__ = [
    "BatchTrace",
    "DeviceProfiler",
    "FlowRecord",
    "FlowRing",
    "NOOP_BATCH",
    "SAMPLE_CAP",
    "Tracer",
]
