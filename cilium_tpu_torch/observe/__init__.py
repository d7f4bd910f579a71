"""Verdict-path observability: the span tracer and the device profiler.

Import-light by design (stdlib only). The flow ring of the JAX
package's ``observe`` waits for a later slice of the port.
"""

from .profiler import DeviceProfiler
from .tracer import BatchTrace, NOOP_BATCH, Tracer

__all__ = ["BatchTrace", "DeviceProfiler", "NOOP_BATCH", "Tracer"]
