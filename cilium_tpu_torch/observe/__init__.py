"""Verdict-path observability: the span tracer.

Import-light by design (stdlib only). The flow ring and the device
profiler of the JAX package's ``observe`` wait for a later slice of
the port.
"""

from .tracer import BatchTrace, NOOP_BATCH, Tracer

__all__ = ["BatchTrace", "NOOP_BATCH", "Tracer"]
