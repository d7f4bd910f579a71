# policyd: hot
"""Span tracer for the verdict path (policyd-trace).

The pipeline's phases (CT pre-pass, LPM, policymap lookup, device
dispatch, host sync) are invisible to /metrics alone — a batch's wall
time is one number with no attribution. This module adds the
attribution layer: monotonic-clock spans grouped into per-batch
traces, a thread-local span stack so helpers (``_dispatch``, the
device-CT path) attach to the enclosing batch without parameter
threading, and a bounded ring buffer of completed traces served by
``GET /traces`` and ``cilium-tpu traces``.

Cost model (the hub's ``active`` pattern, monitor/hub.py): the hot
path reads ONE attribute per batch — ``tracer.active`` — and takes the
no-op branch when tracing is off. The no-op batch/span singletons are
constructed once at import; a disabled batch allocates nothing and
times nothing. When enabled, each completed trace feeds the per-phase
latency histograms in metrics.py and (only while a monitor listener
is attached) publishes one TraceSummary event through the hub.

Phase names are a STABLE API: bench rounds compare waterfalls across
commits, so renaming a phase is a breaking change (observe/README.md).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import metrics as _metrics


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NoopBatch:
    """Shared do-nothing batch: every method is a constant-time no-op
    so instrumented code never branches on enabled-ness beyond the one
    ``tracer.active`` read that selected this singleton."""

    __slots__ = ()

    def phase(self, name: str):
        return _NOOP_SPAN

    def mark(self, **notes) -> None:
        pass

    def end(self, hub=None):
        return None


_NOOP_SPAN = _NoopSpan()
NOOP_BATCH = _NoopBatch()


class _Span:
    """One timed phase inside a batch trace. Records
    (name, start-offset-ns, duration-ns) into the owning trace on
    exit — offsets make the waterfall renderable without re-deriving
    overlap from wall clocks."""

    __slots__ = ("_trace", "name", "_t0")

    def __init__(self, trace: "BatchTrace", name: str) -> None:
        self._trace = trace
        self.name = name
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        t = self._trace
        t.phases.append((self.name, self._t0 - t.t0_ns, now - self._t0))
        return False


class BatchTrace:
    """All spans of one ``_process`` call. ``phases`` is append-only
    from the owning thread; the trace becomes shared (ring buffer,
    monitor event) only after ``end()``."""

    __slots__ = (
        "tracer", "kind", "batch", "ts", "t0_ns", "total_ns", "phases",
        "notes",
    )

    def __init__(self, tracer: "Tracer", kind: str, batch: int) -> None:
        self.tracer = tracer
        self.kind = kind
        self.batch = int(batch)
        self.ts = time.time()
        self.total_ns = 0
        self.phases: List[Tuple[str, int, int]] = []
        self.notes: Dict[str, object] = {}
        # last: the batch wall clock starts when construction is done
        self.t0_ns = time.perf_counter_ns()

    def phase(self, name: str) -> _Span:
        return _Span(self, name)

    def mark(self, **notes) -> None:
        self.notes.update(notes)

    def end(self, hub=None) -> "BatchTrace":
        self.total_ns = time.perf_counter_ns() - self.t0_ns
        self.tracer._complete(self, hub)
        return self

    def to_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "batch": self.batch,
            "ts": self.ts,
            "total_ns": self.total_ns,
            "phases": [list(p) for p in self.phases],
            "notes": dict(self.notes),
        }


class Tracer:
    """Per-pipeline span tracer with a bounded ring of completed
    traces. Disabled by default; the daemon toggles it through the
    ``PhaseTracing`` runtime option."""

    def __init__(self, capacity: int = 256) -> None:
        # plain attribute, not a property: the hot path's entire
        # disabled cost is reading this once per batch
        self.active = False
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- lifecycle ------------------------------------------------------
    def enable(self) -> None:
        self.active = True

    def disable(self) -> None:
        self.active = False

    # -- hot-path API ---------------------------------------------------
    def begin(self, kind: str, batch: int) -> BatchTrace:
        """Open a batch trace and push it on this thread's span stack
        (so nested helpers find it via ``current()``). Callers gate on
        ``tracer.active`` BEFORE calling — begin() itself allocates."""
        bt = BatchTrace(self, kind, batch)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(bt)
        return bt

    def current(self):
        """The enclosing batch trace on this thread, or the no-op
        singleton when none is open (e.g. ``_dispatch`` driven
        directly by a test)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else NOOP_BATCH

    def detach(self, bt: BatchTrace) -> None:
        """Remove ``bt`` from this thread's span stack WITHOUT retiring
        it. The pipelined dispatch path parks a submitted batch's trace
        between its enqueue half and its completion half, so spans keep
        attaching to the batch that COMPLETES while ``current()``
        already serves the next submission being prepared."""
        stack = getattr(self._tls, "stack", None)
        if stack is not None:
            try:
                stack.remove(bt)
            except ValueError:
                pass

    def _complete(self, bt: BatchTrace, hub=None) -> None:
        """end() tail: pop the span stack, retire the trace into the
        ring, feed the metrics registry, and (monitor listeners only)
        publish a TraceSummary event."""
        # identity-based removal, not a top-of-stack pop: with depth>1
        # batches complete FIFO while newer traces sit above them (or
        # were already detach()ed), so ``bt`` may be anywhere or gone
        stack = getattr(self._tls, "stack", None)
        if stack is not None:
            try:
                stack.remove(bt)
            except ValueError:
                pass
        with self._lock:
            self._ring.append(bt)
        for name, _rel, dur in bt.phases:
            _metrics.pipeline_phase_seconds.observe(
                dur / 1e9, {"phase": name}
            )
        _metrics.batch_total_seconds.observe(bt.total_ns / 1e9)
        if hub is not None and hub.active:
            # the monitor hub and its TraceSummary event wait for the
            # port's daemon slice
            raise NotImplementedError("monitor hub events are not ported yet")

    # -- cold-path API --------------------------------------------------
    def traces(self, limit: Optional[int] = None) -> List[Dict]:
        """Completed traces, oldest→newest, bounded by ``limit``."""
        with self._lock:
            items = list(self._ring)
        if limit is not None and limit >= 0:
            items = items[-limit:]
        return [bt.to_dict() for bt in items]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
