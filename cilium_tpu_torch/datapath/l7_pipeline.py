"""Overlapped L7 batch classification.

The L7 analogue of a pipelined verdict path: one ``submit()`` packs a
request batch's field strings (host work), launches the fused DFA walk
on the device's current stream without waiting for it, and returns a
handle; ``result()`` completes in FIFO order. Host prep of batch N+1
therefore overlaps device execution of batch N.

Packing follows fixed ladders: the walk length is bucketed to a FIXED
rung set (ops.dfa.L7_LEN_LADDER) and the lane (row) dimension to
``L7_LANE_RUNGS``, the same chunking as the JAX package's, so the
shape counters (``jit_shape_buckets_total{site="l7"}``) and pad-lane
counters (``l7_pad_lanes_total``) count alike in both. PyTorch compiles
nothing per shape: the cost of the chunking here is one launch per
chunk (131 072 requests × 3 fields are 24 launches of 16 384 rows).
Pad rows are marked length -1 (the kernels mask them to an empty accept
mask) and counted in ``l7_pad_lanes_total``.

With a profiler installed (``set_profiler``) every Nth submit is
sampled at the ``l7`` site: on the card CUDA events on the walk's
stream before the batch's copies in, after them and after its last
launch, and around the copies out at completion, read after the pull
that waits anyway; on the CPU ``time.perf_counter`` around the same
stretches.

The module also owns the ``L7DeviceBatch`` runtime gate: policies read
``device_batch_enabled()`` per batch and fall back to their exact
pre-option code path when it is off.
"""
# policyd: hot

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels, metrics
from ..observe.tracer import NOOP_BATCH, Tracer
from ..ops.dfa import (
    DeviceDFATable,
    L7_LEN_LADDER,
    dfa_match_batch_classes,
    dfa_match_batch_fused,
    dfa_match_batch_pair,
    l7_walk_route,
    len_rung,
    masks_u64,
    strings_to_batch_u8,
)

# Lane (row-count) rungs: a submit of F fields × B requests launches
# ceil(F*B / top) full-rung chunks plus one tail rung. Fixed set.
L7_LANE_RUNGS: Tuple[int, ...] = (512, 4096, 16384)


def lane_rung(needed: int) -> int:
    for rung in L7_LANE_RUNGS:
        if needed <= rung:
            return rung
    return L7_LANE_RUNGS[-1]


class PendingL7Batch:
    """Handle for one submitted L7 classification batch. ``result()``
    blocks until this batch (and every earlier one — FIFO) is pulled,
    and returns per-field ``[B] uint64`` accept masks."""

    __slots__ = ("_pipe", "_done", "_value", "_exc")

    def __init__(self, pipe: "L7Pipeline") -> None:
        self._pipe = pipe
        self._done = False
        self._value: Optional[List[np.ndarray]] = None
        self._exc: Optional[BaseException] = None

    def result(self) -> List[np.ndarray]:
        if not self._done:
            self._pipe._complete_until(self)
        if self._exc is not None:
            raise self._exc
        assert self._value is not None
        return self._value


class _InFlight:
    __slots__ = ("pending", "chunks", "n_req", "n_fields", "bt", "t0", "ps")

    def __init__(self, pending, chunks, n_req, n_fields, bt, t0, ps=None) -> None:
        self.pending = pending
        # [(lo, hi, rows_live)] — device tensors; pulled at completion
        # time, not submit time (that's the overlap)
        self.chunks = chunks
        self.n_req = n_req
        self.n_fields = n_fields
        self.bt = bt
        self.t0 = t0
        # the profiler's sample and its submit-time stamps (before the
        # copies in, after them, after the last launch), or None
        self.ps = ps


def _stamp(dev: torch.device):
    """A point on the walk's clock: a timing CUDA event recorded on the
    device's current stream, or ``time.perf_counter()`` on the CPU."""
    if dev.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def _secs(a, b) -> float:
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


class L7Pipeline:
    """Bounded in-flight queue of fused-DFA launches on one device.

    ``submit()`` retires the oldest batch first once ``depth`` batches
    are in flight, so at most ``depth`` batches are outstanding while
    the host packs the next one.
    """

    def __init__(self, depth: int = 2, tracer: Optional[Tracer] = None,
                 device=None) -> None:
        self.depth = max(1, int(depth))
        self.tracer = tracer
        self.device = _kernels.resolve_device(device)
        # set_profiler() installs the shared DeviceProfiler here
        self.profiler = None
        self._lock = threading.Lock()
        self._inflight: "deque[_InFlight]" = deque()
        # walk shape identity (kernel, Q, lanes, rung), counted as the
        # JAX package counts its jit programs so the metrics line up
        self._seen_shapes: set = set()

    # -- shape accounting ------------------------------------------------
    def _note_shape(self, kind: str, n_states: int, lanes: int, rung: int,
                    warm: bool = False) -> None:
        key = (kind, n_states, lanes, rung)
        with self._lock:
            fresh = key not in self._seen_shapes
            if fresh:
                self._seen_shapes.add(key)
        if fresh:
            result = "warm" if warm else "miss"
        else:
            result = "hit"
        metrics.jit_shape_buckets_total.inc({"site": "l7", "result": result})

    def prewarm(self, table: DeviceDFATable, caps: Sequence[int]) -> int:
        """Claim every (lane, length) rung this table can be launched
        at, at policy compile() time. Nothing is compiled per shape in
        PyTorch; on the card this loads (building once) the kernel
        library, so no request batch waits for it. → number of shapes
        claimed (counted under
        ``jit_shape_buckets_total{site="l7",result="warm"}``)."""
        self._check_table(table)
        if self.device.type == "cuda":
            _kernels.library()
        cap_max = max(caps)
        rungs = [r for r in L7_LEN_LADDER if r <= cap_max]
        if cap_max not in rungs:
            rungs.append(cap_max)
        warmed = 0
        key_kind = "pair" if table.has_pair else "fused"
        for rung in rungs:
            for lanes in L7_LANE_RUNGS:
                key = (key_kind, table.n_states, lanes, rung)
                with self._lock:
                    if key in self._seen_shapes:
                        continue
                self._note_shape(key_kind, table.n_states, lanes, rung, warm=True)
                warmed += 1
        return warmed

    # -- dispatch --------------------------------------------------------
    def _check_table(self, table: DeviceDFATable) -> None:
        if table.device != self.device:
            raise ValueError(
                f"DFA table on {table.device}, L7 pipeline on {self.device}"
            )

    def _upload(self, sb: np.ndarray, lens: np.ndarray, starts: np.ndarray):
        """One chunk's (starts, bytes, lengths) on the pipeline's device."""
        dev = self.device
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (starts, sb, lens)]

    def _walk(self, table: DeviceDFATable, args, rung: int):
        route = l7_walk_route(table.has_pair, table.class_trans is not None, rung)
        if route == "pair":
            return dfa_match_batch_pair(
                table.pair, table.accept_lo, table.accept_hi, *args, rung,
            )
        if route == "classes":
            return dfa_match_batch_classes(
                table.trans, table.byte_class, table.class_trans, table.accept_lo,
                table.accept_hi, *args, rung,
            )
        return dfa_match_batch_fused(
            table.trans, table.accept_lo, table.accept_hi, *args, rung,
        )

    def submit(
        self,
        table: DeviceDFATable,
        fields: Sequence[Tuple[Sequence[bytes], int]],
        parser: str = "http",
    ) -> PendingL7Batch:
        """Classify one request batch against ``table``.

        ``fields`` pairs each fused field slot (in table order) with
        (encoded values, field length cap). Values longer than their
        field cap come back with mask 0 — the CALLER host-walks those
        rows, exactly as the unfused path does. → PendingL7Batch whose
        ``result()`` is per-field ``[B] uint64`` masks."""
        if len(fields) != table.n_fields:
            raise ValueError(
                f"table fuses {table.n_fields} fields, got {len(fields)}"
            )
        self._check_table(table)
        t0 = time.perf_counter()
        tr = self.tracer
        bt = tr.begin("l7", len(fields[0][0])) if (tr is not None and tr.active) else NOOP_BATCH

        with bt.phase("prepare"):
            n_req = len(fields[0][0])
            caps = [cap for _, cap in fields]
            flat: List[bytes] = []
            for values, _cap in fields:
                if len(values) != n_req:
                    raise ValueError("field batches must be the same length")
                flat.extend(values)
            # one rung covers every field; per-field caps re-mark
            # overlong rows below
            needed = 1
            for s in flat:
                if len(s) > needed:
                    needed = len(s)
            cap_max = max(caps)
            rung = len_rung(min(needed, cap_max), cap_max)
            sb, lens = strings_to_batch_u8(flat, rung)
            for f, cap in enumerate(caps):
                if cap < rung:
                    seg = lens[f * n_req : (f + 1) * n_req]
                    seg[seg > cap] = -1
            starts = np.repeat(table.starts_host, n_req)
            live = int(lens.size)
            live_bytes = int(np.maximum(lens, 0).sum())

        # one attribute read while off; a sampled batch stamps its copies
        # in and its launches
        prof = self.profiler
        ps = prof.begin_dispatch("l7", n_req) if prof is not None else None

        with bt.phase("dispatch"):
            parts = []
            top = L7_LANE_RUNGS[-1]
            pad_rows = 0
            off = 0
            kind = "pair" if table.has_pair else "fused"
            while off < live:
                take = min(top, live - off)
                lanes = lane_rung(take)
                if take < lanes:
                    csb = np.zeros((lanes, rung), np.uint8)
                    csb[:take] = sb[off : off + take]
                    clens = np.full(lanes, -1, np.int32)
                    clens[:take] = lens[off : off + take]
                    cstarts = np.zeros(lanes, np.int32)
                    cstarts[:take] = starts[off : off + take]
                    pad_rows += lanes - take
                else:
                    csb = sb[off : off + take]
                    clens = lens[off : off + take]
                    cstarts = starts[off : off + take]
                self._note_shape(kind, table.n_states, lanes, rung)
                parts.append((csb, clens, cstarts, take))
                off += take
            # every chunk's copies in, then every launch: the split's
            # h2d and compute are two stretches of the stream
            stamps = None if ps is None else [_stamp(self.device)]
            ins = [self._upload(*p[:3]) for p in parts]
            if ps is not None:
                stamps.append(_stamp(self.device))
            chunks = []
            for args, p in zip(ins, parts):
                lo, hi = self._walk(table, args, rung)
                chunks.append((lo, hi, p[3]))
            if ps is not None:
                stamps.append(_stamp(self.device))
                ps.mark(rungs=[lane_rung(min(top, c[2])) for c in chunks], len_rung=int(rung),
                        lanes=int(live), pad_lanes=int(pad_rows), chunks=len(chunks),
                        parser=parser)
                ps = (ps, stamps)
            metrics.l7_pad_lanes_total.inc({"kind": "lane"}, pad_rows)
            metrics.l7_pad_lanes_total.inc({"kind": "lane_live"}, live)
            metrics.l7_pad_lanes_total.inc(
                {"kind": "len_bytes"}, live * rung - live_bytes
            )
            metrics.l7_pad_lanes_total.inc({"kind": "len_bytes_live"}, live_bytes)
            metrics.l7_batches_total.inc({"parser": parser})

        pending = PendingL7Batch(self)
        entry = _InFlight(pending, chunks, n_req, table.n_fields, bt, t0, ps)
        if bt is not NOOP_BATCH:
            tr.detach(bt)
        overflow: List[_InFlight] = []
        with self._lock:
            self._inflight.append(entry)
            while len(self._inflight) > self.depth:
                overflow.append(self._inflight.popleft())
        for e in overflow:
            self._finish(e)
        return pending

    # -- completion ------------------------------------------------------
    def _complete_until(self, pending: PendingL7Batch) -> None:
        while not pending._done:
            with self._lock:
                if not self._inflight:
                    break
                entry = self._inflight.popleft()
            self._finish(entry)

    def _finish(self, entry: _InFlight) -> None:
        bt = entry.bt
        ps = entry.ps
        t_out = None if ps is None else _stamp(self.device)
        try:
            with bt.phase("host_sync"):
                parts = [masks_u64(lo, hi)[:take] for lo, hi, take in entry.chunks]
                if not parts:
                    masks = np.zeros(0, np.uint64)
                elif len(parts) == 1:
                    masks = parts[0]
                else:
                    masks = np.concatenate(parts)
            b = entry.n_req
            entry.pending._value = [
                masks[f * b : (f + 1) * b] for f in range(entry.n_fields)
            ]
            if ps is not None:
                # the copies out: from t_out, recorded behind the walks,
                # to a stamp after the pulls, which waited for them
                entry.ps = None
                sample, (e0, e1, e2) = ps
                e3 = _stamp(self.device)
                if not isinstance(e3, float):
                    e3.synchronize()
                sample.add_h2d(_secs(e0, e1))
                sample.add_compute(_secs(e1, e2))
                sample.add_d2h(_secs(t_out, e3))
                prof = self.profiler
                if prof is not None:
                    prof.complete(sample)
        # not swallowed: the error is stored and re-raised by the
        # caller's result() — completion must still mark the batch done
        # or FIFO draining would deadlock behind it
        except Exception as exc:  # policyd-lint: disable=ROBUST001
            entry.pending._exc = exc
        entry.pending._done = True
        metrics.l7_batch_seconds.observe(time.perf_counter() - entry.t0)
        bt.end()

    def drain(self) -> None:
        while True:
            with self._lock:
                if not self._inflight:
                    return
                entry = self._inflight.popleft()
            self._finish(entry)


# ---------------------------------------------------------------------------
# L7DeviceBatch runtime gate
# ---------------------------------------------------------------------------

_rt_lock = threading.Lock()
_enabled = False
_pipeline: Optional[L7Pipeline] = None
# shared DeviceProfiler: installed while DeviceProfiling is on, carried
# onto any pipeline set_device_batch creates later so toggle order
# doesn't matter
_profiler = None


def set_device_batch(on: bool, tracer: Optional[Tracer] = None,
                     depth: int = 2, device=None) -> None:
    """Flip the L7DeviceBatch runtime option; ``device`` (None = the
    card) is where the shared pipeline walks. Turning it OFF drains
    outstanding batches and drops the shared pipeline — the next check
    runs the pre-option code path."""
    global _enabled, _pipeline
    if on:
        dev = _kernels.resolve_device(device)
    with _rt_lock:
        if on:
            if (
                _pipeline is None
                or (tracer is not None and _pipeline.tracer is not tracer)
                or _pipeline.device != dev
            ):
                _pipeline = L7Pipeline(depth=depth, tracer=tracer, device=dev)
            _pipeline.profiler = _profiler
            _enabled = True
            return
        _enabled = False
        pipe, _pipeline = _pipeline, None
    if pipe is not None:
        pipe.drain()


def set_profiler(prof) -> None:
    """Install (or clear, with None) the shared DeviceProfiler on the
    L7 pipeline — the DeviceProfiling half of the L7DeviceBatch gate:
    every ``sample_every``-th submit is sampled at the ``l7`` site."""
    global _profiler
    with _rt_lock:
        _profiler = prof
        if _pipeline is not None:
            _pipeline.profiler = prof


def device_batch_enabled() -> bool:
    # one unlocked read on the request path (same cost model as
    # tracer.active)
    return _enabled


def shared_pipeline() -> Optional[L7Pipeline]:
    with _rt_lock:
        return _pipeline


def _reset_for_tests() -> None:
    set_device_batch(False)
    set_profiler(None)
