"""policyd-journal: causally-ordered lifecycle event journal.

Numeric telemetry (observe/fleet.py) answers "how fast, how hot";
chaos and rolling-upgrade assertions need the OTHER half: the discrete
lifecycle transitions — drain → snapshot → kill → restore → rejoin —
as a machine-checkable sequence. Three layers, bottom-up:

- :class:`HLC` — a hybrid logical clock ``(physical_ms, logical)``.
  Local ticks are monotone even when the wall clock steps backwards;
  the receive rule (:meth:`HLC.observe`) folds timestamps seen on peer
  frames so events emitted after hearing from a skewed peer still
  order after that peer's events. Merge order is the total order
  ``(hlc, node, seq)``.

- :class:`EventJournal` — a bounded, schema-versioned ring of
  structured events ``(seq, wall_ts, hlc, node, kind, severity,
  attrs)``. ``kind`` must be a :data:`~..contracts.JOURNAL_KINDS` row
  (lint rule OBS003 pins the emit sites); ``attrs`` carries the
  correlating bases the repo already maintains (policy_epoch,
  _mat_basis, placement generation, pipeline_mode, CT basis_match).
  Ring overflow is accounted in ``journal_dropped_total`` — the tail
  is complete iff that counter stayed zero.

- :class:`JournalExchange` + :class:`JournalPublisher` +
  :func:`merge_timelines` — each daemon publishes its journal tail as
  a compact versioned frame through a federation SharedStore under
  ``CLUSTER_JOURNAL_PATH`` (the telemetry exchange's sibling);
  ``merge_timelines`` folds every live peer frame into one
  HLC-total-ordered fleet timeline (``cilium-tpu fleet timeline``,
  ``GET /fleet/timeline``, bench --fleetobs ``timeline_merge_ok``).

This module is ONLY imported when the ``LifecycleJournal`` runtime
option turns on — the daemon's OFF path never touches it (the
tripwire test pins ``cilium_tpu_torch.observe.journal`` out of
``sys.modules``), and hot modules reach it only through a None-guarded
``on_journal`` slot.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from .. import metrics as _metrics
from ..contracts import JOURNAL_KINDS, JOURNAL_SEVERITIES
from ..kvstore.paths import CLUSTER_JOURNAL_PATH
from ..kvstore.store import SharedStore

log = logging.getLogger(__name__)

_KV_DOWN = (ConnectionError, TimeoutError, OSError, RuntimeError)

# Event record schema version: bumped when the event tuple shape
# changes. Stamped on snapshots, frames, and bugtool events.json so
# offline consumers can diff archives across daemon versions.
SCHEMA_VERSION = 1

_KIND_SET = frozenset(JOURNAL_KINDS)
_SEV_SET = frozenset(JOURNAL_SEVERITIES)


# -- hybrid logical clock ---------------------------------------------------


class HLC:
    """Hybrid logical clock: ``(l, c)`` where ``l`` is the max physical
    millisecond timestamp seen and ``c`` breaks ties. Monotone under
    wall-clock regression; :meth:`observe` is the message-receive rule
    that makes cross-node merge order causally consistent."""

    __slots__ = ("_clock", "_l", "_c", "_lock")

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock or time.time
        self._l = 0
        self._c = 0
        self._lock = threading.Lock()

    def _pt(self) -> int:
        return int(self._clock() * 1000.0)

    def tick(self) -> Tuple[int, int]:
        """Timestamp one local event."""
        pt = self._pt()
        with self._lock:
            if pt > self._l:
                self._l, self._c = pt, 0
            else:
                self._c += 1
            return self._l, self._c

    def observe(self, l: int, c: int) -> Tuple[int, int]:
        """Fold a timestamp seen on a peer's event (receive rule):
        local events emitted after this call order after ``(l, c)``
        even when the peer's wall clock runs ahead of ours."""
        l, c = int(l), int(c)
        pt = self._pt()
        with self._lock:
            nl = max(self._l, l, pt)
            if nl == self._l and nl == l:
                self._c = max(self._c, c) + 1
            elif nl == self._l:
                self._c += 1
            elif nl == l:
                self._c = c + 1
            else:
                self._c = 0
            self._l = nl
            return self._l, self._c

    def read(self) -> Tuple[int, int]:
        with self._lock:
            return self._l, self._c


def order_key(ev: Mapping) -> Tuple[int, int, str, int]:
    """The HLC total order a merged timeline sorts by: ``(l, c, node,
    seq)`` — deterministic for any frame arrival order."""
    hlc = ev.get("hlc") or (0, 0)
    return (
        int(hlc[0]),
        int(hlc[1]),
        str(ev.get("node", "")),
        int(ev.get("seq", 0)),
    )


# -- the journal ring -------------------------------------------------------


class EventJournal:
    """Bounded ring of structured lifecycle events. ``emit`` is safe
    from any thread; eviction of the oldest event is accounted in
    ``journal_dropped_total``."""

    def __init__(
        self,
        *,
        node: str = "local",
        capacity: int = 512,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError("journal capacity must be >= 1")
        self.node = str(node)
        self.capacity = int(capacity)
        self._clock = clock or time.time
        self.hlc = HLC(clock=self._clock)
        self._events: deque = deque()
        self._lock = threading.Lock()
        self.seq = 0
        self.dropped = 0

    def emit(
        self,
        *,
        kind: str,
        severity: str = "info",
        attrs: Optional[Mapping] = None,
    ) -> Dict:
        """Record one event. ``kind`` must be a JOURNAL_KINDS row and
        ``severity`` a JOURNAL_SEVERITIES row — both bound the
        ``journal_events_total`` label space."""
        if kind not in _KIND_SET:
            raise ValueError(f"unknown journal kind {kind!r}")
        if severity not in _SEV_SET:
            raise ValueError(f"unknown journal severity {severity!r}")
        l, c = self.hlc.tick()
        ev: Dict = {
            "seq": 0,
            "wall_ts": round(float(self._clock()), 6),
            "hlc": [l, c],
            "node": self.node,
            "kind": kind,
            "severity": severity,
            "attrs": dict(attrs or {}),
        }
        with self._lock:
            self.seq += 1
            ev["seq"] = self.seq
            self._events.append(ev)
            if len(self._events) > self.capacity:
                self._events.popleft()
                self.dropped += 1
                _metrics.journal_dropped_total.inc()
        _metrics.journal_events_total.inc(
            {"kind": kind, "severity": severity}
        )
        return ev

    def events(
        self,
        limit: int = 64,
        *,
        kind: Optional[str] = None,
        severity: Optional[str] = None,
        since: Optional[float] = None,
    ) -> List[Dict]:
        """The newest ``limit`` events matching the filters, oldest
        first (the GET /events body)."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if severity is not None:
            evs = [e for e in evs if e["severity"] == severity]
        if since is not None:
            evs = [e for e in evs if e["wall_ts"] >= float(since)]
        if limit is not None and limit >= 0:
            evs = evs[-int(limit):]
        return [dict(e) for e in evs]

    def tail(self, n: int = 64) -> List[Dict]:
        """The newest ``n`` events, oldest first (the frame payload)."""
        with self._lock:
            evs = list(self._events)[-int(n):]
        return [dict(e) for e in evs]

    def snapshot(self) -> Dict:
        """Ring accounting for /events and status surfaces."""
        with self._lock:
            return {
                "journal_schema": SCHEMA_VERSION,
                "node": self.node,
                "capacity": self.capacity,
                "recorded": self.seq,
                "dropped": self.dropped,
                "hlc": list(self.hlc.read()),
            }


# -- journal frame codec ----------------------------------------------------

FRAME_VERSION = 1


def encode_frame(
    node: str,
    seq: int,
    events: List[Dict],
    *,
    cluster: str = "default",
    ts: Optional[float] = None,
) -> Dict:
    """One wire frame: version stamps + identity + the journal tail."""
    return {
        "v": FRAME_VERSION,
        "journal_schema": SCHEMA_VERSION,
        "node": node,
        "cluster": cluster,
        "seq": int(seq),
        # wall clock on purpose: staleness must compare across
        # processes, which monotonic clocks never do
        "ts": time.time() if ts is None else float(ts),
        "events": list(events),
    }


def decode_frame(rec) -> Optional[Dict]:
    """Validate one stored record back into a frame; None for version
    mismatches and malformed stamps (counted as
    ``journal_frames_total{result="rejected"}`` by the reader)."""
    if not isinstance(rec, dict) or rec.get("v") != FRAME_VERSION:
        return None
    if rec.get("journal_schema") != SCHEMA_VERSION:
        return None
    node = rec.get("node")
    if not isinstance(node, str) or not node:
        return None
    if not isinstance(rec.get("events"), list):
        return None
    try:
        int(rec["seq"])
        float(rec["ts"])
    except (KeyError, TypeError, ValueError):
        return None
    return dict(rec)


# -- the exchange -----------------------------------------------------------


class JournalExchange:
    """One node's journal-tail publication + its view of every peer's
    tails, over a SharedStore under ``CLUSTER_JOURNAL_PATH`` (the
    telemetry exchange's sibling)."""

    def __init__(
        self,
        backend,
        node_name: str,
        *,
        cluster: str = "default",
        base_path: str = CLUSTER_JOURNAL_PATH,
        stale_s: float = 30.0,
    ) -> None:
        self.node_name = node_name
        self.cluster = cluster
        self.stale_s = float(stale_s)
        self.key_name = f"{cluster}/{node_name}"
        self._seq = 0
        self.store = SharedStore(backend, base_path)

    def publish(
        self, events: List[Dict], *, ts: Optional[float] = None
    ) -> bool:
        """Publish one tail frame (lease-bound; dies with the node).
        False when the kvstore is down — the journal keeps recording
        locally and the next successful publish carries a later tail."""
        self._seq += 1
        frame = encode_frame(
            self.node_name, self._seq, events, cluster=self.cluster, ts=ts
        )
        try:
            self.store.update_local_key_sync(self.key_name, frame)
        except _KV_DOWN:
            _metrics.journal_frames_total.inc({"result": "publish_error"})
            return False
        _metrics.journal_frames_total.inc({"result": "published"})
        return True

    def pump(self) -> int:
        """Apply pending peer frame events; returns events applied."""
        return self.store.pump()

    def frames(
        self, *, now: Optional[float] = None, stale_s: Optional[float] = None
    ) -> Dict[str, Dict]:
        """node → live decoded journal frame. Rejects version drift
        and ages out frames past the staleness horizon."""
        ref = time.time() if now is None else float(now)
        horizon = self.stale_s if stale_s is None else float(stale_s)
        out: Dict[str, Dict] = {}
        for rec in dict(self.store.shared).values():
            f = decode_frame(rec)
            if f is None:
                _metrics.journal_frames_total.inc({"result": "rejected"})
                continue
            if f.get("cluster") != self.cluster:
                continue
            if ref - f["ts"] > horizon:
                _metrics.journal_frames_total.inc({"result": "stale"})
                continue
            out[f["node"]] = f
        return out

    def sync(self) -> int:
        """Anti-entropy re-write of our frame (heartbeat path)."""
        return self.store.sync_local_keys()

    def close(self) -> None:
        try:
            self.store.delete_local_key(self.key_name)
        except _KV_DOWN:
            pass  # backend gone; the lease reaps our record
        self.store.close()


# -- fleet timeline merge ---------------------------------------------------


def merge_timelines(
    frames: Mapping[str, object], *, limit: Optional[int] = None
) -> List[Dict]:
    """Fold per-node journals into one HLC-total-ordered timeline.

    ``frames`` maps node → decoded journal frame OR a bare event list
    (the local journal tail rides alongside peer frames). Events are
    deduplicated on ``(node, seq)`` — overlapping tails from a node's
    own frame and the local journal collapse — then sorted by the
    ``(hlc, node, seq)`` total order, deterministic for any arrival
    order of the same frames."""
    merged: List[Dict] = []
    seen = set()
    for node, f in frames.items():
        evs = f.get("events", []) if isinstance(f, Mapping) else f
        for ev in evs:
            if not isinstance(ev, Mapping):
                continue
            ev = dict(ev)
            ev.setdefault("node", node)
            key = (ev["node"], int(ev.get("seq", 0)))
            if key in seen:
                continue
            seen.add(key)
            merged.append(ev)
    merged.sort(key=order_key)
    if limit is not None and limit >= 0:
        merged = merged[-int(limit):]
    return merged


def timeline_consistent(events: List[Mapping]) -> bool:
    """True when a merged timeline is HLC-consistent: globally
    non-decreasing in the ``(hlc, node, seq)`` total order AND
    per-node seq order preserved (no node's events were reordered by
    the merge — the causal guarantee the chaos round asserts)."""
    last_key = None
    last_seq: Dict[str, int] = {}
    for ev in events:
        k = order_key(ev)
        if last_key is not None and k < last_key:
            return False
        last_key = k
        node, seq = str(ev.get("node", "")), int(ev.get("seq", 0))
        if seq <= last_seq.get(node, 0):
            return False
        last_seq[node] = seq
    return True


# -- the publisher ----------------------------------------------------------


class JournalPublisher:
    """The ``LifecycleJournal`` cadence thread: every ``interval_s``
    publish the journal tail through the exchange (when one is
    attached) and fold peer HLC timestamps into the local clock so
    cross-node order stays causal under wall-clock skew.
    ``publish_once`` is the whole tick, directly callable for
    deterministic tests."""

    def __init__(
        self,
        journal: EventJournal,
        *,
        interval_s: float = 1.0,
        tail_n: int = 64,
    ) -> None:
        self.journal = journal
        self.interval_s = float(interval_s)
        self.tail_n = int(tail_n)
        self.exchange: Optional[JournalExchange] = None
        self._published_seq = -1
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- wiring ---------------------------------------------------------
    def attach_exchange(self, exchange: Optional[JournalExchange]) -> None:
        with self._lock:
            self.exchange = exchange
            self._published_seq = -1

    # -- one tick -------------------------------------------------------
    def publish_once(self) -> bool:
        """Publish the current tail iff the journal moved since the
        last publish; pump the store and fold peer clocks either way.
        Returns whether a frame went out."""
        with self._lock:
            ex = self.exchange
            if ex is None:
                return False
            published = False
            if self.journal.seq != self._published_seq:
                published = ex.publish(self.journal.tail(self.tail_n))
                if published:
                    self._published_seq = self.journal.seq
            try:
                ex.pump()
            except _KV_DOWN:
                return published  # partition: frames age out
            for node, frame in ex.frames().items():
                if node == self.journal.node:
                    continue
                evs = frame.get("events") or []
                if evs:
                    hlc = evs[-1].get("hlc") or (0, 0)
                    self.journal.hlc.observe(hlc[0], hlc[1])
            return published

    def merged_timeline(self, limit: int = 256) -> List[Dict]:
        """Local tail + every live peer tail, HLC-total-ordered."""
        frames: Dict[str, object] = {}
        ex = self.exchange
        if ex is not None:
            try:
                ex.pump()
            except _KV_DOWN:
                pass
            frames.update(ex.frames())
        # the local journal wins over our own (possibly older) frame
        frames[self.journal.node] = self.journal.tail(
            limit if limit is not None else self.tail_n
        )
        return merge_timelines(frames, limit=limit)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="journal-publisher", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.publish_once()
            except Exception:
                # a journal tick must never take the process down;
                # the next tick retries with fresh state
                log.exception("journal publisher tick failed")

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
        # detach under the lock (a straggling publish_once must see
        # either the live exchange or None, never a closed one), close
        # outside it (close touches the kvstore)
        with self._lock:
            ex, self.exchange = self.exchange, None
        if ex is not None:
            try:
                ex.close()
            except _KV_DOWN:
                pass
