"""Port parity: the lifecycle journal (``observe/journal.py``).

The module is host code copied from the JAX package. The reference's
``test_journal.py`` runs here against both packages (the ``jr``
fixture): every test that builds no ``Daemon`` — ``TestHLC``,
``TestEventJournal``, ``TestFrameCodec``, ``TestMergeTimelines``,
``TestExchangeAndPublisher`` and ``TestShedEpisodes`` (the admission
controller of the package under test, its module's ``time`` patched).
``TestLifecycleJournalOption`` builds a ``Daemon`` and comes with the
port's daemon.

Pipeline parity: one world through both packages
(``test_torch_harness.build_world`` via ``test_torch_submit.Pair``), a
journal armed on each pipeline and its admission controller as the
reference's daemon arms them, and the same sequence through both: a
full rebuild, an identity delta, a rule delta, an epoch swap, poisoned
completions that move the ladder and clean batches that move it back,
a quarantine on the device-CT path, and a gated batch's shed episode.
The ``(kind, severity, attrs)`` lists must be equal (``hlc``,
``wall_ts``, ``node`` and ``seq`` are left out). One named divergence:
the reference's device-CT rescue also pulls the live slot C-1 entry its
K10 writes for a skipped lane (ROADMAP queue C), so the quarantine's
``ct_rescue.kept`` may exceed the port's by exactly that entry, and only
where the reference's slot C-1 is live. The watchdog's stall and the
federation member's ``lease_lost`` and ``identity_reap`` are held the
same way.

A mixed fleet: a JAX node and a port node publish their journals (and
telemetry frames) to one ``KVStoreServer`` over TCP, both ways round;
each merged timeline holds both nodes and is HLC-consistent, and the
frames each package encodes decode to equal dicts in the other.
"""

from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch

from cilium_tpu import faults as jfaults
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch.datapath import placement as tplace
from test_torch_harness import PKGS
from test_torch_incremental import _labels, _rule
from test_torch_submit import Pair


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _ns(pkg: str):
    """The names the reference's journal tests import, from ``pkg``."""
    journal = _mod(pkg, "observe.journal")
    contracts = _mod(pkg, "contracts")
    adm = _mod(pkg, "datapath.admission")
    kv = _mod(pkg, "kvstore.backend")
    ns = types.SimpleNamespace(
        pkg=pkg,
        metrics=_mod(pkg, "metrics"),
        JOURNAL_KINDS=contracts.JOURNAL_KINDS,
        JOURNAL_SEVERITIES=contracts.JOURNAL_SEVERITIES,
        admission_mod=adm,
        REASON_SHED_DEADLINE=adm.REASON_SHED_DEADLINE,
        REASON_SHED_PREFILTER=adm.REASON_SHED_PREFILTER,
        AdmissionController=adm.AdmissionController,
        InMemoryBackend=kv.InMemoryBackend,
        InMemoryStore=kv.InMemoryStore,
    )
    for name in ("FRAME_VERSION", "HLC", "SCHEMA_VERSION", "EventJournal", "JournalExchange",
                 "JournalPublisher", "decode_frame", "encode_frame", "merge_timelines",
                 "order_key", "timeline_consistent"):
        setattr(ns, name, getattr(journal, name))
    return ns


@pytest.fixture(params=PKGS)
def jr(request):
    return _ns(request.param)


def test_public_names_match():
    j, t = (_mod(pkg, "observe.journal") for pkg in PKGS)
    assert sorted(n for n in vars(t) if not n.startswith("_")) == sorted(
        n for n in vars(j) if not n.startswith("_"))
    assert t.__doc__.replace("cilium_tpu_torch.", "cilium_tpu.") == j.__doc__
    # the port's observe package keeps the plane out of its imports
    assert "journal" not in _mod("cilium_tpu_torch", "observe").__all__


class _Clock:
    """Injectable wall clock (seconds, settable — HLC and EventJournal
    both take ``clock=``)."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


# -- test_journal.py -----------------------------------------------------------

class TestHLC:
    def test_tick_monotone_under_wall_regression(self, jr):
        clk = _Clock(100.0)
        h = jr.HLC(clock=clk)
        keys = [h.tick()]
        for t in (100.5, 99.0, 98.0, 98.0, 100.5):
            clk.t = t
            keys.append(h.tick())
        # strictly increasing despite the clock stepping backwards
        assert keys == sorted(keys)
        assert len(set(keys)) == len(keys)
        # the regression rode the logical component, not physical time
        assert keys[-1][0] == int(100.5 * 1000)

    def test_observe_receive_rule(self, jr):
        clk = _Clock(100.0)
        h = jr.HLC(clock=clk)
        h.tick()
        # fold a peer timestamp 100s AHEAD of our wall clock
        l, c = h.observe(200_000, 5)
        assert (l, c) == (200_000, 6)
        # subsequent local ticks order after the peer's event even
        # though our wall clock never caught up
        assert h.tick() == (200_000, 7)
        # a stale peer timestamp never moves the clock backwards
        before = h.read()
        assert h.observe(50_000, 9) > before

    def test_order_key_total_order(self, jr):
        evs = [
            {"hlc": [5, 0], "node": "b", "seq": 1},
            {"hlc": [5, 0], "node": "a", "seq": 2},
            {"hlc": [4, 9], "node": "z", "seq": 9},
        ]
        assert sorted(evs, key=jr.order_key) == [evs[2], evs[1], evs[0]]
        # missing hlc sorts first, not a crash
        assert jr.order_key({"node": "n", "seq": 3}) == (0, 0, "n", 3)


class TestEventJournal:
    def test_emit_validates_vocabulary(self, jr):
        j = jr.EventJournal(node="n", capacity=8)
        with pytest.raises(ValueError, match="unknown journal kind"):
            j.emit(kind="not-a-kind")
        with pytest.raises(ValueError, match="unknown journal severity"):
            j.emit(kind="boot", severity="fatal")
        assert j.seq == 0 and j.events() == []

    def test_event_shape_and_attr_isolation(self, jr):
        clk = _Clock(123.456789)
        j = jr.EventJournal(node="node-a", capacity=8, clock=clk)
        attrs = {"policy_epoch": 7}
        ev = j.emit(kind="boot", attrs=attrs)
        attrs["policy_epoch"] = 99  # caller mutation must not leak
        assert ev["seq"] == 1
        assert ev["node"] == "node-a"
        assert ev["kind"] == "boot" and ev["severity"] == "info"
        assert ev["wall_ts"] == pytest.approx(123.456789)
        assert j.events()[0]["attrs"] == {"policy_epoch": 7}
        c0 = jr.metrics.journal_events_total.get(
            {"kind": "boot", "severity": "info"})
        j.emit(kind="boot")
        assert jr.metrics.journal_events_total.get(
            {"kind": "boot", "severity": "info"}) == c0 + 1

    def test_ring_overflow_accounting(self, jr):
        d0 = jr.metrics.journal_dropped_total.get()
        j = jr.EventJournal(node="n", capacity=4)
        for _ in range(10):
            j.emit(kind="boot")
        assert j.seq == 10 and j.dropped == 6
        assert jr.metrics.journal_dropped_total.get() == d0 + 6
        # the ring keeps exactly the newest `capacity`, oldest first
        assert [e["seq"] for e in j.tail(64)] == [7, 8, 9, 10]
        snap = j.snapshot()
        assert snap["journal_schema"] == jr.SCHEMA_VERSION
        assert snap["recorded"] == 10 and snap["dropped"] == 6
        assert snap["capacity"] == 4
        with pytest.raises(ValueError, match="capacity"):
            jr.EventJournal(capacity=0)

    def test_events_filters(self, jr):
        clk = _Clock(10.0)
        j = jr.EventJournal(node="n", capacity=32, clock=clk)
        j.emit(kind="boot")
        clk.t = 20.0
        j.emit(kind="shed_start", severity="warning")
        clk.t = 30.0
        j.emit(kind="shed_end")
        assert [e["kind"] for e in j.events()] == [
            "boot", "shed_start", "shed_end"]
        assert [e["kind"] for e in j.events(kind="shed_start")] == [
            "shed_start"]
        assert [e["kind"] for e in j.events(severity="warning")] == [
            "shed_start"]
        assert [e["kind"] for e in j.events(since=20.0)] == [
            "shed_start", "shed_end"]
        assert [e["kind"] for e in j.events(1)] == ["shed_end"]


class TestFrameCodec:
    def _frame(self, jr, **over):
        f = jr.encode_frame("node-a", 3, [{"seq": 1, "hlc": [5, 0]}],
                            cluster="t", ts=100.0)
        f.update(over)
        return f

    def test_round_trip(self, jr):
        f = self._frame(jr)
        assert f["v"] == jr.FRAME_VERSION
        assert f["journal_schema"] == jr.SCHEMA_VERSION
        assert f["seq"] == 3 and f["ts"] == 100.0 and f["cluster"] == "t"
        assert jr.decode_frame(f) == f

    def test_rejections(self, jr):
        assert jr.decode_frame(None) is None
        assert jr.decode_frame([1, 2]) is None
        assert jr.decode_frame(self._frame(jr, v=jr.FRAME_VERSION + 1)) is None
        assert jr.decode_frame(
            self._frame(jr, journal_schema=jr.SCHEMA_VERSION + 1)) is None
        assert jr.decode_frame(self._frame(jr, node="")) is None
        assert jr.decode_frame(self._frame(jr, node=7)) is None
        assert jr.decode_frame(self._frame(jr, events={"not": "a list"})) is None
        assert jr.decode_frame(self._frame(jr, seq="x")) is None
        assert jr.decode_frame(self._frame(jr, ts=None)) is None


class TestMergeTimelines:
    def _skewed_pair(self, jr):
        """node-a's wall clock runs 120s AHEAD of node-b's."""
        ca, cb = _Clock(1120.0), _Clock(1000.0)
        return (jr.EventJournal(node="node-a", capacity=32, clock=ca),
                jr.EventJournal(node="node-b", capacity=32, clock=cb))

    def test_merge_dedupes_and_is_deterministic(self, jr):
        ja, jb = self._skewed_pair(jr)
        ja.emit(kind="boot")
        ja.emit(kind="rebuild")
        jb.emit(kind="boot")
        frame_a = jr.encode_frame("node-a", 1, ja.tail(), ts=1120.0)
        # node-a appears twice: as a peer frame AND as a local tail —
        # overlap must collapse on (node, seq)
        m1 = jr.merge_timelines({"node-a": frame_a, "node-b": jb.tail(),
                                 "local": ja.tail()})
        m2 = jr.merge_timelines({"local": ja.tail(), "node-b": jb.tail(),
                                 "node-a": frame_a})
        assert m1 == m2
        assert len(m1) == 3
        assert sorted(e["seq"] for e in m1 if e["node"] == "node-a") == [1, 2]
        assert jr.timeline_consistent(m1)
        assert jr.merge_timelines({"node-a": frame_a}, limit=1) == [
            ja.tail()[-1]]

    def test_observe_keeps_causal_order_under_skew(self, jr):
        ja, jb = self._skewed_pair(jr)
        e1 = ja.emit(kind="quarantine", severity="error")
        # without the receive rule, node-b (120s behind) would emit its
        # causally-LATER rescue event with a smaller HLC
        naive = jb.hlc.read()
        assert naive < tuple(e1["hlc"])
        jb.hlc.observe(*e1["hlc"])
        jb.emit(kind="ct_restore")
        merged = jr.merge_timelines({"a": ja.tail(), "b": jb.tail()})
        assert [e["kind"] for e in merged] == ["quarantine", "ct_restore"]
        assert jr.timeline_consistent(merged)

    def test_timeline_consistent_negatives(self, jr):
        ja, jb = self._skewed_pair(jr)
        jb.emit(kind="boot")
        ja.emit(kind="boot")
        good = jr.merge_timelines({"a": ja.tail(), "b": jb.tail()})
        assert jr.timeline_consistent(good)
        # global HLC order violated
        assert not jr.timeline_consistent(list(reversed(good)))
        # per-node seq order violated (same node, non-increasing seq)
        dup = good + [dict(good[0])]
        assert not jr.timeline_consistent(dup)
        assert jr.timeline_consistent([])


def _publisher_threads():
    return [t for t in threading.enumerate() if t.name == "journal-publisher"]


class TestExchangeAndPublisher:
    def _node(self, jr, store, name, clock):
        j = jr.EventJournal(node=name, capacity=32, clock=clock)
        pub = jr.JournalPublisher(j, tail_n=16)
        pub.attach_exchange(jr.JournalExchange(
            jr.InMemoryBackend(store, name[-1]), name, cluster="t"))
        return j, pub

    def test_publish_iff_moved_and_peer_view(self, jr):
        store = jr.InMemoryStore()
        ja, pa = self._node(jr, store, "node-a", _Clock(100.0))
        jb, pb = self._node(jr, store, "node-b", _Clock(100.0))
        try:
            ja.emit(kind="boot")
            assert pa.publish_once() is True
            # no journal movement since: nothing to publish
            assert pa.publish_once() is False
            jb.emit(kind="boot")
            assert pb.publish_once() is True
            merged = pb.merged_timeline()
            assert {e["node"] for e in merged} == {"node-a", "node-b"}
            assert jr.timeline_consistent(merged)
        finally:
            pa.stop()
            pb.stop()
        # stop() detached and closed the exchange: later ticks no-op
        assert pa.exchange is None and pa.publish_once() is False

    def test_publisher_folds_peer_clocks(self, jr):
        """A 300s-skewed fleet still merges HLC-consistently because
        publish_once folds every peer frame's newest HLC into the
        local clock (the chaos-round invariant)."""
        store = jr.InMemoryStore()
        ja, pa = self._node(jr, store, "node-a", _Clock(1300.0))  # ahead
        jb, pb = self._node(jr, store, "node-b", _Clock(1000.0))  # behind
        try:
            ja.emit(kind="drain_begin")
            pa.publish_once()
            pb.publish_once()  # pumps + observes node-a's tail HLC
            jb.emit(kind="boot")  # causally after the drain it saw
            pb.publish_once()
            pa.publish_once()
            for pub in (pa, pb):
                merged = pub.merged_timeline()
                assert [e["kind"] for e in merged] == [
                    "drain_begin", "boot"]
                assert jr.timeline_consistent(merged)
        finally:
            pa.stop()
            pb.stop()

    def test_frames_age_out_and_reject_drift(self, jr):
        store = jr.InMemoryStore()
        ja, pa = self._node(jr, store, "node-a", _Clock(100.0))
        try:
            ex = pa.exchange
            ja.emit(kind="boot")
            assert ex.publish(ja.tail(), ts=100.0)
            ex.pump()
            assert set(ex.frames(now=101.0)) == {"node-a"}
            # past the staleness horizon the frame disappears
            assert ex.frames(now=100.0 + ex.stale_s + 1.0) == {}
            # a frame from a future codec version is rejected
            bad = jr.encode_frame("node-z", 1, [], cluster="t", ts=100.0)
            bad["v"] = jr.FRAME_VERSION + 1
            ex.store.update_local_key_sync("t/node-z", bad)
            ex.pump()
            r0 = jr.metrics.journal_frames_total.get({"result": "rejected"})
            assert set(ex.frames(now=101.0)) == {"node-a"}
            assert jr.metrics.journal_frames_total.get(
                {"result": "rejected"}) == r0 + 1
        finally:
            pa.stop()

    def test_publisher_thread_stops_with_stop(self, jr):
        """The cadence thread (``journal-publisher``) publishes on its
        own and never outlives ``stop()``."""
        store = jr.InMemoryStore()
        ja, pa = self._node(jr, store, "node-a", _Clock(100.0))
        pa.interval_s = 0.01
        before = set(_publisher_threads())  # another test's daemon may hold one
        try:
            ja.emit(kind="boot")
            pa.start()
            pa.start()  # idempotent: one thread
            assert len(set(_publisher_threads()) - before) == 1
            deadline = time.monotonic() + 5.0
            while pa._published_seq != ja.seq and time.monotonic() < deadline:
                time.sleep(0.005)
            assert pa._published_seq == ja.seq
        finally:
            pa.stop()
        assert not set(_publisher_threads()) - before


class _FakeTime:
    """Stand-in for the admission module's ``time`` (monotonic only —
    the episode hysteresis must be tested at exact hold boundaries)."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def monotonic(self) -> float:
        return self.t


class TestShedEpisodes:
    @pytest.fixture
    def adm(self, jr, monkeypatch):
        fake = _FakeTime()
        monkeypatch.setattr(jr.admission_mod, "time", fake)
        a = jr.AdmissionController(max_depth=8)
        a.events = []
        a.on_journal = lambda **kw: a.events.append(kw)
        a.clock = fake
        return a

    def test_one_start_per_episode(self, jr, adm):
        adm.note_shed(jr.REASON_SHED_PREFILTER, 3)
        adm.clock.t += 0.5
        adm.note_shed(jr.REASON_SHED_PREFILTER, 2)
        adm.clock.t += 0.4
        adm.note_shed(jr.REASON_SHED_DEADLINE, 1)
        # three shed batches inside the hold: exactly ONE edge event
        assert [e["kind"] for e in adm.events] == ["shed_start"]
        assert adm.events[0]["severity"] == "warning"
        assert adm.events[0]["attrs"] == {"reason": jr.REASON_SHED_PREFILTER}

    def test_poll_closes_quiet_episode_with_deltas(self, jr, adm):
        adm.note_shed(jr.REASON_SHED_PREFILTER, 3)
        adm.clock.t += 0.5
        adm.note_shed(jr.REASON_SHED_PREFILTER, 2)
        adm.clock.t += adm.SHED_HOLD_S  # hold expires
        adm.episode_poll()
        assert [e["kind"] for e in adm.events] == ["shed_start", "shed_end"]
        end = adm.events[-1]["attrs"]
        # per-reason deltas for THIS episode; duration spans first to
        # last shed, not to the poll that noticed the quiet
        assert end["shed"] == {jr.REASON_SHED_PREFILTER: 5}
        assert end["duration_s"] == pytest.approx(0.5)
        # a second poll finds nothing to close
        adm.episode_poll()
        assert len(adm.events) == 2
        # the next storm opens a fresh episode
        adm.clock.t += 5.0
        adm.note_shed(jr.REASON_SHED_DEADLINE, 1)
        assert [e["kind"] for e in adm.events] == [
            "shed_start", "shed_end", "shed_start"]
        assert adm.events[-1]["attrs"] == {"reason": jr.REASON_SHED_DEADLINE}

    def test_late_burst_closes_previous_episode_first(self, jr, adm):
        adm.note_shed(jr.REASON_SHED_PREFILTER, 3)
        adm.clock.t += adm.SHED_HOLD_S + 1.0
        # no poll ran: the burst itself must retire the stale episode,
        # and the old episode's deltas must NOT include the new burst
        adm.note_shed(jr.REASON_SHED_PREFILTER, 7)
        assert [e["kind"] for e in adm.events] == [
            "shed_start", "shed_end", "shed_start"]
        assert adm.events[1]["attrs"]["shed"] == {jr.REASON_SHED_PREFILTER: 3}
        assert adm.events[1]["attrs"]["duration_s"] == pytest.approx(0.0)

    def test_off_path_keeps_counters_without_events(self, jr, monkeypatch):
        fake = _FakeTime()
        monkeypatch.setattr(jr.admission_mod, "time", fake)
        a = jr.AdmissionController(max_depth=8)  # on_journal stays None
        a.note_shed(jr.REASON_SHED_PREFILTER, 4)
        fake.t += a.SHED_HOLD_S
        a.episode_poll()
        assert a.shed[jr.REASON_SHED_PREFILTER] == 4
        assert a._episode is None


# -- pipeline parity ------------------------------------------------------------

HUBS = (jfaults.hub, tfaults.hub)


@pytest.fixture
def seam(monkeypatch):
    """Clean fault hubs, and the port's device seam as JAX's 8 virtual
    CPU devices (the rebuild events' plan generations then agree)."""
    for h in HUBS:
        h.reset()
    monkeypatch.setattr(tplace, "visible_devices",
                        lambda: [tplace.DeviceRecord(i, 0, torch.device("cpu")) for i in range(8)])
    yield
    for h in HUBS:
        h.reset()


def _fail(site: str, kind: str) -> None:
    for h in HUBS:
        h.fail(site, kind, times=1)


def _bare(events):
    """(kind, severity, attrs) of each event: the HLC, the wall clock,
    the node and the sequence number are each package's own."""
    return [(e["kind"], e["severity"], e["attrs"]) for e in events]


class Armed(Pair):
    """A Pair whose pipelines (and admission controllers) emit into one
    EventJournal a package, as the reference's daemon arms them."""

    def __init__(self, seed: int = 3, **kw):
        super().__init__(seed, **kw)
        self.journal = {}
        for pkg, p in self.pipes.items():
            j = _mod(pkg, "observe.journal").EventJournal(node=f"node-{pkg}", capacity=256)
            p.on_journal = j.emit
            if p._admission is not None:
                p._admission.on_journal = j.emit
            p.retry_min_s = p.retry_max_s = 0.001
            self.journal[pkg] = j

    def both(self, fn):
        """fn(pkg, pipeline, world) in each package → the two results."""
        return [fn(pkg, p, self.w[pkg]) for pkg, p in self.pipes.items()]

    def new_events(self, since: int):
        """Each package's events after its first ``since``."""
        return [self.journal[pkg].events(256)[since:] for pkg in PKGS]


def test_pipeline_journal_sequence(seam, monkeypatch):
    """The whole sequence through both packages; after each step the
    new events are equal and of the expected kinds, and every event's
    kind and severity are in the reference's vocabulary."""
    now = [50_000.25]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    pr = Armed(3, depth=1, admission=True, prefilter_shed=True, device_ct_bits=10)
    seen = [0]

    def step(kinds):
        ej, et = pr.new_events(seen[0])
        assert _bare(et) == _bare(ej)
        assert [e["kind"] for e in et] == kinds
        seen[0] += len(et)
        return et

    # a full rebuild
    pr.both(lambda pkg, p, w: p.rebuild())
    (ev,) = step(["rebuild"])
    assert ev["attrs"]["prev_basis"] is None
    assert ev["attrs"]["basis"] == list(pr.t._mat_basis)
    # an identity delta: the served basis moves once
    pr.both(lambda pkg, p, w: w.reg.allocate(_labels(pkg, ["k8s:app=a1", "k8s:uid=journal"])))
    pr.both(lambda pkg, p, w: p.rebuild())
    (ev,) = step(["rebuild"])
    assert ev["attrs"]["basis"] == list(pr.t._mat_basis) != ev["attrs"]["prev_basis"]
    # a rule delta
    w0 = pr.w[PKGS[0]]
    app = next(lb for lb in w0.ident_labels[w0.idents[0].id] if "app=" in lb)
    pr.both(lambda pkg, p, w: w.repo.add_list(
        [_rule(pkg, [app], ["k8s:app=a2"], port=80, label="k8s:policy=jdelta")]))
    pr.both(lambda pkg, p, w: p.rebuild())
    step(["rebuild"])
    # an epoch swap: a rule that grows endpoint 0's slot set
    pr.both(lambda pkg, p, w: p.set_epoch_swap(True))
    pr.both(lambda pkg, p, w: w.repo.add_list([_rule(
        pkg, [app], [], port=9443, label="k8s:policy=jgrow", peer_exprs=[("k8s:uid", "Exists")])]))
    pr.both(lambda pkg, p, w: p.rebuild())  # kicks the shadow
    assert pr.both(lambda pkg, p, w: p.wait_epoch_swap(timeout=30.0)) == [True, True]
    pr.both(lambda pkg, p, w: p.rebuild())  # publishes
    swap, _ = step(["epoch_swap", "rebuild"])
    assert swap["attrs"]["policy_epoch"] == pr.t.policy_epoch == 1
    # two poisoned completions move the ladder down, clean batches back up
    pr.both(lambda pkg, p, w: (setattr(p, "breaker_threshold", 2),
                               setattr(p, "recover_after_clean", 3)))
    bt = pr.flows(4, 96, 5)
    for _ in range(2):
        _fail("complete", "poisoned")
        pr.both(lambda pkg, p, w: p.process(*bt))
    assert pr.both(lambda pkg, p, w: p.pipeline_mode) == ["single-device"] * 2
    for _ in range(3):
        pr.both(lambda pkg, p, w: p.process(*bt))
    assert pr.both(lambda pkg, p, w: p.pipeline_mode) == ["sharded"] * 2
    evs = step(["quarantine", "ladder_move", "quarantine", "ladder_move"])
    assert [e["attrs"] for e in evs if e["kind"] == "ladder_move"] == [
        {"from": "sharded", "to": "single-device", "level": 1},
        {"from": "single-device", "to": "sharded", "level": 0}]
    assert [e["severity"] for e in evs] == ["error", "warning", "error", "info"]
    # a quarantine on the device-CT path: the rescue's counts
    ips, eps, dports, protos = pr.flows(4, 400, 7)
    sports = np.random.default_rng(8).integers(1024, 60000, 400).astype(np.int32)
    out = pr.both(lambda pkg, p, w: p.process(ips, eps, dports, protos, sports=sports))
    pr.equal(out[1], tuple(np.asarray(x) for x in out[0]))
    c = 1 << 10
    junk = int(np.asarray(pr.j._device_ct.exp)[c - 1]) > int(now[0])
    _fail("complete", "poisoned")
    pr.both(lambda pkg, p, w: p.process(ips[:50], eps[:50], dports[:50], protos[:50]))
    ej, et = pr.new_events(seen[0])
    assert [e["kind"] for e in et] == [e["kind"] for e in ej] == ["quarantine"]
    rj, rt = ej[0]["attrs"]["ct_rescue"], et[0]["attrs"]["ct_rescue"]
    # the named divergence: the reference's live slot C-1 entry
    assert rt == {"kept": rj["kept"] - junk, "expired": rj["expired"]} and rt["kept"] > 0
    assert {k: v for k, v in et[0]["attrs"].items() if k != "ct_rescue"} == \
        {k: v for k, v in ej[0]["attrs"].items() if k != "ct_rescue"}
    assert et[0]["severity"] == ej[0]["severity"] == "error"
    seen[0] += 1
    # a deny-heavy batch through submit, the gate forced: one shed
    # episode, closed by the poll once the hold has passed
    peer, _ep, dp, prt = bt = pr.flows(4, 256, 21)
    n_shed = int(pr.t._shed_walk(peer, dp, prt, family=4).sum())
    assert n_shed > 0
    shed0 = pr.both(lambda pkg, p, w: dict(p._admission.shed))
    for f in (jfaults, tfaults):
        f.hub.fail(f.SITE_QUEUE_FULL, f.KIND_TRANSIENT, times=1)
    out = pr.both(lambda pkg, p, w: p.submit(*bt).result())
    pr.equal(out[1], tuple(np.asarray(x) for x in out[0]))
    step(["shed_start"])
    pr.both(lambda pkg, p, w: p._admission.episode_poll())
    step([])  # still inside the hold
    now[0] += pr.t._admission.SHED_HOLD_S
    pr.both(lambda pkg, p, w: p._admission.episode_poll())
    (end,) = step(["shed_end"])
    moved = {r: n - shed0[1].get(r, 0) for r, n in pr.t._admission.shed.items()
             if n != shed0[1].get(r, 0)}
    assert end["attrs"]["shed"] == moved == {"prefilter": n_shed}
    # the vocabulary
    tj = _ns(PKGS[1])
    for e in pr.journal[PKGS[1]].events(256):
        assert e["kind"] in tj.JOURNAL_KINDS and e["severity"] in tj.JOURNAL_SEVERITIES
        assert e["node"] == "node-cilium_tpu_torch"
    assert tj.timeline_consistent(pr.journal[PKGS[1]].events(256))


def test_watchdog_stall_event(seam):
    """A stall injected at the watchdog's site gives one
    ``watchdog_stall`` a sweep, equal but for its age (wall clock)."""
    pr = Armed(3, depth=2)
    pr.both(lambda pkg, p, w: p.rebuild())
    base = [len(pr.journal[pkg].events(256)) for pkg in PKGS]
    metrics = {pkg: _mod(pkg, "metrics") for pkg in PKGS}
    s0 = {pkg: m.watchdog_stalls_total.get({"site": "stall"}) for pkg, m in metrics.items()}
    for f in (jfaults, tfaults):
        f.hub.fail(f.SITE_STALL, f.KIND_TRANSIENT, times=1)
    try:
        for pkg, p in pr.pipes.items():
            p.set_stall_ms(20.0)
            m = metrics[pkg]
            deadline = time.monotonic() + 5.0
            while m.watchdog_stalls_total.get({"site": "stall"}) == s0[pkg]:
                assert time.monotonic() < deadline, "no stall counted"
                time.sleep(0.005)
            p.set_stall_ms(0)
    finally:
        pr.both(lambda pkg, p, w: p.set_stall_ms(0))
    got = [pr.journal[pkg].events(256)[n:] for pkg, n in zip(PKGS, base)]
    for evs in got:
        assert [e["kind"] for e in evs] == ["watchdog_stall"]
        assert evs[0]["severity"] == "error" and evs[0]["attrs"]["age_ms"] >= 0
    assert [{**e["attrs"], "age_ms": None} for e in got[1]] == \
        [{**e["attrs"], "age_ms": None} for e in got[0]]


class _Agent:
    """What a FederationMember reads of its daemon: ``registry`` and
    ``pipeline.policy_epoch``."""

    def __init__(self, pkg: str):
        dev = {"device": "cpu"} if pkg == "cilium_tpu_torch" else {}
        self.registry = _mod(pkg, "identity").IdentityRegistry()
        engine = _mod(pkg, "engine").PolicyEngine(
            _mod(pkg, "policy.repository").Repository(), self.registry, **dev)
        self.pipeline = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            engine, _mod(pkg, "ipcache.ipcache").IPCache(), **dev)


def test_federation_member_events():
    """``lease_lost`` from a heartbeat that repairs wiped keys and
    ``identity_reap`` from a GC after a peer's lease died: the same
    events from both packages' members, on in-memory stores."""
    got = {}
    for pkg in PKGS:
        fed, kv = _mod(pkg, "federation"), _mod(pkg, "kvstore")
        store = kv.InMemoryStore()
        j = _mod(pkg, "observe.journal").EventJournal(node="node-a", capacity=32)
        members = {}
        for name in ("node-a", "node-b"):
            members[name] = fed.FederationMember(
                _Agent(pkg), kv.InMemoryBackend(store, name), name, heartbeat_interval=3600)
        a, b = members["node-a"], members["node-b"]
        a.on_journal = j.emit
        lbls = _mod(pkg, "labels").parse_label_array
        key = _mod(pkg, "identity.distributed").labels_to_key
        try:
            mine = a.allocate(lbls(["k8s:app=web"]))
            # what a lease expiry and a GC do to this node's keys
            a.backend.delete(a.identities._slave_key(key(lbls(["k8s:app=web"]))))
            a.backend.delete(a.identities._master_key(mine.id))
            assert a.heartbeat() == 2
            gone = b.allocate(lbls(["k8s:app=ephemeral"]))
            store.revoke_lease(b.backend.lease_id)
            assert a.run_gc() == [gone.id]
            assert a.heartbeat() == 0  # a routine renewal emits nothing
        finally:
            for mem in members.values():
                mem.close()
        got[pkg] = j.events()
    assert _bare(got[PKGS[1]]) == _bare(got[PKGS[0]])
    assert _bare(got[PKGS[1]]) == [
        ("lease_lost", "warning", {"repaired": 2}),
        ("identity_reap", "info", {"reaped": [gone.id], "count": 1})]


# -- a mixed fleet ---------------------------------------------------------------

def _wait(cond, limit: float = 10.0) -> None:
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, "the frames did not arrive"
        time.sleep(0.005)


@pytest.mark.parametrize("server_pkg", PKGS)
def test_mixed_fleet_over_one_kvstore(server_pkg):
    """A JAX node and a port node, each with its package's journal,
    publisher, sampler and NetBackend, over one ``KVStoreServer`` of
    ``server_pkg``: each merged timeline holds both nodes' events and is
    HLC-consistent; each telemetry view aggregates both nodes; every
    frame decodes to the same dict in the other package."""
    server = _mod(server_pkg, "kvstore").KVStoreServer().start()
    nodes, opened = {}, []
    before = set(_publisher_threads())
    try:
        for pkg in PKGS:
            kv, jmod = _mod(pkg, "kvstore"), _mod(pkg, "observe.journal")
            fleet = _mod(pkg, "observe.fleet")
            name = f"node-{pkg}"
            backend = kv.NetBackend(server.url, name)
            opened.append(backend.close)
            j = jmod.EventJournal(node=name, capacity=32)
            pub = jmod.JournalPublisher(j, tail_n=16)
            pub.attach_exchange(jmod.JournalExchange(backend, name, cluster="mixed"))
            sampler = fleet.FleetSampler(interval_s=1.0, capacity=8, epoch_source=lambda: 3)
            sampler.attach_exchange(fleet.TelemetryExchange(backend, name, cluster="mixed"))
            opened += [pub.stop, sampler.stop]
            nodes[pkg] = types.SimpleNamespace(j=j, pub=pub, sampler=sampler, name=name)
        for pkg in PKGS:
            n = nodes[pkg]
            n.j.emit(kind="rebuild", attrs={"basis": [1, 2, 3], "policy_epoch": 3})
            n.j.emit(kind="epoch_swap", attrs={"policy_epoch": 3, "basis": [1, 2, 3]})
            assert n.pub.publish_once()
            n.sampler.sample_once(now=100.0)
        names = {n.name for n in nodes.values()}
        for n in nodes.values():
            ex = n.pub.exchange
            _wait(lambda ex=ex: (ex.pump() or True) and set(ex.frames()) == names)
            tex = n.sampler.exchange
            _wait(lambda tex=tex: (tex.pump() or True) and set(tex.frames()) == names)
        # a second round: each folds the other's HLC before it emits
        for n in nodes.values():
            n.pub.publish_once()
            n.j.emit(kind="rebuild", attrs={"basis": [1, 2, 4], "policy_epoch": 3})
        for n in nodes.values():
            n.pub.publish_once()
        for n in nodes.values():
            ex = n.pub.exchange
            _wait(lambda ex=ex: (ex.pump() or True) and all(
                len(f["events"]) == 3 for f in ex.frames().values()))
            merged = n.pub.merged_timeline()
            assert {e["node"] for e in merged} == names and len(merged) == 6
            assert _mod(PKGS[0], "observe.journal").timeline_consistent(merged)
            assert _mod(PKGS[1], "observe.journal").timeline_consistent(merged)
            agg = _mod(PKGS[1], "observe.fleet").aggregate(n.sampler.exchange.frames())
            assert agg["nodes_reporting"] == 2 and agg["epoch_skew"] == 0
        # the frames each package encodes decode alike in the other
        for kind in ("observe.journal", "observe.fleet"):
            for n in nodes.values():
                ex = n.pub.exchange if kind == "observe.journal" else n.sampler.exchange
                for rec in dict(ex.store.shared).values():
                    dj, dt = (_mod(pkg, kind).decode_frame(rec) for pkg in PKGS)
                    assert dj == dt == rec
    finally:
        for stop in reversed(opened):
            stop()
        server.stop()
    assert not set(_publisher_threads()) - before
