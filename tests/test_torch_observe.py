"""Port parity: the span tracer on every pipeline path.

Both packages' pipelines, built over the same seeded world with the
tracer on, see the same batches; each batch's trace must carry the
same kind and the same sequence of phase names (``contracts.
TRACE_PHASES``) in both, on the first batch (the first rebuild) and on
later ones, for the v4, v6, host-CT, LB, device-CT and attributed
paths. The reference's cost contract and coverage checks
(tests/test_observe.py ``TestDisabledOverhead``, ``TestEnabledTracing``,
``TestEngineTelemetry``) run against the port, and the tracing
telemetry (``jit_shape_buckets_total{site="dispatch"}``, the h2d / d2h
``device_transfers_total`` and ``device_transfer_bytes_total``) moves
by the same amounts as the reference's on the no-CT path.
"""

from __future__ import annotations

import collections
import importlib
import time

import numpy as np
import pytest

from cilium_tpu import metrics as jmetrics
from cilium_tpu_torch import contracts as tcontracts
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.observe import NOOP_BATCH, Tracer
from cilium_tpu_torch.observe import tracer as ttracer_mod
from test_torch_harness import PKGS
from test_torch_pipeline_ct import _pack, egress_flows
from test_torch_submit import B, Pair

TORCH = PKGS[1]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _names(trace):
    return [p[0] for p in trace["phases"]]


def _run_path(path: str, monkeypatch):
    """Three batches of ``path`` through both packages with the tracer
    on → the Pair (its traces hold one trace per batch)."""
    if path == "device_ct":
        now = [50_000.25]
        monkeypatch.setattr(time, "monotonic", lambda: now[0])
    kw = {
        "v4": {}, "v6": {"deny": ("fd00::1:0/126",)}, "attribution": {},
        "host_ct": {"ct": True}, "lb": {"ct": True, "lb": True},
        "device_ct": {"device_ct_bits": 10},
    }[path]
    pr = Pair(3, depth=2, **kw)
    for p in pr.pipes.values():
        p.tracer.enable()
        if path == "attribution":
            p.set_attribution(True)
    rng = np.random.default_rng(11)
    for i in range(3):
        if path == "lb":
            stack = type("S", (), {"w": pr.w, "peers6": pr.peers6, "lb": pr.lb})()
            peer, ep, dp, proto, sp = egress_flows(stack, 4, B, 11 + i)
            hs = pr.submit(4, (_pack(peer), ep, dp, proto), ingress=False, sports=sp)
        elif path == "v6":
            hs = pr.submit(6, pr.flows(6, B, 20 + i), ingress=bool(i % 2))
        else:
            sports = None
            if path in ("host_ct", "device_ct"):
                sports = rng.integers(1024, 4096, B).astype(np.int32)
            flows = pr.flows(4, B, 40 + (i % 2))  # a repeat: CT hits on batch 3
            hs = pr.submit(4, flows, sports=sports)
        for h in hs:
            h.result()
    return pr


@pytest.mark.parametrize("path", ["v4", "v6", "host_ct", "lb", "device_ct", "attribution"])
def test_phase_sequences_match_jax(path, monkeypatch):
    pr = _run_path(path, monkeypatch)
    want = pr.j.tracer.traces()
    got = pr.t.tracer.traces()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g["kind"], g["batch"]) == (w["kind"], w["batch"])
        assert _names(g) == _names(w)
        assert set(_names(g)) <= set(tcontracts.TRACE_PHASES)
    seen = {n for t in got for n in _names(t)}
    expect = {
        "v4": {"rebuild", "prepare", "dispatch", "host_sync", "counters", "emit_events"},
        "v6": {"rebuild", "prepare", "dispatch", "host_sync", "counters", "emit_events"},
        "attribution": {"rebuild", "prepare", "dispatch", "host_sync", "counters"},
        "host_ct": {"ct_prepass", "dispatch", "host_sync", "ct_create", "counters"},
        "lb": {"lb_translate", "ct_prepass", "dispatch", "host_sync", "ct_create"},
        "device_ct": {"rebuild", "prepare", "dispatch", "host_sync", "counters"},
    }[path]
    assert expect <= seen, (path, seen)


def test_traces_end_at_completion_under_depth():
    """At depth 4, four submits in flight hold four open traces; each
    ends, in FIFO order, when its batch completes, in both packages."""
    pr = Pair(3, depth=4)
    for p in pr.pipes.values():
        p.tracer.enable()
    pend = [pr.submit(4, pr.flows(4, 128, 70 + i)) for i in range(4)]
    assert pr.t.tracer.traces() == pr.j.tracer.traces() == []
    for jh, th in pend:
        pr.equal(th.result(), jh.result())
    got, want = pr.t.tracer.traces(), pr.j.tracer.traces()
    assert [t["batch"] for t in got] == [t["batch"] for t in want] == [128] * 4
    assert [_names(t) for t in got] == [_names(t) for t in want]


# -- the reference's tests/test_observe.py, against the port --------------
def _pipeline(pkg: str = TORCH):
    """The reference test's world: one web endpoint, one lb peer, port
    80/TCP allowed."""
    api = _mod(pkg, "policy.api")
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list([
        api.rule(
            ["k8s:app=web"],
            ingress=[api.IngressRule(
                from_endpoints=(api.EndpointSelector.make(["k8s:app=lb"]),),
                to_ports=(api.PortRule(ports=(api.PortProtocol(80, "TCP"),)),),
            )],
            labels=["k8s:policy=obs"],
        ),
    ])
    labels = _mod(pkg, "labels")
    reg = _mod(pkg, "identity").IdentityRegistry()
    web = reg.allocate(labels.parse_label_array(["k8s:app=web"]))
    lb = reg.allocate(labels.parse_label_array(["k8s:app=lb"]))
    cache = _mod(pkg, "ipcache.ipcache").IPCache()
    cache.upsert("10.0.0.2/32", lb.id, source="k8s")
    dev = {} if pkg == PKGS[0] else {"device": "cpu"}
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
        _mod(pkg, "engine").PolicyEngine(repo, reg, **dev), cache,
        _mod(pkg, "ipcache.prefilter").PreFilter(), **dev)
    pipe.set_endpoints([(7, web.id)])
    return pipe


def _batch(n=8, pkg: str = TORCH):
    return (
        _mod(pkg, "ops.lpm").ip_strings_to_u32(["10.0.0.2"] * n),
        np.zeros(n, np.int32),
        np.full(n, 80),
        np.full(n, 6),
    )


class TestDisabledOverhead:
    def test_no_span_objects_when_disabled(self, monkeypatch):
        """Tracing off: a batch builds no BatchTrace and no _Span — only
        the one ``tracer.active`` read."""
        pipe = _pipeline()
        built = []

        class _Boom:
            def __init__(self, *a, **k):
                built.append(1)
                raise AssertionError("span object built while disabled")

        monkeypatch.setattr(ttracer_mod, "BatchTrace", _Boom)
        monkeypatch.setattr(ttracer_mod, "_Span", _Boom)
        assert not pipe.tracer.active
        for sports in (None, np.arange(8) + 30000):
            v, red = pipe.process(*_batch(), sports=sports)
            assert (v == 1).all()
        pipe.conntrack = _mod(TORCH, "datapath.conntrack").FlowConntrack(capacity_bits=12)
        v, _ = pipe.process(*_batch(), sports=np.arange(8) + 30000)
        assert (v == 1).all()
        assert built == []
        assert pipe.tracer.traces() == []

    def test_no_spans_after_tracing_is_turned_off(self, monkeypatch):
        """On, then off again: the next batch builds nothing."""
        pipe = _pipeline()
        pipe.tracer.enable()
        pipe.process(*_batch())
        pipe.tracer.disable()

        class _Boom:
            def __init__(self, *a, **k):
                raise AssertionError("span object built while disabled")

        monkeypatch.setattr(ttracer_mod, "BatchTrace", _Boom)
        monkeypatch.setattr(ttracer_mod, "_Span", _Boom)
        pipe.process(*_batch())
        assert len(pipe.tracer.traces()) == 1

    def test_noop_singletons_are_inert(self):
        with NOOP_BATCH.phase("anything"):
            pass
        NOOP_BATCH.mark(x=1)
        assert NOOP_BATCH.end() is None


class TestEnabledTracing:
    def test_phase_coverage_and_wall_time(self):
        pipe = _pipeline()
        pipe.tracer.enable()
        pipe.process(*_batch())
        traces = pipe.tracer.traces()
        assert len(traces) == 1
        t = traces[0]
        names = _names(t)
        assert t["kind"] == "v4-ingress" and t["batch"] == 8
        # ≥5 distinct named phases per batch
        assert len(set(names)) >= 5, names
        for expected in ("rebuild", "prepare", "dispatch", "host_sync", "counters"):
            assert expected in names
        # the phases account for the batch's wall time within 20%
        total = t["total_ns"]
        covered = sum(dur for _, _, dur in t["phases"])
        assert total > 0
        assert abs(covered - total) / total <= 0.20, (covered, total)
        rels = [rel for _, rel, _ in t["phases"]]
        assert rels == sorted(rels)
        assert all(0 <= r <= total for r in rels)

    def test_ct_path_phases(self):
        pipe = _pipeline()
        pipe.conntrack = _mod(TORCH, "datapath.conntrack").FlowConntrack(capacity_bits=12)
        pipe.tracer.enable()
        src, ep, dp, pr = _batch()
        pipe.process(src, ep, dp, pr, sports=np.arange(8, dtype=np.int64) + 30000)
        names = _names(pipe.tracer.traces()[-1])
        assert "ct_prepass" in names and "ct_create" in names

    def test_ring_is_bounded(self):
        pipe = _pipeline()
        pipe.tracer.capacity = 4
        pipe.tracer._ring = collections.deque(maxlen=4)
        pipe.tracer.enable()
        for _ in range(9):
            pipe.process(*_batch(2))
        assert len(pipe.tracer.traces()) == 4
        assert len(pipe.tracer.traces(limit=2)) == 2

    def test_given_tracer_is_used(self):
        """A tracer passed to the constructor is the pipeline's, and its
        phase histograms move on the port's registry."""
        base = _pipeline()
        tr = Tracer()
        pipe = type(base)(base.engine, base.ipcache, base.prefilter, tracer=tr, device="cpu")
        pipe.set_endpoints([(7, base._endpoints[0])])
        assert pipe.tracer is tr
        tr.enable()
        n0 = tmetrics.pipeline_phase_seconds.get_count({"phase": "dispatch"})
        b0 = tmetrics.batch_total_seconds.get_count()
        pipe.process(*_batch())
        assert tmetrics.pipeline_phase_seconds.get_count({"phase": "dispatch"}) == n0 + 1
        assert tmetrics.batch_total_seconds.get_count() == b0 + 1
        assert len(tr.traces()) == 1


class TestEngineTelemetry:
    def test_refresh_kinds_observed(self):
        full0 = tmetrics.engine_refreshes_total.get({"kind": "full"})
        pipe = _pipeline()
        pipe.process(*_batch(2))  # forces the initial full compile
        assert tmetrics.engine_refreshes_total.get({"kind": "full"}) > full0


# -- the tracing telemetry against the reference ---------------------------
def _telemetry(m) -> dict:
    out = {}
    for r in ("hit", "miss"):
        out[("shape", r)] = m.jit_shape_buckets_total.get({"site": "dispatch", "result": r})
    for d in ("h2d", "d2h"):
        out[("n", d)] = m.device_transfers_total.get({"direction": d})
        out[("bytes", d)] = m.device_transfer_bytes_total.get({"direction": d})
    return out


@pytest.mark.parametrize("attrib", [False, True])
def test_dispatch_telemetry_matches_jax(attrib):
    """The no-CT path with the tracer on: the shape hit / miss counts
    and the h2d / d2h transfer counts and bytes move as the
    reference's. Batch sizes repeat, so both see the same new shapes
    (the reference keys its unpadded no-CT launches on the exact size)."""
    pr = Pair(3, depth=1)
    for p in pr.pipes.values():
        p.tracer.enable()
        if attrib:
            p.set_attribution(True)
        p.rebuild()
    before = [_telemetry(m) for m in (jmetrics, tmetrics)]
    for i, n in enumerate((300, 300, 200, 300, 200)):
        pr.equal(*(h.result() for h in reversed(pr.submit(4, pr.flows(4, n, i)))))
    for i in range(2):
        pr.equal(*(h.result() for h in reversed(pr.submit(6, pr.flows(6, 200, 9 + i)))))
    d_j, d_t = ({k: a[k] - b[k] for k in a} for a, b in
                zip((_telemetry(jmetrics), _telemetry(tmetrics)), before))
    assert d_t == d_j
    assert (d_t[("shape", "miss")], d_t[("shape", "hit")]) == (3, 4)
    assert d_t[("n", "h2d")] == 4 * 7
    assert d_t[("bytes", "h2d")] == 16 * (2 * 300 + 300 + 2 * 200) + (16 * 4 + 12) * 400
    assert d_t[("n", "d2h")] == (6 if attrib else 3) * 7


def test_shape_cache_clears_on_attribution_and_plan_moves():
    """The reference clears its shape set on an attribution or
    placement toggle; so does the port."""
    pr = Pair(3, depth=1)
    p = pr.t
    p.tracer.enable()
    p.process(*pr.flows(4, 64, 1))
    assert p._seen_shapes
    p.set_attribution(True)
    assert not p._seen_shapes
    p.process(*pr.flows(4, 64, 1))
    p.set_sharding(True)
    assert not p._seen_shapes


@pytest.mark.parametrize("path", ["v4", "v6", "host_ct", "lb", "device_ct", "attribution"])
def test_everything_on_changes_no_result(path, monkeypatch):
    """Tracing, profiling at every batch and autotune (epoch 2) on at
    once against a port pipeline with all three off and against the
    JAX package: the same verdicts, redirects and revNAT ids, counters,
    host CT entries and device CT table, batch after batch. (With
    batches queued, the tuner's depth decides which lookups see which
    creations; tests/test_torch_autotune.py holds that case.)"""
    if path == "device_ct":
        monkeypatch.setattr(time, "monotonic", lambda: 50_000.25)
    kw = {
        "v4": {}, "v6": {"deny": ("fd00::1:0/126",)}, "attribution": {},
        "host_ct": {"ct": True}, "lb": {"ct": True, "lb": True},
        "device_ct": {"device_ct_bits": 10},
    }[path]
    on, off = Pair(5, depth=2, **kw), Pair(5, depth=2, **kw)
    on.t.tracer.enable()
    on.t.set_profiling(True, sample_every=1)
    on.t.set_autotune(True, max_depth=4, epoch=2)
    pipes = (on.j, on.t, off.t)
    if path == "attribution":
        for p in pipes:
            p.set_attribution(True)
    rng = np.random.default_rng(17)
    for i in range(6):
        kwargs = {}
        if path == "lb":
            stack = type("S", (), {"w": on.w, "peers6": on.peers6, "lb": on.lb})()
            peer, ep, dp, proto, sp = egress_flows(stack, 4, B, 30 + (i % 3))
            flows, call = (_pack(peer), ep, dp, proto), "submit"
            kwargs = {"ingress": False, "sports": sp, "return_rev_nat": True}
        elif path == "v6":
            flows, call = on.flows(6, B, 20 + (i % 3)), "submit_v6"
        else:
            flows, call = on.flows(4, B, 40 + (i % 3)), "submit"
            if path in ("host_ct", "device_ct"):
                kwargs = {"sports": rng.integers(1024, 1100, B).astype(np.int32)}
        # each batch resolved before the next: the CT entries' counts
        # then do not depend on the queue depth the tuner picks
        want, got, plain = (getattr(p, call)(*flows, **kwargs).result() for p in pipes)
        on.equal(got, want)
        on.equal(got, plain)
    on.state_equal()
    np.testing.assert_array_equal(on.t.counters, off.t.counters)
    if path == "device_ct":
        a, b = on.t._device_ct, off.t._device_ct
        for x, y in ((a.exp, b.exp), (a.kc_lo, b.kc_lo), (a.rec, b.rec)):
            assert bool((x == y).all())
    assert len(on.t.tracer.traces()) == 6
    assert len(on.t.profiler.samples()) >= 1
    assert on.t.autotune_state()["epochs_seen"] >= (0 if path == "device_ct" else 1)
