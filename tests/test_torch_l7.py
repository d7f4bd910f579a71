"""Port parity: the L7 policies, the L7 pipeline and the proxy hooks.

The same rules and requests go through the JAX package's
``HTTPPolicy`` / ``KafkaACL`` / ``L7Pipeline`` / ``Proxy`` and the
port's (on the CPU, ``device="cpu"``), with the ``L7DeviceBatch``
option off (one DFA walk per field) and on (the fused table through
the shared pipeline). Allow bits, accept masks, access-log records and
the pipeline's metric deltas must be equal.
"""

from __future__ import annotations

import random
import struct

import numpy as np
import pytest
import torch

import cilium_tpu.datapath.l7_pipeline as jl7rt
import cilium_tpu.l7 as jl7
import cilium_tpu.metrics as jmetrics
import cilium_tpu.ops.dfa as jdfa
import cilium_tpu.policy.api as japi
import cilium_tpu.proxy as jproxy
import cilium_tpu_torch.datapath.l7_pipeline as tl7rt
import cilium_tpu_torch.l7 as tl7
import cilium_tpu_torch.metrics as tmetrics
import cilium_tpu_torch.ops.dfa as tdfa
import cilium_tpu_torch.policy.api as tapi
import cilium_tpu_torch.proxy as tproxy
from cilium_tpu_torch.l7 import kafka_wire as twire
from cilium_tpu_torch.observe import DeviceProfiler, Tracer

JAX = dict(rt=jl7rt, l7=jl7, dfa=jdfa, api=japi, proxy=jproxy, metrics=jmetrics, kw={})
TORCH = dict(rt=tl7rt, l7=tl7, dfa=tdfa, api=tapi, proxy=tproxy, metrics=tmetrics,
             kw={"device": "cpu"})
SIDES = (JAX, TORCH)


@pytest.fixture(autouse=True)
def _reset_l7_runtime():
    for side in SIDES:
        side["rt"]._reset_for_tests()
        side["dfa"]._reset_intern_for_tests()
    yield
    for side in SIDES:
        side["rt"]._reset_for_tests()
        side["dfa"]._reset_intern_for_tests()


def _option(on: bool) -> None:
    for side in SIDES:
        side["rt"].set_device_batch(on, **side["kw"])


HTTP_RULES = [
    (dict(method="GET|POST", path="/api/v[0-9]+/[a-z]*"), None),
    (dict(path="/bad/(?:zz)+x"), None),  # demoted to host re (syntax the DFA compiler refuses)
    (dict(method="PUT", path="/obj/[a-f0-9]+", host="svc[.]local"), None),
    (dict(method="GET", path="/health"), {17}),
    (dict(path="/svc[0-9]/upload", host="internal[.]corp"), {17, 21}),
    (dict(method="DELETE"), {99}),
]


def _http_policy(side, rules=HTTP_RULES):
    api = side["api"]
    return side["l7"].HTTPPolicy(
        [(api.HTTPRule(**r), ids) for r, ids in rules], **side["kw"]
    )


def _http_requests(side, n: int, seed: int):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        out.append(side["l7"].HTTPRequest(
            method=rng.choice(["GET", "POST", "PUT", "HEAD", "DELETE"]),
            path=rng.choice([
                f"/api/v{i % 7}/obj", "/bad/zzzzx", "/bad/zzzx", f"/obj/{i % 16:x}",
                "/nope", "/health", f"/svc{i % 10}/upload", "/api/v1/" + "a" * 300,  # overlong: host walk
                "/" + "b" * 200,
            ]),
            host=rng.choice(["svc.local", "svcxlocal", "internal.corp", ""]),
            src_identity=rng.choice([17, 21, 99, 5]),
        ))
    return out


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_http_check_batch_matches_jax(seed, on):
    _option(on)
    got = []
    for side in SIDES:
        pol = _http_policy(side)
        assert pol._paths.host_pids  # the demotion happened
        assert (pol._fused_table is not None) == on
        got.append(pol.check_batch(_http_requests(side, 150, seed)))
        got.append(pol.check_batch(_http_requests(side, 20, seed)))  # below the device floor
    np.testing.assert_array_equal(got[2], got[0])
    np.testing.assert_array_equal(got[3], got[1])
    assert got[0].any() and not got[0].all()
    reqs = _http_requests(TORCH, 150, seed)
    want = [any(tapi.HTTPRule(**r).matches(q.method, q.path, q.host)
                and (ids is None or q.src_identity in ids) for r, ids in HTTP_RULES)
            for q in reqs]
    np.testing.assert_array_equal(got[2], want)


def test_http_option_flip_keeps_the_same_policy_exact():
    pols = [_http_policy(side) for side in SIDES]
    reqs = [_http_requests(side, 120, 5) for side in SIDES]
    off = pols[1].check_batch(reqs[1])
    _option(True)
    on = [p.check_batch(r) for p, r in zip(pols, reqs)]
    assert pols[1]._fused_table is not None
    np.testing.assert_array_equal(on[1], off)
    np.testing.assert_array_equal(on[1], on[0])
    _option(False)
    np.testing.assert_array_equal(pols[1].check_batch(reqs[1]), off)


def test_more_than_64_patterns_fail_loudly():
    for side in SIDES:
        rules = [(dict(path=f"/p{i}"), None) for i in range(65)]
        with pytest.raises(ValueError, match="64"):
            _http_policy(side, rules)


def test_http_rules_model_round_trip():
    pol = _http_policy(TORCH)
    again = tl7.HTTPPolicy.from_model(pol.rules_model(), device="cpu")
    assert again.rules_model() == pol.rules_model() == _http_policy(JAX).rules_model()
    reqs = _http_requests(TORCH, 60, 1)
    np.testing.assert_array_equal(again.check_batch(reqs), pol.check_batch(reqs))


KAFKA_RULES = [
    (dict(api_key="fetch", topic="orders"), None),
    (dict(role="produce", topic="audit", client_id="svc-a"), {17, 21}),
    (dict(topic="metrics"), None),
    (dict(role="consume", topic="t3"), {99}),
    (dict(api_key="produce", api_version="2", topic="abc"), None),
]


def _acl(side, rules=KAFKA_RULES):
    api = side["api"]
    return side["l7"].KafkaACL([(api.KafkaRule(**r), ids) for r, ids in rules], **side["kw"])


def _kafka_requests(side, n: int, seed: int):
    rng = random.Random(seed)
    return [side["l7"].KafkaRequest(
        api_key=rng.choice([0, 1, 2, 19, 36]),
        api_version=rng.choice([0, 2, 3]),
        client_id=rng.choice(["svc-a", "svc-b", "", "x" * 200]),
        topic=rng.choice(["orders", "audit", "metrics", "t3", "abc", "ab", "unknown", "",
                          "t" * 150]),
        src_identity=rng.choice([17, 21, 99]),
    ) for _ in range(n)]


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_kafka_check_batch_matches_jax(seed, on):
    _option(on)
    got = []
    for side in SIDES:
        acl = _acl(side)
        assert (acl._fused_table is not None) == on
        got.append(acl.check_batch(_kafka_requests(side, 160, seed)))
    np.testing.assert_array_equal(got[1], got[0])
    assert got[1].any() and not got[1].all()
    if on:
        # the literal caps are odd (7 and 5: each walk ends on a half pair)
        assert [c for _, c in _acl(TORCH)._fused_fields] == [7, 5]
        assert _acl(TORCH)._fused_table.has_pair


def test_kafka_device_ids_match_dict_path():
    _option(True)
    for side in SIDES:
        acl = _acl(side, [(dict(topic=f"topic-{i}"), None) for i in range(10)])
        reqs = [side["l7"].KafkaRequest(api_key=1, topic=f"topic-{i % 12}") for i in range(64)]
        assert acl._device_ids(reqs)["topic"].tolist() == [
            acl._topic_ids.get(r.topic, -2) for r in reqs]


def test_kafka_over_64_literals_use_the_dict_path():
    _option(True)
    rules = [(dict(topic=f"t{i}"), None) for i in range(70)]
    for side in SIDES:
        acl = _acl(side, rules)
        assert acl._fused_table is None
        reqs = [side["l7"].KafkaRequest(api_key=1, topic="t3")] * 40
        assert acl.check_batch(reqs).all()


def test_off_path_never_reaches_the_fused_or_pair_walks(monkeypatch):
    """With L7DeviceBatch off the policies walk one field at a time
    (dfa_match_batch): the fused and pair walks are never called and
    no fused table is built. On the card, chip_smoke.py holds the same
    with the kernels' launch counts."""
    calls = []
    for name in ("dfa_match_batch_fused", "dfa_match_batch_pair"):
        monkeypatch.setattr(tl7rt, name, lambda *a, _n=name, **k: calls.append(_n))
    single = []
    real = tdfa.dfa_match_batch
    monkeypatch.setattr(tdfa, "dfa_match_batch", lambda *a, **k: single.append(1) or real(*a, **k))
    pol = _http_policy(TORCH)
    assert pol._fused_table is None
    pol.check_batch(_http_requests(TORCH, 200, 3))
    acl = _acl(TORCH)
    assert acl._fused_table is None
    acl.check_batch(_kafka_requests(TORCH, 64, 3))
    assert calls == [] and single


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _metric_snapshot(metrics):
    snap = {}
    for res in ("warm", "miss", "hit"):
        snap[("shape", res)] = metrics.jit_shape_buckets_total.get({"site": "l7", "result": res})
    for kind in ("lane", "lane_live", "len_bytes", "len_bytes_live"):
        snap[("pad", kind)] = metrics.l7_pad_lanes_total.get({"kind": kind})
    for parser in ("http", "kafka"):
        snap[("batches", parser)] = metrics.l7_batches_total.get({"parser": parser})
    return snap


def _tables(patterns_per_field, pair: bool = True):
    out = []
    for side in SIDES:
        rc = side["l7"].regex_compile
        fused = side["dfa"].fuse_dfas([rc.compile_patterns(p) for p in patterns_per_field],
                                      pair_cap_elems=tdfa.PAIR_TABLE_CAP_ELEMS if pair else 0)
        out.append(side["dfa"].DeviceDFATable(("pl", pair), fused, **side["kw"]))
    return out


@pytest.mark.parametrize("pair", [True, False])
def test_pipeline_masks_and_counters_match_jax(pair):
    """prewarm's count, the per-field masks of submits of several sizes
    (pad lanes, a 16 384-row chunk plus a tail, a field cap of 3 under
    the rung), and every shape / pad-lane / batch counter delta."""
    fields = [["GET", "POST", "PU."], ["/a.*", "/b[0-9]+", "x*"]]
    rng = random.Random(9)
    batches = []
    for n in (5, 600, 9000):
        batches.append([
            [rng.choice([b"GET", b"POST", b"PUT", b"PUTS", b""]) for _ in range(n)],
            [rng.choice([b"/a", b"/b12", b"xxx", b"/a" + b"z" * 40, b"/c"]) for _ in range(n)],
        ])
    deltas, results, warmed = [], [], []
    for side, table in zip(SIDES, _tables(fields, pair)):
        assert table.has_pair == pair
        before = _metric_snapshot(side["metrics"])
        pipe = side["rt"].L7Pipeline(depth=2, **side["kw"])
        warmed.append(pipe.prewarm(table, [3, 64]))
        pending = [pipe.submit(table, [(b[0], 3), (b[1], 64)], parser=p)
                   for b, p in zip(batches, ("http", "kafka", "http"))]
        results.append([[m.tolist() for m in p.result()] for p in pending])
        after = _metric_snapshot(side["metrics"])
        deltas.append({k: after[k] - before[k] for k in after})
        assert pipe._seen_shapes
    assert warmed[0] == warmed[1] == 3 * 3 + 0
    assert results[1] == results[0]
    assert deltas[1] == deltas[0]
    assert deltas[1][("pad", "lane")] > 0 and deltas[1][("shape", "hit")] > 0


def test_pipeline_fifo_depth_and_out_of_order_result():
    for side, table in zip(SIDES, _tables([["/a.*", "/b.*"]])):
        pipe = side["rt"].L7Pipeline(depth=2, **side["kw"])
        pending = [pipe.submit(table, [([b"/a1", b"/b2", b"/c3"], 16)]) for _ in range(5)]
        assert sum(p._done for p in pending) >= 3  # depth 2 retires the oldest
        assert all(p.result()[0].tolist() == [1, 2, 0] for p in pending)
        pipe = side["rt"].L7Pipeline(depth=4, **side["kw"])
        p1 = pipe.submit(table, [([b"/a"], 16)])
        p2 = pipe.submit(table, [([b"/b"], 16)])
        assert p2.result()[0].tolist() == [2]
        assert p1._done and p1.result()[0].tolist() == [1]
        (mask,) = pipe.submit(table, [([], 16)]).result()
        assert mask.shape == (0,)


def test_pipeline_reraises_an_error_stored_at_completion(monkeypatch):
    table = _tables([["/a.*"]])[1]
    pipe = tl7rt.L7Pipeline(depth=4, device="cpu")
    p1 = pipe.submit(table, [([b"/a"], 16)])
    real = tl7rt.masks_u64
    monkeypatch.setattr(tl7rt, "masks_u64", lambda *a: (_ for _ in ()).throw(RuntimeError("pull")))
    p2 = pipe.submit(table, [([b"/a"], 16)])
    with pytest.raises(RuntimeError, match="pull"):
        p2.result()  # completes p1 too, which fails the same way
    with pytest.raises(RuntimeError, match="pull"):
        p1.result()
    monkeypatch.setattr(tl7rt, "masks_u64", real)
    assert pipe.submit(table, [([b"/a"], 16)]).result()[0].tolist() == [1]


def test_pipeline_traces_its_phases():
    table = _tables([["/a.*"]])[1]
    tracer = Tracer()
    tracer.enable()
    pipe = tl7rt.L7Pipeline(depth=1, tracer=tracer, device="cpu")
    pipe.submit(table, [([b"/a"] * 40, 16)]).result()
    (trace,) = tracer.traces()
    assert trace["kind"] == "l7" and trace["batch"] == 40
    assert [p[0] for p in trace["phases"]] == ["prepare", "dispatch", "host_sync"]


def test_gate_follows_the_device_and_drains_on_off():
    tl7rt.set_device_batch(True, device="cpu")
    pipe = tl7rt.shared_pipeline()
    assert pipe is not None and pipe.device.type == "cpu" and tl7rt.device_batch_enabled()
    tl7rt.set_device_batch(True, device=torch.device("cpu"))
    assert tl7rt.shared_pipeline() is pipe
    prof = DeviceProfiler()
    tl7rt.set_profiler(prof)
    assert pipe.profiler is prof
    table = _tables([["/a"]])[1]
    pending = pipe.submit(table, [([b"/a"], 16)])
    tl7rt.set_device_batch(False)
    assert not tl7rt.device_batch_enabled() and tl7rt.shared_pipeline() is None
    assert pending.result()[0].tolist() == [1]  # drained, not dropped
    assert tl7rt.lane_rung(1) == jl7rt.lane_rung(1)
    assert tl7rt.L7_LANE_RUNGS == jl7rt.L7_LANE_RUNGS
    from cilium_tpu_torch.option import OPTION_SPECS

    assert "L7DeviceBatch" in OPTION_SPECS


# ---------------------------------------------------------------------------
# the proxy hooks
# ---------------------------------------------------------------------------


def _log(proxy):
    return [
        {k: v for k, v in r.to_dict().items() if k != "timestamp"}
        for r in proxy.accesslog.recent(10_000)
    ]


@pytest.mark.parametrize("on", [False, True])
def test_proxy_check_http_and_check_kafka_match_jax(on):
    _option(on)
    out = []
    for side in SIDES:
        proxy = side["proxy"].Proxy()
        rh = proxy.create_or_update_redirect(7, 80, "http", http_policy=_http_policy(side))
        rk = proxy.create_or_update_redirect(7, 9092, "kafka", kafka_acl=_acl(side))
        open_ = proxy.create_or_update_redirect(8, 80, "http")
        allows = [
            list(proxy.check_http(rh, _http_requests(side, 90, 2))),
            list(proxy.check_kafka(rk, _kafka_requests(side, 70, 2))),
            list(proxy.check_http(open_, _http_requests(side, 3, 2))),
        ]
        out.append((allows, _log(proxy), rh.proxy_port, rk.key))
    assert out[1] == out[0]
    assert len(out[1][1]) == 163 and {r["verdict"] for r in out[1][1]} == {"Forwarded", "Denied"}


def _produce_frame(client: str, topics, cid: int = 7, version: int = 0) -> bytes:
    """A Kafka produce request frame, built with the port's wire
    module's constants and string encoder."""
    body = struct.pack(">hhi", twire.API_PRODUCE, version, cid) + twire._w_str(client)
    body += struct.pack(">hi", 1, 30000) + struct.pack(">i", len(topics))
    for t in topics:
        body += twire._w_str(t) + struct.pack(">i", 1)
        body += struct.pack(">ii", 0, 10) + b"\x00" * 10
    return struct.pack(">i", len(body)) + body


@pytest.mark.parametrize("on", [False, True])
def test_proxy_handle_kafka_bytes_matches_jax(on):
    _option(on)
    frames = [
        _produce_frame("svc-a", ["audit"]),  # allowed for 17 / 21 only
        _produce_frame("svc-b", ["audit", "metrics"]),  # audit denied for svc-b
        _produce_frame("c", ["metrics", "metrics"]),
        _produce_frame("c", ["nope"]),
        b"\x00\x00\x00\x02\x00",  # unparseable: dropped
    ]
    out = []
    for side in SIDES:
        proxy = side["proxy"].Proxy()
        r = proxy.create_or_update_redirect(3, 9092, "kafka", kafka_acl=_acl(side))
        res = [proxy.handle_kafka_bytes(r, f, src_identity=ident)
               for f in frames for ident in (17, 99)]
        out.append((res, _log(proxy)))
    assert out[1] == out[0]
    fwd = [f for f, _ in out[1][0]]
    assert fwd[:2] == [True, False] and fwd[4:6] == [True, True] and not any(fwd[6:])
    assert out[1][0][-1] == (False, b"")
