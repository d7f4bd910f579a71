"""Port parity: the native C++ enforcer fed from the port's tables.

``cilium_tpu_torch.native`` compiles the reference's ``fastpath.cpp``
(a byte-identical copy) with ``g++`` and loads it with ``ctypes``; its
tables come from the port's pipeline. The reference's own tests
(``test_native.py``: ``TestParity``, ``TestConntrack``,
``TestLBParity``, ``TestNativeL7``, the concurrent reload,
``TestReload`` and ``TestLoader``) run here against the port on the
CPU; ``test_multithread_throughput_scales`` is left out, as a machine
under load cannot show it. Then the same worlds (``build_world``) go
through both packages: the port's ``NativeFastpath.from_pipeline``
must give the JAX package's verdicts, redirects and counters, and the
LB arrays it loads must equal the JAX ``build_device()`` arrays.
"""

from __future__ import annotations

import importlib
import ipaddress

import numpy as np
import pytest
import torch

from cilium_tpu_torch.datapath.pipeline import (
    DROP_NO_SERVICE,
    DROP_POLICY,
    DROP_PREFILTER,
    FORWARD,
    DatapathPipeline,
)
from cilium_tpu_torch.engine import PolicyEngine
from cilium_tpu_torch.identity import IdentityRegistry
from cilium_tpu_torch.ipcache.ipcache import IPCache
from cilium_tpu_torch.ipcache.prefilter import PreFilter
from cilium_tpu_torch.labels import parse_label_array
from cilium_tpu_torch.native import NativeFastpath, native_available
from cilium_tpu_torch.ops.lpm import ip_strings_to_u32, ipv6_to_bytes
from cilium_tpu_torch.policy.api import (
    EgressRule,
    EndpointSelector,
    IngressRule,
    PortProtocol,
    PortRule,
    rule,
)
from cilium_tpu_torch.policy.repository import Repository
from test_torch_harness import PKGS, build_world, random_flows

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native toolchain unavailable"
)

CPU = {"device": "cpu"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg: str) -> dict:
    return CPU if pkg == "cilium_tpu_torch" else {}


def _world():
    repo = Repository()
    repo.add_list([
        rule(
            ["k8s:app=web"],
            ingress=[IngressRule(
                from_endpoints=(EndpointSelector.make(["k8s:app=lb"]),),
                to_ports=(PortRule(ports=(PortProtocol(80, "TCP"),)),),
            )],
            egress=[EgressRule(
                to_endpoints=(EndpointSelector.make(["k8s:app=db"]),),
                to_ports=(PortRule(ports=(PortProtocol(5432, "TCP"),)),),
            )],
            labels=["k8s:policy=n0"],
        ),
        rule(
            ["k8s:app=db"],
            ingress=[IngressRule(
                from_endpoints=(EndpointSelector.make(["k8s:app=web"]),),
            )],
            labels=["k8s:policy=n1"],
        ),
    ])
    reg = IdentityRegistry()
    web = reg.allocate(parse_label_array(["k8s:app=web"]))
    lb = reg.allocate(parse_label_array(["k8s:app=lb"]))
    db = reg.allocate(parse_label_array(["k8s:app=db"]))
    other = reg.allocate(parse_label_array(["k8s:app=other"]))
    cache = IPCache()
    cache.upsert("10.0.0.2/32", lb.id, source="k8s")
    cache.upsert("10.0.0.3/32", db.id, source="k8s")
    cache.upsert("10.0.0.4/32", other.id, source="k8s")
    cache.upsert("10.1.0.0/16", lb.id, source="k8s")  # broader prefix
    cache.upsert("fd00::2/128", lb.id, source="k8s")
    pf = PreFilter()
    pf.insert(pf.revision, ["192.0.2.0/24", "2001:db8::/32"])
    pipe = DatapathPipeline(PolicyEngine(repo, reg, device="cpu"), cache, pf, device="cpu")
    pipe.set_endpoints([web.id, db.id])
    return pipe, dict(web=web, lb=lb, db=db, other=other)


def _random_flows(n, seed=0):
    rng = np.random.default_rng(seed)
    pool = ip_strings_to_u32([
        "10.0.0.2", "10.0.0.3", "10.0.0.4", "10.1.7.9", "192.0.2.55",
        "8.8.8.8",
    ])
    ips = pool[rng.integers(0, len(pool), n)].astype(np.uint32)
    eps = rng.integers(0, 2, n).astype(np.int32)
    dports = rng.choice([80, 443, 5432, 53], n).astype(np.int32)
    protos = rng.choice([6, 17], n).astype(np.int32)
    return ips, eps, dports, protos


# -- the reference's tests, run against the port -----------------------


class TestParity:
    def test_ingress_parity(self):
        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=0)
        ips, eps, dports, protos = _random_flows(512)
        pv, pr = pipe.process(ips, eps, dports, protos, ingress=True)
        nv, nr = nf.process(ips, eps, dports, protos, ingress=True)
        assert np.array_equal(pv, nv)
        assert np.array_equal(pr, nr)
        assert {FORWARD, DROP_POLICY, DROP_PREFILTER} <= set(pv.tolist())

    def test_egress_parity(self):
        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=0)
        ips, eps, dports, protos = _random_flows(512, seed=1)
        pv, pr = pipe.process(ips, eps, dports, protos, ingress=False)
        nv, nr = nf.process(ips, eps, dports, protos, ingress=False)
        assert np.array_equal(pv, nv) and np.array_equal(pr, nr)

    def test_v6_parity(self):
        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=0)
        peers = ipv6_to_bytes(["fd00::2", "2001:db8::9", "fd00::99"] * 10).astype(np.int32)
        n = peers.shape[0]
        eps = np.zeros(n, np.int32)
        dports = np.full(n, 80, np.int32)
        protos = np.full(n, 6, np.int32)
        pv, _ = pipe.process_v6(peers, eps, dports, protos, ingress=True)
        nv, _ = nf.process_v6(peers, eps, dports, protos, ingress=True)
        assert np.array_equal(pv, nv)
        assert set(pv.tolist()) == {FORWARD, DROP_PREFILTER, DROP_POLICY}


class TestConntrack:
    def test_established_bypass_and_counters(self):
        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=12)
        ips = ip_strings_to_u32(["10.0.0.2"])
        args = (ips, np.zeros(1, np.int32), np.array([80], np.int32), np.array([6], np.int32))
        v1, _ = nf.process(*args, sports=np.array([5555]))
        v2, _ = nf.process(*args, sports=np.array([5555]))
        assert v1.tolist() == [FORWARD] and v2.tolist() == [FORWARD]
        assert nf.counters[0, 0] == 2
        nf.ct_flush()
        v3, _ = nf.process(*args, sports=np.array([5555]))
        assert v3.tolist() == [FORWARD]

    def test_reply_direction_bypass_parity(self):
        """A reply of an established egress flow hits the CT through the
        flipped tuple in both the port's pipeline and native."""
        from cilium_tpu_torch.datapath.conntrack import FlowConntrack

        pipe, _ids = _world()
        pipe.conntrack = FlowConntrack(capacity_bits=12)
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=12)
        db_ip = ip_strings_to_u32(["10.0.0.3"])
        eg = (db_ip, np.zeros(1, np.int32), np.array([5432], np.int32), np.array([6], np.int32))
        pv, _ = pipe.process(*eg, ingress=False, sports=np.array([40000]))
        nv, _ = nf.process(*eg, ingress=False, sports=np.array([40000]))
        assert pv.tolist() == [FORWARD] and nv.tolist() == [FORWARD]
        rep = (db_ip, np.zeros(1, np.int32), np.array([40000], np.int32), np.array([6], np.int32))
        pv, _ = pipe.process(*rep, ingress=True, sports=np.array([5432]))
        nv, _ = nf.process(*rep, ingress=True, sports=np.array([5432]))
        assert pv.tolist() == [FORWARD]
        assert nv.tolist() == [FORWARD]
        pipe.conntrack.flush()
        nf.ct_flush()
        pv, _ = pipe.process(*rep, ingress=True, sports=np.array([5432]))
        nv, _ = nf.process(*rep, ingress=True, sports=np.array([5432]))
        assert pv.tolist() == nv.tolist() == [DROP_POLICY]

    def test_denied_flow_never_cached(self):
        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=12)
        ips = ip_strings_to_u32(["10.0.0.4"])
        args = (ips, np.zeros(1, np.int32), np.array([80], np.int32), np.array([6], np.int32))
        for _ in range(3):
            v, _ = nf.process(*args, sports=np.array([6666]))
            assert v.tolist() == [DROP_POLICY]
        assert nf.counters[0, 1] == 3


def _lb_world(pkg: str):
    """The reference's LB world through ``pkg``: one weighted v4 service
    and one with no backend."""
    api, lb = _mod(pkg, "policy.api"), _mod(pkg, "lb")
    kw = _kw(pkg)
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list([
        api.rule(
            ["k8s:app=web"],
            egress=[api.EgressRule(
                to_endpoints=(api.EndpointSelector.make(["k8s:app=db"]),),
                to_ports=(api.PortRule(ports=(api.PortProtocol(8080, "TCP"),)),),
            )],
            labels=["k8s:policy=nlb"],
        ),
    ])
    reg = _mod(pkg, "identity").IdentityRegistry()
    labels = _mod(pkg, "labels")
    web = reg.allocate(labels.parse_label_array(["k8s:app=web"]))
    db = reg.allocate(labels.parse_label_array(["k8s:app=db"]))
    other = reg.allocate(labels.parse_label_array(["k8s:app=other"]))
    cache = _mod(pkg, "ipcache.ipcache").IPCache()
    cache.upsert("10.0.0.3/32", db.id, source="k8s")
    cache.upsert("10.0.0.4/32", db.id, source="k8s")
    cache.upsert("10.0.0.9/32", other.id, source="k8s")
    lbm = lb.ServiceManager()
    lbm.upsert(lb.L3n4Addr("10.96.0.10", 80, "TCP"),
               [lb.Backend("10.0.0.3", 8080, weight=1), lb.Backend("10.0.0.4", 8080, weight=3)])
    lbm.upsert(lb.L3n4Addr("10.96.0.99", 53, "UDP"), [])  # no backends
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
        _mod(pkg, "engine").PolicyEngine(repo, reg, **kw), cache,
        _mod(pkg, "ipcache.prefilter").PreFilter(), lb=lbm, **kw)
    pipe.set_endpoints([(7, web.id)])
    return pipe, lbm


def _lb_world6(pkg: str):
    """The reference's v6 LB world through ``pkg``."""
    api, lb = _mod(pkg, "policy.api"), _mod(pkg, "lb")
    kw = _kw(pkg)
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list([
        api.rule(
            ["k8s:app=web"],
            egress=[api.EgressRule(
                to_endpoints=(api.EndpointSelector.make(["k8s:app=db"]),),
                to_ports=(api.PortRule(ports=(api.PortProtocol(8080, "TCP"),)),),
            )],
            labels=["k8s:policy=nlb6"],
        ),
    ])
    reg = _mod(pkg, "identity").IdentityRegistry()
    labels = _mod(pkg, "labels")
    web = reg.allocate(labels.parse_label_array(["k8s:app=web"]))
    db = reg.allocate(labels.parse_label_array(["k8s:app=db"]))
    cache = _mod(pkg, "ipcache.ipcache").IPCache()
    cache.upsert("fd00::3/128", db.id, source="k8s")
    cache.upsert("fd00::4/128", db.id, source="k8s")
    lbm = lb.ServiceManager()
    lbm.upsert(lb.L3n4Addr("fd00:96::10", 80, "TCP"),
               [lb.Backend("fd00::3", 8080, weight=1), lb.Backend("fd00::4", 8080, weight=2)])
    lbm.upsert(lb.L3n4Addr("fd00:96::99", 53, "UDP"), [])  # no backends
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
        _mod(pkg, "engine").PolicyEngine(repo, reg, **kw), cache,
        _mod(pkg, "ipcache.prefilter").PreFilter(), lb=lbm, **kw)
    pipe.set_endpoints([(7, web.id)])
    return pipe, lbm


def _lb_flows(seed: int = 5, n: int = 512):
    rng = np.random.default_rng(seed)
    pool = ip_strings_to_u32(["10.96.0.10", "10.96.0.99", "10.0.0.3", "10.0.0.9", "8.8.8.8"])
    ips = pool[rng.integers(0, len(pool), n)].astype(np.uint32)
    dports = rng.choice(np.array([80, 53, 8080], np.int32), n)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return ips, np.zeros(n, np.int32), dports, protos


def _lb_flows6(seed: int = 9, n: int = 256):
    rng = np.random.default_rng(seed)
    pool = ipv6_to_bytes(["fd00:96::10", "fd00:96::99", "fd00::3", "8::8"]).astype(np.int32)
    peers = pool[rng.integers(0, pool.shape[0], n)]
    dports = rng.choice(np.array([80, 53, 8080], np.int32), n)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return peers, np.zeros(n, np.int32), dports, protos


class TestLBParity:
    def test_vip_translation_parity(self):
        """Native's LB stage picks the port pipeline's backends flow for
        flow, the weighted spread included."""
        pipe, _lbm = _lb_world("cilium_tpu_torch")
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=0)
        flows = _lb_flows()
        pv, pr = pipe.process(*flows, ingress=False)
        nv, nr = nf.process(*flows, ingress=False)
        assert np.array_equal(pv, nv) and np.array_equal(pr, nr)
        assert {FORWARD, DROP_POLICY, DROP_NO_SERVICE} <= set(pv.tolist())

    def test_lb_reload_flushes_ct_and_retranslates(self):
        from cilium_tpu_torch.lb import Backend, L3n4Addr

        pipe, lbm = _lb_world("cilium_tpu_torch")
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=12)
        ips = ip_strings_to_u32(["10.96.0.10"])
        args = (ips, np.zeros(1, np.int32), np.array([80], np.int32), np.array([6], np.int32))
        v1, _ = nf.process(*args, ingress=False, sports=np.array([4242]))
        assert v1.tolist() == [FORWARD]
        lbm.upsert(L3n4Addr("10.96.0.10", 80, "TCP"), [Backend("10.0.0.9", 8080)])
        nf.load_lb(lbm)
        v2, _ = nf.process(*args, ingress=False, sports=np.array([4242]))
        assert v2.tolist() == [DROP_POLICY]

    def test_v6_vip_translation_parity(self):
        pipe, _lbm = _lb_world6("cilium_tpu_torch")
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=0)
        flows = _lb_flows6()
        pv, pr = pipe.process_v6(*flows, ingress=False)
        nv, nr = nf.process_v6(*flows, ingress=False)
        assert np.array_equal(pv, nv) and np.array_equal(pr, nr)
        assert {FORWARD, DROP_POLICY, DROP_NO_SERVICE} <= set(pv.tolist())


class TestNativeL7:
    def _http_world(self):
        from cilium_tpu_torch.l7.http_policy import HTTPPolicy
        from cilium_tpu_torch.policy.api import HTTPRule

        pol = HTTPPolicy([
            (HTTPRule(method="GET", path="/api/v[0-9]+/.*"), {101, 102}),
            (HTTPRule(path="/public/.*"), None),
            (HTTPRule(method="PUT", host="admin[.]svc"), {101}),
        ], device="cpu")
        nf = NativeFastpath(ep_count=1, ct_bits=0)
        nf.load_l7_http(7, 80, pol)
        return pol, nf

    def test_http_parity_random(self):
        from cilium_tpu_torch.l7.http_policy import HTTPRequest

        pol, nf = self._http_world()
        rng = np.random.default_rng(3)
        methods = ["GET", "PUT", "POST"]
        paths = ["/api/v1/x", "/api/vx/x", "/public/a", "/secret", ""]
        hosts = ["admin.svc", "adminxsvc", "other", ""]
        reqs = [
            HTTPRequest(
                method=methods[rng.integers(0, 3)],
                path=paths[rng.integers(0, 5)],
                host=hosts[rng.integers(0, 4)],
                src_identity=int(rng.choice([101, 102, 999])),
            )
            for _ in range(256)
        ]
        py = pol.check_batch(reqs)
        nat = nf.check_http_batch(7, 80, reqs)
        assert np.array_equal(py, nat)
        assert py.any() and not py.all()

    def test_http_unsupported_policies_refused(self):
        from cilium_tpu_torch.l7.http_policy import HTTPPolicy, NativeL7Unsupported
        from cilium_tpu_torch.policy.api import HTTPRule

        pol = HTTPPolicy([(HTTPRule(path="/x", headers=("X-Token: s",)), None)], device="cpu")
        nf = NativeFastpath(ep_count=1, ct_bits=0)
        with pytest.raises(NativeL7Unsupported):
            nf.load_l7_http(7, 80, pol)

    def test_kafka_parity_random(self):
        from cilium_tpu_torch.l7.kafka_policy import KafkaACL, KafkaRequest
        from cilium_tpu_torch.policy.api import KafkaRule

        acl = KafkaACL([
            (KafkaRule(role="produce", topic="orders"), {101}),
            (KafkaRule(topic="logs"), None),
            (KafkaRule(role="consume", client_id="reader"), {102}),
            (KafkaRule(api_key="metadata"), None),
        ], device="cpu")
        nf = NativeFastpath(ep_count=1, ct_bits=0)
        nf.load_l7_kafka(7, 9092, acl)
        rng = np.random.default_rng(5)
        topics = ["orders", "logs", "secret", ""]
        clients = ["reader", "writer", ""]
        reqs = [
            KafkaRequest(
                api_key=int(rng.integers(0, 20)),
                api_version=int(rng.integers(0, 3)),
                client_id=clients[rng.integers(0, 3)],
                topic=topics[rng.integers(0, 4)],
                src_identity=int(rng.choice([101, 102, 999])),
            )
            for _ in range(512)
        ]
        py = acl.check_batch(reqs)
        nat = nf.check_kafka_batch(7, 9092, reqs)
        assert np.array_equal(py, nat)
        assert py.any() and not py.all()

    def test_l7_policy_swap_is_live(self):
        from cilium_tpu_torch.l7.http_policy import HTTPPolicy, HTTPRequest
        from cilium_tpu_torch.policy.api import HTTPRule

        nf = NativeFastpath(ep_count=1, ct_bits=0)
        nf.load_l7_http(7, 80, HTTPPolicy([(HTTPRule(path="/a"), None)], device="cpu"))
        req = [HTTPRequest("GET", "/b")]
        assert not nf.check_http_batch(7, 80, req)[0]
        nf.load_l7_http(7, 80, HTTPPolicy([(HTTPRule(path="/b"), None)], device="cpu"))
        assert nf.check_http_batch(7, 80, req)[0]


class TestConcurrency:
    def test_parallel_eval_with_concurrent_reload(self):
        """Eval threads racing a loader thread: every verdict is one of
        a published snapshot's, never a torn mix."""
        import threading

        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=12)
        ips, eps, dports, protos = _random_flows(2048, seed=7)
        sports = np.random.default_rng(0).integers(1024, 60000, 2048).astype(np.int32)
        expect, _ = nf.process(ips, eps, dports, protos)
        stop = threading.Event()
        errors = []

        def evaluator():
            while not stop.is_set():
                v, _r = nf.process(ips, eps, dports, protos, sports=sports)
                if not np.array_equal(v, expect):
                    errors.append("verdict mismatch under reload")
                    return

        def reloader():
            for _ in range(20):
                nf.load_ipcache(pipe.ipcache)

        threads = [threading.Thread(target=evaluator) for _ in range(4)]
        for t in threads:
            t.start()
        rel = threading.Thread(target=reloader)
        rel.start()
        rel.join()
        stop.set()
        for t in threads:
            t.join()
        assert not errors, errors


class TestReload:
    def test_policy_reload_flushes_conntrack(self):
        from cilium_tpu_torch.ops.materialize import EndpointPolicySnapshot

        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=12)
        ips = ip_strings_to_u32(["10.0.0.2"])
        args = (ips, np.zeros(1, np.int32), np.array([80], np.int32), np.array([6], np.int32))
        v, _ = nf.process(*args, sports=np.array([7777]))
        assert v.tolist() == [FORWARD]
        nf.load_policy_snapshots([EndpointPolicySnapshot(entries={}, slots=[]) for _ in range(2)])
        v, _ = nf.process(*args, sports=np.array([7777]))
        assert v.tolist() == [DROP_POLICY]

    def test_empty_ipcache_reload_clears_trie(self):
        pipe, _ids = _world()
        nf = NativeFastpath.from_pipeline(pipe, ct_bits=0)
        ips = ip_strings_to_u32(["10.0.0.2"])
        args = (ips, np.zeros(1, np.int32), np.array([80], np.int32), np.array([6], np.int32))
        v, _ = nf.process(*args)
        assert v.tolist() == [FORWARD]
        nf.load_ipcache(IPCache())
        v, _ = nf.process(*args)
        assert v.tolist() == [DROP_POLICY]


class TestLoader:
    def test_policy_row_count(self):
        from cilium_tpu_torch.ops.materialize import TRAFFIC_INGRESS

        pipe, _ids = _world()
        pipe.rebuild()
        snaps = pipe._mat[TRAFFIC_INGRESS].snapshots
        nf = NativeFastpath(ep_count=len(snaps), ct_bits=0)
        n = nf.load_policy_snapshots(snaps)
        assert n == sum(len(s.entries) for s in snaps) and n > 0


# -- the port against the JAX package ----------------------------------

N_EPS = 6


def _bench_pipe(pkg: str, seed: int, prefilter: bool):
    """``build_world`` with a /128 per identity beside its /32, and
    optionally a prefilter over one world prefix and one v6 prefix."""
    w = build_world(pkg, seed)
    for i, ident in enumerate(w.idents):
        w.ipcache.upsert(f"fd00::7:{i + 1:x}/128", ident.id, source="k8s")
    pf = _mod(pkg, "ipcache.prefilter").PreFilter()
    if prefilter:
        pf.insert(pf.revision, ["8.8.8.0/24", "10.1.0.0/16", "fd00::7:0/124"])
    kw = _kw(pkg)
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
        _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **kw), w.ipcache, pf, **kw)
    pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
    return w, pipe


def _v6_flows(w, n: int, seed: int):
    """v6 peers: the identities' /128s, one address past them, one
    world address; same ports and endpoints as ``random_flows``."""
    rs = np.random.default_rng(seed + 100)
    addrs = [f"fd00::7:{i + 1:x}" for i in range(len(w.idents) + 1)] + ["2001:db8::1"]
    pool = np.stack([np.frombuffer(ipaddress.IPv6Address(a).packed, np.uint8) for a in addrs])
    _, eps, dports, protos = random_flows(w, n, N_EPS, seed)
    return pool[rs.integers(0, len(addrs), n)].astype(np.int32), eps, dports, protos


@pytest.mark.parametrize("prefilter", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_from_pipeline_matches_jax(seed, prefilter):
    """Native loaded from the port's pipeline gives the JAX package's
    native verdicts, redirects and counters, and the port pipeline's
    verdicts, redirects and per-endpoint counters, on v4 and v6
    batches in both directions."""
    outs = {}
    for pkg in PKGS:
        w, pipe = _bench_pipe(pkg, seed, prefilter)
        nf = _mod(pkg, "native").NativeFastpath.from_pipeline(pipe, ct_bits=0)
        flows4 = random_flows(w, 3000, N_EPS, seed)
        flows6 = _v6_flows(w, 3000, seed)
        res = []
        before = pipe.counters.copy()
        for ingress in (True, False):
            res.append(nf.process(*flows4, ingress=ingress))
            res.append(nf.process_v6(*flows6, ingress=ingress))
            if pkg == "cilium_tpu_torch":
                for got, want in ((res[-2], pipe.process(*flows4, ingress=ingress)),
                                  (res[-1], pipe.process_v6(*flows6, ingress=ingress))):
                    for g, e in zip(got, want):
                        np.testing.assert_array_equal(g, e)
        if pkg == "cilium_tpu_torch":
            np.testing.assert_array_equal(nf.counters, pipe.counters - before)
        outs[pkg] = (res, nf.counters.copy())
    (jr, jc), (tr, tc) = outs["cilium_tpu"], outs["cilium_tpu_torch"]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(tc, jc)
    verdicts = np.concatenate([r[0] for r in tr])
    assert {FORWARD, DROP_POLICY} <= set(verdicts.tolist())
    assert (DROP_PREFILTER in verdicts) == prefilter


def test_from_pipeline_ct_matches_jax():
    """With native's own conntrack on (sports given), the port's native
    and the JAX package's agree over an egress pass, its replies and the
    same pass again."""
    outs = {}
    for pkg in PKGS:
        w, pipe = _bench_pipe(pkg, 1, True)
        nf = _mod(pkg, "native").NativeFastpath.from_pipeline(pipe, ct_bits=12)
        peers, eps, dports, protos = random_flows(w, 2000, N_EPS, 1)
        sports = np.random.default_rng(4).integers(1024, 60000, peers.size).astype(np.int32)
        res = [nf.process(peers, eps, dports, protos, ingress=False, sports=sports),
               nf.process(peers, eps, sports, protos, ingress=True, sports=dports),
               nf.process(peers, eps, dports, protos, ingress=False, sports=sports)]
        outs[pkg] = (res, nf.counters.copy())
    (jr, jc), (tr, tc) = outs["cilium_tpu"], outs["cilium_tpu_torch"]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("world", ["v4", "v6"])
def test_lb_arrays_equal_jax_build_device(world, monkeypatch):
    """(A3): ``load_lb`` builds the tables on the CPU and hands native
    their ``.numpy()`` arrays, element for element the JAX package's
    ``build_device()`` arrays; no step asks for the card."""
    make = _lb_world if world == "v4" else _lb_world6
    jpipe, jlbm = make("cilium_tpu")
    tpipe, tlbm = make("cilium_tpu_torch")
    want = jlbm.build_device()
    seen = []
    real = type(tlbm).build_device

    def spy(self, device=None):
        seen.append(device)
        return real(self, device=device)

    monkeypatch.setattr(type(tlbm), "build_device", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nf = NativeFastpath(ep_count=1, ct_bits=0)
    nf.load_lb(tlbm)
    assert seen == ["cpu"]
    got = real(tlbm, device="cpu")
    for fam in (4, 6):
        assert (got[fam] is None) == (want[fam] is None)
        if want[fam] is None:
            continue
        for f in ("fe_bytes", "fe_port", "fe_proto", "fe_seq", "fe_seq_len", "fe_revnat",
                  "be_bytes", "be_port"):
            g, e = getattr(got[fam], f).numpy(), np.asarray(getattr(want[fam], f))
            assert g.dtype == e.dtype and g.shape == e.shape, f
            np.testing.assert_array_equal(g, e, err_msg=f)
    # and the loaded tables translate as the JAX package's native does
    flows, call = ((_lb_flows(), "process") if world == "v4" else (_lb_flows6(), "process_v6"))
    nf_j = _mod("cilium_tpu", "native").NativeFastpath.from_pipeline(jpipe, ct_bits=0)
    nf_t = NativeFastpath.from_pipeline(tpipe, ct_bits=0)
    for a, b in zip(getattr(nf_j, call)(*flows, ingress=False),
                    getattr(nf_t, call)(*flows, ingress=False)):
        np.testing.assert_array_equal(b, a)


def test_l7_tables_match_jax():
    """``load_l7_http`` / ``load_l7_kafka`` from the port's policies give
    the JAX package's native answers on seeded requests."""
    rs = np.random.default_rng(11)
    methods = ["GET", "PUT", "POST", "DELETE"]
    paths = ["/api/v1/x", "/api/v22/y/z", "/api/vx/x", "/public/a", "/public", "/secret", ""]
    hosts = ["admin.svc", "adminxsvc", "other", ""]
    picks = [(int(rs.integers(0, 4)), int(rs.integers(0, 7)), int(rs.integers(0, 4)),
              int(rs.choice([101, 102, 999]))) for _ in range(600)]
    kpicks = [(int(rs.integers(0, 20)), int(rs.integers(0, 3)), int(rs.integers(0, 3)),
               int(rs.integers(0, 4)), int(rs.choice([101, 102, 999]))) for _ in range(600)]
    out = []
    for pkg in PKGS:
        l7, api = _mod(pkg, "l7"), _mod(pkg, "policy.api")
        kw = _kw(pkg)
        pol = l7.HTTPPolicy([
            (api.HTTPRule(method="GET", path="/api/v[0-9]+/.*"), {101, 102}),
            (api.HTTPRule(path="/public(/.*)?"), None),
            (api.HTTPRule(method="PUT|DELETE", host="admin[.]svc"), {101}),
        ], **kw)
        acl = l7.KafkaACL([
            (api.KafkaRule(role="produce", topic="orders"), {101}),
            (api.KafkaRule(topic="logs"), None),
            (api.KafkaRule(role="consume", client_id="reader"), {102}),
            (api.KafkaRule(api_key="metadata"), None),
        ], **kw)
        nf = _mod(pkg, "native").NativeFastpath(ep_count=1, ct_bits=0)
        nf.load_l7_http(7, 80, pol)
        nf.load_l7_kafka(7, 9092, acl, ingress=False)
        reqs = [l7.HTTPRequest(method=methods[m], path=paths[p], host=hosts[h], src_identity=s)
                for m, p, h, s in picks]
        kreqs = [l7.KafkaRequest(api_key=k, api_version=v,
                                 client_id=["reader", "writer", ""][c],
                                 topic=["orders", "logs", "secret", ""][t], src_identity=s)
                 for k, v, c, t, s in kpicks]
        h, k = nf.check_http_batch(7, 80, reqs), nf.check_kafka_batch(7, 9092, kreqs, ingress=False)
        np.testing.assert_array_equal(h, pol.check_batch(reqs))
        np.testing.assert_array_equal(k, acl.check_batch(kreqs))
        out.append((h, k))
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)
    assert out[1][0].any() and not out[1][0].all() and out[1][1].any() and not out[1][1].all()


def test_cache_is_the_ports_own(tmp_path, monkeypatch):
    """The port builds into its own per-user cache, keyed by the source
    hash, and refuses nothing it owns; the two packages never share a
    cached library."""
    from cilium_tpu.native import build as jbuild
    from cilium_tpu_torch.native import build as tbuild

    assert tbuild._CACHE_DIR != jbuild._CACHE_DIR
    assert "cilium_tpu_torch_native" in tbuild._CACHE_DIR
    so = tbuild._so_path()
    assert so.startswith(tbuild._CACHE_DIR) and so.endswith(".so")
    with open(tbuild._SRC, "rb") as a, open(jbuild._SRC, "rb") as b:
        assert a.read() == b.read()  # fastpath.cpp is copied byte for byte
    monkeypatch.setattr(tbuild, "_CACHE_DIR", str(tmp_path / "c"))
    built = tbuild.build()
    assert built.startswith(str(tmp_path / "c")) and tbuild._check_owned(built)
    assert oct((tmp_path / "c").stat().st_mode & 0o777) == "0o700"


def test_build_force_includes_the_headers_fastpath_omits():
    """The reference's fastpath.cpp names ``std::string`` and
    ``std::move`` without including <string> or <utility>: g++ 12 pulls
    them in through <map>, g++ 13 refuses the file. The port keeps the
    source byte for byte and its build force-includes both; the build
    command compiles the source as it stands."""
    import re
    import subprocess

    from cilium_tpu_torch.native import build as tbuild

    src = open(tbuild._SRC).read()
    included = set(re.findall(r"#include <([a-z_]+)>", src))
    cmd = tbuild.compile_command("unused.so")
    forced = {cmd[i + 1] for i, a in enumerate(cmd[:-1]) if a == "-include"}
    for header, name in (("string", "std::string"), ("utility", "std::move")):
        assert name in src and header not in included  # the reference's omission
        assert header in forced
    check = [a for a in cmd if a not in ("-shared", "-O3")]
    check[check.index("-o"):check.index("-o") + 2] = ["-fsyntax-only"]
    assert subprocess.run(check, capture_output=True).returncode == 0
