"""Port parity: endpoints and their regeneration (``cilium_tpu_torch.endpoint``).

``Endpoint``, ``EndpointState``, ``RegenerationStats`` and
``EndpointManager`` are copies of the JAX package's, with two
adaptations: ``_update_redirects`` builds its L7 policies on the
pipeline's device (a CPU pipeline never asks for CUDA), and
``regenerate_all`` lets a ``_kernels.KernelError`` reach its caller
where any other exception still counts one unsuccessful endpoint. The
reference's ``test_endpoint.py`` tests run against the port; the
host-only ones against both packages. Then the same worlds
(``build_world``) go through both packages' pipelines: realized
policymaps, ``sync_policy_map`` counts across a rule and an identity
delta, redirect sets and the L7 answers behind them must be equal.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading

import numpy as np
import pytest
import torch

from cilium_tpu_torch import _kernels
from cilium_tpu_torch.datapath import DROP_POLICY, FORWARD, DatapathPipeline
from cilium_tpu_torch.endpoint import Endpoint, EndpointManager, EndpointState
from cilium_tpu_torch.engine import PolicyEngine
from cilium_tpu_torch.identity import IdentityRegistry
from cilium_tpu_torch.ipcache import SOURCE_AGENT, IPCache
from cilium_tpu_torch.labels import parse_label_array
from cilium_tpu_torch.maps.ctmap import ConntrackMap
from cilium_tpu_torch.ops.lpm import ip_strings_to_u32
from cilium_tpu_torch.ops.materialize import PolicyKey
from cilium_tpu_torch.policy.api import EndpointSelector, IngressRule, rule
from cilium_tpu_torch.policy.repository import Repository
from test_torch_harness import PKGS, build_world

CPU = {"device": "cpu"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg: str) -> dict:
    return CPU if pkg == "cilium_tpu_torch" else {}


def _world():
    repo = Repository()
    repo.add_list([
        rule(["k8s:app=web"], ingress=[
            IngressRule(from_endpoints=(EndpointSelector.make(["k8s:app=client"]),)),
        ]),
    ])
    reg = IdentityRegistry()
    client = reg.allocate(parse_label_array(["k8s:app=client"]))
    web = reg.allocate(parse_label_array(["k8s:app=web"]))
    engine = PolicyEngine(repo, reg, device="cpu")
    cache = IPCache()
    cache.upsert("10.0.0.1", client.id, SOURCE_AGENT)
    pipe = DatapathPipeline(engine, cache, device="cpu")
    return repo, reg, engine, cache, pipe, client, web


def test_public_names_match():
    for name in ("endpoint", "endpoint.endpoint", "endpoint.manager"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        want = getattr(j, "__all__", None) or sorted(n for n in vars(j) if not n.startswith("_"))
        got = getattr(t, "__all__", None) or sorted(n for n in vars(t) if not n.startswith("_"))
        assert set(want) <= set(got), name


# -- the reference's tests: host-only ones on both packages ------------


@pytest.mark.parametrize("pkg", PKGS)
def test_legal_transitions(pkg):
    em = _mod(pkg, "endpoint")
    ep = em.Endpoint(100, _mod(pkg, "labels").parse_label_array(["k8s:app=web"]))
    S = em.EndpointState
    assert ep.state == S.CREATING
    assert ep.set_state(S.WAITING_FOR_IDENTITY)
    assert ep.set_state(S.READY)
    assert ep.set_state(S.WAITING_TO_REGENERATE)
    assert ep.set_state(S.REGENERATING)
    assert ep.set_state(S.READY)
    assert not ep.set_state(S.CREATING)  # illegal
    assert ep.set_state(S.DISCONNECTING)
    assert ep.set_state(S.DISCONNECTED)
    assert not ep.set_state(S.READY)
    assert [m for _t, code, m in ep.status_log_snapshot() if code == "state"] == [
        "creating", "waiting-for-identity", "ready", "waiting-to-regenerate", "regenerating",
        "ready", "disconnecting", "disconnected"]


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_roundtrip(pkg):
    em = _mod(pkg, "endpoint")
    ep = em.Endpoint(7, _mod(pkg, "labels").parse_label_array(["k8s:app=x"]), ipv4="1.2.3.4",
                     pod_name="ns/pod")
    ep.policy_revision = 5
    blob = ep.to_snapshot()
    ep2 = em.Endpoint.from_snapshot(blob)
    assert ep2.id == 7 and ep2.ipv4 == "1.2.3.4" and ep2.pod_name == "ns/pod"
    assert ep2.state == em.EndpointState.RESTORING
    assert ep2.policy_revision == 5
    assert ep2.set_state(em.EndpointState.WAITING_TO_REGENERATE)
    # the other package reads the blob back to the same fields
    other = _mod(PKGS[1 - PKGS.index(pkg)], "endpoint").Endpoint.from_snapshot(blob)
    assert (other.id, other.ipv4, other.pod_name, other.policy_revision) == (7, "1.2.3.4",
                                                                              "ns/pod", 5)


# -- the reference's tests that regenerate, against the port ------------


class TestRegeneration:
    def test_regenerate_and_sync(self):
        repo, reg, engine, cache, pipe, client, web = _world()
        ep = Endpoint(1, parse_label_array(["k8s:app=web"]), ipv4="10.0.0.2")
        ep.set_identity(web)
        pipe.set_endpoints([(ep.id, web.id)])
        assert ep.regenerate(pipe)
        assert ep.state == EndpointState.READY
        assert ep.policy_revision == repo.revision
        key = PolicyKey(client.id, 0, 0, 0)
        assert ep.policy_map.lookup(key) is not None
        repo.delete_by_labels(parse_label_array([]))
        repo.rules.clear()
        repo._bump()
        assert ep.regenerate(pipe)
        assert ep.policy_map.lookup(key) is None
        assert ep.stats.success and ep.stats.total.total() > 0

    def test_pipeline_agrees_with_policymap(self):
        repo, reg, engine, cache, pipe, client, web = _world()
        ep = Endpoint(1, parse_label_array(["k8s:app=web"]))
        ep.set_identity(web)
        pipe.set_endpoints([(ep.id, web.id)])
        ep.regenerate(pipe)
        v, _ = pipe.process(
            ip_strings_to_u32(["10.0.0.1", "9.9.9.9"]),
            np.zeros(2, np.int32), np.zeros(2, np.int32), np.full(2, 6, np.int32),
        )
        assert list(v) == [FORWARD, DROP_POLICY]


class TestManager:
    def test_lookups_and_fanout(self):
        repo, reg, engine, cache, pipe, client, web = _world()
        mgr = EndpointManager(workers=2)
        eps = []
        for i in range(3):
            ep = Endpoint(10 + i, parse_label_array(["k8s:app=web"]),
                          ipv4=f"10.0.1.{i}", container_id=f"c{i}", pod_name=f"default/p{i}")
            ep.set_identity(web)
            mgr.insert(ep)
            eps.append(ep)
        pipe.set_endpoints([(ep.id, web.id) for ep in eps])
        assert mgr.lookup(11) is eps[1]
        assert mgr.lookup_container("c2") is eps[2]
        assert mgr.lookup_pod("default/p0") is eps[0]
        assert mgr.lookup_ipv4("10.0.1.1") is eps[1]
        assert mgr.regenerate_all(pipe) == 3
        assert all(ep.state == EndpointState.READY for ep in eps)
        mgr.remove(eps[0])
        assert mgr.lookup(10) is None and len(mgr) == 2
        mgr.shutdown()

    def test_conntrack_gc(self):
        mgr = EndpointManager(workers=1)
        ct = ConntrackMap()
        ct.create((1, 2, 3, 4, 6, 0), 1, False, lifetime=-1.0)
        ct.create((1, 2, 3, 5, 6, 0), 1, False, lifetime=60.0)
        assert ct.gc() == 1 and len(ct) == 1
        mgr.shutdown()


# -- (A2): kernel errors reach the caller --------------------------------


def test_kernel_error_reaches_the_caller_of_regenerate_all(monkeypatch):
    """A KernelError in one endpoint's regeneration is raised from
    regenerate_all once every endpoint's regeneration has ended; the
    other endpoints still regenerate."""
    repo, reg, engine, cache, pipe, client, web = _world()
    mgr = EndpointManager(workers=4)
    eps = [Endpoint(20 + i, parse_label_array(["k8s:app=web"])) for i in range(4)]
    for ep in eps:
        ep.set_identity(web)
        mgr.insert(ep)
    pipe.set_endpoints([(ep.id, web.id) for ep in eps])
    real = Endpoint.sync_policy_map

    def sync(self, desired):
        if self.id == 22:
            raise _kernels.KernelError("policymap_verdict: launch failed")
        return real(self, desired)

    monkeypatch.setattr(Endpoint, "sync_policy_map", sync)
    with pytest.raises(_kernels.KernelError, match="launch failed"):
        mgr.regenerate_all(pipe)
    assert [ep.stats.success for ep in eps] == [True, True, False, True]
    assert all(ep.state == EndpointState.READY for ep in eps)
    assert [c for _t, c, _m in eps[2].status_log_snapshot()][-2:] == ["regen-fail", "state"]
    mgr.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_other_errors_count_one_unsuccessful_endpoint(pkg, monkeypatch):
    """Any other exception stays isolated to its endpoint, in both
    packages: the fan-out returns the count that succeeded."""
    em = _mod(pkg, "endpoint")
    labels = _mod(pkg, "labels")
    reg = _mod(pkg, "identity").IdentityRegistry()
    web = reg.allocate(labels.parse_label_array(["k8s:app=web"]))
    repo = _mod(pkg, "policy.repository").Repository()
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
        _mod(pkg, "engine").PolicyEngine(repo, reg, **_kw(pkg)),
        _mod(pkg, "ipcache.ipcache").IPCache(), **_kw(pkg))
    mgr = em.EndpointManager(workers=3)
    eps = [em.Endpoint(30 + i, labels.parse_label_array(["k8s:app=web"])) for i in range(3)]
    for ep in eps:
        ep.set_identity(web)
        mgr.insert(ep)
    pipe.set_endpoints([(ep.id, web.id) for ep in eps])
    real = em.Endpoint.sync_policy_map

    def sync(self, desired):
        if self.id == 31:
            raise RuntimeError("map full")
        return real(self, desired)

    monkeypatch.setattr(em.Endpoint, "sync_policy_map", sync)
    assert mgr.regenerate_all(pipe) == 2
    assert [ep.stats.success for ep in eps] == [True, False, True]
    mgr.shutdown()


# -- (A1): a CPU pipeline's redirects never ask for the card -----------


def _l7_world(pkg: str, seed: int, n_rules: int):
    """``build_world`` plus one Kafka rule (port 9092 from the app-0
    pods to every endpoint of app 1) and one wildcard-L7 HTTP port."""
    w = build_world(pkg, seed, n_rules=n_rules)
    api = _mod(pkg, "policy.api")
    w.repo.add_list([
        api.rule(["k8s:app=a1"], ingress=[api.IngressRule(
            from_endpoints=(api.EndpointSelector.make(["k8s:app=a0"]),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(9092, "TCP"),), rules=api.L7Rules(
                kafka=(api.KafkaRule(role="produce", topic="orders"),
                       api.KafkaRule(api_key="metadata")))),),
        )], labels=["k8s:policy=kafka"]),
        api.rule(["k8s:app=a1"], ingress=[api.IngressRule(
            from_endpoints=(api.EndpointSelector.make(["k8s:app=a2"]),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(8080, "TCP"),),
                                   rules=api.L7Rules(http=(api.HTTPRule(),))),),
        )], labels=["k8s:policy=wild"]),
    ])
    return w


def _endpoints(pkg: str, w, n: int):
    em, labels = _mod(pkg, "endpoint"), _mod(pkg, "labels")
    eps = []
    for i, ident in enumerate(w.idents[:n]):
        ep = em.Endpoint(ident.id, labels.parse_label_array(w.ident_labels[ident.id]),
                         ipv4=f"172.16.0.{i + 1}")
        ep.set_identity(ident)
        eps.append(ep)
    return eps


def test_cpu_pipeline_redirects_never_ask_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = _l7_world("cilium_tpu_torch", 5, 96)
    pipe = DatapathPipeline(PolicyEngine(w.repo, w.reg, device="cpu"), w.ipcache, device="cpu")
    eps = _endpoints("cilium_tpu_torch", w, 16)
    pipe.set_endpoints([ep.id for ep in eps])
    from cilium_tpu_torch.proxy import Proxy

    proxy = Proxy()
    assert all(ep.regenerate(pipe, proxy=proxy) for ep in eps)
    rds = list(proxy.redirects().values())
    assert {r.parser for r in rds} == {"http", "kafka"}
    for r in rds:
        pol = r.http_policy if r.parser == "http" else r.kafka_acl
        assert pol.device.type == "cpu"


# -- the port against the JAX package ----------------------------------


def _dump(ep):
    return sorted((dataclasses.astuple(k), dataclasses.astuple(e)) for k, e in ep.policy_map.dump())


def _redirect_set(proxy):
    out = {}
    for key, r in proxy.redirects().items():
        rules = []
        if r.http_policy is not None:
            rules = [(dataclasses.astuple(cr.rule), None if cr.allowed_identities is None
                      else sorted(cr.allowed_identities)) for cr in r.http_policy._rules]
        if r.kafka_acl is not None:
            rules = [(dataclasses.astuple(kr), None if ids is None else sorted(ids))
                     for kr, ids in r.kafka_acl._rules]
        out[key] = (r.endpoint_id, r.dst_port, r.ingress, r.parser, rules)
    return out


def _regen(pkg: str, seed: int, n_rules: int, n_eps: int):
    """Regenerate every endpoint through ``pkg``, then after a rule
    delta (a rule deleted, one added) and an identity delta (a new peer
    identity the added rule selects): the realized policymaps, each
    sync's (added, deleted) and each endpoint's revision, per round."""
    w = _l7_world(pkg, seed, n_rules)
    engine = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_kw(pkg))
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(engine, w.ipcache, **_kw(pkg))
    eps = _endpoints(pkg, w, n_eps)
    pipe.set_endpoints([ep.id for ep in eps])
    counts = {}
    for ep in eps:
        real = ep.sync_policy_map

        def sync(desired, _real=real, _id=ep.id):
            got = _real(desired)
            counts[_id] = got
            return got

        ep.sync_policy_map = sync
    api, labels = _mod(pkg, "policy.api"), _mod(pkg, "labels")
    rounds = []

    def regen_all():
        counts.clear()
        assert all(ep.regenerate(pipe, reason="test") for ep in eps)
        rounds.append(([_dump(ep) for ep in eps], [counts[ep.id] for ep in eps],
                       [ep.policy_revision - w.repo.revision for ep in eps]))

    regen_all()
    # endpoint 0's app takes port 9443 from endpoint 1's app; the
    # wildcard-L7 rule goes
    app0, app1 = (w.ident_labels[ep.id][0] for ep in eps[:2])
    w.repo.delete_by_labels(labels.parse_label_array(["k8s:policy=wild"]))
    w.repo.add_list([api.rule([app0], ingress=[api.IngressRule(
        from_endpoints=(api.EndpointSelector.make([app1]),),
        to_ports=(api.PortRule(ports=(api.PortProtocol(9443, "TCP"),)),))],
        labels=["k8s:policy=delta"])])
    regen_all()
    # a new peer of endpoint 1's app: the delta rule admits it
    peer = w.reg.allocate(labels.parse_label_array([app1, "k8s:team=t1", "k8s:uid=new"]))
    w.ipcache.upsert("172.17.0.1/32", peer.id, source="k8s")
    regen_all()
    return rounds


@pytest.mark.parametrize("seed,n_rules", [(0, 24), (5, 96), (11, 24)])
def test_regeneration_matches_jax(seed, n_rules):
    j, t = (_regen(pkg, seed, n_rules, 8) for pkg in PKGS)
    assert t == j
    assert all(rev == 0 for r in t for rev in r[2])
    # the deltas moved some maps, and each sync's counts add up
    assert any(a or d for a, d in t[1][1]) and any(a or d for a, d in t[2][1])
    assert [sum(a for a, _ in r[1]) for r in t[:1]] == [sum(len(m) for m in t[0][0])]


def _redirects(pkg: str, seed: int, n_rules: int):
    w = _l7_world(pkg, seed, n_rules)
    engine = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_kw(pkg))
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(engine, w.ipcache, **_kw(pkg))
    eps = _endpoints(pkg, w, 16)
    pipe.set_endpoints([ep.id for ep in eps])
    mgr = _mod(pkg, "endpoint").EndpointManager(workers=4)
    for ep in eps:
        mgr.insert(ep)
    proxy = _mod(pkg, "proxy").Proxy()
    assert mgr.regenerate_all(pipe, reason="test", proxy=proxy) == len(eps)
    first = _redirect_set(proxy)
    # seeded requests to every redirect
    l7 = _mod(pkg, "l7")
    rs = np.random.default_rng(seed + 7)
    ids = [i.id for i in w.reg]
    answers = {}
    for key, r in sorted(proxy.redirects().items()):
        if r.parser == "http":
            reqs = [l7.HTTPRequest(method=str(m), path=str(p), src_identity=int(s))
                    for m, p, s in zip(rs.choice(["GET", "POST", "PUT"], 64),
                                       rs.choice(["/api/x", "/api/", "/other", "/"], 64),
                                       rs.choice(ids, 64))]
            answers[key] = proxy.check_http(r, reqs).tolist()
        else:
            reqs = [l7.KafkaRequest(api_key=int(k), api_version=1, client_id="c",
                                    topic=str(tp), src_identity=int(s))
                    for k, tp, s in zip(rs.choice([0, 1, 3, 8], 64),
                                        rs.choice(["orders", "logs"], 64), rs.choice(ids, 64))]
            answers[key] = np.asarray(proxy.check_kafka(r, reqs)).tolist()
    # a rule delta: the app-1 Kafka rule goes; its redirects go with it
    w.repo.delete_by_labels(_mod(pkg, "labels").parse_label_array(["k8s:policy=kafka"]))
    assert mgr.regenerate_all(pipe, proxy=proxy) == len(eps)
    mgr.shutdown()
    return first, answers, _redirect_set(proxy)


@pytest.mark.parametrize("seed,n_rules", [(5, 96), (11, 24)])
def test_redirects_match_jax(seed, n_rules):
    """``regenerate(pipe, proxy=proxy)`` gives the JAX package's
    redirect set, rule scopes included, and the same check_http /
    check_kafka answers; a deleted rule removes its redirects in both."""
    j, t = (_redirects(pkg, seed, n_rules) for pkg in PKGS)
    assert t == j
    first, answers, after = t
    parsers = {v[3] for v in first.values()}
    assert parsers == {"http", "kafka"}
    flat = [a for v in answers.values() for a in v]
    assert any(flat) and not all(flat)
    assert {v[3] for v in after.values()} == {"http"} and len(after) < len(first)


def test_concurrent_regenerations_build_the_tables_once(monkeypatch):
    """regenerate_all runs every endpoint's regeneration on the pool:
    the first rebuild refreshes the engine and materializes both
    directions once, the others take the rebuild's early return and
    read the tables it built."""
    w = build_world("cilium_tpu_torch", 5, n_rules=96)
    engine = PolicyEngine(w.repo, w.reg, device="cpu")
    pipe = DatapathPipeline(engine, w.ipcache, device="cpu")
    eps = _endpoints("cilium_tpu_torch", w, 24)
    pipe.set_endpoints([ep.id for ep in eps])
    calls = {"materialize": 0}
    real_refresh, real_mat = type(engine).refresh, type(pipe)._materialize_both
    seen = set()

    def refresh(self, *a, **kw):
        seen.add(threading.current_thread().name)
        return real_refresh(self, *a, **kw)

    def materialize(self, *a, **kw):
        calls["materialize"] += 1
        return real_mat(self, *a, **kw)

    monkeypatch.setattr(type(engine), "refresh", refresh)
    monkeypatch.setattr(type(pipe), "_materialize_both", materialize)
    from cilium_tpu_torch import metrics

    full = metrics.engine_refreshes_total.get({"kind": "full"})
    mgr = EndpointManager(workers=8)
    for ep in eps:
        mgr.insert(ep)
    assert mgr.regenerate_all(pipe) == len(eps)
    assert calls["materialize"] == 1
    assert all(name.startswith("ep-builder") for name in seen)
    snaps = pipe.snapshots()
    for ep in eps:
        want = snaps[pipe.endpoint_index(ep.id)].entries
        assert {k: e.proxy_port for k, e in ep.policy_map.dump()} == want
        assert ep.policy_revision == engine._compiled.revision
    assert metrics.engine_refreshes_total.get({"kind": "full"}) - full == 1
    mgr.shutdown()
