"""Port parity: the realized datapath maps (``cilium_tpu_torch.maps``).

``policymap``, ``lxcmap``, ``prefixmap``, ``proxymap``, ``routes`` and
``tunnel`` are host code copied from the JAX package; each test here
runs against both packages. The reference's ``test_policymap.py`` tests
(the materialized policymap and the lookup against the engine) run
against the port, and its policymap snapshots must equal the JAX
package's on random worlds. ``observe_node_cidrs`` is fed both by a
registry stand-in with the same ``local`` / ``observe`` surface and by
each package's own ``nodes.NodeRegistry`` over an in-memory kvstore (the
``NodeRegistry`` halves of the reference's tunnel and route tests).
"""

from __future__ import annotations

import dataclasses
import importlib
import threading

import numpy as np
import pytest
import torch

from test_torch_harness import PKGS, build_world

CPU = {"device": "cpu"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg: str) -> dict:
    return CPU if pkg == "cilium_tpu_torch" else {}


def test_public_names_match():
    for name in ("maps", "maps.policymap", "maps.lxcmap", "maps.prefixmap", "maps.proxymap",
                 "maps.routes", "maps.tunnel"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        want = getattr(j, "__all__", None) or sorted(n for n in vars(j) if not n.startswith("_"))
        got = getattr(t, "__all__", None) or sorted(n for n in vars(t) if not n.startswith("_"))
        assert got == want, name
    from cilium_tpu_torch import maps

    assert maps.PolicyMap is _mod("cilium_tpu_torch", "maps.policymap").PolicyMap


# -- PolicyMap ---------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_policymap_allow_delete_account_dump_flush(pkg):
    pm_mod = _mod(pkg, "maps.policymap")
    PolicyKey = _mod(pkg, "ops.materialize").PolicyKey
    m = pm_mod.PolicyMap(name="cilium_policy_7")
    a, b = PolicyKey(100, 80, 6, 0), PolicyKey(101, 0, 0, 1)
    m.allow(a)
    m.allow(b, proxy_port=1)
    assert len(m) == 2 and m.exists(a) and m.lookup(b).proxy_port == 1
    m.allow(b, proxy_port=0)  # an update keeps the counters, moves the port
    m.account(b, 3, 300)
    m.account(PolicyKey(9, 9, 9, 9), 1, 1)  # absent: nothing happens
    assert m.lookup(b) == pm_mod.PolicyEntry(proxy_port=0, packets=3, bytes=300)
    assert sorted((k.identity, e.packets) for k, e in m.dump()) == [(100, 0), (101, 3)]
    assert m.delete(a) and not m.delete(a) and not m.exists(a) and m.lookup(a) is None
    m.flush()
    assert len(m) == 0 and m.dump() == []


@pytest.mark.parametrize("pkg", PKGS)
def test_policymap_concurrent_accounting(pkg):
    """Builder and accounting threads share one map under its lock."""
    pm_mod = _mod(pkg, "maps.policymap")
    PolicyKey = _mod(pkg, "ops.materialize").PolicyKey
    m = pm_mod.PolicyMap()
    key = PolicyKey(5, 443, 6, 0)
    m.allow(key)

    def bump():
        for _ in range(2000):
            m.account(key, 1, 10)

    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert m.lookup(key) == pm_mod.PolicyEntry(0, 8000, 80000)


# -- the reference's test_policymap.py, against the port ---------------


def _pm_world(pkg: str):
    api = _mod(pkg, "policy.api")
    http = api.L7Rules(http=(api.HTTPRule(method="GET"),))
    rules = [
        api.rule(
            ["k8s:app=b"],
            ingress=[
                api.IngressRule(from_endpoints=(api.EndpointSelector.make(["k8s:app=a"]),)),
                api.IngressRule(
                    from_endpoints=(api.EndpointSelector.make(["k8s:app=c"]),),
                    to_ports=(api.PortRule(ports=(api.PortProtocol(80, "TCP"),)),),
                ),
                api.IngressRule(
                    from_endpoints=(api.EndpointSelector.make(["k8s:app=a"]),),
                    to_ports=(api.PortRule(ports=(api.PortProtocol(8080, "TCP"),), rules=http),),
                ),
            ],
        ),
        api.rule(
            ["k8s:app=d"],
            ingress=[api.IngressRule(
                to_ports=(api.PortRule(ports=(api.PortProtocol(53, "ANY"),)),))],
        ),
    ]
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list(rules)
    reg = _mod(pkg, "identity").IdentityRegistry()
    labels = _mod(pkg, "labels")
    idents = {name: reg.allocate(labels.parse_label_array([f"k8s:app={name}"]))
              for name in ("a", "b", "c", "d")}
    return _mod(pkg, "engine").PolicyEngine(repo, reg, **_kw(pkg)), idents


def test_lookup_matches_engine():
    from cilium_tpu_torch.engine import PROTO_TCP, PROTO_UDP
    from cilium_tpu_torch.ops.lookup import lookup_batch
    from cilium_tpu_torch.ops.materialize import materialize_endpoints

    engine, idents = _pm_world("cilium_tpu_torch")
    compiled = engine.refresh()
    ep_ids = [idents[n].id for n in ("b", "d")]
    tables, _snaps = materialize_endpoints(compiled, engine.device_policy, ep_ids)
    ports = [(0, PROTO_TCP), (80, PROTO_TCP), (8080, PROTO_TCP), (53, PROTO_UDP), (53, PROTO_TCP)]
    cases = [(e, src.id, port, proto) for e in range(len(ep_ids)) for src in idents.values()
             for port, proto in ports]

    def col(i, dtype=np.int32):
        return torch.from_numpy(np.array([c[i] for c in cases], dtype))

    src_rows = torch.from_numpy(np.asarray(engine.rows([c[1] for c in cases]), np.int32))
    dec, red = lookup_batch(tables, col(0), src_rows, col(2), col(3))
    v = engine.verdicts([ep_ids[c[0]] for c in cases], [c[1] for c in cases],
                        [c[2] for c in cases], [c[3] for c in cases],
                        has_l4=[c[2] != 0 for c in cases])
    np.testing.assert_array_equal(np.asarray(dec), np.asarray(v.decision))
    np.testing.assert_array_equal(np.asarray(red), np.asarray(v.l7_redirect))


def test_redirect_flag_semantics():
    from cilium_tpu_torch.engine import PROTO_TCP

    engine, idents = _pm_world("cilium_tpu_torch")
    v = engine.verdicts([idents["b"].id], [idents["a"].id], [8080], [PROTO_TCP])
    assert int(v.decision[0]) == 1 and bool(v.l7_redirect[0])
    v = engine.verdicts([idents["b"].id], [idents["a"].id], [0], [PROTO_TCP], has_l4=[False])
    assert int(v.decision[0]) == 1 and not bool(v.l7_redirect[0])
    v = engine.verdicts([idents["b"].id], [idents["c"].id], [80], [PROTO_TCP])
    assert int(v.decision[0]) == 1 and not bool(v.l7_redirect[0])


def test_policymap_snapshot_entries():
    from cilium_tpu_torch.ops.materialize import PolicyKey, materialize_endpoints

    engine, idents = _pm_world("cilium_tpu_torch")
    compiled = engine.refresh()
    _tables, snaps = materialize_endpoints(compiled, engine.device_policy, [idents["b"].id])
    entries = snaps[0].entries
    a, c = idents["a"].id, idents["c"].id
    assert PolicyKey(a, 0, 0, 0) in entries
    assert entries[PolicyKey(a, 8080, 6, 0)] == 1
    assert entries[PolicyKey(c, 80, 6, 0)] == 0
    assert PolicyKey(c, 0, 0, 0) not in entries


def _key(k):
    return dataclasses.astuple(k)


@pytest.mark.parametrize("seed,n_rules", [(0, 24), (1, 24), (11, 24), (5, 96)])
def test_policymap_snapshots_match_jax(seed, n_rules):
    """Each endpoint's realized policymap (the snapshot dict a
    ``PolicyMap`` is synced from) equals the JAX package's, both
    directions, on the random worlds (seeds 0, 11 and 5 redirect)."""
    snaps = []
    for pkg in PKGS:
        w = build_world(pkg, seed, n_rules=n_rules)
        engine = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_kw(pkg))
        pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(engine, w.ipcache, **_kw(pkg))
        pipe.set_endpoints([i.id for i in w.idents[:8]])
        snaps.append([{_key(k): v for k, v in s.entries.items()}
                      for ingress in (True, False) for s in pipe.snapshots(ingress)])
    assert snaps[1] == snaps[0]
    assert sum(map(len, snaps[1])) > 0
    assert any(1 in s.values() for s in snaps[1]) == (seed in (0, 11, 5))


# -- LXC, proxy, tunnel and route maps ---------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_lxcmap_crud_and_sync(pkg):
    lx = _mod(pkg, "maps.lxcmap")
    m = lx.LXCMap()
    m.upsert("10.0.0.5", lx.EndpointInfo(endpoint_id=7))
    assert m.lookup("10.0.0.5").endpoint_id == 7
    assert m.lookup("10.0.0.6") is None

    class EP:
        def __init__(self, id, ipv4=None, ipv6=None):
            self.id, self.ipv4, self.ipv6 = id, ipv4, ipv6

    n = m.sync_endpoints([EP(1, "10.0.0.1"), EP(2, "10.0.0.2", "fd00::2")])
    assert n == 3 and len(m) == 3
    assert m.lookup("10.0.0.5") is None
    assert m.lookup("fd00:0::2").endpoint_id == 2  # normalized
    assert [ip for ip, _ in m.items()] == ["10.0.0.1", "10.0.0.2", "fd00::2"]
    assert m.delete("10.0.0.1") and not m.delete("10.0.0.1")


@pytest.mark.parametrize("pkg", PKGS)
def test_proxymap_record_lookup_gc(pkg):
    px = _mod(pkg, "maps.proxymap")
    pm = px.ProxyMap(lifetime=0.0)
    pm2 = px.ProxyMap()
    v = px.ProxyValue(orig_dst_ip="10.0.0.9", orig_dst_port=80, src_identity=1002)
    pm2.record("10.0.0.1", 4444, "10.0.0.2", 15001, 6, v)
    assert pm2.lookup("10.0.0.1", 4444, "10.0.0.2", 15001, 6) == v
    assert pm2.lookup("10.0.0.1", 4445, "10.0.0.2", 15001, 6) is None
    assert len(pm2) == 1 and pm2.items()[0]["orig_dst"] == "10.0.0.9:80"
    pm.record("1.1.1.1", 1, "2.2.2.2", 2, 6, v)
    assert pm.lookup("1.1.1.1", 1, "2.2.2.2", 2, 6) is None
    assert pm.gc() == 1 and len(pm) == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_tunnel_map_lpm(pkg):
    t = _mod(pkg, "maps.tunnel").TunnelMap()
    t.upsert("10.1.0.0/16", "192.168.0.1")
    t.upsert("10.1.2.0/24", "192.168.0.2")
    assert t.lookup("10.1.2.9") == "192.168.0.2"  # longest wins
    assert t.lookup("10.1.9.9") == "192.168.0.1"
    assert t.lookup("10.9.0.1") is None
    assert t.items() == [("10.1.0.0/16", "192.168.0.1"), ("10.1.2.0/24", "192.168.0.2")]
    assert t.delete("10.1.2.5/24") and t.lookup("10.1.2.9") == "192.168.0.1"
    assert t.clear() == 1 and len(t) == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_route_table_lpm(pkg):
    rm = _mod(pkg, "maps.routes")
    t = rm.RouteTable()
    t.upsert(rm.Route("10.0.0.0/8", "192.168.0.1", "eth0"))
    t.upsert(rm.Route("10.1.0.0/16", None, "cilium_vxlan", mtu=1450))
    t.upsert(rm.Route("fd00::/64", None, "cilium_vxlan"))
    assert t.lookup("10.1.2.3").device == "cilium_vxlan"
    assert t.lookup("10.9.0.1").nexthop == "192.168.0.1"
    assert t.lookup("172.16.0.1") is None
    assert t.lookup("fd00::5").prefix == "fd00::/64" and t.lookup("fd01::5") is None
    assert [r.prefix for r in t.items()] == ["10.0.0.0/8", "10.1.0.0/16", "fd00::/64"]


@dataclasses.dataclass
class _Node:
    key_name: str
    ipv4: str = ""
    ipv6: str = ""
    ipv4_alloc_cidr: str = ""
    ipv6_alloc_cidr: str = ""


class _Registry:
    """The surface ``observe_node_cidrs`` reads of a NodeRegistry:
    ``local.key_name`` and ``observe(fn, replay=True)``."""

    def __init__(self, local: _Node, nodes=()):
        self.local = local
        self._nodes = {n.key_name: n for n in (local, *nodes)}
        self._fns = []

    def observe(self, fn, replay=False):
        self._fns.append(fn)
        if replay:
            for n in self._nodes.values():
                fn(n, True)

    def put(self, node: _Node):
        self._nodes[node.key_name] = node
        for fn in self._fns:
            fn(node, True)

    def drop(self, key: str):
        node = self._nodes.pop(key)
        for fn in self._fns:
            fn(node, False)


@pytest.mark.parametrize("pkg", PKGS)
def test_node_observers_program_tunnel_and_routes(pkg):
    """Remote nodes' alloc CIDRs → tunnel entries and routes; the local
    node is skipped, a node with no address programs nothing, a changed
    CIDR set removes the stale prefix, a dead node its prefixes."""
    tm = _mod(pkg, "maps.tunnel").TunnelMap()
    rt = _mod(pkg, "maps.routes").RouteTable()
    reg = _Registry(_Node("local", ipv4="192.168.0.1", ipv4_alloc_cidr="10.1.0.0/24"),
                    [_Node("r1", ipv4="192.168.0.2", ipv4_alloc_cidr="10.2.0.0/24",
                           ipv6_alloc_cidr="fd02::/64")])
    tm.observe_nodes(reg)
    rt.observe_nodes(reg, route_mtu=1450)
    assert tm.lookup("10.1.0.5") is None and rt.lookup("10.1.0.5") is None
    assert tm.lookup("10.2.0.9") == "192.168.0.2" and tm.lookup("fd02::1") == "192.168.0.2"
    route = rt.lookup("10.2.0.9")
    assert route.nexthop == "192.168.0.2" and route.mtu == 1450 and route.device == "cilium_vxlan"
    reg.put(_Node("half", ipv4_alloc_cidr="10.7.0.0/24"))  # no address yet
    assert tm.lookup("10.7.0.1") is None and rt.lookup("10.7.0.1") is None
    reg.put(_Node("r1", ipv4="192.168.0.2", ipv4_alloc_cidr="10.3.0.0/24"))
    assert tm.lookup("10.3.0.9") == "192.168.0.2" and tm.lookup("10.2.0.9") is None
    assert tm.lookup("fd02::1") is None and rt.lookup("10.2.0.9") is None
    reg.drop("r1")
    assert len(tm) == 0 and len(rt) == 0


# -- the NodeRegistry halves of test_maps_infra.py and test_small_infra.py ------

def _node_registry(pkg, store, client: str, **node):
    kv, nodes = _mod(pkg, "kvstore"), _mod(pkg, "nodes.registry")
    return nodes.NodeRegistry(kv.InMemoryBackend(store, client), nodes.Node(**node))


@pytest.mark.parametrize("pkg", PKGS)
def test_tunnel_observes_node_registry(pkg):
    store = _mod(pkg, "kvstore").InMemoryStore()
    local = _node_registry(pkg, store, "l", name="local", ipv4="192.168.0.1",
                           ipv4_alloc_cidr="10.1.0.0/24")
    t = _mod(pkg, "maps.tunnel").TunnelMap()
    t.observe_nodes(local)
    remote = _node_registry(pkg, store, "r", name="remote", ipv4="192.168.0.2",
                            ipv4_alloc_cidr="10.2.0.0/24")
    local.pump()
    assert t.lookup("10.2.0.9") == "192.168.0.2"
    remote.unregister()
    local.pump()
    assert t.lookup("10.2.0.9") is None


@pytest.mark.parametrize("pkg", PKGS)
def test_tunnel_churn_local_node_skipped_and_cidr_change_cleans_stale(pkg):
    store = _mod(pkg, "kvstore").InMemoryStore()
    local = _node_registry(pkg, store, "l", name="local", ipv4="192.168.0.1",
                           ipv4_alloc_cidr="10.1.0.0/24")
    t = _mod(pkg, "maps.tunnel").TunnelMap()
    t.observe_nodes(local)
    # the local node's own CIDR must never be tunnel-mapped
    assert t.lookup("10.1.0.5") is None
    _node_registry(pkg, store, "r", name="remote", ipv4="192.168.0.2",
                   ipv4_alloc_cidr="10.2.0.0/24")
    local.pump()
    assert t.lookup("10.2.0.9") == "192.168.0.2"
    # remote re-registers with a DIFFERENT alloc CIDR: the stale prefix
    # must disappear
    _node_registry(pkg, store, "r2", name="remote", ipv4="192.168.0.2",
                   ipv4_alloc_cidr="10.3.0.0/24")
    local.pump()
    assert t.lookup("10.3.0.9") == "192.168.0.2"
    assert t.lookup("10.2.0.9") is None


@pytest.mark.parametrize("pkg", PKGS)
def test_routes_observe_node_registry(pkg):
    rm = _mod(pkg, "maps.routes")
    store = _mod(pkg, "kvstore").InMemoryStore()
    local = _node_registry(pkg, store, "l", name="local", ipv4="192.168.0.1",
                           ipv4_alloc_cidr="10.1.0.0/24")
    rt = rm.RouteTable()
    rt.observe_nodes(local, route_mtu=1450)
    assert rt.lookup("10.1.0.5") is None  # local CIDR not routed
    _node_registry(pkg, store, "r", name="remote", ipv4="192.168.0.2",
                   ipv4_alloc_cidr="10.2.0.0/24")
    local.pump()
    route = rt.lookup("10.2.0.9")
    assert route.nexthop == "192.168.0.2" and route.mtu == 1450


@pytest.mark.parametrize("pkg", PKGS)
def test_routes_partial_registration_programs_nothing(pkg):
    """A node with alloc CIDRs but no address yet must not install
    routes or tunnel entries claiming reachability."""
    store = _mod(pkg, "kvstore").InMemoryStore()
    local = _node_registry(pkg, store, "l", name="local", ipv4="1.1.1.1")
    rt, tm = _mod(pkg, "maps.routes").RouteTable(), _mod(pkg, "maps.tunnel").TunnelMap()
    rt.observe_nodes(local)
    tm.observe_nodes(local)
    _node_registry(pkg, store, "r", name="half", ipv4_alloc_cidr="10.7.0.0/24")  # no addr
    local.pump()
    assert rt.lookup("10.7.0.5") is None
    assert tm.lookup("10.7.0.5") is None
