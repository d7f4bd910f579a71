"""Port parity: distributed state — ``identity/distributed.py``
(``DistributedIdentityAllocator``), ``ipcache/kvstore_sync.py``
(``IPIdentitySync``), ``nodes/`` (``NodeRegistry``) and
``kvstore/clustermesh.py`` (``ClusterMesh``), host code copied from the
JAX package, feeding the port's registry, ipcache, engine and pipeline.

All 14 tests of the reference's ``test_distributed.py`` run here against
both packages (the ``m`` fixture); their ``Agent`` runs each package's
engine, the port's on the CPU. Then, for each seed, two agents in each
package over one in-memory kvstore take the same interleaved identity
allocations (with overlap) and ip announcements on a harness world: the
two agents' registries, ipcaches, verdicts, redirects and per-endpoint
counters on v4 and v6 batches in both directions are equal, within a
package and across the two packages; agent B runs with sparse trie
deltas and agent A without. The checks run again after agent A's lease
dies (B's rebuild patches its tries, equal to a fresh pipeline without
sparse deltas) and after the GC that reaps A's identities (an identity
delta, equal to a fresh engine's full compile). Tolerance 0: every
value is an integer. The tests that build a ``Daemon`` come with the
port's daemon.
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest

from test_torch_harness import PKGS, build_world, random_flows


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _ns(pkg: str):
    """The names the reference's distributed tests import, from ``pkg``,
    and the device keyword its engine and pipeline need on the CPU."""
    api = _mod(pkg, "policy.api")
    kvs = _mod(pkg, "kvstore")
    nodes = _mod(pkg, "nodes")
    m = types.SimpleNamespace(
        pkg=pkg,
        cpu={"device": "cpu"} if pkg == "cilium_tpu_torch" else {},
        PolicyEngine=_mod(pkg, "engine").PolicyEngine,
        IdentityRegistry=_mod(pkg, "identity").IdentityRegistry,
        DistributedIdentityAllocator=_mod(
            pkg, "identity.distributed").DistributedIdentityAllocator,
        IPCache=_mod(pkg, "ipcache.ipcache").IPCache,
        PreFilter=_mod(pkg, "ipcache").PreFilter,
        IPIdentitySync=_mod(pkg, "ipcache.kvstore_sync").IPIdentitySync,
        ClusterMesh=kvs.ClusterMesh,
        Allocator=kvs.Allocator,
        InMemoryBackend=kvs.InMemoryBackend,
        InMemoryStore=kvs.InMemoryStore,
        parse_label_array=_mod(pkg, "labels").parse_label_array,
        Node=nodes.Node,
        NodeRegistry=nodes.NodeRegistry,
        EndpointSelector=api.EndpointSelector,
        IngressRule=api.IngressRule,
        PortProtocol=api.PortProtocol,
        PortRule=api.PortRule,
        rule=api.rule,
        Repository=_mod(pkg, "policy.repository").Repository,
        DatapathPipeline=_mod(pkg, "datapath.pipeline").DatapathPipeline,
        metrics=_mod(pkg, "metrics"),
    )
    m.Agent = lambda store, name: Agent(m, store, name)
    return m


@pytest.fixture(params=PKGS)
def m(request):
    return _ns(request.param)


def test_public_names_match():
    for name in ("identity.distributed", "ipcache.kvstore_sync", "nodes", "nodes.registry"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        assert sorted(n for n in vars(t) if not n.startswith("_")) == sorted(
            n for n in vars(j) if not n.startswith("_")), name
    assert _mod("cilium_tpu_torch", "nodes").__all__ == _mod("cilium_tpu", "nodes").__all__


# -- test_distributed.py ----------------------------------------------------------

def _policy_rules(m):
    return [
        m.rule(
            ["k8s:app=web"],
            ingress=[
                m.IngressRule(
                    from_endpoints=(m.EndpointSelector.make(["k8s:app=lb"]),),
                    to_ports=(m.PortRule(ports=(m.PortProtocol(80, "TCP"),)),),
                )
            ],
        ),
        m.rule(
            ["k8s:app=db"],
            ingress=[
                m.IngressRule(from_endpoints=(m.EndpointSelector.make(["k8s:app=web"]),))
            ],
        ),
    ]


class Agent:
    """A minimal per-node agent: engine + distributed identity alloc +
    ipcache sync, all on one kvstore client."""

    def __init__(self, m, store, name: str):
        self.name = name
        self.backend = m.InMemoryBackend(store, name)
        self.repo = m.Repository()
        self.repo.add_list(_policy_rules(m))
        self.registry = m.IdentityRegistry()
        self.ident = m.DistributedIdentityAllocator(self.backend, self.registry, name)
        self.ipcache = m.IPCache()
        self.ipsync = m.IPIdentitySync(self.backend, self.ipcache)
        self.engine = m.PolicyEngine(self.repo, self.registry, **m.cpu)

    def pump(self):
        self.ident.pump()
        self.ipsync.pump()


LBLS = {
    "web": ["k8s:app=web"],
    "db": ["k8s:app=db"],
    "lb": ["k8s:app=lb"],
    "other": ["k8s:app=other"],
}


class TestTwoAgentConvergence:
    @pytest.fixture()
    def agents(self, m):
        store = m.InMemoryStore()
        return store, m.Agent(store, "node-a"), m.Agent(store, "node-b")

    def test_identity_numbering_converges(self, m, agents):
        _store, a, b = agents
        # interleaved allocation of overlapping label sets on both nodes
        ia_web = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        ib_db = b.ident.allocate(m.parse_label_array(LBLS["db"]))
        ib_web = b.ident.allocate(m.parse_label_array(LBLS["web"]))
        ia_db = a.ident.allocate(m.parse_label_array(LBLS["db"]))
        ia_lb = a.ident.allocate(m.parse_label_array(LBLS["lb"]))
        a.pump(), b.pump()
        assert ia_web.id == ib_web.id
        assert ia_db.id == ib_db.id
        # node-b never allocated lb, but sees it via watch
        b.pump()
        assert b.registry.get(ia_lb.id) is not None
        assert b.registry.get(ia_lb.id).labels == ia_lb.labels
        # numbering is dense from MIN_USER_IDENTITY
        assert sorted([ia_web.id, ia_db.id, ia_lb.id]) == [256, 257, 258]

    def test_verdicts_identical_across_agents(self, m, agents):
        _store, a, b = agents
        idents = {}
        for k in ("web", "db", "lb", "other"):
            idents[k] = a.ident.allocate(m.parse_label_array(LBLS[k])).id
        b.pump()
        assert {i.id for i in a.registry} == {i.id for i in b.registry}

        cases = [
            (idents["web"], idents["lb"], 80, True),   # allowed by m.rule 1
            (idents["web"], idents["lb"], 443, True),
            (idents["web"], idents["other"], 80, True),
            (idents["db"], idents["web"], 0, False),   # L3 allow, m.rule 2
            (idents["db"], idents["lb"], 0, False),
        ]
        for subj, peer, port, l4 in cases:
            va = a.engine.verdict_one(subj, peer, port, ingress=True, l4=l4)
            vb = b.engine.verdict_one(subj, peer, port, ingress=True, l4=l4)
            assert va == vb, (subj, peer, port, va, vb)
        # sanity: the policy actually differentiates
        assert a.engine.verdict_one(idents["web"], idents["lb"], 80)[0] == 1
        assert a.engine.verdict_one(idents["web"], idents["other"], 80)[0] == 2

    def test_ipcache_converges(self, m, agents):
        _store, a, b = agents
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        a.ipsync.announce("10.1.0.5", web.id, host_ip="192.168.0.1")
        b.pump()
        e = b.ipcache.lookup_by_ip("10.1.0.5")
        assert e is not None and e.identity == web.id and e.host_ip == "192.168.0.1"
        a.ipsync.withdraw("10.1.0.5")
        b.pump()
        assert b.ipcache.lookup_by_ip("10.1.0.5") is None

    def test_lease_death_reallocation(self, m, agents):
        store, a, b = agents
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        a.ipsync.announce("10.1.0.5", web.id)
        b.pump()
        # node-a dies: lease revoked → slave key + ip announcement gone
        store.revoke_lease(a.backend.lease_id)
        b.pump()
        assert b.ipcache.lookup_by_ip("10.1.0.5") is None
        # b's GC does NOT reap while... actually no slave keys remain:
        reaped = b.ident.run_gc()
        assert reaped == [web.id]
        b.pump()
        # b can now re-allocate the same labels — and because numbering
        # restarts from the freed number, convergence is preserved
        web_b = b.ident.allocate(m.parse_label_array(LBLS["web"]))
        assert web_b.id == web.id

    def test_lease_death_with_resync_protects(self, m, agents):
        store, a, b = agents
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        store.revoke_lease(a.backend.lease_id)
        # node-a restarts with a fresh client and resyncs its held keys
        a.backend = m.InMemoryBackend(store, "node-a")
        a.ident.alloc.backend = a.backend
        assert a.ident.resync() >= 1
        assert b.ident.run_gc() == []
        b.pump()
        assert b.registry.get(web.id) is not None


class TestNodeRegistry:
    def test_membership_and_death(self, m):
        store = m.InMemoryStore()
        b1 = m.InMemoryBackend(store, "n1")
        b2 = m.InMemoryBackend(store, "n2")
        events = []
        r1 = m.NodeRegistry(b1, m.Node(name="n1", ipv4="10.0.0.1",
                                   ipv4_alloc_cidr="10.1.0.0/24"))
        r2 = m.NodeRegistry(b2, m.Node(name="n2", ipv4="10.0.0.2",
                                   ipv4_alloc_cidr="10.2.0.0/24"))
        r2.observe(lambda n, present: events.append((n.name, present)))
        r1.pump(), r2.pump()
        assert ("n1", True) in events
        assert {n.name for n in r2.remote_nodes()} == {"n1"}
        assert r2.get("default", "n1").ipv4_alloc_cidr == "10.1.0.0/24"
        # n1 dies → n2 sees the delete
        store.revoke_lease(b1.lease_id)
        r2.pump()
        assert ("n1", False) in events
        assert r2.remote_nodes() == []


class TestClusterMesh:
    def test_remote_cluster_merge_and_remove(self, m):
        # local cluster
        local_store = m.InMemoryStore()
        a = m.Agent(local_store, "node-a")
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))

        # remote cluster with its own kvstore and an agent announcing.
        # It allocates "web" first, so the shared label set lands on the
        # SAME number as locally (both clusters number from 256 in
        # allocation order) and "lb" takes a fresh number.
        remote_store = m.InMemoryStore()
        remote = m.Agent(remote_store, "r-node-1")
        remote.ident.allocate(m.parse_label_array(LBLS["web"]))
        # remote cluster's ipcache announcements live under its own name
        remote_sync = m.IPIdentitySync(remote.backend, remote.ipcache, cluster="east")
        r_lb = remote.ident.allocate(m.parse_label_array(LBLS["lb"]))
        remote_sync.announce("172.16.0.9", r_lb.id)
        m.NodeRegistry(remote.backend, m.Node(name="r1", cluster="east", ipv4="10.9.9.9"))

        nodes_seen = []
        mesh = m.ClusterMesh(
            a.registry, a.ipcache,
            on_node=lambda c, n, p: nodes_seen.append((c, n.name, p)),
        )
        mesh.add_cluster("east", m.InMemoryBackend(remote_store, "node-a-mesh"))
        mesh.pump()

        # remote identity mirrored into the local registry
        assert a.registry.get(r_lb.id) is not None
        assert a.registry.get(r_lb.id).labels == r_lb.labels
        # remote ip mapping merged into the local ipcache
        e = a.ipcache.lookup_by_ip("172.16.0.9")
        assert e is not None and e.identity == r_lb.id
        assert ("east", "r1", True) in nodes_seen

        # the verdict engine can now answer about remote peers: web
        # ingress from remote lb on 80 is allowed by the local policy
        assert a.engine.verdict_one(web.id, r_lb.id, 80)[0] == 1

        # removing the cluster withdraws everything it contributed
        mesh.remove_cluster("east")
        assert a.ipcache.lookup_by_ip("172.16.0.9") is None
        assert a.registry.get(r_lb.id) is None

    def test_colliding_remote_identity_skipped_local_wins(self, m):
        """Two clusters that allocated DIFFERENT labels under the same
        number: the local binding wins and the remote one is skipped
        (the reference logs-and-skips invalid remote cache entries,
        allocator cache.go invalidKey)."""
        local_store = m.InMemoryStore()
        a = m.Agent(local_store, "node-a")
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))  # 256 local

        remote_store = m.InMemoryStore()
        remote = m.Agent(remote_store, "r-node-1")
        r_lb = remote.ident.allocate(m.parse_label_array(LBLS["lb"]))  # 256 remote
        assert r_lb.id == web.id  # the collision under test

        mesh = m.ClusterMesh(a.registry, a.ipcache)
        mesh.add_cluster("east", m.InMemoryBackend(remote_store, "node-a-mesh"))
        mesh.pump()
        assert a.registry.get(web.id).labels == web.labels  # local binding intact
        mesh.remove_cluster("east")
        assert a.registry.get(web.id) is not None  # remove didn't release it

    def test_live_remote_updates_flow_through_pump(self, m):
        local_store = m.InMemoryStore()
        a = m.Agent(local_store, "node-a")
        remote_store = m.InMemoryStore()
        remote = m.Agent(remote_store, "r-node-1")
        mesh = m.ClusterMesh(a.registry, a.ipcache)
        mesh.add_cluster("west", m.InMemoryBackend(remote_store, "node-a-mesh"))
        mesh.pump()
        # allocation happens AFTER the mesh connected
        r_db = remote.ident.allocate(m.parse_label_array(LBLS["db"]))
        mesh.pump()
        assert a.registry.get(r_db.id) is not None


class TestReviewRegressions:
    """Regressions for the r3 review findings on the distributed layer."""

    def test_local_release_after_remote_mirror_keeps_identity(self, m):
        """Local allocate over an already-mirrored remote identity takes
        its own ref: releasing locally must NOT drop the remote hold."""
        store = m.InMemoryStore()
        a, b = m.Agent(store, "node-a"), m.Agent(store, "node-b")
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        b.pump()  # b mirrors web as remote
        assert b.registry.get(web.id) is not None
        web_b = b.ident.allocate(m.parse_label_array(LBLS["web"]))  # local use on b
        assert b.ident.release(web_b) is False
        # still resolvable on b: the remote (node-a) allocation lives
        assert b.registry.get(web.id) is not None

    def test_local_release_remirrors_while_cluster_holds(self, m):
        """Releasing the last LOCAL ref while another node still uses
        the identity keeps a registry row until the master key dies."""
        store = m.InMemoryStore()
        a, b = m.Agent(store, "node-a"), m.Agent(store, "node-b")
        web_a = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        web_b = b.ident.allocate(m.parse_label_array(LBLS["web"]))
        assert web_a.id == web_b.id
        a.ident.release(web_a)
        # a still resolves the identity (b's slave key keeps it alive)
        assert a.registry.get(web_a.id) is not None
        # b releases too; GC reaps; delete event frees a's mirror
        b.ident.release(web_b)
        b.ident.run_gc()
        a.pump()
        assert a.registry.get(web_a.id) is None

    def test_conflicting_watch_event_does_not_crash_pump(self, m):
        """A labels-conflict arriving via watch is skipped, not raised."""
        store = m.InMemoryStore()
        a = m.Agent(store, "node-a")
        # bind DIFFERENT labels locally OUTSIDE the kvstore path, taking
        # the number the kvstore will hand out next (256)
        local = a.registry.allocate(m.parse_label_array(LBLS["db"]))
        b = m.Agent(store, "node-b")
        remote = b.ident.allocate(m.parse_label_array(LBLS["web"]))
        assert remote.id == local.id  # the conflict under test
        a.pump()  # must not raise
        assert a.registry.get(local.id).labels == local.labels

    def test_ipsync_resync_after_lease_loss(self, m):
        store = m.InMemoryStore()
        a, b = m.Agent(store, "node-a"), m.Agent(store, "node-b")
        web = a.ident.allocate(m.parse_label_array(LBLS["web"]))
        a.ipsync.announce("10.1.0.5", web.id, host_ip="192.168.0.1")
        store.revoke_lease(a.backend.lease_id)
        b.pump()
        assert b.ipcache.lookup_by_ip("10.1.0.5") is None
        a.backend = m.InMemoryBackend(store, "node-a")
        a.ipsync.backend = a.backend
        assert a.ipsync.resync() == 1
        b.pump()
        e = b.ipcache.lookup_by_ip("10.1.0.5")
        assert e is not None and e.identity == web.id

    def test_adopt_race_with_gc_cannot_rebind(self, m):
        """Adoption is serialized with GC via the per-key lock and the
        slave key is conditioned on the master key, so an adopted id
        can never be reaped-and-rebound underneath the adopter."""
        Allocator = m.Allocator

        store = m.InMemoryStore()
        a1 = Allocator(m.InMemoryBackend(store, "n1"), "alloc", suffix="n1", min_id=10)
        id1, _ = a1.allocate("k")
        a1.release("k")  # slave gone, master orphaned
        a2 = Allocator(m.InMemoryBackend(store, "n2"), "alloc", suffix="n2", min_id=10)
        # GC runs BEFORE n2 tries to adopt: master reaped → n2 must
        # re-allocate fresh (same number, fresh master), not adopt a
        # dangling id
        assert a1.run_gc() == [id1]
        id2, is_new = a2.allocate("k")
        assert id2 == id1 and is_new
        assert a1.run_gc() == []  # n2's slave protects it now


# -- two agents of each package over one kvstore ----------------------------------

N_EPS = 6
N_FLOWS = 512


def _v6(i: int) -> str:
    return f"fd00:aa::{i + 1:x}"


class ClusterAgent:
    """One agent of a harness world's cluster: its own copy of the
    world's repository, a registry behind a DistributedIdentityAllocator,
    an IPCache behind an IPIdentitySync, an engine and a pipeline."""

    def __init__(self, m, store, name: str, repo, sparse: bool):
        self.m = m
        self.name = name
        self.backend = m.InMemoryBackend(store, name)
        self.repo = repo
        self.registry = m.IdentityRegistry()
        self.ident = m.DistributedIdentityAllocator(self.backend, self.registry, name)
        self.ipcache = m.IPCache()
        self.ipsync = m.IPIdentitySync(self.backend, self.ipcache)
        self.engine = m.PolicyEngine(repo, self.registry, **m.cpu)
        self.sparse = sparse
        self.pipe = None

    def pump(self):
        self.ident.pump()
        self.ipsync.pump()

    def pipeline(self, endpoint_labels, engine=None, sparse=None):
        m = self.m
        pipe = m.DatapathPipeline(engine or self.engine, self.ipcache, m.PreFilter(),
                                  sparse_deltas=self.sparse if sparse is None else sparse,
                                  **m.cpu)
        pipe.set_endpoints([self.registry.lookup_by_labels(m.parse_label_array(lbls)).id
                            for lbls in endpoint_labels])
        pipe.rebuild()
        return pipe


class Cluster:
    """Agents A (sparse deltas off) and B (on) of ``pkg`` over one
    in-memory store, fed the harness world of ``seed``: label set i is
    allocated by A when i is even, else by B, and by the other agent as
    well when i % 3 == 0; its owner upserts its v4 /32 and a v6 /128 and
    announces both. Both agents then register the world's CIDR
    identities locally, in the same order, and pump."""

    def __init__(self, pkg: str, seed: int):
        m = self.m = _ns(pkg)
        self.world = build_world(pkg, seed)
        self.store = m.InMemoryStore()
        self.a = ClusterAgent(m, self.store, "node-a", build_world(pkg, seed).repo, False)
        self.b = ClusterAgent(m, self.store, "node-b", build_world(pkg, seed).repo, True)
        self.labels = [self.world.ident_labels[i.id] for i in self.world.idents]
        self.only_a = []
        for i, lbls in enumerate(self.labels):
            owner, other = (self.a, self.b) if i % 2 == 0 else (self.b, self.a)
            ident = owner.ident.allocate(m.parse_label_array(lbls))
            if i % 3 == 0:
                other.ident.allocate(m.parse_label_array(lbls))
            elif owner is self.a:
                self.only_a.append(ident.id)
            for cidr in (f"{self.world.peer_ips[i]}/32", f"{_v6(i)}/128"):
                owner.ipcache.upsert(cidr, ident.id, source="k8s")
                owner.ipsync.announce(cidr, ident.id, host_ip=f"192.168.0.{1 + (owner is self.b)}")
        local = sorted((c, e.identity) for c, e in self.world.ipcache.items() if e.source == "agent")
        for agent in (self.a, self.b):
            for cidr, num in local:
                cid = agent.registry.allocate(self.world.reg.get(num).labels, local=True)
                agent.ipcache.upsert(cidr, cid.id, source="agent")
        for agent in (self.a, self.b):
            agent.pump()
        # B's endpoints: label sets B allocated itself, so they outlive A
        self.eps = [lb for i, lb in enumerate(self.labels) if i % 2 or i % 3 == 0][:N_EPS]
        for agent in (self.a, self.b):
            agent.pipe = agent.pipeline(self.eps)
        rs = np.random.default_rng(seed)
        self.flows4 = random_flows(self.world, N_FLOWS, N_EPS, seed)
        peers6 = [_v6(i) for i in range(len(self.labels))] + ["2001:db8::1"]
        addr = _mod("cilium_tpu_torch", "ops.lpm").ipv6_to_bytes(peers6)
        pick = rs.integers(0, len(peers6), N_FLOWS)
        self.flows6 = (addr[pick], rs.integers(0, N_EPS, N_FLOWS).astype(np.int32),
                       rs.choice(np.array([0, 80, 443, 53], np.int32), N_FLOWS),
                       np.full(N_FLOWS, 6, np.int32))

    def results(self, pipe):
        """Verdicts and redirects of the v4 and v6 batches, ingress and
        egress, and the per-endpoint counters they leave."""
        pipe.counters[:] = 0
        out = []
        for call, flows in (("process", self.flows4), ("process_v6", self.flows6)):
            for ingress in (True, False):
                out.extend(np.asarray(x) for x in getattr(pipe, call)(*flows, ingress=ingress))
        out.append(np.asarray(pipe.counters).copy())
        return out

    def fresh(self):
        """B's state through a fresh engine (a full compile) and a fresh
        pipeline without sparse deltas."""
        b = self.b
        engine = self.m.PolicyEngine(b.repo, b.registry, **self.m.cpu)
        return b.pipeline(self.eps, engine=engine, sparse=False)


def _registry(agent):
    return {i.id: sorted(str(lb) for lb in i.labels) for i in agent.registry}


def _ipcache(agent):
    return {c: (e.identity, e.source, e.host_ip) for c, e in agent.ipcache.items()}


def _equal(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what} [{k}]")


def _refreshes(m):
    return {k: m.metrics.engine_refreshes_total.get({"kind": k}) for k in ("full", "incremental")}


def _patches(m):
    return {f: m.metrics.lpm_trie_patches_total.get({"family": str(f)}) for f in (4, 6)}


@pytest.mark.parametrize("seed", [0, 1])
def test_two_agents_converge_in_both_packages(seed):
    cl = {pkg: Cluster(pkg, seed) for pkg in PKGS}
    res = {}
    for pkg, c in cl.items():
        assert _registry(c.a) == _registry(c.b), pkg
        assert {k: v[0] for k, v in _ipcache(c.a).items()} == {
            k: v[0] for k, v in _ipcache(c.b).items()}, pkg
        assert _ipcache(c.a) == _ipcache(c.b), pkg
        res[pkg] = {n: c.results(getattr(c, n).pipe) for n in ("a", "b")}
        _equal(res[pkg]["b"], res[pkg]["a"], f"{pkg}: agent B against agent A")
    j, t = (cl[pkg] for pkg in PKGS)
    assert _registry(t.b) == _registry(j.b)
    assert _ipcache(t.b) == _ipcache(j.b)
    _equal(res["cilium_tpu_torch"]["b"], res["cilium_tpu"]["b"], "port against JAX")
    # the policy really differentiates: some lanes forward, some drop
    assert len(np.unique(res["cilium_tpu_torch"]["b"][0])) > 1

    # agent A dies: its announcements leave B's ipcache, and B's rebuild
    # takes them as trie patches (sparse deltas), in both packages alike
    moved = {}
    for pkg, c in cl.items():
        mirrors = dict(c.b.pipe._trie_patch)
        c.store.revoke_lease(c.a.backend.lease_id)
        c.b.pump()
        gone = [k for k in _ipcache(c.a) if k not in _ipcache(c.b)]
        assert len(gone) == 2 * sum(1 for i in range(len(c.labels)) if i % 2 == 0), pkg
        p0 = _patches(c.m)
        c.b.pipe.rebuild()
        moved[pkg] = {f: _patches(c.m)[f] - p0[f] for f in (4, 6)}
        assert all(c.b.pipe._trie_patch[f] is mirrors[f] for f in (4, 6)), pkg
        res[pkg]["death"] = c.results(c.b.pipe)
        _equal(res[pkg]["death"], c.results(c.fresh()), f"{pkg}: B after A's death vs fresh")
    assert moved["cilium_tpu"] == moved["cilium_tpu_torch"]
    assert moved["cilium_tpu_torch"] == {4: len(gone) // 2, 6: len(gone) // 2}
    _equal(res["cilium_tpu_torch"]["death"], res["cilium_tpu"]["death"], "after death: port vs JAX")

    # GC reaps the identities only A held; B takes the release as an
    # identity delta (no full compile), equal to a fresh engine's
    for pkg, c in cl.items():
        reaped = c.b.ident.run_gc()
        assert sorted(reaped) == sorted(c.only_a), pkg
        c.b.pump()
        assert all(c.b.registry.get(i) is None for i in reaped), pkg
        r0 = _refreshes(c.m)
        c.b.engine.refresh()
        r1 = _refreshes(c.m)
        assert r1["full"] == r0["full"] and r1["incremental"] == r0["incremental"] + 1, pkg
        assert [k for _, k, _ in c.b.engine.deltas_since(c.b.pipe._last_delta_seq)] == ["rows"]
        c.b.pipe.rebuild()
        res[pkg]["gc"] = c.results(c.b.pipe)
        _equal(res[pkg]["gc"], c.results(c.fresh()), f"{pkg}: B after GC vs fresh")
    assert _registry(cl["cilium_tpu_torch"].b) == _registry(cl["cilium_tpu"].b)
    _equal(res["cilium_tpu_torch"]["gc"], res["cilium_tpu"]["gc"], "after GC: port vs JAX")
