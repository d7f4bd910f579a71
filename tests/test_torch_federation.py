"""Port parity: the federation plane (``cilium_tpu_torch.federation``).

``identity_plane``, ``epochs`` and ``member`` are host code copied from
the JAX package; ``bootstrap`` is rewritten on torch.distributed and is
tested in ``test_torch_mesh_bootstrap.py``. The reference's
``test_federation.py`` runs here against both packages (the ``m``
fixture): all of ``TestClusterIdentityAllocator`` (reserve/confirm CAS,
contention, partitions on ``FlakyBackend``, backoff, heartbeats, GC) and
``TestEpochExchange``, and the checks of ``TestFederationMember`` that
hold without a daemon, with the member on an agent that carries the
package's own ``IdentityRegistry`` and ``DatapathPipeline`` (the
member's contract: ``daemon.registry`` and
``daemon.pipeline.policy_epoch``; the port's pipeline on the CPU).
``TestFederationMember``'s runtime-option checks, ``TestOffPath`` and
``TestCLISurface`` build a ``Daemon`` or start the CLI and come with
the port's daemon. Timing bounds are the reference's.
"""

from __future__ import annotations

import importlib
import json
import threading
import time
import types

import pytest

from test_torch_harness import PKGS

RULES = [{
    "endpointSelector": {"matchLabels": {"k8s:app": "web"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"k8s:app": "client"}}],
                 "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}]}]}],
    "labels": ["k8s:policy=fed"],
}]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _ns(pkg: str):
    """The names the reference's federation tests import, from ``pkg``."""
    fed = _mod(pkg, "federation")
    kv = _mod(pkg, "kvstore")
    m = types.SimpleNamespace(
        pkg=pkg,
        cpu={"device": "cpu"} if pkg == "cilium_tpu_torch" else {},
        ClusterIdentityAllocator=fed.ClusterIdentityAllocator,
        EpochExchange=fed.EpochExchange,
        FederationError=fed.FederationError,
        FederationMember=fed.FederationMember,
        Allocator=kv.Allocator,
        InMemoryBackend=kv.InMemoryBackend,
        InMemoryStore=kv.InMemoryStore,
        FlakyBackend=kv.FlakyBackend,
        IDENTITIES_PATH=_mod(pkg, "kvstore.paths").IDENTITIES_PATH,
        Backoff=_mod(pkg, "utils.backoff").Backoff,
        Node=_mod(pkg, "nodes.registry").Node,
    )

    def fast_backoff():
        return m.Backoff(min_s=0.001, max_s=0.01, full_jitter=True,
                         max_elapsed_s=5.0)

    def alloc(store, name, **kw):
        kw.setdefault("backoff_factory", fast_backoff)
        kw.setdefault("min_id", 256)
        kw.setdefault("max_id", 4096)
        return m.ClusterIdentityAllocator(
            m.InMemoryBackend(store, name), m.IDENTITIES_PATH, node_name=name, **kw
        )

    m._fast_backoff, m._alloc = fast_backoff, alloc
    return m


@pytest.fixture(params=PKGS)
def m(request):
    return _ns(request.param)


def test_public_names_match():
    for name in ("federation", "federation.identity_plane", "federation.epochs",
                 "federation.member", "federation.bootstrap"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        pj = {n for n in vars(j) if not n.startswith("_")}
        pt = {n for n in vars(t) if not n.startswith("_")}
        if name == "federation.bootstrap":
            # the rewrite: torch in place of jax, the rendezvous' bound
            pj, pt = pj - {"jax"}, pt - {"torch", "datetime", "INIT_TIMEOUT_S"}
        assert pt == pj, name
    assert _mod("cilium_tpu_torch", "federation").__all__ == _mod("cilium_tpu", "federation").__all__


# ---------------------------------------------------------------------------
class TestClusterIdentityAllocator:
    def test_two_nodes_converge_same_key_same_id(self, m):
        store = m.InMemoryStore()
        a, b = m._alloc(store, "a"), m._alloc(store, "b")
        ia, new_a = a.allocate("k8s:app=web")
        ib, new_b = b.allocate("k8s:app=web")
        assert ia == ib
        assert new_a and not new_b
        ic, _ = b.allocate("k8s:app=db")
        assert ic != ia
        st = b.state()
        assert st["allocations"]["adopted"] == 1
        assert st["allocations"]["new"] == 1

    def test_reserve_keys_confirmed_away(self, m):
        store = m.InMemoryStore()
        a = m._alloc(store, "a")
        for i in range(5):
            a.allocate(f"k8s:app=svc-{i}")
        # confirm deletes every reserve; nothing lease-bound leaks
        assert a.backend.list_prefix(a.reserve_prefix) == {}

    def test_reserve_skips_candidate_mid_confirm(self, m):
        """A live reserve (peer mid-confirm) steers id selection away
        from the candidate without any master-CAS burn."""
        store = m.InMemoryStore()
        a = m._alloc(store, "a")
        ghost = m.InMemoryBackend(store, "ghost")
        assert ghost.create_only(
            a.reserve_prefix + "256", b"ghost", lease=True
        )
        id_, is_new = a.allocate("k8s:app=web")
        assert is_new and id_ == 257  # 256 is reserved by the peer

    def test_interop_with_legacy_allocator(self, m):
        """Wire compatibility: a pre-federation m.Allocator node and a
        reserve/confirm node on the same path agree on numbering."""
        store = m.InMemoryStore()
        fed = m._alloc(store, "fed")
        legacy = m.Allocator(
            m.InMemoryBackend(store, "legacy"), m.IDENTITIES_PATH,
            suffix="legacy", min_id=256, max_id=4096,
        )
        i1, _ = legacy.allocate("k8s:app=web")
        i2, _ = fed.allocate("k8s:app=web")      # adopts legacy's master
        i3, _ = fed.allocate("k8s:app=db")       # fresh via reserve/confirm
        i4, _ = legacy.allocate("k8s:app=db")    # adopts fed's master
        assert (i1, i4) == (i2, i3)

    def test_concurrent_contention_no_double_assign(self, m):
        store = m.InMemoryStore()
        a, b = m._alloc(store, "a"), m._alloc(store, "b")
        keys = [f"k8s:app=svc-{i}" for i in range(32)]
        got = {"a": {}, "b": {}}

        def worker(alloc, tag):
            for k in keys:
                got[tag][k] = alloc.allocate(k)[0]

        ts = [threading.Thread(target=worker, args=(a, "a")),
              threading.Thread(target=worker, args=(b, "b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
        assert got["a"] == got["b"]
        ids = list(got["a"].values())
        assert len(set(ids)) == len(ids)  # injective: no double-assign

    def test_partition_retries_ride_backoff(self, m):
        """A partition mid-allocation stalls (bounded) and converges
        once healed, with the retry outcomes accounted."""
        store = m.InMemoryStore()
        a = m._alloc(store, "a")
        flaky = m.FlakyBackend(m.InMemoryBackend(store, "b"))
        b = m.ClusterIdentityAllocator(
            flaky, m.IDENTITIES_PATH, node_name="b",
            min_id=256, max_id=4096, backoff_factory=m._fast_backoff,
        )
        ia, _ = a.allocate("k8s:app=web")
        flaky.fail(True)
        out = {}
        t = threading.Thread(
            target=lambda: out.setdefault("id", b.allocate("k8s:app=web")[0])
        )
        t.start()
        time.sleep(0.03)
        flaky.fail(False)
        t.join(10.0)
        assert out["id"] == ia
        st = b.state()["allocations"]
        assert st.get("retry", 0) >= 1 and st["adopted"] == 1
        assert flaky.op_errors >= 1

    def test_backoff_exhausted_raises_federation_error(self, m):
        store = m.InMemoryStore()
        flaky = m.FlakyBackend(m.InMemoryBackend(store, "b"))
        b = m.ClusterIdentityAllocator(
            flaky, m.IDENTITIES_PATH, node_name="b", min_id=256, max_id=4096,
            backoff_factory=lambda: m.Backoff(
                min_s=0.001, max_s=0.002, full_jitter=True,
                max_elapsed_s=0.02,
            ),
        )
        flaky.fail(True)
        with pytest.raises(m.FederationError):
            b.allocate("k8s:app=web")
        assert b.state()["allocations"]["error"] == 1

    def test_heartbeat_repairs_lease_loss(self, m):
        """Slave AND master keys wiped (what a lease expiry does to the
        lease-bound half, GC to the rest) come back on heartbeat, so
        identities still in local use survive."""
        store = m.InMemoryStore()
        a = m._alloc(store, "a")
        id_, _ = a.allocate("k8s:app=web")
        a.backend.delete(a._slave_key("k8s:app=web"))
        a.backend.delete(a._master_key(id_))
        assert a.get_no_cache("k8s:app=web") == 0
        assert a.heartbeat() == 2  # slave + master re-created
        assert a.get_no_cache("k8s:app=web") == id_

    def test_release_on_lease_expiry_via_gc(self, m):
        """A dead node's slave keys evaporate with its lease; GC then
        reaps the masterless master — release needs no RPC."""
        store = m.InMemoryStore()
        a, b = m._alloc(store, "a"), m._alloc(store, "b")
        id_, _ = b.allocate("k8s:app=ephemeral")
        store.revoke_lease(b.backend.lease_id)  # node b dies
        assert a.run_gc() == [id_]
        assert a.backend.get(a._master_key(id_)) is None

    def test_heartbeat_reaps_own_orphaned_reserves(self, m):
        store = m.InMemoryStore()
        a = m._alloc(store, "a")
        # a crashed confirm's leftover (same node name, not in flight)
        a.backend.update(a.reserve_prefix + "999", b"a", lease=True)
        a.heartbeat()
        assert a.backend.get(a.reserve_prefix + "999") is None


# ---------------------------------------------------------------------------
class TestEpochExchange:
    def _pair(self, m, store):
        ea = {"v": 0}
        eb = {"v": 0}
        xa = m.EpochExchange(m.InMemoryBackend(store, "a"), "node-a",
                           epoch_source=lambda: ea["v"])
        xb = m.EpochExchange(m.InMemoryBackend(store, "b"), "node-b",
                           epoch_source=lambda: eb["v"])
        return (xa, ea), (xb, eb)

    def test_cluster_epoch_is_min_over_fleet(self, m):
        store = m.InMemoryStore()
        (xa, ea), (xb, eb) = self._pair(m, store)
        ea["v"], eb["v"] = 5, 3
        for x in (xa, xb):
            x.publish()
        for x in (xa, xb):
            x.pump()
        assert len(xa.view()) == 2
        assert xa.cluster_epoch() == 3
        assert xa.epoch_lag() == 2 and xb.epoch_lag() == 0

    def test_wait_cluster_epoch_barrier(self, m):
        store = m.InMemoryStore()
        (xa, ea), (xb, eb) = self._pair(m, store)
        ea["v"], eb["v"] = 2, 1
        xb.publish()
        assert not xa.wait_cluster_epoch(
            2, timeout=0.1, min_nodes=2, pump=xb.pump
        )
        eb["v"] = 2
        assert xa.wait_cluster_epoch(
            2, timeout=5.0, min_nodes=2,
            pump=lambda: (xb.publish(), xb.pump()),
        )

    def test_dead_node_drops_from_view(self, m):
        store = m.InMemoryStore()
        (xa, _), (xb, _) = self._pair(m, store)
        for x in (xa, xb):
            x.publish(force=True)
        for x in (xa, xb):
            x.pump()
        assert len(xa.view()) == 2
        store.revoke_lease(xb.store.backend.lease_id)
        xa.pump()
        assert set(r["node"] for r in xa.view().values()) == {"node-a"}


# ---------------------------------------------------------------------------
class Agent:
    """What a FederationMember reads of its daemon: ``registry`` (the
    package's IdentityRegistry) and ``pipeline.policy_epoch`` (the
    package's DatapathPipeline, the port's on the CPU), beside the
    repository, ipcache and engine that pipeline serves."""

    def __init__(self, m):
        self.m = m
        self.repo = _mod(m.pkg, "policy.repository").Repository()
        self.registry = _mod(m.pkg, "identity").IdentityRegistry()
        self.ipcache = _mod(m.pkg, "ipcache.ipcache").IPCache()
        self.engine = _mod(m.pkg, "engine").PolicyEngine(self.repo, self.registry, **m.cpu)
        self.pipeline = _mod(m.pkg, "datapath.pipeline").DatapathPipeline(
            self.engine, self.ipcache, **m.cpu)
        self.endpoints = {}
        self.member = None

    def endpoint_add(self, ep_id: int, labels, ipv4: str):
        """The identity through the member (the ClusterFederation
        identity source), the address into the ipcache, the endpoint
        into the pipeline."""
        lbls = _mod(self.m.pkg, "labels").parse_label_array(labels)
        ident = self.member.allocate(lbls)
        self.ipcache.upsert(ipv4, ident.id, source="agent")
        self.endpoints[ep_id] = ident
        self.pipeline.set_endpoints([i.id for _, i in sorted(self.endpoints.items())])
        return ident

    def endpoint_delete(self, ep_id: int):
        ident = self.endpoints.pop(ep_id)
        self.member.release(ident)
        self.pipeline.set_endpoints([i.id for _, i in sorted(self.endpoints.items())])

    def policy_add(self, rules):
        api = _mod(self.m.pkg, "policy.api")
        self.repo.add_list(api.rules_from_json(json.dumps(rules)))


@pytest.fixture()
def federated(m):
    store = m.InMemoryStore()
    made = []

    def make(name):
        d = Agent(m)
        mem = m.FederationMember(
            d, m.InMemoryBackend(store, name), name,
            heartbeat_interval=3600, backoff_factory=m._fast_backoff,
        )
        d.member = mem
        made.append((d, mem))
        return d, mem

    a = make("node-a")
    b = make("node-b")
    yield store, a, b
    for d, mem in made:
        mem.close()


def _pump_all(*members, rounds: int = 4):
    for _ in range(rounds):
        for mem in members:
            mem.pump()


class TestFederationMember:
    def test_identity_numbering_agrees(self, federated):
        _store, (da, ma), (db, mb) = federated
        da.policy_add(RULES)
        db.policy_add(RULES)
        da.endpoint_add(1, ["k8s:app=web"], ipv4="10.1.0.10")
        db.endpoint_add(2, ["k8s:app=web"], ipv4="10.2.0.20")
        da.endpoint_add(3, ["k8s:app=client"], ipv4="10.1.0.11")
        _pump_all(ma, mb)
        ida = da.endpoints[1].id
        idb = db.endpoints[2].id
        assert ida == idb  # same labels ⇒ same cluster-wide number
        # node-b mirrors node-a's client identity for row coverage
        idc = da.endpoints[3].id
        assert db.registry.get(idc) is not None

    def test_cluster_policy_epoch_converges(self, federated):
        _store, (da, ma), (db, mb) = federated
        da.endpoint_add(1, ["k8s:app=web"], ipv4="10.1.0.10")
        db.endpoint_add(2, ["k8s:app=web"], ipv4="10.2.0.20")
        for d in (da, db):
            d.pipeline.rebuild()          # baseline generation
            d.pipeline.set_epoch_swap(True)
        da.policy_add(RULES)  # the delta that swaps
        db.policy_add(RULES)
        for d in (da, db):
            d.pipeline.rebuild()          # kick the shadow build
            assert d.pipeline.wait_epoch_swap(timeout=30.0)
        assert da.pipeline.policy_epoch >= 1
        assert ma.wait_cluster_epoch(
            timeout=10.0, min_nodes=2,
            pump=lambda: mb.pump(),
        )
        st = ma.status()
        assert st["epoch_lag"] == 0
        assert st["cluster_epoch"] >= 1

    def test_cluster_status_surface(self, federated):
        _store, (da, ma), (db, mb) = federated
        _pump_all(ma, mb)
        st = ma.status()
        assert st["joined"]
        assert st["node_count"] == 2
        assert {n["node"] for n in st["nodes"]} == {"node-a", "node-b"}
        assert "identities" in st

    def test_release_keeps_remote_rows_covered(self, federated):
        _store, (da, ma), (db, mb) = federated
        da.endpoint_add(1, ["k8s:app=web"], ipv4="10.1.0.10")
        db.endpoint_add(2, ["k8s:app=web"], ipv4="10.2.0.20")
        _pump_all(ma, mb)
        ident = da.endpoints[1]
        da.endpoint_delete(1)
        _pump_all(ma, mb)
        # node-b still uses the number → node-a keeps the row mirrored
        assert da.registry.get(ident.id) is not None

    def test_node_descriptor_rides_epoch_record(self, m):
        store = m.InMemoryStore()
        d = Agent(m)
        mem = m.FederationMember(
            d, m.InMemoryBackend(store, "c"), "node-c",
            descriptor=m.Node(name="node-c", ipv4="192.168.0.3",
                              ipv4_alloc_cidr="10.3.0.0/16"),
            heartbeat_interval=3600, backoff_factory=m._fast_backoff,
        )
        mem.pump()
        (rec,) = mem.epochs.view().values()
        assert rec["ipv4"] == "192.168.0.3"
        assert rec["ipv4_alloc_cidr"] == "10.3.0.0/16"
        assert rec["policy_epoch"] == 0
        mem.close()
