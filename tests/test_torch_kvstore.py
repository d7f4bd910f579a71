"""Port parity: the kvstore fabric (``cilium_tpu_torch.kvstore``).

``paths``, ``backend``, ``store``, ``allocator``, ``filestore``,
``netstore``, ``clustermesh`` are host code copied from the JAX
package. The reference's kvstore tests run here against both packages
(the ``kv`` fixture): all of ``test_kvstore.py`` (CAS, leases, locks,
watch, the master/slave allocator, ``SharedStore``), all of
``test_filestore_mesh.py`` (the sqlite backend across processes,
``FlakyBackend`` outages, remote services over clustermesh) and the
tests of ``test_netstore.py`` that build no ``Daemon`` and start no CLI
(``KVStoreServer`` / ``NetBackend`` over TCP, durability, endpoint
failover, host:port parsing, the snapshot regressions). Its other five
(two daemons over TCP, the CLI's ``kvstore serve`` process, the outage
recovery of two ``ClusterNode`` agents, three real processes) come with
the port's daemon. Timing bounds are the reference's.
"""

from __future__ import annotations

import importlib
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest

from test_torch_harness import PKGS

REPO = pathlib.Path(__file__).resolve().parent.parent


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def kv(request):
    """One package's kvstore names, its lb service names, its netstore
    module and the device keyword its entry points need on the CPU."""
    pkg = request.param
    kvs = _mod(pkg, "kvstore")
    lb = _mod(pkg, "lb")
    ns = types.SimpleNamespace(**{n: getattr(kvs, n) for n in kvs.__all__})
    ns.pkg = pkg
    ns.netstore = _mod(pkg, "kvstore.netstore")
    ns.Backend, ns.L3n4Addr, ns.ServiceManager = lb.Backend, lb.L3n4Addr, lb.ServiceManager
    ns.cpu = {"device": "cpu"} if pkg == "cilium_tpu_torch" else {}
    return ns


def test_public_names_match():
    for name in ("kvstore", "kvstore.paths", "kvstore.backend", "kvstore.store",
                 "kvstore.allocator", "kvstore.filestore", "kvstore.netstore",
                 "kvstore.clustermesh"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        assert sorted(n for n in vars(t) if not n.startswith("_")) == sorted(
            n for n in vars(j) if not n.startswith("_")), name
    assert _mod("cilium_tpu_torch", "kvstore").__all__ == _mod("cilium_tpu", "kvstore").__all__


# -- test_kvstore.py ------------------------------------------------------------

@pytest.fixture()
def store(kv):
    return kv.InMemoryStore()


class TestBackendOps:
    def test_get_set_delete(self, kv, store):
        b = kv.InMemoryBackend(store, "n1")
        assert b.get("k") is None
        b.set("k", b"v")
        assert b.get("k") == b"v"
        b.delete("k")
        assert b.get("k") is None

    def test_create_only_is_cas(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        b2 = kv.InMemoryBackend(store, "n2")
        assert b1.create_only("key", b"a")
        assert not b2.create_only("key", b"b")
        assert b2.get("key") == b"a"

    def test_create_if_exists(self, kv, store):
        b = kv.InMemoryBackend(store, "n1")
        assert not b.create_if_exists("cond", "k", b"v")
        b.set("cond", b"x")
        assert b.create_if_exists("cond", "k", b"v")
        assert b.get("k") == b"v"

    def test_list_and_get_prefix(self, kv, store):
        b = kv.InMemoryBackend(store, "n1")
        b.set("p/a", b"1")
        b.set("p/b", b"2")
        b.set("q/c", b"3")
        assert b.list_prefix("p/") == {"p/a": b"1", "p/b": b"2"}
        assert b.get_prefix("p/") == ("p/a", b"1")
        b.delete_prefix("p/")
        assert b.list_prefix("p/") == {}

    def test_lease_revoke_deletes_keys(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        b2 = kv.InMemoryBackend(store, "n2")
        b1.update("mine", b"v", lease=True)
        b1.set("durable", b"v")
        store.revoke_lease(b1.lease_id)
        assert b2.get("mine") is None
        assert b2.get("durable") == b"v"

    def test_ops_after_lease_expiry_fail(self, kv, store):
        b = kv.InMemoryBackend(store, "n1")
        store.revoke_lease(b.lease_id)
        with pytest.raises(RuntimeError):
            b.update("k", b"v", lease=True)

    def test_lock_mutual_exclusion(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        b2 = kv.InMemoryBackend(store, "n2")
        lock = b1.lock_path("locks/x")
        with pytest.raises(kv.LockTimeout):
            b2.lock_path("locks/x", timeout=0.05)
        lock.unlock()
        b2.lock_path("locks/x", timeout=0.5).unlock()

    def test_lock_released_by_lease_death(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        b2 = kv.InMemoryBackend(store, "n2")
        b1.lock_path("locks/x")
        store.revoke_lease(b1.lease_id)  # owner dies holding the lock
        b2.lock_path("locks/x", timeout=0.5).unlock()


class TestWatch:
    def test_list_then_stream(self, kv, store):
        b = kv.InMemoryBackend(store, "n1")
        b.set("w/a", b"1")
        w = b.list_and_watch("t", "w/")
        evs = w.drain()
        assert [(e.typ, e.key) for e in evs] == [
            (kv.EventTypeCreate, "w/a"),
            (kv.EventTypeListDone, ""),
        ]
        b.set("w/b", b"2")
        b.set("w/a", b"3")
        b.delete("w/b")
        evs = w.drain()
        assert [(e.typ, e.key) for e in evs] == [
            (kv.EventTypeCreate, "w/b"),
            (kv.EventTypeModify, "w/a"),
            (kv.EventTypeDelete, "w/b"),
        ]

    def test_watch_sees_lease_expiry_as_delete(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        b2 = kv.InMemoryBackend(store, "n2")
        b1.update("w/x", b"v", lease=True)
        w = b2.list_and_watch("t", "w/")
        w.drain()
        store.revoke_lease(b1.lease_id)
        evs = w.drain()
        assert [(e.typ, e.key) for e in evs] == [(kv.EventTypeDelete, "w/x")]

    def test_no_events_across_prefixes(self, kv, store):
        b = kv.InMemoryBackend(store, "n1")
        w = b.list_and_watch("t", "a/")
        w.drain()
        b.set("b/k", b"v")
        assert w.drain() == []


class TestAllocator:
    def test_same_key_same_id_across_nodes(self, kv, store):
        a1 = kv.Allocator(kv.InMemoryBackend(store, "n1"), "alloc", suffix="n1", min_id=256)
        a2 = kv.Allocator(kv.InMemoryBackend(store, "n2"), "alloc", suffix="n2", min_id=256)
        id1, new1 = a1.allocate("k8s:app=web;")
        id2, new2 = a2.allocate("k8s:app=web;")
        assert id1 == id2 == 256
        assert new1 and not new2
        id3, _ = a2.allocate("k8s:app=db;")
        assert id3 == 257

    def test_local_refcount(self, kv, store):
        a = kv.Allocator(kv.InMemoryBackend(store, "n1"), "alloc", suffix="n1", min_id=10)
        id1, _ = a.allocate("k")
        id2, new = a.allocate("k")
        assert id1 == id2 and not new
        assert not a.release("k")  # rc 2 → 1
        assert a.release("k")  # rc 1 → 0, slave key gone
        assert a.get_no_cache("k") == 0

    def test_gc_reaps_orphaned_master(self, kv, store):
        a1 = kv.Allocator(kv.InMemoryBackend(store, "n1"), "alloc", suffix="n1", min_id=10)
        id1, _ = a1.allocate("k")
        a1.release("k")
        reaped = a1.run_gc()
        assert reaped == [id1]
        # number is reusable afterwards
        id2, _ = a1.allocate("other")
        assert id2 == id1

    def test_gc_spares_ids_with_live_slaves(self, kv, store):
        a1 = kv.Allocator(kv.InMemoryBackend(store, "n1"), "alloc", suffix="n1", min_id=10)
        a2 = kv.Allocator(kv.InMemoryBackend(store, "n2"), "alloc", suffix="n2", min_id=10)
        id1, _ = a1.allocate("k")
        a2.allocate("k")
        a1.release("k")
        assert a1.run_gc() == []  # n2 still holds it
        assert a2.get("k") == id1

    def test_lease_death_then_resync_reallocates(self, kv, store):
        """Kill a node's lease: its slave keys evaporate; resync
        re-creates them before GC can reap the id (the VERDICT's
        'kill one lease and show re-allocation')."""
        b1 = kv.InMemoryBackend(store, "n1")
        a1 = kv.Allocator(b1, "alloc", suffix="n1", min_id=10)
        id1, _ = a1.allocate("k")
        store.revoke_lease(b1.lease_id)
        assert a1.get_no_cache("k") == 0  # slave key gone cluster-wide
        # node restarts: new client, same held local keys
        a1.backend = kv.InMemoryBackend(store, "n1")
        fixed = a1.resync_local_keys()
        assert fixed >= 1
        assert a1.get_no_cache("k") == id1
        assert a1.run_gc() == []  # protected again

    def test_lease_death_without_resync_is_reaped(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        a1 = kv.Allocator(b1, "alloc", suffix="n1", min_id=10)
        id1, _ = a1.allocate("k")
        store.revoke_lease(b1.lease_id)
        gc_runner = kv.Allocator(
            kv.InMemoryBackend(store, "gc"), "alloc", suffix="gc", min_id=10
        )
        assert gc_runner.run_gc() == [id1]

    def test_watch_cache_follows_remote_allocations(self, kv, store):
        a1 = kv.Allocator(kv.InMemoryBackend(store, "n1"), "alloc", suffix="n1", min_id=10)
        a2 = kv.Allocator(kv.InMemoryBackend(store, "n2"), "alloc", suffix="n2", min_id=10)
        id1, _ = a1.allocate("k")
        a2.pump()
        assert a2.cache_items() == {id1: "k"}
        assert a2.get_by_id(id1) == "k"

    def test_concurrent_allocation_distinct_keys(self, kv, store):
        """8 threads × 2 nodes allocating 16 keys: every key converges
        to one id, no id double-assigned (the CAS race the master-key
        CreateOnly exists for)."""
        nodes = [
            kv.Allocator(kv.InMemoryBackend(store, f"n{i}"), "alloc", suffix=f"n{i}",
                      min_id=100)
            for i in range(2)
        ]
        keys = [f"key-{i}" for i in range(16)]
        results = {}
        lock = threading.Lock()

        def worker(alloc, ks):
            for k in ks:
                id_, _ = alloc.allocate(k)
                with lock:
                    results.setdefault(k, set()).add(id_)

        threads = [
            threading.Thread(target=worker, args=(nodes[t % 2], keys))
            for t in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(len(v) == 1 for v in results.values()), results
        ids = [next(iter(v)) for v in results.values()]
        assert len(set(ids)) == len(keys)


class TestSharedStore:
    def test_replication_and_delete(self, kv, store):
        s1 = kv.SharedStore(kv.InMemoryBackend(store, "n1"), "nodes")
        s2 = kv.SharedStore(kv.InMemoryBackend(store, "n2"), "nodes")
        s1.update_local_key_sync("default/n1", {"name": "n1"})
        s2.pump()
        assert s2.shared == {"default/n1": {"name": "n1"}}
        s1.delete_local_key("default/n1")
        s2.pump()
        assert s2.shared == {}

    def test_lease_death_and_anti_entropy(self, kv, store):
        b1 = kv.InMemoryBackend(store, "n1")
        s1 = kv.SharedStore(b1, "nodes")
        s2 = kv.SharedStore(kv.InMemoryBackend(store, "n2"), "nodes")
        s1.update_local_key_sync("default/n1", {"name": "n1"})
        store.revoke_lease(b1.lease_id)
        s2.pump()
        assert s2.shared == {}
        # restart: new backend client, periodic sync re-publishes
        s1.backend = kv.InMemoryBackend(store, "n1")
        assert s1.sync_local_keys() == 1
        s2.pump()
        assert "default/n1" in s2.shared

    def test_observers_fire(self, kv, store):
        seen = []
        kv.SharedStore(
            kv.InMemoryBackend(store, "n2"), "svc",
            on_update=lambda n, v: seen.append(("u", n)),
            on_delete=lambda n, v: seen.append(("d", n)),
        )
        s1 = kv.SharedStore(kv.InMemoryBackend(store, "n1"), "svc")
        s1.update_local_key_sync("a", {"x": 1})
        s1.delete_local_key("a")
        # the observing store must pump to apply
        # (fresh store created above is collected: re-create properly)
        s2 = kv.SharedStore(
            kv.InMemoryBackend(store, "n3"), "svc",
            on_update=lambda n, v: seen.append(("u", n)),
            on_delete=lambda n, v: seen.append(("d", n)),
        )
        s1.update_local_key_sync("b", {"x": 2})
        s2.pump()
        assert ("u", "b") in seen


# -- test_filestore_mesh.py -----------------------------------------------------

class TestFileBackend:
    def test_crud_and_watch(self, kv, tmp_path):
        db = str(tmp_path / "kv.db")
        b1 = kv.FileBackend(db, "n1")
        b2 = kv.FileBackend(db, "n2")
        try:
            assert b1.create_only("a/x", b"1")
            assert not b2.create_only("a/x", b"2")  # CAS across clients
            assert b2.get("a/x") == b"1"
            w = b2.list_and_watch("w", "a/")
            evs = w.drain()
            assert [e.typ for e in evs] == [kv.EventTypeCreate, kv.EventTypeListDone]
            b1.set("a/y", b"3")
            b1.delete("a/x")
            deadline = time.time() + 5
            got = []
            while time.time() < deadline and len(got) < 2:
                got.extend(w.drain())
                time.sleep(0.02)
            assert [(e.typ, e.key) for e in got] == [
                (kv.EventTypeCreate, "a/y"), (kv.EventTypeDelete, "a/x"),
            ]
            assert b1.list_prefix("a/") == {"a/y": b"3"}
        finally:
            b1.close()
            b2.close()

    def test_lease_death_removes_keys(self, kv, tmp_path):
        db = str(tmp_path / "kv.db")
        b1 = kv.FileBackend(db, "n1", lease_ttl=0.3)
        b2 = kv.FileBackend(db, "n2")
        try:
            b1.update("nodes/n1", b"alive", lease=True)
            assert b2.get("nodes/n1") == b"alive"
            # kill n1's keepalive (simulated agent death) and wait out
            # the TTL: any other client's next op sweeps the key
            b1._closed.set()
            time.sleep(0.6)
            assert b2.get("nodes/n1") is None
        finally:
            b1.close()
            b2.close()

    def test_locks(self, kv, tmp_path):
        db = str(tmp_path / "kv.db")
        b1 = kv.FileBackend(db, "n1")
        b2 = kv.FileBackend(db, "n2")
        try:
            lock = b1.lock_path("ids", timeout=2.0)
            with pytest.raises(kv.LockTimeout):
                b2.lock_path("ids", timeout=0.3)
            lock.unlock()
            b2.lock_path("ids", timeout=2.0).unlock()
        finally:
            b1.close()
            b2.close()

    def test_cross_process(self, kv, tmp_path):
        """A REAL second process allocates through the same file —
        identity numbering converges across process boundaries."""
        db = str(tmp_path / "kv.db")
        b1 = kv.FileBackend(db, "p1")
        try:
            a1 = kv.Allocator(b1, "alloc", suffix="p1", min_id=256, max_id=400)
            id_web, _ = a1.allocate("k8s:app=web")
            script = textwrap.dedent(f"""
                import sys
                sys.path.insert(0, {str(REPO)!r})
                from {kv.pkg}.kvstore import FileBackend, Allocator
                b = FileBackend({db!r}, "p2")
                a = Allocator(b, "alloc", suffix="p2", min_id=256, max_id=400)
                id_web, created = a.allocate("k8s:app=web")
                id_db, _ = a.allocate("k8s:app=db")
                print(id_web, int(created), id_db)
                b.close()
            """)
            out = subprocess.run(
                [sys.executable, "-c", script], capture_output=True,
                text=True, timeout=60,
                env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
            )
            assert out.returncode == 0, out.stderr[-500:]
            remote_web, created, remote_db = out.stdout.split()
            # same key ⇒ same id across processes; new key ⇒ distinct
            assert int(remote_web) == id_web and created == "0"
            assert int(remote_db) != id_web
            # the file watcher POLLS (poll_interval 50ms): give the
            # other process's write time to land in b1's event queue
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                a1.pump()
                if a1.get("k8s:app=db") == int(remote_db):
                    break
                time.sleep(0.05)
            assert a1.get("k8s:app=db") == int(remote_db)
        finally:
            b1.close()


class TestOutage:
    def test_allocator_survives_kvstore_outage(self, kv):
        store = kv.InMemoryStore()
        flaky = kv.FlakyBackend(kv.InMemoryBackend(store, "n1"))
        a = kv.Allocator(flaky, "alloc", suffix="n1", min_id=256, max_id=400)
        id1, _ = a.allocate("k8s:app=web")
        flaky.fail(True)
        # during the outage: local cache still answers, new allocation
        # fails loudly (no silent split-brain numbering)
        assert a.get("k8s:app=web") == id1
        with pytest.raises(Exception):
            a.allocate("k8s:app=db")
        assert flaky.op_errors > 0
        # recovery: allocation works again and numbering is unchanged
        flaky.fail(False)
        id2, _ = a.allocate("k8s:app=db")
        assert id2 != id1
        assert a.get("k8s:app=web") == id1


class TestRemoteServices:
    def _mesh_world(self, kv):
        IdentityRegistry = _mod(kv.pkg, "identity").IdentityRegistry
        IPCache = _mod(kv.pkg, "ipcache.ipcache").IPCache
        ClusterMesh = kv.ClusterMesh

        remote_store = kv.InMemoryStore()
        remote_backend = kv.InMemoryBackend(remote_store, "remote-agent")
        local_services = kv.ServiceManager()
        fe = kv.L3n4Addr("10.96.0.10", 80, "TCP")
        local_services.upsert(fe, [kv.Backend("10.0.0.3", 8080)])
        mesh = ClusterMesh(
            IdentityRegistry(), IPCache(), services=local_services
        )
        return remote_store, remote_backend, local_services, mesh, fe

    def test_remote_backend_merge_and_withdraw(self, kv):
        remote_store, remote_backend, services, mesh, fe = self._mesh_world(kv)
        # the remote cluster exports its services
        remote_services = kv.ServiceManager()
        remote_services.upsert(fe, [kv.Backend("172.20.0.9", 8080)])
        remote_services.export_to_store(remote_backend, "cluster-b")
        mesh.add_cluster("cluster-b", kv.InMemoryBackend(remote_store, "local"))
        mesh.pump()
        backs = {b.ip for b in services.effective_backends(fe)}
        assert backs == {"10.0.0.3", "172.20.0.9"}  # merged
        # remote backend set changes → merge follows
        remote_services.upsert(fe, [kv.Backend("172.20.0.10", 8080)])
        remote_services.export_to_store(remote_backend, "cluster-b")
        mesh.pump()
        backs = {b.ip for b in services.effective_backends(fe)}
        assert backs == {"10.0.0.3", "172.20.0.10"}
        # removing the cluster withdraws every merged backend
        mesh.remove_cluster("cluster-b")
        assert {b.ip for b in services.effective_backends(fe)} == {"10.0.0.3"}

    def test_remote_only_frontends_not_served(self, kv):
        remote_store, remote_backend, services, mesh, fe = self._mesh_world(kv)
        remote_services = kv.ServiceManager()
        other = kv.L3n4Addr("10.96.0.99", 80, "TCP")
        remote_services.upsert(other, [kv.Backend("172.20.0.9", 8080)])
        remote_services.export_to_store(remote_backend, "cluster-b")
        mesh.add_cluster("cluster-b", kv.InMemoryBackend(remote_store, "local"))
        mesh.pump()
        # the local cluster has no such frontend → not programmed
        tables = services.build_device(**kv.cpu)[4]
        assert not (np.asarray(tables.fe_bytes) == np.array(
            [10, 96, 0, 99], np.int32
        )).all(axis=1).any()

    def test_export_is_lease_bound(self, kv):
        store = kv.InMemoryStore()
        agent = kv.InMemoryBackend(store, "agent-b")
        sm = kv.ServiceManager()
        sm.upsert(kv.L3n4Addr("10.96.0.10", 80, "TCP"), [kv.Backend("10.0.0.1", 80)])
        sm.export_to_store(agent, "cluster-b")
        reader = kv.InMemoryBackend(store, "reader")
        prefix = "cilium/state/services/v1/exports/cluster-b/"
        assert len(reader.list_prefix(prefix)) == 1
        store.revoke_lease(agent.lease_id)  # agent dies
        assert reader.list_prefix(prefix) == {}


# -- test_netstore.py (the tests that build no Daemon and start no CLI) --------

@pytest.fixture()
def server(kv):
    srv = kv.KVStoreServer(lease_ttl=1.0).start()
    yield srv
    srv.stop()


def _drain_until(w, typ, key=None, timeout=5.0):
    deadline = time.monotonic() + timeout
    got = []
    while time.monotonic() < deadline:
        ev = w.next(timeout=0.2)
        if ev is None:
            continue
        got.append(ev)
        if ev.typ == typ and (key is None or ev.key == key):
            return got
    raise AssertionError(f"no {typ} event for {key!r}; saw {got}")


class TestNetBackend:
    def test_crud_and_cas_across_clients(self, kv, server):
        a = kv.NetBackend(server.url, "node-a")
        b = kv.NetBackend(server.url, "node-b")
        try:
            a.set("cilium/state/k1", b"v1")
            assert b.get("cilium/state/k1") == b"v1"
            # CAS: only one creator wins
            assert a.create_only("cilium/ids/5", b"labels-a") is True
            assert b.create_only("cilium/ids/5", b"labels-b") is False
            assert b.get("cilium/ids/5") == b"labels-a"
            assert b.create_if_exists(
                "cilium/ids/5", "cilium/ids/5/slave", b"x"
            ) is True
            assert a.create_if_exists(
                "cilium/ids/404", "cilium/ids/404/slave", b"x"
            ) is False
            assert sorted(a.list_prefix("cilium/ids/")) == [
                "cilium/ids/5", "cilium/ids/5/slave",
            ]
            assert a.get_prefix("cilium/state/") == ("cilium/state/k1", b"v1")
            b.delete_prefix("cilium/ids/")
            assert a.list_prefix("cilium/ids/") == {}
        finally:
            a.close()
            b.close()

    def test_watch_streams_across_clients(self, kv, server):
        a = kv.NetBackend(server.url, "node-a")
        b = kv.NetBackend(server.url, "node-b")
        try:
            a.set("cilium/nodes/pre", b"existing")
            w = b.list_and_watch("nodes", "cilium/nodes/")
            evs = _drain_until(w, kv.EventTypeListDone)
            assert [(e.typ, e.key) for e in evs] == [
                (kv.EventTypeCreate, "cilium/nodes/pre"),
                (kv.EventTypeListDone, ""),
            ]
            a.update("cilium/nodes/n1", b"hello", lease=True)
            _drain_until(w, kv.EventTypeCreate, "cilium/nodes/n1")
            a.delete("cilium/nodes/n1")
            _drain_until(w, kv.EventTypeDelete, "cilium/nodes/n1")
            b.stop_watcher(w)
        finally:
            a.close()
            b.close()

    def test_close_revokes_lease_keys(self, kv, server):
        a = kv.NetBackend(server.url, "node-a")
        b = kv.NetBackend(server.url, "node-b")
        try:
            w = b.list_and_watch("nodes", "cilium/nodes/")
            _drain_until(w, kv.EventTypeListDone)
            a.update("cilium/nodes/a", b"announce", lease=True)
            a.set("cilium/persist/a", b"durable")
            _drain_until(w, kv.EventTypeCreate, "cilium/nodes/a")
            a.close()  # connection death == lease revocation
            _drain_until(w, kv.EventTypeDelete, "cilium/nodes/a")
            assert b.get("cilium/persist/a") == b"durable"  # no lease: stays
        finally:
            b.close()

    def test_keepalive_timeout_expires_lease(self, kv, server):
        """A client whose keepalive goes silent (hung process, dropped
        network) loses its lease at TTL even while TCP lingers."""
        a = kv.NetBackend(server.url, "node-a")
        b = kv.NetBackend(server.url, "node-b")
        try:
            a.update("cilium/nodes/a", b"announce", lease=True)
            a._closed.set()  # kill keepalive loop only; socket stays up
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if b.get("cilium/nodes/a") is None:
                    break
                time.sleep(0.1)
            assert b.get("cilium/nodes/a") is None
        finally:
            a.close()
            b.close()

    def test_locks_mutually_exclude(self, kv, server):
        a = kv.NetBackend(server.url, "node-a")
        b = kv.NetBackend(server.url, "node-b")
        try:
            l1 = a.lock_path("cilium/locks/x", timeout=2.0)
            with pytest.raises(kv.LockTimeout):
                b.lock_path("cilium/locks/x", timeout=0.3)
            l1.unlock()
            b.lock_path("cilium/locks/x", timeout=2.0).unlock()
        finally:
            a.close()
            b.close()

    def test_ops_fail_fast_after_server_stop(self, kv, server):
        a = kv.NetBackend(server.url, "node-a")
        server.stop()
        with pytest.raises((ConnectionError, TimeoutError)):
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                a.set("k", b"v")
                time.sleep(0.05)
        assert "unreachable" in a.status() or "net:" in a.status()
        a.close()


class TestDistributedOverNet:
    def test_allocator_cas_agreement(self, kv, server):
        """Two agents on different 'hosts' allocate the same labels →
        one identity (the etcd CAS master-key contract)."""
        a = kv.Allocator(kv.NetBackend(server.url, "node-a"),
                      "cilium/state/identities", suffix="node-a")
        b = kv.Allocator(kv.NetBackend(server.url, "node-b"),
                      "cilium/state/identities", suffix="node-b")
        try:
            id_a, new_a = a.allocate("k8s:app=web;k8s:env=prod")
            id_b, new_b = b.allocate("k8s:app=web;k8s:env=prod")
            assert id_a == id_b
            assert new_a and not new_b
            id_c, _ = b.allocate("k8s:app=db")
            assert id_c != id_a
        finally:
            a.close()
            b.close()

class TestDurability:
    def test_snapshot_survives_restart(self, kv, tmp_path):
        """Non-lease keys persist across a server restart (the etcd
        durability role); lease-bound keys are deliberately NOT
        restored — their owners' sessions died with the old server."""
        state = str(tmp_path / "kv.json")
        srv = kv.KVStoreServer(lease_ttl=1.0, state_path=state).start()
        a0 = kv.Allocator(kv.NetBackend(srv.url, "a"), "cilium/state/identities",
                       suffix="a")
        first, created0 = a0.allocate("k8s:app=web")
        assert created0
        c = kv.NetBackend(srv.url, "x")
        c.update("cilium/nodes/a", b"announce", lease=True)
        c.close()
        a0.close()
        srv.stop()  # writes the final snapshot

        srv2 = kv.KVStoreServer(lease_ttl=1.0, state_path=state).start()
        try:
            c2 = kv.NetBackend(srv2.url, "b")
            assert c2.get("cilium/nodes/a") is None  # lease-bound: gone
            # identity numbering stays stable across the restart: the
            # CAS finds the persisted master key instead of re-minting
            a = kv.Allocator(c2, "cilium/state/identities", suffix="b")
            ident, created = a.allocate("k8s:app=web")
            assert ident == first and not created
            a.close()
        finally:
            srv2.stop()

    def test_corrupt_snapshot_starts_empty(self, kv, tmp_path):
        state = tmp_path / "kv.json"
        state.write_text("{not json")
        srv = kv.KVStoreServer(state_path=str(state)).start()
        try:
            c = kv.NetBackend(srv.url, "a")
            assert c.list_prefix("") == {}
            c.close()
        finally:
            srv.stop()


class TestEndpointFailover:
    def test_backend_from_target_tries_endpoints_in_order(self, kv, server):
        backend_from_target = kv.netstore.backend_from_target

        # first endpoint dead, second alive → connects to the second
        be = backend_from_target(
            f"tcp://127.0.0.1:1,{server.url}", "node-a"
        )
        be.set("k", b"v")
        assert be.get("k") == b"v"
        be.close()
        with pytest.raises(ConnectionError):
            backend_from_target("tcp://127.0.0.1:1,tcp://127.0.0.1:2", "x")


def test_snapshot_persists_deletions(kv, tmp_path):
    """A durable DELETE must dirty the snapshot: the deleted key stays
    gone after a restart (regression: a dirty-check keyed on surviving
    keys' revisions resurrected deletions)."""
    state = str(tmp_path / "kv.json")
    srv = kv.KVStoreServer(state_path=state, snapshot_interval=3600).start()
    c = kv.NetBackend(srv.url, "a")
    c.set("cilium/a", b"1")
    c.set("cilium/b", b"2")
    srv._write_snapshot()
    c.delete("cilium/a")
    c.close()
    srv.stop()  # final snapshot must notice the delete
    srv2 = kv.KVStoreServer(state_path=state).start()
    try:
        c2 = kv.NetBackend(srv2.url, "b")
        assert c2.get("cilium/a") is None
        assert c2.get("cilium/b") == b"2"
        c2.close()
    finally:
        srv2.stop()


def test_snapshot_sees_durable_to_leased_transition(kv, tmp_path):
    """Re-writing a durable key WITH a lease moves it out of the
    durable set; the snapshot dirty-check must notice (regression: the
    old-entry lease check ran after the mutation and never fired)."""
    state = str(tmp_path / "kv.json")
    srv = kv.KVStoreServer(state_path=state, snapshot_interval=3600).start()
    c = kv.NetBackend(srv.url, "a")
    c.set("cilium/x", b"durable")
    srv._write_snapshot()  # snapshot contains x
    c.update("cilium/x", b"leased-now", lease=True)
    c.close()  # lease dies; key should be fully gone
    srv.stop()
    srv2 = kv.KVStoreServer(state_path=state).start()
    try:
        c2 = kv.NetBackend(srv2.url, "b")
        assert c2.get("cilium/x") is None, "stale durable copy resurrected"
        c2.close()
    finally:
        srv2.stop()


class TestHostPortParsing:
    """ADVICE r04: IPv6 listeners — [host]:port syntax, AF from host."""

    def test_parse_hostport(self, kv):
        parse_hostport = kv.netstore.parse_hostport

        assert parse_hostport("127.0.0.1:4240") == ("127.0.0.1", 4240)
        assert parse_hostport("[::1]:4240") == ("::1", 4240)
        assert parse_hostport("[2001:db8::2]:80") == ("2001:db8::2", 80)
        # empty host is the caller's default (CLI binds 127.0.0.1)
        assert parse_hostport(":4240") == ("", 4240)
        for bad in ("::1:4240", "host", "[::1]", "[::1]:x", "h:p",
                    "[]:4240", "127.0.0.1:99999"):
            with pytest.raises(ValueError):
                parse_hostport(bad)

    @pytest.mark.skipif(
        not socket.has_ipv6, reason="host has no IPv6 support"
    )
    def test_ipv6_server_roundtrip(self, kv):
        try:
            probe = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
            probe.bind(("::1", 0))
            probe.close()
        except OSError:
            pytest.skip("::1 not bindable on this host")
        srv = kv.KVStoreServer(host="::1").start()
        try:
            assert srv.url.startswith("tcp://[::1]:")
            c = kv.NetBackend(srv.url, "v6-client")
            c.set("cilium/v6", b"over-v6")
            assert c.get("cilium/v6") == b"over-v6"
            c.close()
        finally:
            srv.stop()


def test_snapshot_survives_partial_write(kv, tmp_path):
    """ADVICE r04: the tmp file is fsync'd before the rename, and a
    torn tmp never replaces a good snapshot."""
    state = str(tmp_path / "kv.json")
    srv = kv.KVStoreServer(state_path=state, snapshot_interval=3600).start()
    c = kv.NetBackend(srv.url, "a")
    c.set("cilium/durable", b"v1")
    srv._write_snapshot()
    c.close()
    srv.stop()
    # a stale tmp from a crashed writer must not shadow the real file
    with open(state + ".tmp", "w") as f:
        f.write('{"rev": 999, "kv"')  # torn JSON
    srv2 = kv.KVStoreServer(state_path=state).start()
    try:
        c2 = kv.NetBackend(srv2.url, "b")
        assert c2.get("cilium/durable") == b"v1"
        c2.close()
    finally:
        srv2.stop()
