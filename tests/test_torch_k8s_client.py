"""Port parity: the k8s apiserver client (``k8s/client.py``: LIST + WATCH
over HTTP, the ``Informer``), copied from the JAX package.

The six tests of the reference's ``test_k8s_client.py`` run against both
packages, each package's ``Informer`` and ``K8sWatcher`` driving its own
stand-in agent (``test_torch_k8s.Agent``: the five daemon methods, an
engine and a pipeline on the CPU, regenerated on every ask) from a
``FakeAPIServer`` of the reference's tests on loopback. Each runs with
the reference's assertions, its ``_wait`` deadlines as they are; the two
packages' runs must then leave equal rules, endpoints, identities,
ipcache entries, LB frontends, oracle decisions and engine and pipeline
verdicts (``agent_state``).
"""

from __future__ import annotations

import time

from test_k8s_client import FakeAPIServer, _cnp, _pod, _wait
from test_torch_k8s import NS, agent_state, allows, both


def _world(m):
    api = FakeAPIServer()
    a = m.Agent()
    return api, a, m.K8sWatcher(a)


def _stop(api):
    api.drop_watches.set()
    api.stop()


def test_initial_list_populates_daemon():
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("CiliumNetworkPolicy", _cnp("guard", "db", "web"))
            api.put("Pod", _pod("web-1", "10.1.0.10", "web"))
            inf = m.Informer(m.APIServerClient(api.url), w).start()
            try:
                assert inf.wait_synced()
                assert len(a.endpoints) == 1
                assert allows(m, a.repo, ["k8s:app=web", f"{NS}=shop"],
                              ["k8s:app=db", f"{NS}=shop"])
            finally:
                inf.stop()
            return agent_state(a)
        finally:
            _stop(api)

    both(run)


def test_watch_events_apply_live():
    def run(m):
        api, a, w = _world(m)
        try:
            inf = m.Informer(m.APIServerClient(api.url), w, relist_backoff_s=0.1).start()
            try:
                assert inf.wait_synced()
                api.put("Pod", _pod("db-1", "10.1.0.20", "db"))
                assert _wait(lambda: len(a.endpoints) == 1)
                api.put("CiliumNetworkPolicy", _cnp("guard", "db", "web"))
                assert _wait(lambda: len(a.repo) > 0)
                n = len(a.repo)
                api.put("CiliumNetworkPolicy", _cnp("guard", "db", "admin"), event="MODIFIED")
                assert _wait(lambda: allows(m, a.repo, ["k8s:app=admin", f"{NS}=shop"],
                                            ["k8s:app=db", f"{NS}=shop"]))
                assert len(a.repo) == n
                with w._apply_lock:  # no event half applied
                    modified = agent_state(a)
                api.remove("CiliumNetworkPolicy", "shop", "guard")
                assert _wait(lambda: len(a.repo) == 0)
                with w._apply_lock:
                    deleted = agent_state(a)
            finally:
                inf.stop()
            return [modified, deleted]
        finally:
            _stop(api)

    both(run)


def test_stream_drop_relists_and_heals_missed_delete():
    """The runs are compared at the end of each resync (the initial LIST,
    the re-list): the fake apiserver replays a new watch stream from its
    first event, so db-1's ADDED may come back at any time after it."""
    def run(m):
        api, a, w = _world(m)
        synced = []
        real = w.resync

        def resync(objects):
            real(objects)
            synced.append(agent_state(a))

        w.resync = resync
        try:
            api.put("Pod", _pod("web-1", "10.1.0.10", "web"))
            api.put("Pod", _pod("db-1", "10.1.0.20", "db"))
            inf = m.Informer(m.APIServerClient(api.url), w, kinds=["Pod"],
                             relist_backoff_s=0.1).start()
            try:
                assert inf.wait_synced()
                assert len(a.endpoints) == 2
                api.expire_watches = True
                api.drop_watches.set()
                api.remove("Pod", "shop", "db-1", notify=False)
                time.sleep(0.3)
                api.drop_watches.clear()
                api.expire_watches = False
                assert _wait(lambda: len(a.endpoints) == 1, timeout=10)
                assert ("shop", "web-1") in w.pods.known_pods()
                assert ("shop", "db-1") not in w.pods.known_pods()
                # the count moves once the re-list's resync returns, after
                # the agent's regeneration for the delete it healed
                assert _wait(lambda: inf.relists >= 1)
            finally:
                inf.stop()
            return synced[:2]
        finally:
            _stop(api)

    both(run)


def test_410_gone_triggers_relist():
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("Pod", _pod("web-1", "10.1.0.10", "web"))
            inf = m.Informer(m.APIServerClient(api.url), w, kinds=["Pod"],
                             relist_backoff_s=0.1).start()
            try:
                assert inf.wait_synced()
                api.expire_watches = True
                api.put("Pod", _pod("api-1", "10.1.0.30", "api"))
                time.sleep(0.3)
                api.expire_watches = False
                assert _wait(lambda: len(a.endpoints) == 2, timeout=10)
            finally:
                inf.stop()
            return agent_state(a)
        finally:
            _stop(api)

    both(run)


def test_half_open_watch_recovers_via_read_deadline():
    """A watch connection that goes silent without closing must not pin
    the watch thread: the client's read deadline abandons it and the
    reconnect resumes from the tracked rv."""
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("Pod", _pod("web-1", "10.1.0.10", "web"))
            api.stall_next_watch = True
            inf = m.Informer(m.APIServerClient(api.url, watch_read_timeout=0.5), w,
                             kinds=["Pod"], relist_backoff_s=0.1).start()
            try:
                assert inf.wait_synced()
                api.put("Pod", _pod("db-1", "10.1.0.20", "db"))
                assert _wait(lambda: len(a.endpoints) == 2, timeout=10)
            finally:
                inf.stop()
            return agent_state(a)
        finally:
            _stop(api)

    both(run)


def test_simultaneous_watch_failures_collapse_to_one_relist():
    """All kind watches dropping at once must not fan out into one full
    re-list per kind."""
    def run(m):
        api, a, w = _world(m)
        kinds = ["Pod", "Service", "Endpoints", "Namespace"]
        try:
            api.put("Pod", _pod("web-1", "10.1.0.10", "web"))
            inf = m.Informer(m.APIServerClient(api.url), w, kinds=kinds,
                             relist_backoff_s=0.3).start()
            try:
                assert inf.wait_synced()
                with api.lock:
                    lists_after_sync = api.list_count
                with api.lock:
                    api.abort_next = set(kinds)
                api.drop_watches.set()
                time.sleep(0.2)
                api.drop_watches.clear()
                time.sleep(1.0)
                api.put("Pod", _pod("db-1", "10.1.0.20", "db"))
                assert _wait(lambda: len(a.endpoints) == 2, timeout=10)
                with api.lock:
                    extra_lists = api.list_count - lists_after_sync
                assert inf.relists <= 2, inf.relists
                assert extra_lists <= 2 * len(kinds), extra_lists
            finally:
                inf.stop()
            return agent_state(a)
        finally:
            _stop(api)

    both(run)
