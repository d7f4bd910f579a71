"""Port parity: the k8s writebacks and the LB side of the watcher (Ingress
to an LB frontend on the node's address, the Node watcher and its CIDR
annotation, CNP status acks, the CNP CRD), copied from the JAX package.

The six tests of the reference's ``test_k8s_parity.py`` run against both
packages through ``FakeAPIServer`` on loopback, each package's watcher
driving its own stand-in agent (``test_torch_k8s.Agent``, its
``services.host_ip`` the node's address, its ``ipam.net`` the pod CIDR
the annotation writes). Each runs with the reference's assertions; the
two packages' runs must then leave equal agent state (``agent_state``)
and equal writes to the apiserver: the distinct status objects (the
ack's wall-clock ``lastUpdated`` left out), annotation patches and CRDs.
"""

from __future__ import annotations

import copy
import json

from test_k8s_client import FakeAPIServer, _cnp, _wait
from test_k8s_parity import HOST_IP, _endpoints, _ingress, _node, _service
from test_torch_k8s import agent_state, both


def _world(m):
    api = FakeAPIServer()
    a = m.Agent(host_ip=HOST_IP)
    w = m.K8sWatcher(a)
    w.status_client = m.APIServerClient(api.url)
    w.node_name = "node-1"
    return api, a, w


def _writes(api):
    """The distinct writes the apiserver recorded, the acks' timestamps
    left out. The fake apiserver replays a new watch stream from its first
    event, so an object's write may repeat a timing-dependent number of
    times; what was written is compared, not how often."""
    status = set()
    for kind, ns, name, obj in api.status_writes:
        obj = copy.deepcopy(obj)
        for entry in ((obj.get("status") or {}).get("nodes") or {}).values():
            entry.pop("lastUpdated", None)
        status.add(json.dumps([kind, ns, name, obj], sort_keys=True))
    return {"status": sorted(status),
            "annotations": sorted({json.dumps(p, sort_keys=True) for p in api.annotation_patches}),
            "crds": copy.deepcopy(api.crds)}


def _stop(api):
    api.drop_watches.set()
    api.stop()


def test_ingress_creates_host_frontend():
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("Service", _service("web", "10.96.0.10", 80))
            api.put("Endpoints", _endpoints("web", ["10.1.0.5", "10.1.0.6"], 8080))
            api.put("Ingress", _ingress("web-ing", "web", 80))
            inf = m.Informer(m.APIServerClient(api.url), w).start()
            try:
                assert inf.wait_synced()
                fe = m.L3n4Addr(HOST_IP, 80, "TCP")
                assert _wait(lambda: a.services.get(fe) is not None)
                svc = a.services.get(fe)
                assert sorted(b.ip for b in svc.backends) == ["10.1.0.5", "10.1.0.6"]
                assert a.services.get(m.L3n4Addr("10.96.0.10", 80, "TCP")) is not None
                assert _wait(lambda: any(
                    k == "Ingress" and o["status"]["loadBalancer"]["ingress"][0]["ip"] == HOST_IP
                    for k, _ns, _n, o in api.status_writes))
            finally:
                inf.stop()
            return agent_state(a), _writes(api)
        finally:
            _stop(api)

    both(run)


def test_ingress_delete_removes_frontend():
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("Service", _service("web", "10.96.0.10", 80))
            api.put("Endpoints", _endpoints("web", ["10.1.0.5"], 8080))
            api.put("Ingress", _ingress("web-ing", "web", 80))
            inf = m.Informer(m.APIServerClient(api.url), w).start()
            try:
                assert inf.wait_synced()
                fe = m.L3n4Addr(HOST_IP, 80, "TCP")
                assert _wait(lambda: a.services.get(fe) is not None)
                with w._apply_lock:  # no event half applied
                    with_ingress = agent_state(a)
                api.remove("Ingress", "shop", "web-ing")
                assert _wait(lambda: a.services.get(fe) is None)
                assert a.services.get(m.L3n4Addr("10.96.0.10", 80, "TCP")) is not None
            finally:
                inf.stop()
            return with_ingress, agent_state(a), _writes(api)
        finally:
            _stop(api)

    both(run)


def test_node_objects_tracked_and_annotated():
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("Node", _node("node-1", "10.200.0.0/16", "192.168.40.1"))
            api.put("Node", _node("node-2", "10.201.0.0/16", "192.168.40.2"))
            inf = m.Informer(m.APIServerClient(api.url), w).start()
            try:
                assert inf.wait_synced()
                assert _wait(lambda: len(w.nodes) == 2)
                assert w.nodes["node-2"]["pod_cidr"] == "10.201.0.0/16"
                assert w.nodes["node-2"]["internal_ip"] == "192.168.40.2"
                assert _wait(lambda: any(
                    name == "node-1"
                    and ann.get("io.cilium.network.ipv4-pod-cidr") == str(a.ipam.net)
                    for _plural, name, ann in api.annotation_patches))
                assert not any(name == "node-2" for _p, name, _a in api.annotation_patches)
                with w._apply_lock:
                    nodes = dict(w.nodes)
                api.remove("Node", "default", "node-2")
                assert _wait(lambda: "node-2" not in w.nodes)
            finally:
                inf.stop()
            return nodes, dict(w.nodes), _writes(api)
        finally:
            _stop(api)

    both(run)


def test_cnp_import_acks_status():
    def run(m):
        api, a, w = _world(m)
        try:
            api.put("CiliumNetworkPolicy", _cnp("guard", "db", "web"))
            inf = m.Informer(m.APIServerClient(api.url), w).start()
            try:
                assert inf.wait_synced()
                assert _wait(lambda: any(k == "CiliumNetworkPolicy" and n == "guard"
                                         for k, _ns, n, _o in api.status_writes))
                _k, ns, _n, obj = next(t for t in api.status_writes
                                       if t[0] == "CiliumNetworkPolicy" and t[2] == "guard")
                assert ns == "shop"
                entry = obj["status"]["nodes"]["node-1"]
                assert entry["ok"] is True and entry["enforcing"] is True
                assert entry["localPolicyRevision"] >= 1
            finally:
                inf.stop()
            return agent_state(a), _writes(api)
        finally:
            _stop(api)

    both(run)


def test_malformed_cnp_acks_error():
    def run(m):
        api, a, w = _world(m)
        try:
            bad = {
                "kind": "CiliumNetworkPolicy",
                "metadata": {"name": "broken", "namespace": "shop"},
                "spec": {"endpointSelector": {"matchLabels": {"app": "x"}},
                         "ingress": [{"toPorts": [{"ports": [
                             {"port": "not-a-port", "protocol": "TCP"}]}]}]},
            }
            api.put("CiliumNetworkPolicy", bad)
            inf = m.Informer(m.APIServerClient(api.url), w).start()
            try:
                inf.wait_synced()
                assert _wait(lambda: any(
                    k == "CiliumNetworkPolicy" and n == "broken"
                    and o["status"]["nodes"]["node-1"]["ok"] is False
                    for k, _ns, n, o in api.status_writes))
            finally:
                inf.stop()
            return agent_state(a), _writes(api)
        finally:
            _stop(api)

    both(run)


def test_crd_registration():
    def run(m):
        api, _a, _w = _world(m)
        try:
            client = m.APIServerClient(api.url)
            assert client.ensure_cnp_crd() is True
            assert "ciliumnetworkpolicies.cilium.io" in api.crds
            crd = api.crds["ciliumnetworkpolicies.cilium.io"]
            assert crd["spec"]["names"]["kind"] == "CiliumNetworkPolicy"
            assert client.ensure_cnp_crd() is True
            return _writes(api)
        finally:
            _stop(api)

    both(run)
