"""Port parity: the xDS channel, ``xds/`` (``cache``, ``server``,
``client``, ``npds``), host code copied from the JAX package.

The reference's ``test_xds.py`` tests that build no ``Daemon`` (the
cache's two, the stream's six and ``test_nphds_follows_ipcache_churn``)
run once a package with the reference's own assertions, and the two runs
must return equal results: cache versions, the resources each client
applied, the versions it ACKed and the completions' outcomes.
``TestNPDS``'s five tests that build a ``Daemon`` wait for the port's
daemon (A7c). In their place the NPDS producers run on endpoints that
each package regenerates on its own pipeline over the same seeded L7
world: ``endpoint_policy_resource``, ``publish_endpoint_policy`` and
``delete_endpoint_policy`` must give equal JSON and equal versions, and
a client of each package's ``XDSServer`` must apply them. The copy
checks hold the copied modules to their references line by line.
Tolerance 0: every value compared is an integer, a string or a bool.
"""

from __future__ import annotations

import ast
import difflib
import importlib
import io
import json
import threading
import time
import tokenize
import types

import pytest

from test_torch_endpoint import _endpoints, _l7_world
from test_torch_harness import PKGS, REPO

IDENTICAL = ["xds/__init__.py", "xds/cache.py", "xds/server.py", "xds/client.py", "xds/npds.py",
             "proxy/__init__.py", "proxy/accesslog.py", "proxy/hpack.py", "proxy/http2.py"]
ADAPTED = ["proxy/standalone.py", "proxy/launcher.py", "proxy/__main__.py"]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def ns(pkg: str):
    xds = _mod(pkg, "xds")
    return types.SimpleNamespace(
        pkg=pkg,
        cpu={"device": "cpu"} if pkg == "cilium_tpu_torch" else {},
        NETWORK_POLICY_TYPE=xds.NETWORK_POLICY_TYPE,
        NETWORK_POLICY_HOSTS_TYPE=xds.NETWORK_POLICY_HOSTS_TYPE,
        ResourceCache=xds.ResourceCache,
        XDSClient=xds.XDSClient,
        XDSServer=xds.XDSServer,
        endpoint_policy_resource=xds.endpoint_policy_resource,
        publish_endpoint_policy=xds.publish_endpoint_policy,
        delete_endpoint_policy=xds.delete_endpoint_policy,
        publish_host_mapping=xds.publish_host_mapping,
        wire_nphds=xds.wire_nphds,
        WaitGroup=_mod(pkg, "utils.completion").WaitGroup,
        IPCache=_mod(pkg, "ipcache.ipcache").IPCache,
    )


def both(scenario):
    """Run ``scenario(m)`` on each package; the two results must be equal."""
    outs = [scenario(ns(pkg)) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


class _Stream:
    """The reference's ``stream`` fixture for one package."""

    def __init__(self, m, tmp_path):
        self.path = str(tmp_path / f"xds-{m.pkg}.sock")
        self.cache = m.ResourceCache()
        self.srv = m.XDSServer(self.cache, self.path)

    def __enter__(self):
        self.srv.start()
        return self.cache, self.srv, self.path

    def __exit__(self, *exc):
        self.srv.stop()


def _wait(cond, timeout: float = 5.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# -- the copies ----------------------------------------------------------------


def _doc_lines(src: str):
    """Line numbers of comments and docstrings."""
    lines = set()
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT:
            lines.add(tok.start[0])
    for node in ast.walk(ast.parse(src)):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant) and isinstance(body[0].value.value, str):
            lines.update(range(body[0].lineno, body[0].end_lineno + 1))
    return lines


@pytest.mark.parametrize("path", IDENTICAL)
def test_copies_equal_the_reference(path):
    assert (REPO / "cilium_tpu_torch" / path).read_text() == (REPO / "cilium_tpu" / path).read_text()


@pytest.mark.parametrize("path", ADAPTED)
def test_adapted_copies_differ_only_in_names_and_the_device(path):
    """Each changed line is a comment or docstring line, names the
    package, or carries the ``device`` / ``--device`` adaptation."""
    ref = (REPO / "cilium_tpu" / path).read_text()
    port = (REPO / "cilium_tpu_torch" / path).read_text()
    a, b = ref.splitlines(), port.splitlines()
    docs_a, docs_b = _doc_lines(ref), _doc_lines(port)
    changed = 0
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        changed += 1
        for k in range(j1, j2):
            assert (k + 1 in docs_b or not b[k].strip() or "device" in b[k]
                    or "cilium_tpu_torch" in b[k]), (path, k + 1, b[k])
        for k in range(i1, i2):
            assert (k + 1 in docs_a or "cilium_tpu." in a[k]
                    or any("device" in x for x in b[j1:j2])), (path, k + 1, a[k])
    assert changed


def test_public_names_match():
    for name in ("xds", "xds.cache", "xds.server", "xds.client", "xds.npds", "proxy",
                 "proxy.accesslog", "proxy.hpack", "proxy.http2", "proxy.standalone",
                 "proxy.launcher"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        assert sorted(n for n, v in vars(t).items() if not n.startswith("__")
                      and not isinstance(v, types.ModuleType)) == sorted(
            n for n, v in vars(j).items() if not n.startswith("__")
            and not isinstance(v, types.ModuleType)), name


# -- test_xds.py: TestCache ----------------------------------------------------


def test_versioning_and_noop():
    def run(m):
        c = m.ResourceCache()
        v1 = c.upsert("t", "a", {"x": 1})
        assert v1 == 1
        assert c.upsert("t", "a", {"x": 1}) == 1  # no-op write
        v2 = c.upsert("t", "a", {"x": 2})
        assert v2 == 2
        v3 = c.upsert("t", "b", {"y": 1})
        ver, res = c.get("t")
        assert ver == v3 == 3 and set(res) == {"a", "b"}
        _, subset = c.get("t", ["b", "missing"])
        assert set(subset) == {"b"}
        assert c.delete("t", "a") == 4
        assert c.delete("t", "a") == 4  # idempotent
        return [v1, v2, v3, ver, res, subset, c.get("t"), c.version("t")]

    both(run)


def test_wait_newer():
    def run(m):
        c = m.ResourceCache()
        c.upsert("t", "a", {})
        assert c.wait_newer("t", 1, timeout=0.05) is None  # nothing newer
        t = threading.Thread(target=lambda: (time.sleep(0.05), c.upsert("t", "b", {})))
        t.start()
        got = c.wait_newer("t", 1, timeout=5.0)
        assert got == 2
        t.join()
        return got, c.get("t")

    both(run)


# -- test_xds.py: TestStream ---------------------------------------------------


def test_subscribe_push_ack(tmp_path):
    def run(m):
        with _Stream(m, tmp_path) as (cache, srv, path):
            cache.upsert(m.NETWORK_POLICY_TYPE, "7", {"endpoint_id": 7})
            got = {}
            client = m.XDSClient(path, node="envoy-1")
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, res: got.update(res))
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, 1)
            assert got["7"] == {"endpoint_id": 7}
            # server observes the ACK
            assert _wait(lambda: srv.acked_version("envoy-1", m.NETWORK_POLICY_TYPE) >= 1)
            acked = srv.acked_version("envoy-1", m.NETWORK_POLICY_TYPE)
            # a cache update pushes a new version to the live stream
            v2 = cache.upsert(m.NETWORK_POLICY_TYPE, "9", {"endpoint_id": 9})
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, v2)
            assert got["9"] == {"endpoint_id": 9}
            applied = dict(client.applied)
            client.close()
            return acked, v2, dict(got), applied

    both(run)


def test_ack_completion_gates_regeneration(tmp_path):
    """The reference blocks endpoint regeneration until the proxy ACKs
    the policy version (ack.go + completion.WaitGroup)."""
    def run(m):
        with _Stream(m, tmp_path) as (cache, srv, path):
            client = m.XDSClient(path, node="envoy-1")
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, res: None)
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, 0, timeout=5)
            version = cache.upsert(m.NETWORK_POLICY_TYPE, "7", {"endpoint_id": 7})
            wg = m.WaitGroup()
            comp = wg.add()
            srv.wait_for_ack(m.NETWORK_POLICY_TYPE, version, "envoy-1", comp)
            assert wg.wait(timeout=5.0)
            client.close()
            return version, comp.err

    both(run)


def test_nack_fails_completion(tmp_path):
    def run(m):
        with _Stream(m, tmp_path) as (cache, srv, path):
            def bad_handler(version, res):
                if res:
                    raise ValueError("bad resource")

            client = m.XDSClient(path, node="envoy-2")
            client.subscribe(m.NETWORK_POLICY_TYPE, bad_handler)
            # the reference sleeps 0.1 s here; waiting for the empty
            # version's ACK orders the push after the subscription
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, 0, timeout=5)
            version = cache.upsert(m.NETWORK_POLICY_TYPE, "7", {"endpoint_id": 7})
            wg = m.WaitGroup()
            comp = wg.add()
            srv.wait_for_ack(m.NETWORK_POLICY_TYPE, version, "envoy-2", comp)
            with pytest.raises(RuntimeError, match="bad resource") as exc:
                wg.wait(timeout=5.0)
            assert comp.err is not None
            client.close()
            return version, str(exc.value), str(comp.err), client.applied

    both(run)


def test_disconnect_fails_pending_completions(tmp_path):
    """A dead stream can never ACK: wait_for_ack callers must be failed,
    not hung (ack.go completions on stream close)."""
    def run(m):
        with _Stream(m, tmp_path) as (cache, srv, path):
            client = m.XDSClient(path, node="envoy-x")
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, r: None)
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, 0, timeout=5)
            # register a completion for a version the client will never see
            wg = m.WaitGroup()
            srv.wait_for_ack(m.NETWORK_POLICY_TYPE, 999, "envoy-x", wg.add())
            client.close()
            with pytest.raises(RuntimeError, match="stream closed") as exc:
                assert wg.wait(timeout=5.0)
            return str(exc.value)

    both(run)


def test_resubscription_with_new_names_gets_push(tmp_path):
    def run(m):
        with _Stream(m, tmp_path) as (cache, srv, path):
            cache.upsert(m.NETWORK_POLICY_TYPE, "1", {"endpoint_id": 1})
            cache.upsert(m.NETWORK_POLICY_TYPE, "2", {"endpoint_id": 2})
            seen = {}
            client = m.XDSClient(path, node="envoy-y")
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, r: (seen.clear(), seen.update(r)),
                             resource_names=["1"])
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, 2)
            assert set(seen) == {"1"}
            first = dict(seen)
            # widen the subscription: same cache version, the new names
            # must still be pushed
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, r: (seen.clear(), seen.update(r)),
                             resource_names=["1", "2"])
            assert _wait(lambda: set(seen) == {"1", "2"})
            client.close()
            return first, dict(seen)

    both(run)


def test_already_acked_completes_immediately(tmp_path):
    def run(m):
        with _Stream(m, tmp_path) as (cache, srv, path):
            client = m.XDSClient(path, node="envoy-3")
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, r: None)
            v = cache.upsert(m.NETWORK_POLICY_TYPE, "1", {"endpoint_id": 1})
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, v)
            assert _wait(lambda: srv.acked_version("envoy-3", m.NETWORK_POLICY_TYPE) >= v)
            wg = m.WaitGroup()
            comp = wg.add()
            srv.wait_for_ack(m.NETWORK_POLICY_TYPE, v, "envoy-3", comp)
            assert wg.wait(timeout=1.0)
            client.close()
            return v, comp.err

    both(run)


# -- test_xds.py: TestNPDS, the Daemon-free test --------------------------------


def test_nphds_follows_ipcache_churn():
    def run(m):
        cache = m.ResourceCache()
        ipc = m.IPCache()
        ipc.upsert("10.0.0.1/32", 1001, source="k8s")
        m.wire_nphds(cache, ipc)
        states = [cache.get(m.NETWORK_POLICY_HOSTS_TYPE)]
        assert states[0][1]["1001"]["host_addresses"] == ["10.0.0.1/32"]
        ipc.upsert("10.0.0.2/32", 1001, source="k8s")
        states.append(cache.get(m.NETWORK_POLICY_HOSTS_TYPE))
        assert states[1][1]["1001"]["host_addresses"] == ["10.0.0.1/32", "10.0.0.2/32"]
        ipc.delete("10.0.0.1/32", "k8s")
        ipc.delete("10.0.0.2/32", "k8s")
        states.append(cache.get(m.NETWORK_POLICY_HOSTS_TYPE))
        assert "1001" not in states[2][1]  # empty set deletes the row
        return states

    both(run)


# -- NPDS from endpoints regenerated on each package's pipeline ----------------


def _regenerated(m, seed: int, n_rules: int, n_eps: int):
    """The seeded L7 world of tests/test_torch_endpoint.py (HTTP rules,
    one Kafka port, one wildcard-L7 port) through ``m``'s engine and
    pipeline; every endpoint regenerated with the proxy, one by one so
    that the proxy ports are allocated in the same order."""
    w = _l7_world(m.pkg, seed, n_rules)
    engine = _mod(m.pkg, "engine").PolicyEngine(w.repo, w.reg, **m.cpu)
    pipe = _mod(m.pkg, "datapath.pipeline").DatapathPipeline(engine, w.ipcache, **m.cpu)
    eps = _endpoints(m.pkg, w, n_eps)
    pipe.set_endpoints([ep.id for ep in eps])
    proxy = _mod(m.pkg, "proxy").Proxy()
    for ep in eps:
        assert ep.regenerate(pipe, reason="test", proxy=proxy)
    return w, pipe, eps, proxy


@pytest.mark.parametrize("seed,n_rules", [(5, 96), (11, 24)])
def test_npds_resources_of_regenerated_endpoints(seed, n_rules, tmp_path):
    """``endpoint_policy_resource`` of every regenerated endpoint, its
    publication, a republication after a rule delta (the Kafka rule goes
    with its redirects), a deletion, and a client's view of the cache:
    equal JSON and equal versions in both packages."""
    def run(m):
        w, pipe, eps, proxy = _regenerated(m, seed, n_rules, 16)
        resources = {ep.id: m.endpoint_policy_resource(ep.id, proxy) for ep in eps}
        parsers = {p["parser"] for r in resources.values() for p in r["l7_ports"]}
        assert parsers == {"http", "kafka"}
        for ep_id, res in resources.items():
            assert res["endpoint_id"] == ep_id
            assert len(res["l7_ports"]) == len(proxy.redirects_for(ep_id))
            for port in res["l7_ports"]:
                assert ("http_rules" in port) == (port["parser"] == "http")
                assert ("kafka_rules" in port) == (port["parser"] == "kafka")
        cache = m.ResourceCache()
        versions = [m.publish_endpoint_policy(cache, ep.id, proxy) for ep in eps]
        # a republication of an unchanged resource bumps nothing
        assert m.publish_endpoint_policy(cache, eps[0].id, proxy) == versions[-1]
        srv = m.XDSServer(cache, str(tmp_path / f"npds-{m.pkg}.sock"))
        srv.start()
        try:
            seen = {}
            client = m.XDSClient(srv.socket_path, node="ext-proxy")
            client.subscribe(m.NETWORK_POLICY_TYPE, lambda v, r: (seen.clear(), seen.update(r)))
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, versions[-1])
            first_seen = json.loads(json.dumps(seen))
            assert first_seen == json.loads(json.dumps({str(k): v for k, v in resources.items()}))
            # the Kafka rule goes: its redirects go with it, and the
            # endpoints that held them publish a new version
            w.repo.delete_by_labels(_mod(m.pkg, "labels").parse_label_array(["k8s:policy=kafka"]))
            for ep in eps:
                assert ep.regenerate(pipe, reason="test", proxy=proxy)
            after = [m.publish_endpoint_policy(cache, ep.id, proxy) for ep in eps]
            assert after[-1] > versions[-1]
            assert not any(p["parser"] == "kafka" for ep in eps
                           for p in m.endpoint_policy_resource(ep.id, proxy)["l7_ports"])
            gone = m.delete_endpoint_policy(cache, eps[1].id)
            assert gone == after[-1] + 1
            assert m.delete_endpoint_policy(cache, eps[1].id) == gone  # idempotent
            assert client.wait_applied(m.NETWORK_POLICY_TYPE, gone)
            assert str(eps[1].id) not in seen
            final = cache.get(m.NETWORK_POLICY_TYPE)
            assert json.loads(json.dumps(seen)) == json.loads(json.dumps(final[1]))
            client.close()
        finally:
            srv.stop()
        return (json.dumps({str(k): v for k, v in resources.items()}, sort_keys=True), versions,
                after, gone, json.dumps(final, sort_keys=True))

    both(run)


def test_npds_remote_policies_follow_the_scopes():
    """Every published HTTP / Kafka rule carries the identity scope its
    redirect's policy holds, and ``from_model`` of the published rules
    rebuilds a policy that answers as the redirect's does."""
    def run(m):
        w, _, eps, proxy = _regenerated(m, 5, 96, 16)
        l7 = _mod(m.pkg, "l7")
        ids = sorted(i.id for i in w.reg)
        answers = []
        for ep in eps:
            res = m.endpoint_policy_resource(ep.id, proxy)
            for port in res["l7_ports"]:
                rd = proxy.lookup(ep.id, port["port"], ingress=port["ingress"])
                if port["parser"] == "http":
                    pol = l7.HTTPPolicy.from_model(port["http_rules"], **m.cpu)
                    reqs = [l7.HTTPRequest(method=meth, path=path, src_identity=s)
                            for meth in ("GET", "POST") for path in ("/api/x", "/other", "/")
                            for s in ids]
                    want = rd.http_policy.check_batch(reqs).tolist()
                else:
                    pol = l7.KafkaACL.from_model(port["kafka_rules"], **m.cpu)
                    reqs = [l7.KafkaRequest(api_key=k, api_version=1, client_id="c", topic=t,
                                            src_identity=s)
                            for k in (0, 3) for t in ("orders", "logs") for s in ids]
                    want = [bool(x) for x in rd.kafka_acl.check_batch(reqs)]
                got = [bool(x) for x in pol.check_batch(reqs)]
                assert got == want
                answers.append((ep.id, port["port"], got))
        flat = [a for _, _, v in answers for a in v]
        assert any(flat) and not all(flat)
        return answers

    both(run)


def test_nphds_rows_of_the_world_ipcache():
    """``wire_nphds`` over the seeded world's ipcache, then a peer moved
    to another identity and one deleted: equal NPHDS rows and versions."""
    def run(m):
        w = _l7_world(m.pkg, 5, 24)
        cache = m.ResourceCache()
        m.wire_nphds(cache, w.ipcache)
        states = [cache.get(m.NETWORK_POLICY_HOSTS_TYPE)]
        assert states[0][1]
        ip = next(p for p, i in zip(w.peer_ips, w.peer_idents) if i is not None)
        other = w.idents[-1].id
        w.ipcache.upsert(f"{ip}/32", other, source="k8s")
        states.append(cache.get(m.NETWORK_POLICY_HOSTS_TYPE))
        w.ipcache.delete(f"{ip}/32", "k8s")
        states.append(cache.get(m.NETWORK_POLICY_HOSTS_TYPE))
        assert f"{ip}/32" not in json.dumps(states[-1][1])
        for ident in {i.id for i in w.idents}:
            assert m.publish_host_mapping(cache, w.ipcache, ident) == states[-1][0]
        return json.dumps(states, sort_keys=True)

    both(run)
