"""Port parity: the Kubernetes policy source, ``k8s/`` (``network_policy``,
``cnp``, ``rule_translate``, ``service_registry``, ``pods``, ``watcher``,
``client``, ``constants``), host code copied from the JAX package.

The Daemon-free tests of the reference's ``test_k8s.py`` run against both
packages through their public names: each runs once a package with the
reference's own assertions, and the two runs must return equal rule JSON
(``rules_to_json``), equal repository-oracle decisions and equal engine
verdicts on the CPU (every pair of the test's label sets, both
directions, three ports). The reference's watcher tests build a
``Daemon``; the port has none until A7c, so they run here through
``Agent``, a stand-in offering the five methods the watcher calls
(``policy_replace``, ``policy_delete``, ``policy_translate``,
``endpoint_add``, ``endpoint_delete``), each doing what the Daemon's
does, with an engine and a pipeline it regenerates on every ask. One
test holds the JAX stand-in to the JAX ``Daemon`` on the same events.
The copy check holds the 12 copied modules of ``k8s/`` and ``fqdn/`` to
their references byte for byte. Tolerance 0: every value compared is an
integer, a string or a bool.
"""

from __future__ import annotations

import ast
import importlib
import io
import ipaddress
import json
import tokenize
import types

import numpy as np
import pytest

from test_k8s import EXAMPLES  # the reference's example policies; absent, their tests skip
from test_torch_harness import PKGS, REPO

NS = "k8s:io.kubernetes.pod.namespace"
PORTS = ((80, 6), (443, 6), (53, 17))
COPIED = [f"k8s/{n}.py" for n in ("constants", "service_registry", "rule_translate",
                                  "network_policy", "cnp", "pods", "watcher", "client",
                                  "__init__")] + [f"fqdn/{n}.py" for n in ("cache", "poller",
                                                                          "__init__")]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def ns(pkg: str):
    """The names the reference's k8s and fqdn tests import, from ``pkg``,
    and the device keyword its engine and pipeline need on the CPU."""
    k8s = _mod(pkg, "k8s")
    client = _mod(pkg, "k8s.client")
    reg = _mod(pkg, "k8s.service_registry")
    api = _mod(pkg, "policy.api")
    ser = _mod(pkg, "policy.api.serialization")
    search = _mod(pkg, "policy.search")
    fqdn = _mod(pkg, "fqdn")
    lb = _mod(pkg, "lb.service")
    labels = _mod(pkg, "labels")
    m = types.SimpleNamespace(
        pkg=pkg,
        cpu={"device": "cpu"} if pkg == "cilium_tpu_torch" else {},
        K8sWatcher=k8s.K8sWatcher,
        RuleTranslator=k8s.RuleTranslator,
        RegistryTranslator=_mod(pkg, "k8s.rule_translate").RegistryTranslator,
        ServiceEndpoint=k8s.ServiceEndpoint,
        ServiceID=k8s.ServiceID,
        ServiceInfo=reg.ServiceInfo,
        ServiceRegistry=k8s.ServiceRegistry,
        load_objects=k8s.load_objects,
        objects_to_rules=k8s.objects_to_rules,
        parse_cnp=k8s.parse_cnp,
        parse_network_policy=k8s.parse_network_policy,
        pod_labels=k8s.pod_labels,
        preprocess_rules=k8s.preprocess_rules,
        APIServerClient=client.APIServerClient,
        Informer=client.Informer,
        RESOURCES=client.RESOURCES,
        DNSCache=fqdn.DNSCache,
        DNSPoller=fqdn.DNSPoller,
        FQDNTranslator=fqdn.FQDNTranslator,
        LabelArray=labels.LabelArray,
        parse_label_array=labels.parse_label_array,
        cidr_labels=_mod(pkg, "labels.cidr").cidr_labels,
        CIDRRule=api.CIDRRule,
        EgressRule=api.EgressRule,
        ServiceSelector=api.ServiceSelector,
        rule=api.rule,
        rules_from_json=ser.rules_from_json,
        rules_to_json=ser.rules_to_json,
        Repository=_mod(pkg, "policy.repository").Repository,
        Decision=search.Decision,
        SearchContext=search.SearchContext,
        PolicyEngine=_mod(pkg, "engine").PolicyEngine,
        IdentityRegistry=_mod(pkg, "identity").IdentityRegistry,
        IPCache=_mod(pkg, "ipcache.ipcache").IPCache,
        SOURCE_AGENT=_mod(pkg, "ipcache.ipcache").SOURCE_AGENT,
        ServiceManager=lb.ServiceManager,
        L3n4Addr=lb.L3n4Addr,
        DatapathPipeline=_mod(pkg, "datapath.pipeline").DatapathPipeline,
    )
    m.Agent = lambda **kw: Agent(m, **kw)
    return m


class Agent:
    """The stand-in for the daemon a K8sWatcher drives, over package ``m``:
    a Repository, an IdentityRegistry, an IPCache, a PolicyEngine, an
    endpoint id -> endpoint map, a ServiceManager as ``services``, an
    object with ``.net`` as ``ipam`` (the node annotation reads it) and a
    DatapathPipeline with ``lb=`` that manager. The five methods are the
    ones the watcher calls, each doing what the reference Daemon's does
    (cilium_tpu/daemon.py policy_replace, policy_delete, policy_translate,
    endpoint_add, endpoint_delete); each regeneration it would ask for
    runs at once: the pipeline's endpoints (by id), the engine's refresh
    and the pipeline's rebuild."""

    def __init__(self, m, host_ip: str = "", pod_cidr: str = "10.200.0.0/16"):
        self.m = m
        self.repo = m.Repository()
        self.registry = m.IdentityRegistry()
        self.ipcache = m.IPCache()
        self.engine = m.PolicyEngine(self.repo, self.registry, **m.cpu)
        self.endpoints = {}
        self.services = m.ServiceManager(host_ip=host_ip)
        self.ipam = types.SimpleNamespace(net=ipaddress.ip_network(pod_cidr))
        self.pipeline = m.DatapathPipeline(self.engine, self.ipcache, lb=self.services, **m.cpu)
        self.asks = []

    def _regenerate(self, reason: str) -> None:
        self.asks.append(reason)
        eps = [(e.id, e.identity.id) for _, e in sorted(self.endpoints.items())]
        if eps != list(zip(self.pipeline._endpoint_ids, self.pipeline._endpoints)):
            self.pipeline.set_endpoints(eps)
        self.engine.refresh()
        self.pipeline.rebuild()

    def policy_replace(self, labels, rules_json: str) -> dict:
        rules = self.m.rules_from_json(rules_json)
        rev, n_deleted = self.repo.replace_by_labels(self.m.parse_label_array(labels), rules)
        self._regenerate("policy replace")
        return {"revision": rev, "count": len(rules), "deleted": n_deleted}

    def policy_delete(self, labels) -> dict:
        rev, deleted = self.repo.take_by_labels(self.m.parse_label_array(labels))
        if deleted:
            self._regenerate("policy delete")
        return {"revision": rev, "deleted": len(deleted)}

    def policy_translate(self, translator) -> dict:
        rev, n = self.repo.translate_rules(translator)
        if n:
            self._regenerate("policy translate")
        return {"revision": rev, "changed": n}

    def endpoint_add(self, endpoint_id: int, labels, *, ipv4=None, ipv6=None,
                     pod_name: str = "") -> dict:
        if endpoint_id in self.endpoints:
            raise ValueError(f"endpoint {endpoint_id} exists")
        lbls = self.m.parse_label_array(labels)
        ident = self.registry.allocate(lbls)
        self.endpoints[endpoint_id] = types.SimpleNamespace(
            id=endpoint_id, labels=lbls, identity=ident, ipv4=ipv4, ipv6=ipv6, pod_name=pod_name)
        if ipv4:
            self.ipcache.upsert(f"{ipv4}/32", ident.id, source=self.m.SOURCE_AGENT)
        if ipv6:
            self.ipcache.upsert(f"{ipv6}/128", ident.id, source=self.m.SOURCE_AGENT)
        self._regenerate("endpoint created")
        return {"id": endpoint_id, "identity": ident.id, "ipv4": ipv4, "ipv6": ipv6}

    def endpoint_delete(self, endpoint_id: int) -> bool:
        ep = self.endpoints.pop(endpoint_id, None)
        if ep is None:
            return False
        if ep.ipv4:
            self.ipcache.delete(f"{ep.ipv4}/32", self.m.SOURCE_AGENT)
        if ep.ipv6:
            self.ipcache.delete(f"{ep.ipv6}/128", self.m.SOURCE_AGENT)
        self.registry.release(ep.identity)
        self._regenerate("endpoint deleted")
        return True


# -- what two runs are held to ---------------------------------------------------


def _arr(x):
    return np.asarray(x).astype(np.int64).tolist()


def engine_verdicts(m, repo, label_sets):
    """A fresh engine of package ``m`` over ``repo``, an identity for each
    label set: decision, l3 and l7_redirect of every (subject, peer) pair
    in both directions on PORTS."""
    reg = m.IdentityRegistry()
    ids = [reg.allocate(ls if isinstance(ls, m.LabelArray) else m.parse_label_array(ls)).id
           for ls in label_sets]
    eng = m.PolicyEngine(repo, reg, **m.cpu)
    return verdicts_of(eng, ids)


def verdicts_of(eng, ids):
    subj, peer, dp, pr = [], [], [], []
    for s in ids:
        for p in ids:
            for port, proto in PORTS:
                subj.append(s), peer.append(p), dp.append(port), pr.append(proto)
    out = []
    for ingress in (True, False):
        v = eng.verdicts(subj, peer, dp, pr, ingress=ingress)
        out.append([_arr(v.decision), _arr(v.l3), _arr(v.l7_redirect)])
    return out


def oracle(m, repo, pairs, ingress=True):
    """The repository's can_reach / allows decisions for (src, dst) label
    lists."""
    out = []
    for src, dst in pairs:
        ctx = m.SearchContext(src=m.parse_label_array(src), dst=m.parse_label_array(dst))
        out.append(str(repo.can_reach_ingress(ctx) if ingress else repo.can_reach_egress(ctx)))
    return out


def allows(m, repo, src, dst, ingress=True):
    ctx = m.SearchContext(src=m.parse_label_array(src), dst=m.parse_label_array(dst))
    d = repo.can_reach_ingress(ctx) if ingress else repo.can_reach_egress(ctx)
    return d == m.Decision.ALLOWED


def summary(m, repo, label_sets, pairs=()):
    return {"rules": json.loads(m.rules_to_json(list(repo.rules))),
            "oracle": oracle(m, repo, pairs),
            "verdicts": engine_verdicts(m, repo, label_sets)}


def agent_state(agent):
    """Everything a watcher test moves: the rules, the endpoints with their
    identities and labels, the ipcache, the LB frontends, the engine's
    verdicts between every endpoint pair and the pipeline's egress
    verdicts from every endpoint to every endpoint address."""
    m = agent.m
    eps = sorted(agent.endpoints.items())
    state = {
        "rules": json.loads(m.rules_to_json(list(agent.repo.rules))),
        "revision": agent.repo.revision,
        "endpoints": [(i, e.identity.id, sorted(str(x) for x in e.labels), e.ipv4, e.ipv6,
                       e.pod_name) for i, e in eps],
        "ipcache": sorted((p, e.identity, e.source) for p, e in agent.ipcache.items()),
        "lb": [(str(s.frontend), [(b.ip, b.port, b.weight) for b in s.backends])
               for s in agent.services.list()],
        "asks": list(agent.asks),
    }
    ids = [e.identity.id for _, e in eps]
    if ids:
        state["verdicts"] = verdicts_of(agent.engine, ids)
        ips = [int(ipaddress.IPv4Address(e.ipv4)) for _, e in eps if e.ipv4]
        if ips:
            n = len(ids)
            peer = np.array([ip for _ in range(n) for ip in ips], np.uint32)
            src = np.array([k for k in range(n) for _ in ips], np.int32)
            for port, proto in PORTS:
                v, red = agent.pipeline.process(
                    peer, src, np.full(peer.size, port, np.int32),
                    np.full(peer.size, proto, np.int32), ingress=False,
                    sports=np.arange(peer.size, dtype=np.int64) + 1024)
                state.setdefault("pipeline", []).append((_arr(v), _arr(red)))
    return state


def both(scenario):
    """Run ``scenario(m)`` on each package; the two results must be equal."""
    outs = [scenario(ns(pkg)) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


@pytest.fixture(params=PKGS)
def m(request):
    return ns(request.param)


# -- the copies --------------------------------------------------------------------


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


@pytest.mark.parametrize("path", COPIED)
def test_copies_match_the_reference(path):
    """Each port module equals its reference byte for byte, but for lines
    of comments or docstrings that name the package."""
    ref = (REPO / "cilium_tpu" / path).read_text()
    port = (REPO / "cilium_tpu_torch" / path).read_text()
    a, b = ref.splitlines(keepends=True), port.splitlines(keepends=True)
    assert len(a) == len(b), path
    docs = _doc_lines(port)
    for k, (x, y) in enumerate(zip(a, b), 1):
        if x != y:
            assert k in docs and "cilium_tpu" in x + y, (path, k, x, y)


def test_public_names_match():
    for name in ("k8s", "k8s.client", "k8s.watcher", "k8s.service_registry",
                 "k8s.rule_translate", "k8s.network_policy", "k8s.cnp", "k8s.pods",
                 "k8s.constants", "fqdn", "fqdn.cache", "fqdn.poller"):
        j, t = (_mod(pkg, name) for pkg in PKGS)
        # submodules show in a package's names once imported: left out
        assert sorted(n for n, v in vars(t).items() if not n.startswith("_")
                      and not isinstance(v, types.ModuleType)) == sorted(
            n for n, v in vars(j).items() if not n.startswith("_")
            and not isinstance(v, types.ModuleType)), name
    assert _mod("cilium_tpu_torch", "fqdn").__all__ == _mod("cilium_tpu", "fqdn").__all__


# -- test_k8s.py: NetworkPolicy --------------------------------------------------


def np_obj(spec, name="test-np", namespace="ns1"):
    return {
        "kind": "NetworkPolicy",
        "apiVersion": "networking.k8s.io/v1",
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec,
    }


def test_np_pod_selector_same_namespace():
    def run(m):
        rules = m.parse_network_policy(np_obj({
            "podSelector": {"matchLabels": {"role": "backend"}},
            "ingress": [{"from": [{"podSelector": {"matchLabels": {"role": "frontend"}}}]}],
        }))
        repo = m.Repository()
        repo.add_list(rules)
        dst = ["k8s:role=backend", f"{NS}=ns1"]
        assert allows(m, repo, ["k8s:role=frontend", f"{NS}=ns1"], dst)
        assert not allows(m, repo, ["k8s:role=frontend", f"{NS}=ns2"], dst)
        other = ["k8s:role=other", f"{NS}=ns1"]
        assert repo.can_reach_ingress(m.SearchContext(
            src=m.parse_label_array(["k8s:x=y"]), dst=m.parse_label_array(other)
        )) == m.Decision.UNDECIDED
        sets = [dst, ["k8s:role=frontend", f"{NS}=ns1"], ["k8s:role=frontend", f"{NS}=ns2"], other]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_np_empty_from_wildcards_peer():
    def run(m):
        repo = m.Repository()
        repo.add_list(m.parse_network_policy(np_obj({"podSelector": {}, "ingress": [{}]})))
        assert allows(m, repo, ["k8s:anything=goes"], [f"{NS}=ns1"])
        sets = [["k8s:anything=goes"], [f"{NS}=ns1"]]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_np_default_deny_ingress():
    def run(m):
        repo = m.Repository()
        repo.add_list(m.parse_network_policy(np_obj({"podSelector": {},
                                                     "policyTypes": ["Ingress"]})))
        ctx = m.SearchContext(src=m.parse_label_array(["k8s:role=frontend", f"{NS}=ns1"]),
                              dst=m.parse_label_array([f"{NS}=ns1"]))
        _matched, any_match = repo.get_rules_matching(m.parse_label_array([f"{NS}=ns1"]))
        assert any_match
        assert repo.can_reach_ingress(ctx) == m.Decision.UNDECIDED
        sets = [["k8s:role=frontend", f"{NS}=ns1"], [f"{NS}=ns1"]]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_np_namespace_selector_meta_labels():
    def run(m):
        repo = m.Repository()
        repo.add_list(m.parse_network_policy(np_obj({
            "podSelector": {},
            "ingress": [{"from": [{"namespaceSelector": {"matchLabels": {"team": "alpha"}}}]}],
        })))
        dst = [f"{NS}=ns1"]
        good = ["k8s:io.cilium.k8s.namespace.labels.team=alpha", f"{NS}=other"]
        bad = ["k8s:io.cilium.k8s.namespace.labels.team=beta", f"{NS}=other"]
        assert allows(m, repo, good, dst)
        assert not allows(m, repo, bad, dst)
        sets = [dst, good, bad]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_np_empty_namespace_selector_selects_all_namespaces():
    def run(m):
        repo = m.Repository()
        repo.add_list(m.parse_network_policy(np_obj({
            "podSelector": {}, "ingress": [{"from": [{"namespaceSelector": {}}]}]})))
        dst = [f"{NS}=ns1"]
        assert allows(m, repo, [f"{NS}=anywhere"], dst)
        assert not allows(m, repo, ["reserved:world"], dst)
        sets = [dst, [f"{NS}=anywhere"], ["reserved:world"]]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_np_ipblock_and_ports():
    def run(m):
        rules = m.parse_network_policy(np_obj({
            "podSelector": {},
            "ingress": [{
                "from": [{"ipBlock": {"cidr": "10.0.0.0/8", "except": ["10.96.0.0/12"]}}],
                "ports": [{"port": 443, "protocol": "TCP"}],
            }],
        }))
        r = rules[0]
        assert r.ingress[0].from_cidr_set[0].cidr == "10.0.0.0/8"
        assert r.ingress[0].from_cidr_set[0].except_cidrs == ("10.96.0.0/12",)
        assert r.ingress[0].to_ports[0].ports[0].port == 443
        repo = m.Repository()
        repo.add_list(rules)
        inside = m.LabelArray(m.cidr_labels("10.1.2.3/32"))
        excepted = m.LabelArray(m.cidr_labels("10.96.1.1/32"))
        return summary(m, repo, [m.parse_label_array([f"{NS}=ns1"]), inside, excepted])

    both(run)


def test_np_named_port_rejected():
    def run(m):
        with pytest.raises(ValueError, match="named port") as e:
            m.parse_network_policy(np_obj({
                "podSelector": {}, "ingress": [{"ports": [{"port": "http", "protocol": "TCP"}]}]}))
        return str(e.value)

    both(run)


# -- test_k8s.py: CNP --------------------------------------------------------------


def test_cnp_namespace_scoping():
    def run(m):
        obj = {
            "kind": "CiliumNetworkPolicy", "apiVersion": "cilium.io/v2",
            "metadata": {"name": "expose", "namespace": "ns1"},
            "spec": {"endpointSelector": {"matchLabels": {"name": "leia"}},
                     "ingress": [{"fromEndpoints": [{"matchLabels": {
                         "k8s:io.kubernetes.pod.namespace": "ns2", "name": "luke"}}]}]},
        }
        repo = m.Repository()
        repo.add_list(m.parse_cnp(obj))
        dst = ["any:name=leia", f"{NS}=ns1"]
        assert allows(m, repo, ["any:name=luke", f"{NS}=ns2"], dst)
        assert not allows(m, repo, ["any:name=luke", f"{NS}=ns1"], dst)
        assert not allows(m, repo, ["any:name=luke", f"{NS}=ns2"], ["any:name=leia", f"{NS}=ns3"])
        sets = [dst, ["any:name=luke", f"{NS}=ns2"], ["any:name=luke", f"{NS}=ns1"],
                ["any:name=leia", f"{NS}=ns3"]]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_cnp_unscoped_peer_gets_policy_namespace():
    def run(m):
        obj = {"kind": "CiliumNetworkPolicy", "metadata": {"name": "p", "namespace": "team-a"},
               "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                        "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}]}]}}
        repo = m.Repository()
        repo.add_list(m.parse_cnp(obj))
        dst = ["any:app=db", f"{NS}=team-a"]
        assert allows(m, repo, ["any:app=web", f"{NS}=team-a"], dst)
        assert not allows(m, repo, ["any:app=web", f"{NS}=team-b"], dst)
        sets = [dst, ["any:app=web", f"{NS}=team-a"], ["any:app=web", f"{NS}=team-b"]]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_cnp_reserved_peer_not_scoped():
    def run(m):
        obj = {"kind": "CiliumNetworkPolicy", "metadata": {"name": "p", "namespace": "team-a"},
               "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                        "ingress": [{"fromEndpoints": [{"matchLabels": {"reserved:host": ""}}]}]}}
        repo = m.Repository()
        repo.add_list(m.parse_cnp(obj))
        assert allows(m, repo, ["reserved:host"], ["any:app=db", f"{NS}=team-a"])
        sets = [["reserved:host"], ["any:app=db", f"{NS}=team-a"]]
        return summary(m, repo, sets, [(a, b) for a in sets for b in sets])

    both(run)


def test_cnp_illegal_namespace_match_overridden():
    def run(m):
        obj = {"kind": "CiliumNetworkPolicy", "metadata": {"name": "p", "namespace": "ns1"},
               "spec": {"endpointSelector": {"matchLabels": {
                   "k8s:io.kubernetes.pod.namespace": "ns9", "app": "db"}},
                   "ingress": [{"fromEndpoints": [{}]}]}}
        rules = m.parse_cnp(obj)
        assert rules[0].endpoint_selector.get_match(NS) == "ns1"
        repo = m.Repository()
        repo.add_list(rules)
        return summary(m, repo, [["any:app=db", f"{NS}=ns1"], ["any:app=db", f"{NS}=ns9"]])

    both(run)


def test_cnp_specs_and_provenance_labels():
    def run(m):
        obj = {"kind": "CiliumNetworkPolicy", "metadata": {"name": "multi", "namespace": "ns1"},
               "specs": [{"endpointSelector": {"matchLabels": {"a": "1"}}},
                         {"endpointSelector": {"matchLabels": {"b": "2"}}}]}
        rules = m.parse_cnp(obj)
        assert len(rules) == 2
        for r in rules:
            strs = r.labels.to_strings()
            assert "k8s:io.cilium.k8s.policy.name=multi" in strs
            assert "k8s:io.cilium.k8s.policy.namespace=ns1" in strs
        repo = m.Repository()
        repo.add_list(rules)
        return summary(m, repo, [["any:a=1", f"{NS}=ns1"], ["any:b=2", f"{NS}=ns1"]])

    both(run)


# -- test_k8s.py: the reference's example fixtures ----------------------------------


@pytest.mark.skipif(not EXAMPLES.exists(), reason="reference examples absent")
def test_all_reference_example_policies_parse():
    def run(m):
        files = sorted(EXAMPLES.rglob("*.json")) + sorted(EXAMPLES.rglob("*.yaml"))
        assert files, "no fixtures found"
        rules = []
        for f in files:
            rules += m.objects_to_rules(m.load_objects(str(f)))
        assert len(rules) >= 20
        return json.loads(m.rules_to_json(rules))

    both(run)


@pytest.mark.skipif(not EXAMPLES.exists(), reason="reference examples absent")
def test_reference_l4_example_verdicts():
    def run(m):
        rules = m.objects_to_rules(m.load_objects(str(EXAMPLES / "l4" / "l4.json")))
        repo = m.Repository()
        repo.add_list(rules)
        ctx = m.SearchContext(src=m.parse_label_array(["any:app=myService"]),
                              dst=m.parse_label_array(["any:role=backend"]))
        l4 = repo.resolve_l4_egress_policy(ctx)
        keys = set(l4.keys()) if hasattr(l4, "keys") else {str(k) for k in l4}
        assert any("80" in str(k) for k in keys)
        return summary(m, repo, [["any:app=myService"], ["any:role=backend"]])

    both(run)


# -- test_k8s.py: ToServices and pod labels ------------------------------------------


def _external_db(m, reg):
    reg.apply_service_object({
        "kind": "Service",
        "metadata": {"name": "external-db", "namespace": "default", "labels": {"tier": "db"}},
        "spec": {"clusterIP": "None", "ports": [{"port": 5432}]},
    })
    reg.apply_endpoints_object({
        "kind": "Endpoints",
        "metadata": {"name": "external-db", "namespace": "default"},
        "subsets": [{"addresses": [{"ip": "192.0.2.10"}, {"ip": "192.0.2.11"}],
                     "ports": [{"port": 5432}]}],
    })


def test_toservices_translation_and_revert():
    def run(m):
        reg = m.ServiceRegistry()
        sid = m.ServiceID("default", "external-db")
        _external_db(m, reg)
        rules = m.rules_from_json(
            """[{"endpointSelector": {"matchLabels": {"app": "web"}},
                 "egress": [{"toServices": [{"k8sService":
                    {"serviceName": "external-db", "namespace": "default"}}]}]}]""")
        translated = m.preprocess_rules(rules, reg)
        cidrs = translated[0].egress[0].to_cidr_set
        assert {c.cidr for c in cidrs} == {"192.0.2.10/32", "192.0.2.11/32"}
        assert all(c.generated for c in cidrs)
        svc, ep = reg.get(sid)
        reverted = m.RuleTranslator(sid, ep, svc.labels, revert=True).translate(translated[0])
        assert reverted.egress[0].to_cidr_set == ()
        repo = m.Repository()
        repo.add_list(list(translated))
        out = summary(m, repo, [["any:app=web"], m.LabelArray(m.cidr_labels("192.0.2.10/32")),
                                m.LabelArray(m.cidr_labels("192.0.2.12/32"))])
        out["reverted"] = json.loads(m.rules_to_json([reverted]))
        return out

    both(run)


def test_toservices_selector_match():
    def run(m):
        reg = m.ServiceRegistry()
        reg.apply_service_object({
            "kind": "Service",
            "metadata": {"name": "svc", "namespace": "default", "labels": {"tier": "db"}},
            "spec": {"clusterIP": "None", "ports": [{"port": 1}]},
        })
        reg.apply_endpoints_object({
            "kind": "Endpoints", "metadata": {"name": "svc", "namespace": "default"},
            "subsets": [{"addresses": [{"ip": "198.51.100.7"}], "ports": [{"port": 1}]}],
        })
        rules = m.rules_from_json(
            """[{"endpointSelector": {"matchLabels": {"app": "web"}},
                 "egress": [{"toServices": [{"k8sServiceSelector":
                    {"selector": {"matchLabels": {"tier": "db"}}}}]}]}]""")
        translated = m.preprocess_rules(rules, reg)
        assert translated[0].egress[0].to_cidr_set[0].cidr == "198.51.100.7/32"
        repo = m.Repository()
        repo.add_list(list(translated))
        return summary(m, repo, [["any:app=web"], m.LabelArray(m.cidr_labels("198.51.100.7/32"))])

    both(run)


def test_pod_labels_include_namespace_meta():
    def run(m):
        lbls = m.pod_labels(
            {"metadata": {"name": "p", "namespace": "ns1", "labels": {"a": "b"}},
             "spec": {"serviceAccountName": "robot"}},
            namespace_labels={"team": "alpha"})
        assert "k8s:a=b" in lbls
        assert "k8s:io.kubernetes.pod.namespace=ns1" in lbls
        assert "k8s:io.cilium.k8s.namespace.labels.team=alpha" in lbls
        assert "k8s:io.cilium.k8s.policy.serviceaccount=robot" in lbls
        return lbls

    both(run)


# -- test_k8s.py: the watcher, through the stand-in -----------------------------------


def _pod(name, ip, app, ns="shop"):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": ns, "labels": {"app": app}},
            "status": {"podIP": ip}}


def _cnp(name, app_subject, app_peer, ns="shop"):
    return {"kind": "CiliumNetworkPolicy", "metadata": {"name": name, "namespace": ns},
            "spec": {"endpointSelector": {"matchLabels": {"app": app_subject}},
                     "ingress": [{"fromEndpoints": [{"matchLabels": {"app": app_peer}}]}]}}


def _svc(name, ip="10.96.0.50", ns="shop"):
    return {"kind": "Service", "metadata": {"name": name, "namespace": ns},
            "spec": {"type": "ClusterIP", "clusterIP": ip,
                     "ports": [{"port": 80, "protocol": "TCP"}]}}


def test_watcher_end_to_end():
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.apply(_pod("web-1", "10.1.0.10", "web"))
        w.apply(_pod("db-1", "10.1.0.20", "db"))
        assert len(a.endpoints) == 2
        w.apply({
            "kind": "CiliumNetworkPolicy",
            "metadata": {"name": "db-guard", "namespace": "shop"},
            "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                     "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}]}]},
        })
        assert allows(m, a.repo, ["k8s:app=web", f"{NS}=shop"], ["k8s:app=db", f"{NS}=shop"])
        assert not allows(m, a.repo, ["k8s:app=other", f"{NS}=shop"],
                          ["k8s:app=db", f"{NS}=shop"])
        mid = agent_state(a)
        w.delete({"kind": "CiliumNetworkPolicy",
                  "metadata": {"name": "db-guard", "namespace": "shop"}})
        assert len(a.repo) == 0
        return [mid, agent_state(a)]

    both(run)


def test_watcher_service_churn_retranslates():
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.add_policy_object({
            "endpointSelector": {"matchLabels": {"app": "web"}},
            "egress": [{"toServices": [{"k8sService": {"serviceName": "ext",
                                                        "namespace": "default"}}]}],
            "labels": ["k8s:io.cilium.k8s.policy.name=svc-rule"],
        })
        w.apply({"kind": "Service", "metadata": {"name": "ext", "namespace": "default"},
                 "spec": {"clusterIP": "None", "ports": [{"port": 9000}]}})
        w.apply({"kind": "Endpoints", "metadata": {"name": "ext", "namespace": "default"},
                 "subsets": [{"addresses": [{"ip": "203.0.113.5"}], "ports": [{"port": 9000}]}]})
        rule = a.repo.rules[0]
        assert any(c.cidr == "203.0.113.5/32" and c.generated
                   for c in rule.egress[0].to_cidr_set)
        mid = agent_state(a)
        w.delete({"kind": "Endpoints", "metadata": {"name": "ext", "namespace": "default"}})
        w.apply({"kind": "Endpoints", "metadata": {"name": "ext", "namespace": "default"},
                 "subsets": []})
        rule = a.repo.rules[0]
        assert not any(c.generated for c in rule.egress[0].to_cidr_set)
        return [mid, agent_state(a),
                summary(m, a.repo, [["k8s:app=web"], m.LabelArray(m.cidr_labels("203.0.113.5/32"))])]

    both(run)


def test_watcher_modified_event_replaces_rules():
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.apply(_pod("web-1", "10.1.0.10", "web"))
        w.apply(_pod("db-1", "10.1.0.20", "db"))
        w.apply(_pod("admin-1", "10.1.0.30", "admin"))
        w.apply(_cnp("guard", "db", "web"))
        n1 = len(a.repo)
        w.apply(_cnp("guard", "db", "web"))
        assert len(a.repo) == n1, "replayed ADDED duplicated rules"
        first = agent_state(a)
        w.apply(_cnp("guard", "db", "admin"))
        assert len(a.repo) == n1
        assert not allows(m, a.repo, ["k8s:app=web", f"{NS}=shop"], ["k8s:app=db", f"{NS}=shop"])
        assert allows(m, a.repo, ["k8s:app=admin", f"{NS}=shop"], ["k8s:app=db", f"{NS}=shop"])
        return [first, agent_state(a)]

    both(run)


def test_watcher_out_of_order_delete_then_add():
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.delete(_cnp("guard", "db", "web"))
        w.delete(_pod("web-1", "10.1.0.10", "web"))
        assert len(a.repo) == 0 and len(a.endpoints) == 0
        w.apply(_cnp("guard", "db", "web"))
        w.apply(_pod("web-1", "10.1.0.10", "web"))
        mid = agent_state(a)
        w.delete(_cnp("guard", "db", "web"))
        w.delete(_cnp("guard", "db", "web"))
        assert len(a.repo) == 0
        assert len(a.endpoints) == 1
        return [mid, agent_state(a)]

    both(run)


def test_watcher_resync_heals_missed_events():
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.apply(_pod("web-1", "10.1.0.10", "web"))
        w.apply(_pod("db-1", "10.1.0.20", "db"))
        w.apply(_cnp("guard", "db", "web"))
        w.apply(_cnp("doomed", "db", "other"))
        w.apply(_svc("kafka"))
        assert len(a.endpoints) == 2
        before = agent_state(a)
        snapshot = [_pod("web-1", "10.1.0.10", "web"), _pod("api-1", "10.1.0.30", "api"),
                    _cnp("guard", "db", "web"), _cnp("extra", "api", "web")]
        w.resync(snapshot)
        assert len(a.endpoints) == 2
        assert ("shop", "api-1") in w.pods.known_pods()
        assert ("shop", "db-1") not in w.pods.known_pods()
        assert {name for name, _ns in w._known_policy_labels()} == {"guard", "extra"}
        assert all(s.name != "kafka" for s in w.services.service_ids())
        healed = agent_state(a)
        rules_before = len(a.repo)
        w.resync(snapshot)
        assert len(a.repo) == rules_before
        assert len(a.endpoints) == 2
        return [before, healed, agent_state(a)]

    both(run)


def test_watcher_resync_heals_stale_endpoints():
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.apply(_svc("kafka"))
        w.apply({"kind": "Endpoints", "metadata": {"name": "kafka", "namespace": "shop"},
                 "subsets": [{"addresses": [{"ip": "10.1.0.40"}],
                              "ports": [{"port": 80, "protocol": "TCP"}]}]})
        sid = m.ServiceID("shop", "kafka")
        assert w.services.get(sid)[1] is not None
        before = agent_state(a)
        w.resync([_svc("kafka")])
        info, eps = w.services.get(sid)
        assert info is not None, "service wrongly deleted"
        assert eps is None, "stale Endpoints survived resync"
        return [before, agent_state(a)]

    both(run)


# -- the stand-in against the JAX Daemon ---------------------------------------------


def _daemon_events(w):
    """test_k8s.py:394's sequence, then services with their Endpoints, a
    pod relabelled, an Ingress and a resync that reaps."""
    w.apply(_pod("web-1", "10.1.0.10", "web"))
    w.apply(_pod("db-1", "10.1.0.20", "db"))
    w.apply(_cnp("guard", "db", "web"))
    w.apply(_cnp("doomed", "db", "other"))
    w.apply(_svc("kafka"))
    w.apply({"kind": "Endpoints", "metadata": {"name": "kafka", "namespace": "shop"},
             "subsets": [{"addresses": [{"ip": "10.1.0.20"}, {"ip": "10.1.0.10"}],
                          "ports": [{"port": 9092, "protocol": "TCP"}]}]})
    w.add_policy_object({
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "egress": [{"toServices": [{"k8sService": {"serviceName": "ext", "namespace": "shop"}}]}],
        "labels": ["k8s:io.cilium.k8s.policy.name=svc-rule"],
    })
    w.apply({"kind": "Service", "metadata": {"name": "ext", "namespace": "shop"},
             "spec": {"clusterIP": "10.96.0.60", "ports": [{"name": "db", "port": 5432}]}})
    w.apply({"kind": "Endpoints", "metadata": {"name": "ext", "namespace": "shop"},
             "subsets": [{"addresses": [{"ip": "198.18.0.7"}],
                          "ports": [{"name": "db", "port": 5432}]}]})
    w.apply({"kind": "Ingress", "metadata": {"name": "ing", "namespace": "shop"},
             "spec": {"backend": {"serviceName": "kafka", "servicePort": 9092}}})
    w.delete(_pod("db-1", "10.1.0.20", "db"))
    w.apply(_pod("db-1", "10.1.0.20", "cache"))
    w.resync([_pod("web-1", "10.1.0.10", "web"), _pod("db-1", "10.1.0.20", "cache"),
              _pod("api-1", "10.1.0.30", "api"), _cnp("guard", "db", "web"),
              _cnp("extra", "api", "web"), _svc("kafka"),
              {"kind": "Endpoints", "metadata": {"name": "kafka", "namespace": "shop"},
               "subsets": [{"addresses": [{"ip": "10.1.0.30"}],
                            "ports": [{"port": 9092, "protocol": "TCP"}]}]},
              {"kind": "Ingress", "metadata": {"name": "ing", "namespace": "shop"},
               "spec": {"backend": {"serviceName": "kafka", "servicePort": 9092}}}])


def _world_of(repo, endpoints, ipcache, services):
    return {
        "rules": json.loads(_mod("cilium_tpu", "policy.api.serialization").rules_to_json(
            list(repo.rules))),
        "endpoints": sorted((i, ident, labels, ipv4) for i, ident, labels, ipv4 in endpoints),
        "ipcache": sorted((p, e.identity, e.source) for p, e in ipcache.items()),
        "lb": [(str(s.frontend), [(b.ip, b.port, b.weight) for b in s.backends])
               for s in services.list()],
    }


def test_stand_in_matches_the_daemon(tmp_path):
    """The JAX stand-in and the JAX Daemon, each under a K8sWatcher, given
    the same events: equal rules, endpoints with their identities,
    ipcache entries and LB frontends with their backends."""
    daemon_mod = _mod("cilium_tpu", "daemon")
    m = ns("cilium_tpu")
    d = daemon_mod.Daemon(state_dir=str(tmp_path / "state"))
    d.services.host_ip = "192.168.40.1"
    try:
        _daemon_events(m.K8sWatcher(d))
        a = m.Agent(host_ip="192.168.40.1")
        _daemon_events(m.K8sWatcher(a))
        want = _world_of(d.repo, [(ep.id, ep.identity.id, sorted(str(x) for x in ep.labels),
                                   ep.ipv4) for ep in d.endpoint_manager.endpoints()],
                         d.ipcache, d.services)
        got = _world_of(a.repo, [(e.id, e.identity.id, sorted(str(x) for x in e.labels), e.ipv4)
                                 for e in a.endpoints.values()], a.ipcache, a.services)
        assert got == want
        assert len(got["endpoints"]) == 3 and got["lb"] and got["rules"]
    finally:
        d.shutdown()


def test_stand_in_sequence_matches_across_packages():
    """The same event sequence through each package's stand-in: equal
    state, engine verdicts and pipeline verdicts."""
    def run(m):
        a = m.Agent(host_ip="192.168.40.1")
        _daemon_events(m.K8sWatcher(a))
        return agent_state(a)

    out = both(run)
    assert len(out["endpoints"]) == 3 and out["lb"]
