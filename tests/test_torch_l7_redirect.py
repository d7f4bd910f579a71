"""Port parity: the L7 redirect path from the verdict path to the proxy.

The same small random world (``build_world``, with L7-HTTP rules)
goes through each package: ``DatapathPipeline.process`` marks the
flows whose policymap entry redirects; every endpoint gets its
redirects built from ``resolve_l4_policy`` as the JAX package's
endpoint regeneration builds them; one HTTP request per redirected
flow goes through ``Proxy.check_http`` with ``L7DeviceBatch`` off and
on. Verdicts, redirect bits, allow bits and access logs must be equal,
and the allow bits must equal ``re.fullmatch`` of the rules.
"""

from __future__ import annotations

import importlib
import ipaddress

import numpy as np
import pytest

from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from test_torch_harness import PKGS, build_world, random_flows

N_EPS = 6
N_FLOWS = 20_000
METHODS = np.array(["GET", "POST", "PUT"])
PATHS = np.array(["/api/x", "/api/", "/api", "/other", "/api/v1/" + "a" * 300])


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def build_redirects(pkg, repo, registry, proxy, ep_id, ep_labels, **kw):
    """One redirect per redirecting L4 filter of the endpoint, each with
    an HTTPPolicy / KafkaACL whose rules are scoped to the identities
    its peer selector matches: the logic of the JAX package's
    endpoint/endpoint.py:199-247 ``_update_redirects``, whose endpoint
    module the port does not have yet."""
    l7, api = _mod(pkg, "l7"), _mod(pkg, "policy.api")
    l4 = repo.resolve_l4_policy(ep_labels)
    identities = list(registry)
    for direction_map, ingress in ((l4.ingress, True), (l4.egress, False)):
        for f in direction_map:
            if not f.is_redirect:
                continue
            http_rules, kafka_rules = [], []
            for sel, rules in f.l7_rules_per_ep.items():
                idents = None if sel.is_wildcard else {
                    i.id for i in identities if sel.matches(i.labels)}
                http_rules += [(hr, idents) for hr in rules.http]
                kafka_rules += [(kr, idents) for kr in rules.kafka]
                if not rules.http and not rules.kafka:
                    # wildcarded L7: this peer passes the proxy unrestricted
                    if f.l7_parser == "http":
                        http_rules.append((api.HTTPRule(), idents))
                    elif f.l7_parser == "kafka":
                        kafka_rules.append((api.KafkaRule(), idents))
            proxy.create_or_update_redirect(
                ep_id, f.port, f.l7_parser, ingress=ingress,
                http_policy=l7.HTTPPolicy(http_rules, **kw) if f.l7_parser == "http" else None,
                kafka_acl=l7.KafkaACL(kafka_rules, **kw) if f.l7_parser == "kafka" else None,
            )


def _run(pkg: str, seed: int, n_rules: int, on: bool):
    kw = {"device": "cpu"} if pkg == "cilium_tpu_torch" else {}
    rt = _mod(pkg, "datapath.l7_pipeline")
    rt._reset_for_tests()
    rt.set_device_batch(on, **kw)
    try:
        w = build_world(pkg, seed, n_rules=n_rules)
        if kw:
            pipe = tpipe.DatapathPipeline(TorchEngine(w.repo, w.reg, device="cpu"), w.ipcache,
                                          device="cpu")
        else:
            pipe = jpipe.DatapathPipeline(JaxEngine(w.repo, w.reg), w.ipcache)
        eps = [i.id for i in w.idents[:N_EPS]]
        pipe.set_endpoints(eps)
        peers, ep_idx, dports, protos = random_flows(w, N_FLOWS, N_EPS, seed)
        verdicts, redirect = pipe.process(peers, ep_idx, dports, protos, ingress=True)
        proxy = _mod(pkg, "proxy").Proxy()
        labels = _mod(pkg, "labels")
        for ep in eps:
            build_redirects(pkg, w.repo, w.reg, proxy, ep, labels.parse_label_array(
                w.ident_labels[ep]), **kw)
        world_id = _mod(pkg, "identity.model").ID_WORLD
        ip_ident = {ip: (world_id if ident is None else ident.id)
                    for ip, ident in zip(w.peer_ips, w.peer_idents)}
        rs = np.random.default_rng(seed + 1)
        idx = np.nonzero(redirect)[0]
        methods, paths = rs.choice(METHODS, idx.size), rs.choice(PATHS, idx.size)
        src = np.array([ip_ident[str(ipaddress.IPv4Address(int(p)))] for p in peers[idx]],
                       np.int64)
        allow = np.zeros(idx.size, bool)
        oracle = np.zeros(idx.size, bool)
        l7 = _mod(pkg, "l7")
        groups = ep_idx[idx].astype(np.int64) * 65536 + dports[idx]
        for g in np.unique(groups):
            sel = np.nonzero(groups == g)[0]
            r = proxy.lookup(eps[int(g) // 65536], int(g) % 65536, ingress=True)
            assert r is not None and r.parser == "http"
            reqs = [l7.HTTPRequest(method=str(methods[j]), path=str(paths[j]),
                                   src_identity=int(src[j])) for j in sel]
            allow[sel] = proxy.check_http(r, reqs)
            oracle[sel] = [any(cr.rule.matches(q.method, q.path, q.host)
                               and (cr.allowed_identities is None
                                    or q.src_identity in cr.allowed_identities)
                               for cr in r.http_policy._rules) for q in reqs]
        log = [(x.verdict, x.src_identity, x.dst_port, x.http["path"])
               for x in proxy.accesslog.recent(100_000)]
        return verdicts, redirect, allow, oracle, log, groups
    finally:
        rt._reset_for_tests()


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("seed,n_rules", [(11, 24), (5, 96)])
def test_redirected_requests_through_the_proxy_match_jax(seed, n_rules, on):
    """Worlds whose first endpoints redirect a few hundred of the
    flows (most seeds of the small world redirect almost none)."""
    j, t = (_run(pkg, seed, n_rules, on) for pkg in PKGS)
    for a, b in zip(j[:4], t[:4]):
        np.testing.assert_array_equal(b, a)
    assert t[4] == j[4]
    np.testing.assert_array_equal(t[2], t[3])  # == re.fullmatch of the scoped rules
    assert t[1].sum() > 100 and t[2].any() and not t[2].all()
    # some redirects get enough requests to take the device walks
    assert np.unique(t[5], return_counts=True)[1].max() >= 32
