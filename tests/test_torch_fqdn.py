"""Port parity: DNS policy, ``fqdn/`` (``DNSCache``, ``FQDNTranslator``,
``DNSPoller``), copied from the JAX package.

The nine Daemon-free tests of the reference's ``test_fqdn.py`` run against
both packages through their public names, each with the reference's
assertions; the two runs must return equal cache answers, rule JSON,
oracle decisions and engine verdicts on the CPU (``test_torch_k8s.both``).
The resolver is always a seeded table and ``now`` is pinned: nothing
asks the host's DNS. The last test moves a name's answer under a poller
whose ``on_change`` regenerates a stand-in agent (CIDR identities for the
rules' prefixes in its ipcache) and holds the pipeline's egress verdicts
to the old and new addresses in both packages. ``TestDaemonFQDN`` needs
the daemon and comes with A7c.
"""

from __future__ import annotations

import ipaddress
import json

import numpy as np

from test_torch_k8s import PORTS, _arr, both, engine_verdicts


def _fqdn_rule(m):
    return m.rule(
        ["k8s:app=web"],
        egress=[m.EgressRule(to_fqdns=("db.example.com",),
                             to_cidr_set=(m.CIDRRule("203.0.113.0/24"),))],
        labels=["k8s:policy=fq0"],
    )


def _rules(m, repo):
    return json.loads(m.rules_to_json(list(repo.rules)))


def _sets(m, *cidrs):
    return [m.parse_label_array(["k8s:app=web"])] + [m.LabelArray(m.cidr_labels(c)) for c in cidrs]


# -- TestDNSCache ---------------------------------------------------------------


def test_update_lookup_expire():
    def run(m):
        c = m.DNSCache(min_ttl=0)
        out = [c.update("db.example.com", ["10.0.0.1"], ttl=10, now=100.0)]
        assert out[-1]
        assert c.lookup("db.example.com", now=105.0) == ["10.0.0.1"]
        out.append(c.update("db.example.com", ["10.0.0.1"], ttl=10, now=105.0))
        assert not out[-1]
        out.append(c.update("db.example.com", ["10.0.0.2"], ttl=10, now=105.0))
        assert out[-1]
        assert c.lookup("db.example.com", now=106.0) == ["10.0.0.1", "10.0.0.2"]
        assert c.lookup("db.example.com", now=114.0) == ["10.0.0.1", "10.0.0.2"]
        changed = c.expire(now=120.0)
        assert changed == ["db.example.com"]
        assert c.lookup("db.example.com", now=120.0) == []
        return out, changed

    both(run)


def test_min_ttl_floor():
    def run(m):
        c = m.DNSCache(min_ttl=60)
        c.update("x.io", ["1.1.1.1"], ttl=1, now=0.0)
        assert c.lookup("x.io", now=30.0) == ["1.1.1.1"]
        return c.lookup("x.io", now=30.0), c.lookup("x.io", now=61.0)

    both(run)


# -- TestTranslator ---------------------------------------------------------------


def test_generated_entries_replace_only_fqdn_ones():
    def run(m):
        cache = m.DNSCache(min_ttl=0)
        cache.update("db.example.com", ["10.9.0.5"], ttl=100, now=0.0)
        r = m.FQDNTranslator(cache, now=1.0).translate(_fqdn_rule(m))
        cs = r.egress[0].to_cidr_set
        assert [c.cidr for c in cs] == ["203.0.113.0/24", "10.9.0.5/32"]
        assert cs[1].generated and cs[1].generated_by == "fqdn"
        cache.update("db.example.com", ["10.9.0.6"], ttl=100, now=200.0)
        cache.expire(now=200.0)
        r2 = m.FQDNTranslator(cache, now=200.0).translate(r)
        assert [c.cidr for c in r2.egress[0].to_cidr_set] == ["203.0.113.0/24", "10.9.0.6/32"]
        out = []
        for rr in (r, r2):
            repo = m.Repository()
            repo.add_list([rr])
            out.append((_rules(m, repo), engine_verdicts(m, repo, _sets(
                m, "10.9.0.5/32", "10.9.0.6/32", "203.0.113.9/32"))))
        return out

    both(run)


def test_rule_without_fqdns_untouched():
    def run(m):
        r = m.rule(["k8s:app=web"], egress=[m.EgressRule(to_cidr=("10.0.0.0/8",))])
        assert m.FQDNTranslator(m.DNSCache(), now=0.0).translate(r) is r
        return json.loads(m.rules_to_json([r]))

    both(run)


# -- TestPoller ---------------------------------------------------------------------


def test_poll_injects_rules_and_flips_verdict():
    def run(m):
        repo = m.Repository()
        repo.add_list([_fqdn_rule(m)])
        answers = {"db.example.com": (["10.9.0.5"], 300.0)}
        revs = []
        poller = m.DNSPoller(repo, resolver=lambda name: answers.get(name, ([], 0.0)),
                             on_change=lambda rev: revs.append(rev))
        assert poller.tracked_names() == ["db.example.com"]
        web = m.parse_label_array(["k8s:app=web"])
        ctx = m.SearchContext(src=web, dst=m.LabelArray(m.cidr_labels("10.9.0.5/32")))
        sets = _sets(m, "10.9.0.5/32", "10.9.0.6/32")
        out = [engine_verdicts(m, repo, sets)]
        assert repo.allows_egress(ctx) == m.Decision.DENIED
        r0 = repo.revision
        assert poller.poll_once(now=0.0) == 1
        assert repo.revision > r0 and revs
        assert repo.allows_egress(ctx) == m.Decision.ALLOWED
        out.append((_rules(m, repo), engine_verdicts(m, repo, sets)))
        r1 = repo.revision
        assert poller.poll_once(now=1.0) == 0
        assert repo.revision == r1
        answers["db.example.com"] = (["10.9.0.6"], 300.0)
        assert poller.poll_once(now=1000.0) == 1
        assert repo.allows_egress(ctx) == m.Decision.DENIED
        ctx6 = m.SearchContext(src=web, dst=m.LabelArray(m.cidr_labels("10.9.0.6/32")))
        assert repo.allows_egress(ctx6) == m.Decision.ALLOWED
        out.append((_rules(m, repo), engine_verdicts(m, repo, sets), revs))
        # the flip in the engine: egress decisions web -> 10.9.0.5, 10.9.0.6 on 80/TCP
        def flip(v):
            return v[1][0][len(PORTS)], v[1][0][2 * len(PORTS)]

        assert [flip(out[0]), flip(out[1][1]), flip(out[2][1])] == [(2, 2), (1, 2), (2, 1)]
        return out

    both(run)


def test_resolver_failure_keeps_cached_ips():
    def run(m):
        repo = m.Repository()
        repo.add_list([_fqdn_rule(m)])
        answers = {"db.example.com": (["10.9.0.5"], 300.0)}
        poller = m.DNSPoller(repo, resolver=lambda n: answers[n])
        poller.poll_once(now=0.0)
        answers["db.example.com"] = ([], 0.0)
        assert poller.poll_once(now=10.0) == 0
        web = m.parse_label_array(["k8s:app=web"])
        ctx = m.SearchContext(src=web, dst=m.LabelArray(m.cidr_labels("10.9.0.5/32")))
        assert repo.allows_egress(ctx) == m.Decision.ALLOWED
        kept = (_rules(m, repo), engine_verdicts(m, repo, _sets(m, "10.9.0.5/32")))
        assert poller.poll_once(now=1000.0) == 1
        assert repo.allows_egress(ctx) == m.Decision.DENIED
        return kept, _rules(m, repo), engine_verdicts(m, repo, _sets(m, "10.9.0.5/32"))

    both(run)


# -- the translators together ----------------------------------------------------


def _mix_repo(m, sid_name, backend, label):
    reg = m.ServiceRegistry()
    sid = m.ServiceID("default", sid_name)
    reg.upsert_service(sid, m.ServiceInfo(cluster_ip=""))
    if backend is not None:
        reg.upsert_endpoints(sid, m.ServiceEndpoint(backend_ips=(backend,)))
    repo = m.Repository()
    repo.add_list([m.rule(
        ["k8s:app=web"],
        egress=[m.EgressRule(
            to_services=(m.ServiceSelector(name=sid_name, namespace="default"),),
            to_fqdns=("db.example.com",),
        )],
        labels=[label],
    )])
    return reg, repo


def test_fqdn_and_service_translators_coexist():
    def run(m):
        reg, repo = _mix_repo(m, "ext", "192.0.2.8", "k8s:policy=mix")
        cache = m.DNSCache(min_ttl=0)
        cache.update("db.example.com", ["10.9.0.5"], ttl=1000, now=0.0)
        m.DNSPoller(repo, resolver=lambda n: (["10.9.0.5"], 1000.0), cache=cache).poll_once(now=0.0)
        repo.translate_rules(m.RegistryTranslator(reg))
        cidrs = {(c.cidr, c.generated_by) for c in repo.rules[0].egress[0].to_cidr_set}
        assert ("10.9.0.5/32", "fqdn") in cidrs
        assert ("192.0.2.8/32", "service") in cidrs
        return _rules(m, repo), engine_verdicts(m, repo, _sets(m, "10.9.0.5/32", "192.0.2.8/32"))

    both(run)


def test_service_backend_survives_dns_move():
    def run(m):
        reg, repo = _mix_repo(m, "ext", "10.9.0.5", "k8s:policy=mix2")
        cache = m.DNSCache(min_ttl=0)
        poller = m.DNSPoller(repo, resolver=lambda n: ([], 0.0), cache=cache)
        cache.update("db.example.com", ["10.9.0.5"], ttl=100, now=0.0)
        poller.poll_once(now=0.0)
        repo.translate_rules(m.RegistryTranslator(reg))
        owners = {(c.cidr, c.generated_by) for c in repo.rules[0].egress[0].to_cidr_set}
        assert ("10.9.0.5/32", "service") in owners
        first = _rules(m, repo)
        cache.update("db.example.com", ["10.9.0.77"], ttl=100, now=300.0)
        cache.expire(now=300.0)
        poller.poll_once(now=300.0)
        owners = {(c.cidr, c.generated_by) for c in repo.rules[0].egress[0].to_cidr_set}
        assert ("10.9.0.5/32", "service") in owners
        assert ("10.9.0.77/32", "fqdn") in owners
        assert ("10.9.0.5/32", "fqdn") not in owners
        return first, _rules(m, repo), engine_verdicts(m, repo, _sets(
            m, "10.9.0.5/32", "10.9.0.77/32"))

    both(run)


def test_legacy_untagged_generated_entries_are_service_owned():
    def run(m):
        repo = m.Repository()
        repo.add_list([m.rule(
            ["k8s:app=web"],
            egress=[m.EgressRule(
                to_services=(m.ServiceSelector(name="gone", namespace="default"),),
                to_cidr_set=(m.CIDRRule("192.0.2.8/32", generated=True),),
            )],
            labels=["k8s:policy=legacy"],
        )])
        repo.translate_rules(m.RegistryTranslator(m.ServiceRegistry()))
        assert repo.rules[0].egress[0].to_cidr_set == ()
        return _rules(m, repo)

    both(run)


# -- the poller's flip through the pipeline ------------------------------------------


def test_poller_flip_through_the_pipeline():
    """A pod under a toFQDNs rule, a DNSPoller whose on_change regenerates
    the stand-in agent, the rules' prefixes given CIDR identities in its
    ipcache: the pipeline's egress verdicts from the pod to the old and
    the new answer flip when the answer moves, equal in both packages."""
    def run(m):
        a = m.Agent()
        w = m.K8sWatcher(a)
        w.apply({"kind": "Pod", "metadata": {"name": "web-1", "namespace": "shop",
                                             "labels": {"app": "web"}},
                 "status": {"podIP": "10.1.0.10"}})
        a.policy_replace(["k8s:policy=fq0"], m.rules_to_json([m.rule(
            ["k8s:app=web"], egress=[m.EgressRule(to_fqdns=("db.example.com",))],
            labels=["k8s:policy=fq0"])]))
        answers = {"db.example.com": (["10.9.0.5"], 300.0)}
        cidr_ids = {}

        def on_change(rev):
            want = {c.cidr for r in a.repo.rules for eg in r.egress for c in eg.to_cidr_set}
            for p in sorted(set(cidr_ids) - want):
                a.ipcache.delete(p, "generated")
                a.registry.release(cidr_ids.pop(p))
            for p in sorted(want - set(cidr_ids)):
                cidr_ids[p] = a.registry.allocate(m.LabelArray(m.cidr_labels(p)), local=True)
                a.ipcache.upsert(p, cidr_ids[p].id, source="generated")
            a._regenerate("fqdn")

        poller = m.DNSPoller(a.repo, resolver=lambda n: answers.get(n, ([], 0.0)),
                             on_change=on_change)
        peers = np.array([int(ipaddress.IPv4Address(ip)) for ip in ("10.9.0.5", "10.9.0.6")],
                         np.uint32)
        eps = np.zeros(2, np.int32)

        def verdicts():
            v, red = a.pipeline.process(peers, eps, np.full(2, 443, np.int32),
                                        np.full(2, 6, np.int32), ingress=False,
                                        sports=np.array([1024, 1025]))
            return _arr(v), _arr(red)

        out = [verdicts()]
        assert poller.poll_once(now=0.0) == 1
        out.append(verdicts())
        answers["db.example.com"] = (["10.9.0.6"], 300.0)
        assert poller.poll_once(now=1000.0) == 1
        out.append(verdicts())
        assert [o[0] for o in out] == [[2, 2], [1, 2], [2, 1]]
        return out, sorted(cidr_ids), a.asks

    both(run)
