"""How long the k8s watcher's resync of chip_smoke's phase 3r cluster
takes on the host, with the engine left out: a probe, not a test.

    python3 tools/k8s_sync_size.py [POLICIES:SERVICES ...]

Builds chip_smoke.k8s_cluster(0, policies, services) for each pair
(default 256:256 512:256 1024:256 512:1024), resyncs its objects in the
Informer's kind order through cilium_tpu_torch.k8s.K8sWatcher into a
chip_smoke.K8sAgent on the CPU (no checkpoint, so no engine work), polls
the toFQDNs names once, then resyncs the same objects again. Prints the
rules, endpoints and frontends it made, both resyncs' walls and, of the
first, the time spent in policy_replace, in policy_translate and in the
LB sync (ServiceManager.sync_from_registry). Runs on any machine; no
card needed.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402
from cilium_tpu_torch.fqdn import DNSPoller  # noqa: E402
from cilium_tpu_torch.k8s import K8sWatcher  # noqa: E402


def size(n_policies: int, n_services: int) -> None:
    cl = c.k8s_cluster(0, n_policies, n_services)
    agent = c.K8sAgent(c.K8S_HOST_IP, "10.0.0.0/16", device="cpu")
    watcher = K8sWatcher(agent)
    watcher.node_name = c.K8S_NODE
    secs = {"policy_replace": 0.0, "policy_translate": 0.0, "sync_from_registry": 0.0}

    def timed_on(obj, name):
        real = getattr(obj, name)

        def call(*a, **k):
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                secs[name] += time.perf_counter() - t
        setattr(obj, name, call)

    timed_on(agent, "policy_replace")
    timed_on(agent, "policy_translate")
    timed_on(agent.services, "sync_from_registry")
    snap = c.k8s_snapshot(cl["objects"])
    t0 = time.perf_counter()
    watcher.resync(snap)
    first = time.perf_counter() - t0
    parts = dict(secs)
    poller = DNSPoller(agent.repo, resolver=lambda name: cl["answers"].get(name, ([], 0.0)))
    t0 = time.perf_counter()
    changed = poller.poll_once(now=0.0)
    poll = time.perf_counter() - t0
    t0 = time.perf_counter()
    watcher.resync(snap)
    second = time.perf_counter() - t0
    print(f"policies {n_policies}, services {n_services}: {len(agent.repo.rules)} rules, "
          f"{len(agent.endpoints)} endpoints, {len(agent.services.list())} frontends; resync "
          f"{first:.3f}s (policy_replace {parts['policy_replace']:.3f}s, policy_translate "
          f"{parts['policy_translate']:.3f}s, sync_from_registry "
          f"{parts['sync_from_registry']:.3f}s); poll {poll:.4f}s ({changed} rules); the "
          f"same resync again {second:.3f}s", flush=True)


def main() -> None:
    pairs = sys.argv[1:] or ["256:256", "512:256", "1024:256", "512:1024"]
    for p in pairs:
        n_pol, n_svc = (int(x) for x in p.split(":"))
        size(n_pol, n_svc)


if __name__ == "__main__":
    main()
