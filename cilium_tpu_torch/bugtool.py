"""bugtool / debuginfo: one-shot state capture for support.

Reference: bugtool/ (cilium-bugtool archives `cilium status`, map
dumps, logs, sysctl) and the /debuginfo REST endpoint
(daemon/debuginfo.go). Here the capture walks the daemon object:
status, policy rules, endpoints + realized policymaps, identities,
services, ipcache, prefilter, conntrack summary, health report,
metrics text, and recent L7 access logs — everything an operator
needs to reconstruct verdict behavior offline.
"""

from __future__ import annotations

import io
import json
import tarfile
import time
from typing import Dict

# Every bundled JSON artifact that external tooling diffs offline
# carries a top-level identification header: ``schema`` (the artifact
# vocabulary, versioned independently of the package) + ``generated_at``
# (one capture-wide wall timestamp — all artifacts of an archive stamp
# the SAME instant, so cross-artifact joins don't skew).
ARTIFACT_SCHEMAS: Dict[str, str] = {
    "traces": "cilium-tpu/traces/v1",
    "flows": "cilium-tpu/flows/v1",
    "profile": "cilium-tpu/profile/v1",
    "fleet": "cilium-tpu/fleet/v1",
    "ct": "cilium-tpu/ct/v1",
    "cluster": "cilium-tpu/cluster/v1",
    "events": "cilium-tpu/events/v1",
}


def _stamp(key: str, payload: Dict, ts: float) -> Dict:
    out = {"schema": ARTIFACT_SCHEMAS[key], "generated_at": ts}
    out.update(payload)
    return out


def collect_debuginfo(daemon) -> Dict:
    """The GET /debuginfo payload (daemon/debuginfo.go)."""
    ipcache = {
        cidr: {"identity": e.identity, "source": e.source,
               "host_ip": e.host_ip}
        for cidr, e in daemon.ipcache.items()
    }
    pf_rev, pf_cidrs = daemon.prefilter.dump()
    endpoints = daemon.endpoint_list()
    policymaps = {}
    for em in endpoints:
        eid = em["id"]
        try:
            policymaps[eid] = {
                "ingress": daemon.policymap_dump(eid, ingress=True),
                "egress": daemon.policymap_dump(eid, ingress=False),
            }
        except Exception as e:  # a broken endpoint must not kill capture
            policymaps[eid] = {"error": f"{type(e).__name__}: {e}"}
    ct = daemon.conntrack
    now = time.time()
    return {
        "timestamp": now,
        "status": daemon.status(),
        "policy": daemon.policy_get(),
        "endpoints": endpoints,
        "policymaps": policymaps,
        "identities": daemon.identity_list(),
        "services": daemon.service_list(),
        "ipcache": ipcache,
        "prefilter": {"revision": pf_rev, "cidrs": pf_cidrs},
        "conntrack": {
            "entries": len(ct) if ct is not None else 0,
            "capacity": ct.capacity if ct is not None else 0,
        },
        # policyd-survive → ct.json: continuity evidence — live table
        # summary plus the provenance of the last restart's CT restore
        # (where it loaded from, snapshot age, kept vs flushed), so an
        # operator can tell a warm restart from a forced cold flush
        "ct": _stamp("ct", {
            "entries": len(ct) if ct is not None else 0,
            "capacity": ct.capacity if ct is not None else 0,
            "version": ct.version if ct is not None else 0,
            "sample": daemon.ct_dump()[:32],
            "restore": daemon.ct_restore_info(),
        }, now),
        "fqdn": {
            "names": daemon.fqdn.tracked_names(),
            "failures": daemon.fqdn.failures,
        },
        "health": daemon.health.report(),
        # policyd-fed → cluster.json: federation membership, per-node
        # published policy epochs, and identity-allocator accounting
        "cluster": _stamp("cluster", daemon.cluster_status(), now),
        # policyd-fleetobs → fleet.json: the aggregated telemetry
        # scoreboard ({"enabled": false} when FleetTelemetry is off)
        "fleet": _stamp("fleet", daemon.fleet_status(), now),
        "accesslog": [r.to_dict() for r in daemon.proxy.accesslog.recent(200)],
        # policyd-trace ring (metrics.prom in the archive carries the
        # matching /metrics snapshot via write_archive_from)
        "traces": _stamp("traces", daemon.traces(limit=64), now),
        # policyd-flows ring → flows.json in the archive: the sampled
        # attributed flows an operator replays offline against
        # policy.json to explain each verdict
        "flows": _stamp("flows", daemon.flows(limit=64), now),
        # policyd-prof → profile.json: sampled RTT decomposition +
        # memory/transfer ledgers, so offline bundles carry the full
        # telemetry surface
        "profile": _stamp("profile", daemon.profile(), now),
        # policyd-journal → events.json: the lifecycle event journal
        # tail ({"enabled": false} while LifecycleJournal is off), the
        # causal spine an operator lines the other artifacts up against
        "events": _stamp("events", daemon.events(limit=256), now),
        # raw Prometheus exposition IN the payload: a remote
        # /debuginfo fetch then archives the same metrics.prom a
        # live-daemon capture gets (write_archive_from pops this key)
        "metrics": daemon.metrics_text(),
    }


def write_archive(daemon, path: str) -> str:
    """cilium-bugtool against a live in-process daemon."""
    return write_archive_from(collect_debuginfo(daemon),
                              daemon.metrics_text(), path)


def write_archive_from(info: Dict, metrics_text: str, path: str) -> str:
    """cilium-bugtool: write a tar.gz of per-subsystem JSON files plus
    the raw Prometheus metrics text. Accepts the /debuginfo payload so
    the CLI can archive a REMOTE daemon over REST. Returns the path."""
    info = dict(info)
    # the payload's own exposition text (remote captures) becomes
    # metrics.prom, not a JSON-encoded metrics.json; an explicit
    # metrics_text (live-daemon capture) wins
    payload_metrics = info.pop("metrics", None)
    members = {f"{key}.json": json.dumps(value, indent=1, default=str)
               for key, value in info.items()}
    members["metrics.prom"] = metrics_text or payload_metrics or ""
    with tarfile.open(path, "w:gz") as tar:
        for name, text in sorted(members.items()):
            data = text.encode()
            ti = tarfile.TarInfo(name=f"cilium-tpu-bugtool/{name}")
            ti.size = len(data)
            ti.mtime = int(time.time())
            tar.addfile(ti, io.BytesIO(data))
    return path
