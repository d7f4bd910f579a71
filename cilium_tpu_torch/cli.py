"""CLI — the `cilium` command surface (reference:
cilium/cmd, 73 cobra commands; this implements the core operational
set: policy import/get/delete/trace, endpoint list/add/delete,
identity get/list, bpf policy get, prefilter, status, metrics, daemon).

Two modes, decided per invocation:

- **daemon mode**: if the API socket exists (``--socket`` /
  ``$CILIUM_TPU_SOCK``), commands go over REST like the reference CLI
  talks to cilium-agent.
- **standalone mode**: otherwise an in-process Daemon is constructed
  over the state dir (``--state`` / ``$CILIUM_TPU_STATE``), so `policy
  trace` works offline against imported policy — the offline-verdict
  flow of cilium/cmd/policy_trace.go.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import List, Optional

DEFAULT_SOCK = os.environ.get("CILIUM_TPU_SOCK", "/tmp/cilium_tpu.sock")
DEFAULT_STATE = os.environ.get(
    "CILIUM_TPU_STATE", os.path.expanduser("~/.cilium_tpu")
)


class _Surface:
    """Uniform facade over APIClient (daemon mode) or Daemon
    (standalone)."""

    def __init__(self, socket_path: str, state_dir: str, device=None) -> None:
        self._client = None
        self._daemon = None
        if os.path.exists(socket_path):
            from .api.client import APIClient

            self._client = APIClient(socket_path)
        else:
            from .daemon import Daemon

            self._daemon = Daemon(state_dir=state_dir, device=device)

    def __getattr__(self, name):
        if self._client is not None:
            return getattr(self._client, name)
        return getattr(self, "_d_" + name)

    # -- standalone adapters (mirror APIClient's surface) ---------------
    def _d_status(self):
        return self._daemon.status()

    def _d_metrics(self):
        return self._daemon.metrics_text()

    def _d_policy_get(self):
        return self._daemon.policy_get()

    def _d_policy_put(self, rules):
        return self._daemon.policy_add(json.dumps(rules))

    def _d_policy_delete(self, labels):
        return self._daemon.policy_delete(labels)

    def _d_policy_resolve(self, src, dst, dports=(), *, ingress=True, verbose=False):
        return self._daemon.policy_resolve(
            src, dst, dports, ingress=ingress, verbose=verbose
        )

    def _d_endpoint_list(self):
        return self._daemon.endpoint_list()

    def _d_endpoint_put(self, ep_id, labels, ipv4=None, ipv6=None):
        return self._daemon.endpoint_add(ep_id, labels, ipv4=ipv4, ipv6=ipv6)

    def _d_endpoint_delete(self, ep_id):
        return {"deleted": self._daemon.endpoint_delete(ep_id)}

    def _d_policymap_get(self, ep_id, *, egress=False):
        return self._daemon.policymap_dump(ep_id, ingress=not egress)

    def _d_identity_list(self):
        return self._daemon.identity_list()

    def _d_identity_get(self, num):
        out = self._daemon.identity_get(num)
        if out is None:
            raise SystemExit(f"identity {num} not found")
        return out

    def _d_health(self):
        return self._daemon.health_report()

    def _d_health_probe(self):
        return self._daemon.health_probe_now()

    def _d_debuginfo(self):
        return self._daemon.debuginfo()

    def _d_traces_get(self, limit=16):
        return self._daemon.traces(limit=limit)

    def _d_profile_get(self):
        return self._daemon.profile()

    def _d_flows_get(self, limit=64, *, verdict=None,
                     from_identity=None, reason=None):
        return self._daemon.flows(
            limit=limit, verdict=verdict,
            from_identity=from_identity, reason=reason,
        )

    def _d_policy_explain(self, src, dst, dport="", *, ingress=True):
        return self._daemon.policy_explain(src, dst, dport,
                                           ingress=ingress)

    def _d_config_get(self):
        return self._daemon.config_get()

    def _d_config_patch(self, options):
        return self._daemon.config_patch(options)

    def _d_endpoint_config(self, ep_id, options):
        return self._daemon.endpoint_config(ep_id, options)

    def _d_map_dump(self, name):
        return self._daemon.map_dump(name)

    def _d_service_list(self):
        return self._daemon.service_list()

    def _d_service_put(self, frontend, backends):
        return self._daemon.service_upsert(frontend, backends)

    def _d_service_delete(self, frontend):
        return {"deleted": self._daemon.service_delete(frontend)}

    def _d_prefilter_get(self):
        rev, cidrs = self._daemon.prefilter.dump()
        return {"revision": rev, "cidrs": cidrs}

    def _d_prefilter_patch(self, cidrs, revision=None):
        rev = self._daemon.prefilter.insert(
            revision if revision is not None
            else self._daemon.prefilter.revision,
            cidrs,
        )
        return {"revision": rev}

    def _d_prefilter_delete(self, cidrs, revision=None):
        rev = self._daemon.prefilter.delete(
            revision if revision is not None
            else self._daemon.prefilter.revision,
            cidrs,
        )
        return {"revision": rev}

    def _d_endpoint_get(self, ep_id):
        out = self._daemon.endpoint_get(ep_id)
        if out is None:
            raise SystemExit(f"endpoint {ep_id} not found")
        return out

    def _d_endpoint_regenerate(self, ep_id=None):
        try:
            return self._daemon.endpoint_regenerate(ep_id)
        except ValueError as e:
            raise SystemExit(str(e)) from None

    def _d_endpoint_log(self, ep_id):
        try:
            return self._daemon.endpoint_log(ep_id)
        except ValueError as e:
            raise SystemExit(str(e)) from None

    def _d_endpoint_labels(self, ep_id, add=(), delete=()):
        try:
            return self._daemon.endpoint_labels(ep_id, add=add, delete=delete)
        except ValueError as e:
            raise SystemExit(str(e)) from None

    def _d_map_list(self):
        return self._daemon.map_list()

    def _d_ct_flush(self):
        return self._daemon.ct_flush()

    def _d_node_list(self):
        return self._daemon.node_list()

    def _d_cluster_status(self):
        return self._daemon.cluster_status()

    def _d_fleet_status(self):
        return self._daemon.fleet_status()

    def _d_fleet_history(self, limit=64):
        return self._daemon.fleet_history(limit=limit)

    def _d_fleet_timeline(self, limit=256):
        return self._daemon.fleet_timeline(limit=limit)

    def _d_events_get(self, limit=64, *, kind=None, severity=None,
                      since=None):
        return self._daemon.events(
            limit=limit, kind=kind, severity=severity, since=since
        )


def _parse_frontend(text: str) -> dict:
    """'10.96.0.10:80/TCP' → frontend dict (cilium service update
    --frontend format, cilium/cmd/service_update.go)."""
    from .lb.service import L3n4Addr

    fe = L3n4Addr.from_string(text)
    return {"ip": fe.ip, "port": fe.port, "protocol": fe.protocol}


def _parse_backend(text: str) -> dict:
    """'10.0.0.3:8080[@weight]' → backend dict."""
    weight = 1
    if "@" in text:
        text, w = text.rsplit("@", 1)
        weight = int(w)
    ip, port = text.rsplit(":", 1)
    return {"ip": ip.strip("[]"), "port": int(port), "weight": weight}


def _print(obj) -> None:
    if isinstance(obj, str):
        print(obj, end="" if obj.endswith("\n") else "\n")
    else:
        print(json.dumps(obj, indent=2))


def _print_journal_lines(events, *, with_node=False) -> None:
    """One line per lifecycle event: wall time, severity, kind, attrs
    (`cilium-tpu events` / `fleet timeline` shared renderer)."""
    import datetime as _dt

    for ev in events:
        ts = _dt.datetime.fromtimestamp(ev["wall_ts"])
        node = f"{ev.get('node', '-'):<12} " if with_node else ""
        attrs = ev.get("attrs") or {}
        rest = " ".join(
            f"{k}={json.dumps(attrs[k])}" for k in sorted(attrs)
        )
        print(
            f"{ts:%H:%M:%S}.{ts.microsecond // 1000:03d} "
            f"{ev['severity']:<8} {node}{ev['kind']:<15} {rest}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cilium-tpu", description="TPU-native policy framework CLI"
    )
    p.add_argument("--socket", default=DEFAULT_SOCK,
                   help="daemon API socket (used when it exists)")
    p.add_argument("--state", default=DEFAULT_STATE,
                   help="state dir for standalone mode")
    p.add_argument("--device", default=None,
                   help="the agent's device: the card unless 'cpu' (plain versions) or 'cuda:N'")
    sub = p.add_subparsers(dest="cmd", required=True)

    hl = sub.add_parser("health", help="node connectivity status")
    hl.add_argument("--probe", action="store_true",
                    help="run an immediate probe sweep first")
    hl.add_argument("--sidecar", action="store_true",
                    help="query the standalone health-endpoint process "
                         "(<socket>.health — the cilium-health CLI role) "
                         "instead of the agent's in-process prober")

    bt = sub.add_parser("bugtool", help="archive daemon state for support")
    bt.add_argument("--output", default="",
                    help="archive path (default: cilium-tpu-bugtool-<ts>.tar.gz)")

    mon = sub.add_parser("monitor", help="stream datapath/agent events")
    mon.add_argument("--json", action="store_true", help="print raw events")
    mon.add_argument("--type", action="append", default=None,
                     dest="types", metavar="TYPE",
                     choices=["drop", "trace", "agent", "l7", "capture",
                              "trace-summary"],
                     help="only these event types (repeatable; "
                          "cilium monitor --type)")

    trc = sub.add_parser(
        "traces", help="print recent verdict-batch phase waterfalls"
    )
    trc.add_argument("-n", "--last", type=int, default=5,
                     help="how many traces to show (default 5)")
    trc.add_argument("--json", action="store_true",
                     help="raw trace dicts instead of waterfalls")
    mon.add_argument("--timeout", type=float, default=None,
                     help="stop after N idle seconds (default: run forever)")

    top = sub.add_parser(
        "top", help="device-time profile: sampled RTT split, jit cost "
                    "ledger, device memory + transfer ledgers"
    )
    top.add_argument("--json", action="store_true",
                     help="raw profile dict instead of the summary view")

    flw = sub.add_parser(
        "flows", help="print sampled attributed flows (policyd-flows)"
    )
    flw.add_argument("-n", "--last", type=int, default=20,
                     help="how many flows to show (default 20)")
    flw.add_argument("--verdict", default=None,
                     choices=["forwarded", "drop", "drop-policy",
                              "drop-prefilter", "drop-no-service"],
                     help="only flows with this outcome ('drop' = any "
                          "drop reason)")
    flw.add_argument("--from-identity", type=int, default=None,
                     help="only flows whose source is this numeric "
                          "identity")
    flw.add_argument("--json", action="store_true",
                     help="raw flow dicts instead of one-liners")

    # policyd-journal: the causally-ordered lifecycle event journal
    evt = sub.add_parser(
        "events", help="lifecycle event journal (policyd-journal)"
    )
    evt.add_argument("-n", "--last", type=int, default=20,
                     help="how many events to show (default 20)")
    evt.add_argument("--kind", default=None,
                     help="only this event kind (contracts.JOURNAL_KINDS)")
    evt.add_argument("--severity", default=None,
                     choices=["info", "warning", "error"],
                     help="only this severity")
    evt.add_argument("--json", action="store_true",
                     help="raw event dicts instead of one-liners")

    # daemon
    d = sub.add_parser("daemon", help="run the agent + API server")
    d.add_argument("--no-conntrack", action="store_true")
    d.add_argument("--join", default=None, metavar="KVSTORE",
                   help="join a cluster via a shared kvstore: a SQLite "
                        "path (all agents on one host pass the same "
                        "file) or tcp://host:port[,tcp://h2:p2,...] of "
                        "`kvstore serve` servers (first reachable "
                        "endpoint wins; rejoin retries the list)")
    d.add_argument("--node-name", default=None,
                   help="cluster node name (default: hostname)")
    d.add_argument("--node-ip", default=None,
                   help="this node's reachable address (tunnel endpoint)")
    d.add_argument("--cluster", default="default")
    d.add_argument("--pod-cidr", default="10.200.0.0/16")
    d.add_argument("--sync-interval", type=float, default=1.0,
                   help="cluster pump interval in seconds")
    d.add_argument("--launch-proxy", action="store_true",
                   help="spawn + supervise the external L7 proxy "
                        "process (python -m cilium_tpu_torch.proxy)")
    d.add_argument("--launch-health", action="store_true",
                   help="spawn + supervise the per-node health endpoint "
                        "process (python -m cilium_tpu_torch.health, the "
                        "cilium-health sidecar)")
    d.add_argument("--launch-monitor", action="store_true",
                   help="run the node monitor as its own supervised "
                        "process (python -m cilium_tpu_torch.monitor) so event "
                        "streaming survives agent stalls "
                        "(cilium-node-monitor role)")
    d.add_argument("--health-port", type=int, default=0,
                   help="health responder port (0 = ephemeral; the "
                        "reference's fixed port is 4240)")
    d.add_argument("--k8s-api", default=None, metavar="URL",
                   help="apiserver base URL: LIST + WATCH NetworkPolicy/"
                        "CNP/Service/Endpoints/Pod/Namespace and apply "
                        "them (pkg/k8s client + informer loop)")
    d.add_argument("--k8s-token-file", default=None,
                   help="bearer-token file for --k8s-api (the in-cluster "
                        "ServiceAccount pattern)")
    d.add_argument("--cri", default=None, metavar="TARGET",
                   help="CRI runtime endpoint to watch for containers "
                        "(containerd/cri-o socket, e.g. "
                        "unix:///run/containerd/containerd.sock); starts "
                        "the PLEG event loop (pkg/workloads role)")
    d.add_argument("--cri-interval", type=float, default=5.0,
                   help="CRI poll interval in seconds")

    # status / metrics
    st = sub.add_parser("status", help="agent status")
    st.add_argument("--all-controllers", action="store_true",
                    help="show only the background controller table")
    sub.add_parser("metrics", help="Prometheus metrics dump")

    # policy
    pol = sub.add_parser("policy", help="policy operations").add_subparsers(
        dest="sub", required=True
    )
    imp = pol.add_parser("import", help="import rules from a JSON file")
    imp.add_argument("file", help="rules JSON file ('-' = stdin)")
    pol.add_parser("get", help="dump the repository")
    dele = pol.add_parser("delete", help="delete rules by label")
    dele.add_argument("labels", nargs="+", help="labels, e.g. k8s:policy=x")
    val = pol.add_parser("validate", help="sanitize a rules file")
    val.add_argument("file", help="rules JSON ('-' = stdin)")
    pw = pol.add_parser("wait", help="wait until the repository reaches a revision")
    pw.add_argument("revision", type=int)
    pw.add_argument("--timeout", type=float, default=30.0)
    tr = pol.add_parser("trace", help="offline verdict + trace log")
    tr.add_argument("-s", "--src", action="append", default=[],
                    help="source label (repeatable)")
    tr.add_argument("-d", "--dst", action="append", default=[],
                    help="destination label (repeatable)")
    tr.add_argument("--src-identity", type=int, default=None,
                    help="resolve source labels from a numeric identity")
    tr.add_argument("--dst-identity", type=int, default=None)
    tr.add_argument("--src-endpoint", type=int, default=None,
                    help="resolve source labels from an endpoint id")
    tr.add_argument("--dst-endpoint", type=int, default=None)
    tr.add_argument("--dport", action="append", default=[],
                    help="destination port 'port[/proto]' (repeatable)")
    tr.add_argument("--egress", action="store_true",
                    help="trace the egress direction")
    tr.add_argument("-v", "--verbose", action="store_true")
    ex = pol.add_parser(
        "explain",
        help="replay ONE flow through the device verdict kernel and "
             "name the deciding rule + drop reason (policyd-flows)",
    )
    ex.add_argument("-s", "--src", action="append", default=[],
                    help="source label (repeatable)")
    ex.add_argument("-d", "--dst", action="append", default=[],
                    help="destination label (repeatable)")
    ex.add_argument("--dport", default="",
                    help="destination port 'port[/proto]' (omit for an "
                         "L3-only flow)")
    ex.add_argument("--egress", action="store_true",
                    help="explain the egress direction")
    ex.add_argument("--json", action="store_true")

    # endpoint
    ep = sub.add_parser("endpoint", help="endpoint operations").add_subparsers(
        dest="sub", required=True
    )
    ep.add_parser("list", help="list endpoints")
    epa = ep.add_parser("add", help="create an endpoint")
    epa.add_argument("id", type=int)
    epa.add_argument("-l", "--label", action="append", required=True)
    epa.add_argument("--ipv4")
    epa.add_argument("--ipv6")
    epc = ep.add_parser("config", help="per-endpoint runtime options")
    epc.add_argument("id", type=int)
    epc.add_argument("options", nargs="+", help="Option=true|false pairs")
    epd = ep.add_parser("delete", help="remove an endpoint")
    epd.add_argument("id", type=int)
    epg = ep.add_parser("get", help="one endpoint's model")
    epg.add_argument("id", type=int)
    epr = ep.add_parser("regenerate", help="force policy regeneration")
    epr.add_argument("id", type=int, nargs="?", default=None)
    eplog = ep.add_parser("log", help="per-endpoint status log")
    eplog.add_argument("id", type=int)
    epl = ep.add_parser("labels", help="modify labels (new identity)")
    epl.add_argument("id", type=int)
    epl.add_argument("-a", "--add", action="append", default=[])
    epl.add_argument("-d", "--delete", action="append", default=[])

    # identity
    idp = sub.add_parser("identity", help="identity operations").add_subparsers(
        dest="sub", required=True
    )
    idp.add_parser("list", help="list identities")
    idg = idp.add_parser("get", help="get one identity")
    idg.add_argument("id", type=int)

    # bpf policy get (map dump)
    cfg = sub.add_parser("config", help="runtime option map")
    cfg.add_argument("options", nargs="*",
                     help="Option=true|false pairs (empty: show)")

    bpf = sub.add_parser("bpf", help="datapath map access").add_subparsers(
        dest="sub", required=True
    )
    for mname, mhelp in (
        ("ct", "conntrack entries"), ("ipcache", "IP→identity cache"),
        ("tunnel", "tunnel endpoints"), ("proxy", "proxy handoffs"),
        ("metrics", "per-endpoint counters"), ("routes", "route table"),
        ("lxc", "local endpoints (bpf endpoint list)"),
        ("lb", "service tables (bpf lb list)"),
    ):
        mp = bpf.add_parser(mname, help=mhelp).add_subparsers(
            dest="mapop", required=True
        )
        mp.add_parser("list", help=f"dump {mhelp}")
        if mname == "ct":
            mp.add_parser("flush", help="flush all conntrack entries")
    bp = bpf.add_parser("policy", help="policymap ops").add_subparsers(
        dest="op", required=True
    )
    bpg = bp.add_parser("get", help="dump an endpoint's realized policymap")
    bpg.add_argument("endpoint", type=int)
    bpg.add_argument("--egress", action="store_true")

    # prefilter
    svc = sub.add_parser("service", help="LB service operations").add_subparsers(
        dest="sub", required=True
    )
    svc.add_parser("list", help="list services")
    svu = svc.add_parser("update", help="create/update a service")
    svu.add_argument("--frontend", required=True,
                     help="VIP as ip:port[/proto], e.g. 10.96.0.10:80/TCP")
    svu.add_argument("--backends", nargs="*", default=[],
                     help="backends as ip:port[@weight]")
    svd = svc.add_parser("delete", help="delete a service")
    svd.add_argument("--frontend", required=True)

    pf = sub.add_parser("prefilter", help="XDP deny-list").add_subparsers(
        dest="sub", required=True
    )
    pf.add_parser("get", help="dump deny CIDRs")
    pfu = pf.add_parser("update", help="insert deny CIDRs")
    pfu.add_argument("cidrs", nargs="+")
    pfd = pf.add_parser("delete", help="remove deny CIDRs")
    pfd.add_argument("cidrs", nargs="+")

    # node / map inventory / version / cleanup
    nd = sub.add_parser("node", help="cluster nodes").add_subparsers(
        dest="sub", required=True
    )
    nd.add_parser("list", help="known cluster nodes")
    # policyd-fed: the federated policy plane (GET /cluster)
    cf = sub.add_parser(
        "cluster", help="federated policy plane (policyd-fed)"
    ).add_subparsers(dest="sub", required=True)
    cf.add_parser("nodes", help="fleet nodes + published policy epochs")
    cf.add_parser("status", help="full federation membership view")
    # policyd-fleetobs: the aggregated telemetry plane (GET /fleet)
    fl = sub.add_parser(
        "fleet", help="fleet telemetry scoreboard (policyd-fleetobs)"
    ).add_subparsers(dest="sub", required=True)
    fl.add_parser("status", help="aggregated scoreboard (raw JSON)")
    fl.add_parser("top", help="per-node health grid, one line per node")
    flh = fl.add_parser("history", help="local time-series ring samples")
    flh.add_argument("-n", "--last", type=int, default=32,
                     help="how many ring samples to show (default 32)")
    flh.add_argument("--json", action="store_true",
                     help="raw sample dicts instead of one-liners")
    # policyd-journal: per-node journals merged into one HLC order
    flt = fl.add_parser(
        "timeline", help="merged fleet lifecycle timeline (policyd-journal)"
    )
    flt.add_argument("-n", "--last", type=int, default=64,
                     help="how many merged events to show (default 64)")
    flt.add_argument("--json", action="store_true",
                     help="raw merged-timeline dict instead of one-liners")
    mp2 = sub.add_parser("map", help="open-map inventory").add_subparsers(
        dest="sub", required=True
    )
    mp2.add_parser("list", help="map names + entry counts")
    mg = mp2.add_parser("get", help="dump one map by name")
    mg.add_argument("name")
    sub.add_parser("version", help="framework + backend versions")
    cl = sub.add_parser("cleanup", help="remove agent state/sockets")
    cl.add_argument("-f", "--force", action="store_true",
                    help="actually delete (dry run without)")

    # kvstore: serve the cluster fabric / direct key access
    # (cilium kvstore get|set|delete, cilium/cmd/kvstore*.go)
    kv = sub.add_parser("kvstore", help="cluster kvstore").add_subparsers(
        dest="sub", required=True
    )
    kvs = kv.add_parser(
        "serve",
        help="run the TCP kvstore server agents --join (etcd role)",
    )
    kvs.add_argument("--listen", default="127.0.0.1:4240",
                     metavar="HOST:PORT")
    kvs.add_argument("--lease-ttl", type=float, default=15.0)
    kvs.add_argument("--state-file", default=None, metavar="PATH",
                     help="persist non-lease keys across restarts "
                          "(periodic + on-stop atomic snapshots)")
    for opname, ophelp in (
        ("get", "read keys under a prefix"),
        ("set", "write one key"),
        ("delete", "delete a key (or prefix with trailing /)"),
        ("status", "kvstore connectivity status"),
    ):
        op = kv.add_parser(opname, help=ophelp)
        op.add_argument("--kvstore", required=True, metavar="TARGET",
                        help="tcp://host:port or SQLite path")
        if opname in ("get", "set", "delete"):
            op.add_argument("key")
        if opname == "set":
            op.add_argument("value")

    return p


def _install_signal_handlers() -> None:
    """Route SIGTERM (and SIGINT, for symmetry) into KeyboardInterrupt
    so orchestrated stops — `kill`, container runtimes, systemd — take
    the same graceful-drain teardown as ^C. Best-effort: signal
    delivery only works from the main thread, and embedded callers
    (tests driving main() from a worker) simply keep default disposition."""
    import signal

    def _raise_interrupt(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _raise_interrupt)
        signal.signal(signal.SIGINT, _raise_interrupt)
    except ValueError:  # not the main thread
        pass


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.cmd == "daemon":
        from .api.server import APIServer
        from .daemon import Daemon
        from .monitor.server import MonitorServer
        from .utils.logging import setup as logging_setup

        logging_setup(os.environ.get("CILIUM_TPU_LOG_LEVEL", "info"))

        daemon = Daemon(
            state_dir=args.state, conntrack=not args.no_conntrack,
            pod_cidr=args.pod_cidr, device=args.device,
        )
        cluster_node = None
        cluster_pump = None
        if args.join:
            if not args.node_ip:
                # a node without an address cannot serve as a tunnel
                # endpoint — peers would learn unroutable announcements
                print("--join requires --node-ip (this node's reachable "
                      "address for tunnels)", file=sys.stderr)
                return 2
            import socket as _socket

            from .cluster import ClusterNode
            from .kvstore.netstore import backend_from_target
            from .nodes.registry import Node as _Node

            name = args.node_name or _socket.gethostname()
            cluster_node = ClusterNode(
                daemon,
                backend_from_target(args.join, name),
                _Node(name=name, ipv4=args.node_ip,
                      ipv4_alloc_cidr=args.pod_cidr),
                cluster=args.cluster,
            )
            cluster_node.export_services()

            # convergence controller: drain cluster subscriptions on
            # an interval (the kvstore watch pump of the reference's
            # controller loops). A dead backend (kvstore outage)
            # triggers a rejoin attempt on a fresh connection; while
            # the server is down the factory raises and the
            # controller's backoff keeps retrying — enforcement keeps
            # running on local state the whole time.
            def _cluster_sync():
                if not cluster_node.joined():
                    cluster_node.rejoin(backend_from_target(args.join, name))
                    # export follows below — rejoin itself doesn't
                cluster_node.pump()
                cluster_node.export_services()

            # registered with the daemon's manager so it shows in
            # `cilium status --all-controllers`
            cluster_pump = daemon.controllers.update_controller(
                "cluster-sync", _cluster_sync,
                run_interval=args.sync_interval,
            )
        server = APIServer(daemon, args.socket)
        monitor = None
        monitor_launcher = None
        monitor_feeder = None
        if args.launch_monitor:
            # external monitor owns the client socket; the agent only
            # FEEDS it — `cilium monitor` streams survive agent stalls
            # (monitor/monitor.go:184 isolation)
            from .monitor.standalone import MonitorFeeder
            from .proxy.launcher import MonitorLauncher

            monitor_launcher = MonitorLauncher(
                args.socket + ".monitor", args.socket + ".monitor-feed"
            ).start()
            monitor_feeder = MonitorFeeder(
                daemon.monitor, args.socket + ".monitor-feed"
            ).start()
        else:
            monitor = MonitorServer(daemon.monitor, args.socket + ".monitor")
            monitor.start()
        from .xds.server import XDSServer

        xds = XDSServer(daemon.xds_cache, args.socket + ".xds")
        xds.start()
        accesslog_rx = None
        proxy_launcher = None
        if args.launch_proxy:
            # external proxy: accesslog receiver + supervised child
            # (pkg/envoy/envoy.go:76-143 + pkg/launcher)
            from .proxy.accesslog import AccessLogSocketServer
            from .proxy.launcher import ProxyLauncher

            accesslog_rx = AccessLogSocketServer(
                daemon.proxy.accesslog, args.socket + ".accesslog"
            ).start()
            proxy_launcher = ProxyLauncher(
                args.socket + ".xds", args.socket + ".accesslog",
                extra_args=["--device", args.device] if args.device else None,
            ).start()
        health_launcher = None
        if args.launch_health:
            # per-node health endpoint as its own supervised process
            # (the cilium-health sidecar, daemon/main.go:927-945)
            from .health.standalone import HealthAPIClient
            from .proxy.launcher import HealthLauncher

            health_api = args.socket + ".health"
            health_launcher = HealthLauncher(
                args.socket, health_api,
                listen_ip=args.node_ip or "127.0.0.1",
                port=args.health_port,
                interval=max(1.0, args.sync_interval),
            ).start()

            if cluster_node is not None:
                # port advertisement only matters with peers to tell;
                # a standalone daemon would poll for nothing
                def _health_advertise():
                    """Once the sidecar reports its responder port,
                    advertise it in the node announcement so peers
                    probe the right socket."""
                    st = HealthAPIClient(health_api, timeout=3.0).status()
                    port = int(st.get("port") or 0)
                    if port:
                        import dataclasses as _dc

                        local = cluster_node.nodes.local
                        if local.health_port != port:
                            cluster_node.nodes.announce_local(_dc.replace(
                                local, health_ip=args.node_ip,
                                health_port=port,
                            ))

                daemon.controllers.update_controller(
                    "health-advertise", _health_advertise,
                    run_interval=max(1.0, args.sync_interval),
                )
        informer = None
        if args.k8s_api:
            from .k8s import K8sWatcher
            from .k8s.client import APIServerClient, Informer

            token = None
            if args.k8s_token_file:
                with open(args.k8s_token_file) as f:
                    token = f.read().strip()
            api = APIServerClient(args.k8s_api, token=token)
            watcher = K8sWatcher(daemon)
            # writeback wiring: CNP status acks, Ingress LB status,
            # node CIDR annotations (pkg/k8s/client.go AnnotateNode)
            watcher.status_client = api
            watcher.node_name = args.node_name or ""
            if args.node_ip:
                daemon.services.host_ip = args.node_ip  # Ingress frontends
            try:
                # register the CNP CRD before watching it
                # (pkg/k8s/apis/cilium.io/v2/register.go)
                api.ensure_cnp_crd()
            except Exception as e:
                print(f"WARNING: CNP CRD registration failed: {e}")
            informer = Informer(api, watcher).start()
            # the reference blocks on cache sync before serving
            # (daemon/main.go:843-856); an unsynced start is loudly
            # flagged rather than silently serving empty k8s state
            if not informer.wait_synced(timeout=30.0):
                print("WARNING: k8s cache not synced after 30s — "
                      "serving with partial state; the informer keeps "
                      "retrying in the background")
        pleg = None
        if args.cri:
            # container runtime watcher over the CRI socket
            # (pkg/workloads docker.go role for containerd/cri-o)
            from .runtimes import CRIRuntime, PLEGPoller
            from .workloads import WorkloadWatcher

            cri = CRIRuntime(args.cri)
            pleg = PLEGPoller(
                WorkloadWatcher(daemon, cri), cri,
                interval=args.cri_interval,
            ).start()
        daemon.fqdn_start()  # ToFQDNs DNS poll loop (daemon/main.go:808)
        if daemon.health.nodes is not None:
            # node prober (daemon/main.go:927-945) — only meaningful
            # once a node registry is attached; a standalone daemon
            # has no peers and would spin an empty sweep forever
            daemon.health.start()
        cluster_note = f", cluster: {args.cluster}@{args.join}" if args.join else ""
        print(f"cilium-tpu daemon serving on {args.socket} "
              f"(monitor: {args.socket}.monitor, xds: {args.socket}.xds, "
              f"state: {args.state}{cluster_note})")
        # Graceful drain on SIGTERM (policyd-survive): rolling restarts
        # deliver SIGTERM, not ^C — route both through the one teardown
        # path below so in-flight verdicts drain and state persists.
        _install_signal_handlers()
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            if informer is not None:
                informer.stop()
            if pleg is not None:
                pleg.stop()
            if proxy_launcher is not None:
                proxy_launcher.stop()
            if health_launcher is not None:
                health_launcher.stop()
            if accesslog_rx is not None:
                accesslog_rx.stop()
            xds.stop()
            if monitor is not None:
                monitor.stop()
            if monitor_feeder is not None:
                monitor_feeder.stop()
            if monitor_launcher is not None:
                monitor_launcher.stop()
            server.stop()
            if cluster_pump is not None:
                cluster_pump.stop()  # BEFORE close: no pump mid-teardown
            if cluster_node is not None:
                cluster_node.close()
            daemon.shutdown()
        return 0

    if args.cmd == "monitor":
        import dataclasses

        from .monitor.server import monitor_stream

        path = args.socket + ".monitor"
        if not os.path.exists(path):
            print(f"no monitor socket at {path} (is the daemon running?)",
                  file=sys.stderr)
            return 1
        print(f"Listening for events on {path}...", file=sys.stderr)
        from .monitor.events import (
            EVENT_AGENT,
            EVENT_CAPTURE,
            EVENT_DROP,
            EVENT_L7,
            EVENT_TRACE,
            EVENT_TRACE_SUMMARY,
        )

        _type_names = {EVENT_DROP: "drop", EVENT_TRACE: "trace",
                       EVENT_AGENT: "agent", EVENT_L7: "l7",
                       EVENT_CAPTURE: "capture",
                       EVENT_TRACE_SUMMARY: "trace-summary"}
        try:
            for ev in monitor_stream(path, timeout=args.timeout):
                if args.types and _type_names.get(ev.type) not in args.types:
                    continue
                if args.json:
                    d = dataclasses.asdict(ev)
                    # bytes fields (peer_addr, capture payloads) ride
                    # as hex — json has no bytes type
                    for k, v in d.items():
                        if isinstance(v, bytes):
                            d[k] = v.hex()
                    print(json.dumps(d))
                else:
                    print(ev.summary())
        except KeyboardInterrupt:
            pass
        return 0

    if args.cmd == "version":
        # local by design: version must print even with no daemon
        from . import __version__

        print(f"cilium-tpu {__version__}")
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        where = f"gpu: {torch.cuda.get_device_name(0)}" if n else "cpu"
        print(f"torch {torch.__version__} ({where}, {max(n, 1)} device(s))")
        return 0

    if args.cmd == "cleanup":
        # cilium cleanup: remove agent state + sockets (the reference
        # removes BPF maps/veths; our datapath state is the state dir)
        import shutil

        targets = [p for p in (
            args.state,
            args.socket, args.socket + ".monitor", args.socket + ".xds",
            args.socket + ".accesslog",
        ) if os.path.exists(p)]
        if not targets:
            print("nothing to clean")
            return 0
        for t in targets:
            print(("removing " if args.force else "would remove ") + t)
            if args.force:
                if os.path.isdir(t):
                    shutil.rmtree(t, ignore_errors=True)
                else:
                    try:
                        os.unlink(t)
                    except OSError:
                        pass
        if not args.force:
            print("dry run — pass --force to delete")
        return 0

    if args.cmd == "kvstore":
        from .kvstore.netstore import KVStoreServer, backend_from_target

        if args.sub == "serve":
            from .kvstore.netstore import parse_hostport

            try:
                host, port = parse_hostport(args.listen)
            except ValueError as e:
                print(f"--listen: {e}", file=sys.stderr)
                return 2
            server = KVStoreServer(
                host or "127.0.0.1", port, lease_ttl=args.lease_ttl,
                state_path=args.state_file,
            ).start()
            print(f"kvstore serving on {server.url}", flush=True)
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                pass
            server.stop()
            return 0
        # `kvstore status` exists precisely to probe a possibly-down
        # server — a traceback here would be a bug report, not an
        # answer (same for a dying server mid-op, or an unwritable
        # SQLite path)
        import sqlite3

        _kv_errors = (
            OSError, TimeoutError, RuntimeError, ValueError, sqlite3.Error,
        )
        try:
            be = backend_from_target(args.kvstore, "cli")
        except _kv_errors as e:
            print(f"kvstore {args.kvstore}: unreachable ({e})",
                  file=sys.stderr)
            return 1
        try:
            if args.sub == "get":
                for k, v in sorted(be.list_prefix(args.key).items()):
                    print(f"{k} => {v.decode(errors='replace')}")
            elif args.sub == "set":
                be.set(args.key, args.value.encode())
            elif args.sub == "delete":
                if args.key.endswith("/"):
                    be.delete_prefix(args.key)
                else:
                    be.delete(args.key)
            elif args.sub == "status":
                print(be.status())
        except _kv_errors as e:
            print(f"kvstore {args.kvstore}: {args.sub} failed ({e})",
                  file=sys.stderr)
            return 1
        finally:
            be.close()
        return 0

    s = _Surface(args.socket, args.state, args.device)

    if args.cmd == "status":
        status = s.status()
        if getattr(args, "all_controllers", False):
            _print(status.get("controllers", []))
        else:
            slo = status.get("slo")
            if slo:
                # one-line health summary (policyd-fleetobs); absent
                # when FleetTelemetry is off so stdout stays pure JSON
                print(f"SLO: worst={slo['worst_objective']} "
                      f"state={slo['state']} burn={slo['ratio']}",
                      file=sys.stderr)
            _print(status)
    elif args.cmd == "metrics":
        _print(s.metrics())
    elif args.cmd == "policy":
        if args.sub == "import":
            text = (sys.stdin.read() if args.file == "-"
                    else open(args.file).read())
            _print(s.policy_put(json.loads(text)))
        elif args.sub == "get":
            _print(s.policy_get())
        elif args.sub == "delete":
            _print(s.policy_delete(args.labels))
        elif args.sub == "validate":
            from .policy.api.serialization import rules_from_json

            text = (sys.stdin.read() if args.file == "-"
                    else open(args.file).read())
            try:
                rules = rules_from_json(text)
            except (ValueError, KeyError) as e:
                print(f"invalid: {e}", file=sys.stderr)
                return 1
            print(f"valid: {len(rules)} rule(s)")
            return 0
        elif args.sub == "wait":
            import time as _time

            deadline = _time.time() + args.timeout
            while _time.time() < deadline:
                rev = s.status()["policy_revision"]
                if rev >= args.revision:
                    print(f"revision {rev} reached")
                    return 0
                _time.sleep(0.2)
            print(f"timeout waiting for revision {args.revision}",
                  file=sys.stderr)
            return 1
        elif args.sub == "trace":
            eps_by_id: dict = {}

            def endpoints_once():
                # one GET /endpoint serves both sides of the trace
                if not eps_by_id:
                    eps_by_id.update(
                        {e["id"]: e for e in s.endpoint_list()}
                    )
                return eps_by_id

            def resolve_side(labels, identity, endpoint, side):
                # --src-identity / --src-endpoint sources mirror
                # cilium/cmd/policy_trace.go (identity → GET
                # /identity/<id>, endpoint → its labels)
                out = list(labels)
                if identity is not None:
                    try:
                        out += s.identity_get(identity)["labels"]
                    except (SystemExit, Exception):
                        raise SystemExit(
                            f"{side} identity {identity} not found"
                        ) from None
                if endpoint is not None:
                    eps = endpoints_once()
                    if endpoint not in eps:
                        raise SystemExit(f"{side} endpoint {endpoint} not found")
                    out += eps[endpoint]["labels"]
                if not out:
                    raise SystemExit(
                        f"no {side}: give -{side[0]}, --{side}-identity "
                        f"or --{side}-endpoint"
                    )
                return out

            out = s.policy_resolve(
                resolve_side(args.src, args.src_identity,
                             args.src_endpoint, "src"),
                resolve_side(args.dst, args.dst_identity,
                             args.dst_endpoint, "dst"),
                args.dport,
                ingress=not args.egress, verbose=args.verbose,
            )
            print(out["trace"], end="")
            print(f"Final verdict: {out['verdict']}")
            if not out["parity"]:
                print("WARNING: device/oracle verdict mismatch "
                      f"(device allowed={out['device_allowed']})",
                      file=sys.stderr)
                return 2
            return 0 if out["allowed"] else 1
        elif args.sub == "explain":
            if not args.src or not args.dst:
                raise SystemExit("give at least one -s and one -d label")
            out = s.policy_explain(args.src, args.dst, args.dport,
                                   ingress=not args.egress)
            if args.json:
                _print(out)
                return 0 if out["allowed"] else 1
            dec = "ALLOWED" if out["allowed"] else "DENIED"
            print(f"{out['direction']} verdict: {dec} [{out['reason']}]")
            r = out.get("rule")
            if r is not None:
                what = (", ".join(r.get("labels", []))
                        or r.get("description")
                        or f"rule {out['rule_index']}")
                print(f"decided by rule #{out['rule_index']}: {what}")
            elif out["rule_index"] >= 0:
                print(f"decided by rule #{out['rule_index']}")
            else:
                print("no rule matched")
            if out.get("l7_redirect"):
                print("L7: redirected to proxy")
            return 0 if out["allowed"] else 1
    elif args.cmd == "endpoint":
        if args.sub == "list":
            _print(s.endpoint_list())
        elif args.sub == "add":
            _print(s.endpoint_put(args.id, args.label,
                                  ipv4=args.ipv4, ipv6=args.ipv6))
        elif args.sub == "config":
            opts = {}
            for pair in args.options:
                name, _, val = pair.partition("=")
                opts[name] = val or "true"
            _print(s.endpoint_config(args.id, opts))
        elif args.sub == "delete":
            _print(s.endpoint_delete(args.id))
        elif args.sub == "get":
            _print(s.endpoint_get(args.id))
        elif args.sub == "regenerate":
            _print(s.endpoint_regenerate(args.id))
        elif args.sub == "log":
            import datetime as _dt

            for rec in s.endpoint_log(args.id):
                ts = _dt.datetime.fromtimestamp(rec["timestamp"])
                print(f"{ts:%H:%M:%S} [{rec['code']}] {rec['message']}")
        elif args.sub == "labels":
            _print(s.endpoint_labels(args.id, add=args.add,
                                     delete=args.delete))
    elif args.cmd == "identity":
        if args.sub == "list":
            _print(s.identity_list())
        else:
            _print(s.identity_get(args.id))
    elif args.cmd == "config":
        if args.options:
            opts = {}
            for pair in args.options:
                name, _, val = pair.partition("=")
                opts[name] = val or "true"
            _print(s.config_patch(opts))
        else:
            _print(s.config_get())
    elif args.cmd == "bpf":
        if args.sub == "ct" and args.mapop == "flush":
            _print(s.ct_flush())
        elif args.sub in ("ct", "ipcache", "tunnel", "proxy", "metrics",
                          "routes", "lxc", "lb"):
            _print(s.map_dump(args.sub))
        else:
            _print(s.policymap_get(args.endpoint, egress=args.egress))
    elif args.cmd == "health":
        if args.sidecar:
            from .health.standalone import HealthAPIClient

            hpath = args.socket + ".health"
            if not os.path.exists(hpath):
                print(f"no health socket at {hpath} (daemon running "
                      "with --launch-health?)", file=sys.stderr)
                return 1
            from .api.client import APIError

            hc = HealthAPIClient(hpath)
            try:
                if args.probe:
                    hc.probe()
                _print(hc.status())
            except (OSError, APIError, ValueError) as e:
                print(f"health sidecar unreachable: {e}", file=sys.stderr)
                return 1
        else:
            _print(s.health_probe() if args.probe else s.health())
    elif args.cmd == "traces":
        out = s.traces_get(limit=args.last)
        if args.json:
            _print(out)
        else:
            from .monitor.dissect import render_waterfall

            if not out.get("enabled") and not out.get("traces"):
                print("phase tracing is disabled (enable with "
                      "`cilium-tpu config PhaseTracing=true`)")
            if "pipeline_depth" in out:
                # overlap context: with depth>1 a trace's host_sync is
                # the residual wait, not the device execution time
                print(
                    f"pipeline depth {out['pipeline_depth']}, "
                    f"{out.get('in_flight', 0)} batch(es) in flight"
                )
                if out.get("flow_attribution"):
                    # attribution widens host_sync (6 pulled arrays,
                    # not 3) — name it so waterfalls read honestly
                    print("flow attribution is ON: host_sync includes "
                          "rule/reason/hit-counter pulls")
                at = out.get("autotune")
                if at:
                    # depth moved between these traces' batches —
                    # waterfalls are NOT like-for-like comparable
                    # without this context (observe/README.md)
                    adj = at.get("adjustments", {})
                    print(
                        f"auto-tune is ON: depth {at.get('depth')} in "
                        f"[{at.get('min_depth')}, {at.get('max_depth')}], "
                        f"{adj.get('up', 0)} up / {adj.get('down', 0)} "
                        f"down step(s)"
                    )
                pl = out.get("placement")
                if pl and pl.get("axes"):
                    # a formed mesh changes what a dispatch span covers
                    # (flow shards, and under 2D an ident-axis reduce)
                    ax = pl["axes"]
                    shape = "×".join(
                        f"{k}={v}" for k, v in sorted(ax.items())
                    )
                    print(
                        f"placement: mesh {{{shape}}} over "
                        f"{len(pl.get('devices', ()))} device(s), "
                        f"generation {pl.get('generation')}"
                        + (
                            ", identity tables SHARDED over ident"
                            if pl.get("ident_sharded")
                            else ""
                        )
                    )
                adm = out.get("admission")
                if adm and adm.get("enabled"):
                    # an active gate means some flows in this window
                    # never produced device spans at all — waterfalls
                    # undercount offered load without this context
                    wd = adm.get("watchdog") or {}
                    line = (
                        f"admission control is ON: limit "
                        f"{adm.get('limit')}/{adm.get('max_depth')}, "
                        f"queue depth {adm.get('queue_depth', 0)}, "
                        f"shed ratio {adm.get('shed_ratio', 0.0)}"
                    )
                    if adm.get("prefilter"):
                        shed = adm.get("shed", {})
                        line += (
                            f", prefilter shed "
                            f"{shed.get('prefilter', 0)} flow(s)"
                        )
                    print(line)
                    if wd.get("last_stall"):
                        ls = wd["last_stall"]
                        print(
                            f"watchdog: {wd.get('stalls', 0)} stall(s), "
                            f"last at site {ls.get('site')!r} after "
                            f"{ls.get('age_ms')}ms"
                        )
                fs = out.get("failsafe")
                if fs and fs.get("degraded"):
                    # a degraded ladder changes what the spans MEAN
                    # (host mode has no device phases at all) — say so
                    # before any waterfall prints
                    print(
                        f"pipeline DEGRADED: mode {fs.get('mode')} "
                        f"(level {fs.get('level')}), "
                        f"{fs.get('quarantined_batches', 0)} batch(es) "
                        f"quarantined, "
                        f"{'fail-open' if fs.get('fail_open') else 'fail-closed'}"
                    )
                pq = out.get("phase_quantiles")
                if pq:
                    # process-lifetime latency context (histogram
                    # interpolation) for the per-batch waterfalls below
                    print("phase quantiles: " + ", ".join(
                        f"{ph} p50={v['p50_ms']}ms/p99={v['p99_ms']}ms"
                        for ph, v in sorted(pq.items())
                    ))
                print()
            for t in out.get("traces", ()):
                print(render_waterfall(
                    t["kind"], t["batch"], t["total_ns"], t["phases"],
                ))
                print()
    elif args.cmd == "top":
        out = s.profile_get()
        if args.json:
            _print(out)
        else:
            if not out.get("enabled"):
                print("device profiling is disabled (enable with "
                      "`cilium-tpu config DeviceProfiling=true`)")
            else:
                print(f"sampling every {out.get('sample_every')} "
                      f"batch(es), {len(out.get('samples', ()))} "
                      "sample(s) retained")
            sites = out.get("sites") or {}
            if sites:
                print()
                print(f"{'site':<10}{'samples':>8}{'h2d_ms':>10}"
                      f"{'compute_ms':>12}{'d2h_ms':>10}")
                for name, st in sorted(
                    sites.items(),
                    key=lambda kv: -kv[1].get("device_compute_ms", 0.0),
                ):
                    print(f"{name:<10}{st.get('samples', 0):>8}"
                          f"{st.get('h2d_ms', 0.0):>10.3f}"
                          f"{st.get('device_compute_ms', 0.0):>12.3f}"
                          f"{st.get('d2h_ms', 0.0):>10.3f}")
            costs = out.get("jit_costs") or {}
            if costs:
                print()
                print("jit sites (XLA cost_analysis per compiled "
                      "program):")
                for key, c in sorted(costs.items()):
                    print(f"  {key}: flops={c.get('flops')} "
                          f"bytes_accessed={c.get('bytes_accessed')}")
            ledger = out.get("device_table_bytes") or {}
            if ledger:
                print()
                print("device table bytes (family/placement, per "
                      "device):")
                for key, val in sorted(ledger.items()):
                    print(f"  {key:<28}{int(val):>14,}")
            xf = out.get("device_transfers") or {}
            if xf.get("counts") or xf.get("bytes"):
                counts = xf.get("counts") or {}
                nbytes = xf.get("bytes") or {}
                print()
                print("device transfers:")
                for k in sorted(set(counts) | set(nbytes)):
                    print(f"  {k:<6} count={counts.get(k, 0):.0f} "
                          f"bytes={nbytes.get(k, 0):.0f}")
    elif args.cmd == "flows":
        import datetime as _dt

        _verdict_codes = {"forwarded": 1, "drop": -1, "drop-policy": 2,
                          "drop-prefilter": 3, "drop-no-service": 4}
        out = s.flows_get(
            limit=args.last,
            verdict=(_verdict_codes[args.verdict]
                     if args.verdict else None),
            from_identity=args.from_identity,
        )
        if args.json:
            _print(out)
        else:
            if not out.get("enabled") and not out.get("flows"):
                print("flow attribution is disabled (enable with "
                      "`cilium-tpu config FlowAttribution=true`)")
            for f in out.get("flows", ()):
                ts = _dt.datetime.fromtimestamp(f["ts"])
                rule = ""
                if f["rule_index"] >= 0:
                    org = f.get("rule_origin") or {}
                    what = (", ".join(org.get("labels", []))
                            or org.get("description", ""))
                    rule = f"  rule #{f['rule_index']}"
                    if what:
                        rule += f" ({what})"
                ip = f["src_ip"] or f["dst_ip"]
                ip = f" {ip}" if ip else ""
                print(
                    f"{ts:%H:%M:%S} {f['direction']:<7} "
                    f"{f['src_identity']}->{f['dst_identity']}{ip} "
                    f"{f['dport']}/{f['proto']} "
                    f"{f['verdict_name']} [{f['reason_name']}]{rule}"
                )
            if out.get("recorded", 0):
                shown = len(out.get("flows", ()))
                print(f"({shown} shown; {out['recorded']} recorded "
                      "since enable; drops sampled first)")
    elif args.cmd == "events":
        out = s.events_get(
            limit=args.last, kind=args.kind, severity=args.severity
        )
        if args.json:
            _print(out)
        elif not out.get("enabled"):
            print("lifecycle journal is disabled (enable with "
                  "`cilium-tpu config LifecycleJournal=true`)")
        else:
            _print_journal_lines(out.get("events", ()))
            if out.get("dropped", 0):
                print(f"({out['dropped']} event(s) dropped to the ring "
                      "bound since enable)")
    elif args.cmd == "bugtool":
        import time as _time

        from .bugtool import write_archive_from

        out = args.output or f"cilium-tpu-bugtool-{int(_time.time())}.tar.gz"
        write_archive_from(s.debuginfo(), s.metrics(), out)
        print(f"archive written: {out}")
    elif args.cmd == "service":
        if args.sub == "list":
            _print(s.service_list())
        elif args.sub == "update":
            _print(s.service_put(
                _parse_frontend(args.frontend),
                [_parse_backend(b) for b in args.backends],
            ))
        elif args.sub == "delete":
            _print(s.service_delete(_parse_frontend(args.frontend)))
    elif args.cmd == "prefilter":
        if args.sub == "get":
            _print(s.prefilter_get())
        elif args.sub == "delete":
            _print(s.prefilter_delete(args.cidrs))
        else:
            _print(s.prefilter_patch(args.cidrs))
    elif args.cmd == "node":
        _print(s.node_list())
    elif args.cmd == "cluster":
        st = s.cluster_status()
        _print(st.get("nodes", []) if args.sub == "nodes" else st)
    elif args.cmd == "fleet":
        if args.sub == "timeline":
            out = s.fleet_timeline(limit=args.last)
            if args.json:
                _print(out)
            elif not out.get("enabled"):
                print("lifecycle journal is disabled (enable with "
                      "`cilium-tpu config LifecycleJournal=true`)")
            else:
                _print_journal_lines(out.get("events", ()),
                                     with_node=True)
                nodes = out.get("nodes", ())
                flag = "" if out.get("consistent", True) else \
                    "  HLC ORDER VIOLATION"
                print(f"({len(nodes)} node(s) merged: "
                      f"{', '.join(nodes)}){flag}")
        elif args.sub == "history":
            out = s.fleet_history(limit=args.last)
            if args.json:
                _print(out)
            elif not out.get("enabled"):
                print("fleet telemetry is disabled (enable with "
                      "`cilium-tpu config FleetTelemetry=true`)")
            else:
                import datetime as _dt

                for rec in out.get("history", ()):
                    ts = _dt.datetime.fromtimestamp(rec["ts"])
                    rest = " ".join(
                        f"{k}={rec[k]}" for k in sorted(rec) if k != "ts"
                    )
                    print(f"{ts:%H:%M:%S} {rest}")
        else:
            out = s.fleet_status()
            if not out.get("enabled"):
                print("fleet telemetry is disabled (enable with "
                      "`cilium-tpu config FleetTelemetry=true`)")
            elif args.sub == "status":
                _print(out)
            else:  # top: per-node health grid, worst burn first
                agg = out
                print(f"{agg.get('nodes_reporting', 0)} node(s) "
                      f"reporting, fleet vps "
                      f"{agg.get('fleet_vps', 0.0):.1f}, epoch skew "
                      f"{agg.get('epoch_skew', 0)}")
                wb = agg.get("worst_burn") or {}
                if wb.get("objective"):
                    print(f"worst burn: {wb['objective']} on "
                          f"{wb.get('node')} ({wb.get('state')}, "
                          f"ratio {wb.get('ratio')})")
                print(f"{'node':<16}{'state':<9}{'vps':>10}"
                      f"{'p99_ms':>9}{'epoch':>7}{'lag':>5}"
                      f"{'age_s':>7}  mode")
                for n in agg.get("nodes", ()):
                    print(f"{n['node']:<16}{n['slo_state'] or '-':<9}"
                          f"{(n['vps'] or 0.0):>10.1f}"
                          f"{(n['verdict_p99_ms'] or 0.0):>9.2f}"
                          f"{(n['policy_epoch'] if n['policy_epoch'] is not None else '-'):>7}"
                          f"{(n['epoch_lag'] if n['epoch_lag'] is not None else '-'):>5}"
                          f"{n['age_s']:>7.1f}  "
                          f"{n['pipeline_mode'] or '-'}")
    elif args.cmd == "map":
        if args.sub == "list":
            _print(s.map_list())
        else:
            _print(s.map_dump(args.name))
    return 0


def run() -> int:
    """Entry point shared by `python -m cilium_tpu_torch` and
    `python -m cilium_tpu_torch.cli`."""
    try:
        return main()
    except BrokenPipeError:
        # `cilium-tpu ... | head` closing the pipe is not an error;
        # devnull swap avoids a second BrokenPipeError at interpreter
        # shutdown when stdout flushes
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(run())
