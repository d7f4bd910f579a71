"""Daemon core: the per-node agent object every surface talks to.

Re-design of daemon/daemon.go (NewDaemon :1051) for the
TPU framework: owns the policy repository, identity registry, ipcache,
prefilter, conntrack, endpoint manager, and the device pipeline, and
exposes the operations the REST API (api/v1, wiring
daemon/main.go:963-1035) and CLI surface. No kernel writes — the
"datapath" is the device pipeline; regeneration swaps device tables.

State persistence: rules/endpoints/ipcache snapshot to a state dir
(the role of /var/run/cilium endpoint dirs + restore,
daemon/state.go:53,135).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import asdict as dataclasses_asdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import _kernels, metrics
from .datapath.conntrack import FlowConntrack
from .datapath.pipeline import DatapathPipeline
from .endpoint.endpoint import Endpoint, EndpointState
from .endpoint.manager import EndpointManager
from .fqdn import DNSPoller, system_resolver
from .health import HealthProber, tcp_probe
from .ipam import IPAM
from .maps.lxcmap import LXCMap
from .maps.proxymap import ProxyMap
from .maps.routes import RouteTable
from .maps.tunnel import TunnelMap
from .mtu import MTUConfig
from .observe.flows import FlowRing
from .utils.iputil import prefix_lengths_of
from .utils.logging import get_logger
from .utils.prefix_counter import PrefixLengthCounter
from .xds.cache import ResourceCache
from .xds.npds import (
    delete_endpoint_policy,
    publish_endpoint_policy,
    wire_nphds,
)

log = get_logger("daemon")
from .engine import PolicyEngine
from .identity import IdentityRegistry
from .ipcache.ipcache import IPCache, SOURCE_AGENT
from .ipcache.prefilter import PreFilter
from .labels import parse_label_array
from .lb.service import Backend, L3n4Addr, ServiceManager
from .monitor.events import AgentNotify, L7Notify
from .monitor.hub import MonitorHub
from .ops.materialize import TRAFFIC_EGRESS, TRAFFIC_INGRESS
from .policy.api.serialization import rule_from_dict, rule_to_dict, rules_from_json
from .option import OptionMap, get_config
from .policy.repository import Repository
from .policy.search import Decision, PortContext, SearchContext, Trace
from .proxy.proxy import Proxy
from . import u8proto


def parse_dport(text: str) -> PortContext:
    """'80/tcp' | '53/udp' | '80' → PortContext (cilium policy trace
    --dport format, cilium/cmd/policy_trace.go)."""
    if "/" in text:
        port_s, proto_s = text.split("/", 1)
        return PortContext(int(port_s), proto_s.upper())
    return PortContext(int(text), "ANY")


class Daemon:
    """In-process agent (daemon/daemon.go Daemon struct)."""

    def __init__(
        self,
        state_dir: Optional[str] = None,
        *,
        conntrack: bool = True,
        dns_resolver=None,
        node_registry=None,
        health_probe=None,
        pod_cidr: str = "10.200.0.0/16",
        regen_debounce: float = 0.0,
        ct_gc_interval: float = 60.0,
        device=None,
    ) -> None:
        self.device = _kernels.resolve_device(device)
        self.state_dir = state_dir
        self.repo = Repository()
        self.registry = IdentityRegistry()
        self.ipcache = IPCache()
        self.prefilter = PreFilter()
        self.engine = PolicyEngine(self.repo, self.registry, device=self.device)
        self.conntrack = FlowConntrack() if conntrack else None
        self.services = ServiceManager()
        self.monitor = MonitorHub()
        cfg = get_config()
        # placement intent (policyd-mesh): device subset / 2D axes /
        # per-host process index resolve into the pipeline's MeshPlan
        from .datapath.placement import PlacementConfig

        placement = PlacementConfig(
            device_ids=(
                tuple(int(x) for x in cfg.mesh_devices.split(","))
                if cfg.mesh_devices
                else None
            ),
            ident_axis=cfg.mesh_ident_axis,
            process_index=cfg.mesh_process_index,
        )
        self.pipeline = DatapathPipeline(
            self.engine, self.ipcache, self.prefilter,
            conntrack=self.conntrack, lb=self.services,
            monitor=self.monitor,
            pipeline_depth=cfg.verdict_pipeline_depth,
            sharding=cfg.verdict_sharding,
            flow_ring=FlowRing(capacity=cfg.flow_ring_capacity),
            pipeline_max_depth=cfg.verdict_pipeline_max_depth,
            epoch_swap=cfg.policy_epoch_swap,
            placement=placement,
            mesh_2d=cfg.mesh_sharding_2d,
            # policyd-overload: the deadline and stall budgets are boot
            # config; the AdmissionControl/Prefilter gates themselves
            # are runtime options (default off)
            deadline_ms=cfg.verdict_deadline_ms,
            stall_ms=cfg.dispatch_stall_ms,
            # policyd-prof: the sampling period is boot config; the
            # DeviceProfiling gate itself is a runtime option (off)
            profile_sample_every=cfg.profile_sample_every,
            device=self.device,
        )
        # ONE controller registry for the whole daemon (pkg/controller;
        # `cilium status --all-controllers` reads it) — the endpoint
        # manager registers its loops here too, so nothing hides in a
        # second manager
        from .utils.controller import ControllerManager

        self.controllers = ControllerManager()
        self.endpoint_manager = EndpointManager(controllers=self.controllers)
        self.proxy = Proxy()
        if self.conntrack is not None and ct_gc_interval > 0:
            # periodic CT reaping (endpointmanager.EnableConntrackGC,
            # ctmap.go GC:345)
            self.endpoint_manager.enable_conntrack_gc(
                self.conntrack, interval=ct_gc_interval
            )
        # boot-time capability probes on a daemon thread (the
        # run_probes.sh-at-boot analog; status() peeks, never blocks)
        from . import probes as _probes

        _probes.probe_in_background()
        # datapath state maps (pkg/maps/{lxcmap,tunnel,proxymap})
        self.ipam = IPAM(pod_cidr)
        self.lxcmap = LXCMap()
        self.tunnel = TunnelMap()
        self.routes = RouteTable()
        self.proxymap = ProxyMap()
        self.mtu = MTUConfig()
        # distinct CIDR prefix lengths in force (pkg/counter) — a new
        # length forces a datapath trie rebuild (the compileBase
        # trigger of daemon/policy.go:184-195)
        self.prefix_lengths = PrefixLengthCounter()
        # datapath redirect verdicts → proxymap entries (the
        # cilium_proxy4/6 write of bpf_lxc.c; the L7 front-end reads
        # them back to recover original destination + source identity)
        self.pipeline.on_redirect = self._record_proxy_flow
        # per-endpoint option resolution for event gating (`cilium
        # endpoint config` overrides, layered over the daemon map)
        self.pipeline.endpoint_options = self._endpoint_option
        # policyd-flows: flow records carry label strings, resolved
        # lazily for the sampled subset only (never per-flow-in-batch)
        self.pipeline.identity_labels = self._identity_label_strings
        # xDS distribution (pkg/envoy xDS): NPDS per-endpoint L7
        # policy + NPHDS identity→addresses, served to external
        # proxies by an XDSServer the embedder/CLI attaches
        self.xds_cache = ResourceCache()
        wire_nphds(self.xds_cache, self.ipcache)
        # policyd-fleetobs: the FleetTelemetry sampler slot + its boot
        # knobs exist BEFORE option seeding so a boot-enabled option
        # can start the sampler from the on_change handler; None while
        # the option is off (the fleet plane stays unimported)
        self._fleet_sampler = None
        self._telemetry_sample_s = cfg.telemetry_sample_s
        self._telemetry_ring_rows = cfg.telemetry_ring_rows
        # policyd-journal: the LifecycleJournal slots + boot knobs,
        # same pre-seeding discipline as the sampler above; None while
        # the option is off (the journal plane stays unimported)
        self._journal = None
        self._journal_publisher = None
        self._journal_capacity = cfg.journal_ring_capacity
        self._journal_publish_s = cfg.journal_publish_s
        self._journal_tail_n = cfg.journal_tail_n
        # runtime-mutable option map (pkg/option: PATCH /config /
        # `cilium config`); endpoints inherit it (applyOptsLocked)
        self.options = OptionMap()
        self.options.set("Policy", True)
        self.options.set("Conntrack", conntrack)
        self.options.set("DropNotification", True)
        # boot value rides DaemonConfig; the pipeline already took it
        # via its ctor, so seed the map BEFORE wiring on_change
        self.options.set("VerdictSharding", cfg.verdict_sharding)
        self.options.set("MeshSharding2D", cfg.mesh_sharding_2d)
        self.options.set("EpochSwap", cfg.policy_epoch_swap)
        self.options.on_change(self._on_option_change)
        # the remaining datapath-gated options need their on_change
        # side effect (pipeline setters / shared L7 pipeline / fault
        # hub), so their boot values seed AFTER on_change is wired;
        # contracts.OPTION_BOOT_FIELDS pairs each with its field and
        # rule OPT001 machine-checks the pairing
        for opt_name, boot_on in (
            ("L7DeviceBatch", cfg.l7_device_batch),
            ("PolicyVerdictNotification", cfg.policy_verdict_notification),
            ("PhaseTracing", cfg.phase_tracing),
            ("FlowAttribution", cfg.flow_attribution),
            ("DispatchAutoTune", cfg.dispatch_autotune),
            ("FailOpen", cfg.fail_open),
            ("AdmissionControl", cfg.admission_control),
            ("Prefilter", cfg.prefilter_shed),
            ("SparseDeltas", cfg.sparse_deltas),
            ("DeviceProfiling", cfg.device_profiling),
            ("FaultInjection", cfg.fault_injection),
            ("FleetTelemetry", cfg.fleet_telemetry),
            ("LifecycleJournal", cfg.lifecycle_journal),
        ):
            if boot_on:
                self.options.set(opt_name, True)
        # daemon boot marker: the journal's causal anchor for the
        # restart-downtime window (restore_done closes it). Emitted
        # here — before restore_state — so journal-computed downtime
        # spans the same window as restart_downtime_seconds.
        self._journal_emit(kind="boot", attrs={
            "policy_epoch": self.pipeline.policy_epoch,
        })
        # fleet regeneration is synchronous by default (tests and
        # small deployments observe effects immediately); a busy node
        # sets regen_debounce > 0 to fold bursts of endpoint churn
        # into rate-limited sweeps (pkg/trigger TriggerPolicyUpdates)
        self._regen_trigger = None
        if regen_debounce > 0:
            from .utils.trigger import Trigger

            self._regen_trigger = Trigger(
                lambda reasons: self._regenerate_now(
                    "; ".join(reasons) or "debounced"
                ),
                min_interval=regen_debounce,
                name="fleet-regeneration",
            )
        # serializes snapshot writers: API threads AND the background
        # DNS poller both reach save_state
        self._save_lock = threading.Lock()
        self._compiled_saved_basis = None  # (rev, id_ver, vocab_ver)
        self._compiled_saved_at = float("-inf")
        # policyd-survive: CT snapshot debounce + restore provenance
        # (bugtool ct.json) + restart-downtime stamp
        self._ct_saved_at = float("-inf")
        self._ct_save_suppressed = False  # True while restore_state runs
        self._ct_restore_info: Optional[Dict] = None
        self._restore_started: Optional[float] = None
        # identity allocation is pluggable: clustered deployments
        # (cluster.py ClusterNode) swap in the kvstore CAS allocator
        # so the whole cluster numbers identities identically
        self.allocate_identity = self.registry.allocate
        self.release_identity = self.registry.release
        # policyd-fed: a federation membership (federation/member.py)
        # is attached after the kvstore join; the ClusterFederation
        # runtime option decides whether the identity source routes
        # through it
        self._federation = None
        # node connectivity prober (cilium-health launch,
        # daemon/main.go:927-945); probes the node registry when one
        # is attached, reports empty standalone
        self.health = HealthProber(
            nodes=node_registry, probe=health_probe or tcp_probe
        )
        # ToFQDNs poller (fqdn.StartDNSPoller, daemon/main.go:808 —
        # started lazily via fqdn_start(); tests drive fqdn_poll())
        self.fqdn = DNSPoller(
            self.repo,
            resolver=dns_resolver or system_resolver,
            on_change=lambda rev: (
                self._regenerate("fqdn update"),
                self.save_state(),
            ),
        )
        # L7 access-log records surface on the monitor stream the way
        # the reference forwards proxy logs as monitor agent events
        # (pkg/proxy/logger → monitor).
        self.proxy.accesslog.subscribe(
            lambda r: self.monitor.publish(
                L7Notify(verdict=r.verdict, detail=json.dumps(r.to_dict()))
            )
            if self.monitor.active
            else None
        )
        self._lock = threading.RLock()
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            self.restore_state()
            if self.conntrack is not None:
                # periodic CT persistence (policyd-survive): verdict
                # batches churn the table without ever touching
                # save_state, so without this sweep a crash restores a
                # CT snapshot frozen at the last policy mutation. The
                # writer itself debounces; the first trigger re-persists
                # whatever restore just placed.
                self.controllers.update_controller(
                    "ct-snapshot-sync",
                    lambda: self._save_ct_snapshot(),
                    run_interval=self.CT_SNAPSHOT_MIN_INTERVAL_S,
                )

    @staticmethod
    def _rule_cidrs(rules) -> List[str]:
        """Every CIDR prefix a rule set installs (pkg/policy/cidr.go
        GetCIDRPrefixes role) — CIDRRule exceptions expand into the
        covering sub-prefixes the datapath actually materializes."""
        from .policy.cidr import compute_resultant_cidr_set

        out: List[str] = []
        for r in rules:
            for ing in r.ingress:
                out.extend(ing.from_cidr)
                out.extend(compute_resultant_cidr_set(ing.from_cidr_set))
            for eg in r.egress:
                out.extend(eg.to_cidr)
                out.extend(compute_resultant_cidr_set(eg.to_cidr_set))
        return out

    # -- policy ---------------------------------------------------------
    def policy_add(self, rules_json: str) -> Dict:
        """PUT /policy (daemon/policy.go PolicyAdd:167)."""
        rules = rules_from_json(rules_json)
        rev = self.repo.add_list(rules)
        self._regenerate("policy import")
        self.save_state()
        log.info("policy imported",
                 fields={"policyRevision": rev, "rules": len(rules)})
        return {"revision": rev, "count": len(rules)}

    def policy_get(self, labels: Optional[Sequence[str]] = None) -> Dict:
        """GET /policy (daemon/policy.go getPolicy)."""
        with self.repo._lock:
            rules = list(self.repo.rules)
        if labels:
            sel = parse_label_array(labels)
            rules = [
                r for r in rules
                if all(any(l == rl for rl in r.labels) for l in sel)
            ]
        return {
            "revision": self.repo.revision,
            "rules": [rule_to_dict(r) for r in rules],
        }

    def policy_replace(self, labels: Sequence[str], rules_json: str) -> Dict:
        """Atomic upsert: swap the rules carrying ``labels`` for the
        given rule set under one repository lock, then regenerate ONCE
        — the MODIFIED-event path (no enforcement gap, no doubled
        regeneration)."""
        rules = rules_from_json(rules_json)
        rev, n_deleted = self.repo.replace_by_labels(
            parse_label_array(labels), rules
        )
        self._regenerate("policy replace")
        self.save_state()
        return {"revision": rev, "count": len(rules), "deleted": n_deleted}

    def policy_delete(self, labels: Sequence[str]) -> Dict:
        """DELETE /policy (daemon/policy.go PolicyDelete:253). A no-op
        delete (nothing matched) skips regeneration and the state
        save — upsert-style callers probe-delete before every add."""
        rev, deleted = self.repo.take_by_labels(parse_label_array(labels))
        if deleted:
            self._regenerate("policy delete")
            self.save_state()
        return {"revision": rev, "deleted": len(deleted)}

    def policy_translate(self, translator) -> Dict:
        """Re-translate imported rules against changed external state
        (k8s service churn; daemon/k8s_watcher.go → TranslateRules)."""
        rev, n = self.repo.translate_rules(translator)
        if n:
            self._regenerate("policy translate")
            self.save_state()
        return {"revision": rev, "changed": n}

    def policy_resolve(
        self,
        src_labels: Sequence[str],
        dst_labels: Sequence[str],
        dports: Sequence[str] = (),
        *,
        ingress: bool = True,
        verbose: bool = False,
    ) -> Dict:
        """GET /policy/resolve — the `cilium policy trace` backend
        (daemon/policy.go getPolicyResolve.Handle:66-126): runs the
        traced host oracle AND the device engine, asserting parity so
        every trace doubles as a device-correctness check."""
        src = parse_label_array(src_labels)
        dst = parse_label_array(dst_labels)
        ports = tuple(parse_dport(p) for p in dports)
        ctx = SearchContext(
            src=src, dst=dst, dports=ports,
            trace=Trace.VERBOSE if verbose else Trace.ENABLED,
        )
        oracle = (
            self.repo.allows_ingress(ctx) if ingress
            else self.repo.allows_egress(ctx)
        )

        # Device parity: identities for both label sets (ref-counted
        # temporaries when not already allocated).
        src_id = self.registry.lookup_by_labels(src)
        dst_id = self.registry.lookup_by_labels(dst)
        tmp = []
        for have, lbls in ((src_id, src), (dst_id, dst)):
            if have is None:
                # the PLUGGABLE allocator: clustered daemons must not
                # mint local-cursor numbers that collide with the
                # cluster's CAS numbering
                tmp.append(self.allocate_identity(lbls))
        src_id = src_id or self.registry.lookup_by_labels(src)
        dst_id = dst_id or self.registry.lookup_by_labels(dst)
        subj, peer = (dst_id, src_id) if ingress else (src_id, dst_id)
        if ports:
            decs = [
                self.engine.verdict_one(
                    subj.id, peer.id, p.port,
                    u8proto.from_name(p.protocol) if p.protocol not in ("ANY", "") else 6,
                    ingress=ingress, l4=True,
                )[0]
                for p in ports
            ]
            device_allowed = all(d == 1 for d in decs)
        else:
            device_allowed = (
                self.engine.verdict_one(
                    subj.id, peer.id, 0, 6, ingress=ingress, l4=False
                )[0] == 1
            )
        for ident in tmp:
            self.release_identity(ident)

        oracle_allowed = oracle == Decision.ALLOWED
        return {
            "verdict": str(oracle),
            "allowed": oracle_allowed,
            "device_allowed": device_allowed,
            "parity": oracle_allowed == device_allowed,
            "trace": ctx.log(),
        }

    def policy_explain(
        self,
        src_labels: Sequence[str],
        dst_labels: Sequence[str],
        dport: str = "",
        *,
        ingress: bool = True,
    ) -> Dict:
        """GET /policy/explain (policyd-flows): replay ONE flow through
        the verdict kernel with attribution on and name the deciding
        repository rule + drop reason — `cilium policy trace` answered
        by the device program instead of the host oracle."""
        src = parse_label_array(src_labels)
        dst = parse_label_array(dst_labels)
        port = parse_dport(dport) if dport else None
        # identity resolution mirrors policy_resolve: ref-counted
        # temporaries for label sets without a live identity
        src_id = self.registry.lookup_by_labels(src)
        dst_id = self.registry.lookup_by_labels(dst)
        tmp = []
        for have, lbls in ((src_id, src), (dst_id, dst)):
            if have is None:
                tmp.append(self.allocate_identity(lbls))
        src_id = src_id or self.registry.lookup_by_labels(src)
        dst_id = dst_id or self.registry.lookup_by_labels(dst)
        subj, peer = (dst_id, src_id) if ingress else (src_id, dst_id)
        try:
            if port is not None:
                proto = (
                    u8proto.from_name(port.protocol)
                    if port.protocol not in ("ANY", "") else 6
                )
                out = self.engine.explain_one(
                    subj.id, peer.id, port.port, proto,
                    ingress=ingress, l4=True,
                )
            else:
                out = self.engine.explain_one(
                    subj.id, peer.id, 0, 6, ingress=ingress, l4=False,
                )
        finally:
            for ident in tmp:
                self.release_identity(ident)
        out["direction"] = "ingress" if ingress else "egress"
        out["src_identity"] = src_id.id
        out["dst_identity"] = dst_id.id
        return out

    # -- endpoints ------------------------------------------------------
    def endpoint_add(
        self,
        endpoint_id: int,
        labels: Sequence[str],
        *,
        ipv4: Optional[str] = None,
        ipv6: Optional[str] = None,
        pod_name: str = "",
    ) -> Dict:
        """PUT /endpoint/{id} (daemon/endpoint.go putEndpointID →
        endpointmanager.Insert + AllocateIdentity + ipcache upsert +
        regenerate)."""
        with self._lock:
            if self.endpoint_manager.lookup(endpoint_id) is not None:
                raise ValueError(f"endpoint {endpoint_id} exists")
            lbls = parse_label_array(labels)
            ep = Endpoint(endpoint_id, lbls, ipv4=ipv4, ipv6=ipv6,
                          pod_name=pod_name, parent_options=self.options)
            # CREATING → WAITING_FOR_IDENTITY → READY (endpoint.go
            # lifecycle) so the first regeneration is legal.
            ep.set_state(EndpointState.WAITING_FOR_IDENTITY)
            ep.identity = self.allocate_identity(lbls)
            ep.set_state(EndpointState.READY)
            self.endpoint_manager.insert(ep)
            if ipv4:
                self.ipcache.upsert(f"{ipv4}/32", ep.identity.id,
                                    source=SOURCE_AGENT)
            if ipv6:
                self.ipcache.upsert(f"{ipv6}/128", ep.identity.id,
                                    source=SOURCE_AGENT)
            self._sync_pipeline_endpoints()
            # a fresh identity changes what OTHER endpoints' L7
            # identity scopes must allow — regenerate the fleet (the
            # identity-watcher → TriggerPolicyUpdates path; it covers
            # the new endpoint too)
            self._regenerate("endpoint created")
        self.save_state()
        self.notify_agent("endpoint-created", f"endpoint {endpoint_id}")
        log.info("endpoint created", fields={
            "endpointID": endpoint_id,
            "identity": ep.identity.id if ep.identity else 0,
            "ipAddr": ipv4 or ipv6 or "",
        })
        return self._endpoint_model(ep)

    def endpoint_delete(self, endpoint_id: int) -> bool:
        with self._lock:
            ep = self.endpoint_manager.lookup(endpoint_id)
            if ep is None:
                return False
            self.endpoint_manager.remove(ep)
            if ep.ipv4:
                self.ipcache.delete(f"{ep.ipv4}/32", SOURCE_AGENT)
                # REST/CLI deletes must return the address to the pool
                # or the pod CIDR leaks dry. release() is a no-op False
                # for addresses IPAM never allocated (static IPs).
                self.ipam.release(ep.ipv4)
            if ep.ipv6:
                self.ipcache.delete(f"{ep.ipv6}/128", SOURCE_AGENT)
            if ep.identity is not None:
                self.release_identity(ep.identity)
            self._sync_pipeline_endpoints()
            # release the endpoint's L7 redirects (and their proxy
            # ports) BEFORE the fleet regen republishes NPDS
            self.proxy.remove_endpoint(endpoint_id)
            # the released identity must drop out of every OTHER
            # endpoint's L7 scope + published NPDS (symmetric to the
            # create-path fleet regen) — a re-allocated identity id
            # must not inherit stale allows
            self._regenerate("endpoint deleted")
        delete_endpoint_policy(self.xds_cache, endpoint_id)
        self.save_state()
        self.notify_agent("endpoint-deleted", f"endpoint {endpoint_id}")
        log.info("endpoint deleted", fields={"endpointID": endpoint_id})
        return True

    def endpoint_list(self) -> List[Dict]:
        return [self._endpoint_model(ep)
                for ep in self.endpoint_manager.endpoints()]

    def endpoint_get(self, endpoint_id: int) -> Optional[Dict]:
        """GET /endpoint/{id} (cilium endpoint get)."""
        ep = self.endpoint_manager.lookup(endpoint_id)
        return self._endpoint_model(ep) if ep is not None else None

    def endpoint_regenerate(self, endpoint_id: Optional[int] = None) -> Dict:
        """Force regeneration (cilium endpoint regenerate; endpoint.go
        regenerate REST modifier). One endpoint given an id, else all —
        the device tables rebuild either way (regeneration is
        whole-engine here, not per-endpoint program compiles)."""
        if endpoint_id is not None and (
            self.endpoint_manager.lookup(endpoint_id) is None
        ):
            raise ValueError(f"endpoint {endpoint_id} not found")
        self._regenerate_now("manual regeneration")
        return {"regenerated": (
            1 if endpoint_id is not None else len(self.endpoint_manager)
        )}

    def endpoint_labels(
        self,
        endpoint_id: int,
        add: Sequence[str] = (),
        delete: Sequence[str] = (),
    ) -> Dict:
        """Modify an endpoint's labels → new identity → regenerate
        (cilium endpoint labels -a/-d; the reference resolves the new
        identity exactly like a fresh endpoint,
        daemon/endpoint.go modifyEndpointIdentityLabelsFromAPI)."""
        from .labels.label import parse_label

        with self._lock:
            ep = self.endpoint_manager.lookup(endpoint_id)
            if ep is None:
                raise ValueError(f"endpoint {endpoint_id} not found")
            current = {str(l) for l in ep.labels}
            # canonicalize through the label parser: the user spells
            # 'app=web', the store holds 'unspec:app=web' (or
            # 'k8s:app=web') — raw-string set math would silently
            # no-op the delete and duplicate the add under a second
            # source. Source-less deletes remove the label from ANY
            # source (cilium endpoint labels -d semantics).
            removed = set()
            for spec in delete:
                lab = parse_label(spec)
                if ":" in spec.split("=", 1)[0]:
                    removed.add(str(lab))  # exact source given
                else:
                    removed |= {
                        str(l) for l in ep.labels
                        if l.key == lab.key and l.value == lab.value
                    }
            kv_present = {
                (l.key, l.value) for l in ep.labels
                if str(l) not in removed  # allow delete+add to retag source
            }
            added = {
                str(lab) for lab in (parse_label(s) for s in add)
                # same key=value under another source is already there —
                # adding a second copy would force a spurious identity
                if (lab.key, lab.value) not in kv_present
            }
            wanted = (current - removed) | added
            if wanted == current:
                return self._endpoint_model(ep)
            old_ident = ep.identity
            lbls = parse_label_array(sorted(wanted))
            ep.labels = lbls
            ep.identity = self.allocate_identity(lbls)
            if old_ident is not None:
                self.release_identity(old_ident)
            for ip, plen in ((ep.ipv4, 32), (ep.ipv6, 128)):
                if ip:
                    self.ipcache.upsert(
                        f"{ip}/{plen}", ep.identity.id, source=SOURCE_AGENT
                    )
            self._sync_pipeline_endpoints()
            self._regenerate("endpoint labels changed")
            self.save_state()
        self.notify_agent(
            "endpoint-labels",
            f"endpoint {endpoint_id} identity {ep.identity.id}",
        )
        return self._endpoint_model(ep)

    def endpoint_log(self, endpoint_id: int) -> List[Dict]:
        """Per-endpoint status log (cilium endpoint log): state moves
        + regeneration outcomes, newest last."""
        ep = self.endpoint_manager.lookup(endpoint_id)
        if ep is None:
            raise ValueError(f"endpoint {endpoint_id} not found")
        return [
            {"timestamp": ts, "code": code, "message": msg}
            for ts, code, msg in ep.status_log_snapshot()
        ]

    def ct_flush(self) -> Dict:
        """Flush the connection-tracking table (cilium bpf ct flush)."""
        n = self.conntrack.flush() if self.conntrack is not None else 0
        return {"flushed": n}

    def node_list(self) -> List[Dict]:
        """Known cluster nodes (cilium node list). Standalone daemons
        know no peers."""
        reg = getattr(self.health, "nodes", None)
        if reg is None or not hasattr(reg, "remote_nodes"):
            return []
        out = []
        for n in reg.remote_nodes():
            out.append({
                "name": n.name,
                "ipv4": n.ipv4,
                "ipv4_alloc_cidr": n.ipv4_alloc_cidr,
                "cluster": getattr(n, "cluster", "default"),
                "health_ip": getattr(n, "health_ip", None),
                "health_port": getattr(n, "health_port", None),
            })
        return out

    def map_list(self) -> List[Dict]:
        """Open-map inventory (cilium map list): name + entry count."""
        out = []
        for name in ("ct", "ipcache", "tunnel", "proxy", "metrics",
                     "routes", "lxc", "lb"):
            try:
                out.append({"name": name, "entries": len(self.map_dump(name))})
            except Exception:
                out.append({"name": name, "entries": -1})
        return out

    def _endpoint_model(self, ep: Endpoint) -> Dict:
        return {
            "id": ep.id,
            "labels": list(ep.labels.to_strings()),
            "identity": ep.identity.id if ep.identity else None,
            "ipv4": ep.ipv4,
            "ipv6": ep.ipv6,
            "state": str(ep.state.value),
            "policy_revision": ep.policy_revision,
        }

    def _sync_pipeline_endpoints(self) -> None:
        eps = self.endpoint_manager.endpoints()
        self.pipeline.set_endpoints(
            [(ep.id, ep.identity.id) for ep in eps if ep.identity]
        )
        self.lxcmap.sync_endpoints(eps)  # daemon.go:953 syncLXCMap

    def _endpoint_option(self, ep_id: int, name: str, default: bool) -> bool:
        ep = self.endpoint_manager.lookup(ep_id)
        if ep is None:
            return default
        return ep.options.get(name)  # inherits the daemon map

    def _record_proxy_flow(
        self, peer_addr: bytes, ep_idx: int, sport: int, dport: int,
        proto: int, ingress: bool, family: int,
    ) -> None:
        """bpf_lxc.c proxymap insert on redirect verdicts: key the
        redirected 5-tuple to its ORIGINAL destination + source
        identity so the L7 front-end (envoy/cilium_bpf_metadata.cc
        read side) knows where the connection was headed and who sent
        it."""
        import ipaddress as _ipa

        from .maps.proxymap import ProxyValue

        ep_id = self.pipeline.endpoint_id_at(ep_idx)
        ep = self.endpoint_manager.lookup(ep_id) if ep_id is not None else None
        ep_ip = (ep.ipv4 if family == 4 else ep.ipv6) if ep else None
        peer_ip = str(_ipa.ip_address(peer_addr))
        entry = self.ipcache.lookup_by_ip(peer_ip)
        if ingress:
            src_ip, src_port = peer_ip, sport
            dst_ip, dst_port = ep_ip or "", dport
            src_identity = entry.identity if entry else 0
        else:
            src_ip, src_port = ep_ip or "", sport
            dst_ip, dst_port = peer_ip, dport
            src_identity = ep.identity.id if ep and ep.identity else 0
        self.proxymap.record(
            src_ip, src_port, dst_ip, dst_port, proto,
            ProxyValue(
                orig_dst_ip=dst_ip,
                orig_dst_port=dst_port,
                src_identity=src_identity,
            ),
        )

    def notify_agent(self, kind: str, message: str) -> None:
        """AgentNotify on the monitor stream (pkg/monitor/agent.go)."""
        if self.monitor.active:
            self.monitor.publish(AgentNotify(kind=kind, message=message))

    def _regenerate(self, reason: str) -> None:
        if self._regen_trigger is not None:
            self._regen_trigger.trigger(reason)
            return
        self._regenerate_now(reason)

    def _regenerate_now(self, reason: str) -> None:
        # authoritative prefix-length recount (pkg/counter role):
        # incremental add/delete pairs drift once translation or the
        # DNS poller rewrites rule CIDRs, so recount from the live set
        with self.repo._lock:
            rules = list(self.repo.rules)
        self.prefix_lengths.resync(prefix_lengths_of(self._rule_cidrs(rules)))
        self.endpoint_manager.regenerate_all(
            self.pipeline, reason, proxy=self.proxy
        )
        # NPDS: republish every endpoint's L7 policy post-regeneration
        # (UpdateNetworkPolicy, pkg/envoy/server.go:535)
        for ep in self.endpoint_manager.endpoints():
            publish_endpoint_policy(self.xds_cache, ep.id, self.proxy)
        self.notify_agent("regenerate", reason)

    # -- map dumps ------------------------------------------------------
    def policymap_dump(self, endpoint_id: int, *, ingress: bool = True) -> List[Dict]:
        """`cilium bpf policy get <ep>` analog: the realized policymap
        rows for one endpoint (pkg/maps/policymap DumpToSlice)."""
        idx = self.pipeline.endpoint_index(endpoint_id)
        if idx is None:
            raise KeyError(f"endpoint {endpoint_id} not in datapath")
        snaps = self.pipeline.snapshots(ingress=ingress)
        out = []
        for key, redirect in sorted(
            snaps[idx].entries.items(),
            key=lambda kv: (kv[0].identity, kv[0].dport, kv[0].nexthdr),
        ):
            out.append({
                "identity": key.identity,
                "dport": key.dport,
                "proto": key.nexthdr,
                "direction": "ingress" if key.direction == TRAFFIC_INGRESS
                             else "egress",
                "redirect": bool(redirect),
            })
        return out

    # -- identities -----------------------------------------------------
    def identity_list(self) -> List[Dict]:
        return [
            {"id": i.id, "labels": list(i.labels.to_strings())}
            for i in sorted(self.registry, key=lambda i: i.id)
        ]

    def identity_get(self, num: int) -> Optional[Dict]:
        ident = self.registry.get(num)
        if ident is None:
            return None
        return {"id": ident.id, "labels": list(ident.labels.to_strings())}

    def _identity_label_strings(self, num: int) -> Tuple[str, ...]:
        """Label strings for a numeric identity, () when unknown —
        the pipeline's flow-record label resolver (sampled flows
        only, so a registry miss is cheap and non-fatal)."""
        ident = self.registry.get(num)
        if ident is None:
            return ()
        return tuple(ident.labels.to_strings())

    # -- runtime config (pkg/option; PATCH /config) ----------------------
    # options whose runtime mutation actually changes behavior; the
    # rest are rejected so the surface never claims changes it cannot
    # deliver (the reference verifies per-option too, option.go)
    _MUTABLE_OPTIONS = frozenset(
        {
            "Conntrack", "TraceNotification", "DropNotification", "Debug",
            "PhaseTracing", "VerdictSharding", "MeshSharding2D",
            "FlowAttribution", "DispatchAutoTune", "FailOpen",
            "FaultInjection", "EpochSwap", "L7DeviceBatch",
            "AdmissionControl", "Prefilter", "SparseDeltas",
            "DeviceProfiling",
            "ClusterFederation", "PolicyVerdictNotification",
            "FleetTelemetry", "LifecycleJournal",
        }
    )

    def _on_option_change(self, name: str, value: bool) -> None:
        if name == "TraceNotification":
            # trace events for forwarded flows are gated per option
            self.pipeline.trace_enabled = value
        elif name == "Conntrack":
            # detach/reattach the CT pre-pass (flows re-verdict on
            # every batch while detached). Reattach FLUSHES: policy
            # may have changed while detached (the detached table
            # skips the pipeline's basis-move flushes), so stale
            # established-flow bypasses must not come back with it.
            if value and self.conntrack is not None:
                self.conntrack.flush()
            self.pipeline.conntrack = self.conntrack if value else None
        elif name == "DropNotification":
            self.pipeline.drop_notifications = value
        elif name == "PolicyVerdictNotification":
            # per-verdict monitor events (pkg/monitor PolicyVerdict
            # notifications): one PolicyVerdictNotify per sampled flow
            # on the event path; OFF keeps the emit loop untouched
            self.pipeline.verdict_notifications = value
        elif name == "PhaseTracing":
            # policyd-trace: span tracing on the verdict path
            if value:
                self.pipeline.tracer.enable()
            else:
                self.pipeline.tracer.disable()
        elif name == "VerdictSharding":
            # flow-sharded dispatch; placement changes on next rebuild
            # (a single-device node accepts the option as a no-op)
            self.pipeline.set_sharding(value)
        elif name == "MeshSharding2D":
            # policyd-mesh: 2D flows×ident mesh with ident-sharded
            # device tables; the placement plan re-resolves on the
            # next rebuild (a node without an even device factor
            # degrades to the 1D plan — accepted as a no-op)
            self.pipeline.set_mesh_2d(value)
        elif name == "FlowAttribution":
            # policyd-flows: per-flow rule attribution + flow-log ring;
            # the verdict program recompiles with the origin tail on
            # the next rebuild, the off path keeps today's program
            self.pipeline.set_attribution(value)
        elif name == "DispatchAutoTune":
            # policyd-autotune: adaptive pipeline depth; off restores
            # the static configured depth
            self.pipeline.set_autotune(value)
        elif name == "FailOpen":
            # policyd-failsafe: what degraded mode returns — forward
            # (fail-open) vs the default deny with reason 155
            self.pipeline.set_fail_open(value)
        elif name == "EpochSwap":
            # policyd-delta: shadow-built full rebuilds swapped in at
            # a batch boundary; off abandons any in-flight shadow
            self.pipeline.set_epoch_swap(value)
        elif name == "L7DeviceBatch":
            # policyd-l7batch: fused, overlapped L7 classification;
            # off drains the L7 pipeline and policies fall back to the
            # exact pre-option per-field programs on the next batch
            from .datapath import l7_pipeline as _l7rt
            from .option import get_config as _get_config

            _l7rt.set_device_batch(
                value,
                tracer=self.pipeline.tracer,
                depth=_get_config().l7_pipeline_depth,
                device=self.device,
            )
        elif name == "AdmissionControl":
            # policyd-overload: the AIMD admission gate; off keeps the
            # submit path at one attribute read (exact pre-option path)
            self.pipeline.set_admission(value)
        elif name == "Prefilter":
            # policyd-overload: the coarse shed table compiles +
            # publishes on the next rebuild; off publishes None and the
            # shed kernels never trace
            self.pipeline.set_prefilter_shed(value)
        elif name == "SparseDeltas":
            # policyd-sparse: O(k) placed sel_match patching + in-place
            # LPM trie prefix patches; toggling either way drops the
            # caches so the next rebuild establishes the chosen layout
            # (off = exact pre-option dense re-place / classic tries)
            self.pipeline.set_sparse_deltas(value)
        elif name == "DeviceProfiling":
            # policyd-prof: the sampling device profiler; off clears
            # the instance and both dispatch paths return to one
            # attribute read per batch (exact pre-option programs)
            self.pipeline.set_profiling(value)
            from .datapath import l7_pipeline as _l7rt

            _l7rt.set_profiler(self.pipeline.profiler)
        elif name == "ClusterFederation":
            # policyd-fed: swap the identity source onto the attached
            # federation membership (cluster-wide reserve/confirm CAS
            # numbering); off restores the local registry path. No
            # recompile either way — identity NUMBERING is the only
            # difference, so the OFF path's programs stay bit-identical
            fed = self._federation
            if value and fed is not None:
                self.allocate_identity = fed.allocate
                self.release_identity = fed.release
            else:
                self.allocate_identity = self.registry.allocate
                self.release_identity = self.registry.release
        elif name == "FleetTelemetry":
            # policyd-fleetobs: start/stop the cadence sampler thread.
            # The fleet plane is imported lazily HERE and only here —
            # the off path never loads the frame codec and the verdict
            # path never reads anything fleet-related, so off is
            # bit-identical (tripwire-tested)
            if value:
                self._start_fleet_sampler()
            else:
                self._stop_fleet_sampler()
        elif name == "LifecycleJournal":
            # policyd-journal: start/stop the event journal + tail
            # publisher. The journal plane is imported lazily HERE and
            # only here — off resets every hot-module on_journal slot
            # to None (one attribute read per site) and the verdict
            # path is bit-identical (tripwire-tested)
            if value:
                self._start_journal()
            else:
                self._stop_journal()
        elif name == "FaultInjection":
            # policyd-failsafe: arm/disarm the injection hub; off keeps
            # rules queued so a re-enable resumes a chaos scenario
            from . import faults as _faults

            if value:
                _faults.hub.enable()
            else:
                _faults.hub.disable()
        elif name == "Debug":
            import logging as _logging

            _logging.getLogger("cilium_tpu").setLevel(
                _logging.DEBUG if value else _logging.INFO
            )
        log.info("option changed", fields={"option": name, "value": value})

    def _validated_options(self, options: Dict) -> Dict[str, bool]:
        """Validate EVERY entry before any mutation — a bad entry in a
        batch must not leave earlier options silently applied while
        the client sees a 400."""
        from .option import OPTION_SPECS, _parse_bool

        out: Dict[str, bool] = {}
        for name, value in options.items():
            if name not in OPTION_SPECS:
                raise ValueError(f"unknown option {name!r}")
            if name not in self._MUTABLE_OPTIONS:
                raise ValueError(f"option {name!r} is not runtime-mutable")
            if name == "Conntrack" and self.conntrack is None:
                # a daemon started without a CT table cannot deliver
                # this change — reporting it applied would lie
                raise ValueError(
                    "Conntrack cannot be enabled: daemon started "
                    "without a conntrack table"
                )
            if (
                name == "ClusterFederation"
                and (value if isinstance(value, bool) else _parse_bool(value))
                and self._federation is None
            ):
                # enabling with no membership would silently keep the
                # registry path — same never-lie rule as Conntrack
                raise ValueError(
                    "ClusterFederation cannot be enabled: no federation "
                    "membership attached (daemon.attach_federation)"
                )
            out[name] = value if isinstance(value, bool) else _parse_bool(value)
        return out

    def config_get(self) -> Dict:
        """GET /config (daemon/config.go): static config + the mutable
        option snapshot."""
        return {
            "pod_cidr": str(self.ipam.net),
            "options": self.options.snapshot(),
        }

    def config_patch(self, options: Dict) -> Dict:
        """PATCH /config: mutate runtime options atomically (validate
        all, then apply)."""
        validated = self._validated_options(options)
        changed = [
            name for name, b in validated.items() if self.options.set(name, b)
        ]
        return {"changed": changed, "options": self.options.snapshot()}

    def endpoint_config(self, endpoint_id: int, options: Dict) -> Dict:
        """PATCH /endpoint/{id}/config (cilium endpoint config):
        per-endpoint overrides layered over the daemon map."""
        ep = self.endpoint_manager.lookup(endpoint_id)
        if ep is None:
            raise KeyError(f"endpoint {endpoint_id} not found")
        validated = self._validated_options(options)
        for name, b in validated.items():
            ep.options.set(name, b)
        return {"id": endpoint_id, "options": ep.options.snapshot()}

    # -- map dumps (cilium bpf * list) -----------------------------------
    def map_dump(self, name: str) -> List[Dict]:
        """One shared name→dump table for the REST route and the CLI
        (`cilium bpf <map> list`)."""
        dumps = {
            "ct": self.ct_dump,
            "ipcache": self.ipcache_dump,
            "tunnel": self.tunnel_dump,
            "proxy": self.proxymap_dump,
            "metrics": self.metricsmap_dump,
            "routes": lambda: [
                dataclasses_asdict(r) for r in self.routes.items()
            ],
            # cilium bpf endpoint list (lxcmap) / bpf lb list (lbmap)
            "lxc": lambda: [
                {"ip": ip, **dataclasses_asdict(info)}
                for ip, info in self.lxcmap.items()
            ],
            "lb": lambda: [
                {
                    "frontend": str(s.frontend),
                    "backends": [
                        {"ip": b.ip, "port": b.port, "weight": b.weight}
                        for b in s.backends
                    ],
                    "id": s.id,
                }
                for s in self.services.list()
            ],
        }
        fn = dumps.get(name)
        if fn is None:
            raise ValueError(f"unknown map {name!r}")
        return fn()

    def ct_dump(self) -> List[Dict]:
        return self.conntrack.dump() if self.conntrack is not None else []

    def ipcache_dump(self) -> List[Dict]:
        return [
            {"cidr": cidr, "identity": e.identity, "source": e.source,
             "host_ip": e.host_ip}
            for cidr, e in sorted(self.ipcache.items())
        ]

    def tunnel_dump(self) -> List[Dict]:
        return [
            {"prefix": p, "endpoint": ep} for p, ep in self.tunnel.items()
        ]

    def proxymap_dump(self) -> List[Dict]:
        return self.proxymap.items()

    def metricsmap_dump(self) -> List[Dict]:
        """Per-endpoint forwarded/dropped counters (metricsmap role)."""
        out = []
        counters = self.pipeline.counters
        for idx in range(counters.shape[0]):
            ep_id = self.pipeline.endpoint_id_at(idx)
            if ep_id is None:
                continue
            fwd, dpol, dother = (int(x) for x in counters[idx])
            out.append({
                "endpoint": ep_id, "forwarded": fwd,
                "dropped_policy": dpol, "dropped_other": dother,
            })
        return out

    # -- services (daemon/loadbalancer.go PUT/GET/DELETE /service) -------
    @staticmethod
    def _frontend(fe: Dict) -> L3n4Addr:
        return L3n4Addr(fe["ip"], int(fe["port"]),
                        str(fe.get("protocol", "TCP")).upper())

    @staticmethod
    def _service_model(svc) -> Dict:
        return {
            "id": svc.id,
            "frontend": {
                "ip": svc.frontend.ip,
                "port": svc.frontend.port,
                "protocol": svc.frontend.protocol,
            },
            "backends": [
                {"ip": b.ip, "port": b.port, "weight": b.weight}
                for b in svc.backends
            ],
        }

    def service_upsert(self, frontend: Dict, backends: Sequence[Dict]) -> Dict:
        svc = self.services.upsert(
            self._frontend(frontend),
            [
                Backend(b["ip"], int(b["port"]), int(b.get("weight", 1)))
                for b in backends
            ],
        )
        self._regenerate("service upsert")
        self.save_state()
        return self._service_model(svc)

    def service_delete(self, frontend: Dict) -> bool:
        ok = self.services.delete(self._frontend(frontend))
        if ok:
            self._regenerate("service delete")
            self.save_state()
        return ok

    def service_list(self) -> List[Dict]:
        return [self._service_model(s) for s in self.services.list()]

    # -- fqdn -----------------------------------------------------------
    def fqdn_poll(self) -> Dict:
        """One DNS resolution sweep (the 5s tick of dnspoller.go:78)."""
        changed = self.fqdn.poll_once()
        return {
            "names": self.fqdn.tracked_names(),
            "rules_changed": changed,
            "revision": self.repo.revision,
        }

    def fqdn_start(self, interval: float = 5.0) -> None:
        self.fqdn.start(interval)

    # -- health / debuginfo ---------------------------------------------
    def attach_node_registry(self, registry, *, probe_interval: float = 60.0) -> None:
        """Give the health prober a cluster node registry
        (nodes/registry.py) and start probing — clustered deployments
        call this after joining the kvstore; standalone daemons have
        no peers to probe."""
        self.health.nodes = registry
        self.health.start(probe_interval)
        # remote alloc CIDRs → tunnel endpoints (node/manager.go);
        # registries without an observer feed (tests, static lists)
        # just skip tunnel programming
        if hasattr(registry, "observe"):
            self.tunnel.observe_nodes(registry)
            self.routes.observe_nodes(
                registry, route_mtu=self.mtu.route_mtu
            )

    # -- federation (policyd-fed) ----------------------------------------
    def attach_federation(self, member) -> None:
        """Attach a federation membership (federation/member.py) after
        the kvstore join; the ClusterFederation runtime option decides
        whether the identity source actually routes through it (and
        re-applies immediately if it was already on)."""
        self._federation = member
        if self.options.get("ClusterFederation"):
            self.allocate_identity = member.allocate
            self.release_identity = member.release
        # policyd-fleetobs: a running sampler gains the telemetry
        # exchange the moment a membership exists — frames publish
        # beside the member's epoch-exchange node descriptor
        sampler = self._fleet_sampler
        if sampler is not None and sampler.exchange is None:
            from .observe.fleet import TelemetryExchange

            sampler.attach_exchange(
                TelemetryExchange(
                    member.backend, member.node_name, cluster=member.cluster
                )
            )
        # policyd-journal: a running journal gains the tail exchange,
        # the member's node identity, and the member's lease/reap
        # emission slot the same way
        pub = self._journal_publisher
        if pub is not None and pub.exchange is None:
            from .observe.journal import JournalExchange

            self._journal.node = member.node_name
            pub.attach_exchange(
                JournalExchange(
                    member.backend, member.node_name, cluster=member.cluster
                )
            )
            member.on_journal = self._journal.emit

    def detach_federation(self) -> None:
        """Drop the membership and restore the local identity source
        (the member itself is closed by its owner)."""
        if self._federation is not None:
            self._federation.on_journal = None
        if self.options.get("ClusterFederation"):
            self.options.set("ClusterFederation", False)
        self._federation = None
        self.allocate_identity = self.registry.allocate
        self.release_identity = self.registry.release
        # the telemetry exchange rode the member's backend: close it;
        # the sampler keeps ticking locally (single-node scoreboard)
        sampler = self._fleet_sampler
        if sampler is not None and sampler.exchange is not None:
            exchange, sampler.exchange = sampler.exchange, None
            try:
                exchange.close()
            except (ConnectionError, TimeoutError, OSError, RuntimeError):
                pass
        # ... and so did the journal exchange; the journal itself keeps
        # recording locally (single-node timeline)
        pub = self._journal_publisher
        if pub is not None and pub.exchange is not None:
            exchange, pub.exchange = pub.exchange, None
            try:
                exchange.close()
            except (ConnectionError, TimeoutError, OSError, RuntimeError):
                pass

    def cluster_status(self) -> Dict:
        """GET /cluster (policyd-fed): federation membership view —
        fleet nodes with their published policy epochs, the cluster
        convergence floor, and identity-allocator accounting."""
        out: Dict = {
            "enabled": self.options.get("ClusterFederation"),
            "attached": self._federation is not None,
        }
        if self._federation is not None:
            out.update(self._federation.status())
        else:
            out.update({"node": None, "node_count": 0, "nodes": []})
        return out

    # -- fleet telemetry (policyd-fleetobs) ------------------------------
    def _start_fleet_sampler(self) -> None:
        if self._fleet_sampler is not None:
            return
        # lazy import: the FleetTelemetry OFF path never loads the
        # fleet plane or the frame codec (tripwire-tested)
        from .observe import fleet as _fleet

        sampler = _fleet.FleetSampler(
            interval_s=self._telemetry_sample_s,
            capacity=self._telemetry_ring_rows,
            epoch_source=lambda: self.pipeline.policy_epoch,
        )
        member = getattr(self, "_federation", None)
        if member is not None:
            sampler.attach_exchange(
                _fleet.TelemetryExchange(
                    member.backend, member.node_name, cluster=member.cluster
                )
            )
        sampler.start()
        self._fleet_sampler = sampler

    def _stop_fleet_sampler(self) -> None:
        sampler, self._fleet_sampler = self._fleet_sampler, None
        if sampler is not None:
            sampler.stop()

    def fleet_status(self) -> Dict:
        """GET /fleet: the aggregated scoreboard — fleet-wide when a
        telemetry exchange is attached (federated), a single-node fold
        of the local sampler otherwise — plus local sampler state."""
        sampler = self._fleet_sampler
        if sampler is None:
            return {"enabled": False}
        from .observe import fleet as _fleet  # already loaded: sampler runs

        if sampler.exchange is not None:
            try:
                sampler.exchange.pump()
            except (ConnectionError, TimeoutError, OSError, RuntimeError):
                pass  # partition: serve the last applied view
            frames = sampler.exchange.frames()
            node = sampler.exchange.node_name
        else:
            node = "local"
            frames = {
                node: _fleet.encode_frame(
                    node, sampler.ring.appended, sampler.frame_body()
                )
            }
        out = _fleet.aggregate(frames)
        out["enabled"] = True
        out["node"] = node
        out["local"] = sampler.local_status()
        return out

    def fleet_history(self, limit: int = 64) -> Dict:
        """GET /fleet/history: newest-last local sampler rows (the
        ``cilium-tpu fleet history`` payload)."""
        sampler = self._fleet_sampler
        if sampler is None:
            return {"enabled": False, "history": []}
        return {
            "enabled": True,
            "fields": list(sampler.ring.fields),
            "interval_s": sampler.interval_s,
            "history": sampler.ring.history(limit),
        }

    def _slo_summary(self):
        """One-line SLO block for /status, None while FleetTelemetry
        is off (status must not wake the fleet plane)."""
        sampler = self._fleet_sampler
        if sampler is None:
            return None
        return sampler.slo_summary()

    # -- lifecycle journal (policyd-journal) -----------------------------
    def _start_journal(self) -> None:
        if self._journal is not None:
            return
        # lazy import: the LifecycleJournal OFF path never loads the
        # journal plane or the frame codec (tripwire-tested)
        from .observe import journal as _journal

        member = getattr(self, "_federation", None)
        node = member.node_name if member is not None else "local"
        j = _journal.EventJournal(node=node, capacity=self._journal_capacity)
        pub = _journal.JournalPublisher(
            j, interval_s=self._journal_publish_s, tail_n=self._journal_tail_n
        )
        if member is not None:
            pub.attach_exchange(
                _journal.JournalExchange(
                    member.backend, member.node_name, cluster=member.cluster
                )
            )
            member.on_journal = j.emit
        # hot modules reach the journal through one None-guarded
        # attribute read per site; installing the bound emit arms them
        self.pipeline.on_journal = j.emit
        adm = self.pipeline._admission
        if adm is not None:
            adm.on_journal = j.emit
        pub.start()
        self._journal = j
        self._journal_publisher = pub
        # shed episodes are edge-triggered with a hold: the poller
        # closes an episode once the hold expires without new shed
        # activity (note_shed itself only sees the next storm's edge)
        self.controllers.update_controller(
            "journal-shed-poll", self._journal_shed_poll, run_interval=1.0
        )

    def _journal_shed_poll(self) -> None:
        adm = self.pipeline._admission
        if adm is not None:
            adm.episode_poll()

    def _stop_journal(self) -> None:
        j, self._journal = self._journal, None
        pub, self._journal_publisher = self._journal_publisher, None
        if j is None:
            return
        self.controllers.remove_controller("journal-shed-poll")
        # disarm every hot-module slot before tearing the plane down
        self.pipeline.on_journal = None
        adm = self.pipeline._admission
        if adm is not None:
            adm.on_journal = None
        member = getattr(self, "_federation", None)
        if member is not None:
            member.on_journal = None
        if pub is not None:
            try:
                pub.publish_once()  # final tail (drain events) for peers
            except Exception:
                pass  # kvstore down: peers age our frame out
            pub.stop()

    def _journal_emit(self, **kw) -> None:
        """Emit one lifecycle event when the journal is on; the OFF
        path is a single attribute read (daemon-side sites only — hot
        modules carry their own on_journal slots)."""
        j = self._journal
        if j is not None:
            j.emit(**kw)

    def events(
        self,
        limit: int = 64,
        *,
        kind: Optional[str] = None,
        severity: Optional[str] = None,
        since: Optional[float] = None,
    ) -> Dict:
        """GET /events: the local journal tail + ring accounting."""
        j = self._journal
        if j is None:
            return {"enabled": False, "events": []}
        out = j.snapshot()
        out["enabled"] = True
        out["events"] = j.events(
            limit, kind=kind, severity=severity, since=since
        )
        return out

    def fleet_timeline(self, limit: int = 256) -> Dict:
        """GET /fleet/timeline: local tail + every live peer tail,
        merged into one HLC-total-ordered fleet timeline."""
        pub = self._journal_publisher
        if pub is None:
            return {"enabled": False, "events": []}
        from .observe import journal as _journal  # already loaded

        evs = pub.merged_timeline(limit)
        return {
            "enabled": True,
            "node": pub.journal.node,
            "nodes": sorted({e.get("node") for e in evs}),
            "consistent": _journal.timeline_consistent(evs),
            "events": evs,
        }

    def health_report(self) -> Dict:
        """GET /health (the cilium-health status surface)."""
        return self.health.report()

    def health_probe_now(self) -> Dict:
        """POST /health/probe — one immediate sweep (cilium-health
        `--probe`)."""
        self.health.probe_once()
        return self.health.report()

    def debuginfo(self) -> Dict:
        """GET /debuginfo (daemon/debuginfo.go)."""
        from . import bugtool

        return bugtool.collect_debuginfo(self)

    def traces(self, limit: int = 16) -> Dict:
        """GET /traces (policyd-trace ring buffer)."""
        tr = self.pipeline.tracer
        return {
            "enabled": tr.active,
            "capacity": tr.capacity,
            "pipeline_depth": self.pipeline.pipeline_depth,
            "in_flight": self.pipeline.inflight_depth,
            # policyd-flows: attribution changes what the host_sync
            # phase pulls (6 arrays, not 3) — trace readers should know
            "flow_attribution": self.pipeline.flow_ring.active,
            # policyd-autotune: None while DispatchAutoTune is off;
            # otherwise the tuner snapshot (bounds, per-depth EWMA
            # stats, adjustment counts) — waterfalls read under a
            # moving depth need this context (observe/README.md)
            "autotune": self.pipeline.autotune_state(),
            # policyd-failsafe: ladder level, breaker counters, and the
            # fault-hub snapshot — a trace read during a chaos round or
            # a real degradation needs to say WHICH path produced the
            # spans (device phases vanish at host level)
            "failsafe": self.pipeline.failsafe_state(),
            # policyd-mesh: the placement plan (mesh axes, generation,
            # device set) — sharded vs replicated tables change what a
            # dispatch span covers (per-device bytes, ident reduce)
            "placement": self.pipeline.placement_state(),
            # policyd-overload: gate limit, shed accounting, watchdog —
            # spans read during an overload spike need to say which
            # flows never reached the device path at all
            "admission": self.pipeline.admission_state(),
            # policyd-prof: per-phase p50/p99 from the registry's
            # bucket counts — callers stop eyeballing raw buckets
            "phase_quantiles": self._phase_quantiles(),
            "traces": tr.traces(limit),
        }

    def _phase_quantiles(self) -> Dict:
        """{phase: {n, p50_ms, p99_ms}} interpolated from the
        pipeline_phase_seconds histogram (metrics.Histogram.quantile)."""
        h = metrics.pipeline_phase_seconds
        out: Dict = {}
        for lbl in h.series_labels():
            phase = lbl.get("phase")
            if phase is None:
                continue
            n = h.get_count(lbl)
            if not n:
                continue
            p50 = h.quantile(0.5, lbl)
            p99 = h.quantile(0.99, lbl)
            out[phase] = {
                "n": n,
                "p50_ms": round(p50 * 1e3, 4),
                "p99_ms": round(p99 * 1e3, 4),
            }
        return out

    def profile(self) -> Dict:
        """GET /profile (policyd-prof): sampled RTT decomposition +
        per-site aggregates, the jit cost ledger, and the device
        memory/transfer ledgers."""
        snap = self.pipeline.profile_state()
        snap["device_table_bytes"] = {
            "/".join(v for _, v in key): val
            for key, val in metrics.device_table_bytes.series().items()
        }
        snap["device_transfers"] = {
            "counts": {
                "/".join(v for _, v in key) or "all": val
                for key, val in metrics.device_transfers_total.series().items()
            },
            "bytes": {
                "/".join(v for _, v in key) or "all": val
                for key, val
                in metrics.device_transfer_bytes_total.series().items()
            },
        }
        return snap

    def flows(
        self,
        limit: int = 64,
        *,
        verdict: Optional[int] = None,
        from_identity: Optional[int] = None,
        reason: Optional[int] = None,
    ) -> Dict:
        """GET /flows (policyd-flows ring buffer; the Hubble
        `cilium monitor`/flow-API analog for attributed verdicts)."""
        ring = self.pipeline.flow_ring
        return {
            "enabled": ring.active,
            "capacity": ring.capacity,
            "recorded": ring.recorded,
            "flows": ring.query(
                limit, verdict=verdict,
                from_identity=from_identity, reason=reason,
            ),
        }

    # -- status ---------------------------------------------------------
    def status(self) -> Dict:
        return {
            "policy_revision": self.repo.revision,
            "rules": len(self.repo.rules),
            "identities": len(self.registry),
            "endpoints": len(self.endpoint_manager),
            "ipcache_entries": len(self.ipcache),
            "conntrack_entries": (
                len(self.conntrack) if self.conntrack is not None else 0
            ),
            "prefilter_revision": self.prefilter.revision,
            "services": len(self.services.list()),
            "ipam_allocated": len(self.ipam),
            "lxcmap_entries": len(self.lxcmap),
            "tunnel_entries": len(self.tunnel),
            # node capability probe summary (run_probes.sh role):
            # subsystems running degraded are named, not crashed-on.
            # Non-blocking: the probe set runs on a boot thread (the
            # first native probe can pay a g++ compile), so status
            # answers "still probing" instead of stalling the RPC.
            "features_degraded": (
                peeked.get("degraded", [])
                if (peeked := self._peek_features()) is not None
                else ["probing"]
            ),
            # controller.go:282 status surfacing (`cilium status
            # --all-controllers`)
            "controllers": self.controllers.statuses(),
            # policyd-failsafe: /healthz must answer "are verdicts
            # degraded" without a second RPC — level 0 is healthy,
            # 1/2 names the mode (sharded|single-device|host)
            "pipeline_mode": self.pipeline.pipeline_mode,
            "pipeline_degraded": self.pipeline.pipeline_mode != "sharded",
            # policyd-overload: /healthz answers "is the gate shedding"
            # (queue depth, shed ratio, last stall) without a second RPC
            "admission": self.pipeline.admission_state(),
            # policyd-fed: is this node federated, and is its policy
            # epoch converged with the fleet (GET /cluster for the
            # full per-node view)
            "cluster": {
                "enabled": self.options.get("ClusterFederation"),
                "attached": self._federation is not None,
                "epoch_lag": (
                    self._federation.epochs.epoch_lag()
                    if self._federation is not None
                    else 0
                ),
            },
            # policyd-fleetobs: the one-line SLO summary (worst
            # objective + state) so health is visible without the
            # fleet CLI; None while FleetTelemetry is off. /healthz
            # keys on the plain bool.
            "slo": (slo := self._slo_summary()),
            "slo_burning": bool(slo and slo["burning"]),
        }

    def _peek_features(self):
        from . import probes

        return probes.peek_features()

    def features(self) -> Dict:
        """Node capability probes (probes.py; bpf/run_probes.sh role).
        Blocks until the probe set completes (explicit callers want
        the answer; status() uses the non-blocking peek)."""
        from . import probes

        return probes.probe_features()

    def metrics_text(self) -> str:
        return metrics.registry.expose()

    # -- state persistence (daemon/state.go role) ------------------------
    def save_state(self) -> None:
        if not self.state_dir:
            return
        with self.repo._lock:
            rules = [rule_to_dict(r) for r in self.repo.rules]
        eps = self.endpoint_list()
        # unique tmp per call + a writer lock: the fqdn poller thread
        # and API threads may snapshot concurrently, and two writers
        # sharing one tmp path would interleave into invalid JSON
        with self._save_lock:
            fd, tmp = tempfile.mkstemp(
                dir=self.state_dir, prefix=".state.", suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "w") as f:
                    from .state_migrate import SCHEMA_VERSION

                    body = {
                        "schema": SCHEMA_VERSION,
                        "rules": rules,
                        "endpoints": eps,
                        "services": self.service_list(),
                        # v3: where the CT snapshot lives (its basis
                        # stamp is authoritative inside the npz meta)
                        "ct": {
                            "snapshot": (
                                "ct.npz" if self.conntrack is not None
                                else None
                            ),
                        },
                    }
                    json.dump(body, f, indent=1)
                # _save_lock is a single-purpose snapshot-serialization
                # lock (CLI save vs shutdown poller); holding it across
                # the atomic tmp+rename IS its job — no verdict-path
                # thread ever contends on it
                os.replace(tmp, os.path.join(self.state_dir, "state.json"))  # policyd-lint: disable=LOCK002
                metrics.state_snapshot_bytes.set(
                    float(os.path.getsize(
                        os.path.join(self.state_dir, "state.json")
                    )),
                    {"kind": "state_json"},
                )
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        # compiled-state snapshot beside the JSON (pinned-map
        # persistence analog): a restart serves these tables while the
        # re-imported rules drive the recompile. Debounced — save_state
        # runs on every mutation, but the npz is heavy at scale, so it
        # is rewritten only when the compiled basis moved and at most
        # every few seconds (shutdown() forces the tail write).
        # Materialized policymaps are NOT included: across a restart
        # identity numbering may differ, so the daemon path could not
        # soundly adopt them (the engine-level API still takes them for
        # same-process restores, e.g. the bench restart measurement).
        self._save_compiled_snapshot()
        # CT snapshot beside it (policyd-survive): same debounce shape
        self._save_ct_snapshot()

    COMPILED_SNAPSHOT_MIN_INTERVAL_S = 5.0

    def _save_compiled_snapshot(self, force: bool = False) -> None:
        if not self.state_dir:
            return
        c = self.engine._compiled
        if c is None:
            return
        if c.revision < 0:
            # snapshot-restored state with re-stamped counters: writing
            # it back would overwrite the on-disk snapshot with the
            # same arrays under sentinel metadata — pure cost
            return
        basis = (c.revision, c.identity_version, c.vocab_version)
        now = time.monotonic()
        saved = False
        with self._save_lock:
            if not force:
                if basis == self._compiled_saved_basis:
                    return
                if (
                    now - self._compiled_saved_at
                    < self.COMPILED_SNAPSHOT_MIN_INTERVAL_S
                ):
                    return
            try:
                cpath = os.path.join(self.state_dir, "compiled.npz")
                self.engine.save_snapshot(cpath)
                self._compiled_saved_basis = basis
                self._compiled_saved_at = now
                metrics.state_snapshot_bytes.set(
                    float(os.path.getsize(cpath)), {"kind": "compiled"}
                )
                saved = True
            except Exception as e:
                log.warning("compiled snapshot save failed", fields={
                    "err": f"{type(e).__name__}: {e}",
                })
        if saved:
            # outside _save_lock: the journal must never extend the
            # snapshot writers' critical section
            self._journal_emit(kind="snapshot_save", attrs={
                "what": "compiled", "basis": list(basis),
            })

    CT_SNAPSHOT_MIN_INTERVAL_S = 5.0

    def _save_ct_snapshot(self, force: bool = False) -> None:
        """Write ct.npz beside compiled.npz (policyd-survive), stamped
        with the basis + CT epoch the live entries were VERDICTED
        under — the pipeline's served basis, not the engine's newest
        compile: between a recompile and the next rebuild the table
        still holds previous-basis entries, and stamping those with
        the new revision would let a raced rule change restore as a
        false match. Debounced like the compiled snapshot (CT churn is
        continuous); shutdown() forces the tail write."""
        if not self.state_dir or self.conntrack is None:
            return
        if self._ct_save_suppressed:
            return  # mid-restore: the disk pair is still authoritative
        basis = self.pipeline._mat_basis
        if basis is None or basis[0] < 0:
            return  # nothing served yet / restored sentinel counters
        if self.pipeline._ct_flush_pending:
            return  # table is condemned — the next rebuild flushes it
        # pair coherence: the basis we stamp must also be the one in
        # compiled.npz, or the restore-side match can never succeed. A
        # landed BACKGROUND recompile moves the served basis without
        # any save_state trigger (the endpoint_add save ran while the
        # compile was still in flight), so re-save compiled first.
        # Outside _save_lock — the compiled saver takes it too.
        if basis != self._compiled_saved_basis:
            self._save_compiled_snapshot(force=True)
        now = time.monotonic()
        ct_epoch = getattr(self.pipeline, "_ct_epoch", 0)
        saved = False
        with self._save_lock:
            if not force and (
                now - self._ct_saved_at < self.CT_SNAPSHOT_MIN_INTERVAL_S
            ):
                return
            from .datapath.ct_snapshot import save_ct_state

            try:
                # same _save_lock invariant as save_state above: the
                # callee's tmp+fsync+rename is exactly what the lock
                # serializes (snapshot writers), so the one-call-away
                # file I/O is the design, not a convoy
                nbytes = save_ct_state(  # policyd-lint: disable=LOCK002
                    os.path.join(self.state_dir, "ct.npz"),
                    self.conntrack,
                    basis=basis,
                    ct_epoch=ct_epoch,
                )
                self._ct_saved_at = now
                metrics.state_snapshot_bytes.set(
                    float(nbytes), {"kind": "ct"}
                )
                saved = True
            except Exception as e:
                # a failed CT save (including an injected torn write)
                # must never fail the caller's mutation path — the next
                # save retries; restore tolerates whatever is on disk
                log.warning("ct snapshot save failed", fields={
                    "err": f"{type(e).__name__}: {e}",
                })
        if saved:
            self._journal_emit(kind="snapshot_save", attrs={
                "what": "ct", "basis": list(basis), "ct_epoch": ct_epoch,
            })

    def restore_state(self) -> int:
        """Parse the snapshot and rebuild live state (restoreOldEndpoints
        + regenerateRestoredEndpoints, daemon/state.go:53,135)."""
        path = os.path.join(self.state_dir or "", "state.json")
        if not self.state_dir or not os.path.exists(path):
            return 0
        # restart-downtime clock (policyd-survive): starts at state
        # load, stops at the first completed verdict batch — the span
        # during which a restarted daemon cannot answer.
        self._restore_started = time.monotonic()
        self.pipeline.on_first_batch = self._note_restart_downtime
        # Enforcement continuity (the pinned-map property): load the
        # compiled device tables from the last save FIRST, so verdicts
        # serve last-known-good state while the re-imported rules and
        # endpoints below drive the (slow) recompile when they differ.
        cpath = os.path.join(self.state_dir, "compiled.npz")
        if os.path.exists(cpath):
            try:
                self.engine.restore_snapshot(cpath)
            except Exception as e:
                log.warning("compiled snapshot restore failed", fields={
                    "err": f"{type(e).__name__}: {e}",
                })
        # Capture the CT snapshot (and the basis of the compiled file
        # it rode beside) NOW, same early-read pattern as compiled.npz
        # above: every endpoint_add below runs save_state, whose
        # debounced snapshot writes would otherwise clobber the very
        # files we restore from.
        from .compiler.snapshot import read_snapshot_basis
        from .datapath.ct_snapshot import load_ct_state

        ct_snap = load_ct_state(os.path.join(self.state_dir, "ct.npz"))
        ct_disk_basis = read_snapshot_basis(cpath)
        # ... and the early read is not enough: a boot that dies after
        # the re-add loop but before the first CT sync would leave that
        # clobbered (empty, mid-re-add-basis) ct.npz as the ONLY copy.
        # Suppress CT snapshot writes entirely until the restore has
        # refilled the table — the on-disk pair stays exactly as the
        # dead process left it.
        self._ct_save_suppressed = True
        try:
            with open(path) as f:
                snap = json.load(f)
            # upgrade older snapshots in memory (cilium-map-migrate role)
            from .state_migrate import migrate

            snap = migrate(snap)
            rules = [rule_from_dict(d) for d in snap.get("rules", [])]
            if rules:
                self.repo.add_list(rules)
            for sm in snap.get("services", []):
                self.services.restore(
                    self._frontend(sm["frontend"]),
                    [
                        Backend(
                            b["ip"], int(b["port"]),
                            int(b.get("weight", 1)),
                        )
                        for b in sm.get("backends", [])
                    ],
                    int(sm["id"]),
                )
            n = 0
            for em in snap.get("endpoints", []):
                try:
                    self.endpoint_add(
                        em["id"], em["labels"], ipv4=em.get("ipv4"),
                        ipv6=em.get("ipv6"),
                    )
                    n += 1
                except ValueError:
                    continue
                # re-register restored IPs with IPAM so allocate_next
                # cannot hand them out again (pkg/ipam restore path)
                ip = em.get("ipv4")
                if ip:
                    try:
                        self.ipam.allocate(ip, owner=f"endpoint-{em['id']}")
                    except ValueError:
                        pass  # outside the pool (static IP) or pre-claimed
            # Established-flow continuity: restore the CT snapshot LAST —
            # every endpoint_add above ran set_endpoints, which flushes
            # the host table (CT keys embed endpoint indices, and the
            # restore loop reproduces the saved index order).
            self._restore_ct_snapshot(ct_snap, ct_disk_basis)
        finally:
            self._ct_save_suppressed = False
        # kept-vs-cold restore verdict on the journal: warning when the
        # basis mismatched (the fleet timeline shows which restarts
        # came up cold)
        info = self._ct_restore_info
        if info is not None:
            self._journal_emit(
                kind="ct_restore",
                severity="info" if info.get("basis_match") else "warning",
                attrs=dict(info),
            )
        return n

    def _restore_ct_snapshot(self, snap, basis) -> None:
        """Refill the host conntrack from the captured ct.npz payload
        when its recorded policy basis matches the compiled snapshot we
        just restored. Any mismatch — raced rule change between the two
        writes, torn file, missing compiled.npz — degrades to the
        pre-PR behaviour: a cold (flushed) table. Never raises."""
        if not self.state_dir or self.conntrack is None:
            return
        info: Dict = {
            "restored_from": os.path.join(self.state_dir, "ct.npz"),
            "kept": 0, "expired": 0, "flushed": 0,
            "basis_match": False, "snapshot_age_s": None,
        }
        if snap is None:  # missing / torn / foreign-schema file
            self._ct_restore_info = info
            return
        info["snapshot_age_s"] = max(0.0, time.time() - snap["saved_at"])
        if basis is None or basis != snap["basis"]:
            # the entries were admitted under a policy world we did not
            # restore — keeping them would enforce stale verdicts
            info["flushed"] = int(snap["entries"])
            metrics.ct_restored_entries_total.inc(
                {"result": "flushed"}, float(snap["entries"])
            )
            self._ct_restore_info = info
            return
        kept, expired = self.conntrack.restore_arrays(
            snap["ka"], snap["kb"], snap["kc"], snap["ttl"],
            packets=snap["packets"], revnat=snap["revnat"],
        )
        # the first rebuild materializes from exactly these restored
        # tables — hold its flush triggers so the refill survives it;
        # pinned to the revision current NOW, so any policy mutation
        # landing before that rebuild voids the hold and flushes
        c = self.engine._compiled
        self.pipeline._ct_restore_hold = (
            c.revision if c is not None else None
        )
        info.update(kept=kept, expired=expired, basis_match=True)
        if kept:
            metrics.ct_restored_entries_total.inc(
                {"result": "kept"}, float(kept))
        if expired:
            metrics.ct_restored_entries_total.inc(
                {"result": "expired"}, float(expired))
        self._ct_restore_info = info

    def _note_restart_downtime(self) -> None:
        """One-shot pipeline callback: first verdict batch after a
        restore closes the downtime window."""
        started = self._restore_started
        if started is None:
            return
        self._restore_started = None
        downtime = time.monotonic() - started
        metrics.restart_downtime_seconds.set(downtime)
        self._journal_emit(kind="restore_done", attrs={
            "downtime_ms": round(downtime * 1e3, 3),
        })

    def ct_restore_info(self) -> Optional[Dict]:
        """Provenance of the last CT restore attempt (bugtool)."""
        return self._ct_restore_info

    def drain(self, deadline_s: float = 5.0) -> Dict:
        """Graceful drain (policyd-survive): shed new admissions, let
        in-flight verdict batches complete FIFO under the deadline,
        persist CT + compiled + state.json, and report. Every batch is
        resolved — completed normally or degraded — so callers observe
        verdicts_lost == 0 structurally."""
        t0 = time.monotonic()
        self._journal_emit(kind="drain_begin", attrs={
            "policy_epoch": self.pipeline.policy_epoch,
            "deadline_s": float(deadline_s),
        })
        # stop the stall watchdog FIRST: the bounded wait below
        # legitimately blocks on slow completions and must not race an
        # abandonment sweep
        self.pipeline.set_stall_ms(0)
        self.pipeline.begin_drain()
        report = self.pipeline.drain(deadline_s=deadline_s)
        # flush the shared L7 inspection pipeline too — its in-flight
        # batches carry verdicts the same callers are waiting on
        try:
            from .datapath import l7_pipeline as _l7rt

            l7 = _l7rt.shared_pipeline()
            if l7 is not None:
                l7.drain()
        except Exception as e:
            log.warning("l7 drain failed", fields={
                "err": f"{type(e).__name__}: {e}",
            })
        # tail persistence while the tables are quiescent
        self._save_compiled_snapshot(force=True)
        self._save_ct_snapshot(force=True)
        self.save_state()
        elapsed = time.monotonic() - t0
        metrics.drain_seconds.observe(elapsed)
        report = dict(report)
        report.update(drain_s=elapsed, verdicts_lost=0)
        self._journal_emit(kind="drain_end", attrs={
            "drain_s": round(elapsed, 6),
            "verdicts_lost": 0,
            "completed": report.get("completed", 0),
            "abandoned": report.get("abandoned", 0),
        })
        return report

    def shutdown(self, deadline_s: float = 5.0) -> None:
        # bounded graceful drain: sheds new work, completes (or
        # degrades) everything in flight, persists CT + compiled +
        # state.json under the deadline
        self.drain(deadline_s=deadline_s)
        self._stop_journal()
        self._stop_fleet_sampler()
        self.controllers.remove_all()
        self.health.stop()
        self.fqdn.stop()
        self.endpoint_manager.shutdown()
