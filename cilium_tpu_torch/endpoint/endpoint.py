"""Endpoint: a workload whose policy is enforced.

Reference: pkg/endpoint/endpoint.go (struct :288, state machine
:264-270,442-450), policy.go (regeneration pipeline :506-812), and the
desired/realized policymap sync (endpoint.go:2572).

Regeneration here = recompute the endpoint's desired policymap entries
through the device engine (ops/materialize for this endpoint's
identity), then diff desired vs realized into the endpoint's PolicyMap
— the syncPolicyMap semantics — while the datapath pipeline swaps its
device tables wholesale. The per-phase wall time lands in
RegenerationStats (spanstat, pkg/endpoint/metrics.go).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import metrics
from ..identity.model import Identity
from ..labels import LabelArray, parse_label_array
from ..maps.policymap import PolicyMap
from ..ops.materialize import PolicyKey
from ..option import OptionMap
from ..utils.spanstat import SpanStat


class EndpointState(str, enum.Enum):
    # endpoint.go state strings (:264-270)
    CREATING = "creating"
    WAITING_FOR_IDENTITY = "waiting-for-identity"
    READY = "ready"
    WAITING_TO_REGENERATE = "waiting-to-regenerate"
    REGENERATING = "regenerating"
    RESTORING = "restoring"
    DISCONNECTING = "disconnecting"
    DISCONNECTED = "disconnected"
    INVALID = "invalid"


# Legal transitions (endpoint.go SetStateLocked:442).
_TRANSITIONS = {
    EndpointState.CREATING: {EndpointState.WAITING_FOR_IDENTITY, EndpointState.READY, EndpointState.DISCONNECTING, EndpointState.INVALID},
    EndpointState.WAITING_FOR_IDENTITY: {EndpointState.READY, EndpointState.DISCONNECTING},
    EndpointState.READY: {EndpointState.WAITING_TO_REGENERATE, EndpointState.DISCONNECTING},
    EndpointState.WAITING_TO_REGENERATE: {EndpointState.REGENERATING, EndpointState.DISCONNECTING},
    EndpointState.REGENERATING: {EndpointState.READY, EndpointState.WAITING_TO_REGENERATE, EndpointState.DISCONNECTING},
    EndpointState.RESTORING: {EndpointState.WAITING_TO_REGENERATE, EndpointState.DISCONNECTING},
    EndpointState.DISCONNECTING: {EndpointState.DISCONNECTED},
    EndpointState.DISCONNECTED: set(),
    EndpointState.INVALID: set(),
}


@dataclasses.dataclass
class RegenerationStats:
    total: SpanStat = dataclasses.field(default_factory=SpanStat)
    policy_calculation: SpanStat = dataclasses.field(default_factory=SpanStat)
    map_sync: SpanStat = dataclasses.field(default_factory=SpanStat)
    success: bool = False


class Endpoint:
    def __init__(
        self,
        endpoint_id: int,
        labels: LabelArray,
        *,
        ipv4: Optional[str] = None,
        ipv6: Optional[str] = None,
        container_id: str = "",
        pod_name: str = "",
        parent_options: Optional[OptionMap] = None,
    ) -> None:
        self.id = endpoint_id
        self.labels = labels
        self.ipv4 = ipv4
        self.ipv6 = ipv6
        self.container_id = container_id
        self.pod_name = pod_name
        self.identity: Optional[Identity] = None
        self.options = OptionMap(parent=parent_options)
        self.state = EndpointState.CREATING
        self.policy_revision = 0  # realized revision
        self.policy_map = PolicyMap(name=f"cilium_policy_{endpoint_id}")
        self.desired: Dict[PolicyKey, int] = {}
        self.stats = RegenerationStats()
        self._lock = threading.RLock()
        # One builder per endpoint at a time (the reference serializes
        # via the build queue, pkg/endpoint/policy.go:812).
        self._build_lock = threading.Lock()
        self._state_log: List[Tuple[float, EndpointState]] = [(time.time(), self.state)]
        # bounded status log: state moves + regeneration outcomes (the
        # per-endpoint status log `cilium endpoint log` prints;
        # pkg/endpoint StatusLog / endpoint_log.go)
        self.status_log: collections.deque = collections.deque(maxlen=64)
        self._log_status("state", self.state.value)

    def _log_status(self, code: str, message: str) -> None:
        with self._lock:
            self.status_log.append((time.time(), code, message))

    def status_log_snapshot(self):
        """Copy under the lock: builder threads append concurrently and
        a bare iteration would raise 'deque mutated during iteration'."""
        with self._lock:
            return list(self.status_log)

    # -- state machine --------------------------------------------------
    def set_state(self, new: EndpointState) -> bool:
        with self._lock:
            if new == self.state:
                return True
            if new not in _TRANSITIONS.get(self.state, set()):
                return False
            self.state = new
            self._state_log.append((time.time(), new))
            self._log_status("state", new.value)
            return True

    def set_identity(self, identity: Identity) -> None:
        with self._lock:
            self.identity = identity
            if self.state in (EndpointState.CREATING, EndpointState.WAITING_FOR_IDENTITY):
                self.state = EndpointState.READY

    # -- desired/realized sync -----------------------------------------
    def sync_policy_map(self, desired: Dict[PolicyKey, int]) -> Tuple[int, int]:
        """Diff desired vs realized and apply (endpoint.go:2572):
        returns (added, deleted)."""
        with self._lock:
            realized = {k: e.proxy_port for k, e in self.policy_map.dump()}
            added = deleted = 0
            for key, proxy in desired.items():
                if realized.get(key) != proxy:
                    self.policy_map.allow(key, proxy)
                    added += 1
            for key in realized:
                if key not in desired:
                    self.policy_map.delete(key)
                    deleted += 1
            self.desired = dict(desired)
            return added, deleted

    def regenerate(self, pipeline, reason: str = "", proxy=None) -> bool:
        """One regeneration pass against the shared datapath pipeline
        (the regenerateBPF orchestration, pkg/endpoint/bpf.go:362).
        Serialized per endpoint via the build lock. When ``proxy`` is
        given, L7 redirects are created/updated/removed to match the
        resolved L4 policy (addNewRedirects / removeOldRedirects,
        pkg/endpoint/bpf.go:488-497)."""
        with self._build_lock:
            if not self.set_state(EndpointState.WAITING_TO_REGENERATE):
                if self.state != EndpointState.WAITING_TO_REGENERATE:
                    return False
            self.set_state(EndpointState.REGENERATING)
            stats = self.stats = RegenerationStats()
            ok = False
            try:
                with stats.total:
                    with stats.policy_calculation:
                        pipeline.rebuild()
                        snaps = pipeline.snapshots()
                        idx = pipeline.endpoint_index(self.id)
                        desired = snaps[idx].entries if idx is not None else {}
                    if proxy is not None:
                        self._update_redirects(pipeline, proxy)
                    with stats.map_sync:
                        self.sync_policy_map(desired)
                    # Stamp the revision the engine actually compiled, not
                    # a re-read of repo.revision: a rule batch landing
                    # after the rebuild must not be reported as realized.
                    compiled = pipeline.engine._compiled
                    self.policy_revision = (
                        compiled.revision if compiled is not None else 0
                    )
                ok = True
            finally:
                stats.success = ok
                self._log_status(
                    "regen-ok" if ok else "regen-fail",
                    (reason or "regeneration")
                    + f" ({stats.total.total() * 1000:.1f}ms, "
                      f"rev {self.policy_revision})",
                )
                self.set_state(EndpointState.READY)
                metrics.endpoint_regeneration_count.inc(
                    labels={"outcome": "success" if ok else "failure"}
                )
                metrics.endpoint_regeneration_time.observe(stats.total.total())
            return ok

    def _update_redirects(self, pipeline, proxy) -> None:
        """Create/update redirects for every L7-bearing filter in the
        resolved L4 policy; remove stale ones. Identity scoping per rule
        comes from matching filter endpoint selectors over the registry
        (the NPDS policy translation, pkg/envoy/server.go:267-331).
        The policies are built on the pipeline's device: a CPU pipeline
        gets CPU policies, a card pipeline policies whose walks run on
        the card."""
        from ..l7.http_policy import HTTPPolicy
        from ..l7.kafka_policy import KafkaACL
        from ..policy.api import HTTPRule, KafkaRule

        engine = pipeline.engine
        device = pipeline.device
        l4 = engine.repo.resolve_l4_policy(self.labels)
        identities = list(engine.registry)
        wanted = set()
        for direction_map, ingress in ((l4.ingress, True), (l4.egress, False)):
            for f in direction_map:
                if not f.is_redirect:
                    continue
                http_rules, kafka_rules = [], []
                for sel, rules in f.l7_rules_per_ep.items():
                    if sel.is_wildcard:
                        idents = None
                    else:
                        idents = {i.id for i in identities if sel.matches(i.labels)}
                    for hr in rules.http:
                        http_rules.append((hr, idents))
                    for kr in rules.kafka:
                        kafka_rules.append((kr, idents))
                    if not rules.http and not rules.kafka:
                        # Wildcarded L7: this peer flows through the
                        # proxy unrestricted (wildcardL3L4Rules).
                        if f.l7_parser == "http":
                            http_rules.append((HTTPRule(), idents))
                        elif f.l7_parser == "kafka":
                            kafka_rules.append((KafkaRule(), idents))
                proxy.create_or_update_redirect(
                    self.id,
                    f.port,
                    f.l7_parser,
                    ingress=ingress,
                    http_policy=(
                        HTTPPolicy(http_rules, device=device)
                        if f.l7_parser == "http" else None
                    ),
                    kafka_acl=(
                        KafkaACL(kafka_rules, device=device)
                        if f.l7_parser == "kafka" else None
                    ),
                )
                wanted.add((f.port, ingress))
        for key, r in proxy.redirects().items():
            if r.endpoint_id == self.id and (r.dst_port, r.ingress) not in wanted:
                proxy.remove_redirect(r.endpoint_id, r.dst_port, r.ingress)

    # -- snapshot/restore (pkg/endpoint/restore.go) ---------------------
    def to_snapshot(self) -> str:
        return json.dumps(
            {
                "id": self.id,
                "labels": list(self.labels.to_strings()),
                "ipv4": self.ipv4,
                "ipv6": self.ipv6,
                "container_id": self.container_id,
                "pod_name": self.pod_name,
                "policy_revision": self.policy_revision,
                "state": self.state.value,
            }
        )

    @classmethod
    def from_snapshot(cls, blob: str, parent_options: Optional[OptionMap] = None) -> "Endpoint":
        d = json.loads(blob)
        ep = cls(
            d["id"],
            parse_label_array(d["labels"]),
            ipv4=d.get("ipv4"),
            ipv6=d.get("ipv6"),
            container_id=d.get("container_id", ""),
            pod_name=d.get("pod_name", ""),
            parent_options=parent_options,
        )
        ep.state = EndpointState.RESTORING
        ep.policy_revision = d.get("policy_revision", 0)
        return ep

    def status(self) -> Dict:
        return {
            "id": self.id,
            "state": self.state.value,
            "identity": self.identity.id if self.identity else None,
            "labels": list(self.labels.to_strings()),
            "ipv4": self.ipv4,
            "policy-revision": self.policy_revision,
            "policy-map-entries": len(self.policy_map),
        }
