"""Host service manager: frontends, weighted backends, revNAT records.

Reference: pkg/loadbalancer (L3n4Addr/LBSVC types), pkg/maps/lbmap
(service + backend + RR-sequence programming, lbmap.go:274,351), and
pkg/service (kvstore-backed global service ID allocation,
service.go). The manager owns the authoritative service table and
emits immutable device snapshots (lb/device.py LBTables) for the
pipeline's egress pre-policy stage — the lb4_lookup_service /
lb4_local position of bpf/bpf_lxc.c:444-455.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import u8proto
from .device import LBTables, MAX_SEQ

SERVICES_ID_PATH = "cilium/state/services/v1/id"
SERVICES_VALUE_PATH = "cilium/state/services/v1/value"
SERVICES_EXPORT_PATH = "cilium/state/services/v1/exports"


@dataclasses.dataclass(frozen=True, order=True)
class L3n4Addr:
    """Frontend / backend address (pkg/loadbalancer L3n4Addr)."""

    ip: str
    port: int
    protocol: str = "TCP"  # TCP | UDP | ANY

    def __post_init__(self) -> None:
        # normalize ONCE at construction: frontends round-trip through
        # string keys (clustermesh export paths, CLI args) and a
        # case-mismatched protocol would make delete miss its upsert
        object.__setattr__(self, "protocol", self.protocol.upper())

    @property
    def family(self) -> int:
        return 6 if ipaddress.ip_address(self.ip).version == 6 else 4

    @property
    def proto_num(self) -> int:
        return 0 if self.protocol.upper() in ("ANY", "NONE") else u8proto.from_name(
            self.protocol
        )

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}/{self.protocol}"

    @classmethod
    def from_string(cls, text: str) -> "L3n4Addr":
        """Inverse of __str__ ('ip:port[/proto]', brackets around v6
        literals tolerated) — the ONE place the frontend wire format
        is parsed (CLI args, clustermesh export keys)."""
        proto = "TCP"
        if "/" in text:
            text, proto = text.rsplit("/", 1)
        ip, _, port = text.rpartition(":")
        return cls(ip.strip("[]"), int(port), proto.upper())


@dataclasses.dataclass(frozen=True)
class Backend:
    """One backend with an RR weight (lbmap.go LBBackEnd)."""

    ip: str
    port: int
    weight: int = 1


@dataclasses.dataclass
class LBService:
    """A programmed service (pkg/loadbalancer LBSVC)."""

    id: int  # global service / revNAT id
    frontend: L3n4Addr
    backends: Tuple[Backend, ...]


def _addr_bytes(ip: str, length: int) -> List[int]:
    return list(ipaddress.ip_address(ip).packed.rjust(length, b"\x00"))[-length:]


def build_selection_seq(backends: Sequence[Backend]) -> List[int]:
    """Backend indices repeated by weight — the weighted-RR sequence of
    lbmap.go:351 (generateWrrSeq). Capped at MAX_SEQ slots: when
    weights overflow the cap they are rescaled with every backend
    guaranteed ≥ 1 slot; when the backend COUNT itself exceeds MAX_SEQ
    only the first MAX_SEQ backends receive slots (deterministic
    truncation — the reference's slave-slot maps have the same kind of
    hard capacity, bpf/lib/lb.h LB_MAX)."""
    if not backends:
        return []
    # weight 0 means "no traffic" in BOTH paths; all-zero degrades to
    # equal shares (the reference treats weightless services as plain
    # round-robin)
    live = [(i, max(0, b.weight)) for i, b in enumerate(backends)]
    if all(w == 0 for _, w in live):
        live = [(i, 1) for i, _ in live]
    else:
        live = [(i, w) for i, w in live if w > 0]
    live = live[:MAX_SEQ]
    idxs = [i for i, _ in live]
    weights = [w for _, w in live]
    total = sum(weights)
    if total <= MAX_SEQ:
        reps = weights
    else:
        # every positive-weight backend gets 1 slot; remaining slots
        # go by largest weight remainder so shares stay proportional
        n = len(live)
        spare = MAX_SEQ - n
        shares = [w * spare / total for w in weights]
        reps = [1 + int(s) for s in shares]
        spare -= sum(int(s) for s in shares)
        order = sorted(range(n), key=lambda i: shares[i] - int(shares[i]),
                       reverse=True)
        for i in order[:spare]:
            reps[i] += 1
    seq: List[int] = []
    # interleave round-robin style so short prefixes are still mixed
    counts = list(reps)
    while any(c > 0 for c in counts):
        for k, c in enumerate(counts):
            if c > 0:
                seq.append(idxs[k])
                counts[k] -= 1
    return seq[:MAX_SEQ]


class ServiceManager:
    """Thread-safe service table with device snapshot builds.

    Service IDs double as revNAT ids (the reference allocates one
    ID per frontend, pkg/service/service.go). With a kvstore backend
    the allocation is a cluster-global CAS (create_only on the
    frontend's value key); standalone it is a local counter.
    """

    def __init__(self, kvstore=None, host_ip: str = "") -> None:
        self._lock = threading.RLock()
        self._services: Dict[L3n4Addr, LBService] = {}
        self._next_id = 1
        self._kv = kvstore
        self.version = 0
        # node host address — the Ingress frontend IP (the reference
        # uses Config.HostV4Addr, k8s_watcher.go:1209)
        self.host_ip = host_ip
        self._synced_frontends: set = set()  # frontends owned by k8s sync
        # (frontend, remote_cluster) → backends merged in via
        # clustermesh (the global-service merge; remote_cluster.go)
        self._remote: Dict[Tuple[L3n4Addr, str], Tuple[Backend, ...]] = {}

    # -- id allocation --------------------------------------------------
    def _allocate_id(self, frontend: L3n4Addr) -> int:
        if self._kv is None:
            sid = self._next_id
            self._next_id += 1
            return sid
        key = f"{SERVICES_VALUE_PATH}/{frontend}"
        existing = self._kv.get(key)
        if existing is not None:
            return int(existing.decode())
        while True:
            candidate = self._next_id
            self._next_id += 1
            if self._kv.create_only(
                f"{SERVICES_ID_PATH}/{candidate}", str(frontend).encode()
            ):
                self._kv.set(key, str(candidate).encode())
                return candidate

    # -- mutation -------------------------------------------------------
    @staticmethod
    def _validate(frontend: L3n4Addr, backends: Sequence[Backend]) -> None:
        """Reject malformed addresses BEFORE mutating the table: a bad
        entry would otherwise poison every later build_device() (and,
        via the daemon's state snapshot, survive restarts)."""
        ipaddress.ip_address(frontend.ip)  # raises ValueError if bad
        frontend.proto_num  # raises on unknown protocol names
        if not 0 < frontend.port < 65536:
            raise ValueError(f"frontend port out of range: {frontend.port}")
        for b in backends:
            ipaddress.ip_address(b.ip)
            if not 0 < b.port < 65536:
                raise ValueError(f"backend port out of range: {b.port}")

    def upsert(
        self, frontend: L3n4Addr, backends: Sequence[Backend]
    ) -> LBService:
        self._validate(frontend, backends)
        with self._lock:
            existing = self._services.get(frontend)
            sid = existing.id if existing else self._allocate_id(frontend)
            svc = LBService(id=sid, frontend=frontend, backends=tuple(backends))
            self._services[frontend] = svc
            self.version += 1
            return svc

    def restore(
        self, frontend: L3n4Addr, backends: Sequence[Backend], sid: int
    ) -> LBService:
        """Re-install a service keeping its persisted id (daemon
        restart must not renumber services: revNAT ids are API-visible
        and recorded in snapshots)."""
        self._validate(frontend, backends)
        with self._lock:
            svc = LBService(id=sid, frontend=frontend, backends=tuple(backends))
            self._services[frontend] = svc
            self._next_id = max(self._next_id, sid + 1)
            self.version += 1
            return svc

    def delete(self, frontend: L3n4Addr) -> bool:
        with self._lock:
            if self._services.pop(frontend, None) is None:
                return False
            self.version += 1
            return True

    # -- queries --------------------------------------------------------
    def get(self, frontend: L3n4Addr) -> Optional[LBService]:
        with self._lock:
            return self._services.get(frontend)

    def list(self) -> List[LBService]:
        with self._lock:
            return sorted(self._services.values(), key=lambda s: s.id)

    # -- clustermesh merge (global services) ----------------------------
    def set_remote_backends(
        self, frontend: L3n4Addr, cluster: str, backends: Sequence[Backend]
    ) -> None:
        """Merge (or clear, with an empty list) one remote cluster's
        backends for a frontend. Only frontends that exist LOCALLY are
        served — the local cluster decides which services are global
        (remote_cluster.go mergeExternalServiceUpdate)."""
        with self._lock:
            key = (frontend, cluster)
            if backends:
                self._validate(frontend, backends)
                self._remote[key] = tuple(backends)
            elif key not in self._remote:
                return
            else:
                del self._remote[key]
            self.version += 1

    def effective_backends(self, frontend: L3n4Addr) -> List[Backend]:
        """Own backends + every remote cluster's merged backends."""
        with self._lock:
            svc = self._services.get(frontend)
            out = list(svc.backends) if svc else []
            for (fe, _cluster), backs in sorted(
                self._remote.items(), key=lambda kv: kv[0][1]
            ):
                if fe == frontend:
                    out.extend(backs)
            return out

    def rev_nat(self, revnat_id: int) -> Optional[L3n4Addr]:
        """revNAT id → original frontend (the cilium_lb4_reverse_nat
        role): rewrites reply source back to the VIP."""
        with self._lock:
            for svc in self._services.values():
                if svc.id == revnat_id:
                    return svc.frontend
        return None

    # -- k8s bridge -----------------------------------------------------
    def sync_from_registry(self, registry) -> int:
        """Full resync from a k8s ServiceRegistry: every ClusterIP
        service port becomes a frontend; backends come from the
        Endpoints object's matching port name (daemon/k8s_watcher.go
        addK8sSVCs). Ingress objects add a frontend on the node's host
        address pointing at the named service's backends
        (k8s_watcher.go:1181 addIngressV1beta1 — requires ``host_ip``
        to be set). Frontends previously created by sync but gone from
        the registry are deleted. Returns the live frontend count."""
        desired: Dict[L3n4Addr, List[Backend]] = {}
        with registry._lock:
            services = dict(registry.services)
            endpoints = dict(registry.endpoints)
            ingresses = dict(getattr(registry, "ingresses", {}))
        for sid, info in services.items():
            if not info.cluster_ip or info.is_headless:
                continue
            ep = endpoints.get(sid)
            for pname, sp in info.ports.items():
                fe = L3n4Addr(info.cluster_ip, sp.port, sp.protocol)
                backs: List[Backend] = []
                if ep is not None:
                    tgt = ep.ports.get(pname) or ep.ports.get(str(sp.port))
                    if tgt is not None:
                        backs = [Backend(ip, tgt.port) for ip in ep.backend_ips]
                desired[fe] = backs
        if self.host_ip:
            for iid, ing in ingresses.items():
                svc_id = type(iid)(iid.namespace, ing.service_name)
                ep = endpoints.get(svc_id)
                backs = []
                fe_port = ing.service_port
                if ep is not None:
                    tgt = (
                        ep.ports.get(ing.port_name)
                        or ep.ports.get(str(ing.service_port))
                    )
                    if tgt is None and len(ep.ports) == 1:
                        tgt = next(iter(ep.ports.values()))
                    if tgt is not None:
                        backs = [Backend(ip, tgt.port) for ip in ep.backend_ips]
                        if not fe_port:  # named servicePort: number from
                            fe_port = tgt.port  # the endpoints mapping
                if fe_port:
                    desired[L3n4Addr(self.host_ip, fe_port, "TCP")] = backs
        with self._lock:
            for fe in self._synced_frontends - set(desired):
                self.delete(fe)
            synced = set()
            for fe, backs in desired.items():
                try:
                    cur = self._services.get(fe)
                    if cur is None or cur.backends != tuple(backs):
                        self.upsert(fe, backs)
                    synced.add(fe)
                except ValueError:
                    # malformed registry data (bad IP/port) — skip the
                    # one service rather than abort the sync
                    continue
            self._synced_frontends = synced
        return len(synced)

    # -- clustermesh export ---------------------------------------------
    def export_to_store(self, backend, cluster: str) -> int:
        """Publish this cluster's services (frontend + OWN backends,
        never merged remote ones — re-export loops would amplify) for
        clustermesh consumers. Lease-bound: a dead agent's export
        disappears with its lease. Idempotent full sync; returns the
        exported service count."""
        import json as _json

        prefix = f"{SERVICES_EXPORT_PATH}/{cluster}/"
        with self._lock:
            services = list(self._services.values())
        desired = {}
        for svc in services:
            desired[prefix + str(svc.frontend)] = _json.dumps({
                "frontend": {
                    "ip": svc.frontend.ip,
                    "port": svc.frontend.port,
                    "protocol": svc.frontend.protocol,
                },
                "backends": [
                    {"ip": b.ip, "port": b.port, "weight": b.weight}
                    for b in svc.backends
                ],
            }, sort_keys=True).encode()
        existing = backend.list_prefix(prefix)
        for key in existing:
            if key not in desired:
                backend.delete(key)
        for key, value in desired.items():
            if existing.get(key) != value:
                backend.update(key, value, lease=True)
        return len(desired)

    # -- device snapshot ------------------------------------------------
    def build_device(self, device=None) -> Dict[int, Optional[LBTables]]:
        """→ {4: LBTables|None, 6: LBTables|None} (None = no frontends
        of that family; the pipeline skips the stage entirely), the
        tables on ``device`` (``None`` = the CUDA card)."""
        from .. import _kernels
        from ..convert import lb_tables_from_numpy

        device = _kernels.resolve_device(device)
        with self._lock:
            services = sorted(self._services.values(), key=lambda s: s.id)
        out: Dict[int, Optional[LBTables]] = {4: None, 6: None}
        for family, length in ((4, 4), (6, 16)):
            fam = [s for s in services if s.frontend.family == family]
            if not fam:
                continue
            nf = max(1, len(fam))
            fe_bytes = np.zeros((nf, length), np.int32)
            fe_port = np.full(nf, -1, np.int32)
            fe_proto = np.zeros(nf, np.int32)
            fe_seq = np.zeros((nf, MAX_SEQ), np.int32)
            fe_seq_len = np.zeros(nf, np.int32)
            fe_revnat = np.zeros(nf, np.int32)
            be_rows: List[Tuple[List[int], int]] = []
            for i, svc in enumerate(fam):
                fe_bytes[i] = _addr_bytes(svc.frontend.ip, length)
                fe_port[i] = svc.frontend.port
                fe_proto[i] = svc.frontend.proto_num
                fe_revnat[i] = svc.id
                base = len(be_rows)
                live = [
                    b for b in self.effective_backends(svc.frontend)
                    if ipaddress.ip_address(b.ip).version == (6 if family == 6 else 4)
                ]
                for b in live:
                    be_rows.append((_addr_bytes(b.ip, length), b.port))
                seq = build_selection_seq(live)
                fe_seq_len[i] = len(seq)
                for j, rel in enumerate(seq):
                    fe_seq[i, j] = base + rel
            nb = max(1, len(be_rows))
            be_bytes = np.zeros((nb, length), np.int32)
            be_port = np.zeros(nb, np.int32)
            for r, (byts, port) in enumerate(be_rows):
                be_bytes[r] = byts
                be_port[r] = port
            out[family] = lb_tables_from_numpy(
                fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, fe_revnat,
                be_bytes, be_port, device=device,
            )
        return out
