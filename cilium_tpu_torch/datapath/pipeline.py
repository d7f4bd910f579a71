"""Batched IPv4 flow pipeline: prefilter → identity → policymap verdict.

Mirrors the per-packet path of the reference, hoisted to batches:

    bpf_xdp.c check_filters (:158)    → deny-trie LPM on peer address
    bpf_netdev.c secctx from ipcache  → identity-trie LPM (world if miss)
    bpf_lxc.c tail_ipv4_policy (:931) → ingress policymap lookup
    bpf_lxc.c policy_can_egress4(:505)→ egress policymap lookup

plus per-endpoint forwarded/dropped counters (the metricsmap role,
pkg/maps/metricsmap). Both traffic directions are materialized.

One batch runs :func:`process_flows_wide`: one or two ``lpm_wide``
kernel launches (the fused deny+identity walk, or the identity walk
plus the deny walk when the prefilter is live and the tries cannot
merge) and one ``policymap_verdict`` launch that also applies the
prefilter override and accumulates the counters.

This port covers the synchronous IPv4 path only; conntrack, load
balancing, IPv6, overlay identities, async submission, shedding,
failsafe, tracing and multi-device placement are not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..convert import wide_tables_from_numpy
from ..engine import PolicyEngine
from ..identity.model import ID_WORLD
from ..ipcache.ipcache import IPCache
from ..ipcache.prefilter import PreFilter
from ..ops.lookup import PolicymapTables, policymap_verdict
from ..ops.lpm import DENY_BIT, MERGED_VALUE_MASK, build_wide_trie, lpm_lookup_wide, merge_flat_tries
from ..ops.materialize import TRAFFIC_EGRESS, TRAFFIC_INGRESS, materialize_endpoints_state

FORWARD = 1
DROP_POLICY = 2
DROP_PREFILTER = 3


@dataclasses.dataclass(frozen=True)
class WideDatapathTables:
    """IPv4 device state over the dense-16-bit-first-stride tries
    (ops/lpm.py). ``merged_*`` carry the fused deny+identity flat trie
    when both sides use the flat layout (ops/lpm.py merge_flat_tries):
    one walk yields the identity row and the prefilter verdict. A
    [1, 1] merged_sub_info marks "no merged table"."""

    pf_root_info: torch.Tensor  # [65536] int32
    pf_root_child: torch.Tensor
    pf_sub_child: torch.Tensor  # [M, 256] or [1, 65536] int32
    pf_sub_info: torch.Tensor
    ip_root_info: torch.Tensor
    ip_root_child: torch.Tensor
    ip_sub_child: torch.Tensor
    ip_sub_info: torch.Tensor
    merged_root_info: torch.Tensor  # [65536] int32 (packed) or [1]
    merged_root_child: torch.Tensor
    merged_sub_child: torch.Tensor
    merged_sub_info: torch.Tensor  # [M, 65536] or [1, 1]
    world_row: int
    policymap: PolicymapTables


def _v4_lpm_stage(
    t: WideDatapathTables, peer_u32: torch.Tensor, prefilter: bool
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """→ (denied_pf [B] bool or None when the deny stage is off,
    identity hit [B] int32 value+1).

    With the fused deny+identity flat trie present and the prefilter
    stage active, one walk answers both questions; otherwise the two
    classic walks run (the deny walk only when the stage is active)."""
    fused = t.merged_sub_info.shape[-1] == 65536
    if prefilter and fused:
        packed = lpm_lookup_wide(
            t.merged_root_info, t.merged_root_child, t.merged_sub_child,
            t.merged_sub_info, peer_u32,
        )
        # v4 packs value+1 below DENY_BIT: no -1 before the mask
        return (packed & int(DENY_BIT)) != 0, packed & int(MERGED_VALUE_MASK)
    denied_pf = None
    if prefilter:
        denied_pf = lpm_lookup_wide(
            t.pf_root_info, t.pf_root_child, t.pf_sub_child, t.pf_sub_info,
            peer_u32,
        ) > 0
    hit = lpm_lookup_wide(
        t.ip_root_info, t.ip_root_child, t.ip_sub_child, t.ip_sub_info, peer_u32,
    )
    return denied_pf, hit


def _verdict_tail(
    policymap: PolicymapTables,
    denied_pf: Optional[torch.Tensor],
    peer_row: torch.Tensor,
    ep_idx: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    ep_count: int,
    block: int,
):
    """Post-LPM tail: policymap lookup, prefilter override, counters
    [EP, 3] = (forwarded, dropped_policy, dropped_prefilter)."""
    return policymap_verdict(
        policymap, peer_row, ep_idx, dport, proto, denied_pf=denied_pf,
        ep_count=ep_count, block=block,
    )


def process_flows_wide(
    t: WideDatapathTables,
    peer_u32: torch.Tensor,  # [B] int32 bit view of host-order peer addresses
    ep_idx: torch.Tensor,  # [B] int32
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    ep_count: int = 1,
    block: int = 16384,
    prefilter: bool = True,
    row_override: Optional[torch.Tensor] = None,  # [B] int32, -1 = LPM
):
    """→ (verdict [B] int8, redirect [B] bool, counters [EP, 3] int32).

    ``peer_u32`` is the remote address of each flow: the source for
    ingress, the destination for egress. ``prefilter`` guards the XDP
    deny-trie stage. ``row_override`` carries an identity row trusted
    over the ipcache walk (the overlay path): flows with a non-negative
    row skip both the identity LPM and the prefilter."""
    denied_pf, hit = _v4_lpm_stage(t, peer_u32, prefilter)
    peer_row = torch.where(hit > 0, hit - 1, t.world_row).to(torch.int32)
    if row_override is not None:
        trusted = row_override >= 0
        peer_row = torch.where(trusted, row_override, peer_row).to(torch.int32)
        if denied_pf is not None:
            denied_pf = denied_pf & ~trusted
    return _verdict_tail(
        t.policymap, denied_pf, peer_row, ep_idx, dport, proto, ep_count, block
    )


_NO_TRIE = (
    np.zeros(1, np.int32),
    np.zeros(1, np.int32),
    np.zeros((1, 1), np.int32),
    np.zeros((1, 1), np.int32),
)


class DatapathPipeline:
    """Host orchestrator: owns the device snapshot of prefilter +
    ipcache + materialized policymaps for a set of local endpoints, and
    re-materializes when any input version moves."""

    def __init__(
        self,
        engine: PolicyEngine,
        ipcache: IPCache,
        prefilter: Optional[PreFilter] = None,
        device=None,
    ) -> None:
        self.device = _kernels.resolve_device(device)
        if self.device != engine.device:
            raise ValueError(f"pipeline on {self.device}, engine on {engine.device}")
        self.engine = engine
        self.ipcache = ipcache
        self.prefilter = prefilter or PreFilter()
        self._lock = threading.Lock()
        self._endpoints: list = []  # identity id per endpoint index
        self._basis = None
        self._tables: Dict[int, WideDatapathTables] = {}
        self._pf_empty = True
        self.counters = np.zeros((0, 3), np.int64)

    def set_endpoints(self, endpoints: Sequence) -> None:
        """Accepts identity ids (endpoint id == identity id) or
        (endpoint_id, identity_id) pairs; order defines the datapath
        endpoint index."""
        with self._lock:
            self._endpoints = [int(e[1]) if isinstance(e, tuple) else int(e) for e in endpoints]

    def rebuild(self, force: bool = False) -> Dict[int, WideDatapathTables]:
        """Bring the device state up to date: both directions' policymap
        sweeps and the v4 tries, rebuilt in full when the policy, the
        identities, the ipcache, the prefilter or the endpoint set moved.
        Returns {direction: WideDatapathTables}."""
        with self._lock:
            # versions captured before the sources are read: a mutation
            # landing mid-build triggers one more rebuild
            trie_versions = (self.ipcache.version, self.prefilter.revision)
            compiled, device = self.engine.snapshot()
            basis = (self.engine.install_gen, trie_versions, tuple(self._endpoints))
            if not force and basis == self._basis:
                return self._tables
            mat = {
                TRAFFIC_INGRESS: materialize_endpoints_state(
                    compiled, device, self._endpoints, ingress=True
                ),
                TRAFFIC_EGRESS: materialize_endpoints_state(
                    compiled, device, self._endpoints, ingress=False
                ),
            }
            _, pf_cidrs = self.prefilter.dump()
            pf4 = [c for c in pf_cidrs if ":" not in c]
            pf_empty = not pf4
            pf_wide = build_wide_trie((c, 0) for c in pf4)
            ip4_list = [
                (cidr, row)
                for cidr, e in self.ipcache.items()
                if ":" not in cidr
                and (row := compiled.id_to_row.get(e.identity)) is not None
            ]
            ip_wide = build_wide_trie(ip4_list)
            # fused deny+identity walk: built only while the deny stage
            # is live and both layouts are flat; it then covers the deny
            # stage, so the standalone deny trie is not uploaded
            merged = merge_flat_tries(ip_wide, pf_wide) if not pf_empty else None
            if merged is None:
                merged = _NO_TRIE
            else:
                pf_wide = _NO_TRIE
            world_row = compiled.id_to_row.get(ID_WORLD)
            if world_row is None:
                raise RuntimeError("reserved:world identity has no device row")
            # one upload of the tries, shared by both directions
            ingress_t = wide_tables_from_numpy(
                (*pf_wide, *ip_wide, *merged), world_row,
                mat[TRAFFIC_INGRESS].tables, device=self.device,
            )
            self._tables = {
                TRAFFIC_INGRESS: ingress_t,
                TRAFFIC_EGRESS: dataclasses.replace(
                    ingress_t, policymap=mat[TRAFFIC_EGRESS].tables
                ),
            }
            self._pf_empty = pf_empty
            self._basis = basis
            if self.counters.shape[0] != len(self._endpoints):
                self.counters = np.zeros((len(self._endpoints), 3), np.int64)
            return self._tables

    def process(
        self,
        src_ips: np.ndarray,  # [B] uint32 IPv4 host-order (peer address)
        ep_idx: np.ndarray,  # [B] int32 local endpoint index
        dports: np.ndarray,
        protos: np.ndarray,
        *,
        ingress: bool = True,
        sports: Optional[np.ndarray] = None,
        return_rev_nat: bool = False,
        tunnel_identities: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """IPv4 batch → (verdicts [B] int8, redirect [B] bool);
        accumulates the per-endpoint counters. ``src_ips`` is the peer
        address (source for ingress, destination for egress)."""
        if sports is not None or return_rev_nat:
            raise NotImplementedError("conntrack and revNAT are not in the torch port yet")
        if tunnel_identities is not None:
            raise NotImplementedError("overlay tunnel identities are not in the torch port yet")
        tables = self.rebuild()
        t = tables[TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS]

        def up(a, dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype, copy=False))).to(self.device)

        peer = up(np.asarray(src_ips).astype(np.uint32).view(np.int32), np.int32)
        # the XDP prefilter guards traffic entering the node only, and
        # an empty deny set skips the walk
        verdict, redirect, counters = process_flows_wide(
            t, peer, up(ep_idx, np.int32), up(dports, np.int32), up(protos, np.int32),
            ep_count=max(1, len(self._endpoints)),
            prefilter=ingress and not self._pf_empty,
        )
        counters = counters.cpu().numpy()
        with self._lock:
            if self.counters.shape == counters.shape:
                self.counters += counters
        return verdict.cpu().numpy(), redirect.cpu().numpy()
