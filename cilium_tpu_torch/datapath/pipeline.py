"""Batched flow pipeline: prefilter → identity → policymap verdict.

Mirrors the per-packet path of the reference, hoisted to batches:

    bpf_xdp.c check_filters (:158)    → deny-trie LPM on peer address
    bpf_netdev.c secctx from ipcache  → identity-trie LPM (world if miss)
    bpf_lxc.c tail_ipv4_policy (:931) → ingress policymap lookup
    bpf_lxc.c policy_can_egress4(:505)→ egress policymap lookup
    bpf_lxc.c tail_ipv6_* (:848)      → the same over IPv6

plus per-endpoint forwarded/dropped counters (the metricsmap role,
pkg/maps/metricsmap). Both traffic directions are materialized.

An IPv4 batch runs :func:`process_flows_wide`: one or two ``lpm_wide``
kernel launches (the fused deny+identity walk, or the identity walk
plus the deny walk when the prefilter is live and the tries cannot
merge) and one ``policymap_verdict`` launch that also applies the
prefilter override and accumulates the counters. An IPv6 batch runs
:func:`process_flows`: the same over the elided stride-8 tries, one or
two ``lpm_stride8`` launches. With verdict attribution on
(:meth:`DatapathPipeline.set_attribution`) the policymap launch is the
kernel's attribution entry, which also returns each flow's deciding
rule, its L4 coverage and the rule-hit counts.

Ahead of those stages, :meth:`DatapathPipeline.process` /
``process_v6`` run, as the reference's ``_submit_inner`` does:

- the overlay row override (``tunnel_identities``: a known identity
  from the tunnel key is trusted over the LPM and skips the prefilter);
- the LB stage on egress batches of a family with frontends: one
  ``lb_translate`` launch (lb/device.py) rewrites VIP flows to their
  backend before CT and policy; a frontend with no backend drops
  with DROP_NO_SERVICE;
- with a :class:`FlowConntrack` and ``sports``, the host CT pre-pass:
  established and reply hits take FORWARD, only the misses go to the
  kernels (at their exact shape: there is no compile cache to pad
  for), and allowed non-redirect misses create entries carrying the
  flow's revNAT id.

With ``device_ct_bits`` the conntrack table lives on the device
(datapath/device_ct.py) and a batch with ``sports`` whose family has
no LB table, and no tunnel identities, runs :func:`process_flows_ct`:
the LPM walks, ``policymap_verdict`` without counters, then the two
``ct_step`` kernel entries, which probe, refresh and insert in place,
override the verdicts of established flows and count. Every other
batch takes the host CT pre-pass.

This port covers the synchronous path only; async submission,
shedding, failsafe, tracing, the flow ring and multi-device placement
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .. import metrics as _metrics
from ..convert import v6_tables_from_numpy, wide_tables_from_numpy
from .conntrack import CT_NEW, CT_REPLY, FlowConntrack, pack_keys
from .device_ct import DeviceCTState, _i32, _u32, ct_step_verdict, make_state, pack_kc_words
from ..engine import PolicyEngine
from ..identity.model import ID_WORLD
from ..ipcache.ipcache import IPCache
from ..ipcache.prefilter import PreFilter
from ..lb.device import flow_hash32, lb_translate
from ..ops.lookup import PolicymapTables, policymap_verdict
from ..ops.lpm import (
    DENY_BIT, MERGED_VALUE_MASK, build_trie_elided, build_wide_trie, elided_lookup,
    ipv4_to_bytes, lpm_lookup_wide, merge_flat_tries, merge_trie_entries,
)
from ..ops.materialize import TRAFFIC_EGRESS, TRAFFIC_INGRESS, materialize_endpoints_state

FORWARD = 1
DROP_POLICY = 2
DROP_PREFILTER = 3
DROP_NO_SERVICE = 4
DROP_DEGRADED = 5


@dataclasses.dataclass(frozen=True)
class DatapathTables:
    """IPv6 device state for one traffic direction over the elided
    stride-8 tries (ops/lpm.py build_trie_elided). Trie tensors are
    shared between the two directions' instances. ``*_common`` carry
    each trie's elided shared prefix bytes ([K] int32, [0] = no
    elision). ``merged_*`` carry the fused deny+identity trie (one
    walk, both answers — ops/lpm.py merge_trie_entries); its presence
    is the pipeline's ``fused`` flag, a [1, 256] placeholder
    otherwise."""

    pf_child: torch.Tensor  # [M, 256] int32
    pf_info: torch.Tensor
    pf_common: torch.Tensor  # [K] int32
    ip_child: torch.Tensor
    ip_info: torch.Tensor
    ip_common: torch.Tensor
    merged_child: torch.Tensor
    merged_info: torch.Tensor
    merged_common: torch.Tensor
    world_row: int
    policymap: PolicymapTables


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


# the reference's _elided_lpm (datapath/pipeline.py:171): the K-byte
# compare and the walk of the remaining levels are one lpm_stride8 launch
_elided_lpm = elided_lookup


def _v6_lpm_stage(
    t: DatapathTables, peer_bytes: torch.Tensor, levels: int, prefilter: bool, fused: bool
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """→ (denied_pf [B] bool or None when the deny stage is off,
    identity hit [B] int32 value+1) — the v6 twin of _v4_lpm_stage:
    with the fused trie present and the deny stage active, ONE elided
    stride-8 walk answers both questions; ``fused`` is a flag because
    the stride-8 shapes cannot tell presence the way the flat layout's
    65536 width can."""
    if prefilter and fused:
        raw = _elided_lpm(t.merged_child, t.merged_info, t.merged_common, peer_bytes, levels)
        # the fused trie stores packed+1: unpack with the -1 first
        # (v4's flat merge stores the packed value as is)
        packed = torch.where(raw > 0, raw - 1, 0)
        return (packed & int(DENY_BIT)) != 0, packed & int(MERGED_VALUE_MASK)
    denied_pf = None
    if prefilter:
        denied_pf = _elided_lpm(t.pf_child, t.pf_info, t.pf_common, peer_bytes, levels) > 0
    hit = _elided_lpm(t.ip_child, t.ip_info, t.ip_common, peer_bytes, levels)
    return denied_pf, hit


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
    attrib: bool = False,
    rule_tab: Optional[torch.Tensor] = None,
    n_rules: int = 0,
):
    """Post-LPM tail shared by both families: policymap lookup,
    prefilter override, counters [EP, 3] = (forwarded, dropped_policy,
    dropped_prefilter). ``attrib=True`` appends the attribution: the
    deciding rule gathered from ``rule_tab`` (-1 = none, and -1 for a
    prefilter drop, which never reached the policymap), whether an L4
    column covered the flow, and the [max(n_rules, 1)] rule-hit
    counts."""
    if attrib and rule_tab is None:
        raise ValueError("attribution needs the materializer's rule table")
    return policymap_verdict(
        policymap, peer_row, ep_idx, dport, proto, denied_pf=denied_pf,
        ep_count=ep_count, block=block, rule_tab=rule_tab if attrib else None,
        n_rules=n_rules,
    )


def _peer_rows(
    denied_pf: Optional[torch.Tensor], hit: torch.Tensor, world_row: int,
    row_override: Optional[torch.Tensor],
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Identity hit → peer row (world on a miss); ``row_override``
    rows (>= 0) are trusted over the walk and skip the prefilter."""
    peer_row = torch.where(hit > 0, hit - 1, world_row).to(torch.int32)
    if row_override is not None:
        trusted = row_override >= 0
        peer_row = torch.where(trusted, row_override, peer_row).to(torch.int32)
        if denied_pf is not None:
            denied_pf = denied_pf & ~trusted
    return denied_pf, peer_row


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
    attrib: bool = False,
    rule_tab: Optional[torch.Tensor] = None,  # [N, C_pad] int32
    n_rules: int = 0,
):
    """→ (verdict [B] int8, redirect [B] bool, counters [EP, 3] int32);
    with ``attrib=True`` also (rule [B] int32, l4_covered [B] bool,
    hits [max(n_rules, 1)] int32) — see _verdict_tail.

    ``peer_u32`` is the remote address of each flow: the source for
    ingress, the destination for egress. ``prefilter`` guards the XDP
    deny-trie stage. ``row_override`` carries an identity row trusted
    over the ipcache walk (the overlay path): flows with a non-negative
    row skip both the identity LPM and the prefilter."""
    denied_pf, hit = _v4_lpm_stage(t, peer_u32, prefilter)
    denied_pf, peer_row = _peer_rows(denied_pf, hit, t.world_row, row_override)
    return _verdict_tail(
        t.policymap, denied_pf, peer_row, ep_idx, dport, proto, ep_count, block,
        attrib=attrib, rule_tab=rule_tab, n_rules=n_rules,
    )


def process_flows(
    t: DatapathTables,
    peer_bytes: torch.Tensor,  # [B, levels] int32 address bytes
    ep_idx: torch.Tensor,  # [B] int32
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    ep_count: int = 1,
    block: int = 16384,
    levels: int = 4,
    prefilter: bool = True,
    fused: bool = False,
    row_override: Optional[torch.Tensor] = None,  # [B] int32, -1 = LPM
    attrib: bool = False,
    rule_tab: Optional[torch.Tensor] = None,  # [N, C_pad] int32
    n_rules: int = 0,
):
    """The stride-8 twin of :func:`process_flows_wide` (IPv6 with
    ``levels=16``): same outputs, same ``prefilter``, ``row_override``
    and attribution semantics; ``fused`` says the fused deny+identity
    trie is present."""
    denied_pf, hit = _v6_lpm_stage(t, peer_bytes, levels, prefilter, fused)
    denied_pf, peer_row = _peer_rows(denied_pf, hit, t.world_row, row_override)
    return _verdict_tail(
        t.policymap, denied_pf, peer_row, ep_idx, dport, proto, ep_count, block,
        attrib=attrib, rule_tab=rule_tab, n_rules=n_rules,
    )


def process_flows_ct(
    t,  # WideDatapathTables (family 4) | DatapathTables (family 6)
    ct: DeviceCTState,  # updated in place
    peer: torch.Tensor,  # family 4: [B] int32 bit view; family 6: [B, 16] int32
    ep_idx: torch.Tensor,  # [B] int32
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    sport: torch.Tensor,  # [B] int32
    direction,  # int or [] tensor: 0 ingress / 1 egress
    now,  # int seconds (monotonic)
    valid: torch.Tensor,  # [B] bool — False lanes never insert nor count
    ep_count: int = 1,
    block: int = 16384,
    prefilter: bool = True,
    levels: int = 4,
    family: int = 4,
    fused: bool = False,  # v6 merged-trie presence (v4 routes by shape)
):
    """The datapath step with device-resident conntrack: deny and
    identity LPM (``lpm_wide`` or ``lpm_stride8``), the policymap
    verdict with the prefilter override (``policymap_verdict``, no
    counters), then the CT step on the ``ct_step`` kernel: probe (fwd +
    reply), refresh, insert the policy-allowed non-redirect valid
    misses; established flows take FORWARD and lose their redirect,
    the bpf/lib/conntrack.h bypass; the counters count the final
    verdicts of the valid lanes. The state is updated in place.

    → (verdict [B] int8, redirect [B] bool, counters [EP, 3] int32)."""
    if family == 4:
        denied_pf, hit = _v4_lpm_stage(t, peer, prefilter)
        z = torch.zeros_like(peer, dtype=torch.int32)
        ka_w, kb_w = (z, z), (z, peer.to(torch.int32))
    else:
        denied_pf, hit = _v6_lpm_stage(t, peer, levels, prefilter, fused)
        # the four big-endian uint32 words of the 16 address bytes
        b = _u32(peer)

        def word(i):
            return _i32(((b[:, i] << 24) | (b[:, i + 1] << 16) | (b[:, i + 2] << 8)
                         | b[:, i + 3]) & 0xFFFFFFFF)

        ka_w, kb_w = (word(0), word(4)), (word(8), word(12))
    denied_pf, peer_row = _peer_rows(denied_pf, hit, t.world_row, None)
    dec, red, _ = policymap_verdict(
        t.policymap, peer_row, ep_idx, dport, proto, denied_pf=denied_pf, block=block
    )
    kc_w = pack_kc_words(ep_idx, sport, dport, proto, int(direction))
    verdict, redirect, counters, _est = ct_step_verdict(
        ct, ka_w, kb_w, kc_w, proto.to(torch.int32), now, dec, red, valid, ep_idx.to(torch.int32),
        ep_count,
    )
    return verdict, redirect, counters


_NO_TRIE = (
    np.zeros(1, np.int32),
    np.zeros(1, np.int32),
    np.zeros((1, 1), np.int32),
    np.zeros((1, 1), np.int32),
)

_NO_TRIE6 = (
    np.zeros((1, 256), np.int32),
    np.zeros((1, 256), np.int32),
    np.zeros(0, np.int32),
)


def _pack_v4_u32(peer_bytes: np.ndarray) -> np.ndarray:
    """[B, 4] address bytes → [B] uint32 host-order (the wide-trie
    query word). One definition for every dispatch path."""
    b = peer_bytes.astype(np.uint32)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def _peer_words(peer_bytes: np.ndarray, family: int) -> Tuple[np.ndarray, np.ndarray]:
    """[B, 4 | 16] address bytes → (hi, lo) uint64 conntrack key words
    (hi is 0 for IPv4)."""
    bytes64 = peer_bytes.astype(np.uint64)
    if family == 4:
        lo = (
            (bytes64[:, 0] << 24) | (bytes64[:, 1] << 16)
            | (bytes64[:, 2] << 8) | bytes64[:, 3]
        )
        return np.zeros(peer_bytes.shape[0], np.uint64), lo
    shift = np.arange(7, -1, -1, dtype=np.uint64) * np.uint64(8)
    hi = (bytes64[:, :8] << shift).sum(axis=1, dtype=np.uint64)
    lo = (bytes64[:, 8:] << shift).sum(axis=1, dtype=np.uint64)
    return hi, lo


@dataclasses.dataclass
class _Batch:
    """One batch's flows on the host while it moves through the stages.
    ``peer_bytes`` is [B, 4 | 16] int32; an IPv4 batch also carries its
    uint32 words (``peer_u32``, the wide-trie query) and builds the
    bytes only when a stage needs them."""

    family: int
    ep_idx: np.ndarray
    dports: np.ndarray
    protos: np.ndarray
    peer_bytes: Optional[np.ndarray] = None
    peer_u32: Optional[np.ndarray] = None
    # the caller's CT key words, kept until the LB stage rewrites the peer
    words: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def bytes_(self) -> np.ndarray:
        if self.peer_bytes is None:
            self.peer_bytes = ipv4_to_bytes(self.peer_u32)
        return self.peer_bytes

    def set_peer(self, peer_bytes: np.ndarray) -> None:
        self.peer_bytes = peer_bytes
        self.peer_u32 = _pack_v4_u32(peer_bytes) if self.family == 4 else None
        self.words = None  # address changed — repack for CT

    def ct_words(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.words is not None:
            return self.words
        return _peer_words(self.bytes_(), self.family)


class DatapathPipeline:
    """Host orchestrator: owns the device snapshot of prefilter +
    ipcache + materialized policymaps for a set of local endpoints, and
    re-materializes when any input version moves.

    With ``conntrack`` (a :class:`FlowConntrack`) a batch that carries
    ``sports`` runs the host CT pre-pass: established and reply hits
    take FORWARD without a device dispatch, and only misses reach the
    kernels. With ``lb`` (a ``ServiceManager``) every egress batch of a
    family with frontends goes through VIP→backend translation on the
    ``lb_translate`` kernel first, so CT and policy see the backend.

    With ``device_ct_bits`` the conntrack table (2**bits slots) lives
    on the device and is probed and filled inside the verdict step
    (:func:`process_flows_ct`) for every batch with ``sports`` whose
    family has no LB table and that carries no tunnel identities; those
    other batches fall back to a host ``FlowConntrack``, made here when
    none is given. The positional order is the reference's up to
    ``device_ct_bits``; ``device`` (None = the card) is keyword-only.
    ``monitor`` is not ported and must be None."""

    def __init__(
        self,
        engine: PolicyEngine,
        ipcache: IPCache,
        prefilter: Optional[PreFilter] = None,
        conntrack: Optional[FlowConntrack] = None,
        lb=None,  # Optional[lb.service.ServiceManager]
        monitor=None,
        device_ct_bits: Optional[int] = None,
        *,
        device=None,
    ) -> None:
        if monitor is not None:
            raise NotImplementedError("the monitor is not in the torch port yet")
        self.device = _kernels.resolve_device(device)
        if self.device != engine.device:
            raise ValueError(f"pipeline on {self.device}, engine on {engine.device}")
        self.engine = engine
        self.ipcache = ipcache
        self.prefilter = prefilter or PreFilter()
        self.conntrack = conntrack
        # device-resident conntrack: made on first use, dropped on every
        # CT flush; batches it cannot serve (an LB family, tunnel
        # identities) need the host CT domain, or they would lose CT
        self._device_ct_bits = device_ct_bits
        self._device_ct: Optional[DeviceCTState] = None
        if device_ct_bits is not None and conntrack is None:
            self.conntrack = FlowConntrack(capacity_bits=max(10, device_ct_bits))
        self.lb = lb
        # called for every redirect verdict with a known 5-tuple:
        # fn(peer_addr_bytes, ep_idx, sport, dport, proto, ingress,
        # family) — the cilium_proxy4/6 write hook (bpf_lxc.c inserts
        # a proxymap entry when the verdict is a proxy port)
        self.on_redirect = None
        self._lb_tables: Dict[int, object] = {}
        self._lb_version = -1
        self._lock = threading.Lock()
        self._endpoints: list = []  # identity id per endpoint index
        self._endpoint_ids: list = []  # endpoint id per endpoint index
        self._basis = None
        # {(direction, family): WideDatapathTables (4) | DatapathTables (6)}
        self._tables: Dict[Tuple[int, int], object] = {}
        self._pf_empty = (True, True)  # (v4, v6) deny sets empty
        self._v6_fused = False
        # verdict attribution (FlowAttribution): requested flag, the
        # per-direction rule tables of the last sweep (None = plain
        # path), the rule count and the metric origin names
        self._attrib_requested = False
        self._rule_tabs: Optional[Dict[int, torch.Tensor]] = None
        self._attrib_n_rules = 0
        self._attrib_names: list = []
        # conntrack basis epoch: bumped on every CT flush, so a batch
        # whose basis moved between its pre-pass and its completion
        # creates no entries verdicted under the old basis
        self._ct_epoch = 0
        self.counters = np.zeros((0, 3), np.int64)

    def set_endpoints(self, endpoints: Sequence) -> None:
        """Accepts identity ids (endpoint id == identity id) or
        (endpoint_id, identity_id) pairs; order defines the datapath
        endpoint index."""
        with self._lock:
            pairs = [e if isinstance(e, tuple) else (int(e), int(e)) for e in endpoints]
            self._endpoint_ids = [int(p[0]) for p in pairs]
            self._endpoints = [int(p[1]) for p in pairs]
            # CT keys embed the endpoint INDEX; a changed endpoint list
            # would let a new occupant of an index inherit the previous
            # endpoint's established-flow bypass entries.
            self._flush_ct_locked()

    def endpoint_index(self, endpoint_id: int) -> Optional[int]:
        try:
            return self._endpoint_ids.index(endpoint_id)
        except ValueError:
            return None

    def endpoint_id_at(self, idx: int) -> Optional[int]:
        with self._lock:
            if 0 <= idx < len(self._endpoint_ids):
                return self._endpoint_ids[idx]
        return None

    def _flush_ct_locked(self) -> None:
        if self.conntrack is not None:
            self.conntrack.flush()
        self._ct_epoch += 1
        self._device_ct = None  # a fresh table on next use

    def set_attribution(self, on: bool) -> None:
        """Toggle per-flow verdict attribution (the FlowAttribution
        runtime option). Takes effect on the next rebuild, which it
        forces: the materializer sweep re-runs with the attribution
        variant to populate the per-(identity row, column) deciding-rule
        table, and batches switch to the policymap kernel's attribution
        entry, accounting ``rule_hits_total`` / ``drop_reasons_total``.
        Off drops the rule table and runs the plain path."""
        with self._lock:
            if bool(on) == self._attrib_requested:
                return
            self._attrib_requested = bool(on)
            self._basis = None  # the rule table exists only after a sweep

    def _attrib_origins(self, compiled):
        """({ingress_bool: AttribTables | None}, n_rules) for this
        rebuild — all None when attribution is off or a rule mutation
        raced the (compiled, device) snapshot (the next rebuild heals)."""
        off = {True: None, False: None}
        if not self._attrib_requested:
            return off, 0
        ai = self.engine.attribution(True, expect_revision=compiled.revision)
        ae = self.engine.attribution(False, expect_revision=compiled.revision)
        if ai is None or ae is None:
            return off, 0
        return {True: ai[0], False: ae[0]}, ai[1]

    @staticmethod
    def _build_mats(compiled, device, endpoints, ao, nr):
        """Both directions' full sweeps from one (compiled, device)
        snapshot; with origins, the attribution sweeps."""
        return {
            TRAFFIC_INGRESS: materialize_endpoints_state(
                compiled, device, endpoints, ingress=True,
                attrib_origin=ao[True], n_rules=nr,
            ),
            TRAFFIC_EGRESS: materialize_endpoints_state(
                compiled, device, endpoints, ingress=False,
                attrib_origin=ao[False], n_rules=nr,
            ),
        }

    def rebuild(self, force: bool = False) -> Dict[Tuple[int, int], object]:
        """Bring the device state up to date: both directions' policymap
        sweeps and both families' tries, rebuilt in full when the
        policy, the identities, the ipcache, the prefilter, the endpoint
        set or the attribution switch moved, and the LB tables when the
        service table moved. Each of those moves flushes the conntrack.
        Returns {(direction, family): tables}."""
        with self._lock:
            # versions captured before the sources are read: a mutation
            # landing mid-build triggers one more rebuild
            trie_versions = (self.ipcache.version, self.prefilter.revision)
            compiled, device = self.engine.snapshot()
            basis = (self.engine.install_gen, trie_versions, tuple(self._endpoints))
            if not force and basis == self._basis:
                self._refresh_lb_locked()
                return self._tables
            ao, nr = self._attrib_origins(compiled)
            mat = self._build_mats(compiled, device, self._endpoints, ao, nr)
            _, pf_cidrs = self.prefilter.dump()
            # empty-set flags first: both families' fusion gates read
            # them (an empty deny set skips the walk entirely)
            pf_empty = (
                not any(":" not in c for c in pf_cidrs),
                not any(":" in c for c in pf_cidrs),
            )
            ip_lists = {4: [], 6: []}
            for cidr, e in self.ipcache.items():
                row = compiled.id_to_row.get(e.identity)
                if row is not None:
                    ip_lists[6 if ":" in cidr else 4].append((cidr, row))

            # IPv6: stride-8 tries with the shared prefix elided; the
            # fused deny+identity walk while a v6 deny set is live (it
            # then covers the deny stage, so no standalone deny trie)
            pf6_list = [(c, 0) for c in pf_cidrs if ":" in c]
            ip6 = build_trie_elided(ip_lists[6], ipv6=True)
            merged6_list = (
                merge_trie_entries(ip_lists[6], pf6_list, ipv6=True)
                if not pf_empty[1] else None
            )
            if merged6_list is not None:
                merged6 = build_trie_elided(merged6_list, ipv6=True)
                pf6 = _NO_TRIE6
            else:
                pf6 = build_trie_elided(pf6_list, ipv6=True)
                merged6 = _NO_TRIE6
            v6_fused = merged6_list is not None

            # IPv4 rides the wide (dense-16-bit-first) tries
            pf_wide = build_wide_trie((c, 0) for c in pf_cidrs if ":" not in c)
            ip_wide = build_wide_trie(ip_lists[4])
            # fused deny+identity walk: built only while the deny stage
            # is live and both layouts are flat; it then covers the deny
            # stage, so the standalone deny trie is not uploaded
            merged = merge_flat_tries(ip_wide, pf_wide) if not pf_empty[0] else None
            if merged is None:
                merged = _NO_TRIE
            else:
                pf_wide = _NO_TRIE
            world_row = compiled.id_to_row.get(ID_WORLD)
            if world_row is None:
                raise RuntimeError("reserved:world identity has no device row")
            # one upload of each family's tries, shared by both directions
            v4 = wide_tables_from_numpy(
                (*pf_wide, *ip_wide, *merged), world_row,
                mat[TRAFFIC_INGRESS].tables, device=self.device,
            )
            v6 = v6_tables_from_numpy(
                (*pf6, *ip6, *merged6), world_row, mat[TRAFFIC_INGRESS].tables,
                device=self.device,
            )
            tables: Dict[Tuple[int, int], object] = {}
            for direction, m in mat.items():
                tables[(direction, 4)] = dataclasses.replace(v4, policymap=m.tables)
                tables[(direction, 6)] = dataclasses.replace(v6, policymap=m.tables)
            rule_tabs = {d: m.rule_tab for d, m in mat.items()}
            self._rule_tabs = None if any(r is None for r in rule_tabs.values()) else rule_tabs
            self._attrib_n_rules = nr if self._rule_tabs is not None else 0
            self._attrib_names = self.engine.repo.origin_names() if self._rule_tabs else []
            self._tables = tables
            self._pf_empty = pf_empty
            self._v6_fused = v6_fused
            self._basis = basis
            if self.counters.shape[0] != len(self._endpoints):
                self.counters = np.zeros((len(self._endpoints), 3), np.int64)
            # Conntrack invalidation: the established-flow bypass is
            # only sound while the verdict basis that admitted the flow
            # still holds, so any basis move flushes the table (revoked
            # rules, remapped peers and new deny prefixes apply to
            # established flows on their next packet).
            self._flush_ct_locked()
            self._refresh_lb_locked()
            return self._tables

    def _refresh_lb_locked(self) -> None:
        # LB tables: deterministic backend selection means backend
        # churn changes the translated CT key (a natural miss), but
        # entries created while a flow was NOT translated would bypass
        # the new service table — so any LB move flushes too.
        if self.lb is not None and self.lb.version != self._lb_version:
            lb_ver = self.lb.version
            self._lb_tables = self.lb.build_device(device=self.device)
            self._lb_version = lb_ver
            self._flush_ct_locked()

    def _account_attribution(
        self,
        verdict: np.ndarray,
        rule: np.ndarray,
        l4x: np.ndarray,
        hits: Optional[np.ndarray],
        *,
        ingress: bool,
    ) -> None:
        """rule_hits_total / drop_reasons_total accounting for one
        attributed batch, from pulled host arrays. ``hits=None`` means
        no exact device segment-sum is at hand — fall back to a host
        bincount over the rule array."""
        names = self._attrib_names
        if hits is None:
            matched = rule[rule >= 0]
            hits = np.bincount(matched, minlength=len(names))
        direction = "ingress" if ingress else "egress"
        for r in np.nonzero(hits)[0]:
            origin = names[r] if r < len(names) else f"rule-{r}"
            _metrics.rule_hits_total.inc(
                {"origin": origin, "direction": direction}, float(hits[r])
            )
        pol = verdict == DROP_POLICY
        deny = pol & (rule >= 0)
        for reason, mask in (
            ("deny-rule", deny),
            ("no-l4-match", pol & ~deny & l4x),
            ("no-l3-match", pol & ~deny & ~l4x),
            ("prefilter", verdict == DROP_PREFILTER),
            ("no-service", verdict == DROP_NO_SERVICE),
            ("pipeline-degraded", verdict == DROP_DEGRADED),
        ):
            n = int(np.count_nonzero(mask))
            if n:
                labels = {"reason": reason}
                if reason == "prefilter":
                    # reason 144's device-kernel producer
                    labels["producer"] = "prefilter"
                _metrics.drop_reasons_total.inc(labels, float(n))

    def _up(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a).astype(dtype, copy=False))
        ).to(self.device)

    def _add_host_counters(self, verdict: np.ndarray, ep_idx: np.ndarray) -> None:
        """Per-endpoint (forwarded, dropped_policy, dropped_other)
        counts of a batch whose device counters do not cover it."""
        with self._lock:
            if self.counters.shape[0] == max(1, len(self._endpoints)):
                cls = np.select([verdict == FORWARD, verdict == DROP_POLICY], [0, 1], default=2)
                np.add.at(self.counters, (ep_idx, cls), 1)

    def _dispatch(self, st, fl: _Batch, sel, row_override, *, ingress: bool):
        """The device half for the flows ``sel`` (None = all): LPM
        walks and policymap verdict at the exact shape, pulled to host
        → (verdict, redirect, counters, rule, l4_covered, hits); the
        last three are None without attribution."""
        t, pf_empty, v6_fused, rule_tab, n_rules, ep_count, _lbt = st

        def part(a):
            return a if sel is None else a[sel]

        flows = tuple(self._up(part(a), np.int32) for a in (fl.ep_idx, fl.dports, fl.protos))
        attrib = rule_tab is not None
        # the XDP prefilter guards traffic entering the node only, and
        # an empty deny set skips the walk
        kw = dict(ep_count=ep_count, prefilter=ingress and not pf_empty,
                  attrib=attrib, rule_tab=rule_tab, n_rules=n_rules,
                  row_override=None if row_override is None else self._up(part(row_override), np.int32))
        if fl.family == 4:
            peer = self._up(part(fl.peer_u32).astype(np.uint32, copy=False).view(np.int32), np.int32)
            out = process_flows_wide(t, peer, *flows, **kw)
        else:
            out = process_flows(t, self._up(part(fl.peer_bytes), np.int32), *flows, levels=16,
                                fused=v6_fused, **kw)
        out = [x.cpu().numpy() for x in out]
        return (*out, None, None, None) if not attrib else tuple(out)

    def _lb_stage(self, lbt, fl: _Batch, sports):
        """Egress VIP→backend translation (bpf_lxc.c:444-455: the
        service lookup precedes conntrack and the policy check, so CT
        tracks the backend tuple and policy sees the backend's
        identity) → (svc_drop [B] bool, revnat [B] uint16), both None
        when no flow hit a frontend; rewrites ``fl`` in place."""
        # hash over STABLE endpoint ids so unrelated endpoint churn
        # cannot re-select backends for established flows
        if self._endpoint_ids:
            ep_ids = np.asarray(self._endpoint_ids, np.int64)[
                np.clip(fl.ep_idx, 0, len(self._endpoint_ids) - 1)
            ]
        else:
            ep_ids = fl.ep_idx
        peer_bytes = fl.bytes_()
        fh = flow_hash32(peer_bytes, sports, fl.dports, fl.protos, ep_ids)
        nb, npo, rv, ok, nobk = lb_translate(
            lbt, self._up(peer_bytes, np.int32), self._up(fl.dports, np.int32),
            self._up(fl.protos, np.int32), self._up(fh, np.int32),
        )
        ok = ok.cpu().numpy()
        nobk = nobk.cpu().numpy()
        if not (ok.any() or nobk.any()):
            return None, None
        fl.set_peer(nb.cpu().numpy())
        fl.dports = npo.cpu().numpy()
        return nobk, rv.cpu().numpy().astype(np.uint16)

    def _run(
        self,
        fl: _Batch,
        sports: Optional[np.ndarray],
        *,
        ingress: bool,
        want_rev_nat: bool = False,
        tunnel_identities: Optional[np.ndarray] = None,
    ):
        """One synchronous batch of either family: overlay rows, the LB
        stage, then either the whole batch on the device (no CT) or the
        CT pre-pass with only its misses on the device; counters, CT
        creation, the redirect hook and, with attribution on, the
        attribution metrics."""
        self.rebuild()
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        family = fl.family
        with self._lock:
            st = (
                self._tables[(direction, family)],
                self._pf_empty[0 if family == 4 else 1],
                self._v6_fused,
                self._rule_tabs[direction] if self._rule_tabs is not None else None,
                self._attrib_n_rules,
                max(1, len(self._endpoints)),
                self._lb_tables.get(family) if self.lb is not None else None,
            )
        b = fl.ep_idx.shape[0]

        # Overlay path (bpf_overlay.c): decapped flows carry the peer's
        # security identity in the tunnel key — trust it over the
        # ipcache LPM when it resolves to a known device row; unknown
        # or zero identities fall back to the LPM walk.
        row_override = None
        if tunnel_identities is not None:
            row_override = self.engine.rows_or_negative(np.asarray(tunnel_identities, np.int64))

        svc_drop = revnat_vals = None
        lbt = st[6]
        if not ingress and lbt is not None:
            svc_drop, revnat_vals = self._lb_stage(lbt, fl, sports)

        # device-resident conntrack. An LB family falls back to the host
        # CT in BOTH directions: the CT is one bidirectional structure,
        # and an egress VIP flow's entry must be visible to its reply.
        if (
            self._device_ct_bits is not None
            and sports is not None
            and svc_drop is None
            and row_override is None
            and lbt is None
        ):
            return self._process_device_ct(fl, sports, ingress=ingress, want_rev_nat=want_rev_nat)

        ct = self.conntrack
        if ct is None or sports is None:
            # no CT: the whole batch takes the device path
            v, red, counters, rule, l4x, hits = self._dispatch(st, fl, None, row_override,
                                                               ingress=ingress)
            if svc_drop is not None and svc_drop.any():
                v = np.where(svc_drop, np.int8(DROP_NO_SERVICE), v)
                red = red & ~svc_drop
                # the device counters classified these flows before the
                # override: count this batch on the host instead
                counters = None
                if rule is not None:
                    # no-backend flows never reached a rule: drop their
                    # attribution and re-derive the hit sums on the host
                    rule = np.where(svc_drop, np.int32(-1), rule)
                    hits = None
            if counters is None:
                self._add_host_counters(v, fl.ep_idx)
            else:
                with self._lock:
                    if self.counters.shape == counters.shape:
                        self.counters += counters
            if rule is not None:
                self._account_attribution(v, rule, l4x, hits, ingress=ingress)
            if want_rev_nat:
                # no CT → replies can't be recognized → no restore
                return v, red, np.zeros(b, np.uint16)
            return v, red

        # --- conntrack pre-pass (vectorized host) ----------------------
        sports = np.asarray(sports, np.int64)
        peer_hi, peer_lo = fl.ct_words()
        ka, kb, kc = pack_keys(
            peer_hi, peer_lo, fl.ep_idx.astype(np.uint64), sports,
            fl.dports.astype(np.uint64), fl.protos.astype(np.uint64),
            np.full(b, 0 if ingress else 1, np.uint64),
        )
        if want_rev_nat:
            # revNAT ids read under the SAME lock hold as the find
            state, _slot, ct_rev = ct.lookup_batch(ka, kb, kc, want_revnat=True)
            ct_rev[state != CT_REPLY] = 0
        else:
            state, _slot = ct.lookup_batch(ka, kb, kc)
        miss = state == CT_NEW
        # no CT entry is created under a basis that moved after this point
        ct_epoch = self._ct_epoch

        verdict = np.full(b, FORWARD, np.int8)
        redirect = np.zeros(b, bool)
        if miss.any():
            # the miss tail, at its exact shape
            midx = np.nonzero(miss)[0]
            v, red, _counters, at_rule, at_l4x, at_hits = self._dispatch(
                st, fl, midx, row_override, ingress=ingress)
            if svc_drop is not None:
                sd = svc_drop[midx]
                v = np.where(sd, np.int8(DROP_NO_SERVICE), v)
                red = red & ~sd
                if at_rule is not None and sd.any():
                    # no-backend flows never reached a rule
                    at_rule = np.where(sd, np.int32(-1), at_rule)
                    at_hits = None
            verdict[midx] = v
            redirect[midx] = red
            if at_rule is not None:
                # CT-bypassed flows took no policy decision this batch
                # (rule -1): only the tail's decisions are accounted
                self._account_attribution(v, at_rule, at_l4x, at_hits, ingress=ingress)
            # CT entries for newly allowed flows (ct_create4,
            # bpf_lxc.c:~560: only successful verdicts create state).
            # L7-redirect flows are EXCLUDED: a CT bypass would return
            # redirect=False on later packets and route them around the
            # proxy — proxied connections stay on the policy path.
            ok = (v == FORWARD) & ~red
            if ok.any() and self.conntrack is ct and self._ct_epoch == ct_epoch:
                oidx = midx[ok]
                ct.create_batch(
                    ka[oidx], kb[oidx], kc[oidx],
                    revnat=None if revnat_vals is None else revnat_vals[oidx],
                )

        # proxymap handoff: redirected flows carry their full 5-tuple
        if self.on_redirect is not None and redirect.any():
            peer_bytes = fl.bytes_()
            for i in np.nonzero(redirect)[0]:
                self.on_redirect(
                    bytes(int(x) & 0xFF for x in peer_bytes[i]),
                    int(fl.ep_idx[i]), int(sports[i]), int(fl.dports[i]),
                    int(fl.protos[i]), ingress, family,
                )
        # host counter accumulation (CT hits included)
        self._add_host_counters(verdict, fl.ep_idx)
        if want_rev_nat:
            # revNAT restore (bpf/lib/lb.h lb4_rev_nat via the CT
            # entry's rev_nat_index): REPLY hits carry the id of the
            # service that translated the original request
            return verdict, redirect, ct_rev
        return verdict, redirect

    def _process_device_ct(self, fl: _Batch, sports, *, ingress: bool, want_rev_nat: bool):
        """One batch through :func:`process_flows_ct` at its exact shape
        (there is no compile cache to pad for): the tables and the CT
        state are read under one lock hold, so a flush between them
        cannot pair old-basis verdicts with a fresh table. Adds the
        device counters and calls ``on_redirect``; attributes nothing,
        and returns zero revNAT ids (no LB table is active here)."""
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        family = fl.family
        b = fl.ep_idx.shape[0]
        if b and not (0 <= fl.ep_idx.min() and fl.ep_idx.max() < 1 << 23):
            raise ValueError("device CT: ep_idx outside the 23 bits of the kc word")
        sports = np.asarray(sports, np.int32)
        if family == 4:
            peer = self._up(fl.peer_u32.astype(np.uint32, copy=False).view(np.int32), np.int32)
        else:
            peer = self._up(fl.peer_bytes, np.int32)
        flows = [self._up(a, np.int32) for a in (fl.ep_idx, fl.dports, fl.protos, sports)]
        valid = torch.ones(b, dtype=torch.bool, device=self.device)
        now = int(time.monotonic())
        with self._lock:
            t = self._tables[(direction, family)]
            if self._device_ct is None:
                self._device_ct = make_state(self._device_ct_bits, device=self.device)
            v, red, counters = process_flows_ct(
                t, self._device_ct, peer, *flows, 0 if ingress else 1, now, valid,
                ep_count=max(1, len(self._endpoints)),
                prefilter=ingress and not self._pf_empty[0 if family == 4 else 1],
                levels=16, family=family, fused=self._v6_fused if family == 6 else False,
            )
            counters = counters.cpu().numpy()
            if self.counters.shape == counters.shape:
                self.counters += counters
        verdict = v.cpu().numpy()
        redirect = red.cpu().numpy()
        if self.on_redirect is not None and redirect.any():
            peer_bytes = fl.bytes_()
            for i in np.nonzero(redirect)[0]:
                self.on_redirect(
                    bytes(int(x) & 0xFF for x in peer_bytes[i]),
                    int(fl.ep_idx[i]), int(sports[i]), int(fl.dports[i]),
                    int(fl.protos[i]), ingress, family,
                )
        if want_rev_nat:
            return verdict, redirect, np.zeros(b, np.uint16)
        return verdict, redirect

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
    ):
        """IPv4 batch → (verdicts [B] int8, redirect [B] bool);
        accumulates the per-endpoint counters. ``src_ips`` is the peer
        address (source for ingress, destination for egress). Passing
        ``sports`` with a conntrack-enabled pipeline activates the CT
        pre-pass (established/reply bypass + creation on allow).
        ``return_rev_nat`` appends a [B] uint16 array of revNAT ids for
        reply-direction CT hits (0 otherwise) — resolve with
        rev_nat_frontend() to restore the VIP on reply sources.
        ``tunnel_identities`` ([B] int, 0 = none) marks overlay-decapped
        flows whose encap key carried the peer identity — trusted over
        the ipcache LPM when known (bpf_overlay.c)."""
        src = np.asarray(src_ips)
        fl = _Batch(
            4, np.asarray(ep_idx, np.int32), np.asarray(dports, np.int32),
            np.asarray(protos, np.int32), peer_u32=src.astype(np.uint32),
            words=(np.zeros(src.shape[0], np.uint64), src.astype(np.uint64)),
        )
        return self._run(fl, sports, ingress=ingress, want_rev_nat=return_rev_nat,
                         tunnel_identities=tunnel_identities)

    def process_v6(
        self,
        peer_bytes: np.ndarray,  # [B, 16] int32 address bytes
        ep_idx: np.ndarray,
        dports: np.ndarray,
        protos: np.ndarray,
        *,
        ingress: bool = True,
        sports: Optional[np.ndarray] = None,
        return_rev_nat: bool = False,
        tunnel_identities: Optional[np.ndarray] = None,
    ):
        """IPv6 batch (16-level elided stride-8 walk, bpf_lxc.c:848
        tail_ipv6_*) → (verdicts [B] int8, redirect [B] bool), with the
        same ``sports`` / ``return_rev_nat`` / ``tunnel_identities``
        as :meth:`process`; the counters are shared with IPv4."""
        peer = np.asarray(peer_bytes, np.int32)
        if peer.ndim != 2 or peer.shape[1] != 16:
            raise ValueError(f"process_v6: peer_bytes must be [B, 16], got {tuple(peer.shape)}")
        fl = _Batch(6, np.asarray(ep_idx, np.int32), np.asarray(dports, np.int32),
                    np.asarray(protos, np.int32), peer_bytes=peer)
        return self._run(fl, sports, ingress=ingress, want_rev_nat=return_rev_nat,
                         tunnel_identities=tunnel_identities)

    def rev_nat_frontend(self, revnat_id: int):
        """revNAT id (from a return_rev_nat=True process call) → the
        original frontend L3n4Addr, or None."""
        if self.lb is None or not revnat_id:
            return None
        return self.lb.rev_nat(int(revnat_id))
