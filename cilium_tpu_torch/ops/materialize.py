"""Policymap materialization: full verdict engine → realized lookup state.

The counterpart of the reference's hottest control-plane loop,
computeDesiredL3PolicyMapEntries (pkg/endpoint/policy.go:317-389): for
every local endpoint, evaluate the full policy for *every known
identity* (and every L4 slot) and emit the column-bitmap lookup tables
of ops/lookup.py plus host-visible policymap entries (pkg/maps/policymap
key format) for the datapath front-end.

Two sweeps compute the same packed words: "auto", the identity-major
matrix sweep (:func:`_sweep_device_matrix`, every product on the
``bool_mm`` kernel), and "flow", one :func:`verdict_batch` flow per
(segment, identity) pair (:func:`_sweep_device`). The tests diff them
bit for bit. With rule-origin tables (verdict attribution) the sweep
always takes the flow route, :func:`_sweep_device_attrib`, whose
per-flow term vectors give each (identity row, column) its deciding
rule (``rule_nc`` / ``rule_tab``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.program import CompiledPolicy, PROTO_TCP_N
from .bitmap import pack_bool_bits, unpack_bits_u32
from .lookup import PolicymapTables
from .verdict import ALLOW, AttribTables, DevicePolicy, bool_mm, verdict_batch

TRAFFIC_INGRESS = 0
TRAFFIC_EGRESS = 1


@dataclasses.dataclass(frozen=True)
class PolicyKey:
    """pkg/maps/policymap PolicyKey (policymap.go:64): identity, dport
    (0 = L3-only), nexthdr (0 = L3-only), traffic direction."""

    identity: int
    dport: int
    nexthdr: int
    direction: int


@dataclasses.dataclass
class EndpointPolicySnapshot:
    """Desired policymap for one endpoint + its slot layout. Entry value
    is the proxy-redirect flag."""

    entries: Dict[PolicyKey, int]
    slots: List[Tuple[int, int]]


def _endpoint_slots(compiled: CompiledPolicy, subj_sel_row: np.ndarray, ingress: bool):
    """Distinct (port, proto) L4 slots this endpoint's policy can
    reference: L4 entries whose subject selector matches, plus
    L7-parser ports (always TCP)."""
    d = compiled.ingress if ingress else compiled.egress

    def sel_hit(sids: np.ndarray) -> np.ndarray:
        return (subj_sel_row[sids >> 5] >> (sids & 31)) & 1

    slots = set()
    if d.e_subj.size:
        hit = sel_hit(d.e_subj.astype(np.int64)) == 1
        for port, proto in zip(d.e_port[hit], d.e_proto[hit]):
            slots.add((int(port), int(proto)))
    if d.l7_subj.size:
        hit = sel_hit(d.l7_subj.astype(np.int64)) == 1
        for port in d.l7_port[hit]:
            slots.add((int(port), PROTO_TCP_N))
    return sorted(slots)


@dataclasses.dataclass
class MaterializedState:
    """Host mirror of the realized policymap (unpacked column bitmaps +
    metadata) beside the device tables."""

    tables: PolicymapTables
    snapshots: List[EndpointPolicySnapshot]
    ingress: bool
    endpoint_identity_ids: List[int]
    ep_rows: np.ndarray  # [E] int32
    ep_slots: List[List[Tuple[int, int]]]
    allow_nc: np.ndarray  # [N, C_pad] bool
    red_nc: np.ndarray  # [N, C_pad] bool
    n_cols: int
    # Verdict attribution: per-(identity row, column) deciding-rule
    # index from an attribution sweep (-1 = no rule; padded columns -1;
    # deny drops carry the deny rule even though their allow bit is 0).
    # None when the sweep ran without attribution.
    rule_nc: Optional[np.ndarray] = None  # [N, C_pad] int32 (host)
    rule_tab: Optional[torch.Tensor] = None  # [N, C_pad] int32 (device)


def _sweep_device(
    policy: DevicePolicy,
    seg_row: torch.Tensor,  # [n_seg] int32
    seg_port: torch.Tensor,
    seg_proto: torch.Tensor,
    seg_l4: torch.Tensor,  # [n_seg] bool
    n: int,
    ingress: bool,
    block: int,
):
    """Per-flow sweep ("flow" route): one verdict_batch flow per
    (segment, identity row) pair → packed (allow, l3, redirect)
    [n_seg, ceil(n/32)] words."""
    n_seg = seg_row.shape[0]
    dev = seg_row.device
    v = verdict_batch(
        policy,
        seg_row.repeat_interleave(n),
        torch.arange(n, dtype=torch.int32, device=dev).repeat(n_seg),
        seg_port.repeat_interleave(n),
        seg_proto.repeat_interleave(n),
        seg_l4.repeat_interleave(n),
        ingress=ingress,
        block=block,
    )
    allow = pack_bool_bits((v.decision == ALLOW).reshape(n_seg, n))
    l3a = pack_bool_bits((v.l3 == 1).reshape(n_seg, n))
    red = pack_bool_bits(v.l7_redirect.reshape(n_seg, n))
    return allow, l3a, red


def _sweep_device_attrib(
    policy: DevicePolicy,
    seg_row: torch.Tensor,
    seg_port: torch.Tensor,
    seg_proto: torch.Tensor,
    seg_l4: torch.Tensor,
    origin: AttribTables,
    n: int,
    ingress: bool,
    block: int,
    n_rules: int,
):
    """:func:`_sweep_device` plus the attribution tail: also returns the
    [n_seg, n] int32 deciding-rule index per (segment, identity row) —
    the source of MaterializedState.rule_tab."""
    n_seg = seg_row.shape[0]
    dev = seg_row.device
    v, at, _hits = verdict_batch(
        policy,
        seg_row.repeat_interleave(n),
        torch.arange(n, dtype=torch.int32, device=dev).repeat(n_seg),
        seg_port.repeat_interleave(n),
        seg_proto.repeat_interleave(n),
        seg_l4.repeat_interleave(n),
        ingress=ingress,
        block=block,
        attrib=True,
        origin=origin,
        n_rules=n_rules,
    )
    allow = pack_bool_bits((v.decision == ALLOW).reshape(n_seg, n))
    l3a = pack_bool_bits((v.l3 == 1).reshape(n_seg, n))
    red = pack_bool_bits(v.l7_redirect.reshape(n_seg, n))
    return allow, l3a, red, at.rule.reshape(n_seg, n)


def _sweep_device_matrix(
    policy: DevicePolicy,
    seg_row: torch.Tensor,  # [g] int32
    seg_port: torch.Tensor,
    seg_proto: torch.Tensor,
    seg_l4: torch.Tensor,  # [g] bool
    n: int,
    ingress: bool,
    nblock: int,
):
    """Identity-major matrix formulation of the segment sweep ("auto").

    The segment side (subject selector row, port one-hot, combo and
    L7-filter coverage) is fixed per segment, so it is hoisted: the
    per-peer term vectors are computed once per identity block and
    contracted against the [·, g] segment matrices. Every reduction is
    ``any(a ∧ b) == (Σ a·b) > 0`` over 0/1 int8 operands, i.e. one
    :func:`bool_mm`; the one per-flow data dependence — group_ok folding
    req_ok — is handled by evaluating both req_ok phases and selecting
    per (peer, segment) cell on the deny matrix. Returns the same packed
    (allow, l3, redirect) [g, ceil(n/32)] words as :func:`_sweep_device`.
    """
    t = policy.ingress if ingress else policy.egress
    subj8 = unpack_bits_u32(policy.sel_match[seg_row.long()])  # [g, S]
    pp = (
        (seg_port[:, None] == t.ports[None, :])
        & (seg_proto[:, None] == t.protos[None, :])
        & seg_l4[:, None]
    ).to(torch.int8)  # [g, P4]
    subj_t8 = subj8.T.contiguous()  # [S, g]
    combo_t = (bool_mm(subj8, t.s1_mat) & bool_mm(pp, t.p1_mat)).T.contiguous()  # [K1, g]
    sp7_t = (bool_mm(subj8, t.s7_mat) & bool_mm(pp, t.p7_mat)).T.contiguous()  # [K7, g]
    has_l4 = seg_l4[None, :]  # [1, g]

    allow_parts, l3_parts, red_parts = [], [], []
    for lo in range(0, n, nblock):
        peer8 = unpack_bits_u32(policy.sel_match[lo:lo + nblock])  # [nb, S]
        peer_deny = bool_mm(peer8, t.deny_t, complement_x=True)  # [nb, S]
        peer_allow = bool_mm(peer8, t.allow_t)
        peer_en = bool_mm(peer8, t.en_t)  # [nb, K1]
        peer_ee = bool_mm(peer8, t.ee_t)
        deny = bool_mm(peer_deny, subj_t8)  # [nb, g]
        l3_allow = bool_mm(peer_allow, subj_t8)
        en_any = bool_mm(peer_en, combo_t)
        ee_any = bool_mm(peer_ee, combo_t)
        l4_allow = en_any | (~deny & ee_any)

        gpn_hit = bool_mm(peer8, t.gpn_mat)  # [nb, G]
        gpe_hit = bool_mm(peer8, t.gpe_mat)
        gok_true = gpn_hit | gpe_hit | t.group_no_peers[None, :]
        gok_false = gpn_hit | t.group_no_peers[None, :]
        l7_true = bool_mm(bool_mm(gok_true, t.g7_mat), sp7_t)  # [nb, g]
        l7_false = bool_mm(bool_mm(gok_false, t.g7_mat), sp7_t)
        l7_present = torch.where(deny, l7_false, l7_true)

        l3_pass = l3_allow & ~deny
        allow_parts.append(l3_pass | (has_l4 & l4_allow))
        l3_parts.append(l3_pass)
        red_parts.append(has_l4 & l4_allow & l7_present)

    def fin(parts):
        return pack_bool_bits(torch.cat(parts).T)

    return fin(allow_parts), fin(l3_parts), fin(red_parts)


def _unpack_rows(words: torch.Tensor, n: int) -> np.ndarray:
    """[n_seg, ceil(n/32)] packed words → [n_seg, n] bool on the host
    (the pack_bool_bits inverse)."""
    w = np.ascontiguousarray(words.cpu().numpy())
    bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[0], -1), axis=1, bitorder="little")
    return bits[:, :n].astype(bool)


# Identity rows per matrix-sweep block: bounds the [nblock, S]
# peer-term intermediates.
_MATRIX_NBLOCK = 1024

# Sweep calls per route ("matrix", "flow", "flow_attrib"), one per
# segment chunk: shows which sweep a rebuild ran.
SWEEPS: Dict[str, int] = {}


def _sweep_segments(
    device: DevicePolicy,
    sr: np.ndarray,  # [n_seg] int32 subject rows
    sp: np.ndarray,  # [n_seg] int32 ports
    spr: np.ndarray,  # [n_seg] int32 protos
    sl: np.ndarray,  # [n_seg] bool has_l4
    n: int,
    *,
    ingress: bool,
    block: int,
    attrib_origin: Optional[AttribTables] = None,
    n_rules: int = 0,
    sweep: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Chunked segments × all-identities sweep → unpacked (allow_sn,
    l3_sn, red_sn) [n_seg, n] bool + rule_sn [n_seg, n] int32 (-1 when
    no attribution ran). ``sweep`` picks the kernel: "auto" the
    identity-major matrix sweep, "flow" the per-flow sweep. Attribution
    sweeps always take the flow route: the first-match rule tail needs
    the per-flow term vectors the matrix form contracts away."""
    if sweep not in ("auto", "flow"):
        raise ValueError(f"unknown sweep {sweep!r}")
    n_seg = len(sr)
    if n_seg == 0:  # zero endpoints: nothing to sweep
        empty = np.zeros((0, n), bool)
        return empty, empty, empty, np.zeros((0, n), np.int32)
    dev = device.sel_match.device
    # chunk the segment axis so one call covers at most ~2**23
    # (segment, identity) pairs whatever the endpoint count
    budget = max(8, (1 << 23) // max(1, n))
    seg_chunk = 1 << (budget.bit_length() - 1)
    outs: List[List[np.ndarray]] = [[], [], []]
    rule_parts: List[np.ndarray] = []
    for lo in range(0, n_seg, seg_chunk):
        hi = min(lo + seg_chunk, n_seg)
        chunk = (
            torch.from_numpy(np.ascontiguousarray(sr[lo:hi], np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sp[lo:hi], np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(spr[lo:hi], np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sl[lo:hi], bool)).to(dev),
        )
        route = "flow_attrib" if attrib_origin is not None else (
            "matrix" if sweep == "auto" else "flow")
        SWEEPS[route] = SWEEPS.get(route, 0) + 1
        if attrib_origin is not None:
            *words, rule = _sweep_device_attrib(
                device, *chunk, attrib_origin, n, ingress, block, n_rules
            )
            rule_parts.append(rule.cpu().numpy())
        elif sweep == "auto":
            words = _sweep_device_matrix(device, *chunk, n, ingress, _MATRIX_NBLOCK)
        else:
            words = _sweep_device(device, *chunk, n, ingress, block)
        for acc, w in zip(outs, words):
            acc.append(_unpack_rows(w, n))
    allow_sn, l3_sn, red_sn = (np.concatenate(acc) for acc in outs)
    rule_sn = (
        np.concatenate(rule_parts) if rule_parts else np.full((n_seg, n), -1, np.int32)
    )
    return allow_sn, l3_sn, red_sn, rule_sn


def _pack_rows_np(m: np.ndarray) -> np.ndarray:
    """[N, K] bool (K a multiple of 32) → [N, K/32] int32 words in
    pack_bool_bits bit order."""
    packed = np.packbits(m, axis=1, bitorder="little")
    return packed.view("<i4").astype(np.int32)


def materialize_endpoints_state(
    compiled: CompiledPolicy,
    device: DevicePolicy,
    endpoint_identity_ids: Sequence[int],
    *,
    ingress: bool = True,
    block: int = 8192,
    attrib_origin: Optional[AttribTables] = None,
    n_rules: int = 0,
    sweep: str = "auto",
) -> MaterializedState:
    """Sweep every endpoint × identity × (L3 + each L4 slot) and lay
    the results out as policymap columns. ``attrib_origin`` (with
    ``n_rules``) switches the sweep to the attribution variant: the
    result also carries rule_nc/rule_tab, the deciding-rule index per
    (identity row, column) the pipeline's lookup gathers from."""
    n = compiled.id_bits.shape[0]
    ep_rows = compiled.rows_for(endpoint_identity_ids)
    # bounded [E, S/32] pull of just the endpoint subject rows
    ep_sel = (
        device.sel_match[torch.from_numpy(ep_rows.astype(np.int64)).to(device.sel_match.device)]
        .cpu().numpy().view(np.uint32)
    )
    live = compiled.row_live
    direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS

    # Flatten (endpoint L3 sweep) + (endpoint, slot) sweeps into one batch.
    ep_slots: List[List[Tuple[int, int]]] = [
        _endpoint_slots(compiled, ep_sel[i], ingress) for i in range(len(ep_rows))
    ]
    seg_row: List[int] = []
    seg_port: List[int] = []
    seg_proto: List[int] = []
    seg_l4: List[bool] = []
    for e, row in enumerate(ep_rows):
        seg_row.append(int(row))
        seg_port.append(0)
        seg_proto.append(0)
        seg_l4.append(False)
        for port, proto in ep_slots[e]:
            seg_row.append(int(row))
            seg_port.append(port)
            seg_proto.append(proto)
            seg_l4.append(True)

    allow_sn, l3_sn, red_sn, rule_sn = _sweep_segments(
        device,
        np.asarray(seg_row, np.int32),
        np.asarray(seg_port, np.int32),
        np.asarray(seg_proto, np.int32),
        np.asarray(seg_l4, bool),
        n,
        ingress=ingress,
        block=block,
        attrib_origin=attrib_origin,
        n_rules=n_rules,
        sweep=sweep,
    )

    # Column layout: one column per (endpoint, L3) + (endpoint, slot).
    col_ep: List[int] = []
    col_port: List[int] = []
    col_proto: List[int] = []
    col_is_l3: List[bool] = []
    col_allow: List[np.ndarray] = []
    col_red: List[np.ndarray] = []
    col_rule: List[np.ndarray] = []
    snapshots: List[EndpointPolicySnapshot] = []

    seg = 0
    for e, row in enumerate(ep_rows):
        l3_allow = l3_sn[seg] & live
        col_rule.append(rule_sn[seg])
        seg += 1
        col_ep.append(e)
        col_port.append(0)
        col_proto.append(0)
        col_is_l3.append(True)
        col_allow.append(l3_allow)
        col_red.append(np.zeros(n, bool))
        entries: Dict[PolicyKey, int] = {}
        for r_idx in np.nonzero(l3_allow)[0]:
            entries[PolicyKey(int(compiled.row_ids[r_idx]), 0, 0, direction)] = 0
        for port, proto_n in ep_slots[e]:
            allow = allow_sn[seg] & live
            redirect = red_sn[seg] & live
            col_rule.append(rule_sn[seg])
            seg += 1
            col_ep.append(e)
            col_port.append(port)
            col_proto.append(proto_n)
            col_is_l3.append(False)
            col_allow.append(allow)
            col_red.append(redirect)
            # Exact {id, port, proto} entries: the datapath consults the
            # exact key first (bpf/lib/policy.h:46), so L3-allowed
            # identities still need one when the filter redirects.
            for r_idx in np.nonzero(allow & (~l3_allow | redirect))[0]:
                key = PolicyKey(int(compiled.row_ids[r_idx]), port, proto_n, direction)
                entries[key] = int(redirect[r_idx])
        snapshots.append(EndpointPolicySnapshot(entries=entries, slots=ep_slots[e]))

    c = len(col_ep)
    c_pad = max(32, ((c + 31) // 32) * 32)
    pad = c_pad - c
    allow_nc = np.zeros((n, c_pad), bool)
    red_nc = np.zeros((n, c_pad), bool)
    rule_nc = None
    if attrib_origin is not None:
        rule_nc = np.full((n, c_pad), -1, np.int32)
    if c:
        allow_nc[:, :c] = np.stack(col_allow, axis=1)
        red_nc[:, :c] = np.stack(col_red, axis=1)
        if rule_nc is not None:
            rule_nc[:, :c] = np.stack(col_rule, axis=1)

    dev = device.sel_match.device

    def col(values, dtype, fill=0):
        return torch.from_numpy(
            np.pad(np.asarray(values, dtype), (0, pad), constant_values=fill)
        ).to(dev)

    tables = PolicymapTables(
        col_ep=col(col_ep, np.int32, -1),
        col_port=col(col_port, np.int32),
        col_proto=col(col_proto, np.int32),
        col_is_l3=col(col_is_l3, bool),
        # allow ‖ redirect in one table: one row read serves both
        id_bits=torch.from_numpy(
            _pack_rows_np(np.concatenate([allow_nc, red_nc], axis=1))
        ).to(dev),
    )
    return MaterializedState(
        tables=tables,
        snapshots=snapshots,
        ingress=ingress,
        endpoint_identity_ids=list(endpoint_identity_ids),
        ep_rows=ep_rows,
        ep_slots=ep_slots,
        allow_nc=allow_nc,
        red_nc=red_nc,
        n_cols=c,
        rule_nc=rule_nc,
        rule_tab=torch.from_numpy(rule_nc).to(dev) if rule_nc is not None else None,
    )

