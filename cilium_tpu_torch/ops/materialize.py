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

The engine's deltas patch a materialized state in place of a new
sweep: :func:`patch_identity_rows` re-sweeps the changed identity rows
against every column, :func:`patch_endpoints_state` the columns of the
endpoints a rule delta can touch against every row. Each writes its
device words with one out-of-place indexing op (:func:`_patch_bitmap_rows`,
``lookup.patch_bitmap_cols``). Given a :class:`PlacedTables` (the
pipeline's copies placed on a plan's grid) each patch scatters the same
words into the placed copies too, one op per stored tensor that owns a
patched row. :func:`patch_selector_rows` / :func:`patch_selector_cols`
replay the engine's selector deltas onto a placed ``sel_match``.
:func:`state_from_snapshot` rebuilds a state from a compiled snapshot's
arrays (``compiler/snapshot.py``) without a sweep.

Under a 2D plan the pipeline hands the sweeps a ``DevicePolicy`` whose
``sel_match`` is ident-sharded (``lookup.IdentSharded``): every row read
of it is ``verdict.sel_rows``, which then launches the ``ident_gather``
kernel once per device over its shards (``lookup.ident_gather_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..compiler.program import CompiledPolicy, PROTO_TCP_N
from .bitmap import pack_bool_bits, unpack_bits_u32
from .lookup import PolicymapTables, patch_bitmap_cols, patch_placed_cols, patch_placed_rows, map_placed
from .verdict import ALLOW, AttribTables, DevicePolicy, bool_mm, sel_rows, verdict_batch

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
    subj8 = unpack_bits_u32(sel_rows(policy.sel_match, seg_row.long()))  # [g, S]
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
        peer8 = unpack_bits_u32(sel_rows(policy.sel_match, slice(lo, lo + nblock)))  # [nb, S]
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


def _pack_rows(rows_bool: np.ndarray) -> np.ndarray:
    """[k, C_pad] bool → [k, C_pad/32] uint32 in pack_bool_bits bit
    order (C_pad is a multiple of 32 by construction)."""
    packed = np.packbits(rows_bool, axis=1, bitorder="little")
    return packed.view(np.uint32).reshape(rows_bool.shape[0], rows_bool.shape[1] // 32)


def _pack_col_word(cols_bool: np.ndarray) -> np.ndarray:
    """[N, ≤32] bool column block → [N] uint32 (one packed id_bits
    word; short tails zero-pad, matching pack_bool_bits)."""
    n, w = cols_bool.shape
    if w < 32:
        cols_bool = np.concatenate([cols_bool, np.zeros((n, 32 - w), bool)], axis=1)
    return np.packbits(cols_bool, axis=1, bitorder="little").view(np.uint32)[:, 0]


def _words(a: np.ndarray, dev) -> torch.Tensor:
    """uint32 words → int32 bit-view tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


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
        sel_rows(device.sel_match, torch.from_numpy(ep_rows.astype(np.int64)).to(device.sel_match.device))
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
        id_bits=_words(_pack_rows(np.concatenate([allow_nc, red_nc], axis=1)), dev),
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
        # a copy even on the CPU: the patches write rule_nc in place
        rule_tab=torch.from_numpy(rule_nc).to(dev, copy=True) if rule_nc is not None else None,
    )


def materialize_endpoints(
    compiled: CompiledPolicy,
    device: DevicePolicy,
    endpoint_identity_ids: Sequence[int],
    *,
    ingress: bool = True,
    block: int = 8192,
) -> Tuple[PolicymapTables, List[EndpointPolicySnapshot]]:
    """The policymap tables and per-endpoint snapshots of
    :func:`materialize_endpoints_state`."""
    st = materialize_endpoints_state(
        compiled, device, endpoint_identity_ids, ingress=ingress, block=block
    )
    return st.tables, st.snapshots


def state_from_snapshot(row_ids: np.ndarray, fields: dict, *, device=None) -> MaterializedState:
    """Rebuild a MaterializedState from compiler/snapshot.py fields on
    ``device`` (None = the card): the restore half of the pinned-map
    persistence analog. The column bitmaps are authoritative; the
    per-endpoint snapshots (the policymap dump surface) are re-derived
    from them, and the device tables packed and uploaded. No sweep runs:
    this is a load, not a derive, so ``rule_nc`` / ``rule_tab`` stay
    None until a rebuild sweeps with attribution."""
    dev = _kernels.resolve_device(device)
    allow_nc = np.asarray(fields["allow_nc"], bool)
    red_nc = np.asarray(fields["red_nc"], bool)
    col_ep = np.asarray(fields["col_ep"], np.int32)
    col_port = np.asarray(fields["col_port"], np.int32)
    col_proto = np.asarray(fields["col_proto"], np.int32)
    col_is_l3 = np.asarray(fields["col_is_l3"], bool)
    ep_slots = fields["ep_slots"]
    ingress = bool(fields["ingress"])
    direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS

    snapshots: List[EndpointPolicySnapshot] = []
    col = 0
    for slots in ep_slots:
        l3_allow = allow_nc[:, col]
        col += 1
        entries: Dict[PolicyKey, int] = {}
        for r_idx in np.nonzero(l3_allow)[0]:
            entries[PolicyKey(int(row_ids[r_idx]), 0, 0, direction)] = 0
        for port, proto_n in slots:
            allow = allow_nc[:, col]
            redirect = red_nc[:, col]
            col += 1
            for r_idx in np.nonzero(allow & (~l3_allow | redirect))[0]:
                key = PolicyKey(int(row_ids[r_idx]), port, proto_n, direction)
                entries[key] = int(redirect[r_idx])
        snapshots.append(EndpointPolicySnapshot(entries=entries, slots=slots))

    def up(a: np.ndarray) -> torch.Tensor:
        # a copy even on the CPU: the loaded arrays stay the host mirror
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, copy=True)

    tables = PolicymapTables(
        col_ep=up(col_ep),
        col_port=up(col_port),
        col_proto=up(col_proto),
        col_is_l3=up(col_is_l3),
        id_bits=pack_bool_bits(up(np.concatenate([allow_nc, red_nc], axis=1))),
    )
    return MaterializedState(
        tables=tables,
        snapshots=snapshots,
        ingress=ingress,
        endpoint_identity_ids=list(fields["endpoint_identity_ids"]),
        ep_rows=np.asarray(fields["ep_rows"], np.int32),
        ep_slots=ep_slots,
        allow_nc=allow_nc,
        red_nc=red_nc,
        n_cols=int(fields["n_cols"]),
    )


def _seg_bucket(n_seg: int) -> int:
    b = 8
    while b < n_seg:
        b <<= 1
    return b


def _patch_bitmap_rows(tab: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Whole rows into a per-identity table, out of place (a published
    snapshot or an in-flight batch may hold the old tensor)."""
    return tab.index_copy(0, idx, rows)


# Flows per verdict block of a patch's sweep (a full sweep's default).
_PATCH_BLOCK = 8192


@dataclasses.dataclass
class PlacedTables:
    """Mutable holder for the grid-placed copies of a materialized
    direction's device tables (the pipeline's per-direction cache): a
    ``PolicymapTables`` whose fields are ``lookup.Replicated`` or, for
    ``id_bits`` under a 2D plan, ``lookup.IdentSharded``, and the rule
    table placed the same way. The patch paths scatter the SAME idx /
    vals into these copies, one out-of-place op per stored tensor that
    owns a patched row, so a row patch under the ident sharding touches
    only the shard that owns the row — no re-place."""

    tables: PolicymapTables
    rule_tab: Optional[object] = None


def patch_identity_rows(
    state: MaterializedState,
    device: DevicePolicy,
    row_events: Sequence[Tuple[int, int, bool]],
    *,
    attrib_origin: Optional[AttribTables] = None,
    n_rules: int = 0,
    placed: Optional[PlacedTables] = None,
) -> None:
    """Apply identity-churn row updates to a materialized policymap.

    ``row_events``: (row, identity_id, live) in order. Dead rows zero
    out; live rows get a fresh verdict sweep over every column segment
    of every endpoint — n_seg × k flows instead of the full n_seg × N
    re-materialization. Snapshots (host policymap dicts) are patched in
    place. With attribution on the state (rule_nc / rule_tab) and an
    ``attrib_origin`` the sweep runs the attribution variant too;
    without an origin the patched rows' rule entries become -1.
    ``placed`` gets the same row scatters."""
    if not row_events:
        return
    direction = TRAFFIC_INGRESS if state.ingress else TRAFFIC_EGRESS
    # last event per row wins for the verdict sweep; all ids seen on a
    # row get their stale snapshot entries dropped
    stale_ids = {int(ident) for _r, ident, _l in row_events}
    final: Dict[int, Tuple[int, bool]] = {}
    for row, ident, live in row_events:
        final[int(row)] = (int(ident), bool(live))

    for snap in state.snapshots:
        for key in [k for k in snap.entries if k.identity in stale_ids]:
            del snap.entries[key]

    rows = sorted(final)
    live_rows = [r for r in rows if final[r][1]]
    dev = device.sel_match.device
    if live_rows:
        seg_subj: List[int] = []
        seg_port: List[int] = []
        seg_proto: List[int] = []
        seg_l4: List[bool] = []
        seg_col: List[int] = []
        col = 0
        for e, ep_row in enumerate(state.ep_rows):
            seg_subj.append(int(ep_row))
            seg_port.append(0)
            seg_proto.append(0)
            seg_l4.append(False)
            seg_col.append(col)
            col += 1
            for port, proto in state.ep_slots[e]:
                seg_subj.append(int(ep_row))
                seg_port.append(port)
                seg_proto.append(proto)
                seg_l4.append(True)
                seg_col.append(col)
                col += 1
        n_seg = len(seg_subj)
        k = len(live_rows)
        # fit the verdict block to the sweep: a single-identity patch is
        # n_seg·k ≈ E·(1+slots) flows, far under a full sweep's block
        block = min(_PATCH_BLOCK, max(64, _seg_bucket(n_seg * k)))

        def lanes(vals, dtype):
            return torch.from_numpy(np.repeat(np.asarray(vals, dtype), k)).to(dev)

        sweep_args = (
            device,
            lanes(seg_subj, np.int32),
            torch.from_numpy(np.tile(np.asarray(live_rows, np.int32), n_seg)).to(dev),
            lanes(seg_port, np.int32),
            lanes(seg_proto, np.int32),
            lanes(seg_l4, bool),
        )
        rl = None
        if state.rule_nc is not None and attrib_origin is not None:
            v, at, _hits = verdict_batch(
                *sweep_args, ingress=state.ingress, block=block, attrib=True,
                origin=attrib_origin, n_rules=n_rules,
            )
            rl = at.rule.cpu().numpy().reshape(n_seg, k)
        else:
            v = verdict_batch(*sweep_args, ingress=state.ingress, block=block)
        dec = v.decision.cpu().numpy().reshape(n_seg, k)
        l3d = v.l3.cpu().numpy().reshape(n_seg, k)
        red = v.l7_redirect.cpu().numpy().reshape(n_seg, k)

    for r in rows:
        state.allow_nc[r] = False
        state.red_nc[r] = False
        if state.rule_nc is not None:
            state.rule_nc[r] = -1

    if live_rows:
        row_pos = {r: i for i, r in enumerate(live_rows)}
        seg_i = 0
        for e in range(len(state.ep_rows)):
            snap = state.snapshots[e]
            # the endpoint's L3 allow, for the exact-entry condition
            l3_allow = l3d[seg_i] == 1
            ci = seg_col[seg_i]
            for r in live_rows:
                i = row_pos[r]
                allowed = l3_allow[i]
                state.allow_nc[r, ci] = allowed
                if rl is not None:
                    state.rule_nc[r, ci] = rl[seg_i, i]
                if allowed:
                    snap.entries[PolicyKey(final[r][0], 0, 0, direction)] = 0
            seg_i += 1
            for port, proto in state.ep_slots[e]:
                ci = seg_col[seg_i]
                for r in live_rows:
                    i = row_pos[r]
                    allowed = dec[seg_i, i] == ALLOW
                    redir = bool(red[seg_i, i])
                    state.allow_nc[r, ci] = allowed
                    state.red_nc[r, ci] = allowed and redir
                    if rl is not None:
                        state.rule_nc[r, ci] = rl[seg_i, i]
                    if allowed and (not l3_allow[i] or redir):
                        snap.entries[PolicyKey(final[r][0], port, proto, direction)] = int(redir)
                seg_i += 1

    idx_np = np.asarray(rows, np.int64)
    idx = torch.from_numpy(idx_np).to(dev)
    comb_rows = _words(
        _pack_rows(np.concatenate([state.allow_nc[idx_np], state.red_nc[idx_np]], axis=1)), dev)
    state.tables = dataclasses.replace(
        state.tables, id_bits=_patch_bitmap_rows(state.tables.id_bits, idx, comb_rows)
    )
    if placed is not None:
        # the same scatter onto the placed copies: they stay placed
        placed.tables = dataclasses.replace(
            placed.tables, id_bits=patch_placed_rows(placed.tables.id_bits, idx, comb_rows))
    if state.rule_nc is not None and state.rule_tab is not None:
        rvals = torch.from_numpy(np.ascontiguousarray(state.rule_nc[idx_np])).to(dev)
        state.rule_tab = _patch_bitmap_rows(state.rule_tab, idx, rvals)
        if placed is not None and placed.rule_tab is not None:
            placed.rule_tab = patch_placed_rows(placed.rule_tab, idx, rvals)


def patch_endpoints_state(
    state: MaterializedState,
    compiled: CompiledPolicy,
    device: DevicePolicy,
    touched_sids: Sequence[int],
    *,
    attrib_origin: Optional[AttribTables] = None,
    n_rules: int = 0,
    placed: Optional[PlacedTables] = None,
) -> bool:
    """O(delta) column re-materialization for a rule append/delete.

    Every verdict term is gated on the SUBJECT selector, so a rule delta
    can only change policymap cells in the columns of endpoints whose
    identity matches one of the rule's subject selectors
    (``touched_sids``, from the engine's delta log). Re-sweep exactly
    those endpoints' column segments against the already-patched device
    tables and scatter the changed id_bits words / rule_tab columns —
    O(affected · N) instead of E × N.

    Returns False when the delta is not expressible as a column patch
    and the caller must call ``materialize_endpoints_state``: the row
    capacity moved, attribution state mismatched, or an affected
    endpoint's slot set GREW (new columns). Shrunken slot sets keep
    their stale columns, which re-sweep to the now-denied values.
    Snapshots of affected endpoints are rebuilt in place. ``placed``
    gets the same column scatters."""
    n = compiled.id_bits.shape[0]
    if state.allow_nc.shape[0] != n:
        return False  # row-bucket crossing — full rebuild
    if (state.rule_nc is not None) != (attrib_origin is not None):
        return False
    sids = sorted({int(s) for s in touched_sids})
    n_ep = len(state.ep_rows)
    if not sids or n_ep == 0:
        return True
    if any(s >> 5 >= device.sel_match.shape[1] for s in sids):
        return False  # selector axis outgrew the device tables

    # Affected endpoints: subject row matches any touched selector. The
    # bounded [E, S/32] pull of the endpoint rows is the path's only
    # read of sel_match (never the [N, S/32] matrix).
    dev = device.sel_match.device
    ep_sel = (
        sel_rows(device.sel_match, torch.from_numpy(state.ep_rows.astype(np.int64)).to(dev))
        .cpu().numpy().view(np.uint32)
    )
    word = np.asarray([s >> 5 for s in sids])
    bit = np.asarray([s & 31 for s in sids], np.uint32)
    hit = ((ep_sel[:, word] >> bit[None, :]) & 1).astype(bool).any(axis=1)
    affected = np.nonzero(hit)[0]
    if affected.size == 0:
        return True  # no local endpoint matches the rule's subject

    # canonical column offsets: one L3 column then one per slot,
    # endpoint-major
    col_of = np.zeros(n_ep + 1, np.int64)
    for e in range(n_ep):
        col_of[e + 1] = col_of[e] + 1 + len(state.ep_slots[e])
    if int(col_of[n_ep]) != state.n_cols:
        return False

    # slot-layout guard: the patch reuses the existing columns
    for e in affected:
        if not set(_endpoint_slots(compiled, ep_sel[e], state.ingress)) <= set(state.ep_slots[e]):
            return False

    segs: List[Tuple[int, int, int, bool]] = []
    for e in affected:
        row = int(state.ep_rows[e])
        segs.append((row, 0, 0, False))
        segs += [(row, port, proto, True) for port, proto in state.ep_slots[e]]
    allow_sn, l3_sn, red_sn, rule_sn = _sweep_segments(
        device,
        np.asarray([x[0] for x in segs], np.int32),
        np.asarray([x[1] for x in segs], np.int32),
        np.asarray([x[2] for x in segs], np.int32),
        np.asarray([x[3] for x in segs], bool),
        n,
        ingress=state.ingress,
        block=_PATCH_BLOCK,
        attrib_origin=attrib_origin,
        n_rules=n_rules,
    )

    live = compiled.row_live
    direction = TRAFFIC_INGRESS if state.ingress else TRAFFIC_EGRESS
    touched_cols: List[int] = []
    seg = 0
    for e in affected:
        snap = state.snapshots[e]
        l3_allow = l3_sn[seg] & live
        ci = int(col_of[e])
        state.allow_nc[:, ci] = l3_allow
        state.red_nc[:, ci] = False
        if state.rule_nc is not None:
            state.rule_nc[:, ci] = rule_sn[seg]
        touched_cols.append(ci)
        seg += 1
        entries: Dict[PolicyKey, int] = {}
        for r_idx in np.nonzero(l3_allow)[0]:
            entries[PolicyKey(int(compiled.row_ids[r_idx]), 0, 0, direction)] = 0
        for j, (port, proto_n) in enumerate(state.ep_slots[e]):
            allow = allow_sn[seg] & live
            redirect = red_sn[seg] & live
            cj = ci + 1 + j
            state.allow_nc[:, cj] = allow
            state.red_nc[:, cj] = redirect
            if state.rule_nc is not None:
                state.rule_nc[:, cj] = rule_sn[seg]
            touched_cols.append(cj)
            seg += 1
            for r_idx in np.nonzero(allow & (~l3_allow | redirect))[0]:
                entries[PolicyKey(int(compiled.row_ids[r_idx]), port, proto_n, direction)] = int(
                    redirect[r_idx])
        # in place: holders of the snapshot dict see the update
        snap.entries.clear()
        snap.entries.update(entries)

    # Device scatter of only the packed words the touched columns live
    # in. Allow word w holds columns 32w..32w+31; the redirect copy of
    # word w sits c_pad/32 words later (id_bits = allow ‖ redirect).
    c_pad = state.allow_nc.shape[1]
    word_idx: List[int] = []
    word_vals: List[np.ndarray] = []
    for w in sorted({c >> 5 for c in touched_cols}):
        cols = slice(w * 32, min((w + 1) * 32, c_pad))
        word_idx.append(w)
        word_vals.append(_pack_col_word(state.allow_nc[:, cols]))
        word_idx.append(c_pad // 32 + w)
        word_vals.append(_pack_col_word(state.red_nc[:, cols]))
    widx = torch.from_numpy(np.asarray(word_idx, np.int64)).to(dev)
    wvals = _words(np.stack(word_vals, axis=1), dev)
    state.tables = dataclasses.replace(
        state.tables, id_bits=patch_bitmap_cols(state.tables.id_bits, widx, wvals))
    if placed is not None:
        placed.tables = dataclasses.replace(
            placed.tables, id_bits=patch_placed_cols(placed.tables.id_bits, widx, wvals))
    if state.rule_nc is not None and state.rule_tab is not None:
        ridx = torch.from_numpy(np.asarray(touched_cols, np.int64)).to(dev)
        rvals = torch.from_numpy(np.ascontiguousarray(state.rule_nc[:, touched_cols])).to(dev)
        state.rule_tab = patch_bitmap_cols(state.rule_tab, ridx, rvals)
        if placed is not None and placed.rule_tab is not None:
            placed.rule_tab = patch_placed_cols(placed.rule_tab, ridx, rvals)
    return True


# -- sparse sel_match patching ----------------------------------------------
#
# The engine keeps the authoritative device sel_match; under a 2D plan the
# pipeline keeps an ident-sharded copy for its sweeps. These replay the
# engine's delta-log events onto that copy as O(k) scatters instead of
# re-placing the full [N, S/32] matrix: one out-of-place index op per
# shard that owns a patched row. The reference pads each scatter to a
# power of two (_pow2_rows_vals) to bound its jit cache; there is no
# compile cache here, so the port scatters the exact rows.


def _scatter_sel_rows(sel_match: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Whole rows ``rows`` [k, S/32] at ``idx`` [k], out of place
    (a batch in flight may hold the old tensor)."""
    return sel_match.index_copy(0, idx, rows)


def _scatter_sel_cols(
    sel_match: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """The cells ``rows`` [k] × ``cols`` [w] ← ``vals`` [k, w], out of
    place."""
    return sel_match.index_put((rows[:, None], cols[None, :]), vals)


def patch_selector_rows(sel_match, ident_rows: Sequence[int], row_words: np.ndarray):
    """Scatter whole packed sel_match rows (identity-churn deltas: the
    engine's ``"rows"`` events) into a device or placed copy → the
    patched copy, placed as the input was. O(k · S/32) payload."""
    rows = np.asarray(ident_rows, np.int64)
    if rows.size == 0:
        return sel_match
    vals = np.ascontiguousarray(row_words, dtype=np.uint32).view(np.int32)
    return patch_placed_rows(sel_match, torch.from_numpy(rows), torch.from_numpy(vals),
                             op=_scatter_sel_rows)


def patch_selector_cols(
    sel_match, ident_rows: Sequence[int], word_cols: Sequence[int], vals: np.ndarray
):
    """Scatter a column delta (selector appends: the engine's ``"cols"``
    events) into a device or placed sel_match copy: k touched identity
    rows × the appended selectors' word window. O(k · w) payload."""
    rows = np.asarray(ident_rows, np.int64)
    cols = np.asarray(word_cols, np.int64)
    if rows.size == 0 or cols.size == 0:
        return sel_match
    ridx = torch.from_numpy(rows)
    cidx = torch.from_numpy(cols)
    v = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.uint32).view(np.int32))

    def one(t: torch.Tensor, lo: int) -> torch.Tensor:
        own = (ridx >= lo) & (ridx < lo + t.shape[0])
        if not bool(own.any()):
            return t
        return _scatter_sel_cols(
            t, (ridx[own] - lo).to(t.device), cidx.to(t.device), v[own].to(t.device))

    return map_placed(sel_match, one)
