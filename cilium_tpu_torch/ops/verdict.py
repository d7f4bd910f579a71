"""Batched policy-verdict kernel (matmul formulation).

Evaluates the verdict semantics of pkg/policy/repository.go
AllowsIngressRLocked/AllowsEgressRLocked for a batch of flows
(subject identity row, peer identity row, dport, proto):

    deny      = any(subj ∧ ((1-peer) @ deny_matᵀ > 0))
    l3_allow  = any(subj ∧ (peer @ allow_matᵀ > 0))
    req_ok    = ¬deny                        # folded-requirements term
    combo     = (subj @ s1) ∧ (port_onehot @ p1)
    l4_allow  = any(combo ∧ peer@enᵀ) | req_ok ∧ any(combo ∧ peer@eeᵀ)
    l7_present= any((subj @ s7) ∧ (port @ p7) ∧ (group_ok @ g7))
    verdict   = ALLOW  if l3_allow ∧ ¬deny
              | ALLOW  if flow has L4 context ∧ l4_allow
              | DENY   otherwise

Per flow the only data-dependent access is one packed row gather from
``sel_match``; every relation product is :func:`bool_mm`, which on a
CUDA tensor launches the ``bool_mm`` kernel (csrc/bool_mm.cu) and on a
CPU tensor runs :func:`bool_mm_plain`.

With ``attrib=True`` the block also returns the attribution: the
first-match rule of each deciding term (three row reductions in one
launch of the ``first_rule`` kernel, csrc/first_rule.cu:
:func:`first_rule_terms`; plain version :func:`first_rule_plain` per
term), the decider select and the ATTR_* reason
codes, and :func:`verdict_batch` adds the [n_rules] rule-hit counts.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _kernels
from ..compiler.program import DirectionProgram
from ..policy.search import Decision
from .bitmap import unpack_bits_u32

if TYPE_CHECKING:
    from .lookup import IdentSharded

ALLOW = int(Decision.ALLOWED)
DENY = int(Decision.DENIED)

# -- verdict attribution (policyd-flows) ---------------------------------
# Per-flow attribution reason codes emitted by the attrib=True kernel
# variant. These classify WHICH term decided the flow; the pipeline maps
# them onto the monitor's DropNotify reason taxonomy
# (monitor/events.py REASON_POLICY_*).
ATTR_ALLOW = 0  # allowed (rule = the first-match allowing rule)
ATTR_DENY_RULE = 1  # an explicit deny (FromRequires) rule matched
ATTR_NO_L3 = 2  # dropped: no L3 allow covered the peer
ATTR_NO_L4 = 3  # dropped: L4 coverage existed, peer not allowed
ATTR_L7 = 4  # allowed via a parser-bearing filter (proxy redirect)

ATTR_NAMES = {
    ATTR_ALLOW: "allowed",
    ATTR_DENY_RULE: "deny-rule",
    ATTR_NO_L3: "no-l3-match",
    ATTR_NO_L4: "no-l4-match",
    ATTR_L7: "l7-redirect",
}

# Sentinel for "no rule contributes to this term" in the origin arrays
# (min-reduction identity; converted to -1 in the per-flow output).
NO_RULE = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class AttribTables:
    """Term→rule origin arrays for the attribution kernel variant:
    the FIRST (lowest-index) repository rule contributing each deny
    subject-selector, pure-L3-allow subject-selector, and L4 combo —
    first-contributing-rule-wins mirrors the reference's in-order rule
    walk. Entries with no contributing rule hold ``NO_RULE``. Built by
    ``compiler.program.rule_origin_arrays``."""

    deny_rule: torch.Tensor  # [S] int32
    allow_rule: torch.Tensor  # [S] int32
    combo_rule: torch.Tensor  # [K1] int32


@dataclasses.dataclass(frozen=True)
class Attribution:
    """Per-flow attribution (attrib=True only). ``rule``: repository
    rule index that decided the flow (-1 = no rule — a no-match drop).
    ``reason``: ATTR_* code."""

    rule: torch.Tensor  # [B] int32
    reason: torch.Tensor  # [B] int8


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Per-flow results. ``decision``: 1 allow / 2 deny. ``l3`` is the
    pure-L3 stage decision (0 undecided / 1 allowed / 2 denied) used by
    the policymap materializer; ``l7_redirect`` flags flows whose L4
    allow passes through a parser-bearing filter (proxy redirect)."""

    decision: torch.Tensor  # [B] int8
    l3: torch.Tensor  # [B] int8
    l7_redirect: torch.Tensor  # [B] bool


def _t(a: np.ndarray, device) -> torch.Tensor:
    # a copy even on the CPU: the packers patch their matrices in place
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """DirectionProgram matrices as tensors. Transposed copies of the
    peer-side relations are stored so every product runs with the
    contracted axis leading."""

    deny_t: torch.Tensor  # [S, S] int8  deny_matᵀ
    allow_t: torch.Tensor  # [S, S] int8  allow_matᵀ
    ports: torch.Tensor  # [P4] int32
    protos: torch.Tensor  # [P4] int32
    s1_mat: torch.Tensor  # [S, K1] int8
    p1_mat: torch.Tensor  # [P4, K1] int8
    en_t: torch.Tensor  # [S, K1] int8  en_matᵀ
    ee_t: torch.Tensor  # [S, K1] int8  ee_matᵀ
    gpn_mat: torch.Tensor  # [S, G] int8
    gpe_mat: torch.Tensor  # [S, G] int8
    group_no_peers: torch.Tensor  # [G] bool
    s7_mat: torch.Tensor  # [S, K7] int8
    p7_mat: torch.Tensor  # [P4, K7] int8
    g7_mat: torch.Tensor  # [G, K7] int8

    @classmethod
    def from_host(cls, d: DirectionProgram, device=None) -> "DeviceTables":
        """``d``'s matrices on ``device`` (None = the card)."""
        device = _kernels.resolve_device(device)
        return cls(
            deny_t=_t(d.deny_mat.T, device),
            allow_t=_t(d.allow_mat.T, device),
            ports=_t(d.ports.astype(np.int32), device),
            protos=_t(d.protos.astype(np.int32), device),
            s1_mat=_t(d.s1_mat, device),
            p1_mat=_t(d.p1_mat, device),
            en_t=_t(d.en_mat.T, device),
            ee_t=_t(d.ee_mat.T, device),
            gpn_mat=_t(d.gpn_mat, device),
            gpe_mat=_t(d.gpe_mat, device),
            group_no_peers=_t(d.group_no_peers.astype(bool), device),
            s7_mat=_t(d.s7_mat, device),
            p7_mat=_t(d.p7_mat, device),
            g7_mat=_t(d.g7_mat, device),
        )


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    """Compiled policy resident on one device."""

    id_bits: torch.Tensor  # [N, W] int32 (uint32 bit view)
    # [N, S/32] int32 (packed selector matches); under a 2D plan the
    # pipeline's sweeps get an ident-sharded copy. Read rows with
    # sel_rows: on an IdentSharded copy it launches ident_gather.
    sel_match: Union[torch.Tensor, "IdentSharded"]
    ingress: DeviceTables
    egress: DeviceTables


def sel_rows(sel_match, idx) -> torch.Tensor:
    """The rows ``idx`` (an index tensor or a slice) of a sel_match.
    A tensor is indexed; an ident-sharded copy (``lookup.IdentSharded``)
    is read through ``lookup.ident_gather_rows``: one ``ident_gather``
    kernel launch per device its shards lie on."""
    if isinstance(sel_match, torch.Tensor):
        return sel_match[idx]
    from .lookup import ident_gather_rows  # lookup imports this module

    if isinstance(idx, slice):
        idx = torch.arange(*idx.indices(sel_match.shape[0]), device=sel_match.device)
    return ident_gather_rows(sel_match, idx.to(torch.int32))


def _as_int8(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int8) if x.dtype == torch.bool else x


def bool_mm_plain(
    x: torch.Tensor, w: torch.Tensor, complement_x: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the ``bool_mm`` kernel: int8 [B, A] @
    int8 [A, C] > 0 as a float64 product (exact: |sum| < 2**53)."""
    x = _as_int8(x)
    if complement_x:
        x = 1 - x
    return (x.to(torch.float64) @ _as_int8(w).to(torch.float64)) > 0


def bool_mm(
    x: torch.Tensor, w: torch.Tensor, complement_x: bool = False
) -> torch.Tensor:
    """int8 [B, A] @ int8 [A, C] → bool [B, C] (int32 accumulate, > 0).
    With ``complement_x`` the left operand is ``1 - x``."""
    dev = _kernels.dispatch_device(x, w)
    if dev.type == "cpu":
        return bool_mm_plain(x, w, complement_x)
    x = _as_int8(x).contiguous()
    w = _as_int8(w).contiguous()
    b, a = x.shape
    a2, c = w.shape
    if a != a2 or x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"bool_mm: bad operands {tuple(x.shape)} {x.dtype} @ {tuple(w.shape)} {w.dtype}")
    out = torch.empty((b, c), dtype=torch.bool, device=dev)
    _kernels.check_cuda("bool_mm", dev, x, w, out)
    _kernels.KERNELS["bool_mm"].launch(
        dev, x.data_ptr(), w.data_ptr(), out.data_ptr(), b, a, c, int(complement_x)
    )
    return out


def first_rule_plain(mask: torch.Tensor, rule_of: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``first_rule`` kernel: bool [B, S],
    int32 [S] → [B] int32 min of ``rule_of`` where ``mask`` holds,
    NO_RULE for a row with no set cell."""
    if mask.shape[1] == 0:
        return torch.full((mask.shape[0],), NO_RULE, dtype=torch.int32, device=mask.device)
    cand = torch.where(mask, rule_of.to(torch.int32)[None, :], NO_RULE)
    return cand.min(dim=1).values.to(torch.int32)


def first_rule_terms_plain(
    terms: Sequence[Tuple[torch.Tensor, torch.Tensor]],
) -> List[torch.Tensor]:
    """Plain PyTorch version of a multi-term ``first_rule`` launch:
    :func:`first_rule_plain` on each ``(mask, rule_of)`` term."""
    return [first_rule_plain(mask, rule_of) for mask, rule_of in terms]


def first_rule_terms(terms: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """First-match rules of one to three terms over the same rows, in
    one ``first_rule`` kernel launch: per term ``(mask [B, S_k] bool,
    rule_of [S_k])`` the [B] int32 lowest ``rule_of[s]`` over the set
    cells of each row (NO_RULE when none is set)."""
    if not 1 <= len(terms) <= _kernels.FIRST_RULE_MAX_TERMS:
        raise ValueError(f"first_rule: {len(terms)} terms, the kernel takes 1 to "
                         f"{_kernels.FIRST_RULE_MAX_TERMS}")
    dev = _kernels.dispatch_device(*(x for term in terms for x in term))
    if dev.type == "cpu":
        return first_rule_terms_plain(terms)
    b = terms[0][0].shape[0]
    lst = _kernels.FirstRuleTerms()
    keep, outs = [], []  # each term's operands live until the launch
    for k, (mask, rule_of) in enumerate(terms):
        if mask.dtype != torch.bool or mask.dim() != 2 or mask.shape[0] != b or \
                rule_of.shape != (mask.shape[1],):
            raise ValueError(f"first_rule: bad operands {tuple(mask.shape)} {mask.dtype}, "
                             f"{tuple(rule_of.shape)} (rows {b})")
        m = _kernels.operand(mask, torch.bool)
        r = _kernels.operand(rule_of, torch.int32)
        out = torch.empty(b, dtype=torch.int32, device=dev)
        _kernels.check_cuda("first_rule", dev, m, r, out)
        lst.mask[k], lst.rule_of[k], lst.out[k] = m.data_ptr(), r.data_ptr(), out.data_ptr()
        lst.width[k] = m.shape[1]
        keep += [m, r]
        outs.append(out)
    lst.n = len(terms)
    _kernels.KERNELS["first_rule"].launch(dev, lst, b)
    return outs


def first_rule(mask: torch.Tensor, rule_of: torch.Tensor) -> torch.Tensor:
    """First-match rule of a term: per row the lowest ``rule_of[s]``
    over the set cells of ``mask`` (NO_RULE when none is set); a
    one-term :func:`first_rule_terms`."""
    return first_rule_terms([(mask, rule_of)])[0]


def _verdict_block(
    sel_match,  # [N, S/32] int32, or an ident-sharded copy (see sel_rows)
    t: DeviceTables,
    subj_rows: torch.Tensor,
    peer_rows: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    has_l4: torch.Tensor,
    origin: Optional[AttribTables] = None,
):
    subj8 = unpack_bits_u32(sel_rows(sel_match, subj_rows.long()))  # [b, S]
    peer8 = unpack_bits_u32(sel_rows(sel_match, peer_rows.long()))
    subj_b = subj8.to(torch.bool)

    deny_vec = subj_b & bool_mm(peer8, t.deny_t, complement_x=True)  # [b, S]
    allow_vec = subj_b & bool_mm(peer8, t.allow_t)
    deny = deny_vec.any(dim=1)
    l3_allow = allow_vec.any(dim=1)
    req_ok = ~deny

    pp = (
        (dport[:, None] == t.ports[None, :])
        & (proto[:, None] == t.protos[None, :])
        & has_l4[:, None]
    ).to(torch.int8)

    combo = bool_mm(subj8, t.s1_mat) & bool_mm(pp, t.p1_mat)  # [b, K1]
    en_hit = combo & bool_mm(peer8, t.en_t)
    ee_hit = combo & bool_mm(peer8, t.ee_t)
    l4_allow = en_hit.any(dim=1) | (req_ok & ee_hit.any(dim=1))

    group_ok = (
        bool_mm(peer8, t.gpn_mat)
        | (bool_mm(peer8, t.gpe_mat) & req_ok[:, None])
        | t.group_no_peers[None, :]
    )  # [b, G]
    l7_present = (
        bool_mm(subj8, t.s7_mat)
        & bool_mm(pp, t.p7_mat)
        & bool_mm(group_ok, t.g7_mat)
    ).any(dim=1)

    l3 = torch.where(deny, 2, torch.where(l3_allow, 1, 0)).to(torch.int8)
    decision = torch.where(
        l3_allow & ~deny, ALLOW, torch.where(has_l4 & l4_allow, ALLOW, DENY)
    ).to(torch.int8)
    # Datapath redirect semantics (bpf/lib/policy.h lookup order: the
    # exact {id,port,proto} entry wins over the L3-only entry): a flow
    # allowed at L4 through a parser-bearing filter redirects even when
    # L3 also allows it.
    l7_redirect = has_l4 & l4_allow & l7_present
    verdict = Verdict(decision=decision, l3=l3, l7_redirect=l7_redirect)
    if origin is None:
        return verdict

    # -- attribution (policyd-flows): first-match rule + reason ----------
    # Masked min over the pre-reduction term vectors picks the LOWEST
    # repository rule index whose cell fired — the reference's in-order
    # rule walk stops at the first decider.
    combo_fired = en_hit | (req_ok[:, None] & ee_hit)  # [b, K1]
    deny_rule, allow_rule, l4_rule = first_rule_terms(
        [(deny_vec, origin.deny_rule), (allow_vec, origin.allow_rule),
         (combo_fired, origin.combo_rule)])

    # Attribute by what actually DECIDED: pure-L3 allow wins over the
    # L4 path (repository walk order); a deny only decides when the
    # flow really dropped (an en-side L4 entry can allow past a deny).
    allowed = decision == ALLOW
    l3_decides = l3_allow & ~deny
    rule = torch.where(
        allowed,
        torch.where(l3_decides, allow_rule, l4_rule),
        torch.where(deny, deny_rule, NO_RULE),
    )
    rule = torch.where(rule == NO_RULE, -1, rule).to(torch.int32)

    # Drop refinement: with L4 context and any combo covering the
    # subject at this port, the peer was the missing half (no-L4);
    # otherwise nothing covered the flow at all (no-L3).
    l4_covered = has_l4 & combo.any(dim=1)
    dropped = decision == DENY
    reason = torch.where(
        dropped,
        torch.where(deny, ATTR_DENY_RULE, torch.where(l4_covered, ATTR_NO_L4, ATTR_NO_L3)),
        torch.where(l7_redirect, ATTR_L7, ATTR_ALLOW),
    ).to(torch.int8)
    return verdict, Attribution(rule=rule, reason=reason)


def rule_hits(rule: torch.Tensor, n_rules: int) -> torch.Tensor:
    """[max(n_rules, 1)] int32 count of flows per attributed rule; a
    rule index past the last lands in the last cell, -1 counts nowhere
    (the clipped segment-sum of the reference)."""
    valid = rule >= 0
    idx = rule.long().clamp(0, max(n_rules - 1, 0))
    return torch.bincount(idx[valid], minlength=max(n_rules, 1)).to(torch.int32)


def verdict_batch(
    policy: DevicePolicy,
    subj_rows: torch.Tensor,  # [B] int32 identity rows
    peer_rows: torch.Tensor,  # [B] int32
    dport: torch.Tensor,  # [B] int32 (with has_l4)
    proto: torch.Tensor,  # [B] int32 IANA proto (u8proto)
    has_l4: torch.Tensor,  # [B] bool — False = pure-L3 query
    ingress: bool = True,
    block: int = 8192,
    attrib: bool = False,
    origin: Optional[AttribTables] = None,
    n_rules: int = 0,
):
    """Batch verdicts, ``block`` flows at a time to bound the
    [block, S] intermediates. With ``attrib=True`` (and the rule
    ``origin`` tables) → ``(Verdict, Attribution, hits)``, ``hits`` the
    [n_rules] int32 per-rule hit counts."""
    if attrib and origin is None:
        raise ValueError("verdict_batch(attrib=True) needs the rule origin tables")
    t = policy.ingress if ingress else policy.egress
    b = subj_rows.shape[0]
    parts = [
        _verdict_block(
            policy.sel_match, t, subj_rows[lo:lo + block], peer_rows[lo:lo + block],
            dport[lo:lo + block], proto[lo:lo + block], has_l4[lo:lo + block],
            origin=origin if attrib else None,
        )
        for lo in range(0, b, block)
    ]
    dev = subj_rows.device

    def cat(xs, dtype):
        return torch.cat(xs) if xs else torch.zeros(0, dtype=dtype, device=dev)

    verdicts = [p[0] for p in parts] if attrib else parts
    verdict = Verdict(
        decision=cat([v.decision for v in verdicts], torch.int8),
        l3=cat([v.l3 for v in verdicts], torch.int8),
        l7_redirect=cat([v.l7_redirect for v in verdicts], torch.bool),
    )
    if not attrib:
        return verdict
    attribution = Attribution(
        rule=cat([p[1].rule for p in parts], torch.int32),
        reason=cat([p[1].reason for p in parts], torch.int8),
    )
    return verdict, attribution, rule_hits(attribution.rule, n_rules)[:n_rules]
