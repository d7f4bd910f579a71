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

Every batch enters through :meth:`DatapathPipeline.submit` /
``submit_v6``, which return a :class:`PendingBatch`; ``process`` /
``process_v6`` are ``submit(...).result()``. The enqueue half stages
the flows in pinned host buffers, copies them to the card and launches
the kernels on the current stream, all without waiting; the completion
half waits on one CUDA event recorded after the copies back, then runs
the counters, conntrack creation, the redirect hook and the metrics.
Up to ``pipeline_depth`` batches wait un-pulled, and they complete in
FIFO order. Device-CT batches run synchronously.

With ``admission`` the submit path is gated by an AIMD queue limit
(datapath/admission.py). A batch over budget first sheds, with
``prefilter_shed`` on, its deny-for-sure flows through one
``shed_walk`` kernel launch (DROP_PREFILTER, never queued), then
waits for the queue up to ``deadline_ms``, and resolves what is left
through the fail-open / fail-closed semantics when that runs out.

:meth:`DatapathPipeline.rebuild` follows the engine's delta log
(``PolicyEngine.deltas_since``): identity churn patches the changed
identity rows of both directions' policymaps (one verdict re-sweep of
those rows against every endpoint column, on ``bool_mm``), and a rule
append or delete re-sweeps only the columns of the endpoints its
subject selectors match (``ops/materialize.py`` ``patch_identity_rows``
/ ``patch_endpoints_state``). Every patch replaces the device tensor
it changes (out of place), so a batch in flight keeps the tables it
was enqueued with.

With ``sparse_deltas`` an ipcache move that is the only trie trigger
patches the identity tries through their host mirrors
(``ops/lpm.py`` ``PatchableFlatTrie`` / ``PatchableElidedTrie``): only
the dirty node rows and dense spans are uploaded, again out of place.
With ``epoch_swap`` a delta the patches cannot express re-materializes
on a shadow thread (on its own CUDA stream on the card) while batches
keep the current generation; the next rebuild after the install
publishes the new one.

With ``sharding`` (and ``mesh_2d``) the pipeline places its tables on
the plan ``datapath/placement.py`` resolves over the visible devices: a
batch splits over the grid's ``flows`` axis, each flow shard runs on
its grid row's first device against tables replicated there (the tries,
the shed table, the policymaps and rule tables), and on a 2D plan the
identity tables row-shard over the ``ident`` axis. A batch's policymap
lookup then reads each row in place from its shard, one launch a flow
shard, when the grid row's shards lie on its device (one card's grid;
``ops/lookup.py`` ``policymap_verdict_gathered``); otherwise, and for
the materializer sweeps' ``sel_match`` reads, a row fetch runs the
``ident_gather`` kernel once per device over the shards there, adding
partials only across devices (``ident_gather_rows``). The device-CT
path keeps the unplaced tables on the pipeline's device.

Every batch runs under the failsafe (the reference's
policyd-failsafe): a fault at a named site (``faults.SITE_H2D``,
``SITE_DISPATCH``, ``SITE_COMPLETE``, ``SITE_CT_EPOCH``) or a real
exception is classified. A transient one retries, bounded; a poisoned
one, or a transient one past its retries, quarantines the batch: a
DROP_DEGRADED result for every flow (FORWARD under FailOpen), the CT
epoch advanced and the device CT rescued into the host table. A
programmer error, and a kernel that failed to build, load or launch
(``_kernels.KernelError``), reach the caller raw. Quarantines trip a
breaker that walks the ladder sharded → single-device → host (numpy
verdicts from the host ipcache and the policymap's host copy), and a
clean streak climbs back one level at a time. With ``stall_ms`` the
watchdog (datapath/admission.py ``Watchdog``) abandons a completion
that waits longer than that through the same quarantine, and counts a
full sweep that outlasts it as a ``compile`` stall.

Every batch can be watched without changing what it computes: the
span tracer (``tracer``, observe/tracer.py) times the phases of
``contracts.TRACE_PHASES`` of a batch from its submit to its
completion; the device profiler (``set_profiling``,
observe/profiler.py) splits every Nth dispatch into h2d / device
compute / d2h, on the card by CUDA events recorded on the batch's own
stream and read after its completion wait (no added synchronization),
on the CPU by ``time.perf_counter``; and the depth tuner
(``set_autotune``, datapath/tuner.py) moves ``pipeline_depth`` from the
enqueue and completion halves' clocks. Off, each costs one attribute
read a batch.

Every path's completion, the device-CT path's and the admission gate's
included, reports its flows as events (monitor/events.py) to the
``monitor`` hub while it has a listener: a DropNotify a dropped flow,
and, when asked for, a TraceNotify a forwarded one and a
PolicyVerdictNotify a flow, in flow order; with attribution on, the
flow ring (observe/flows.py) records a sample of at most ``SAMPLE_CAP``
flows a batch. Both read only the host arrays the batch already holds:
no transfer is added, and with no listener and attribution off a batch
builds no event and no peer address bytes.

Across a restart (the reference's policyd-survive): a caller that
restored a CT snapshot (datapath/ct_snapshot.py) into the host table,
and verified its basis against the restored compiled snapshot, sets
``_ct_restore_hold`` to the engine's revision. The next rebuild's CT
flush triggers, the basis move and the LB move, both keep the table
(and the device CT) if that rebuild materializes the same revision,
and the hold is spent after both have seen it. ``on_first_batch`` is a
one-shot hook the first completed batch fires (the restart-downtime
stamp); its exception never fails the batch.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import threading
import time
from collections import deque
from itertools import repeat
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .. import faults as _faults
from .. import metrics as _metrics
from ..compiler.selectors import selector_word_window
from ..contracts import PIPELINE_DEPTH_MAX, PIPELINE_DEPTH_MIN
from ..convert import shed_table_from_numpy, v6_tables_from_numpy, wide_tables_from_numpy
from ..utils.backoff import Backoff
from . import placement as _placement
from .admission import (
    REASON_SHED_DEADLINE, REASON_SHED_PREFILTER, AdmissionController, Watchdog,
    compile_shed_table,
)
from .conntrack import CT_NEW, CT_REPLY, FlowConntrack, pack_keys
from .device_ct import (
    DeviceCTState, _i32, _u32, ct_step_verdict, make_state, pack_kc_words, pull_live_entries,
    seed_state_from_host,
)
from ..engine import PolicyEngine
from ..identity.model import ID_WORLD
from ..ipcache.ipcache import IPCache
from ..ipcache.prefilter import PreFilter
from ..lb.device import flow_hash32, lb_translate
from ..monitor.events import (
    REASON_NO_SERVICE, REASON_PIPELINE_DEGRADED, REASON_POLICY, REASON_POLICY_DENY,
    REASON_POLICY_NO_L3, REASON_POLICY_NO_L4, REASON_PREFILTER, REASON_PROXY_REDIRECT,
    REASON_UNKNOWN, TRACE_TO_ENDPOINT, TRACE_TO_PROXY, DropNotify, PolicyVerdictNotify,
    TraceNotify, reason_name,
)
from ..observe import flows as _flows
from ..observe.flows import SAMPLE_CAP as _FLOW_SAMPLE_CAP, FlowRecord, FlowRing
from ..observe.tracer import NOOP_BATCH as _NOOP_BATCH, Tracer
from ..ops.lookup import (
    PolicymapTables, Replicated, policymap_verdict, policymap_verdict_gathered, replicate,
    replicate_tables, shard_rows, shard_tables_ident, tables_on,
)
from ..ops.lpm import (
    DENY_BIT, MERGED_VALUE_MASK, PatchableElidedTrie, build_trie_elided, build_wide_trie,
    elided_lookup, ipv4_to_bytes, lpm_lookup_wide, make_patchable_wide, merge_flat_tries,
    merge_trie_entries, place_table,
)
from ..ops.materialize import (
    TRAFFIC_EGRESS, TRAFFIC_INGRESS, EndpointPolicySnapshot, PlacedTables,
    materialize_endpoints_state, patch_endpoints_state, patch_identity_rows, patch_selector_cols,
    patch_selector_rows,
)
from ..ops.shed import shed_walk_stride8, shed_walk_wide
from .placement import EMPTY_PLAN, MeshPlan, PlacementConfig, resolve_plan
from .tuner import DepthTuner

FORWARD = 1
DROP_POLICY = 2
DROP_PREFILTER = 3
DROP_NO_SERVICE = 4  # frontend matched but zero backends (lb4_local)
# the pipeline could not verdict this flow and FailOpen is off: the
# fail-closed deny (monitor reason 155)
DROP_DEGRADED = 5

# verdict code → metrics outcome label (metricsmap REASON strings)
_OUTCOME_NAMES = (
    (FORWARD, "forwarded"),
    (DROP_POLICY, "dropped_policy"),
    (DROP_PREFILTER, "dropped_prefilter"),
    (DROP_NO_SERVICE, "dropped_no_service"),
    (DROP_DEGRADED, "dropped_degraded"),
)

# degradation-ladder levels (policyd-failsafe): index = ladder level.
# Level 0 is the full device complement (sharded over the plan's grid
# when VerdictSharding is on), 1 re-forms the plan on one device, 2
# verdicts on host numpy.
_MODE_NAMES = ("sharded", "single-device", "host")


def _classify(exc: BaseException) -> str:
    """``faults.classify`` with one more programmer error: a kernel that
    could not be built, loaded or launched (``_kernels.KernelError``,
    a RuntimeError that classify would call poisoned) is raised raw,
    never retried, quarantined or served around by the ladder. Every
    guarded path of the pipeline classifies through here."""
    if isinstance(exc, _kernels.KernelError):
        return _faults.KIND_ERROR
    return _faults.classify(exc)


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
    rule_tab=None,
    n_rules: int = 0,
    ident_gather: bool = False,
):
    """Post-LPM tail shared by both families: policymap lookup,
    prefilter override, counters [EP, 3] = (forwarded, dropped_policy,
    dropped_prefilter). ``attrib=True`` appends the attribution: the
    deciding rule gathered from ``rule_tab`` (-1 = none, and -1 for a
    prefilter drop, which never reached the policymap), whether an L4
    column covered the flow, and the [max(n_rules, 1)] rule-hit
    counts. ``ident_gather=True`` (a 2D plan: ``policymap.id_bits`` and
    ``rule_tab`` ident-sharded) runs ``policymap_verdict_gathered``: one
    launch reading each row in place from its shard when the shards lie
    on the flows' device, else a row gather and a launch a block; False
    keeps the one direct policymap launch."""
    if attrib and rule_tab is None:
        raise ValueError("attribution needs the materializer's rule table")
    verdict = policymap_verdict_gathered if ident_gather else policymap_verdict
    return verdict(
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
    rule_tab=None,  # [N, C_pad] int32
    n_rules: int = 0,
    ident_gather: bool = False,
):
    """→ (verdict [B] int8, redirect [B] bool, counters [EP, 3] int32);
    with ``attrib=True`` also (rule [B] int32, l4_covered [B] bool,
    hits [max(n_rules, 1)] int32) — see _verdict_tail.

    ``peer_u32`` is the remote address of each flow: the source for
    ingress, the destination for egress. ``prefilter`` guards the XDP
    deny-trie stage. ``row_override`` carries an identity row trusted
    over the ipcache walk (the overlay path): flows with a non-negative
    row skip both the identity LPM and the prefilter. ``ident_gather``
    (a 2D plan) reads the policymap rows as ``_verdict_tail`` says."""
    denied_pf, hit = _v4_lpm_stage(t, peer_u32, prefilter)
    denied_pf, peer_row = _peer_rows(denied_pf, hit, t.world_row, row_override)
    return _verdict_tail(
        t.policymap, denied_pf, peer_row, ep_idx, dport, proto, ep_count, block,
        attrib=attrib, rule_tab=rule_tab, n_rules=n_rules, ident_gather=ident_gather,
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
    rule_tab=None,  # [N, C_pad] int32
    n_rules: int = 0,
    ident_gather: bool = False,
):
    """The stride-8 twin of :func:`process_flows_wide` (IPv6 with
    ``levels=16``): same outputs, same ``prefilter``, ``row_override``
    and attribution semantics; ``fused`` says the fused deny+identity
    trie is present, ``ident_gather`` as in process_flows_wide."""
    denied_pf, hit = _v6_lpm_stage(t, peer_bytes, levels, prefilter, fused)
    denied_pf, peer_row = _peer_rows(denied_pf, hit, t.world_row, row_override)
    return _verdict_tail(
        t.policymap, denied_pf, peer_row, ep_idx, dport, proto, ep_count, block,
        attrib=attrib, rule_tab=rule_tab, n_rules=n_rules, ident_gather=ident_gather,
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


# Backwards-compatible alias for the IPv4 path (the reference's name).
process_ipv4 = process_flows


# -- the admission gate's prefilter shed walk ---------------------------
# ONE identity LPM walk + ONE gather from the [N, 9] drop table compiled
# by admission.compile_shed_table, on the shed_walk kernel. Runs only
# from the admission gate when the queue is over budget; it skips the
# deny-trie stage and the policymap, since the table alone is
# deny-for-sure and skipping stages can only shed less. A row past the
# table sheds nothing (ops/shed.py; the reference's uint8 jnp.take
# fill of 255 sheds it).


def shed_flows_wide(
    t: WideDatapathTables,
    shed_tab: torch.Tensor,  # [N, 9] uint8 (admission.compile_shed_table)
    peer_u32: torch.Tensor,  # [B] int32 bit view of host-order peer addresses
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """→ shed [B] bool: every flagged flow is deny-for-sure under the
    current realized policy (IPv4)."""
    return shed_walk_wide(
        t.ip_root_info, t.ip_root_child, t.ip_sub_child, t.ip_sub_info, shed_tab,
        t.world_row, peer_u32, dport, proto,
    )


def shed_flows(
    t: DatapathTables,
    shed_tab: torch.Tensor,
    peer_bytes: torch.Tensor,  # [B, levels] int32 address bytes
    dport: torch.Tensor,
    proto: torch.Tensor,
    levels: int = 16,
) -> torch.Tensor:
    """IPv6 twin of :func:`shed_flows_wide` (stride-8 elided identity
    walk)."""
    return shed_walk_stride8(
        t.ip_child, t.ip_info, t.ip_common, shed_tab, t.world_row, peer_bytes, dport, proto,
        levels,
    )


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

    def bytes_at(self, idx: np.ndarray) -> np.ndarray:
        """The address bytes of the flows ``idx`` only (an IPv4 batch
        whose bytes are not built converts just those words)."""
        if self.peer_bytes is None:
            return ipv4_to_bytes(self.peer_u32[idx])
        return self.peer_bytes[idx]

    def set_peer(self, peer_bytes: np.ndarray) -> None:
        self.peer_bytes = peer_bytes
        self.peer_u32 = _pack_v4_u32(peer_bytes) if self.family == 4 else None
        self.words = None  # address changed — repack for CT

    def ct_words(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.words is not None:
            return self.words
        return _peer_words(self.bytes_(), self.family)

    def take(self, idx: np.ndarray) -> "_Batch":
        """The flows ``idx`` as a batch of their own."""

        def part(a):
            return None if a is None else a[idx]

        return _Batch(
            self.family, self.ep_idx[idx], self.dports[idx], self.protos[idx],
            peer_bytes=part(self.peer_bytes), peer_u32=part(self.peer_u32),
            words=None if self.words is None else (self.words[0][idx], self.words[1][idx]),
        )


class PendingBatch:
    """Handle for one batch accepted by ``DatapathPipeline.submit()``.
    Batches complete strictly FIFO; ``result()`` blocks until this
    batch's host pull and accounting have run (completing any older
    in-flight batches first, preserving counter and conntrack order)."""

    __slots__ = ("_pipe", "_event", "_value", "_exc")

    def __init__(self, pipe: "DatapathPipeline") -> None:
        self._pipe = pipe
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self):
        if not self._event.is_set():
            self._pipe._complete_until(self)
            # a timed loop, not a bare wait: when another thread popped
            # this batch and is mid-finish, wait for it without parking
            # the caller unwakeably
            while not self._event.wait(0.5):
                pass
        if self._exc is not None:
            raise self._exc
        return self._value


class _InFlight:
    """One submitted batch: its handle, the completion closure (host
    pull, counters, CT create, metrics) and the trace that ends when the
    batch completes. ``finish=None`` marks a batch that ran
    synchronously (the device-CT path)."""

    __slots__ = ("pending", "finish", "bt", "enq_ns", "occ", "b", "rev", "t0", "abandoned")

    def __init__(self, pending: PendingBatch, finish, b: int = 0, rev: bool = False) -> None:
        self.pending = pending
        self.finish = finish
        self.bt = _NOOP_BATCH
        # depth-tuner observations, set only while DispatchAutoTune is
        # on: the enqueue half's ns and the queue occupancy at admission
        # (enq_ns == 0: not observed)
        self.enq_ns = 0
        self.occ = 0
        # batch size and revNAT flag: a drained or quarantined batch
        # gets a shape-correct degraded result from these
        self.b = b
        self.rev = rev
        # submit time (monotonic; 0 = not tracked, set only while
        # admission control or the watchdog is on) and the drain's or
        # the watchdog's abandonment mark: an abandoned batch is already
        # resolved degraded, and a late finish must not overwrite it
        self.t0 = 0.0
        self.abandoned = False


class _GatedPending(PendingBatch):
    """Admission-gate handle for a PARTIALLY shed batch: the deny-for-
    sure flows were resolved at the gate (DROP_PREFILTER), the kept
    flows ride an inner PendingBatch through the unchanged submit path.
    result() merges the two back into the caller's [B] order."""

    __slots__ = ("_inner", "_keep", "_shed_v", "_b", "_rev", "_merge")

    def __init__(
        self,
        pipe: "DatapathPipeline",
        inner: PendingBatch,
        keep_idx: np.ndarray,  # [K] indices of kept flows in the batch
        shed_verdict: np.ndarray,  # [B] int8, shed lanes pre-filled
        b: int,
        rev: bool,
    ) -> None:
        super().__init__(pipe)
        self._inner = inner
        self._keep = keep_idx
        self._shed_v = shed_verdict
        self._b = b
        self._rev = rev
        self._merge = threading.Lock()

    @property
    def done(self) -> bool:
        return self._event.is_set() or self._inner.done

    def result(self):
        with self._merge:
            if not self._event.is_set():
                try:
                    out = self._inner.result()
                except BaseException as e:
                    self._exc = e
                    self._event.set()
                    raise
                v = self._shed_v
                red = np.zeros(self._b, bool)
                v[self._keep] = out[0]
                red[self._keep] = out[1]
                if self._rev:
                    rev = np.zeros(self._b, np.uint16)
                    rev[self._keep] = out[2]
                    self._value = (v, red, rev)
                else:
                    self._value = (v, red)
                self._event.set()
        if self._exc is not None:
            raise self._exc
        return self._value


class _Enqueued:
    """Un-pulled results of one dispatch: (verdict, redirect, counters)
    — and (rule, l4_covered, hits) with attribution — as device
    tensors (``outs``, one tuple per flow shard), the pinned host views
    they are being copied into (``host``), the CUDA events recorded
    after those copies (one per device the dispatch ran on), the pinned
    staging tuples to release once the events have completed, and the
    tensors the launches read, kept alive until then. ``ndev`` is the
    plan's flows-axis size the batch was split over. On the CPU the
    outputs are final at enqueue and there is no event. ``done`` holds
    the pulled result once the completion half has it (a retried
    finish returns it again), or from the start at ladder level 2,
    where the verdicts are computed on the host at enqueue. ``bt`` is
    the batch's trace (the no-op one while tracing is off) and
    ``split`` the profiler's sample with its clocks (None unless this
    dispatch was sampled); the completion half times and retires it."""

    __slots__ = ("outs", "host", "events", "staging", "keep", "ndev", "done", "bt", "split")

    def __init__(self, outs, host, events, staging, keep, ndev=1, done=None, bt=_NOOP_BATCH,
                 split=None) -> None:
        self.outs = outs
        self.host = host
        self.events = events
        self.staging = staging
        self.keep = keep
        self.ndev = ndev
        self.done = done
        self.bt = bt
        self.split = split

    @property
    def event(self):
        """The last event recorded (the only one without a plan)."""
        return self.events[-1] if self.events else None


class _Split:
    """The clocks of one dispatch the profiler sampled: for each flow
    shard, stamps before its copies in, after them and after its last
    launch; for each device, one after the copies out (the event the
    completion half waits on). On the card a stamp is a timing CUDA
    event recorded on the device's current stream, read only after that
    wait, so sampling adds no synchronization; on the CPU it is
    ``time.perf_counter()`` around the same stretches."""

    __slots__ = ("sample", "cuda", "shards", "ends")

    def __init__(self, sample, cuda: bool) -> None:
        self.sample = sample
        self.cuda = cuda
        self.shards: list = []  # (device, before h2d, after h2d, after launches)
        self.ends: dict = {}  # device → after its copies out

    def stamp(self, dev):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(dev))
        return event

    def _secs(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def close(self) -> None:
        """Add the longest flow shard's h2d / compute / d2h to the
        sample; a device's copies out are timed from its last shard's
        last launch."""
        last = {dev: e2 for dev, _e0, _e1, e2 in self.shards}
        best = None
        for dev, e0, e1, e2 in self.shards:
            parts = (self._secs(e0, e1), self._secs(e1, e2), self._secs(last[dev], self.ends[dev]))
            if best is None or sum(parts) > sum(best):
                best = parts
        self.sample.add_h2d(best[0])
        self.sample.add_compute(best[1])
        self.sample.add_d2h(best[2])


@dataclasses.dataclass(frozen=True)
class _Placed:
    """The dispatch view of a plan, published by rebuild under the
    lock: one entry per grid row (a flow shard) — its first device, its
    {(direction, family): tables} and its {direction: rule table}
    (None without attribution) — the shed table on row 0's device, and
    whether the identity tables are ident-sharded (``ident_gather``)."""

    generation: int
    ident2d: bool
    rows: Tuple[Tuple[torch.device, Dict, Optional[Dict]], ...]
    shed_tab: Optional[torch.Tensor] = None


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
    none is given.

    With ``sharding`` (the VerdictSharding option) batches split over
    the flows axis of the plan ``placement.resolve_plan`` forms over
    the visible devices (``placement`` a ``PlacementConfig``); with
    ``mesh_2d`` (MeshSharding2D) the grid is ``flows × ident`` and the
    identity tables row-shard over ``ident``.

    Every batch runs under the failsafe (the module docstring): read
    it with :meth:`failsafe_state` and :attr:`pipeline_mode`; the
    breaker and retry knobs (``breaker_threshold``,
    ``recover_after_clean``, ``retry_limit``, ``retry_min_s``,
    ``retry_max_s``, ``device_ct_rescue_limit``) are plain attributes.
    ``stall_ms`` > 0 arms the watchdog (:meth:`set_stall_ms`);
    ``on_journal``, when set, is called as ``fn(kind=..., severity=...,
    attrs=...)`` for the ``ladder_move``, ``quarantine``, ``rebuild``
    and ``epoch_swap`` events, outside the pipeline's locks.

    ``tracer`` (a :class:`Tracer`, off until enabled) times each
    batch's phases; ``profiling`` / :meth:`set_profiling` sample the
    h2d / compute / d2h split of every ``profile_sample_every``-th
    dispatch; ``autotune`` / :meth:`set_autotune` let a
    :class:`DepthTuner` move ``pipeline_depth`` within
    ``pipeline_max_depth``. None of them changes a verdict, a counter or
    a launch.

    ``monitor`` (a ``MonitorHub``), while it has a listener, receives a
    DropNotify for every dropped flow, with ``trace_enabled`` a
    TraceNotify for every forwarded one, with ``verdict_notifications``
    a PolicyVerdictNotify for every flow, and a TraceSummary for every
    traced batch; ``drop_notifications`` turns the drops off and
    ``endpoint_options`` (``fn(endpoint_id, option_name, default)``)
    overrides each switch per endpoint. With attribution on,
    ``flow_ring`` (a :class:`FlowRing`, made when not given) records at
    most ``SAMPLE_CAP`` flows a batch, drops first; ``identity_labels``
    (``fn(identity_id)``) labels them. Both read only host arrays the
    completion half already holds.

    The positional order is the reference's; ``device`` (None = the
    card) is keyword-only."""

    def __init__(
        self,
        engine: PolicyEngine,
        ipcache: IPCache,
        prefilter: Optional[PreFilter] = None,
        conntrack: Optional[FlowConntrack] = None,
        lb=None,  # Optional[lb.service.ServiceManager]
        monitor=None,  # Optional[monitor.hub.MonitorHub]
        device_ct_bits: Optional[int] = None,
        tracer=None,
        pipeline_depth: int = 2,
        sharding: bool = False,
        flow_ring: Optional[FlowRing] = None,
        pipeline_max_depth: int = 4,
        autotune: bool = False,
        epoch_swap: bool = False,
        placement=None,
        mesh_2d: bool = False,
        admission: bool = False,
        prefilter_shed: bool = False,
        sparse_deltas: bool = False,
        deadline_ms: float = 0.0,
        stall_ms: float = 0.0,
        profiling: bool = False,
        profile_sample_every: int = 64,
        *,
        device=None,
    ) -> None:
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
        # the monitor hub (monitor/hub.py): flow events are built only
        # while it has a listener, one ``hub.active`` read a batch
        self.monitor = monitor
        # the span tracer: off by default, the verdict path then pays one
        # ``tracer.active`` read a batch
        self.tracer = tracer if tracer is not None else Tracer()
        # the sampled flow ring (observe/flows.py): FlowRecords from the
        # completion half while FlowAttribution is on, one ``ring.active``
        # read a batch
        self.flow_ring = flow_ring if flow_ring is not None else FlowRing()
        # optional identity → labels resolver for flow records:
        # fn(identity_id) -> tuple of label strings
        self.identity_labels = None
        # launch shapes already dispatched while tracing (the
        # jit_shape_buckets_total telemetry; a new one is a "miss")
        self._seen_shapes: set = set()
        # called for every redirect verdict with a known 5-tuple:
        # fn(peer_addr_bytes, ep_idx, sport, dport, proto, ingress,
        # family) — the cilium_proxy4/6 write hook (bpf_lxc.c inserts
        # a proxymap entry when the verdict is a proxy port)
        self.on_redirect = None
        # TraceNotify for forwarded flows is opt-in (the TraceNotification
        # endpoint option); DropNotify is on while a listener is attached,
        # gated by the DropNotification runtime option
        self.trace_enabled = False
        self.drop_notifications = True
        # PolicyVerdictNotify for EVERY flow (allowed included) is opt-in
        # (PolicyVerdictNotification): it walks the whole batch
        self.verdict_notifications = False
        # optional per-endpoint option resolver:
        # fn(endpoint_id, option_name, default) -> bool, so an
        # endpoint's own options gate its events
        self.endpoint_options = None
        # (ipcache version, {family: [(plen, {network: identity})]}): the
        # host ipcache as per-length tables, made when flow events first
        # resolve a peer at that version
        self._peer_index: Optional[Tuple[int, Dict]] = None
        # (repository, revision, rule_origins()) the flow records name
        self._origins: Optional[Tuple[object, int, List[dict]]] = None
        self._lb_tables: Dict[int, object] = {}
        self._lb_version = -1
        self._lock = threading.Lock()
        self._endpoints: list = []  # identity id per endpoint index
        self._endpoint_ids: list = []  # endpoint id per endpoint index
        # {(direction, family): WideDatapathTables (4) | DatapathTables (6)}
        self._tables: Dict[Tuple[int, int], object] = {}
        # direction → MaterializedState: made by a full sweep, then
        # patched in place by the engine's deltas
        self._mat: Dict[int, object] = {}
        self._mat_sig: Tuple = ()  # endpoint list the policymap was built for
        self._last_delta_seq = 0  # engine delta cursor
        # (v4 tables, v6 tables) of the last trie build, with the
        # policymap of that rebuild; republished per direction
        self._tries: Optional[Tuple[object, object]] = None
        self._trie_versions: Tuple = ()  # (ipcache version, prefilter revision)
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
        # set by a basis move or an epoch-swap install; the next rebuild
        # flushes the CT and clears it, after the SITE_CT_EPOCH check, so
        # a fault there leaves it set and a retried rebuild flushes
        self._ct_flush_pending = False
        # (revision, identity_version, vocab_version) of the served
        # generation, committed after the flush; a move is the
        # ``rebuild`` journal event
        self._mat_basis: Optional[Tuple[int, int, int]] = None
        # One-shot CT restore hold: the engine revision current when a
        # CT snapshot whose basis matched the restored compiled snapshot
        # was restored. The next rebuild's flush triggers keep the table
        # only if it materializes that same revision (its first
        # materialization then builds from exactly the restored tables);
        # a policy mutation before it bumps the revision and flushes.
        self._ct_restore_hold: Optional[int] = None
        # one-shot completion hook (the restart-downtime stamp): fired
        # once after the first completed batch, then cleared
        self.on_first_batch = None
        # -- epoch-swapped full rebuilds (EpochSwap) --------------------
        # A full re-materialization the delta log demands builds on a
        # shadow thread while batches keep the current generation; the
        # install (under _lock) becomes visible through the next
        # rebuild's publish. _swap_gen is the abandonment guard: an
        # endpoint or attribution change, or the swap turned off, bumps
        # it, and a shadow finishing under another generation is dropped.
        self._epoch_swap = bool(epoch_swap)
        self._policy_epoch = 0  # generations swapped in
        self._swap_gen = 0  # basis generation a shadow binds to
        self._shadow_thread: Optional[threading.Thread] = None
        self._shadow_exc: Optional[BaseException] = None
        # -- sparse trie deltas (SparseDeltas) --------------------------
        # family → patchable identity-trie mirror (4: PatchableFlatTrie,
        # 6: PatchableElidedTrie; None for a family with a live deny set
        # or the 16-8-8 layout), made beside self._tries; None while off
        self._sparse_deltas = bool(sparse_deltas)
        self._trie_patch: Optional[Dict[int, object]] = None
        # -- placement (VerdictSharding, MeshSharding2D) ----------------
        # the resolved MeshPlan owns the grid, the axis shardings and the
        # generation counter; every placed-table cache below is keyed on
        # that generation, so a plan move never serves tables placed on
        # a stale grid. _excluded_devices: device ids the plan must leave
        # out, filled by the ladder's sharded → single-device descent.
        self._sharding_requested = bool(sharding)
        self._placement: Optional[PlacementConfig] = placement
        self._mesh2d_requested = bool(mesh_2d)
        self._plan: MeshPlan = EMPTY_PLAN
        self._excluded_devices: set = set()
        # direction → (plan generation, source, placed copy): the
        # policymaps, the attribution rule tables
        self._placed_pm: Dict[int, Tuple[int, object, object]] = {}
        self._placed_rt: Dict[int, Tuple[int, object, object]] = {}
        # (plan generation, engine sel_match, ident-sharded copy) under a
        # 2D plan: the sweeps read through it
        self._placed_sel: Tuple[int, object, object] = (0, None, None)
        # (family, field) → (plan generation, source tensor, Replicated):
        # the tries and the shed table
        self._placed_tab: Dict[Tuple, Tuple[int, object, object]] = {}
        # what dispatch reads under a plan (_Placed), published by
        # rebuild with the tables; None without one
        self._placed: Optional[_Placed] = None
        # -- the failsafe: ladder, breaker, bounded retry ---------------
        # ladder level (index into _MODE_NAMES); moves under self._lock,
        # dispatch reads the int without it
        self._ladder_level = 0
        # quarantines add to _breaker_faults and a clean streak clears
        # them; at breaker_threshold the ladder descends one level, and
        # recover_after_clean clean batches at a degraded level climb one
        self.breaker_threshold = 3
        self.recover_after_clean = 32
        self._breaker_faults = 0
        self._clean_batches = 0
        # bounded retry of transient faults (completion and enqueue):
        # retry_limit attempts spaced by a fresh Backoff(min → max)
        self.retry_limit = 2
        self.retry_min_s = 0.005
        self.retry_max_s = 0.1
        self._quarantined = 0  # batches resolved degraded (lifetime)
        # direction → (source PolicymapTables, host numpy copy) for the
        # host rung, pulled once per materialization
        self._host_pm: Dict[int, Tuple[object, Tuple]] = {}
        # a quarantine rescued device-CT entries into the host table:
        # the next fresh device table seeds from the host CT
        self._device_ct_seed = False
        self.device_ct_rescue_limit = 1 << 16
        # lifecycle-event hook: fn(kind=..., severity=..., attrs=...),
        # always called outside this pipeline's locks; set before the
        # admission toggle below, which hands it to the controller
        self.on_journal = None
        # the stuck-completion watchdog (stall_ms > 0) and the batch a
        # thread is completing, (inflight, t0), written only while it runs
        self._watchdog: Optional[Watchdog] = None
        self._completing: Optional[Tuple] = None
        self.counters = np.zeros((0, 3), np.int64)
        # -- bounded in-flight dispatch queue -------------------------
        # submit() enqueues the device work and defers the host pull
        # (+ counters / CT create / metrics) until completion; depth
        # bounds how many batches sit un-pulled, so host prep of batch
        # N+1 overlaps device execution of batch N. Depth 1 = sync.
        self.pipeline_depth = min(PIPELINE_DEPTH_MAX, max(PIPELINE_DEPTH_MIN, int(pipeline_depth)))
        self.pipeline_max_depth = max(self.pipeline_depth, int(pipeline_max_depth))
        self._inflight: deque = deque()  # FIFO of _InFlight
        self._queue_lock = threading.Lock()  # guards _inflight only
        # the depth tuner (DispatchAutoTune): None keeps the queue at one
        # ``self._tuner is None`` read a batch and the depth static;
        # _static_depth is what set_autotune(False) restores
        self._static_depth = self.pipeline_depth
        self._tuner: Optional[DepthTuner] = None
        if autotune:
            self.set_autotune(True)
        _metrics.pipeline_depth_current.set(float(self.pipeline_depth))
        # pinned staging: key → free-list of pinned host tensor tuples.
        # A tuple leaves its list at enqueue and returns only after its
        # batch's event completed: a buffer returned earlier could be
        # overwritten while its copy is still pending.
        self._staging: Dict[tuple, list] = {}
        self._staging_lock = threading.Lock()
        # -- admission control + prefilter shed ------------------------
        # AdmissionControl: None (off) keeps _submit at one attribute
        # read per batch. The deadline is boot config.
        self.deadline_ms = max(0.0, float(deadline_ms))
        # FailOpen: what a batch that is not verdicted returns (a drained
        # or deadline-expired one): DROP_DEGRADED off, FORWARD on
        self._fail_open = False
        self._admission: Optional[AdmissionController] = None
        if admission:
            self.set_admission(True)
        # Prefilter: rebuild() compiles the [identity, class] shed table
        # from the ingress policymap mirror and publishes it with the
        # tries (_shed_tab); off publishes None. _shed_cache holds
        # (source MaterializedState, table) across rebuilds.
        self._shed_requested = bool(prefilter_shed)
        self._shed_cache: Optional[Tuple[object, torch.Tensor]] = None
        self._shed_tab: Optional[torch.Tensor] = None
        # graceful drain: new batches resolve degraded at once
        self._draining = False
        if stall_ms > 0:
            self.set_stall_ms(stall_ms)
        # the device profiler (DeviceProfiling): None keeps each dispatch
        # at one ``self.profiler is None`` read; sample_every is boot
        # config, set_profiling builds the profiler with it
        self.profile_sample_every = max(1, int(profile_sample_every))
        self.profiler = None
        if profiling:
            self.set_profiling(True)
        _metrics.pipeline_mode.set(0.0)

    def set_endpoints(self, endpoints: Sequence) -> None:
        """Accepts identity ids (endpoint id == identity id) or
        (endpoint_id, identity_id) pairs; order defines the datapath
        endpoint index."""
        with self._lock:
            pairs = [e if isinstance(e, tuple) else (int(e), int(e)) for e in endpoints]
            self._endpoint_ids = [int(p[0]) for p in pairs]
            self._endpoints = [int(p[1]) for p in pairs]
            self._mat = {}  # the column layout changes with the endpoint set
            # CT keys embed the endpoint INDEX; a changed endpoint list
            # would let a new occupant of an index inherit the previous
            # endpoint's established-flow bypass entries.
            self._flush_ct_locked()
            self._swap_gen += 1  # column layout moved: abandon shadows

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
            # force re-materialization: the rule table exists only
            # after a sweep with attribution (and goes when off)
            self._mat = {}
            self._mat_sig = ()
            self._swap_gen += 1  # sweep variant moved: abandon shadows
        self.flow_ring.active = bool(on)
        self._seen_shapes.clear()  # attributed launches are other shapes

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

    def _materialize_both(self, compiled, device) -> None:
        ao, nr = self._attrib_origins(compiled)
        self._attrib_n_rules = nr
        self._attrib_names = self.engine.repo.origin_names() if nr else []
        # the slowest thing rebuild() does: with the watchdog armed, a
        # sweep that outlasts the stall budget shows as a "compile" stall
        wd = self._watchdog
        if wd is not None:
            with wd.watching("compile"):
                self._mat = self._build_mats(compiled, device, self._endpoints, ao, nr)
        else:
            self._mat = self._build_mats(compiled, device, self._endpoints, ao, nr)

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
        """Bring the device state up to date. The policymaps follow the
        engine's delta log: identity churn patches rows, rule appends
        and deletes re-sweep the affected endpoints' columns, and a
        "full" event, a truncated log, a delta the patches cannot
        express, a new endpoint set, the attribution switch or ``force``
        re-materialize both directions. With EpochSwap on, only a delta
        the patches cannot express re-materializes on a shadow thread
        instead: this generation keeps serving, and the first rebuild
        after the install publishes the new one. The tries are rebuilt
        when the ipcache or the prefilter moved, after a fresh
        materialization or on a row event; with SparseDeltas on, an
        ipcache move that is the only trigger patches them in place. The
        LB tables follow the service table. Any of those moves, any rule
        delta and a swap install flush the conntrack.
        Returns {(direction, family): tables}.

        A move of the served basis is one ``rebuild`` journal event,
        sent after the lock is released."""
        oj = self.on_journal
        prev_basis = self._mat_basis if oj is not None else None
        tables = self._rebuild_locked(force)
        if oj is not None and self._mat_basis != prev_basis:
            basis = self._mat_basis
            oj(kind="rebuild", attrs={
                "prev_basis": None if prev_basis is None else list(prev_basis),
                "basis": None if basis is None else list(basis),
                "policy_epoch": self._policy_epoch,
                "generation": self._plan.generation,
            })
        return tables

    def _rebuild_locked(self, force: bool = False) -> Dict[Tuple[int, int], object]:
        with self._lock:
            self._refresh_mesh_locked()
            # versions captured before the sources are read: a mutation
            # landing mid-build triggers one more rebuild
            trie_versions = (self.ipcache.version, self.prefilter.revision)
            delta_target = self.engine.delta_seq
            compiled, device = self.engine.snapshot()
            pending = self.engine.deltas_since(self._last_delta_seq)
            delta_target = max(delta_target, self.engine.delta_seq)
            ep_sig = tuple(self._endpoints)
            basis_moved = trie_versions != self._trie_versions
            placed_gen = 0 if self._placed is None else self._placed.generation
            if (not force and self._tables and self._tries is not None and self._mat
                    and self._mat_sig == ep_sig and pending == [] and not basis_moved
                    and not self._ct_flush_pending
                    and placed_gen == (self._plan.generation if self._plan.mesh else 0)):
                self._publish_shed_locked(False)
                self._place_shed_locked()
                self._table_gauges_locked(device)
                self._refresh_lb_locked(self._ct_restore_hold == compiled.revision)
                self._ct_restore_hold = None
                return self._tables
            # a 2D plan: the sweeps and patches read an ident-sharded
            # sel_match (generation-cached; the engine's copy untouched)
            device = self._ident_placed_device(device, pending)

            mat_fresh = saw_row_event = saw_rule_delta = swap_pending = False
            if force or not self._mat or self._mat_sig != ep_sig:
                self._materialize_both(compiled, device)
                mat_fresh = True
            else:
                routed = self._route_deltas(compiled, device, pending)
                if routed is None:
                    # with EpochSwap the shadow builds it and this
                    # generation keeps serving; the install advances the
                    # delta cursor itself, so nothing here commits
                    if self._epoch_swap and self._kick_shadow_build(
                            compiled, device, ep_sig, delta_target):
                        swap_pending = True
                    else:
                        self._materialize_both(compiled, device)
                        mat_fresh = True
                else:
                    saw_row_event, saw_rule_delta = routed
            if not swap_pending:
                self._mat_sig = ep_sig
                self._last_delta_seq = delta_target

            # SparseDeltas: when ipcache churn is the only trie trigger,
            # patch the identity tries from the ipcache delta ring. A
            # success commits _trie_versions, so the full build below
            # skips; any failure leaves them stale and the build runs.
            if (self._sparse_deltas and self._trie_patch is not None and not force
                    and not mat_fresh and not saw_row_event and self._tries is not None
                    and self._tables and basis_moved
                    and trie_versions[1] == self._trie_versions[1]):
                self._patch_tries_locked(compiled, trie_versions)
            # any row move can re-point an ipcache entry's trie target
            if (force or self._tries is None or trie_versions != self._trie_versions
                    or mat_fresh or saw_row_event):
                self._build_tries_locked(compiled)
                self._trie_versions = trie_versions

            v4, v6 = self._tries
            tables: Dict[Tuple[int, int], object] = {}
            for direction, m in self._mat.items():
                tables[(direction, 4)] = dataclasses.replace(v4, policymap=m.tables)
                tables[(direction, 6)] = dataclasses.replace(v6, policymap=m.tables)
            rule_tabs = {d: m.rule_tab for d, m in self._mat.items()}
            self._rule_tabs = None if any(r is None for r in rule_tabs.values()) else rule_tabs
            if self._rule_tabs is None:
                self._attrib_n_rules = 0
                self._attrib_names = []
            self._tables = tables
            # in the same lock hold as the tries: a shed walk never
            # pairs a new table with old tries or the reverse
            self._publish_shed_locked(mat_fresh or saw_row_event or saw_rule_delta)
            self._publish_placed_locked()
            self._table_gauges_locked(device)
            if self.counters.shape[0] != len(self._endpoints):
                self.counters = np.zeros((len(self._endpoints), 3), np.int64)
            # Conntrack invalidation: the established-flow bypass is
            # only sound while the verdict basis that admitted the flow
            # still holds, so any basis move flushes the table (revoked
            # rules, remapped peers and new deny prefixes apply to
            # established flows on their next packet). A column patch is
            # still a rule change; a swap install sets the flag itself.
            # The restore hold (one-shot): on the first rebuild after a
            # verified CT restore the fresh materialization builds from
            # the restored tables, so the basis that admitted the
            # restored entries still holds and both triggers keep them.
            # Revision-pinned: a mutation before this rebuild voids it.
            held = self._ct_restore_hold == compiled.revision
            if (mat_fresh or saw_row_event or saw_rule_delta or basis_moved) and not held:
                self._ct_flush_pending = True
            if self._ct_flush_pending:
                if _faults.hub.active:
                    # before the flush: a retried rebuild re-runs this
                    # whole block (pending stays set), nothing half done
                    _faults.hub.check(_faults.SITE_CT_EPOCH)
                self._flush_ct_locked()
                self._ct_flush_pending = False
            self._refresh_lb_locked(held)
            # spent once both flush triggers have seen it
            self._ct_restore_hold = None
            # the served basis, after the flushes: a pending shadow swap
            # keeps serving the old generation until its install publishes
            if not swap_pending:
                self._mat_basis = (compiled.revision, compiled.identity_version,
                                   compiled.vocab_version)
            return self._tables

    def _build_tries_locked(self, compiled) -> None:
        """Both families' tries from the ipcache and the prefilter, one
        upload each, shared by both directions (``self._tries``). With
        SparseDeltas on, a family with no deny set builds its identity
        trie through a patchable mirror (kept in ``self._trie_patch``),
        with power-of-two node-pool headroom."""
        _, pf_cidrs = self.prefilter.dump()
        # empty-set flags first: both families' fusion gates read them
        # (an empty deny set skips the walk entirely)
        pf_empty = (
            not any(":" not in c for c in pf_cidrs),
            not any(":" in c for c in pf_cidrs),
        )
        ip_lists = {4: [], 6: []}
        for cidr, e in self.ipcache.items():
            row = compiled.id_to_row.get(e.identity)
            if row is not None:
                ip_lists[6 if ":" in cidr else 4].append((cidr, row))

        # IPv6: stride-8 tries with the shared prefix elided; the fused
        # deny+identity walk while a v6 deny set is live (it then covers
        # the deny stage, so no standalone deny trie)
        pf6_list = [(c, 0) for c in pf_cidrs if ":" in c]
        p6 = (PatchableElidedTrie(ip_lists[6], ipv6=True)
              if self._sparse_deltas and pf_empty[1] else None)
        ip6 = p6.arrays() if p6 is not None else build_trie_elided(ip_lists[6], ipv6=True)
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

        # IPv4 rides the wide (dense-16-bit-first) tries
        pf_wide = build_wide_trie((c, 0) for c in pf_cidrs if ":" not in c)
        # a v4 mirror only while the flat 16+16 layout holds (the 16-8-8
        # layout is never patched: None)
        p4 = make_patchable_wide(ip_lists[4]) if self._sparse_deltas and pf_empty[0] else None
        ip_wide = p4.arrays() if p4 is not None else build_wide_trie(ip_lists[4])
        # fused deny+identity walk: built only while the deny stage is
        # live and both layouts are flat; it then covers the deny stage,
        # so the standalone deny trie is not uploaded
        merged = merge_flat_tries(ip_wide, pf_wide) if not pf_empty[0] else None
        if merged is None:
            merged = _NO_TRIE
        else:
            pf_wide = _NO_TRIE
        world_row = compiled.id_to_row.get(ID_WORLD)
        if world_row is None:
            raise RuntimeError("reserved:world identity has no device row")
        pm = self._mat[TRAFFIC_INGRESS].tables
        self._tries = (
            wide_tables_from_numpy((*pf_wide, *ip_wide, *merged), world_row, pm, device=self.device),
            v6_tables_from_numpy((*pf6, *ip6, *merged6), world_row, pm, device=self.device),
        )
        self._pf_empty = pf_empty
        self._v6_fused = merged6_list is not None
        self._trie_patch = {4: p4, 6: p6} if self._sparse_deltas else None

    def _patch_tries_locked(self, compiled, trie_versions) -> bool:
        """Apply the ipcache delta window to the identity-trie tensors
        through their mirrors (lock held). On success commits
        ``_trie_versions`` and returns True; a truncated ring, a live
        deny set or an unpatched layout for a touched family, pool
        exhaustion, an elision violation or a shape mismatch return
        False with the versions stale, and the full build runs (and
        replaces the mirrors, so a half-applied window never leaks).
        Every flush is out of place: a batch in flight keeps the tries
        it was enqueued with."""
        deltas = self.ipcache.deltas_since(self._trie_versions[0])
        if not deltas:  # None (truncated) or an unlogged version move
            return False
        ops = []  # (family, mirror, cidr, row | None)
        for _ver, cidr, _old_ident, new_ident in deltas:
            fam = 6 if ":" in cidr else 4
            if not self._pf_empty[0 if fam == 4 else 1]:
                return False  # the fused deny+identity trie is never patched
            mirror = self._trie_patch.get(fam)
            if mirror is None:
                return False  # the 16-8-8 v4 layout
            # an identity without a device row is absent from the trie
            row = compiled.id_to_row.get(new_ident) if new_ident is not None else None
            ops.append((fam, mirror, cidr, row))
        applied = {4: 0, 6: 0}
        for fam, mirror, cidr, row in ops:
            if not (mirror.insert(cidr, row) if row is not None else mirror.delete(cidr)):
                return False
            applied[fam] += 1
        v4, v6 = self._tries
        nbytes = 0
        p4, p6 = self._trie_patch[4], self._trie_patch[6]
        if p4 is not None and p4.dirty:
            out = p4.flush(v4.ip_root_info, v4.ip_root_child, v4.ip_sub_child, v4.ip_sub_info)
            if out is None:
                return False
            (ri, rc, sc, si), nb = out
            v4 = dataclasses.replace(v4, ip_root_info=ri, ip_root_child=rc, ip_sub_child=sc,
                                     ip_sub_info=si)
            nbytes += nb
        if p6 is not None and p6.dirty:
            out = p6.flush(v6.ip_child, v6.ip_info)
            if out is None:
                return False
            (child, info), nb = out
            v6 = dataclasses.replace(v6, ip_child=child, ip_info=info)
            nbytes += nb
        self._tries = (v4, v6)
        self._trie_versions = trie_versions
        for fam, n in applied.items():
            if n:
                _metrics.lpm_trie_patches_total.inc({"family": str(fam)}, float(n))
        if nbytes:
            _metrics.device_transfer_bytes_total.inc({"direction": "h2d"}, float(nbytes))
            _metrics.device_transfers_total.inc({"direction": "h2d"}, 1.0)
        return True

    def _route_deltas(self, compiled, device, deltas) -> Optional[Tuple[bool, bool]]:
        """Apply the engine delta log to the materialized states in place
        (the O(delta) refresh path, lock held) → ``(saw_row_event,
        saw_rule_delta)``, or None when the log demands a full
        re-materialization: a truncated ring, a "full" event, or a rule
        delta the column patch cannot express (slot growth, row-bucket
        crossing, a delete under attribution — every later rule's index
        shifts, so the per-cell rule table cannot be patched).

        Row patches rewrite whole identity rows and column patches whole
        endpoint columns, both against the FINAL (compiled, device)
        snapshot, so replaying the coalesced rows first and the rule
        columns second lands every touched cell on its final value
        however the log interleaved them."""
        if deltas is None:
            return None
        if any(k == "full" for _, k, _ in deltas):
            return None
        if self._attrib_requested and any(
            k == "rules" and p and p[0] == "del" for _, k, p in deltas
        ):
            if any(m.rule_nc is not None for m in self._mat.values()):
                return None
        t0 = time.perf_counter()
        ao, nr = self._attrib_origins(compiled)
        saw_row_event = False
        touched_sids: set = set()
        row_events: list = []
        for _seq, kind, payload in deltas:
            if kind == "rows":
                # coalesced: one patch per direction for every row event
                # since the last rebuild (last event per row wins)
                row_events.extend(payload)
                saw_row_event |= bool(payload)
            elif kind == "rules":  # ("add" | "del", subject sids)
                touched_sids.update(payload[1])
            # "cols": the engine already scattered sel_match; the paired
            # "rules" event's column re-sweep consumes it
        if row_events:
            for direction, mat in self._mat.items():
                # the same scatters patch the placed copies, so the
                # placement survives the O(delta) path without a re-place
                placed = self._placed_holder(direction, mat)
                patch_identity_rows(
                    mat, device, row_events,
                    attrib_origin=ao[direction == TRAFFIC_INGRESS], n_rules=nr, placed=placed,
                )
                self._rekey_placed(direction, mat, placed)
        if touched_sids:
            for direction, mat in self._mat.items():
                placed = self._placed_holder(direction, mat)
                if not patch_endpoints_state(
                    mat, compiled, device, sorted(touched_sids),
                    attrib_origin=ao[direction == TRAFFIC_INGRESS], n_rules=nr, placed=placed,
                ):
                    # partial patches are harmless: every cell they wrote
                    # holds its final value, and the full sweep replaces
                    # the state wholesale
                    return None
                self._rekey_placed(direction, mat, placed)
            # appends grow the rule set: keep the completion half's
            # rule-index → origin map in step with the patched tables
            if nr:
                self._attrib_n_rules = nr
                self._attrib_names = self.engine.repo.origin_names()
        if saw_row_event or touched_sids:
            _metrics.engine_refresh_seconds.observe(time.perf_counter() - t0, {"kind": "delta"})
        return saw_row_event, bool(touched_sids)

    # -- runtime switches: sparse trie deltas, epoch swap --------------
    def set_sparse_deltas(self, on: bool) -> None:
        """Toggle sparse trie deltas (the SparseDeltas runtime option),
        from the next rebuild. Both transitions drop the tries and the
        mirrors: on builds the mirrors beside a fresh full build (they
        mirror the device tensors row for row), off sheds their node-pool
        headroom and builds the exact-sized tries again."""
        with self._lock:
            on = bool(on)
            if on == self._sparse_deltas:
                return
            self._sparse_deltas = on
            self._trie_patch = None
            self._tries = None
            self._placed_sel = (0, None, None)

    # -- placement: VerdictSharding, MeshSharding2D --------------------
    def set_sharding(self, on: bool) -> None:
        """Toggle flow sharding over the plan's grid (the
        VerdictSharding runtime option). Takes effect on the next
        rebuild; a grid only forms with >1 visible device. Clears the
        tables and the placed copies."""
        with self._lock:
            if bool(on) == self._sharding_requested:
                return
            self._sharding_requested = bool(on)
            self._drop_placed_locked()

    def set_mesh_2d(self, on: bool) -> None:
        """Toggle the 2D flows×ident grid (the MeshSharding2D runtime
        option). Takes effect on the next rebuild through the plan: the
        grid splits into flows×ident axes and the identity dimension of
        the policymaps / rule tables / sel_match shards over ``ident``.
        Off never reaches ``ident_gather_rows`` nor the in-place shard
        read (``local_row_shards``). Clears the tables and
        the placed copies, as set_sharding."""
        with self._lock:
            if bool(on) == self._mesh2d_requested:
                return
            self._mesh2d_requested = bool(on)
            self._drop_placed_locked()

    def _drop_placed_locked(self) -> None:
        self._tables = {}
        self._tries = None
        self._placed_pm.clear()
        self._placed_rt.clear()
        self._placed_sel = (0, None, None)
        self._placed_tab.clear()
        self._placed = None
        self._swap_gen += 1  # placement basis moved: abandon shadows
        self._seen_shapes.clear()

    def _refresh_mesh_locked(self) -> None:
        """Resolve the placement plan to match the sharding / 2D
        requests (lock held). resolve_plan returns the previous plan
        unchanged when nothing moved, so the placed caches survive; a new
        plan moves the ``mesh_axis_size`` gauge. A plan whose devices are
        of another type than the pipeline's raises: a pipeline asked to
        run on the CPU never places on a card, nor the reverse."""
        plan = resolve_plan(
            self._placement,
            sharding=self._sharding_requested,
            mesh_2d=self._mesh2d_requested,
            excluded=frozenset(self._excluded_devices),
            prev=self._plan,
        )
        if plan is not self._plan:
            for row in plan.mesh or ():
                for rec in row:
                    if rec.device.type != self.device.type:
                        raise ValueError(
                            f"placement device {rec.device} for a pipeline on {self.device}")
            self._plan = plan
            _metrics.mesh_axis_size.set(float(plan.axes.get("flows", 0)), {"axis": "flows"})
            _metrics.mesh_axis_size.set(float(plan.axes.get("ident", 0)), {"axis": "ident"})

    def placement_state(self) -> Dict:
        """Placement snapshot (the reference's GET /traces block): the
        resolved plan's generation, axes and device set plus the
        operator's requests. Resolves the plan first, so a just-toggled
        option reports the grid it WILL run on."""
        with self._lock:
            self._refresh_mesh_locked()
        plan = self._plan
        return {
            "generation": plan.generation,
            "axes": dict(plan.axes),
            "devices": list(plan.device_ids),
            "flows_size": plan.flows_size,
            "mesh_2d_requested": self._mesh2d_requested,
            "sharding_requested": self._sharding_requested,
            "ident_sharded": plan.is_2d,
            "excluded_devices": sorted(self._excluded_devices),
        }

    # -- the failsafe: ladder and classified error handling -------------
    @property
    def pipeline_mode(self) -> str:
        return _MODE_NAMES[self._ladder_level]

    def failsafe_state(self) -> Dict:
        """Degraded-state snapshot (the reference's GET /healthz block)."""
        return {
            "mode": self.pipeline_mode,
            "level": self._ladder_level,
            "degraded": self._ladder_level > 0,
            "fail_open": self._fail_open,
            "breaker_faults": self._breaker_faults,
            "clean_batches": self._clean_batches,
            "quarantined_batches": self._quarantined,
            "excluded_devices": sorted(self._excluded_devices),
            "fault_injection": _faults.hub.active,
        }

    def _set_level(self, level: int) -> None:
        """Move the ladder (descent on a tripped breaker, one level up on
        a clean streak). Drops the tables and the placed copies, as a
        sharding toggle does: the next rebuild re-forms the plan over
        the devices left and places the tables again."""
        with self._lock:
            cur = self._ladder_level
            level = max(0, min(len(_MODE_NAMES) - 1, int(level)))
            if level == cur:
                return
            frm, to = _MODE_NAMES[cur], _MODE_NAMES[level]
            self._ladder_level = level
            if level == 0:
                # full re-promotion: every device eligible again
                self._excluded_devices.clear()
            elif cur == 0:
                # sharded → single-device: which device faulted cannot
                # be told on the host, so keep the first of the active
                # plan (never one its placement left out) and exclude
                # the rest; the clean-streak probe re-admits them
                plan_ids = self._plan.device_ids or tuple(
                    r.id for r in _placement.visible_devices())
                self._excluded_devices.update(plan_ids[1:])
            # also bumps _swap_gen: a shadow built for the old device set
            # must never install
            self._drop_placed_locked()
            self._breaker_faults = 0
            self._clean_batches = 0
        _metrics.degradations_total.inc({"from": frm, "to": to})
        _metrics.pipeline_mode.set(float(level))
        oj = self.on_journal
        if oj is not None:
            oj(kind="ladder_move", severity="warning" if level > cur else "info",
               attrs={"from": frm, "to": to, "level": level})

    def _note_fault(self, exc: BaseException, kind: str) -> None:
        """Account one classified fault and trip the breaker when due.
        An injected FaultError was counted where it fired
        (``faults.hub.check``); only a real one adds to the metric."""
        if not isinstance(exc, _faults.FaultError):
            _metrics.pipeline_faults_total.inc(
                {"site": getattr(exc, "site", "pipeline"), "kind": kind})
        with self._lock:
            self._clean_batches = 0
            self._breaker_faults += 1
            trip = self._breaker_faults >= self.breaker_threshold
            lvl = self._ladder_level
        if trip and lvl < len(_MODE_NAMES) - 1:
            self._set_level(lvl + 1)

    def _note_clean_batch(self) -> None:
        """One healthy completion: a short streak clears the breaker; at
        a degraded level a long enough one climbs one level."""
        if self._ladder_level == 0 and self._breaker_faults == 0:
            return  # steady state: two reads, no lock
        with self._lock:
            self._clean_batches += 1
            if self._clean_batches >= self.breaker_threshold:
                self._breaker_faults = 0
            lvl = self._ladder_level
            promote = lvl > 0 and self._clean_batches >= self.recover_after_clean
        if promote:
            self._set_level(lvl - 1)

    def _quarantine(self, inf: _InFlight):
        """Give up on a batch: advance the CT epoch under the lock (a
        batch completing after this creates no entry verdicted under a
        basis that may be poisoned), drop the device CT after rescuing
        its live entries into the host table, abandon any shadow build,
        and resolve the batch degraded. Its pinned staging tuples are
        never returned to the free-lists: a copy may still be writing
        them while its event is pending."""
        with self._lock:
            dct = self._device_ct
            self._ct_epoch += 1
            ct_epoch = self._ct_epoch
            self._device_ct = None
            self._quarantined += 1
            quarantined = self._quarantined
            # the generation a shadow bound to may be the poisoned one
            self._swap_gen += 1
        # outside the lock: the pull can be slow, or fail, on a device
        # being quarantined
        rescue = None
        if dct is not None and self.conntrack is not None:
            rescue = self._rescue_device_ct(dct)
        oj = self.on_journal
        if oj is not None:
            oj(kind="quarantine", severity="error", attrs={
                "ct_epoch": ct_epoch,
                "quarantined": quarantined,
                "ct_rescue": "skipped" if rescue is None else rescue,
            })
        return self._degraded_result(inf)

    def _rescue_device_ct(self, state) -> Optional[Dict]:
        """Pull the live device-CT entries (at most
        ``device_ct_rescue_limit``) into the host FlowConntrack, so the
        degraded levels keep serving established flows, and mark the
        next fresh device table to seed from the host CT. The device is
        the thing quarantined, so any fault, an injected one at
        SITE_COMPLETE too, skips the rescue (None) and never escalates;
        a programmer error is raised. → {kept, expired} for the
        quarantine event."""
        try:
            if _faults.hub.active:
                _faults.hub.check(_faults.SITE_COMPLETE)
            pulled = pull_live_entries(state, int(time.monotonic()),
                                       limit=self.device_ct_rescue_limit)
            kept, expired = self.conntrack.restore_arrays(
                pulled["ka"], pulled["kb"], pulled["kc"], pulled["ttl"])
        except BaseException as e:
            if _classify(e) == _faults.KIND_ERROR:
                raise
            return None  # the quarantine goes on cold
        if kept:
            _metrics.ct_restored_entries_total.inc({"result": "kept"}, float(kept))
            with self._lock:  # read by _process_device_ct under it
                self._device_ct_seed = True
        if expired:
            _metrics.ct_restored_entries_total.inc({"result": "expired"}, float(expired))
        return {"kept": int(kept), "expired": int(expired)}

    def _seed_device_ct(self) -> DeviceCTState:
        """A fresh device CT holding the host table's entries (the
        re-upload half of the rescue; the caller holds self._lock). A
        classified failure gives an empty table: seeding saves the
        established flows a re-verdict, nothing depends on it."""
        try:
            snap = self.conntrack.snapshot_arrays()
            return seed_state_from_host(
                snap["ka"], snap["kb"], snap["kc"], snap["ttl"], self._device_ct_bits,
                int(time.monotonic()), limit=self.device_ct_rescue_limit, device=self.device)
        except BaseException as e:
            if _classify(e) == _faults.KIND_ERROR:
                raise
            return make_state(self._device_ct_bits, device=self.device)

    def _finish_guarded(self, inf: _InFlight):
        """Run a batch's finish closure under classification → (value,
        exc), exactly one not None:

        - transient: retried, ``retry_limit`` times, each after a fresh
          Backoff's sleep. Sound because SITE_COMPLETE and the event
          wait come before anything the closure changes, and a pulled
          result stays on its _Enqueued, so a re-run starts whole;
        - poisoned, or transient past its retries: quarantined, a
          degraded result, FIFO order kept;
        - error (a programmer error, a KernelError): returned for
          ``result()`` to raise."""
        attempt = 0
        bo: Optional[Backoff] = None
        while True:
            try:
                out = inf.finish()
            except BaseException as e:
                kind = _classify(e)
                if kind == _faults.KIND_ERROR:
                    return None, e
                self._note_fault(e, kind)
                if kind == _faults.KIND_TRANSIENT and attempt < self.retry_limit:
                    attempt += 1
                    if bo is None:
                        bo = Backoff(min_s=self.retry_min_s, max_s=self.retry_max_s, jitter=False)
                    time.sleep(bo.duration())
                    continue
                return self._quarantine(inf), None
            self._note_clean_batch()
            return out, None

    def _replicated_policymap(self, direction: int, pm: PolicymapTables) -> PolicymapTables:
        """Grid-placed copy of one direction's policymap, cached on the
        source object AND the plan generation: patches (which swap the
        tensors) and plan moves re-place, steady-state rebuilds reuse the
        copy. Under a 2D plan the identity axis shards
        (shard_tables_ident); 1D replicates."""
        plan = self._plan
        gen, src, placed = self._placed_pm.get(direction, (-1, None, None))
        if src is pm and gen == plan.generation:
            return placed
        if plan.is_2d:
            placed = shard_tables_ident(pm, plan.ident_sharding, plan.table_sharding)
        else:
            placed = replicate_tables(pm, plan.table_sharding)
        self._placed_pm[direction] = (plan.generation, pm, placed)
        return placed

    def _replicated_rule_tab(self, direction: int, rt: torch.Tensor):
        """Grid-placed copy of one direction's attribution rule table —
        the _replicated_policymap pattern: replicated on a 1D plan,
        row-sharded like id_bits on a 2D one."""
        plan = self._plan
        gen, src, placed = self._placed_rt.get(direction, (-1, None, None))
        if src is rt and gen == plan.generation:
            return placed
        placed = (shard_rows(rt, plan.ident_sharding) if plan.is_2d
                  else replicate(rt, plan.table_sharding))
        self._placed_rt[direction] = (plan.generation, rt, placed)
        return placed

    def _ident_placed_device(self, device, deltas=None):
        """The engine's DevicePolicy with ``sel_match`` ident-sharded
        under a 2D plan (generation-cached on the source tensor); any
        other plan returns it untouched. With SparseDeltas on, a source
        change the delta log explains patches the cached copy
        (_patch_placed_sel) instead of re-placing it."""
        plan = self._plan
        if not plan.is_2d:
            return device
        gen, src, placed = self._placed_sel
        if src is not device.sel_match or gen != plan.generation:
            patched = self._patch_placed_sel(device, deltas) if self._sparse_deltas else None
            placed = (shard_rows(device.sel_match, plan.ident_sharding)
                      if patched is None else patched)
            self._placed_sel = (plan.generation, device.sel_match, placed)
        return dataclasses.replace(device, sel_match=placed)

    def _patch_placed_sel(self, device, deltas):
        """Replay the delta window onto the cached ident-sharded
        sel_match → the patched copy, or None when the gap is not
        patchable (no cached copy, a plan move, a truncated or absent
        log, a "full" event, a shape move, a mirror miss) and the
        caller re-places it. The values are final-state reads of the
        engine's host mirror (sel_match_rows), so a replay is
        idempotent."""
        plan = self._plan
        gen, _src, placed = self._placed_sel
        if placed is None or gen != plan.generation:
            return None
        if not deltas:  # None (truncated) or an unlogged source move
            return None
        if tuple(placed.shape) != tuple(device.sel_match.shape):
            return None
        row_set: set = set()
        col_events: list = []
        for _seq, kind, payload in deltas:
            if kind == "rows":
                row_set.update(int(r) for r, _ident, _live in payload)
            elif kind == "cols":
                col_events.append(payload)
            elif kind != "rules":  # "full": re-place
                return None
        if not row_set and not col_events:
            return None  # the source moved with no sel_match event logged
        nbytes = nscat = 0
        if row_set:
            rows = sorted(row_set)
            vals = self.engine.sel_match_rows(rows)
            if vals is None or vals.shape[1] != placed.shape[1]:
                return None
            placed = patch_selector_rows(placed, rows, vals)
            nbytes += len(rows) * 4 + int(vals.nbytes)
            nscat += 1
        for sel_lo, sel_hi, touched in col_events:
            # rows the row patch rewrote whole already hold their final bits
            rows = [int(r) for r in touched if int(r) not in row_set]
            if not rows:
                continue
            words = selector_word_window(int(sel_lo), int(sel_hi))
            if words.size == 0 or int(words.max()) >= placed.shape[1]:
                return None
            vals = self.engine.sel_match_rows(rows, words)
            if vals is None:
                return None
            placed = patch_selector_cols(placed, rows, words, vals)
            nbytes += len(rows) * 4 + int(vals.nbytes) + int(words.nbytes)
            nscat += 1
        if nscat:
            _metrics.device_transfer_bytes_total.inc({"direction": "h2d"}, float(nbytes))
            _metrics.device_transfers_total.inc({"direction": "h2d"}, float(nscat))
        return placed

    def _placed_holder(self, direction: int, mat) -> Optional[PlacedTables]:
        """PlacedTables view of the direction's current placed copies,
        for the patch paths to scatter into; None when nothing valid is
        cached (no plan, a source swap, a plan move) — the next rebuild
        re-places instead."""
        plan = self._plan
        if plan.table_sharding is None:
            return None
        gen, src, ppm = self._placed_pm.get(direction, (-1, None, None))
        if src is not mat.tables or gen != plan.generation:
            return None
        holder = PlacedTables(tables=ppm)
        rgen, rsrc, prt = self._placed_rt.get(direction, (-1, None, None))
        if mat.rule_tab is not None and rsrc is mat.rule_tab and rgen == plan.generation:
            holder.rule_tab = prt
        return holder

    def _rekey_placed(self, direction: int, mat, holder) -> None:
        """Re-key the placed caches after a patch: it swapped both the
        materialized tensors and the placed copies, so the entries move
        to the new source objects without a re-place."""
        if holder is None:
            return
        gen = self._plan.generation
        self._placed_pm[direction] = (gen, mat.tables, holder.tables)
        if holder.rule_tab is not None and mat.rule_tab is not None:
            self._placed_rt[direction] = (gen, mat.rule_tab, holder.rule_tab)

    def _place_locked(self, key, t: torch.Tensor) -> Replicated:
        """``t`` replicated over the plan's grid through place_table,
        cached on the source tensor and the plan generation (a trie
        patch or a new shed table re-places only what it replaced)."""
        gen = self._plan.generation
        pgen, src, placed = self._placed_tab.get(key, (-1, None, None))
        if src is t and pgen == gen:
            return placed
        placed = place_table(t, self._plan.table_sharding)
        self._placed_tab[key] = (gen, t, placed)
        return placed

    def _place_shed_locked(self) -> None:
        """Publish the shed table placed on grid row 0's device beside
        the placed tables (None while Prefilter is off)."""
        if self._placed is None:
            return
        shed = None
        if self._shed_tab is not None:
            shed = self._place_locked(("shed",), self._shed_tab).on(self._placed.rows[0][0])
        if shed is not self._placed.shed_tab:
            self._placed = dataclasses.replace(self._placed, shed_tab=shed)

    def _publish_placed_locked(self) -> None:
        """Publish the dispatch view of the plan (``self._placed``):
        per grid row, the tries placed through place_table and the
        policymaps and rule tables placed by _replicated_policymap /
        _replicated_rule_tab, as read from that row's first device.
        None without a grid."""
        plan = self._plan
        if plan.mesh is None:
            self._placed = None
            return
        pms = {d: self._replicated_policymap(d, m.tables) for d, m in self._mat.items()}
        rts = None
        if self._rule_tabs is not None:
            rts = {d: self._replicated_rule_tab(d, rt) for d, rt in self._rule_tabs.items()}
        v4, v6 = self._tries
        tries = {}
        for fam, t in ((4, v4), (6, v6)):
            tries[fam] = {
                f.name: self._place_locked((fam, f.name), getattr(t, f.name))
                for f in dataclasses.fields(t) if f.name not in ("world_row", "policymap")
            }
        rows = []
        for grid_row in plan.mesh:
            dev = grid_row[0].device
            tabs = {}
            for direction, pm in pms.items():
                pm_d = tables_on(pm, dev)
                for fam, t in ((4, v4), (6, v6)):
                    tabs[(direction, fam)] = dataclasses.replace(
                        t, policymap=pm_d, **{k: r.on(dev) for k, r in tries[fam].items()})
            rt_d = None if rts is None else {
                d: r.on(dev) if isinstance(r, Replicated) else r for d, r in rts.items()}
            rows.append((dev, tabs, rt_d))
        self._placed = _Placed(plan.generation, plan.is_2d, tuple(rows))
        self._place_shed_locked()

    def _table_gauges_locked(self, device) -> None:
        """Per-device table bytes (``sharded_table_bytes``,
        ``device_table_bytes``): under a 2D plan the identity tables
        split by the ident factor; replicated / 1D report full bytes;
        the tries are always replicated."""
        ident = self._plan.ident_size if self._plan.is_2d else 1
        pm_bytes = sum(m.tables.id_bits.numel() * 4 for m in self._mat.values())
        rt_bytes = sum(m.rule_tab.numel() * 4 for m in self._mat.values() if m.rule_tab is not None)
        _metrics.sharded_table_bytes.set(float(pm_bytes // ident), {"family": "policymap"})
        _metrics.sharded_table_bytes.set(float(rt_bytes // ident), {"family": "rule_tab"})
        placement = "ident-sharded" if self._plan.is_2d else "replicated"
        _metrics.device_table_bytes.set(
            float(pm_bytes // ident), {"family": "policymap", "placement": placement})
        _metrics.device_table_bytes.set(
            float(rt_bytes // ident), {"family": "rule_tab", "placement": placement})
        sel = device.sel_match
        _metrics.device_table_bytes.set(
            float(sel.shape[0] * sel.shape[1] * 4 // ident),
            {"family": "sel_match", "placement": placement})
        trie_bytes = sum(
            getattr(t, f.name).numel() * getattr(t, f.name).element_size()
            for t in self._tries for f in dataclasses.fields(t)
            if f.name not in ("world_row", "policymap"))
        _metrics.device_table_bytes.set(
            float(trie_bytes), {"family": "lpm_trie", "placement": "replicated"})

    def set_epoch_swap(self, on: bool) -> None:
        """Toggle epoch-swapped full rebuilds (the EpochSwap runtime
        option). Off also abandons a shadow build in flight: the next
        rebuild that needs a full sweep runs it synchronously."""
        with self._lock:
            on = bool(on)
            if on == self._epoch_swap:
                return
            self._epoch_swap = on
            if not on:
                self._swap_gen += 1

    def wait_epoch_swap(self, timeout: float = 60.0) -> bool:
        """Block until no shadow build is in flight; False on timeout.
        The installed generation serves from the NEXT rebuild() on."""
        t = self._shadow_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            return not t.is_alive()
        return True

    @property
    def policy_epoch(self) -> int:
        """Shadow-built generations swapped in since start."""
        return self._policy_epoch

    def _kick_shadow_build(self, compiled, device, ep_sig, delta_target) -> bool:
        """Start (or keep watching) a shadow materialization bound to
        the current basis generation (lock held). True while a shadow
        runs — the caller keeps serving this generation — and False when
        the caller must sweep synchronously: the previous shadow died on
        a transient or poisoned fault (a programmer error re-raises).

        On the card the shadow sweeps on a side stream that first waits
        for the serving stream, where the snapshot's last out-of-place
        updates may still be queued."""
        exc = self._shadow_exc
        if exc is not None:
            self._shadow_exc = None
            if _classify(exc) == _faults.KIND_ERROR:
                raise exc
            return False
        t = self._shadow_thread
        if t is not None and t.is_alive():
            return True  # one shadow at a time; converge via the log
        ao, nr = self._attrib_origins(compiled)
        names = self.engine.repo.origin_names() if nr else []
        streams = None
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            streams = (main, side)
        t = threading.Thread(
            target=self._shadow_build,
            args=(compiled, device, list(self._endpoints), ep_sig, delta_target,
                  self._swap_gen, ao, nr, names, streams),
            name="policyd-shadow-mat", daemon=True,
        )
        self._shadow_thread = t
        t.start()
        return True

    def _shadow_build(self, compiled, device, endpoints, ep_sig, delta_target, gen,
                      ao, nr, names, streams) -> None:
        """Shadow-thread body: both directions' sweeps off the pipeline
        lock (batches and O(delta) rebuilds go on against the old
        generation), then the install under it. Deltas that landed
        during the sweep are not lost: the install sets the cursor to
        the kick-time target, so the next rebuild replays them against
        the new generation."""
        try:
            if streams is None:
                mats = self._build_mats(compiled, device, endpoints, ao, nr)
            else:
                main, side = streams
                with torch.cuda.stream(side):
                    mats = self._build_mats(compiled, device, endpoints, ao, nr)
                side.synchronize()
                # the tensors were made on the side stream and are read
                # on the serving stream: the allocator must not hand
                # their blocks out again before the serving stream's
                # work on them ends
                for m in mats.values():
                    fields = dataclasses.fields(m.tables)
                    for t in (*(getattr(m.tables, f.name) for f in fields), m.rule_tab):
                        if t is not None:
                            t.record_stream(main)
        # The broad catch is the point: any shadow failure, a
        # BaseException too, parks in _shadow_exc, so the next kick routes
        # it through _classify (KIND_ERROR re-raises there, the rest
        # fall back to a synchronous sweep); a raise on this daemon thread
        # would vanish.
        except BaseException as e:
            with self._lock:
                if self._swap_gen == gen:
                    self._shadow_exc = e
            return
        with self._lock:
            if self._swap_gen != gen:
                return  # the basis moved under the shadow: abandon it
            self._mat = mats
            self._mat_sig = ep_sig
            self._last_delta_seq = delta_target
            self._attrib_n_rules = nr
            self._attrib_names = names
            # rows may have moved with the sweep: the tries must follow
            self._tries = None
            # dispatch-visible only through the next rebuild's publish,
            # which also flushes the CT
            self._ct_flush_pending = True
            self._policy_epoch += 1
            epoch = self._policy_epoch
        _metrics.engine_epoch_swaps_total.inc()
        oj = self.on_journal
        if oj is not None:
            oj(kind="epoch_swap", attrs={
                "policy_epoch": epoch,
                "basis": [compiled.revision, compiled.identity_version, compiled.vocab_version],
            })

    def snapshots(self, ingress: bool = True) -> List[EndpointPolicySnapshot]:
        """The realized policymap of every endpoint (host dicts, patched
        in place by row deltas) for one direction, after a rebuild."""
        self.rebuild()
        return self._mat[TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS].snapshots

    def fastpath(self, ingress: bool = True):
        """Per-flow verdict cache over the current realized policymaps
        (datapath/fastpath.py). Row patches from identity churn are
        visible through the shared snapshot dicts; re-fetch after rule
        changes (re-materialization swaps the snapshot objects)."""
        from .fastpath import VerdictFastpath

        self.rebuild()
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        return VerdictFastpath(
            self._mat[direction].snapshots, direction=direction
        )

    def _publish_shed_locked(self, policymap_moved: bool) -> None:
        """Publish the prefilter shed table of the current ingress
        policymap mirror (None while the Prefilter option is off),
        compiled again whenever the mirror was re-made or patched."""
        if not self._shed_requested:
            self._shed_cache = None
            self._shed_tab = None
            return
        mat_in = self._mat.get(TRAFFIC_INGRESS)
        if mat_in is None:
            self._shed_tab = None
            return
        if policymap_moved or self._shed_cache is None or self._shed_cache[0] is not mat_in:
            tab = compile_shed_table(mat_in.allow_nc, mat_in.ep_slots)
            self._shed_cache = (mat_in, shed_table_from_numpy(tab, self.device))
        self._shed_tab = self._shed_cache[1]

    def _refresh_lb_locked(self, held: bool = False) -> None:
        # LB tables: deterministic backend selection means backend
        # churn changes the translated CT key (a natural miss), but
        # entries created while a flow was NOT translated would bypass
        # the new service table — so any LB move flushes too. Unless
        # ``held`` (the restore hold): restored services come from the
        # same saved state as the restored CT entries, which were
        # translated under exactly these tables.
        if self.lb is not None and self.lb.version != self._lb_version:
            lb_ver = self.lb.version
            self._lb_tables = self.lb.build_device(device=self.device)
            self._lb_version = lb_ver
            if not held:
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

    def _account_batch(self, verdict: np.ndarray, shard_of: Optional[np.ndarray] = None) -> None:
        """Registry accounting for one completed batch (the metricsmap →
        pkg/metrics bridge), from the pulled host verdicts. ``shard_of``
        ([B] flow shard of each flow, sharded dispatches only) switches
        verdicts_total to per-shard ``device`` series."""
        _metrics.verdict_batches.inc({"path": "pipeline"})
        # one count per outcome over the int8 verdicts: the reference's
        # bincount casts a 1M-flow batch to int64 first, several times
        # the cost
        parts = [({}, verdict)] if shard_of is None else [
            ({"device": str(int(d))}, verdict[shard_of == d]) for d in np.unique(shard_of)]
        for labels, v in parts:
            for code, outcome in _OUTCOME_NAMES:
                n = int(np.count_nonzero(v == code))
                if n:
                    _metrics.verdicts_total.inc({"outcome": outcome, **labels}, float(n))

    # -- flow events and the flow ring ----------------------------------
    def _peer_identities(self, u8: np.ndarray, family: int) -> np.ndarray:
        """[N] identity of each peer ([N, 4 | 16] uint8 address rows) as
        the host ipcache's ``lookup_by_ip`` gives it: the entry of the
        longest prefix holding the address, 0 for none. ``lookup_by_ip``
        formats up to 129 prefixes an address; here the ipcache is read
        once per version as one {network: identity} table a prefix
        length, and each distinct address is resolved once."""
        cache = self.ipcache
        version = cache.version
        index = self._peer_index
        if index is None or index[0] != version:
            tabs: Dict[int, Dict[int, Dict[int, int]]] = {4: {}, 6: {}}
            for key, entry in cache.items():
                net = ipaddress.ip_network(key)
                tabs[net.version].setdefault(net.prefixlen, {})[
                    int(net.network_address)] = entry.identity
            index = (version, {f: sorted(t.items(), reverse=True) for f, t in tabs.items()})
            if cache.version == version:
                self._peer_index = index
        levels = index[1][family]
        width = 32 if family == 4 else 128
        keys = u8.view(np.dtype((np.void, u8.shape[1]))).ravel()
        uniq, inv = np.unique(keys, return_inverse=True)
        out = np.zeros(len(uniq), np.int64)
        for k, key in enumerate(uniq):
            a = int.from_bytes(key.tobytes(), "big")
            for plen, tab in levels:
                ident = tab.get(a >> (width - plen) << (width - plen))
                if ident is not None:
                    out[k] = ident
                    break
        return out[inv.reshape(-1)]

    def _drop_reasons(self, verdict: np.ndarray, rule, l4_covered) -> np.ndarray:
        """[B] monitor reason of each flow's verdict (0 for FORWARD); with
        attribution arrays a policy drop carries its attributed reason
        (deny rule, no L4 allow, no L3 allow) instead of REASON_POLICY."""
        codes = verdict.astype(np.int64)
        pol = codes == DROP_POLICY
        reasons = np.select(
            [pol, codes == DROP_PREFILTER, codes == DROP_NO_SERVICE, codes == DROP_DEGRADED],
            [REASON_POLICY, REASON_PREFILTER, REASON_NO_SERVICE, REASON_PIPELINE_DEGRADED], 0)
        if rule is not None:
            l4 = np.zeros(codes.shape[0], bool) if l4_covered is None else l4_covered
            reasons = np.where(pol & (rule >= 0), REASON_POLICY_DENY, np.where(
                pol & l4, REASON_POLICY_NO_L4, np.where(pol, REASON_POLICY_NO_L3, reasons)))
        return reasons

    def _emit_flow_events(
        self,
        fl: _Batch,
        verdict: np.ndarray,
        *,
        ingress: bool,
        redirect: Optional[np.ndarray] = None,
        rule: Optional[np.ndarray] = None,
        l4_covered: Optional[np.ndarray] = None,
        producer: str = "prefilter",
    ) -> None:
        """Publish a DropNotify per dropped flow of ``fl``, with
        ``trace_enabled`` a TraceNotify per forwarded flow (to-proxy when
        redirected) and with ``verdict_notifications`` a
        PolicyVerdictNotify per flow, in that order and each in flow
        order, as one ``publish_many``. Runs only while the monitor has a
        listener; with no ``endpoint_options`` resolver each switch holds
        for the whole batch, else the resolver is asked per flow (a
        programmer error in it raises, any other fault gives the
        default). The peer identity is the host ipcache's. ``producer``
        names reason 144's emitter on its DropNotify ("prefilter": the
        device path, "admission": the host gate). With attribution arrays
        (``rule`` / ``l4_covered``) a policy drop carries its attributed
        reason. Everything read is host memory the batch already holds."""
        hub = self.monitor
        if hub is None or not hub.active:
            return
        family = fl.family
        b = verdict.shape[0]
        resolver = self.endpoint_options
        ep_idx = fl.ep_idx.astype(np.int64)
        ids = np.asarray(self._endpoint_ids, np.int64)
        # the endpoint id of each flow, its index where it has none
        ok = (ep_idx >= 0) & (ep_idx < ids.shape[0])
        ep_ids = ep_idx.copy()
        ep_ids[ok] = ids[ep_idx[ok]]

        def gated(lanes: np.ndarray, name: str, default: bool) -> np.ndarray:
            if resolver is None:
                return lanes if default else lanes[:0]
            keep = []
            for i in lanes.tolist():
                try:
                    on = bool(resolver(int(ep_ids[i]), name, default))
                except Exception as e:
                    # a transient or poisoned resolver fault degrades to
                    # the default; a programmer error in it surfaces
                    if _faults.classify(e) == _faults.KIND_ERROR:
                        raise
                    on = default
                if on:
                    keep.append(i)
            return np.asarray(keep, np.int64)

        drops = gated(np.nonzero(verdict >= DROP_POLICY)[0], "DropNotification",
                      self.drop_notifications)
        # forwarded flows are the bulk of a batch: walked only when traces
        # or verdict events can be on
        traces = verdict_lanes = drops[:0]
        if self.trace_enabled or resolver is not None:
            traces = gated(np.nonzero(verdict == FORWARD)[0], "TraceNotification",
                           self.trace_enabled)
        if self.verdict_notifications or resolver is not None:
            verdict_lanes = gated(np.arange(b), "PolicyVerdictNotification",
                                  self.verdict_notifications)
        if not (drops.size or traces.size or verdict_lanes.size):
            return
        need = np.unique(np.concatenate([drops, traces, verdict_lanes]))
        raw = np.ascontiguousarray(fl.bytes_at(need) & 0xFF, dtype=np.uint8)
        src = self._peer_identities(raw, family)
        width = raw.shape[1]
        blob = raw.tobytes()
        addrs = [blob[k:k + width] for k in range(0, len(blob), width)]
        reasons = self._drop_reasons(verdict, rule, l4_covered)

        def cols(lanes):
            """(endpoint, src_identity, family, peer_addr, dport, proto,
            ingress) columns of ``lanes``, as the events' positional
            fields after their first ones."""
            rows = np.searchsorted(need, lanes)  # each flow's row of ``raw``
            n = lanes.size
            return (ep_ids[lanes].tolist(), src[rows].tolist(), repeat(family, n),
                    [addrs[k] for k in rows.tolist()], fl.dports[lanes].tolist(),
                    fl.protos[lanes].tolist(), repeat(ingress, n))

        # one map a kind over column lists: a 1M-flow batch's events are
        # built without a Python loop body of their own
        r = reasons[drops].tolist()
        events = list(map(DropNotify, r, *cols(drops),
                          [producer if x == REASON_PREFILTER else "" for x in r]))
        if traces.size:
            proxy = np.zeros(traces.size, bool) if redirect is None else redirect[traces]
            obs = np.where(proxy, TRACE_TO_PROXY, TRACE_TO_ENDPOINT).tolist()
            events.extend(map(TraceNotify, obs, *cols(traces)))
        if verdict_lanes.size:
            lanes = verdict_lanes
            fwd = verdict[lanes] == FORWARD
            red = np.zeros(lanes.size, bool) if redirect is None else redirect[lanes].astype(bool)
            action = np.where(fwd, np.where(red, 2, 1), 0).tolist()
            reason = np.where(fwd, np.where(red, REASON_PROXY_REDIRECT, REASON_UNKNOWN),
                              reasons[lanes]).tolist()
            ri = (np.full(lanes.size, -1) if rule is None else rule[lanes]).tolist()
            events.extend(map(PolicyVerdictNotify, action, reason, *cols(lanes), ri))
        hub.publish_many(events)

    def _rule_origins(self) -> List[dict]:
        """``repo.rule_origins()``, made once per repository revision
        (the index → origin table the records name; a 10k-rule table
        takes tens of ms to build, longer than the rest of a sample)."""
        repo = self.engine.repo
        rev = repo.revision
        cached = self._origins
        if cached is None or cached[0] is not repo or cached[1] != rev:
            cached = self._origins = (repo, rev, repo.rule_origins())
        return cached[2]

    def _record_flows(
        self,
        fl: _Batch,
        verdict: np.ndarray,
        rule: np.ndarray,
        l4x: np.ndarray,
        redirect: Optional[np.ndarray],
        *,
        ingress: bool,
    ) -> None:
        """The flow ring's sample of one attributed batch: at most
        SAMPLE_CAP FlowRecords, the drops first (the rare, interesting
        tail), then forwarded flows for the rest, so the host cost is
        bounded whatever the batch size. Runs only while the ring is
        active; the record time is ``observe.flows.now()``."""
        ring = self.flow_ring
        if not ring.active:
            return
        take = np.nonzero(verdict >= DROP_POLICY)[0][:_FLOW_SAMPLE_CAP]
        if take.size < _FLOW_SAMPLE_CAP:
            take = np.concatenate([
                take, np.nonzero(verdict == FORWARD)[0][:_FLOW_SAMPLE_CAP - take.size]])
        if not take.size:
            return
        origins = self._rule_origins()
        outcome = dict(_OUTCOME_NAMES)
        labels_of = self.identity_labels
        ts = _flows.now()
        raw = np.ascontiguousarray(fl.bytes_at(take) & 0xFF, dtype=np.uint8)
        peer_ids = self._peer_identities(raw, fl.family).tolist()
        reasons = self._drop_reasons(verdict[take], rule[take], l4x[take])
        endpoints = self._endpoints

        def labels(ident: int) -> Tuple[str, ...]:
            if labels_of is None:
                return ()
            try:
                return tuple(labels_of(ident))
            except Exception as e:
                # unlabeled records on environmental faults only: a
                # buggy resolver surfaces
                if _faults.classify(e) == _faults.KIND_ERROR:
                    raise
                return ()

        recs = []
        for k, i in enumerate(take.tolist()):
            code = int(verdict[i])
            ri = int(rule[i])
            reason = int(reasons[k])
            if code == FORWARD and redirect is not None and bool(redirect[i]):
                reason = REASON_PROXY_REDIRECT
            peer_ip = str(ipaddress.ip_address(raw[k].tobytes()))
            idx = int(fl.ep_idx[i])
            ep_ident = endpoints[idx] if 0 <= idx < len(endpoints) else 0
            # ingress = peer → endpoint, egress = endpoint → peer (only
            # the peer side carries an address)
            src_id, dst_id = ((peer_ids[k], ep_ident) if ingress else (ep_ident, peer_ids[k]))
            recs.append(FlowRecord(
                ts=ts,
                direction="ingress" if ingress else "egress",
                src_identity=src_id,
                dst_identity=dst_id,
                src_labels=labels(src_id),
                dst_labels=labels(dst_id),
                src_ip=peer_ip if ingress else "",
                dst_ip="" if ingress else peer_ip,
                dport=int(fl.dports[i]),
                proto=int(fl.protos[i]),
                verdict=code,
                verdict_name=outcome.get(code, str(code)),
                reason=reason,
                reason_name="allowed" if reason == 0 else reason_name(reason),
                rule_index=ri,
                rule_origin=origins[ri] if 0 <= ri < len(origins) else None,
            ))
        ring.push_many(recs)

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

    # -- pinned staging ------------------------------------------------
    # free-list bound per key: deeper queues keep more tuples in flight,
    # but beyond this the allocations were a burst, not steady state
    _STAGING_FREE_CAP = 8

    def _staging_acquire(self, key: tuple, make):
        """One pinned tuple for ``key``, off its free-list or made by
        ``make()`` on first use (pinned memory is allocated once, not
        per batch: a pin of 4-16 MB takes milliseconds)."""
        with self._staging_lock:
            free = self._staging.get(key)
            if free:
                return free.pop()
        return make()

    def _staging_release(self, tuples) -> None:
        """Return a completed batch's pinned tuples to their free-lists
        (called from the completion half only, after its event)."""
        with self._staging_lock:
            for key, bufs in tuples:
                free = self._staging.setdefault(key, [])
                if len(free) < self._STAGING_FREE_CAP:
                    free.append(bufs)

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """A staging buffer: page-locked for the card (an asynchronous
        copy from pageable memory runs synchronously), plain on the
        CPU."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    @staticmethod
    def _shard_spans(b: int, ndev: int) -> List[Tuple[int, int]]:
        """[(lo, hi)] of each flow shard of a b-flow batch: the
        reference's ``_shard_map`` widths (``ceil(b / ndev)``, as its
        padded split gives), the last shard shorter, since nothing is
        padded; one span without a plan."""
        if ndev <= 1:
            return [(0, b)]
        w = max(1, -(-b // ndev))
        return [(min(k * w, b), b if k == ndev - 1 else min((k + 1) * w, b)) for k in range(ndev)]

    @classmethod
    def _shard_map(cls, b: int, ndev: int) -> np.ndarray:
        """[B] flow shard of each flow (the reference's ``_shard_map``)."""
        widths = [hi - lo for lo, hi in cls._shard_spans(b, ndev)]
        return np.repeat(np.arange(ndev, dtype=np.int32), widths)

    # -- the failsafe's host rung (ladder level 2) ----------------------
    def _host_tables(self, direction: int) -> Optional[Tuple]:
        """Host numpy copy of one direction's policymap (col_ep,
        col_port, col_proto, col_is_l3, id_bits as uint32), cached on the
        source tables. The pull touches the device: a classified failure
        gives None, and the caller falls back to the fail policy."""
        mat = self._mat.get(direction)
        if mat is None:
            return None
        pm = mat.tables
        src, ht = self._host_pm.get(direction, (None, None))
        if src is pm:
            return ht
        try:
            ht = (
                pm.col_ep.cpu().numpy(),
                pm.col_port.cpu().numpy(),
                pm.col_proto.cpu().numpy(),
                pm.col_is_l3.cpu().numpy().astype(bool),
                # the int32 bit view as the words it carries
                pm.id_bits.cpu().numpy().view(np.uint32),
            )
        except BaseException as e:
            if _classify(e) == _faults.KIND_ERROR:
                raise
            return None
        self._host_pm[direction] = (pm, ht)
        return ht

    def _host_verdicts(self, fl: _Batch, *, ingress: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Numpy mirror of the device verdict path (the ladder's last
        rung): the peer's identity from the host ipcache, the source the
        tries are built from, then the policymap decision exactly as
        ``policymap_verdict`` makes it. O(B · C) numpy and a Python
        ipcache walk per flow: an emergency path, not a fast one. With
        the host tables out of reach: FORWARD under FailOpen, else
        DROP_DEGRADED."""
        import ipaddress as _ipa

        b = fl.ep_idx.shape[0]
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        ht = self._host_tables(direction)
        if ht is None:
            v = np.full(b, FORWARD if self._fail_open else DROP_DEGRADED, np.int8)
            if not self._fail_open and b:
                _metrics.drop_reasons_total.inc({"reason": "pipeline-degraded"}, float(b))
            return v, np.zeros(b, bool)
        col_ep, col_port, col_proto, col_is_l3, id_bits = ht
        peer_bytes = fl.bytes_()
        addrs = [_ipa.ip_address(bytes(int(x) & 0xFF for x in peer_bytes[i])) for i in range(b)]
        idents = np.empty(b, np.int64)
        for i, a in enumerate(addrs):
            e = self.ipcache.lookup_by_ip(str(a))
            idents[i] = ID_WORLD if e is None else e.identity
        rows = np.asarray(self.engine.rows_or_negative(idents))
        world = np.asarray(self.engine.rows_or_negative(np.array([ID_WORLD], np.int64)))[0]
        rows = np.where(rows < 0, world, rows).astype(np.int64)
        # the prefilter deny, ingress only as on the device
        pf_drop = np.zeros(b, bool)
        if ingress:
            _, pf_cidrs = self.prefilter.dump()
            nets = [_ipa.ip_network(c) for c in pf_cidrs if (":" in c) == (fl.family == 6)]
            if nets:
                for i, a in enumerate(addrs):
                    pf_drop[i] = any(a in n for n in nets)
        w = id_bits.shape[1] // 2
        gathered = id_bits[np.clip(rows, 0, id_bits.shape[0] - 1)]
        shifts = np.arange(32, dtype=np.uint32)
        both = ((gathered[:, :, None] >> shifts) & np.uint32(1)).astype(bool).reshape(b, -1)
        c = col_ep.shape[0]
        allow_bits = both[:, : w * 32][:, :c]
        red_bits = both[:, w * 32:][:, :c]
        ep = np.asarray(fl.ep_idx, np.int64)
        # col_ep's -1 padding matches no endpoint
        colsel = (ep[:, None] == col_ep[None, :]) & (
            col_is_l3[None, :]
            | ((np.asarray(fl.dports)[:, None] == col_port[None, :])
               & (np.asarray(fl.protos)[:, None] == col_proto[None, :])))
        hit = colsel & allow_bits
        allow = hit.any(axis=1)
        red = (hit & red_bits).any(axis=1)
        v = np.where(allow, np.int8(FORWARD), np.int8(DROP_POLICY))
        v = np.where(pf_drop, np.int8(DROP_PREFILTER), v).astype(np.int8)
        return v, (red & (v == FORWARD))

    def _host_enqueue(self, st, fl: _Batch, sel, *, ingress: bool, bt=_NOOP_BATCH) -> _Enqueued:
        """``_dispatch_enqueue`` at ladder level 2: the verdicts of the
        flows ``sel`` (None = all) computed on the host now, carried
        finished in ``done`` so the completion half runs unchanged and
        touches no device. With attribution the host rung decides no
        rule: every flow's rule is -1 and nothing is counted as a hit."""
        with bt.phase("dispatch"):
            part = fl if sel is None else fl.take(sel)
            v, red = self._host_verdicts(part, ingress=ingress)
        b = v.shape[0]
        if st[3] is None:
            done = (v, red, None, None, None, None)
        else:
            done = (v, red, None, np.full(b, -1, np.int32), np.zeros(b, bool), None)
        return _Enqueued((), [], [], [], [], done=done)

    def _dispatch_enqueue(self, st, fl: _Batch, sel, row_override, *, ingress: bool,
                          bt=_NOOP_BATCH) -> _Enqueued:
        """The enqueue half of the device work for the flows ``sel``
        (None = all), at their exact shape: stage the int32 inputs in a
        pinned tuple, copy them to the card and launch the LPM walks and
        the policymap verdict, then copy the outputs into pinned buffers
        and record one event after the copies. Nothing here waits for
        the card. On the CPU the same staging runs with plain buffers
        and the plain versions compute at once (no event).

        Under a plan (``st``'s placed view) the flows split into the
        plan's flow shards: each shard's inputs go to its grid row's
        first device and run against that row's tables (the 2D plan's
        row reads as ``_verdict_tail`` says); the per-flow outputs
        land in their slices of the pinned buffers, the counters and
        rule hits are summed on the pipeline's device, and one event is
        recorded per device.

        ``bt`` is the batch's trace: the work above is its ``dispatch``
        phase, and while tracing is on the launch shapes and the bytes
        copied in are counted. A dispatch the profiler samples stamps
        its split (``_Split``) around each shard's copies in and
        launches, and makes the final events timing ones.

        At ladder level 2 the host rung verdicts the flows instead
        (``_host_enqueue``). The SITE_DISPATCH and SITE_H2D checks come
        before any staging tuple is taken, so a retry leaks none."""
        if self._ladder_level >= 2:
            return self._host_enqueue(st, fl, sel, ingress=ingress, bt=bt)
        if _faults.hub.active:
            _faults.hub.check(_faults.SITE_DISPATCH)
            _faults.hub.check(_faults.SITE_H2D)
        t, pf_empty, v6_fused, rule_tab, n_rules, ep_count, _lbt, placed = st

        def part(a):
            return a if sel is None else a[sel]

        attrib = rule_tab is not None
        cuda = self.device.type == "cuda"
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        if fl.family == 4:
            peer = part(fl.peer_u32).astype(np.uint32, copy=False).view(np.int32)
        else:
            peer = part(fl.peer_bytes)
        flows = (peer, part(fl.ep_idx), part(fl.dports), part(fl.protos),
                 None if row_override is None else part(row_override))
        b = peer.shape[0]
        if placed is None:
            shards = [(0, b, self.device, t, rule_tab)]
            ident2d = False
            ndev = 1
        else:
            ident2d = placed.ident2d
            ndev = len(placed.rows)
            shards = []
            for (lo, hi), (dev, tabs, rts) in zip(self._shard_spans(b, ndev), placed.rows):
                if hi > lo or not shards:
                    shards.append((lo, hi, dev, tabs[(direction, fl.family)],
                                   None if rts is None else rts[direction]))
        # the XDP prefilter guards traffic entering the node only, and
        # an empty deny set skips the walk
        pf_stage = ingress and not pf_empty
        has_ro = row_override is not None
        if self.tracer.active:
            # a launch shape not seen on this pipeline is a "miss" (the
            # reference's jit cache key: shape and static arguments)
            for lo, hi, *_ in shards:
                key = (direction, fl.family, hi - lo, pf_stage, ep_count, has_ro, v6_fused,
                       ndev > 1, attrib, ident2d)
                hit = key in self._seen_shapes
                self._seen_shapes.add(key)
                _metrics.jit_shape_buckets_total.inc(
                    {"site": "dispatch", "result": "hit" if hit else "miss"})
            n_in = 4 + has_ro
            _metrics.device_transfers_total.inc({"direction": "h2d"}, float(n_in * len(shards)))
            # the int32 staging the copies read (a v6 peer: 16 words)
            _metrics.device_transfer_bytes_total.inc(
                {"direction": "h2d"}, float(4 * sum(a.size for a in flows if a is not None)))
            bt.mark(padded=b, chunks=len(shards))
        prof = self.profiler
        sample = prof.begin_dispatch("dispatch", b) if prof is not None else None
        split = None if sample is None else _Split(sample, cuda)
        with bt.phase("dispatch"):
            # capacity rounded up to a power of two: few keys, reused often
            cap = 1 if b <= 1 else 1 << (b - 1).bit_length()
            width = peer.shape[1:]
            key = ("in", fl.family, cap)
            bufs = self._staging_acquire(key, lambda: tuple(
                self._host_buffer((cap, *width) if i == 0 else (cap,), torch.int32)
                for i in range(len(flows))))
            staging = [(key, bufs)]
            views = []
            for buf, a in zip(bufs, flows):
                if a is None:
                    views.append(None)
                    continue
                view = buf[:b]
                view.numpy()[...] = a
                views.append(view)
            kw = dict(ep_count=ep_count, prefilter=pf_stage, attrib=attrib, n_rules=n_rules,
                      ident_gather=ident2d)
            outs, keep = [], [st]
            for lo, hi, dev, t_s, rt_s in shards:
                e0 = None if split is None else split.stamp(dev)
                ins = [None if v is None else v[lo:hi].to(dev, non_blocking=True) for v in views]
                e1 = None if split is None else split.stamp(dev)
                peer_t, ep_t, dp_t, pr_t, ro_t = ins
                keep += ins
                if fl.family == 4:
                    out = process_flows_wide(t_s, peer_t, ep_t, dp_t, pr_t, row_override=ro_t,
                                             rule_tab=rt_s, **kw)
                else:
                    out = process_flows(t_s, peer_t, ep_t, dp_t, pr_t, levels=16,
                                        fused=v6_fused, row_override=ro_t, rule_tab=rt_s, **kw)
                outs.append(out)
                if split is not None:
                    split.shards.append((dev, e0, e1, split.stamp(dev)))
                    prof.note_jit_cost(
                        "dispatch", (fl.family, hi - lo, pf_stage, ep_count, has_ro, v6_fused,
                                     attrib, ident2d), (t_s, rt_s, ins), out)
            n_hits = outs[0][5].shape[0] if attrib else 0
            key = ("out", cap, ep_count, n_hits)

            def make():
                shapes = [(cap, torch.int8), (cap, torch.bool), (ep_count * 3, torch.int32)]
                if attrib:
                    shapes += [(cap, torch.int32), (cap, torch.bool), (n_hits, torch.int32)]
                return tuple(self._host_buffer(n, dtype) for n, dtype in shapes)

            bufs = self._staging_acquire(key, make)
            staging.append((key, bufs))
            host = []
            for i, buf in enumerate(bufs):
                if i in (2, 5):  # counters, rule hits: one sum per batch
                    parts = [o[i] for o in outs]
                    x = parts[0] if len(parts) == 1 else torch.stack(
                        [p.to(self.device, non_blocking=True) for p in parts]).sum(dim=0).to(torch.int32)
                    keep.append(x)
                    view = buf[:x.numel()].view(x.shape)
                    view.copy_(x, non_blocking=cuda)
                else:
                    view = buf[:b]
                    for (lo, hi, *_), o in zip(shards, outs):
                        view[lo:hi].copy_(o[i], non_blocking=cuda)
                host.append(view)
            events = []
            for dev in dict.fromkeys([self.device, *(sh[2] for sh in shards)]):
                if cuda:
                    event = torch.cuda.Event(enable_timing=split is not None)
                    event.record(torch.cuda.current_stream(dev))
                    events.append(event)
                if split is not None:
                    split.ends[dev] = events[-1] if cuda else time.perf_counter()
            if sample is not None:
                sample.mark(rungs=[hi - lo for lo, hi, *_ in shards], lanes=b, pad_lanes=0,
                            chunks=len(shards), ndev=ndev, depth=self.pipeline_depth,
                            family=fl.family, bucketed=sel is not None)
        return _Enqueued(outs, host, events, staging, keep, ndev=ndev, bt=bt, split=split)

    def _dispatch_complete(self, enq: _Enqueued):
        """The completion half: wait on the batch's events, copy the
        outputs out of the staging and release it → (verdict, redirect,
        counters, rule, l4_covered, hits) numpy; the last three are None
        without attribution. Launches no device work, so any thread may
        run it. The wait and the copies are the batch's ``host_sync``
        phase; a sampled dispatch's split is read after the wait (its
        events have completed by then) and retired once. The result
        stays on ``enq``: a retried finish gets it again. A host-rung
        batch carries its result from the enqueue and never reaches the
        SITE_COMPLETE check, which fires before the wait, ahead of
        anything a retry could see changed."""
        if enq.done is not None:
            return enq.done
        if _faults.hub.active:
            _faults.hub.check(_faults.SITE_COMPLETE)
        if self.tracer.active:
            # per-flow outputs one copy a flow shard, the sums one each
            n_sum = 2 if len(enq.host) == 6 else 1
            _metrics.device_transfers_total.inc(
                {"direction": "d2h"}, float((len(enq.host) - n_sum) * len(enq.outs) + n_sum))
            _metrics.device_transfer_bytes_total.inc(
                {"direction": "d2h"}, float(sum(h.nbytes for h in enq.host)))
        with enq.bt.phase("host_sync"):
            for event in enq.events:
                event.synchronize()
            out = [np.array(h.numpy()) for h in enq.host]
        split = enq.split
        if split is not None:
            enq.split = None  # retired once, whatever a retry does
            split.close()
            prof = self.profiler
            if prof is not None:
                prof.complete(split.sample)
        self._staging_release(enq.staging)
        enq.host = enq.keep = enq.outs = None
        enq.done = (*out, None, None, None) if len(out) == 3 else tuple(out)
        return enq.done

    def _lb_stage(self, lbt, fl: _Batch, sports):
        """Egress VIP→backend translation (bpf_lxc.c:444-455: the
        service lookup precedes conntrack and the policy check, so CT
        tracks the backend tuple and policy sees the backend's
        identity) → (svc_drop [B] bool, revnat [B] uint16), both None
        when no flow hit a frontend; rewrites ``fl`` in place. It pulls
        its results at once, as the reference does: the CT pre-pass
        needs the translated flows on the host."""
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

    def _redirect_hook(self, fl: _Batch, sports, redirect: np.ndarray, *, ingress: bool) -> None:
        """proxymap handoff: redirected flows carry their full 5-tuple."""
        if self.on_redirect is not None and redirect.any():
            peer_bytes = fl.bytes_()
            for i in np.nonzero(redirect)[0]:
                self.on_redirect(
                    bytes(int(x) & 0xFF for x in peer_bytes[i]),
                    int(fl.ep_idx[i]), int(sports[i]), int(fl.dports[i]),
                    int(fl.protos[i]), ingress, fl.family,
                )

    def _submit_inner(
        self,
        fl: _Batch,
        sports: Optional[np.ndarray],
        *,
        ingress: bool,
        want_rev_nat: bool = False,
        tunnel_identities: Optional[np.ndarray] = None,
        bt=_NOOP_BATCH,
    ) -> _InFlight:
        """The enqueue half of one batch of either family: rebuild,
        overlay rows, the LB stage, then either the whole batch on the
        device (no CT) or the CT pre-pass with only its misses on the
        device. Returns the batch with its ``finish`` closure, the
        completion half: counters, CT creation, the redirect hook, the
        attribution metrics, the batch metrics, then the flow events and
        the flow ring's sample (the ``emit_events`` phase). Each stage is
        a phase of ``bt``, where the reference opens it."""
        with bt.phase("rebuild"):
            self.rebuild()
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        family = fl.family
        with bt.phase("prepare"):
            with self._lock:
                st = (
                    self._tables[(direction, family)],
                    self._pf_empty[0 if family == 4 else 1],
                    self._v6_fused,
                    self._rule_tabs[direction] if self._rule_tabs is not None else None,
                    self._attrib_n_rules,
                    max(1, len(self._endpoints)),
                    self._lb_tables.get(family) if self.lb is not None else None,
                    # the plan's dispatch view, published with the tables
                    self._placed,
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
        if not ingress and self.lb is not None:
            with bt.phase("lb_translate"):
                if lbt is not None:
                    svc_drop, revnat_vals = self._lb_stage(lbt, fl, sports)

        # device-resident conntrack: the table is updated in place batch
        # to batch, so this path stays synchronous. An LB family falls
        # back to the host CT in BOTH directions: the CT is one
        # bidirectional structure, and an egress VIP flow's entry must
        # be visible to its reply. At ladder level 2 every batch takes
        # the host CT and the host rung.
        if (
            self._device_ct_bits is not None
            and self._ladder_level < 2
            and sports is not None
            and svc_drop is None
            and row_override is None
            and lbt is None
        ):
            pending = PendingBatch(self)
            pending._value = self._process_device_ct(fl, sports, ingress=ingress,
                                                     want_rev_nat=want_rev_nat, bt=bt)
            pending._event.set()
            return _InFlight(pending, None)

        ct = self.conntrack
        if ct is None or sports is None:
            # no CT: the whole batch takes the device path
            enq = self._dispatch_enqueue(st, fl, None, row_override, ingress=ingress, bt=bt)

            def finish():
                v, red, counters, rule, l4x, hits = self._dispatch_complete(enq)
                with bt.phase("counters"):
                    if svc_drop is not None and svc_drop.any():
                        v = np.where(svc_drop, np.int8(DROP_NO_SERVICE), v)
                        red = red & ~svc_drop
                        # the device counters classified these flows
                        # before the override: count this batch on the
                        # host instead
                        counters = None
                        if rule is not None:
                            # no-backend flows never reached a rule: drop
                            # their attribution, re-derive the hit sums
                            rule = np.where(svc_drop, np.int32(-1), rule)
                            hits = None
                    if counters is None:
                        self._add_host_counters(v, fl.ep_idx)
                    else:
                        with self._lock:
                            if self.counters.shape == counters.shape:
                                self.counters += counters
                    # per flow shard under a plan, so a hot shard shows
                    self._account_batch(
                        v, shard_of=self._shard_map(b, enq.ndev) if enq.ndev > 1 else None)
                    if rule is not None:
                        self._account_attribution(v, rule, l4x, hits, ingress=ingress)
                with bt.phase("emit_events"):
                    self._emit_flow_events(fl, v, ingress=ingress, redirect=red, rule=rule,
                                           l4_covered=l4x)
                    if rule is not None:
                        self._record_flows(fl, v, rule, l4x, red, ingress=ingress)
                if want_rev_nat:
                    # no CT → replies can't be recognized → no restore
                    return v, red, np.zeros(b, np.uint16)
                return v, red

            return _InFlight(PendingBatch(self), finish, b=b, rev=want_rev_nat)

        # --- conntrack pre-pass (vectorized host) ----------------------
        with bt.phase("ct_prepass"):
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
        enq = midx = None
        if miss.any():
            # the miss tail, at its exact shape
            midx = np.nonzero(miss)[0]
            enq = self._dispatch_enqueue(st, fl, midx, row_override, ingress=ingress, bt=bt)
        # no CT entry is created under a basis that moved after this point
        ct_epoch = self._ct_epoch

        def finish():
            verdict = np.full(b, FORWARD, np.int8)
            redirect = np.zeros(b, bool)
            rule_full = l4x_full = None
            if enq is not None:
                v, red, _counters, at_rule, at_l4x, at_hits = self._dispatch_complete(enq)
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
                    # CT-bypassed flows took no policy decision this
                    # batch (rule -1, reason "allowed"): only the tail's
                    # decisions count
                    rule_full = np.full(b, -1, np.int32)
                    l4x_full = np.zeros(b, bool)
                    rule_full[midx] = at_rule
                    l4x_full[midx] = at_l4x
                    self._account_attribution(v, at_rule, at_l4x, at_hits, ingress=ingress)
                # CT entries for newly allowed flows (ct_create4,
                # bpf_lxc.c:~560: only successful verdicts create
                # state). L7-redirect flows are EXCLUDED: a CT bypass
                # would return redirect=False on later packets and
                # route them around the proxy.
                ok = (v == FORWARD) & ~red
                if ok.any() and self.conntrack is ct and self._ct_epoch == ct_epoch:
                    with bt.phase("ct_create"):
                        oidx = midx[ok]
                        ct.create_batch(
                            ka[oidx], kb[oidx], kc[oidx],
                            revnat=None if revnat_vals is None else revnat_vals[oidx],
                        )
            self._redirect_hook(fl, sports, redirect, ingress=ingress)
            # host counter accumulation (CT hits included)
            with bt.phase("counters"):
                self._add_host_counters(verdict, fl.ep_idx)
                self._account_batch(verdict)
            with bt.phase("emit_events"):
                self._emit_flow_events(fl, verdict, ingress=ingress, redirect=redirect,
                                       rule=rule_full, l4_covered=l4x_full)
                if rule_full is not None:
                    self._record_flows(fl, verdict, rule_full, l4x_full, redirect, ingress=ingress)
            if want_rev_nat:
                # revNAT restore (bpf/lib/lb.h lb4_rev_nat via the CT
                # entry's rev_nat_index): REPLY hits carry the id of the
                # service that translated the original request
                return verdict, redirect, ct_rev
            return verdict, redirect

        return _InFlight(PendingBatch(self), finish, b=b, rev=want_rev_nat)

    def _process_device_ct(self, fl: _Batch, sports, *, ingress: bool, want_rev_nat: bool,
                           bt=_NOOP_BATCH):
        """One batch through :func:`process_flows_ct` at its exact shape
        (there is no compile cache to pad for): the tables and the CT
        state are read under one lock hold, so a flush between them
        cannot pair old-basis verdicts with a fresh table. Adds the
        device counters, accounts the batch and calls ``on_redirect``;
        attributes nothing, and returns zero revNAT ids (no LB table is
        active here). The copies in and the launches are the batch's
        ``dispatch`` phase, the two pulls ``host_sync`` phases. The
        profiler samples this path too (the reference's fused program
        has no sample): its copies out are synchronous pulls, so the
        last stamp follows them and is waited on at once."""
        direction = TRAFFIC_INGRESS if ingress else TRAFFIC_EGRESS
        family = fl.family
        b = fl.ep_idx.shape[0]
        if b and not (0 <= fl.ep_idx.min() and fl.ep_idx.max() < 1 << 23):
            raise ValueError("device CT: ep_idx outside the 23 bits of the kc word")
        sports = np.asarray(sports, np.int32)
        now = int(time.monotonic())
        prof = self.profiler
        sample = prof.begin_dispatch("dispatch", b) if prof is not None else None
        split = None if sample is None else _Split(sample, self.device.type == "cuda")
        dev = self.device
        with self._lock:
            t = self._tables[(direction, family)]
            if self._device_ct is None:
                # after a quarantine rescued the device entries into the
                # host table, the fresh table seeds from it, so the
                # rescued flows stay established on the device path
                if self._device_ct_seed and self.conntrack is not None:
                    self._device_ct_seed = False
                    self._device_ct = self._seed_device_ct()
                else:
                    self._device_ct = make_state(self._device_ct_bits, device=dev)
            prefilter = ingress and not self._pf_empty[0 if family == 4 else 1]
            fused = self._v6_fused if family == 6 else False
            ep_count = max(1, len(self._endpoints))
            with bt.phase("dispatch"):
                e0 = None if split is None else split.stamp(dev)
                if family == 4:
                    peer = self._up(fl.peer_u32.astype(np.uint32, copy=False).view(np.int32), np.int32)
                else:
                    peer = self._up(fl.peer_bytes, np.int32)
                ins = [peer] + [self._up(a, np.int32) for a in (fl.ep_idx, fl.dports, fl.protos, sports)]
                valid = torch.ones(b, dtype=torch.bool, device=dev)
                e1 = None if split is None else split.stamp(dev)
                v, red, counters = process_flows_ct(
                    t, self._device_ct, *ins, 0 if ingress else 1, now, valid,
                    ep_count=ep_count, prefilter=prefilter, levels=16, family=family, fused=fused,
                )
                if split is not None:
                    split.shards.append((dev, e0, e1, split.stamp(dev)))
                    prof.note_jit_cost("dispatch", ("ct", family, b, prefilter, ep_count, fused),
                                       (t, self._device_ct, ins, valid), (v, red, counters))
            with bt.phase("host_sync"):
                counters = counters.cpu().numpy()
            if self.counters.shape == counters.shape:
                self.counters += counters
        with bt.phase("host_sync"):
            verdict = v.cpu().numpy()
            redirect = red.cpu().numpy()
        if split is not None:
            end = split.ends[dev] = split.stamp(dev)
            if split.cuda:
                end.synchronize()  # recorded after the pulls' own waits
            split.close()
            sample.mark(rungs=[b], lanes=b, pad_lanes=0, chunks=1, ndev=1,
                        depth=self.pipeline_depth, family=family, bucketed=False, device_ct=True)
            prof.complete(sample)
        with bt.phase("counters"):
            self._account_batch(verdict)
        self._redirect_hook(fl, sports, redirect, ingress=ingress)
        # not attributed: drops keep the generic policy reason
        self._emit_flow_events(fl, verdict, ingress=ingress, redirect=redirect)
        if want_rev_nat:
            return verdict, redirect, np.zeros(b, np.uint16)
        return verdict, redirect

    # -- bounded in-flight queue ---------------------------------------
    def _complete_oldest(self) -> bool:
        """Pull and finish the oldest in-flight batch. Returns False when
        nothing was queued. The finish closure runs OUTSIDE the queue
        lock, under classification (``_finish_guarded``): a transient
        fault retries, a poisoned one quarantines into a degraded
        result, and only an error comes back for ``result()`` to raise."""
        with self._queue_lock:
            if not self._inflight:
                return False
            inf = self._inflight.popleft()
            _metrics.pipeline_inflight_depth.set(float(len(self._inflight)))
        # the completion half's clock (the tuner's latency signal), only
        # for batches admitted while the tuner was on
        tuner = self._tuner
        t0 = time.perf_counter_ns() if tuner is not None and inf.enq_ns else 0
        adm = self._admission
        wd = self._watchdog
        try:
            # the watchdog's stall clock starts when a thread pulls the
            # batch: batches nobody is pulling yet are no stall
            if wd is not None:
                self._completing = (inf, time.monotonic())
            try:
                value, exc = self._finish_guarded(inf)
            except Exception as e:  # the quarantine itself failed: result() raises it
                value, exc = None, e
            # value and event published together under the queue lock,
            # where the watchdog decides abandonment: an abandoned batch is
            # resolved by the watchdog (or the drain), which sets its event
            # after its degraded value, and a late result never overwrites
            # it (the reference sets the event here regardless, so a
            # waiter could read the empty value in between)
            with self._queue_lock:
                if not inf.abandoned:
                    inf.pending._value = value
                    inf.pending._exc = exc
                    inf.pending._event.set()
        finally:
            if wd is not None:
                self._completing = None
            if not inf.abandoned and not inf.pending._event.is_set():
                inf.pending._event.set()  # an interrupt on the way: never park a waiter
            if inf.bt is not _NOOP_BATCH:
                inf.bt.end(self.monitor)
        if adm is not None and inf.t0:
            adm.observe_completion(time.monotonic() - inf.t0)
        if t0:
            new_depth = tuner.observe(self.pipeline_depth, inf.b, inf.enq_ns,
                                      time.perf_counter_ns() - t0, inf.occ)
            # the armistice with the admission gate: while it shed
            # recently, the tuner never probes the queue deeper (two
            # controllers pushing one knob apart would oscillate)
            if new_depth is not None and not (
                new_depth > self.pipeline_depth and adm is not None and adm.shedding()
            ):
                self._apply_depth(new_depth)
        # the one-shot first-completion hook; one attribute read unset
        cb = self.on_first_batch
        if cb is not None:
            self.on_first_batch = None
            # a measurement hook never fails the batch it measures
            try:
                cb()
            except Exception:
                pass
        return True

    def _complete_until(self, pending: PendingBatch) -> None:
        """Complete in-flight batches FIFO until ``pending`` is done. An
        empty queue with ``pending`` still unset means another thread
        popped it and is mid-finish — the caller's event wait covers
        that."""
        while not pending.done:
            if not self._complete_oldest():
                return

    def begin_drain(self) -> None:
        """Stop admitting new batches (graceful drain): later submits
        resolve at once with the degraded shape while drain()
        FIFO-completes the in-flight queue."""
        self._draining = True

    def end_drain(self) -> None:
        """Re-open admission (a drain not followed by process exit)."""
        self._draining = False

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Complete every in-flight batch FIFO. With a deadline, batches
        still queued when it expires resolve DEGRADED instead of
        blocking: a drain never loses a verdict, it only downgrades late
        ones. → {completed, abandoned}."""
        completed = 0
        limit = time.monotonic() + deadline_s if deadline_s is not None else None
        while limit is None or time.monotonic() < limit:
            if not self._complete_oldest():
                break
            completed += 1
        abandoned = 0
        while True:
            with self._queue_lock:
                if not self._inflight:
                    break
                inf = self._inflight.popleft()
                inf.abandoned = True
                _metrics.pipeline_inflight_depth.set(float(len(self._inflight)))
            inf.pending._value = self._degraded_result(inf)
            inf.pending._event.set()
            if inf.bt is not _NOOP_BATCH:
                inf.bt.end(self.monitor)
            abandoned += 1
        return {"completed": completed, "abandoned": abandoned}

    @property
    def inflight_depth(self) -> int:
        return len(self._inflight)

    def _degraded_result(self, inf: _InFlight):
        """Shape-correct result for a batch that will not be verdicted
        (drained, quarantined): FORWARD under FailOpen, DROP_DEGRADED (monitor reason
        155) fail-closed. Never an exception; the batch still lands in
        verdicts_total and drop_reasons_total, but not in the
        per-endpoint counters (its flows are no longer at hand)."""
        b = max(0, inf.b)
        if self._fail_open:
            v = np.full(b, FORWARD, np.int8)
        else:
            v = np.full(b, DROP_DEGRADED, np.int8)
            if b:
                _metrics.drop_reasons_total.inc({"reason": "pipeline-degraded"}, float(b))
        self._account_batch(v)
        red = np.zeros(b, bool)
        if inf.rev:
            return v, red, np.zeros(b, np.uint16)
        return v, red

    def _submit(
        self,
        fl: _Batch,
        sports: Optional[np.ndarray],
        *,
        ingress: bool,
        want_rev_nat: bool = False,
        tunnel_identities: Optional[np.ndarray] = None,
        gate: bool = True,
    ) -> PendingBatch:
        """Trace shell and queue admission around :meth:`_submit_inner`:
        the admission gate (one attribute read while it is off), the
        draining shell, the enqueue half, then the bounded queue —
        admission beyond ``pipeline_depth`` completes the oldest batch
        first. While tracing is on the batch's trace opens here (kind
        ``v{family}-{ingress|egress}``), leaves this thread's span stack
        once the enqueue half returns and ends when the batch completes;
        off, the cost is one ``tracer.active`` read. While the tuner is
        on the enqueue half is timed here for it. ``gate=False`` is the
        gate's own re-entry for the kept part of a partially shed batch,
        which must not be gated twice."""
        if gate and self._admission is not None:
            gated = self._admission_gate(fl, sports, ingress=ingress, want_rev_nat=want_rev_nat,
                                         tunnel_identities=tunnel_identities)
            if gated is not None:
                return gated
        b = fl.ep_idx.shape[0]
        if self._draining:
            pending = PendingBatch(self)
            pending._value = self._degraded_result(_InFlight(pending, None, b=b, rev=want_rev_nat))
            pending._event.set()
            return pending
        tr = self.tracer
        # the enqueue half for the tuner: everything up to the queue
        # (prepare, CT pre-pass, h2d, launches)
        tuner = self._tuner
        t0 = time.perf_counter_ns() if tuner is not None else 0
        if tr.active:
            bt = tr.begin(f"v{fl.family}-{'ingress' if ingress else 'egress'}", b)
        else:
            bt = _NOOP_BATCH
        # the classified enqueue: a fault in the enqueue half (rebuild,
        # h2d, dispatch) retries bounded when transient, then resolves
        # the batch degraded; an error is raised. Each attempt takes a
        # copy of the batch, whose stages rebind its arrays (the LB stage
        # rewrites the peers), so a retry starts from the caller's flows.
        attempt = 0
        bo: Optional[Backoff] = None
        while True:
            try:
                inf = self._submit_inner(
                    dataclasses.replace(fl), sports, ingress=ingress, want_rev_nat=want_rev_nat,
                    tunnel_identities=tunnel_identities, bt=bt)
                break
            except BaseException as e:
                kind = _classify(e)
                if kind == _faults.KIND_ERROR:
                    if bt is not _NOOP_BATCH:
                        bt.end(self.monitor)
                    raise
                self._note_fault(e, kind)
                if kind == _faults.KIND_TRANSIENT and attempt < self.retry_limit:
                    attempt += 1
                    if bo is None:
                        bo = Backoff(min_s=self.retry_min_s, max_s=self.retry_max_s, jitter=False)
                    time.sleep(bo.duration())
                    continue
                if bt is not _NOOP_BATCH:
                    bt.end(self.monitor)
                pending = PendingBatch(self)
                pending._value = self._quarantine(_InFlight(pending, None, b=b, rev=want_rev_nat))
                pending._event.set()
                return pending
        if bt is not _NOOP_BATCH:
            tr.detach(bt)
        if self._admission is not None or self._watchdog is not None:
            inf.t0 = time.monotonic()
        if inf.finish is None:
            # ran synchronously (device CT)
            if bt is not _NOOP_BATCH:
                bt.end(self.monitor)
            return inf.pending
        inf.bt = bt
        with self._queue_lock:
            self._inflight.append(inf)
            if tuner is not None:
                inf.enq_ns = time.perf_counter_ns() - t0
                inf.occ = len(self._inflight)
            _metrics.pipeline_inflight_depth.set(float(len(self._inflight)))
            over = len(self._inflight) > self.pipeline_depth
        while over:
            self._complete_oldest()
            with self._queue_lock:
                over = len(self._inflight) > self.pipeline_depth
        return inf.pending

    # -- admission control + prefilter shed ----------------------------
    def set_fail_open(self, on: bool) -> None:
        """Toggle the FailOpen runtime option: what a batch that cannot
        be verdicted returns. Off (default) is fail-closed —
        DROP_DEGRADED verdicts; on forwards unverdicted traffic."""
        self._fail_open = bool(on)

    def set_admission(self, on: bool) -> None:
        """Toggle the AdmissionControl runtime option. Off (default)
        keeps the submit path at ONE attribute read per batch; on
        installs the AIMD gate bounded by pipeline_max_depth and keyed
        on the boot verdict deadline."""
        if on:
            if self._admission is None:
                self._admission = AdmissionController(
                    max_depth=max(self.pipeline_depth, self.pipeline_max_depth),
                    deadline_ms=self.deadline_ms,
                )
                # a journal armed before the controller existed still
                # sees its shed episodes
                self._admission.on_journal = self.on_journal
        else:
            self._admission = None

    def set_prefilter_shed(self, on: bool) -> None:
        """Toggle the Prefilter runtime option: whether rebuild()
        compiles and publishes the coarse [identity, class] shed table.
        The next rebuild makes the change visible to the gate."""
        self._shed_requested = bool(on)

    def set_stall_ms(self, stall_ms: float) -> None:
        """(Re)arm the stuck-completion watchdog with a budget of
        ``stall_ms``; 0 stops it."""
        wd = self._watchdog
        if wd is not None:
            wd.stop()
            self._watchdog = None
        if stall_ms and stall_ms > 0:
            self._watchdog = Watchdog(self, float(stall_ms))
            self._watchdog.start()

    def admission_state(self) -> Dict:
        """Overload snapshot: gate limit and shed accounting, queue
        depth and the watchdog's state (None while it is off)."""
        adm = self._admission
        wd = self._watchdog
        out: Dict = {
            "enabled": adm is not None,
            "prefilter": self._shed_requested,
            "queue_depth": len(self._inflight),
            "deadline_ms": self.deadline_ms,
        }
        if adm is not None:
            out.update(adm.snapshot())
        else:
            out["shed_ratio"] = 0.0
        out["watchdog"] = wd.snapshot() if wd is not None else None
        return out

    # -- the depth tuner (DispatchAutoTune) -----------------------------
    def set_autotune(self, on: bool, *, max_depth: Optional[int] = None,
                     epoch: Optional[int] = None) -> None:
        """Toggle the dispatch depth tuner. On installs a fresh
        DepthTuner stepping ``pipeline_depth`` in [1,
        pipeline_max_depth] from each batch's enqueue and completion
        times; off restores the configured static depth and drops the
        tuner. ``epoch`` shrinks the decision interval (tests, short
        runs)."""
        if max_depth is not None:
            self.pipeline_max_depth = max(1, int(max_depth))
        if not on:
            if self._tuner is not None:
                self._tuner = None
                self._apply_depth(self._static_depth)
            return
        kw = {} if epoch is None else {"epoch": int(epoch)}
        self._tuner = DepthTuner(1, self.pipeline_max_depth, **kw)
        _metrics.pipeline_depth_current.set(float(self.pipeline_depth))

    def _apply_depth(self, depth: int) -> None:
        """Move the effective depth (a tuner decision, or the static
        depth restored). The admission path reads ``pipeline_depth``
        unlocked, so a step takes effect on the next submit; a shallower
        queue drains through the over-depth completion loop."""
        depth = max(1, min(int(depth), max(self.pipeline_max_depth, self._static_depth)))
        cur = self.pipeline_depth
        if depth == cur:
            return
        self.pipeline_depth = depth
        _metrics.pipeline_depth_current.set(float(depth))
        _metrics.autotune_adjustments_total.inc({"direction": "up" if depth > cur else "down"})

    def autotune_state(self) -> Optional[Dict]:
        """The tuner's snapshot with the current and static depth; None
        while autotune is off."""
        t = self._tuner
        if t is None:
            return None
        snap = t.snapshot()
        snap["depth"] = self.pipeline_depth
        snap["static_depth"] = self._static_depth
        return snap

    # -- the device profiler (DeviceProfiling) --------------------------
    def set_profiling(self, on: bool, *, sample_every: Optional[int] = None) -> None:
        """Toggle the device profiler. Off (the default) keeps each
        dispatch at one ``self.profiler is None`` read; on installs a
        DeviceProfiler whose every ``sample_every``-th dispatch records
        its h2d / compute / d2h split. Turning it on again with another
        rate retunes the live profiler and keeps its samples."""
        if sample_every is not None:
            self.profile_sample_every = max(1, int(sample_every))
        if not on:
            self.profiler = None
            return
        if self.profiler is None:
            from ..observe.profiler import DeviceProfiler

            self.profiler = DeviceProfiler(sample_every=self.profile_sample_every)
        elif self.profiler.sample_every != self.profile_sample_every:
            self.profiler.sample_every = self.profile_sample_every

    def profile_state(self) -> Dict:
        """The profiler's snapshot (samples, per-site sums, the launch
        cost ledger), or the off state with the configured rate."""
        prof = self.profiler
        if prof is None:
            return {"enabled": False, "sample_every": self.profile_sample_every}
        return prof.snapshot()

    def _shed_walk(self, peer, dports, protos, *, family: int) -> Optional[np.ndarray]:
        """[B] bool deny-for-sure mask from the published shed table
        (one ``shed_walk`` launch), or None when no table is live
        (Prefilter off, or before the first rebuild). ``peer`` is [B, 4
        | 16] address bytes, or [B] uint32 words for IPv4. Reflects the
        policy as of the LAST rebuild, the same staleness every
        in-flight batch has."""
        with self._lock:
            shed_tab = self._shed_tab
            t = self._tables.get((TRAFFIC_INGRESS, family))
            dev = self.device
            if self._placed is not None and t is not None:
                # under a plan: the tables and shed table placed on grid
                # row 0's first device
                dev, tabs, _rts = self._placed.rows[0]
                t, shed_tab = tabs[(TRAFFIC_INGRESS, family)], self._placed.shed_tab
        if shed_tab is None or t is None:
            return None

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32))).to(dev)

        dp = up(dports)
        pr = up(protos)
        peer = np.asarray(peer)
        if family == 4:
            u32 = peer.astype(np.uint32) if peer.ndim == 1 else _pack_v4_u32(peer)
            mask = shed_flows_wide(t, shed_tab, up(u32.view(np.int32)), dp, pr)
        else:
            mask = shed_flows(t, shed_tab, up(peer), dp, pr, levels=16)
        # the gate partitions the batch on the host: one pull per shed
        # decision
        return mask.cpu().numpy()

    def _resolve_at_gate(self, fl: _Batch, idx: np.ndarray, *, verdict_code: int,
                         ingress: bool) -> None:
        """Account and emit for flows resolved AT the admission gate
        (shed or deadline-degraded): the per-endpoint counters,
        verdicts_total, the drop-reason series and the DropNotify events
        (producer "admission") the device path would have made, so a
        shed flow is observable everywhere a dropped one is."""
        if idx.size == 0:
            return
        v = np.full(idx.size, verdict_code, np.int8)
        with self._lock:
            n_ep = self.counters.shape[0]
            if n_ep == max(1, len(self._endpoints)):
                cls = 0 if verdict_code == FORWARD else 2
                eps = fl.ep_idx[idx]
                if 0 <= eps.min() and eps.max() < n_ep:
                    # one bincount: np.add.at over a shed batch's ~10^6
                    # lanes costs several times as much
                    self.counters[:, cls] += np.bincount(eps, minlength=n_ep)
                else:  # numpy's own index rules: a negative wraps, past the end raises
                    np.add.at(self.counters, (eps, cls), 1)
        if verdict_code == DROP_PREFILTER:
            # reason 144 has two producers; this is the host admission
            # gate, not the device prefilter kernel
            _metrics.drop_reasons_total.inc(
                {"reason": "prefilter", "producer": "admission"}, float(idx.size))
        elif verdict_code == DROP_DEGRADED:
            _metrics.drop_reasons_total.inc({"reason": "pipeline-degraded"}, float(idx.size))
        self._account_batch(v)
        hub = self.monitor
        if hub is not None and hub.active:
            self._emit_flow_events(fl.take(idx), v, ingress=ingress, producer="admission")

    def _admission_gate(
        self,
        fl: _Batch,
        sports: Optional[np.ndarray],
        *,
        ingress: bool,
        want_rev_nat: bool,
        tunnel_identities,
    ) -> Optional[PendingBatch]:
        """The over-budget path of the admission gate. Returns None
        when the batch is admitted UNCHANGED (the caller goes down the
        ungated submit path), else a fully or partially resolved
        PendingBatch:

        1. deny-for-sure flows (shed-table match) resolve NOW with
           DROP_PREFILTER — no queue, one shed_walk launch;
        2. the rest waits, bounded: this thread completes its own
           in-flight batches until the gate opens or the deadline budget
           is spent (an empty queue always admits);
        3. a spent deadline resolves the rest FORWARD under FailOpen,
           else DROP_DEGRADED. Never an unbounded queue, never a silent
           drop."""
        adm = self._admission
        t_gate = time.monotonic()
        forced = False
        if _faults.hub.active:
            try:
                _faults.hub.check(_faults.SITE_QUEUE_FULL)
            except _faults.FaultError:
                # an overload signal, not a device fault: halve the
                # limit and force THIS batch through the shed path
                adm.note_queue_full()
                forced = True
        depth = len(self._inflight)
        _metrics.admission_queue_depth.set(float(depth))
        b = fl.ep_idx.shape[0]
        if not forced and not adm.over_budget(depth):
            adm.note_admitted(b)
            return None
        # 1) prefilter shed — ingress only (the table is compiled from
        # the ingress policymaps) and never for overlay flows, whose
        # tunnel identity overrides the LPM row
        shed_mask = None
        if ingress and tunnel_identities is None and b:
            try:
                shed_mask = self._shed_walk(
                    fl.peer_u32 if fl.family == 4 else fl.peer_bytes, fl.dports, fl.protos,
                    family=fl.family)
            except _faults.FaultError as e:
                # an injected fault: the shed walk is an optimization
                # and must not fail the submission; the breaker counts it,
                # as the reference's does. Any other exception (a kernel
                # that failed to build or launch) propagates.
                self._note_fault(e, e.kind)
                shed_mask = None
        if shed_mask is not None and shed_mask.any():
            shed_idx = np.nonzero(shed_mask)[0]
            keep_idx = np.nonzero(~shed_mask)[0]
            self._resolve_at_gate(fl, shed_idx, verdict_code=DROP_PREFILTER, ingress=ingress)
            adm.note_shed(REASON_SHED_PREFILTER, int(shed_idx.size))
        else:
            shed_idx = np.empty(0, np.int64)
            keep_idx = np.arange(b)
        # 2) bounded deferral for the rest
        admitted = keep_idx.size > 0
        if admitted:
            budget_s = adm.deadline_s or None
            while adm.over_budget(len(self._inflight)):
                if budget_s is not None and time.monotonic() - t_gate >= budget_s:
                    admitted = False
                    break
                if not self._complete_oldest():
                    break
        _metrics.queue_wait_seconds.observe(time.monotonic() - t_gate)
        if keep_idx.size == 0 or not admitted:
            v = np.full(b, DROP_PREFILTER, np.int8)
            if keep_idx.size:
                # 3) deadline spent: failsafe resolution for the rest
                code = FORWARD if self._fail_open else DROP_DEGRADED
                self._resolve_at_gate(fl, keep_idx, verdict_code=code, ingress=ingress)
                adm.note_shed(REASON_SHED_DEADLINE, int(keep_idx.size))
                v[keep_idx] = code
            # resolved handle, nothing ever queued
            pending = PendingBatch(self)
            red = np.zeros(b, bool)
            pending._value = (v, red, np.zeros(b, np.uint16)) if want_rev_nat else (v, red)
            pending._event.set()
            return pending
        adm.note_admitted(int(keep_idx.size))
        if keep_idx.size == b:
            # nothing shed and the gate opened: the unchanged path
            return None
        inner = self._submit(
            fl.take(keep_idx), None if sports is None else np.asarray(sports)[keep_idx],
            ingress=ingress, want_rev_nat=want_rev_nat, tunnel_identities=None, gate=False,
        )
        shed_v = np.zeros(b, np.int8)
        shed_v[shed_idx] = DROP_PREFILTER
        return _GatedPending(self, inner, keep_idx, shed_v, b, want_rev_nat)

    # ------------------------------------------------------------------
    def submit(
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
    ) -> PendingBatch:
        """Enqueue an IPv4 batch WITHOUT pulling its results: returns a
        PendingBatch whose .result() waits for the card. Submitting the
        next batch before resolving the previous one overlaps host prep
        with device execution (bounded by ``pipeline_depth``: admission
        past the bound completes the oldest in-flight batch first)."""
        src = np.asarray(src_ips)
        fl = _Batch(
            4, np.asarray(ep_idx, np.int32), np.asarray(dports, np.int32),
            np.asarray(protos, np.int32), peer_u32=src.astype(np.uint32),
            words=(np.zeros(src.shape[0], np.uint64), src.astype(np.uint64)),
        )
        return self._submit(fl, sports, ingress=ingress, want_rev_nat=return_rev_nat,
                            tunnel_identities=tunnel_identities)

    def submit_v6(
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
    ) -> PendingBatch:
        """IPv6 counterpart of :meth:`submit`."""
        peer = np.asarray(peer_bytes, np.int32)
        if peer.ndim != 2 or peer.shape[1] != 16:
            raise ValueError(f"submit_v6: peer_bytes must be [B, 16], got {tuple(peer.shape)}")
        fl = _Batch(6, np.asarray(ep_idx, np.int32), np.asarray(dports, np.int32),
                    np.asarray(protos, np.int32), peer_bytes=peer)
        return self._submit(fl, sports, ingress=ingress, want_rev_nat=return_rev_nat,
                            tunnel_identities=tunnel_identities)

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
        return self.submit(
            src_ips, ep_idx, dports, protos, ingress=ingress, sports=sports,
            return_rev_nat=return_rev_nat, tunnel_identities=tunnel_identities,
        ).result()

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
        return self.submit_v6(
            peer_bytes, ep_idx, dports, protos, ingress=ingress, sports=sports,
            return_rev_nat=return_rev_nat, tunnel_identities=tunnel_identities,
        ).result()

    def rev_nat_frontend(self, revnat_id: int):
        """revNAT id (from a return_rev_nat=True process call) → the
        original frontend L3n4Addr, or None."""
        if self.lb is None or not revnat_id:
            return None
        return self.lb.rev_nat(int(revnat_id))
