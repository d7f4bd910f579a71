"""Device-resident conntrack: the CT table lives in device memory and
is probed, refreshed and inserted into inside the verdict dispatch.

The port of the JAX package's ``datapath/device_ct.py``. A slot holds
six key words (the full 192-bit tuple keys: peer address hi/lo 64 bits
and the packed kc word, each as two 32-bit words) and an expiry word;
a slot is live iff ``exp > now``. Key words travel as int32 bit views
of the reference's uint32 words, as every packed word of the port
does. The reference keeps seven [C] arrays; the port keeps ``exp`` and
``kc_lo`` (the words a probe window reads for every slot it passes) as
[C] arrays and the other five key words, with the insert claims'
``owner`` word, in one 32-byte record a slot (:class:`DeviceCTState`).

Semantics mirrored from FlowConntrack / conntrack.h:
- forward-tuple hit → ESTABLISHED (refresh lifetime)
- flipped-tuple hit (sport/dport swapped, direction inverted) → REPLY
- policy-allowed, non-redirect misses insert a forward entry at the
  first free (expired) slot of their 8-slot probe window
- redirect (proxy) flows never enter CT
- expiry: TCP 21600s / other 60s, wall clock passed per call
- flush = a fresh table (verdict-basis moves, same as the host CT)

Two differences from the reference, both deliberate:

- :func:`ct_step` updates the state **in place** (the reference jit
  donates the buffers and returns a new state).
- Lanes that do not refresh or insert write nothing. The reference
  aims them at index -1 with ``mode="drop"``, which JAX writes to slot
  C-1 instead of dropping, so slot C-1 holds junk that never expires
  and can make a denied flow established. Insert conflicts (several
  new flows whose first free slot is the same) go to the highest lane
  index, which is what JAX's scatter keeps; the port computes that
  winner explicitly instead of relying on the order of a scatter.

On CUDA tensors :func:`ct_step` and :func:`ct_step_verdict` launch the
two entries of the ``ct_step`` kernel (csrc/ct_step.cu): ``ct_probe_claim``
probes, refreshes and claims each insert slot with an ``atomicMax`` of
the lane index into the slot record's ``owner`` word; ``ct_commit`` lets
each slot's winner write its key. On CPU tensors they run the dense
[B, P] gather versions :func:`ct_step_plain` / :func:`ct_step_verdict_plain`.

The host halves (:func:`split_u64`, :func:`pull_live_entries`,
:func:`seed_state_from_host` and the numpy hash twins) are the
reference's, reading and writing the port's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import _kernels

CT_PROBES = 8

LIFE_TCP_S = 21600
LIFE_OTHER_S = 60

_M32 = 0xFFFFFFFF
_KEY_FIELDS = ("ka_hi", "ka_lo", "kb_hi", "kb_lo", "kc_hi", "kc_lo")
# the words of a slot's record: five key words, the owner, two spare
REC_WORDS = 8
_REC_COLS = {"ka_hi": 0, "ka_lo": 1, "kb_hi": 2, "kb_lo": 3, "kc_hi": 4, "owner": 5}


def _rec_col(k: int):
    return property(lambda self: self.rec[:, k], doc=f"rec[:, {k}], a view that writes through")


@dataclasses.dataclass(frozen=True)
class DeviceCTState:
    """CT table on one device, updated in place, C slots: ``exp`` [C]
    int32 (expiry, seconds, monotonic clock), ``kc_lo`` [C] int32 and
    ``rec`` [C, 8] int32, one 32-byte record a slot holding ka_hi,
    ka_lo, kb_hi, kb_lo, kc_hi, owner and two spare words. Key words:
    peer address (hi/lo 64 bits as 2×u32 each) and the packed kc word
    (ep/sport/dport/proto/dir, conntrack.py pack_keys layout) split into
    2×u32, all as int32 bit views. ``owner`` is the port's own scratch
    for the insert claims (-1 between steps); it is not part of the
    table. The reference's seven word names and ``owner`` are properties:
    column views of ``rec`` (or the arrays), which write through."""

    exp: torch.Tensor  # [C] int32 expiry
    kc_lo: torch.Tensor  # [C] int32 kc & 0xffffffff
    rec: torch.Tensor  # [C, REC_WORDS] int32

    ka_hi = _rec_col(_REC_COLS["ka_hi"])  # peer_hi >> 32
    ka_lo = _rec_col(_REC_COLS["ka_lo"])  # peer_hi & 0xffffffff
    kb_hi = _rec_col(_REC_COLS["kb_hi"])  # peer_lo >> 32
    kb_lo = _rec_col(_REC_COLS["kb_lo"])
    kc_hi = _rec_col(_REC_COLS["kc_hi"])  # kc >> 32
    owner = _rec_col(_REC_COLS["owner"])  # claiming lane, -1 = none

    @property
    def capacity(self) -> int:
        return self.exp.shape[0]

    def keys(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in _KEY_FIELDS)


def make_state(capacity_bits: int = 20, device=None) -> DeviceCTState:
    """A fresh table of 2**capacity_bits slots on ``device`` (None = the
    card): zero keys, zero expiry (every slot free), no claims."""
    dev = _kernels.resolve_device(device)
    c = 1 << capacity_bits
    rec = torch.zeros((c, REC_WORDS), dtype=torch.int32, device=dev)
    rec[:, _REC_COLS["owner"]] = -1
    return DeviceCTState(torch.zeros(c, dtype=torch.int32, device=dev),
                         torch.zeros(c, dtype=torch.int32, device=dev), rec)


# -- 32-bit word arithmetic ---------------------------------------------------
# PyTorch on the CPU has no shifts on uint32, so the words are widened to
# int64, masked to 32 bits after every shift and multiply, and narrowed
# back to int32 bit views.


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor → int64 holding its low 32 bits (unsigned)."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) → int32 bit view."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over 32-bit lanes → int32 bit view."""
    return _i32(_fmix(_u32(x)))


def _hash_u32(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo) -> torch.Tensor:
    h = _fmix(_u32(ka_hi))
    for w in (ka_lo, kb_hi, kb_lo, kc_hi, kc_lo):
        h = _fmix(h ^ _u32(w))
    return h


def _hash_tuple(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo) -> torch.Tensor:
    """The six-word fmix32 chain → int32 bit view."""
    return _i32(_hash_u32(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo))


def pack_kc_words(
    ep_idx: torch.Tensor, sport: torch.Tensor, dport: torch.Tensor,
    proto: torch.Tensor, direction,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pack_keys kc layout (ep[41:] sport[25:41] dport[9:25]
    proto[1:9] dir[0]) built in 32-bit halves (int32 bit views):
        kc_lo = sport[25:32←7 bits] | dport<<9 | proto<<1 | dir
        kc_hi = ep<<9 | sport>>7
    ``direction`` is a tensor or one int for the whole batch."""
    ep, sp, dp, pr = (_u32(x) for x in (ep_idx, sport, dport, proto))
    dr = _u32(torch.as_tensor(direction, device=ep.device))
    kc_lo = (((sp & 0x7F) << 25) | (dp << 9) | (pr << 1) | dr) & _M32
    kc_hi = ((ep << 9) | (sp >> 7)) & _M32
    return _i32(kc_hi), _i32(kc_lo)


def _flip_kc_words(kc_hi, kc_lo):
    """Reply tuple: swap sport/dport, invert the direction bit."""
    hi, lo = _u32(kc_hi), _u32(kc_lo)
    sp = ((hi & 0x1FF) << 7) | (lo >> 25)
    dp = (lo >> 9) & 0xFFFF
    pr = (lo >> 1) & 0xFF
    dr = lo & 1
    ep = hi >> 9
    f_lo = (((dp & 0x7F) << 25) | (sp << 9) | (pr << 1) | (dr ^ 1)) & _M32
    f_hi = ((ep << 9) | (dp >> 7)) & _M32
    return _i32(f_hi), _i32(f_lo)


def _window(h: torch.Tensor, c: int) -> torch.Tensor:
    """[B] uint32 hashes (int64) → [B, P] int64 probe slots."""
    offs = torch.arange(CT_PROBES, dtype=torch.int64, device=h.device)
    return ((h[:, None] + offs[None, :]) & _M32) & (c - 1)


def _probe(state: DeviceCTState, ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo, now: int):
    """→ (hit [B] bool, slot [B] int64 of the first live slot holding
    the key, or -1). Dense P-way probe."""
    words = (ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo)
    slots = _window(_hash_u32(*words), state.capacity)
    match = state.exp[slots] > now
    for table, w in zip(state.keys(), words):
        match &= table[slots] == w.to(torch.int32)[:, None]
    hit = match.any(dim=1)
    first = match.to(torch.int8).argmax(dim=1)
    slot = torch.where(hit, slots.gather(1, first[:, None])[:, 0], -1)
    return hit, slot


def _life(proto: torch.Tensor) -> torch.Tensor:
    return torch.where(proto == 6, LIFE_TCP_S, LIFE_OTHER_S).to(torch.int32)


def ct_step_plain(
    state: DeviceCTState,
    peer_hi_w: Tuple[torch.Tensor, torch.Tensor],
    peer_lo_w: Tuple[torch.Tensor, torch.Tensor],
    kc_w: Tuple[torch.Tensor, torch.Tensor],
    proto: torch.Tensor,
    now,
    allow_new: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`ct_step` (the dense [B, P]
    gathers): the same in-place update and result."""
    now = int(now)
    ka_hi, ka_lo = peer_hi_w
    kb_hi, kb_lo = peer_lo_w
    kc_hi, kc_lo = kc_w
    words = (ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo)
    fwd_hit, fwd_slot = _probe(state, *words, now)
    f_hi, f_lo = _flip_kc_words(kc_hi, kc_lo)
    rep_hit, rep_slot = _probe(state, ka_hi, ka_lo, kb_hi, kb_lo, f_hi, f_lo, now)
    established = fwd_hit | rep_hit

    # The insert target is the first free (expired) slot of the forward
    # window. The reference tests freedom after the refresh; a refresh
    # only rewrites a live slot to another live value, so the test reads
    # the same answer before it.
    slots = _window(_hash_u32(*words), state.capacity)
    free = state.exp[slots] <= now
    has_free = free.any(dim=1)
    ins_slot = slots.gather(1, free.to(torch.int8).argmax(dim=1)[:, None])[:, 0]

    exp_new = now + _life(proto)
    state.exp[fwd_slot[fwd_hit]] = exp_new[fwd_hit]
    state.exp[rep_slot[rep_hit]] = exp_new[rep_hit]

    # insert: each claimed slot goes to its highest claiming lane
    do_ins = allow_new.to(torch.bool) & ~established & has_free
    lanes = torch.arange(proto.shape[0], dtype=torch.int32, device=proto.device)
    claimed = ins_slot[do_ins]
    state.owner.scatter_reduce_(0, claimed, lanes[do_ins], "amax")
    win = do_ins & (state.owner[ins_slot] == lanes)
    s = ins_slot[win]
    for table, w in zip(state.keys(), words):
        table[s] = w.to(torch.int32)[win]
    state.exp[s] = exp_new[win]
    state.owner[claimed] = -1
    return established


def _check_state(name: str, state: DeviceCTState, dev: torch.device) -> int:
    c = state.capacity
    if c <= 0 or c & (c - 1) or c > 1 << 31:
        raise ValueError(f"{name}: capacity {c} is not a power of two in [1, 2**31]")
    for f, shape in (("exp", (c,)), ("kc_lo", (c,)), ("rec", (c, REC_WORDS))):
        t = getattr(state, f)
        if t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: state.{f} must be a contiguous {list(shape)} int32 tensor")
    if state.rec.data_ptr() % 32:
        raise ValueError(f"{name}: state.rec must start on a 32-byte boundary (a record a sector)")
    _kernels.check_cuda(name, dev, state.exp, state.kc_lo, state.rec)
    return c


def _check_lanes(name: str, dev: torch.device, b: int, dtype, *tensors) -> None:
    for t in tensors:
        if t.dtype != dtype or t.shape != (b,):
            raise ValueError(f"{name}: expected [{b}] {dtype}, got {tuple(t.shape)} {t.dtype}")
    _kernels.check_cuda(name, dev, *tensors)


def _launch(state, words, proto, now: int, verdict, redirect, valid, ep_idx, ep_count: int):
    """The two K10 entries on the card → (established [B] bool,
    counters [EP, 3] int32). ``verdict`` and ``redirect`` are rewritten
    in place with the final verdicts. Lanes whose ep_idx lies outside
    [0, ep_count) are not counted, as in the plain version; that ep_idx
    fits the 23 bits of the kc words is for whoever packed them to
    check (``_process_device_ct`` does, on the host)."""
    dev = proto.device
    c = _check_state("ct_step", state, dev)
    b = proto.shape[0]
    if b >= 1 << 31:
        raise ValueError("ct_step: batch too large for int32 lane ids")
    _check_lanes("ct_step", dev, b, torch.int32, *words, proto, ep_idx)
    _check_lanes("ct_step", dev, b, torch.int8, verdict)
    _check_lanes("ct_step", dev, b, torch.bool, redirect, valid)
    if not 0 < ep_count <= 1 << 23:
        raise ValueError(f"ct_step: ep_count {ep_count} outside [1, 2**23]")
    counters = torch.zeros((ep_count, 3), dtype=torch.int32, device=dev)
    established = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return established, counters
    target = torch.empty(b, dtype=torch.int32, device=dev)
    tab = [state.exp.data_ptr(), state.kc_lo.data_ptr(), state.rec.data_ptr()]
    q = [w.data_ptr() for w in words]
    _kernels.KERNELS["ct_probe_claim"].launch(
        dev, *tab, c, *q, proto.data_ptr(), verdict.data_ptr(), redirect.data_ptr(),
        valid.data_ptr(), now, established.data_ptr(), target.data_ptr(), b,
    )
    _kernels.KERNELS["ct_commit"].launch(
        dev, *tab, *q, proto.data_ptr(), now, target.data_ptr(), established.data_ptr(),
        verdict.data_ptr(), redirect.data_ptr(), ep_idx.data_ptr(), valid.data_ptr(),
        counters.data_ptr(), ep_count, b,
    )
    return established, counters


def ct_step(
    state: DeviceCTState,
    peer_hi_w: Tuple[torch.Tensor, torch.Tensor],  # (hi32, lo32) of peer_hi
    peer_lo_w: Tuple[torch.Tensor, torch.Tensor],  # (hi32, lo32) of peer_lo
    kc_w: Tuple[torch.Tensor, torch.Tensor],  # (kc_hi, kc_lo)
    proto: torch.Tensor,  # [B] int32, the protocol the kc words carry
    now,  # int seconds (monotonic)
    allow_new: torch.Tensor,  # [B] bool — policy-allowed non-redirect misses
) -> torch.Tensor:
    """Probe (fwd + reply), refresh hits, insert allowed misses →
    established [B] bool. Updates ``state`` in place, where the
    reference's jit donates it and returns a new state. Words are
    [B] int32 bit views. On CUDA tensors it launches K10, on CPU
    tensors it runs :func:`ct_step_plain`; K10 then runs as
    :func:`ct_step_verdict` does, with the verdict FORWARD where
    ``allow_new`` and a policy drop elsewhere, no redirect, every lane
    valid and one endpoint."""
    words = (*peer_hi_w, *peer_lo_w, *kc_w)
    dev = _kernels.dispatch_device(*words, proto, allow_new, state.exp)
    if dev.type == "cpu":
        return ct_step_plain(state, peer_hi_w, peer_lo_w, kc_w, proto, now, allow_new)
    b = proto.shape[0]
    _check_lanes("ct_step", dev, b, torch.bool, allow_new)
    verdict = torch.where(allow_new, 1, 2).to(torch.int8)
    redirect = torch.zeros(b, dtype=torch.bool, device=dev)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    ep_idx = torch.zeros(b, dtype=torch.int32, device=dev)
    return _launch(state, words, proto, int(now), verdict, redirect, valid, ep_idx, 1)[0]


def ct_step_verdict_plain(state, peer_hi_w, peer_lo_w, kc_w, proto, now, verdict, redirect,
                          valid, ep_idx, ep_count: int):
    """Plain PyTorch version of :func:`ct_step_verdict`."""
    allow_new = (verdict == 1) & ~redirect & valid
    est = ct_step_plain(state, peer_hi_w, peer_lo_w, kc_w, proto, now, allow_new)
    verdict = torch.where(est, 1, verdict).to(torch.int8)
    redirect = redirect & ~est
    counted = valid & (ep_idx >= 0) & (ep_idx < ep_count)
    cell = ep_idx.long() * 3 + (verdict.long() - 1)
    counters = torch.bincount(cell[counted], minlength=ep_count * 3)
    return verdict, redirect, counters.to(torch.int32).reshape(ep_count, 3), est


def ct_step_verdict(
    state: DeviceCTState,
    peer_hi_w, peer_lo_w, kc_w,
    proto: torch.Tensor,
    now,
    verdict: torch.Tensor,  # [B] int8 policy verdict, prefilter override applied
    redirect: torch.Tensor,  # [B] bool
    valid: torch.Tensor,  # [B] bool — False lanes never insert nor count
    ep_idx: torch.Tensor,  # [B] int32
    ep_count: int,
):
    """The CT tail of ``process_flows_ct``: :func:`ct_step` with
    ``allow_new = (verdict == FORWARD) & ~redirect & valid``, then the
    final verdicts (an established flow takes FORWARD and loses its
    redirect) and the per-endpoint counters [EP, 3] (forwarded, dropped
    by policy, dropped by the prefilter) of the valid lanes → (verdict,
    redirect, counters, established). On CUDA tensors both K10 entries
    do all of it in two launches."""
    words = (*peer_hi_w, *peer_lo_w, *kc_w)
    dev = _kernels.dispatch_device(*words, proto, verdict, redirect, valid, ep_idx, state.exp)
    if dev.type == "cpu":
        return ct_step_verdict_plain(state, peer_hi_w, peer_lo_w, kc_w, proto, now, verdict,
                                     redirect, valid, ep_idx, ep_count)
    verdict, redirect = verdict.clone(), redirect.clone()
    est, counters = _launch(state, words, proto, int(now), verdict, redirect, valid, ep_idx,
                            ep_count)
    return verdict, redirect, counters, est


def split_u64(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 host words → (hi32, lo32) uint32 arrays."""
    x = np.asarray(x, np.uint64)
    return (
        (x >> np.uint64(32)).astype(np.uint32),
        (x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


# ---------------------------------------------------------------------------
# host-side pull / seed (policyd-survive)
#
# The word split is lossless against the host layout: pack_kc_words
# builds exactly the low/high 32-bit halves of pack_keys' uint64 kc
# (sp>>7 lands in kc_hi bits [0:9] == kc bits [32:41]), so
# (hi<<32)|lo reconstructs the FlowConntrack key words verbatim.
# ---------------------------------------------------------------------------


def pull_live_entries(state: DeviceCTState, now_s: int, limit: int = 1 << 16) -> dict:
    """Pull the live device entries to host → {ka, kb, kc (uint64),
    ttl (float64 remaining seconds)} in slot order, bounded at
    ``limit``. Only the live slots' records leave the device."""
    exp = state.exp.cpu().numpy()
    live = np.nonzero(exp > now_s)[0][:limit]
    idx = torch.from_numpy(live).to(state.exp.device)
    rec = state.rec[idx].cpu().numpy().view(np.uint32).astype(np.uint64)
    kc_lo = state.kc_lo[idx].cpu().numpy().view(np.uint32).astype(np.uint64)

    def join(hi, lo):
        return (hi << np.uint64(32)) | lo

    col = _REC_COLS
    return {
        "ka": join(rec[:, col["ka_hi"]], rec[:, col["ka_lo"]]),
        "kb": join(rec[:, col["kb_hi"]], rec[:, col["kb_lo"]]),
        "kc": join(rec[:, col["kc_hi"]], kc_lo),
        "ttl": (exp[live] - now_s).astype(np.float64),
    }


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """Numpy twin of _mix32 — bit-identical murmur3 fmix32, so host
    placement lands entries where the device probe will find them."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32, copy=True)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def _hash_tuple_np(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = _mix32_np(ka_hi)
        h = _mix32_np(h ^ ka_lo)
        h = _mix32_np(h ^ kb_hi)
        h = _mix32_np(h ^ kb_lo)
        h = _mix32_np(h ^ kc_hi)
        h = _mix32_np(h ^ kc_lo)
    return h


def seed_state_from_host(
    ka: np.ndarray,  # [N] uint64 host key words (conntrack.py layout)
    kb: np.ndarray,
    kc: np.ndarray,
    ttl: np.ndarray,  # [N] remaining seconds
    capacity_bits: int,
    now_s: int,
    limit: int = 1 << 16,
    device=None,
) -> DeviceCTState:
    """Build a DeviceCTState pre-populated from host CT entries, on
    ``device`` (None = the card). Placement runs host-side with the
    numpy murmur twin (bit-identical hashing), so every seeded entry
    sits on its device probe chain; entries past ``limit`` or losing a
    full neighborhood are dropped and re-verdict on their next batch."""
    c = 1 << capacity_bits
    mask = np.uint32(c - 1)
    n = min(len(ka), limit)
    ka = np.asarray(ka, np.uint64)[:n]
    kb = np.asarray(kb, np.uint64)[:n]
    kc = np.asarray(kc, np.uint64)[:n]
    exp_in = now_s + np.maximum(
        np.asarray(ttl, np.float64)[:n], 1.0
    ).astype(np.int64)
    ka_hi, ka_lo = split_u64(ka)
    kb_hi, kb_lo = split_u64(kb)
    kc_hi, kc_lo = split_u64(kc)

    t = {f: np.zeros(c, np.uint32) for f in _KEY_FIELDS}
    exp = np.zeros(c, np.int32)
    h = _hash_tuple_np(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo)
    placed = np.zeros(n, bool)
    for p in range(CT_PROBES):
        with np.errstate(over="ignore"):
            cand = ((h + np.uint32(p)) & mask).astype(np.int64)
        want = (~placed) & (exp[cand] <= now_s)
        if not want.any():
            continue
        idx = np.nonzero(want)[0]
        _, first = np.unique(cand[idx], return_index=True)
        win = idx[first]
        s = cand[win]
        t["ka_hi"][s], t["ka_lo"][s] = ka_hi[win], ka_lo[win]
        t["kb_hi"][s], t["kb_lo"][s] = kb_hi[win], kb_lo[win]
        t["kc_hi"][s], t["kc_lo"][s] = kc_hi[win], kc_lo[win]
        exp[s] = exp_in[win].astype(np.int32)
        placed[win] = True
        if placed.all():
            break
    from ..convert import device_ct_state_from_numpy

    return device_ct_state_from_numpy([*(t[f] for f in _KEY_FIELDS), exp], device=device)
