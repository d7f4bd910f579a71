"""Batched multi-pattern DFA execution on the card.

The L7 HTTP matcher: strings (method/path/host) walk a combined DFA
(l7/regex_compile.py) whose accept sets are per-state pattern bitmasks.
Accept masks come back as two 32-bit words (pattern bit i = pattern i
matches), carried as int32 bit views (PyTorch on the CPU has no right
shift on uint32) and recombined to uint64 on the host.

Field DFAs for one policy stack into a single :class:`FusedDFA`
(per-field start states over one padded transition tensor) so
method/path/host classify in one launch; walks are length-bucketed
(``L7_LEN_LADDER``); small automata carry a stride-2 pair-transition
table that halves the chained-gather depth; and device residence is
interned by pattern-set key (and device) so N endpoints with the same
policy share one table.

The numpy packers, ``len_rung``, ``FusedDFA``, ``_pair_table`` and
``fuse_dfas`` are copies of the JAX package's. The walks launch a
kernel on a CUDA tensor and run its plain version on a CPU tensor:

- :func:`dfa_match_batch` (one scalar start, int32 bytes) and
  :func:`dfa_match_batch_fused` (per-row starts, uint8 bytes): the two
  entries of the ``dfa_walk`` kernel (csrc/dfa_walk.cu, plain
  :func:`dfa_walk_plain`), counted as ``dfa_walk`` and
  ``dfa_walk_fused``;
- :func:`dfa_match_batch_pair`: the ``dfa_pair_walk`` kernel
  (csrc/dfa_pair_walk.cu, plain :func:`dfa_pair_walk_plain`).

Where the JAX walks gather out of range (a state outside [0, Q), or an
int32 byte outside [0, 255] given to ``dfa_match_batch``), ``jnp.take``
fills or lands in another state's row; the kernels and their plain
versions read nothing outside their tables and return mask 0 for that
row. Every table ``compile_patterns`` / ``fuse_dfas`` build stays
inside [0, Q), so the two agree there. The JAX pair walk also reads
one byte past ``max_len`` when ``max_len`` is odd and a row is longer
than it (ROADMAP queue C); here a position at or past ``max_len`` is
the pad symbol, which keeps the pair walk equal to the single-byte
walk.
"""
# policyd: hot

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import TYPE_CHECKING, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels, metrics

if TYPE_CHECKING:  # annotation-only: a runtime import would cycle
    # (l7/__init__ imports http_policy, which imports this module)
    from ..l7.regex_compile import MultiDFA


# Length rungs for the bucketed walk: a FIXED rung set, so the shapes a
# walk runs at do not follow live batch lengths. Strings longer than
# the top rung walk at the field cap rung.
L7_LEN_LADDER: Tuple[int, ...] = (16, 32, 64, 128)

# Pair-walk pad symbol: alphabet index 256 is the identity transition,
# so a padded tail byte leaves the state untouched in-kernel and the
# packed buffers stay 0-padded (shared with the single-byte walk).
PAIR_ALPHA = 257
PAIR_PAD = 256

# A fused automaton gets a [Q, 257*257] pair table only when it fits
# this element cap (int32 words) — 1<<23 ≈ 32 MiB, i.e. Q ≲ 126.
# Real policies compile to a few dozen states; pathological ones just
# stay on the single-byte walk.
PAIR_TABLE_CAP_ELEMS = 1 << 23


def _pack_u8(strings: Sequence[bytes], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shared packer core → ([B, max_len] uint8, [B] int32 lengths).

    Vectorized: numpy's fixed-width bytes dtype copies every string
    into a zero-padded row in one C-level pass (embedded NULs are
    preserved — only the Python ``len`` is authoritative, so a string
    ending in \\x00 still walks its full length). Overlong strings are
    truncated by the dtype; their rows are zeroed and marked length -1
    (never match — fail closed)."""
    b = len(strings)
    if not b:
        return np.zeros((0, max_len), np.uint8), np.zeros(0, np.int32)
    raw_lens = np.fromiter(map(len, strings), np.int64, b)
    out = (
        np.array(strings, dtype=f"S{max_len}")
        .view(np.uint8)
        .reshape(b, max_len)
    )
    over = raw_lens > max_len
    if over.any():
        out[over] = 0
    lens = np.where(over, -1, raw_lens).astype(np.int32)
    return out, lens


def strings_to_batch(strings: Sequence[bytes], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """→ (bytes [B, max_len] int32, lengths [B] int32); overlong strings
    are marked length -1 (never match — fail closed). Packs every
    request batch on the proxy hot path — vectorized, no per-string
    Python loop."""
    out, lens = _pack_u8(strings, max_len)
    return out.astype(np.int32), lens


def strings_to_batch_u8(strings: Sequence[bytes], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 variant for the fused walks: a quarter of the host→device
    transfer of the int32 batch. The int32 ``strings_to_batch`` stays
    the contract of the unfused walk."""
    return _pack_u8(strings, max_len)


# ---------------------------------------------------------------------------
# the walks: kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _accept(alive, state, accept_lo, accept_hi):
    safe = torch.where(alive, state, 0)
    lo = torch.where(alive, accept_lo[safe], 0).to(torch.int32)
    hi = torch.where(alive, accept_hi[safe], 0).to(torch.int32)
    return lo, hi


def dfa_walk_plain(
    trans: torch.Tensor,  # [Q, 256] int32
    accept_lo: torch.Tensor,  # [Q] int32 bit view of the uint32 word
    accept_hi: torch.Tensor,  # [Q] int32
    starts: torch.Tensor,  # [B] int32 per-row start state
    str_bytes: torch.Tensor,  # [B, >= max_len] uint8 or int32
    lengths: torch.Tensor,  # [B] int32 (-1 = fail closed)
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``dfa_walk`` kernel → (mask_lo,
    mask_hi) [B] int32. Row i steps ``state = trans[state, byte]`` over
    its first ``min(length, max_len)`` bytes and returns the accept
    words of the final state; 0 for a negative length, and 0 once the
    walk meets a byte outside [0, 255] or a state outside [0, Q)."""
    q = trans.shape[0]
    flat = trans.reshape(-1)
    state = starts.to(torch.int64)
    lens = lengths.to(torch.int64)
    alive = (lens >= 0) & (state >= 0) & (state < q)
    end = lens.clamp(max=max_len)
    for lvl in range(max_len):
        byte = str_bytes[:, lvl].to(torch.int64)
        step = alive & (lvl < end)
        alive = alive & ~(step & ((byte < 0) | (byte > 255)))
        step = step & alive
        nxt = flat[torch.where(step, state * 256 + byte, 0)].to(torch.int64)
        state = torch.where(step, nxt, state)
        alive = alive & (state >= 0) & (state < q)
    return _accept(alive, state, accept_lo, accept_hi)


def dfa_pair_walk_plain(
    pair: torch.Tensor,  # [Q, 257*257] int32
    accept_lo: torch.Tensor,  # [Q] int32
    accept_hi: torch.Tensor,  # [Q] int32
    starts: torch.Tensor,  # [B] int32
    str_bytes: torch.Tensor,  # [B, >= max_len] uint8 or int32, 0-padded
    lengths: torch.Tensor,  # [B] int32 (-1 = fail closed)
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``dfa_pair_walk`` kernel →
    (mask_lo, mask_hi) [B] int32. Row i takes ``ceil(max_len / 2)``
    steps ``state = pair[state, b0 * 257 + b1]`` over byte positions
    (2k, 2k + 1), where a position at or past ``min(length, max_len)``
    is the pad symbol 256; a step whose two positions are both pads
    leaves the state as it is (the (pad, pad) identity of
    :func:`_pair_table`). No byte at or past ``max_len`` is read. Mask
    0 for a negative length, a byte outside [0, 255] or a state outside
    [0, Q)."""
    q = pair.shape[0]
    flat = pair.reshape(-1)
    b = str_bytes.shape[0]
    state = starts.to(torch.int64)
    lens = lengths.to(torch.int64)
    alive = (lens >= 0) & (state >= 0) & (state < q)
    end = lens.clamp(max=max_len)
    zeros = torch.zeros(b, dtype=torch.int64, device=str_bytes.device)
    for lvl in range(0, max_len, 2):
        raw0 = str_bytes[:, lvl].to(torch.int64)
        raw1 = str_bytes[:, lvl + 1].to(torch.int64) if lvl + 1 < max_len else zeros
        in1 = lvl + 1 < end
        step = alive & (lvl < end)
        bad = (raw0 < 0) | (raw0 > 255) | (in1 & ((raw1 < 0) | (raw1 > 255)))
        alive = alive & ~(step & bad)
        step = step & alive
        b1 = torch.where(in1, raw1, PAIR_PAD)
        idx = (state * PAIR_ALPHA + raw0) * PAIR_ALPHA + b1
        nxt = flat[torch.where(step, idx, 0)].to(torch.int64)
        state = torch.where(step, nxt, state)
        alive = alive & (state >= 0) & (state < q)
    return _accept(alive, state, accept_lo, accept_hi)


def _check_walk(name, table, width, accept_lo, accept_hi, starts, str_bytes,
                lengths, max_len, scalar_start):
    b = str_bytes.shape[0]
    if (
        table.dim() != 2 or table.shape[1] != width or table.shape[0] < 1
        or table.dtype != torch.int32
        or accept_lo.shape != (table.shape[0],) or accept_hi.shape != (table.shape[0],)
        or accept_lo.dtype != torch.int32 or accept_hi.dtype != torch.int32
        or str_bytes.dim() != 2 or str_bytes.dtype not in (torch.uint8, torch.int32)
        or not 0 <= max_len <= str_bytes.shape[1]
        or lengths.shape != (b,) or lengths.dtype != torch.int32
        or starts.dtype != torch.int32
        or (starts.numel() != 1 if scalar_start else starts.shape != (b,))
    ):
        raise ValueError(f"{name}: not a [Q, {width}] int32 table and a string batch")


def _walk(kernel, plain, table, width, accept_lo, accept_hi, starts,
          str_bytes, lengths, max_len, scalar_start):
    dev = _kernels.dispatch_device(table, accept_lo, accept_hi, starts, str_bytes, lengths)
    _check_walk(kernel, table, width, accept_lo, accept_hi, starts, str_bytes,
                lengths, max_len, scalar_start)
    b = str_bytes.shape[0]
    if dev.type == "cpu":
        rows = starts.reshape(-1).expand(b) if scalar_start else starts
        return plain(table, accept_lo, accept_hi, rows, str_bytes, lengths, max_len)
    out_lo = torch.empty(b, dtype=torch.int32, device=dev)
    out_hi = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out_lo, out_hi
    args = [x.contiguous() for x in (table, accept_lo, accept_hi, starts, str_bytes, lengths)]
    _kernels.check_cuda(kernel, dev, *args, out_lo, out_hi)
    tab, lo, hi, st, sb, ln = args
    head = [tab.data_ptr(), tab.shape[0], lo.data_ptr(), hi.data_ptr(), st.data_ptr()]
    if kernel != "dfa_pair_walk":
        head.append(0 if scalar_start else 1)  # dfa_walk's start stride
    _kernels.KERNELS[kernel].launch(
        dev, *head, sb.data_ptr(), sb.element_size(), sb.shape[1], max_len,
        ln.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(), b,
    )
    return out_lo, out_hi


def dfa_match_batch(
    trans: torch.Tensor,  # [Q, 256] int32 (state 0 = dead)
    accept_lo: torch.Tensor,  # [Q] int32 bit view
    accept_hi: torch.Tensor,  # [Q] int32 bit view
    start: torch.Tensor,  # [] int32
    str_bytes: torch.Tensor,  # [B, max_len] int32
    lengths: torch.Tensor,  # [B] int32 (-1 = fail closed)
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (mask_lo [B] int32, mask_hi [B] int32), one scalar start: the
    ``dfa_walk`` entry of the K7 kernel."""
    return _walk("dfa_walk", dfa_walk_plain, trans, 256, accept_lo, accept_hi,
                 start, str_bytes, lengths, max_len, scalar_start=True)


def dfa_match_batch_fused(
    trans: torch.Tensor,  # [Q, 256] int32 (stacked fields, absolute ids)
    accept_lo: torch.Tensor,  # [Q] int32
    accept_hi: torch.Tensor,  # [Q] int32
    starts: torch.Tensor,  # [B] int32 per-row start state
    str_bytes: torch.Tensor,  # [B, max_len] uint8 (or int32)
    lengths: torch.Tensor,  # [B] int32 (-1 = fail closed)
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-byte walk with PER-ROW start states: one launch
    classifies every field of the whole batch against its own
    sub-automaton of the stacked table (the ``dfa_walk_fused`` entry of
    the K7 kernel)."""
    return _walk("dfa_walk_fused", dfa_walk_plain, trans, 256, accept_lo, accept_hi,
                 starts, str_bytes, lengths, max_len, scalar_start=False)


def dfa_match_batch_pair(
    pair: torch.Tensor,  # [Q, 257*257] int32 stride-2 table
    accept_lo: torch.Tensor,  # [Q] int32
    accept_hi: torch.Tensor,  # [Q] int32
    starts: torch.Tensor,  # [B] int32 per-row start state
    str_bytes: torch.Tensor,  # [B, max_len] uint8 (or int32), 0-padded
    lengths: torch.Tensor,  # [B] int32 (-1 = fail closed)
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stride-2 walk: ceil(max_len/2) chained gathers instead of
    max_len. Tail positions past the string length (or past
    ``max_len``) are the identity symbol IN-KERNEL, so the packed
    buffers stay 0-padded (the K8 ``dfa_pair_walk`` kernel)."""
    return _walk("dfa_pair_walk", dfa_pair_walk_plain, pair, PAIR_ALPHA * PAIR_ALPHA,
                 accept_lo, accept_hi, starts, str_bytes, lengths, max_len,
                 scalar_start=False)


def accept_words(accept: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[Q] uint64 accept masks → (lo, hi) [Q] int32 bit views of their
    uint32 halves."""
    acc = np.asarray(accept, np.uint64)
    lo = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (acc >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def masks_u64(lo: torch.Tensor, hi: torch.Tensor) -> np.ndarray:
    """(mask_lo, mask_hi) int32 bit views → host [B] uint64 masks."""
    lo64 = lo.cpu().numpy().view(np.uint32).astype(np.uint64)
    hi64 = hi.cpu().numpy().view(np.uint32).astype(np.uint64)
    return lo64 | (hi64 << np.uint64(32))


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """numpy → tensor on ``dev``; a read-only array (a view of a JAX
    buffer) is copied so the tensor never aliases it."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def device_dfa(
    dfa: "MultiDFA", device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host MultiDFA → tensors on ``device`` (None = the card): trans,
    accept lo / hi words (int32 bit views) and the [] int32 start."""
    dev = _kernels.resolve_device(device)
    lo, hi = accept_words(dfa.accept)
    return (
        _on(np.asarray(dfa.trans, np.int32), dev),
        _on(lo, dev),
        _on(hi, dev),
        torch.tensor(int(dfa.start), dtype=torch.int32, device=dev),
    )


def match_patterns(
    dfa: "MultiDFA", strings: Sequence[bytes], max_len: int = 128, device=None
) -> np.ndarray:
    """Convenience host API → [B] uint64 accept masks."""
    dev = _kernels.resolve_device(device)
    sb, lens = strings_to_batch(strings, max_len)
    lo, hi = dfa_match_batch(
        *device_dfa(dfa, dev), _on(sb, dev), _on(lens, dev), max_len
    )
    return masks_u64(lo, hi)


# ---------------------------------------------------------------------------
# fused multi-field tables + length-bucketed walks (copies)
# ---------------------------------------------------------------------------


def len_rung(needed: int, cap: int) -> int:
    """Smallest ladder rung covering ``needed`` bytes; batches whose
    longest string exceeds the top rung walk at the field cap (itself a
    fixed shape — one extra rung per policy, not per batch)."""
    for rung in L7_LEN_LADDER:
        if needed <= rung and rung <= cap:
            return rung
    return cap


@dataclasses.dataclass(frozen=True)
class FusedDFA:
    """Per-field automata stacked into one transition tensor.

    Field f's states live in rows [f*q_pad, (f+1)*q_pad); transitions
    are rebased to absolute row ids so the flat chained gather of the
    single-DFA walk works unchanged — only the START state becomes
    per-row instead of scalar. ``pair`` (optional) is the stride-2
    table: pair[q, a*257 + b] = trans[trans[q, a], b] with symbol 256
    the identity pad."""

    trans: np.ndarray  # [F*q_pad, 256] int32, absolute row ids
    accept: np.ndarray  # [F*q_pad] uint64
    starts: np.ndarray  # [F] int32 absolute start states
    q_pad: int
    n_fields: int
    pair: Optional[np.ndarray]  # [F*q_pad, 257*257] int32 or None

    @property
    def n_states(self) -> int:
        return self.n_fields * self.q_pad


def _pair_table(trans: np.ndarray) -> np.ndarray:
    """[Q, 256]-step table → [Q, 257*257] double-step table, built
    host-side in one fancy-index composition: two walk levels collapse
    into one gather, halving the chained-gather depth on device."""
    q = trans.shape[0]
    p = np.empty((q, PAIR_ALPHA, PAIR_ALPHA), np.int32)
    p[:, :256, :256] = trans[trans]  # trans[trans[q, a], b]
    p[:, :256, 256] = trans  # (byte, pad): single step
    p[:, 256, :256] = trans  # unreachable mid-string pad; keep total
    p[:, 256, 256] = np.arange(q, dtype=np.int32)  # (pad, pad): identity
    return p.reshape(q, PAIR_ALPHA * PAIR_ALPHA)


def fuse_dfas(
    dfas: Sequence["MultiDFA"], pair_cap_elems: int = PAIR_TABLE_CAP_ELEMS
) -> FusedDFA:
    """Stack one policy's field DFAs (method/path/host, or kafka
    topic/client-id) into a FusedDFA so every field of a request batch
    classifies in a single launch."""
    if not dfas:
        raise ValueError("fuse_dfas needs at least one automaton")
    q_pad = max(d.trans.shape[0] for d in dfas)
    f = len(dfas)
    trans = np.empty((f * q_pad, 256), np.int32)
    accept = np.zeros(f * q_pad, np.uint64)
    starts = np.empty(f, np.int32)
    for i, d in enumerate(dfas):
        q = d.trans.shape[0]
        base = i * q_pad
        trans[base : base + q] = d.trans + base
        # padding rows are unreachable; self-loop them into the block's
        # dead state so every row id stays inside its field block
        trans[base + q : base + q_pad] = base
        accept[base : base + q] = d.accept
        starts[i] = base + d.start
    pair = None
    if f * q_pad * PAIR_ALPHA * PAIR_ALPHA <= pair_cap_elems:
        pair = _pair_table(trans)
    return FusedDFA(
        trans=trans, accept=accept, starts=starts, q_pad=q_pad,
        n_fields=f, pair=pair,
    )


# ---------------------------------------------------------------------------
# device residence
# ---------------------------------------------------------------------------


class DeviceDFATable:
    """Residence of one FusedDFA on one device (interned — see below).

    Holds the transfer-once tensors plus the host-side start vector
    from which per-batch start columns are built."""

    __slots__ = (
        "key", "device", "trans", "accept_lo", "accept_hi", "pair",
        "starts_host", "n_states", "n_fields", "q_pad", "has_pair",
        "device_bytes",
    )

    def __init__(self, key: Tuple, fused: FusedDFA, device=None) -> None:
        dev = _kernels.resolve_device(device)
        lo, hi = accept_words(fused.accept)
        self.key = key
        self.device = dev
        self.trans = _on(np.asarray(fused.trans, np.int32), dev)
        self.accept_lo = _on(lo, dev)
        self.accept_hi = _on(hi, dev)
        self.pair = _on(np.asarray(fused.pair, np.int32), dev) if fused.pair is not None else None
        self.starts_host = np.asarray(fused.starts, np.int32)
        self.n_states = fused.n_states
        self.n_fields = fused.n_fields
        self.q_pad = fused.q_pad
        self.has_pair = fused.pair is not None
        # memory ledger: device-resident bytes of this table
        self.device_bytes = sum(
            t.numel() * t.element_size()
            for t in (self.trans, self.accept_lo, self.accept_hi, self.pair)
            if t is not None
        )


# Interned device tables, keyed by (device, pattern-set key): N
# endpoints with the same policy share ONE table instead of N copies.
# Bounded LRU — a changed pattern set produces a new key
# (content-addressed, so invalidation is just eviction of entries
# nothing references anymore).
DFA_INTERN_CAP = 32
_intern_lock = threading.Lock()
_interned: "OrderedDict[Tuple, DeviceDFATable]" = OrderedDict()


def _device_key(dev: torch.device) -> str:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def intern_fused_table(
    key: Tuple, build: Callable[[], FusedDFA], device=None
) -> DeviceDFATable:
    dev = _kernels.resolve_device(device)
    ikey = (_device_key(dev), key)
    with _intern_lock:
        tab = _interned.get(ikey)
        if tab is not None:
            _interned.move_to_end(ikey)
            metrics.l7_dfa_intern_total.inc({"result": "hit"})
            return tab
    # build + transfer outside the lock (subset construction and the
    # pair-table composition can be slow for big automata)
    tab = DeviceDFATable(key, build(), dev)
    with _intern_lock:
        raced = _interned.get(ikey)
        if raced is not None:
            _interned.move_to_end(ikey)
            metrics.l7_dfa_intern_total.inc({"result": "hit"})
            return raced
        _interned[ikey] = tab
        metrics.l7_dfa_intern_total.inc({"result": "miss"})
        while len(_interned) > DFA_INTERN_CAP:
            _interned.popitem(last=False)
            metrics.l7_dfa_intern_total.inc({"result": "evict"})
        metrics.l7_dfa_tables_interned.set(len(_interned))
        metrics.device_table_bytes.set(
            float(sum(t.device_bytes for t in _interned.values())),
            {"family": "dfa", "placement": "replicated"},
        )
    return tab


def dfa_intern_stats() -> Tuple[int, int]:
    """→ (live interned tables, cap)."""
    with _intern_lock:
        return len(_interned), DFA_INTERN_CAP


def _reset_intern_for_tests() -> None:
    with _intern_lock:
        _interned.clear()
        metrics.l7_dfa_tables_interned.set(0)
        metrics.device_table_bytes.set(
            0.0, {"family": "dfa", "placement": "replicated"}
        )
