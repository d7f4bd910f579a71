"""Longest-prefix match: the stride-8 tries (IPv6, and IPv4 in the
JAX package's classic layout) and the IPv4 wide tries.

Replaces the kernel LPM trie maps (bpf/lib/maps.h cilium_ipcache LPM,
bpf/bpf_xdp.c:54-86 CIDR deny tries) with device-resident tables
walked by chained gathers. The numpy builders below are copies of the
JAX package's (``TrieBuilder``, ``build_trie``, ``build_trie_elided``,
``merge_trie_entries``, ``WideTrieBuilder``, ``FlatTrieBuilder``,
``build_wide_trie``, ``merge_flat_tries``). The walks launch a kernel
on a CUDA tensor and run its plain version on a CPU tensor:
:func:`lpm_lookup` / :func:`elided_lookup` the ``lpm_stride8`` kernel
(csrc/lpm_stride8.cu, plain :func:`lpm_stride8_plain`), and
:func:`lpm_lookup_wide` the ``lpm_wide`` kernel (csrc/lpm_wide.cu,
plain :func:`lpm_wide_plain`).

:class:`PatchableElidedTrie` and :class:`PatchableFlatTrie` (copies of
the JAX package's) keep host mirrors of an identity trie that take
single-prefix inserts and deletes; their ``flush`` writes only the
dirty node rows and dense spans into the device tensors, each with one
out-of-place torch op (``index_copy`` / ``slice_scatter``).

Layouts (all return value+1, 0 = no match, longest match wins):

    stride-8:    child/info [M, 256] (node 0 is the root), one level
                 per address byte, the trie's elided shared prefix
                 bytes ``common`` [K] compared instead of walked
    flat 16+16:  root_info/root_child [65536], sub_info [M, 65536]
                 (sub_child [1, 65536] marks the layout) — 2 gathers
    16-8-8:      root_info/root_child [65536], sub_child/sub_info
                 [M, 256] stride-8 nodes — 3 gathers
"""

from __future__ import annotations

import ipaddress
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..convert import _tensor
from .lookup import replicate


class TrieBuilder:
    """Host-side incremental stride-8 trie. Rebuild-on-change is cheap
    (ms for 100k prefixes); the device arrays are immutable snapshots."""

    def __init__(self, levels: int) -> None:
        self.levels = levels
        # node storage: list of dicts byte→child_id / (value+1, plen)
        self._children: List[Dict[int, int]] = [{}]
        self._info: List[Dict[int, Tuple[int, int]]] = [{}]

    def _new_node(self) -> int:
        self._children.append({})
        self._info.append({})
        return len(self._children) - 1

    def _write(self, node: int, slot: int, value: int, plen: int) -> None:
        # Within one level, slots covered by several prefixes keep the
        # longest writer (a /0 expansion must not clobber a /8 entry) —
        # insert-order independence like the kernel LPM trie.
        old = self._info[node].get(slot)
        if old is None or plen >= old[1]:
            self._info[node][slot] = (value + 1, plen)

    def insert(self, prefix_bytes: bytes, prefix_len: int, value: int) -> None:
        """value ≥ 0; stored as value+1 internally."""
        node = 0
        full, rem = divmod(prefix_len, 8)
        for i in range(full):
            b = prefix_bytes[i]
            if rem == 0 and i == full - 1:
                self._write(node, b, value, prefix_len)
                return
            nxt = self._children[node].get(b)
            if nxt is None:
                nxt = self._new_node()
                self._children[node][b] = nxt
            node = nxt
        # partial byte: populate all covered slots at this level
        b = prefix_bytes[full] if full < len(prefix_bytes) else 0
        lo = b & (0xFF << (8 - rem)) & 0xFF
        for slot in range(lo, lo + (1 << (8 - rem))):
            self._write(node, slot, value, prefix_len)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        m = len(self._children)
        child = np.zeros((m, 256), np.int32)
        info = np.zeros((m, 256), np.int32)
        for n in range(m):
            for b, c in self._children[n].items():
                child[n, b] = c
            for b, (v, _plen) in self._info[n].items():
                info[n, b] = v
        return child, info


def build_trie(
    prefixes: Iterable[Tuple[str, int]], *, ipv6: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """[(cidr_string, value)] → (child, info) arrays for one family."""
    levels = 16 if ipv6 else 4
    t = TrieBuilder(levels)
    for cidr, value in prefixes:
        net = ipaddress.ip_network(cidr, strict=False)
        if (net.version == 6) != ipv6:
            continue
        t.insert(net.network_address.packed, net.prefixlen, value)
    return t.arrays()


def build_trie_elided(
    prefixes: Iterable[Tuple[str, int]], *, ipv6: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[(cidr_string, value)] → (child, info, common_bytes) with the
    longest shared whole-byte prefix ELIDED from the trie.

    IPv6 pod allocations share a long prefix (everything under one
    /48-/64), so a full 16-level byte walk wastes most of its chained
    gathers traversing single-child nodes. The shared K bytes come
    back as ``common_bytes`` ([K] int32): the lookup compares them
    against the batch instead of walking them and walks only the
    remaining 16-K levels. Elision applies only while EVERY prefix is
    at least K whole bytes long (a shorter deny CIDR disables it), and
    K is capped one byte short so at least one walk level remains."""
    size = 16 if ipv6 else 4
    entries = []
    for cidr, value in prefixes:
        net = ipaddress.ip_network(cidr, strict=False)
        if (net.version == 6) != ipv6:
            continue
        entries.append((net.network_address.packed, net.prefixlen, value))
    k = 0
    if entries:
        first = entries[0][0]
        k = min(min(p for _, p, _ in entries) // 8, size - 1)
        for packed, _p, _v in entries:
            while k and packed[:k] != first[:k]:
                k -= 1
    t = TrieBuilder(size - k)
    for packed, plen, value in entries:
        t.insert(packed[k:], plen - 8 * k, value)
    child, info = t.arrays()
    common = (
        np.frombuffer(entries[0][0][:k], np.uint8).astype(np.int32)
        if k
        else np.zeros(0, np.int32)
    )
    return child, info, common


# The deepest walk K5 and K11 read as 16-byte vectors (csrc/lpm_walk.cuh
# LPM_VEC_LEVELS): an IPv6 address's 16 int32 bytes.
LPM_VEC_LEVELS = 16

# The route of each stride-8 walk's latest launch on the card, keyed by
# kernel name ("lpm_stride8", "shed_walk_stride8").
STRIDE8_ROUTES: Dict[str, str] = {}


def lpm_stride8_route(stride: int, levels: int, data_ptr: int) -> str:
    """The path a stride-8 walk (K5, K11's v6 entry) takes inside its
    kernel: "vector" (the row as 16-byte loads issued together, the
    compare and the walk on registers) when ``levels`` <=
    LPM_VEC_LEVELS and both the row stride in bytes (4 x ``stride``)
    and the base pointer are multiples of 16; else "scalar" (one
    int32 byte a step). The C entries refuse a vector route their
    inputs do not allow."""
    vec = levels <= LPM_VEC_LEVELS and (4 * stride) % 16 == 0 and data_ptr % 16 == 0
    return "vector" if vec else "scalar"


def lpm_stride8_plain(
    child: torch.Tensor,  # [M, 256] int32
    info: torch.Tensor,  # [M, 256] int32
    common: torch.Tensor,  # [K] int32 elided shared prefix bytes
    addr_bytes: torch.Tensor,  # [B, >= levels] int32, one byte per level
    levels: int,
) -> torch.Tensor:
    """Plain PyTorch version of the ``lpm_stride8`` kernel → [B] int32
    value+1 (0 = no match). An address whose first K bytes differ from
    ``common`` matches nothing; the rest walks ``levels - K`` stride-8
    levels from node 0, the deepest ``info > 0`` winning, and stops at
    a child id outside [1, M). A byte outside [0, 255] reads nothing
    and ends the walk, like the fill of an out-of-range ``jnp.take``."""
    b = addr_bytes.shape[0]
    k = common.shape[0]
    m = info.shape[0]
    flat_i = info.reshape(-1)
    flat_c = child.reshape(-1)
    best = torch.zeros(b, dtype=torch.int32, device=addr_bytes.device)
    alive = torch.ones(b, dtype=torch.bool, device=addr_bytes.device)
    if k:
        alive = (addr_bytes[:, :k] == common[None, :]).all(dim=1)
    node = torch.zeros(b, dtype=torch.int64, device=addr_bytes.device)
    for lvl in range(k, levels):
        byte = addr_bytes[:, lvl].long()
        alive = alive & (byte >= 0) & (byte < 256)
        flat = torch.where(alive, node * 256 + byte, 0)
        hit = flat_i[flat]
        best = torch.where(alive & (hit > 0), hit, best)
        nxt = flat_c[flat].long()
        alive = alive & (nxt > 0) & (nxt < m)
        node = torch.where(alive, nxt, node)
    return best


def elided_lookup(
    child: torch.Tensor,  # [M, 256] int32
    info: torch.Tensor,  # [M, 256] int32
    common: torch.Tensor,  # [K] int32
    addr_bytes: torch.Tensor,  # [B, >= levels] int32
    levels: int,
) -> torch.Tensor:
    """→ [B] int32: matched value+1, 0 = no match (longest wins), over
    an elided trie (:func:`build_trie_elided`): the K shared prefix
    bytes are compared inside the same kernel launch and only
    ``levels - K`` levels are walked; an address that differs in them
    matches nothing."""
    dev = _kernels.dispatch_device(child, info, common, addr_bytes)
    k = common.shape[0]
    if (
        child.dim() != 2 or child.shape[-1] != 256 or child.shape != info.shape
        or addr_bytes.dim() != 2 or not 0 <= k <= levels <= addr_bytes.shape[1]
    ):
        raise ValueError("lpm_stride8: not a stride-8 trie and address batch")
    if dev.type == "cpu":
        return lpm_stride8_plain(child, info, common, addr_bytes, levels)
    args = [x.to(torch.int32).contiguous() for x in (child, info, common, addr_bytes)]
    out = torch.empty(addr_bytes.shape[0], dtype=torch.int32, device=dev)
    _kernels.check_cuda("lpm_stride8", dev, *args, out)
    ch, inf, com, addr = args
    route = lpm_stride8_route(addr.shape[1], levels, addr.data_ptr())
    STRIDE8_ROUTES["lpm_stride8"] = route
    _kernels.KERNELS["lpm_stride8"].launch(
        dev, ch.data_ptr(), inf.data_ptr(), ch.shape[0], com.data_ptr(), k,
        addr.data_ptr(), addr.shape[1], levels, out.data_ptr(), addr.shape[0],
        int(route == "vector"),
    )
    return out


def lpm_lookup(
    child: torch.Tensor,  # [M, 256] int32
    info: torch.Tensor,  # [M, 256] int32
    addr_bytes: torch.Tensor,  # [B, levels] int32 (byte per level)
    levels: int = 4,
) -> torch.Tensor:
    """→ [B] int32: matched value+1, 0 = no match (longest wins)."""
    no_common = torch.zeros(0, dtype=torch.int32, device=addr_bytes.device)
    return elided_lookup(child, info, no_common, addr_bytes, levels)


class _DenseRoot:
    """Shared 16-bit dense first stride (root_info/root_child +
    per-slot plen precedence) for both wide-trie layouts — one copy of
    the masking and longest-prefix tie-break semantics."""

    def __init__(self) -> None:
        self.root_info = np.zeros(65536, np.int32)
        self._root_plen = np.full(65536, -1, np.int32)
        self.root_child = np.zeros(65536, np.int32)

    @staticmethod
    def _mask(addr_u32: int, plen: int) -> int:
        return (
            addr_u32 & ((0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF)
            if plen else 0
        )

    def _root_insert(self, addr_u32: int, plen: int, value: int) -> None:
        """plen ≤ 16: fill the covered root range, longest plen wins."""
        hi = addr_u32 >> 16
        span = 1 << (16 - plen)
        sl = slice(hi, hi + span)
        mask = self._root_plen[sl] <= plen
        self.root_info[sl] = np.where(mask, value + 1, self.root_info[sl])
        self._root_plen[sl] = np.where(mask, plen, self._root_plen[sl])


class WideTrieBuilder(_DenseRoot):
    """IPv4 LPM with a DENSE 16-bit first stride: level 1 is one
    [65536] direct-indexed table (the DIR-24-8 idea, sized 16-8-8 so
    the dense level stays 256KB), levels 2-3 are stride-8 nodes. The
    walk is 3 gathers instead of 4 — measured ~1.8× over the stride-8
    trie at 50k prefixes — and the first gather indexes a small dense
    array, the TPU-friendliest access pattern of the three."""

    def __init__(self) -> None:
        super().__init__()
        # stride-8 node storage (node 0 reserved = "none")
        self._children: List[Dict[int, int]] = [{}]
        self._infos: List[Dict[int, Tuple[int, int]]] = [{}]

    def _new_node(self) -> int:
        self._children.append({})
        self._infos.append({})
        return len(self._children) - 1

    def _write(self, node: int, base: int, span: int, value: int, plen: int) -> None:
        for s in range(base, base + span):
            old = self._infos[node].get(s)
            if old is None or plen >= old[1]:
                self._infos[node][s] = (value + 1, plen)

    def insert(self, addr_u32: int, plen: int, value: int) -> None:
        addr_u32 = self._mask(addr_u32, plen)
        hi = addr_u32 >> 16
        if plen <= 16:
            self._root_insert(addr_u32, plen, value)
            return
        node = self.root_child[hi]
        if node == 0:
            node = self._new_node()
            self.root_child[hi] = node
        b2 = (addr_u32 >> 8) & 0xFF
        rem = plen - 16
        if rem <= 8:
            span = 1 << (8 - rem)
            self._write(node, b2 & (0xFF << (8 - rem)) & 0xFF, span, value, plen)
            return
        nxt = self._children[node].get(b2)
        if nxt is None:
            nxt = self._new_node()
            self._children[node][b2] = nxt
        rem2 = rem - 8
        span = 1 << (8 - rem2)
        base = (addr_u32 & 0xFF) & (0xFF << (8 - rem2)) & 0xFF
        self._write(nxt, base, span, value, plen)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        m = len(self._children)
        sub_child = np.zeros((m, 256), np.int32)
        sub_info = np.zeros((m, 256), np.int32)
        for n in range(m):
            for b, c in self._children[n].items():
                sub_child[n, b] = c
            for b, (v, _plen) in self._infos[n].items():
                sub_info[n, b] = v
        return self.root_info.copy(), self.root_child.copy(), sub_child, sub_info


class FlatTrieBuilder(_DenseRoot):
    """IPv4 LPM with TWO dense 16-bit strides: level 1 is the [65536]
    root table, level 2 is one [65536] table per hi-16 that carries
    longer-than-/16 prefixes. The walk is 2 chained gathers (vs 3 for
    the 16-8-8 layout) — the LPM walk is the whole-pipeline bottleneck,
    so one fewer dependent gather is ~1/3 more end-to-end throughput.

    Memory/rebuild cost: 256KB per level-2 node, re-uploaded on every
    trie rebuild (identity row churn included). That is comparable to
    the 16-8-8 layout at production scale — 50k scattered prefixes
    build ~37k stride-8 nodes = ~76MB of child+info arrays, vs ≤33MB
    here at the node budget — so the flat layout is capped where it
    stops being the cheaper transfer, not grown until it fits."""

    def __init__(self) -> None:
        super().__init__()
        # node id → (info [65536], plen [65536]); id 0 reserved = none
        self._nodes: List[Tuple[np.ndarray, np.ndarray]] = []

    def _node(self, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        nid = self.root_child[hi]
        if nid == 0:
            self._nodes.append((
                np.zeros(65536, np.int32), np.full(65536, -1, np.int32)
            ))
            nid = len(self._nodes)  # 1-based
            self.root_child[hi] = nid
        return self._nodes[nid - 1]

    def insert(self, addr_u32: int, plen: int, value: int) -> None:
        addr_u32 = self._mask(addr_u32, plen)
        hi = addr_u32 >> 16
        if plen <= 16:
            self._root_insert(addr_u32, plen, value)
            return
        info, plens = self._node(hi)
        base = addr_u32 & 0xFFFF
        span = 1 << (32 - plen)
        sl = slice(base, base + span)
        mask = plens[sl] <= plen
        info[sl] = np.where(mask, value + 1, info[sl])
        plens[sl] = np.where(mask, plen, plens[sl])

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        m = len(self._nodes) + 1  # row 0 = "no node", all zeros
        sub_info = np.zeros((m, 65536), np.int32)
        for i, (info, _plens) in enumerate(self._nodes):
            sub_info[i + 1] = info
        # sub_child is unused in this layout (its [*, 65536] shape is
        # what routes lpm_lookup_wide onto the 2-gather branch)
        sub_child = np.zeros((1, 65536), np.int32)
        return self.root_info.copy(), self.root_child.copy(), sub_child, sub_info


# level-2 node budget for the flat layout: 128 nodes = 33MB per trie
# (rebuilt + re-uploaded on ipcache/identity churn); past that the
# 16-8-8 pointer structure wins on transfer size
FLAT_TRIE_MAX_NODES = 128


def build_wide_trie(
    prefixes: Iterable[Tuple[str, int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """[(v4 cidr_string, value)] → wide-trie arrays (v6 entries are
    skipped — the wide layout is IPv4-only). Picks the 2-gather flat
    16+16 layout when the deep prefixes cluster into few /16s (the
    normal pod-CIDR shape), else the 16-8-8 layout."""
    parsed = []
    deep_hi16 = set()
    for cidr, value in prefixes:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            continue
        addr, plen = int(net.network_address), net.prefixlen
        parsed.append((addr, plen, value))
        if plen > 16:
            deep_hi16.add(addr >> 16)
    t = (
        FlatTrieBuilder()
        if len(deep_hi16) <= FLAT_TRIE_MAX_NODES
        else WideTrieBuilder()
    )
    for addr, plen, value in parsed:
        t.insert(addr, plen, value)
    return t.arrays()


# -- fused deny+identity walk (v6 stride-8 elided tries) --------------------


class _HostLPM:
    """Host-side LPM oracle over one prefix set: per-plen exact-match
    dicts, queried longest-first. O(#distinct plens) per query — the
    merge below asks it once per union prefix."""

    def __init__(self, entries) -> None:  # [(packed_bytes, plen, value)]
        self._by_plen: Dict[int, Dict[bytes, int]] = {}
        for packed, plen, value in entries:
            masked = _mask_bytes(packed, plen)
            self._by_plen.setdefault(plen, {})[masked] = value
        self._plens = sorted(self._by_plen, reverse=True)

    def lookup(self, packed: bytes, plen: int) -> int:
        """Longest match covering prefix (packed/plen) → value+1, 0 =
        none. Only prefixes of length ≤ plen can cover it."""
        for p in self._plens:
            if p > plen:
                continue
            hit = self._by_plen[p].get(_mask_bytes(packed, p))
            if hit is not None:
                return hit + 1
        return 0


def _mask_bytes(packed: bytes, plen: int) -> bytes:
    full, rem = divmod(plen, 8)
    out = bytearray(len(packed))
    out[:full] = packed[:full]
    if rem and full < len(packed):
        out[full] = packed[full] & (0xFF << (8 - rem)) & 0xFF
    return bytes(out)


def merge_trie_entries(ip_prefixes, deny_prefixes, *, ipv6=True):
    """[(cidr, value)] identity + [(cidr, _)] deny → ONE packed prefix
    list [(cidr, packed_value)] whose LPM equals BOTH sides' LPMs at
    every address: packed = (identity value+1) | DENY_BIT·denied.

    Every union prefix carries the OTHER side's LPM answer at that
    point, so a longer prefix from one side cannot shadow the other
    side's match (the correctness trap of a naive set union). Feed the
    result to build_trie_elided for the fused stride-8 walk."""
    def parse(prefixes):
        out = []
        for cidr, value in prefixes:
            net = ipaddress.ip_network(cidr, strict=False)
            if (net.version == 6) != ipv6:
                continue
            out.append((net.network_address.packed, net.prefixlen, value))
        return out

    ip_entries = parse(ip_prefixes)
    deny_entries = parse(deny_prefixes)
    ip_lpm = _HostLPM(ip_entries)
    deny_lpm = _HostLPM(deny_entries)
    union: Dict[Tuple[bytes, int], int] = {}
    for packed, plen, _v in ip_entries + deny_entries:
        key = (_mask_bytes(packed, plen), plen)
        if key in union:
            continue
        ip_v = ip_lpm.lookup(packed, plen)  # value+1, 0 = none
        if ip_v >= int(DENY_BIT) - 1:
            # packing range: the trie stores (ip_v | DENY_BIT) + 1,
            # which must stay inside int32 — the -1 keeps the denied
            # boundary case from overflowing
            return None
        denied = deny_lpm.lookup(packed, plen) > 0
        union[key] = ip_v | (int(DENY_BIT) if denied else 0)
    out = []
    for (packed, plen), pv in union.items():
        addr = ipaddress.ip_address(packed)
        out.append((f"{addr}/{plen}", pv))
    return out


# -- fused deny+identity walk (flat 16+16 layouts only) ---------------------
#
# The datapath's two v4 LPM walks — XDP deny trie and ipcache identity
# trie — consume the same address bytes (bpf_xdp.c:97-156 then
# bpf_netdev.c secctx). When BOTH tries use the dense flat layout their
# tables merge ELEMENT-WISE into one packed table: identity row+1 in
# the low bits, the deny verdict in one high bit — one 2-gather walk
# returns both results, halving the pipeline's gather count.

DENY_BIT = np.int32(1 << 30)
MERGED_VALUE_MASK = np.int32((1 << 30) - 1)


def _flat_value_grid(root_info, root_child, sub_info, his):
    """For each hi16 in ``his`` → [len(his), 65536] resolved LPM values
    (node entry where present, else the root's value — the flat
    layout's exact lookup semantics, vectorized)."""
    nodes = root_child[his]  # [H] node ids (0 = none)
    grid = sub_info[nodes]  # [H, 65536] (row 0 is all-zero)
    root_vals = root_info[his][:, None]  # [H, 1]
    return np.where(grid > 0, grid, root_vals)


def merge_flat_tries(ip_arrays, deny_arrays):
    """(ip flat-trie arrays, deny flat-trie arrays) → merged flat
    arrays, or None when either side uses the 16-8-8 pointer layout
    (merging needs the dense form). Identity values must stay below
    DENY_BIT."""
    # host-side table prep: the merge needs fancy indexing and in-place
    # writes, so pin the inputs to numpy up front — a device array
    # slipping in would otherwise turn every reduction below into a
    # blocking transfer (and int(...) on it into a device sync)
    ip_ri, ip_rc, ip_sc, ip_si = (np.asarray(a) for a in ip_arrays)
    d_ri, d_rc, d_sc, d_si = (np.asarray(a) for a in deny_arrays)
    if ip_si.shape[-1] != 65536 or d_si.shape[-1] != 65536:
        return None
    if (
        np.max(ip_si, initial=0) >= DENY_BIT
        or np.max(ip_ri, initial=0) >= DENY_BIT
    ):
        return None

    # hi16 buckets where either side holds longer-than-/16 prefixes
    his = np.union1d(np.nonzero(ip_rc)[0], np.nonzero(d_rc)[0]).astype(
        np.int64
    )
    if len(his) > FLAT_TRIE_MAX_NODES:
        # the UNION can exceed the per-trie transfer budget even when
        # each side fits — past it, the merged table costs more to
        # rebuild/upload per churn than the second walk saves
        return None
    m = len(his) + 1
    root_info = ip_ri.astype(np.int32).copy()
    root_info |= np.where(d_ri > 0, DENY_BIT, 0).astype(np.int32)
    root_child = np.zeros(65536, np.int32)
    sub_info = np.zeros((m, 65536), np.int32)
    if len(his):
        root_child[his] = np.arange(1, m, dtype=np.int32)
        ip_grid = _flat_value_grid(ip_ri, ip_rc, ip_si, his)
        d_grid = _flat_value_grid(d_ri, d_rc, d_si, his)
        sub_info[1:] = ip_grid | np.where(d_grid > 0, DENY_BIT, 0)
        # a merged node must never fall back to the root (its grid is
        # fully resolved); keep zero cells zero so "no match" stays 0 —
        # they already are, because _flat_value_grid resolves them to
        # the root value, which IS the correct fallback. But a cell
        # whose resolved value is 0 (no identity, no deny) must not
        # shadow the merged ROOT value either — it cannot, because the
        # root fallback only applies when the node cell is 0, and the
        # resolved grid equals that root fallback by construction.
    sub_child = np.zeros((1, 65536), np.int32)  # flat-layout marker
    return root_info, root_child, sub_child, sub_info


# -- O(delta) trie patching -------------------------------------------------
#
# ToFQDN-style small-CIDR storms churn the ipcache a few /32s//128s at a
# time; rebuilding + re-uploading whole tries per change is the
# reference's per-key LPM map write turned into a table rebuild. These
# builders keep HOST mirrors of the device trie tensors plus enough
# writer bookkeeping to insert/delete individual prefixes in place, and
# flush only the touched node rows / dense spans to the device copies —
# O(delta) words per churn instead of the whole trie. Node pools carry
# power-of-two headroom; exhaustion (or a layout/elision violation)
# returns False and the caller falls back to the classic full rebuild.
#
# Correctness bar: for any applied prefix set, the host mirrors are
# value-identical to what build_wide_trie / build_trie_elided would
# produce for that set (modulo zero-padded pool rows, which the walks
# never reach) — (prefix, plen) keys must be unique per trie, which the
# ipcache guarantees (normalized CIDR keys).


# The four scatter programs of the reference, each one out-of-place
# torch op on the tensors' device. Out of place on purpose: a batch
# enqueued before a churn may still read the old tensors (the
# reference's "no donation").


def _patch_trie_rows(
    child: torch.Tensor,  # [M, 256] int32
    info: torch.Tensor,  # [M, 256] int32
    idx: torch.Tensor,  # [k] int64 node rows, sorted and unique
    cvals: torch.Tensor,  # [k, 256]
    ivals: torch.Tensor,  # [k, 256]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dirty stride-8 node rows into both trie tensors. The rows are
    the exact dirty set (the reference pads them to a power of two)."""
    return child.index_copy(0, idx, cvals), info.index_copy(0, idx, ivals)


def _patch_span1(a: torch.Tensor, start: int, vals: torch.Tensor) -> torch.Tensor:
    """Dense-root span update (flat v4 layout): ``vals`` over
    ``a[start:start + len(vals)]``, which lies inside ``a``."""
    return a.slice_scatter(vals, 0, start, start + vals.shape[0])


def _patch_span_row(a: torch.Tensor, row: int, start: int, vals: torch.Tensor) -> torch.Tensor:
    """``vals`` over ``a[row, start:start + len(vals)]``: one contiguous
    span of the flat view."""
    off = row * a.shape[1] + start
    return a.reshape(-1).slice_scatter(vals, 0, off, off + vals.shape[0]).view(a.shape)


def _patch_elems(a: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``vals`` at the [k] int64 indices ``idx`` (unique) of ``a``."""
    return a.index_copy(0, idx, vals)


class PatchableElidedTrie:
    """Patchable host mirror of one build_trie_elided trie (v6 ip
    tries; also correct for v4 stride-8, unused there). Per-(node,
    slot) writers keyed by plen make deletes exact: at one slot of the
    final level, distinct covering prefixes necessarily carry distinct
    plens (same plen + same covered slot ⇒ same masked prefix ⇒ same
    ipcache key), so the remaining longest plen is the new winner."""

    def __init__(self, prefixes: Iterable[Tuple[str, int]], *, ipv6: bool = True):
        size = 16 if ipv6 else 4
        self._ipv6 = ipv6
        entries = []
        for cidr, value in prefixes:
            net = ipaddress.ip_network(cidr, strict=False)
            if (net.version == 6) != ipv6:
                continue
            entries.append((net.network_address.packed, net.prefixlen, value))
        k = 0
        if entries:
            first = entries[0][0]
            k = min(min(p for _, p, _ in entries) // 8, size - 1)
            for packed, _p, _v in entries:
                while k and packed[:k] != first[:k]:
                    k -= 1
        self._k = k
        self._levels = size - k
        self._common = entries[0][0][:k] if k else b""
        # node storage: byte→child dicts + per-slot {plen: value} writers
        self._children: List[Dict[int, int]] = [{}]
        self._writers: List[Dict[int, Dict[int, int]]] = [{}]
        self._live = False  # arrays not materialized yet
        self.child_h = np.zeros((0, 256), np.int32)
        self.info_h = np.zeros((0, 256), np.int32)
        self._dirty: set = set()
        for packed, plen, value in entries:
            self._ins(packed[k:], plen - 8 * k, value)
        m = len(self._children)
        cap = 8
        while cap < m + 1:  # ≥1 spare row for live inserts
            cap <<= 1
        self.child_h = np.zeros((cap, 256), np.int32)
        self.info_h = np.zeros((cap, 256), np.int32)
        for n in range(m):
            for b, c in self._children[n].items():
                self.child_h[n, b] = c
            for slot, w in self._writers[n].items():
                if w:
                    self.info_h[n, slot] = w[max(w)] + 1
        self._live = True

    # -- host structure ------------------------------------------------
    def _new_node(self) -> Optional[int]:
        nid = len(self._children)
        if self._live and nid >= self.child_h.shape[0]:
            return None  # pool exhausted → caller full-rebuilds
        self._children.append({})
        self._writers.append({})
        return nid

    def _write(self, node: int, slot: int, value: int, plen: int) -> None:
        w = self._writers[node].setdefault(slot, {})
        w[plen] = value
        if self._live:
            self.info_h[node, slot] = w[max(w)] + 1
            self._dirty.add(node)

    def _unwrite(self, node: int, slot: int, plen: int) -> None:
        w = self._writers[node].get(slot)
        if not w or plen not in w:
            return
        del w[plen]
        self.info_h[node, slot] = (w[max(w)] + 1) if w else 0
        self._dirty.add(node)

    def _ins(self, pb: bytes, plen: int, value: int) -> bool:
        node = 0
        full, rem = divmod(plen, 8)
        for i in range(full):
            b = pb[i]
            if rem == 0 and i == full - 1:
                self._write(node, b, value, plen)
                return True
            nxt = self._children[node].get(b)
            if nxt is None:
                nxt = self._new_node()
                if nxt is None:
                    return False
                self._children[node][b] = nxt
                if self._live:
                    self.child_h[node, b] = nxt
                    self._dirty.add(node)
            node = nxt
        b = pb[full] if full < len(pb) else 0
        lo = b & (0xFF << (8 - rem)) & 0xFF
        for slot in range(lo, lo + (1 << (8 - rem))):
            self._write(node, slot, value, plen)
        return True

    # -- public ops ----------------------------------------------------
    def _parse(self, cidr: str):
        net = ipaddress.ip_network(cidr, strict=False)
        if (net.version == 6) != self._ipv6:
            return None
        return net.network_address.packed, net.prefixlen

    def insert(self, cidr: str, value: int) -> bool:
        """Upsert one prefix. False → not expressible in place (family
        mismatch, elision violation, node-pool exhaustion): rebuild."""
        p = self._parse(cidr)
        if p is None:
            return False
        packed, plen = p
        if self._k and (plen < 8 * self._k or packed[: self._k] != self._common):
            return False  # would break the elided shared prefix
        return self._ins(packed[self._k:], plen - 8 * self._k, value)

    def delete(self, cidr: str) -> bool:
        """Remove one prefix (no-op when absent — e.g. its identity
        never had a device row). Deletes cannot violate elision or grow
        the pool, so this never demands a rebuild."""
        p = self._parse(cidr)
        if p is None:
            return True
        packed, plen = p
        if self._k and (plen < 8 * self._k or packed[: self._k] != self._common):
            return True  # was never inserted
        pb = packed[self._k:]
        plen -= 8 * self._k
        node = 0
        full, rem = divmod(plen, 8)
        for i in range(full):
            b = pb[i]
            if rem == 0 and i == full - 1:
                self._unwrite(node, b, plen)
                return True
            nxt = self._children[node].get(b)
            if nxt is None:
                return True  # path absent → prefix absent
            node = nxt
        b = pb[full] if full < len(pb) else 0
        lo = b & (0xFF << (8 - rem)) & 0xFF
        for slot in range(lo, lo + (1 << (8 - rem))):
            self._unwrite(node, slot, plen)
        return True

    @property
    def dirty(self) -> bool:
        return bool(self._dirty)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(child, info, common_bytes) — build_trie_elided layout with
        the pow2-padded node pool (zero rows the walk never reaches)."""
        common = (
            np.frombuffer(self._common, np.uint8).astype(np.int32)
            if self._k
            else np.zeros(0, np.int32)
        )
        return self.child_h.copy(), self.info_h.copy(), common

    def flush(self, child_dev: torch.Tensor, info_dev: torch.Tensor):
        """Scatter the dirty node rows into the device copies (out of
        place) → ((child, info), h2d bytes uploaded), or None when the
        device shape does not match the mirror (caller rebuilds)."""
        if not self._dirty:
            return (child_dev, info_dev), 0
        if tuple(child_dev.shape) != self.child_h.shape:
            return None
        rows = np.asarray(sorted(self._dirty), np.int64)
        cvals = self.child_h[rows]
        ivals = self.info_h[rows]
        dev = child_dev.device
        child_dev, info_dev = _patch_trie_rows(
            child_dev, info_dev, _tensor(rows, dev), _tensor(cvals, dev), _tensor(ivals, dev),
        )
        self._dirty.clear()
        nbytes = int(rows.nbytes) + int(cvals.nbytes) + int(ivals.nbytes)
        return (child_dev, info_dev), nbytes


class _FlatNode:
    """One level-2 dense node of the patchable flat v4 trie: resolved
    info/plen arrays + the raw entry dict the delete path recomputes
    spans from."""

    __slots__ = ("info", "plen", "entries")

    def __init__(self) -> None:
        self.info = np.zeros(65536, np.int32)
        self.plen = np.full(65536, -1, np.int16)
        self.entries: Dict[Tuple[int, int], int] = {}


class PatchableFlatTrie:
    """Patchable host mirror of one flat 16+16 v4 trie
    (FlatTrieBuilder layout). Root precedence keeps a per-plen [17,
    65536] value table (≤16 plens ⇒ winner recompute is 17 vectorized
    selects over the touched span); deep nodes recompute deleted spans
    from their entry dicts. Dirty state flushes as power-of-two dense
    spans, one out-of-place op a tensor."""

    def __init__(self, prefixes: Iterable[Tuple[int, int, int]]):
        # prefixes: parsed (addr_u32, plen, value) v4 entries
        self._root_by_plen = np.zeros((17, 65536), np.int32)  # value+1
        self.root_info = np.zeros(65536, np.int32)
        self.root_child = np.zeros(65536, np.int32)
        self._nodes: List[_FlatNode] = []
        entries = list(prefixes)
        n_deep = len({a >> 16 for a, p, _v in entries if p > 16})
        cap = 4
        while cap < n_deep + 2:  # ≥1 spare node row (row 0 = none)
            cap <<= 1
        self._cap_rows = min(cap, FLAT_TRIE_MAX_NODES * 2)
        # (start, pow2 width) dense-root spans / node ids / (nid, base,
        # pow2 width) node spans touched since the last flush
        self._dirty_root: Dict[Tuple[int, int], None] = {}
        self._dirty_child: Dict[int, None] = {}
        self._dirty_sub: Dict[Tuple[int, int, int], None] = {}
        for addr, plen, value in entries:
            ok = self._ins(addr, plen, value)
            assert ok  # cap covers the build set by construction
        self._clear_dirty()

    def _clear_dirty(self) -> None:
        self._dirty_root.clear()
        self._dirty_child.clear()
        self._dirty_sub.clear()

    @staticmethod
    def _mask(addr_u32: int, plen: int) -> int:
        return (
            addr_u32 & ((0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF)
            if plen else 0
        )

    def _root_recompute(self, sl: slice) -> None:
        out = np.zeros(sl.stop - sl.start, np.int32)
        for p in range(17):  # ascending: longer plen overwrites
            v = self._root_by_plen[p, sl]
            out = np.where(v > 0, v, out)
        self.root_info[sl] = out

    def _ins(self, addr: int, plen: int, value: int) -> bool:
        addr = self._mask(addr, plen)
        hi = addr >> 16
        if plen <= 16:
            span = 1 << (16 - plen)
            sl = slice(hi, hi + span)
            self._root_by_plen[plen, sl] = value + 1
            self._root_recompute(sl)
            self._dirty_root[(hi, span)] = None
            return True
        nid = int(self.root_child[hi])
        if nid == 0:
            if (
                len(self._nodes) + 2 > self._cap_rows
                or len(self._nodes) >= FLAT_TRIE_MAX_NODES
            ):
                return False  # pool exhausted / past the flat budget
            self._nodes.append(_FlatNode())
            nid = len(self._nodes)
            self.root_child[hi] = nid
            self._dirty_child[hi] = None
        node = self._nodes[nid - 1]
        node.entries[(addr, plen)] = value
        base = addr & 0xFFFF
        span = 1 << (32 - plen)
        sl = slice(base, base + span)
        m = node.plen[sl] <= plen
        node.info[sl] = np.where(m, value + 1, node.info[sl])
        node.plen[sl] = np.where(m, np.int16(plen), node.plen[sl])
        self._dirty_sub[(nid, base, span)] = None
        return True

    # -- public ops ----------------------------------------------------
    @staticmethod
    def _parse(cidr: str):
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            return None
        return int(net.network_address), net.prefixlen

    def insert(self, cidr: str, value: int) -> bool:
        p = self._parse(cidr)
        if p is None:
            return False
        return self._ins(p[0], p[1], value)

    def delete(self, cidr: str) -> bool:
        """Remove one prefix (no-op when absent). Never demands a
        rebuild: spans recompute from the surviving writers."""
        p = self._parse(cidr)
        if p is None:
            return True
        addr, plen = self._mask(p[0], p[1]), p[1]
        hi = addr >> 16
        if plen <= 16:
            span = 1 << (16 - plen)
            sl = slice(hi, hi + span)
            if not self._root_by_plen[plen, sl].any():
                return True  # absent
            self._root_by_plen[plen, sl] = 0
            self._root_recompute(sl)
            self._dirty_root[(hi, span)] = None
            return True
        nid = int(self.root_child[hi])
        if nid == 0:
            return True
        node = self._nodes[nid - 1]
        if node.entries.pop((addr, plen), None) is None:
            return True
        base = addr & 0xFFFF
        span = 1 << (32 - plen)
        sl = slice(base, base + span)
        node.info[sl] = 0
        node.plen[sl] = -1
        for (a2, p2), v2 in node.entries.items():
            b2 = a2 & 0xFFFF
            s2 = 1 << (32 - p2)
            lo, hi2 = max(base, b2), min(base + span, b2 + s2)
            if lo < hi2:
                ssl = slice(lo, hi2)
                m = node.plen[ssl] <= p2
                node.info[ssl] = np.where(m, v2 + 1, node.info[ssl])
                node.plen[ssl] = np.where(m, np.int16(p2), node.plen[ssl])
        self._dirty_sub[(nid, base, span)] = None
        return True

    @property
    def dirty(self) -> bool:
        return bool(self._dirty_root or self._dirty_child or self._dirty_sub)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """build_wide_trie flat-layout arrays with the pow2-padded node
        pool (zero rows resolve to the root fallback, exactly like an
        unallocated node)."""
        sub_info = np.zeros((self._cap_rows, 65536), np.int32)
        for i, node in enumerate(self._nodes):
            sub_info[i + 1] = node.info
        sub_child = np.zeros((1, 65536), np.int32)  # flat-layout marker
        return (
            self.root_info.copy(), self.root_child.copy(), sub_child,
            sub_info,
        )

    def flush(self, root_info_dev, root_child_dev, sub_child_dev, sub_info_dev):
        """Upload the dirty spans (out of place) → ((root_info, root_child,
        sub_child, sub_info), h2d bytes uploaded), or None on a
        device/mirror shape mismatch (caller rebuilds). A lone dirty span
        of a tensor is one span op that uploads its values; several
        gather into one index op on the flat view, so a burst copies each
        tensor once and not once a span (the reference dispatches one op
        a span). The values come from the final mirror, so overlapping
        spans agree."""
        if not self.dirty:
            return (root_info_dev, root_child_dev, sub_child_dev, sub_info_dev), 0
        if tuple(sub_info_dev.shape) != (self._cap_rows, 65536):
            return None
        dev = sub_info_dev.device
        nbytes = 0
        if len(self._dirty_root) == 1:
            (start, span), = self._dirty_root
            vals = self.root_info[start:start + span]
            root_info_dev = _patch_span1(root_info_dev, start, _tensor(vals, dev))
            nbytes += int(vals.nbytes)
        elif self._dirty_root:
            idx = _span_indices((s, w) for s, w in self._dirty_root)
            vals = self.root_info[idx]
            root_info_dev = _patch_elems(root_info_dev, _tensor(idx, dev), _tensor(vals, dev))
            nbytes += int(idx.nbytes) + int(vals.nbytes)
        if self._dirty_child:
            idx = np.asarray(sorted(self._dirty_child), np.int64)
            vals = self.root_child[idx]
            root_child_dev = _patch_elems(root_child_dev, _tensor(idx, dev), _tensor(vals, dev))
            nbytes += int(idx.nbytes) + int(vals.nbytes)
        if len(self._dirty_sub) == 1:
            (nid, base, span), = self._dirty_sub
            vals = self._nodes[nid - 1].info[base:base + span]
            sub_info_dev = _patch_span_row(sub_info_dev, nid, base, _tensor(vals, dev))
            nbytes += int(vals.nbytes)
        elif self._dirty_sub:
            idx = _span_indices((nid * 65536 + b, w) for nid, b, w in self._dirty_sub)
            nid, off = np.divmod(idx, 65536)
            vals = np.empty(idx.shape[0], np.int32)
            for n in np.unique(nid):
                sel = nid == n
                vals[sel] = self._nodes[n - 1].info[off[sel]]
            flat = _patch_elems(sub_info_dev.reshape(-1), _tensor(idx, dev), _tensor(vals, dev))
            sub_info_dev = flat.view(sub_info_dev.shape)
            nbytes += int(idx.nbytes) + int(vals.nbytes)
        self._clear_dirty()
        return (root_info_dev, root_child_dev, sub_child_dev, sub_info_dev), nbytes


def _span_indices(spans) -> np.ndarray:
    """The sorted distinct int64 indices that (start, width) spans cover."""
    return np.unique(np.concatenate([np.arange(s, s + w, dtype=np.int64) for s, w in spans]))


def make_patchable_wide(
    prefixes: Iterable[Tuple[str, int]]
) -> Optional[PatchableFlatTrie]:
    """PatchableFlatTrie over the v4 entries, or None when
    build_wide_trie would pick the 16-8-8 pointer layout (too many
    deep /16 buckets) — that layout is not patched; callers fall back
    to full rebuilds."""
    parsed = []
    deep_hi16 = set()
    for cidr, value in prefixes:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            continue
        addr, plen = int(net.network_address), net.prefixlen
        parsed.append((addr, plen, value))
        if plen > 16:
            deep_hi16.add(addr >> 16)
    if len(deep_hi16) > FLAT_TRIE_MAX_NODES:
        return None
    return PatchableFlatTrie(parsed)


def lpm_wide_plain(
    root_info: torch.Tensor,  # [65536] int32
    root_child: torch.Tensor,  # [65536] int32
    sub_child: torch.Tensor,  # [M, 256] or [1, 65536] int32
    sub_info: torch.Tensor,  # [M, 256] or [M, 65536] int32
    addr_u32: torch.Tensor,  # [B] int32 bit view of host-order addresses
) -> torch.Tensor:
    """Plain PyTorch version of the ``lpm_wide`` kernel → [B] int32
    value+1 (0 = no match). A node id outside [1, M) counts as none."""
    q = addr_u32.to(torch.int64) & 0xFFFFFFFF
    hi = q >> 16
    m = sub_info.shape[0]
    best = root_info[hi]
    node = root_child[hi].long()
    nok = (node > 0) & (node < m)
    node = torch.where(nok, node, 0)
    flat_i = sub_info.reshape(-1)
    if sub_info.shape[-1] == 65536:  # flat second stride
        v1 = flat_i[node * 65536 + (q & 0xFFFF)]
        return torch.where(nok & (v1 > 0), v1, best)
    flat_c = sub_child.reshape(-1)
    idx1 = node * 256 + ((q >> 8) & 0xFF)
    v1 = flat_i[idx1]
    n1 = flat_c[idx1].long()
    best = torch.where(nok & (v1 > 0), v1, best)
    n1ok = nok & (n1 > 0) & (n1 < m)
    v2 = flat_i[torch.where(n1ok, n1, 0) * 256 + (q & 0xFF)]
    return torch.where(n1ok & (v2 > 0), v2, best)


def lpm_lookup_wide(
    root_info: torch.Tensor,
    root_child: torch.Tensor,
    sub_child: torch.Tensor,
    sub_info: torch.Tensor,
    addr_u32: torch.Tensor,
) -> torch.Tensor:
    """→ [B] int32: matched value+1, 0 = no match (longest wins). The
    sub-table width routes between the flat 16+16 layout and 16-8-8."""
    dev = _kernels.dispatch_device(root_info, root_child, sub_child, sub_info, addr_u32)
    if dev.type == "cpu":
        return lpm_wide_plain(root_info, root_child, sub_child, sub_info, addr_u32)
    flat = sub_info.shape[-1] == 65536
    m = sub_info.shape[0]
    if root_info.shape != (65536,) or root_child.shape != (65536,) or (
        not flat and (sub_info.shape[-1] != 256 or sub_child.shape != sub_info.shape)
    ):
        raise ValueError("lpm_lookup_wide: not a wide-trie table set")
    args = [x.to(torch.int32).contiguous()
            for x in (root_info, root_child, sub_child, sub_info, addr_u32)]
    out = torch.empty(addr_u32.shape[0], dtype=torch.int32, device=dev)
    _kernels.check_cuda("lpm_wide", dev, *args, out)
    ri, rc, sc, si, addr = args
    _kernels.KERNELS["lpm_wide"].launch(
        dev, ri.data_ptr(), rc.data_ptr(), sc.data_ptr(), si.data_ptr(), m,
        int(flat), addr.data_ptr(), out.data_ptr(), addr.shape[0],
    )
    return out


def place_table(t: torch.Tensor, sharding=None):
    """One trie tensor as the verdict path reads it: with a plan's
    sharding (``datapath/placement.py``) REPLICATED across the grid — a
    :class:`~.lookup.Replicated` with a copy on each device, since every
    LPM walk reads the whole trie whichever flow shard it serves;
    without one the tensor itself. Centralized here so every trie
    consumer places tables the same way."""
    return t if sharding is None else replicate(t, sharding)


def ipv4_to_bytes(addrs: np.ndarray) -> np.ndarray:
    """[B] uint32 host-order IPv4 → [B, 4] int32 big-endian bytes."""
    a = addrs.astype(np.uint32)
    return np.stack(
        [(a >> 24) & 0xFF, (a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF], axis=1
    ).astype(np.int32)


def ip_strings_to_u32(ips: Iterable[str]) -> np.ndarray:
    return np.array([int(ipaddress.IPv4Address(ip)) for ip in ips], np.uint32)


def ipv6_to_bytes(ips: Iterable[str]) -> np.ndarray:
    return np.array(
        [list(ipaddress.IPv6Address(ip).packed) for ip in ips], np.int32
    )
