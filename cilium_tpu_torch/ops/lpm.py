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
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import _kernels


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
    _kernels.KERNELS["lpm_stride8"].launch(
        dev, ch.data_ptr(), inf.data_ptr(), ch.shape[0], com.data_ptr(), k,
        addr.data_ptr(), addr.shape[1], levels, out.data_ptr(), addr.shape[0],
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


def ipv4_to_bytes(addrs: np.ndarray) -> np.ndarray:
    """[B] uint32 host-order IPv4 → [B, 4] int32 big-endian bytes."""
    a = addrs.astype(np.uint32)
    return np.stack(
        [(a >> 24) & 0xFF, (a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF], axis=1
    ).astype(np.int32)


def ipv6_to_bytes(ips: Iterable[str]) -> np.ndarray:
    return np.array(
        [list(ipaddress.IPv6Address(ip).packed) for ip in ips], np.int32
    )
