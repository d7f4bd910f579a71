"""Port parity at the shapes and layouts that choose K1's path, and K3's
edge batches.

K1 (``csrc/selector_match.cu``) stages a tile of identity rows in
shared memory when a block's tiles fit its budget, and reads each list
entry's word from the row in device memory otherwise; the wrapper takes
that choice from ``selector_match_route``, tested here at its boundary
(on the card, ``chip_smoke.edge_checks10`` holds each launch to the
route its case names), and the tile and budget constants are held to
the kernel source's. The plain versions, which ``chip_smoke`` holds the
kernels against, are held here against the JAX functions: K1 at W 1 /
34 / 300, S 1 / 31 / 33 / 640, CPS 1 / 3 with invalid conjuncts,
conjuncts with req_count 0, forbid-only conjuncts, conjuncts with every
word nonzero, and N 0 / 1 / 129; K3 (``csrc/lpm_wide.cu``) at batch
sizes 0, 1, 3, 5, 1023 and 1025, views one to three elements into a
buffer, both trie layouts and node ids outside [1, M). Inputs are made
from seeds with numpy; outputs are integers, so equality is exact.
"""

from __future__ import annotations

import ipaddress
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cilium_tpu.ops import bitmap as jbitmap
from cilium_tpu.ops import lpm as jlpm
from cilium_tpu_torch.convert import words_i32
from cilium_tpu_torch.ops import bitmap as tbitmap
from cilium_tpu_torch.ops import lpm as tlpm

CSRC = Path(tlpm.__file__).resolve().parent.parent / "csrc"


def _view1(a: np.ndarray, elems_in: int) -> torch.Tensor:
    """``a`` (1-D) as a contiguous view ``elems_in`` elements into a
    larger buffer."""
    buf = np.zeros(a.shape[0] + elems_in + 3, a.dtype)
    buf[elems_in:elems_in + a.shape[0]] = a
    view = torch.from_numpy(buf)[elems_in:elems_in + a.shape[0]]
    assert view.is_contiguous() and torch.equal(view, torch.from_numpy(a))
    return view


# ---------------------------------------------------------------------------
# K1's route and constants
# ---------------------------------------------------------------------------


def _staged_max_w(cps: int) -> int:
    """The widest W whose staged tiles fit SEL_SMEM_BUDGET."""
    w = 1
    while tbitmap.selector_match_smem_bytes(w + 1, cps, True) <= tbitmap.SEL_SMEM_BUDGET:
        w += 1
    return w


@pytest.mark.parametrize("w, cps, route", [
    (1, 1, "staged"), (2, 3, "staged"), (34, 1, "staged"), (34, 3, "staged"),
    (300, 1, "staged"), (300, 3, "staged"), (0, 1, "staged"), (34, 0, "staged"),
    (_staged_max_w(1), 1, "staged"), (_staged_max_w(1) + 2, 1, "wide"),
    (_staged_max_w(3), 3, "staged"), (800, 1, "wide"), (5000, 3, "wide"), (65535, 1, "wide"),
])
def test_selector_match_route(w, cps, route):
    assert tbitmap.selector_match_route(w, cps) == route


@pytest.mark.parametrize("w, cps", [(65536, 1), (34, 1024), (34, -1)])
def test_selector_match_route_refuses_what_an_entry_cannot_pack(w, cps):
    with pytest.raises(ValueError):
        tbitmap.selector_match_route(w, cps)


def test_selector_match_smem_at_the_main_shape():
    """[2048, 34] x [640, 1, 34]: a block stages its whole stream (32 x 34
    words, rounded up to 1 152: one round) and 128 rows of 35 words,
    50 208 bytes: four blocks an SM."""
    assert tbitmap.selector_match_smem_bytes(34, 1, True) == 4 * (7 * 1152 + 8 + 128 * 35)
    assert 4 * tbitmap.selector_match_smem_bytes(34, 1, True) <= 232448
    # past SEL_STAGE_MAX words a block works in rounds of SEL_STAGE_MAX
    assert tbitmap.selector_match_smem_bytes(300, 1, False) \
        == tbitmap.selector_match_smem_bytes(300, 3, False) \
        == 4 * (7 * tbitmap.SEL_STAGE_MAX + 8)


@pytest.mark.parametrize("source, name, value", [
    ("selector_match.cu", "SEL_ROWS", tbitmap.SEL_ROWS),
    ("selector_match.cu", "SEL_WARPS", tbitmap.SEL_WARPS),
    ("selector_match.cu", "SEL_STAGE_MAX", tbitmap.SEL_STAGE_MAX),
    ("selector_match.cu", "SEL_SMEM_BUDGET", tbitmap.SEL_SMEM_BUDGET),
])
def test_route_constants_match_the_kernel_sources(source, name, value):
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m is not None and int(m.group(1)) == value


# ---------------------------------------------------------------------------
# K3: lpm_wide_plain against JAX lpm_lookup_wide
# ---------------------------------------------------------------------------


def _wide_trie(layout: str, seed: int):
    """Flat 16+16 (6 deep /16s) or 16-8-8 (129 deep /16s) arrays, with
    a few node ids outside [1, M) in root_child (and sub_child)."""
    rs = np.random.default_rng(seed)
    prefixes = [("0.0.0.0/0", 1), ("10.0.0.0/8", 2), ("10.1.0.0/16", 3), ("10.1.2.0/24", 4)]
    for j in range(129 if layout == "16-8-8" else 6):
        hi = (100 << 8) | j
        for _ in range(4):
            addr = (hi << 16) | int(rs.integers(0, 1 << 16))
            plen = int(rs.choice([17, 20, 24, 28, 32]))
            prefixes.append((str(ipaddress.ip_network((addr, plen), strict=False)), len(prefixes) + 1))
    ri, rc, sc, si = (np.array(a) for a in tlpm.build_wide_trie(prefixes))
    assert (si.shape[-1] == 65536) == (layout == "flat")
    m = si.shape[0]
    deep = np.nonzero(rc)[0]
    rc[deep[:3]] = [m, m + 3, -1]  # three deep buckets lose their node
    rc[(100 << 8) | 200] = -7
    if layout == "16-8-8":
        live = np.nonzero(sc)
        pick = rs.choice(live[0].shape[0], 6, replace=False)
        sc[live[0][pick], live[1][pick]] = [m, m + 1, m + 9, -1, -2, 0]
    return ri, rc, sc, si


def _wide_addresses(b: int, seed: int) -> np.ndarray:
    """Mostly under the first six deep /16s, a fifth anywhere."""
    rs = np.random.default_rng(seed)
    a = (np.uint32(100) << 24) | (rs.integers(0, 6, b).astype(np.uint32) << 16) \
        | rs.integers(0, 1 << 16, b).astype(np.uint32)
    other = rs.random(b) < 0.2
    a[other] = rs.integers(0, 1 << 32, int(other.sum()), dtype=np.uint64).astype(np.uint32)
    return a


def _jax_wide(arrays, addr):
    return np.asarray(jlpm.lpm_lookup_wide(*(jnp.asarray(x) for x in arrays), jnp.asarray(addr)))


@pytest.mark.parametrize("layout", ["flat", "16-8-8"])
@pytest.mark.parametrize("b", [0, 1, 3, 5, 1023, 1025])
def test_lpm_wide_plain_matches_jax_at_batch_sizes(layout, b):
    """B = 0, one address, and batches ragged against 4 and 256."""
    arrays = _wide_trie(layout, 5)
    addr = _wide_addresses(b, b)
    want = _jax_wide(arrays, addr) if b else np.zeros(0, np.int32)
    tabs = [torch.from_numpy(x) for x in arrays]
    got = tlpm.lpm_lookup_wide(*tabs, torch.from_numpy(addr.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tlpm.lpm_wide_plain(*tabs, torch.from_numpy(addr.view(np.int32))).numpy(), want)
    if b >= 1023:
        assert (got > 4).mean() > 0.1  # deeper than the short prefixes on many addresses


@pytest.mark.parametrize("layout", ["flat", "16-8-8"])
@pytest.mark.parametrize("elems_in", [1, 2, 3])
def test_lpm_wide_plain_matches_jax_on_offset_views(layout, elems_in):
    """Views one to three elements into a buffer (off 16 bytes), over a
    batch ragged against 4 and 256."""
    arrays = _wide_trie(layout, 7)
    addr = _wide_addresses(2051, elems_in)
    view = _view1(addr.view(np.int32), elems_in)
    got = tlpm.lpm_lookup_wide(*(torch.from_numpy(x) for x in arrays), view).numpy()
    np.testing.assert_array_equal(got, _jax_wide(arrays, addr))


@pytest.mark.parametrize("layout", ["flat", "16-8-8"])
def test_lpm_wide_nodes_outside_the_table_are_no_node(layout):
    """An address under a bucket whose node id lies outside [1, M)
    gets the root's value, as in JAX."""
    arrays = _wide_trie(layout, 9)
    ri, rc, _, _ = arrays
    m = arrays[3].shape[0]
    bad = np.nonzero((rc < 0) | (rc >= m))[0]
    assert bad.size >= 4
    addr = ((bad.astype(np.uint64) << 16) | np.arange(bad.size, dtype=np.uint64) * 977).astype(np.uint32)
    got = tlpm.lpm_lookup_wide(*(torch.from_numpy(x) for x in arrays),
                               torch.from_numpy(addr.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, _jax_wide(arrays, addr))
    np.testing.assert_array_equal(got, ri[bad])


# ---------------------------------------------------------------------------
# K1: selector_match_plain against JAX compute_selector_matches
# ---------------------------------------------------------------------------


def _popcount(words: np.ndarray) -> np.ndarray:
    return np.unpackbits(words.astype(np.uint32).view(np.uint8), axis=-1).sum(axis=-1)


def _selector_case(n: int, w: int, s: int, cps: int, seed: int):
    """chip_smoke's K1 edge inputs (identity rows of a few labels;
    conjuncts of one to three of a row's labels, some with a forbidden
    label; invalid, req_count-0, forbid-only, dense and one-off shares)
    as uint32 words."""
    ids, req, forbid, valid, count = chip_smoke.k1_edge_case(np.random.default_rng(seed), n, w, s, cps)
    return ids.view(np.uint32), req.view(np.uint32), forbid.view(np.uint32), valid, count


def _match_both(ids, req, forbid, valid, count):
    n = ids.shape[0]
    want = np.asarray(jbitmap.compute_selector_matches(
        jnp.asarray(ids), jnp.asarray(req), jnp.asarray(forbid), jnp.asarray(valid),
        jnp.asarray(count), row_chunk=64))
    args = (words_i32(ids, "cpu"), words_i32(req, "cpu"), words_i32(forbid, "cpu"),
            torch.from_numpy(valid), torch.from_numpy(count))
    got = tbitmap.compute_selector_matches(*args).numpy().view(np.uint32)
    np.testing.assert_array_equal(tbitmap.selector_match_plain(*args).numpy().view(np.uint32), got)
    return got, want


@pytest.mark.parametrize("cps", [1, 3])
@pytest.mark.parametrize("s", [1, 31, 33, 640])
@pytest.mark.parametrize("w", [1, 34, 300])
def test_selector_match_plain_matches_jax(w, s, cps):
    ids, req, forbid, valid, count = _selector_case(129, w, s, cps, w * 7 + s + cps)
    got, want = _match_both(ids, req, forbid, valid, count)
    np.testing.assert_array_equal(got, want)
    if s >= 31:  # some (row, selector) pairs match, not all
        share = np.unpackbits(want.view(np.uint8), axis=1, bitorder="little")[:, :s].mean()
        assert 0 < share < 1


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("w, s, cps", [(34, 33, 3), (300, 640, 1)])
def test_selector_match_plain_matches_jax_few_rows(n, w, s, cps):
    ids, req, forbid, valid, count = _selector_case(n, w, s, cps, n + w)
    got, want = _match_both(ids, req, forbid, valid, count)
    assert got.shape == (n, (s + 31) // 32)
    np.testing.assert_array_equal(got, want)


def test_selector_match_edge_conjuncts_by_kind():
    """One selector per kind over the same rows: a valid req_count-0
    conjunct with no forbid word matches every row; an invalid one none;
    a forbid-only one exactly the rows without the label; a dense one
    exactly the rows holding every word's bit; a req_count one off none."""
    w, n = 34, 129
    ids, *_ = _selector_case(n, w, 1, 1, 99)
    req = np.zeros((5, 1, w), np.uint32)
    forbid = np.zeros((5, 1, w), np.uint32)
    forbid[2, 0, 3] = 1 << 7
    ids[::2, 3] |= np.uint32(1 << 7)
    req[3, 0] = 1
    req[4, 0, 5] = 3
    count = _popcount(req).astype(np.int32)
    count[4] += 1
    valid = np.array([[True], [False], [True], [True], [True]])
    got, want = _match_both(ids, req, forbid, valid, count)
    np.testing.assert_array_equal(got, want)
    bit = lambda k: (got[:, 0] >> k) & 1  # noqa: E731
    assert bit(0).all() and not bit(1).any() and not bit(4).any()
    np.testing.assert_array_equal(bit(2), ((ids[:, 3] >> 7) & 1) ^ 1)
    np.testing.assert_array_equal(bit(3), (ids & 1).all(axis=1))
    assert bit(3)[0] == 1
