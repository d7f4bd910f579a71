"""Port parity at the layouts that choose K7's and K5's paths.

K7 (``csrc/dfa_walk.cu``) serves its transitions from shared memory for
Q <= ``DFA_SMEM_MAX_Q``, or an interned table's byte classes
(``class_table``) where they fit, and reads a row as 16-byte vectors
when the row stride in bytes and the base pointer are multiples of 16;
the class table must give back every transition. K5 and K11's
stride-8 entry read an address as 16-byte vectors under the same
alignment rule, up to ``LPM_VEC_LEVELS`` levels. The wrappers take those
choices from two plain functions, ``dfa_walk_route`` and
``lpm_stride8_route``, tested here at each boundary (on the card,
``chip_smoke.edge_checks9`` holds each launch to the route its layout
names). The plain versions, which ``chip_smoke`` holds the kernels
against, are held here against the JAX walks at those layouts:
synthetic tables at Q = ``DFA_SMEM_MAX_Q`` and one state past it, row
widths that are not a multiple of 4 or 16, views one row and one
element into a buffer, lengths around every 16-byte chunk's end, K 0,
13 and 16, and bytes outside [0, 255] in the compared and the walked
part of an address. Inputs are made from seeds with numpy.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.ops import dfa as jdfa
from cilium_tpu.ops import lpm as jlpm
from cilium_tpu_torch.ops import dfa as tdfa
from cilium_tpu_torch.ops import lpm as tlpm

CSRC = Path(tdfa.__file__).resolve().parent.parent / "csrc"
FAR = 1 << 24  # a byte value past every table: jnp.take fills
Q_EDGES = (tdfa.DFA_SMEM_MAX_Q, tdfa.DFA_SMEM_MAX_Q + 1)

# (byte dtype, row width, max_len, rows in, elements in)
DFA_LAYOUTS = [
    (np.uint8, 16, 16, 0, 0), (np.uint8, 17, 17, 0, 0), (np.uint8, 20, 17, 0, 0),
    (np.uint8, 16, 16, 1, 0), (np.uint8, 16, 16, 0, 1), (np.uint8, 33, 33, 1, 3),
    (np.int32, 4, 4, 0, 0), (np.int32, 5, 5, 0, 0), (np.int32, 6, 5, 0, 0),
    (np.int32, 8, 8, 1, 0), (np.int32, 8, 8, 0, 1), (np.int32, 13, 11, 2, 1),
]


def _view(a: np.ndarray, rows_in: int, elems_in: int) -> torch.Tensor:
    """``a`` as a contiguous view ``rows_in`` rows and ``elems_in``
    elements into a larger buffer."""
    b, w = a.shape
    buf = np.zeros((rows_in + b + 1) * w + elems_in, a.dtype)
    start = rows_in * w + elems_in
    buf[start:start + b * w] = a.reshape(-1)
    view = torch.from_numpy(buf)[start:start + b * w].view(b, w)
    assert view.is_contiguous() and torch.equal(view, torch.from_numpy(a))
    return view


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _chunk_lengths(rs, b: int, max_len: int, elem_size: int) -> np.ndarray:
    """-1, 0, max_len, past it, and one under, at and one past each
    16-byte chunk's end, then random lengths."""
    ch = 16 // elem_size
    edges = [-1, 0, max_len, max_len + 1, max_len + 9] + [
        c * ch + d for c in range(1, max_len // ch + 1) for d in (-1, 0, 1)]
    lens = np.array(edges, np.int32)[np.arange(b) % len(edges)]
    return np.where(rs.random(b) < 0.5, lens, rs.integers(-1, max_len + 3, b)).astype(np.int32)


# ---------------------------------------------------------------------------
# the route functions
# ---------------------------------------------------------------------------


BIG = tdfa.DFA_SHARED_MIN_ROWS


@pytest.mark.parametrize("q, rows, classes, table", [
    (1, BIG, 0, "shared"), (59, BIG, 0, "shared"), (tdfa.DFA_SMEM_MAX_Q, BIG, 0, "shared"),
    (tdfa.DFA_SMEM_MAX_Q + 1, BIG, 0, "l2"), (735, BIG, 0, "l2"), (0, BIG, 0, "l2"),
    # a [Q + 1, 256] table's copy pays from DFA_SHARED_MIN_ROWS rows, or
    # at any row count up to DFA_SHARED_SMALL_Q states
    (59, BIG - 1, 0, "l2"), (59, 1, 0, "l2"), (59, 4 * BIG, 0, "shared"),
    (tdfa.DFA_SHARED_SMALL_Q, 1, 0, "shared"), (tdfa.DFA_SHARED_SMALL_Q + 1, BIG - 1, 0, "l2"),
    (14, 3621, 0, "shared"), (tdfa.DFA_SHARED_SMALL_Q + 1, BIG, 0, "shared"),
    # a class table's (Q + 1) x C entries against DFA_SMEM_ENTRIES, at any rows
    (59, 1, 24, "classes"), (735, 16384, 48, "classes"), (801, BIG, 128, "classes"),
    (802, BIG, 128, "l2"), (400, 1, 256, "classes"), (401, BIG, 256, "l2"),
    (64, BIG, 264, "shared"), (64, BIG, 1, "shared"), (64, 100, 264, "l2"),
    (20, 100, 264, "shared"),
])
def test_dfa_walk_route_table(q, rows, classes, table):
    assert tdfa.dfa_walk_route(q, rows, 16, 1, 0, classes)[0] == table


@pytest.mark.parametrize("row_stride, elem_size, ptr, route", [
    (16, 1, 0, "vector"), (32, 1, 4096, "vector"), (17, 1, 0, "scalar"), (20, 1, 0, "scalar"),
    (16, 1, 16, "vector"), (16, 1, 1, "scalar"), (16, 1, 8, "scalar"),
    (4, 4, 0, "vector"), (64, 4, 0, "vector"), (256, 4, 1024, "vector"), (5, 4, 0, "scalar"),
    (6, 4, 0, "scalar"), (8, 4, 4, "scalar"), (8, 4, 32, "vector"), (0, 1, 0, "vector"),
])
def test_dfa_walk_route_bytes(row_stride, elem_size, ptr, route):
    assert tdfa.dfa_walk_route(59, BIG, row_stride, elem_size, ptr) == ("shared", route)


@pytest.mark.parametrize("stride, levels, ptr, route", [
    (16, 16, 0, "vector"), (20, 16, 64, "vector"), (17, 16, 0, "scalar"), (5, 4, 0, "scalar"),
    (4, 4, 0, "vector"), (16, 16, 4, "scalar"), (16, 16, 16, "vector"), (32, 17, 0, "scalar"),
    (32, 16, 0, "vector"), (16, 0, 0, "vector"),
] + [
    # row strides of 64, 80, 96 and 128 bytes, base pointers 0, 4, 16
    # and 32 bytes past a 4 096-byte boundary, 8 / 16 / 17 levels
    (stride, levels, 4096 + off, "vector" if levels <= 16 and off % 16 == 0 else "scalar")
    for stride in (16, 20, 24, 32) for off in (0, 4, 16, 32) for levels in (8, 16, 17)
])
def test_lpm_stride8_route(stride, levels, ptr, route):
    assert tlpm.lpm_stride8_route(stride, levels, ptr) == route


def test_route_views_take_the_buffer_offset():
    """A view's data_ptr carries its offset: one row in keeps a 16-byte
    row aligned, one element in never is."""
    a = np.zeros((8, 16), np.uint8)
    for rows_in, elems_in, route in ((0, 0, "vector"), (1, 0, "vector"), (0, 1, "scalar")):
        v = _view(a, rows_in, elems_in)
        base = v.untyped_storage().data_ptr()
        ptr = 64 + (v.data_ptr() - base)  # a 64-byte-aligned allocation
        assert tdfa.dfa_walk_route(59, 8, v.shape[1], v.element_size(), ptr)[1] == route
        w = _view(np.zeros((8, 16), np.int32), rows_in, elems_in)
        wptr = 64 + (w.data_ptr() - w.untyped_storage().data_ptr())
        assert tlpm.lpm_stride8_route(w.shape[1], 16, wptr) == route


@pytest.mark.parametrize("source, name, value", [
    ("dfa_walk.cu", "SMEM_MAX_Q", tdfa.DFA_SMEM_MAX_Q),
    ("lpm_walk.cuh", "LPM_VEC_LEVELS", tlpm.LPM_VEC_LEVELS),
])
def test_route_constants_match_the_kernel_sources(source, name, value):
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m is not None and int(m.group(1)) == value


# ---------------------------------------------------------------------------
# K7's byte classes
# ---------------------------------------------------------------------------


def _cap_policy_dfas():
    """The field automata of a three-field HTTP policy at the pattern
    cap (7 methods, 63 path patterns, 3 hosts: chip_smoke's
    cap_policy_rules less its demoted pattern), fused as the L7 pipeline
    fuses them."""
    from cilium_tpu_torch.l7.regex_compile import compile_patterns

    methods = ["GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS"]
    hosts = ["api[.]example[.]com", "[a-z]+[.]internal", "svc[0-9]+[.]local"]
    paths = [f"/api/v{i % 8}/r{i}/[a-z0-9]*" for i in range(40)] + [f"/svc{i}/.*" for i in range(23)]
    return [compile_patterns(x) for x in (methods, paths, hosts)]


def _corpus_tables():
    """Fused tables of the random automata tests/test_torch_dfa.py walks
    (its patterns' atoms) and the pattern-cap policy's."""
    import random

    from cilium_tpu_torch.l7.regex_compile import compile_patterns

    atoms = ["a", "b", "0", "/", "[a-z]", "[0-9]", ".", "x+", "b*", "(ab|ba)", "c?", "[^a]"]
    out = []
    for seed in range(4):
        rng = random.Random(seed)
        sets = []
        for _ in range(3):
            pats = []
            while len(pats) < rng.randrange(2, 10):
                pat = "".join(rng.choice(atoms) for _ in range(rng.randrange(1, 6)))
                try:
                    re.compile(pat)
                except re.error:
                    continue
                pats.append(pat)
            sets.append(compile_patterns(pats))
        out.append((f"random {seed}", tdfa.fuse_dfas(sets).trans))
    out.append(("pattern cap", tdfa.fuse_dfas(_cap_policy_dfas()).trans))
    return out


@pytest.mark.parametrize("name, trans", _corpus_tables(), ids=lambda x: x if isinstance(x, str) else "")
def test_class_table_gives_back_trans(name, trans):
    """Every transition through the class map and the class table is
    the table's own; the sink row, the columns past the classes and the
    padding all lead to Q; the width is a multiple of DFA_CLASS_PAD."""
    q = trans.shape[0]
    byte_class, ct = tdfa.byte_classes(trans)
    np.testing.assert_array_equal(ct[:, byte_class], trans)
    assert ct.shape[1] == len(np.unique(trans.T, axis=0))
    packed = tdfa.class_table(trans)
    assert packed is not None
    cmap, table = packed
    np.testing.assert_array_equal(cmap, byte_class)
    u16 = table.view(np.uint16)
    assert u16.shape[0] == q + 1 and u16.shape[1] % tdfa.DFA_CLASS_PAD == 0
    assert u16.shape[1] > ct.shape[1] and (q + 1) * u16.shape[1] <= tdfa.DFA_SMEM_ENTRIES
    np.testing.assert_array_equal(u16[:q][:, cmap].astype(np.int32), trans)
    assert (u16[q] == q).all() and (u16[:, ct.shape[1]:] == q).all()
    if name == "pattern cap":
        assert q == 735 and ct.shape[1] == 43


def test_class_table_maps_out_of_range_entries_to_the_sink():
    rs = np.random.default_rng(3)
    trans = rs.integers(0, 50, (50, 256)).astype(np.int32)
    trans[:, 128:] = trans[:, :128]
    trans[3, 7] = -1
    trans[4, 9] = 50
    cmap, table = tdfa.class_table(trans)
    u16 = table.view(np.uint16).astype(np.int32)
    assert u16[3, cmap[7]] == 50 and u16[4, cmap[9]] == 50
    ok = (trans >= 0) & (trans < 50)
    np.testing.assert_array_equal(u16[:50][:, cmap][ok], trans[ok])


@pytest.mark.parametrize("q, n_cols, fits", [
    (801, 127, True), (802, 127, False), (400, 255, True), (401, 255, False), (30, 256, False),
])
def test_class_table_budget(q, n_cols, fits):
    """None past the shared-memory entries, and where the class table
    would be wider than the table itself (256 classes and the sink's
    column)."""
    rs = np.random.default_rng(q + n_cols)
    base = rs.integers(0, q, (q, n_cols)).astype(np.int32)
    trans = base[:, np.arange(256) % n_cols]
    assert (tdfa.class_table(trans) is not None) == fits


def test_interned_table_builds_its_classes_once(monkeypatch):
    calls = []
    real = tdfa.class_table

    def counting(trans):
        calls.append(trans.shape)
        return real(trans)

    monkeypatch.setattr(tdfa, "class_table", counting)
    tdfa._reset_intern_for_tests()
    try:
        build = lambda: tdfa.fuse_dfas(_cap_policy_dfas())  # noqa: E731
        a = tdfa.intern_fused_table(("cap",), build, device="cpu")
        for _ in range(3):
            assert tdfa.intern_fused_table(("cap",), build, device="cpu") is a
    finally:
        tdfa._reset_intern_for_tests()
    assert calls == [(735, 256)]
    assert a.class_trans.shape == (736, 48) and a.class_trans.dtype == torch.int16
    assert a.byte_class.dtype == torch.uint8 and a.class_bytes == 256 + 736 * 48 * 2
    # the reference's ledger is unchanged by the class table
    assert a.device_bytes == sum(t.numel() * 4 for t in (a.trans, a.accept_lo, a.accept_hi))


@pytest.mark.parametrize("rows_in, elems_in", [(0, 0), (1, 0), (0, 1)])
def test_class_walk_matches_jax(rows_in, elems_in):
    """dfa_match_batch_classes (on the CPU its plain version walks
    trans) against the JAX fused walk on the pattern-cap table, and the
    wrapper refuses class tensors of the wrong shape or type."""
    from cilium_tpu_torch.l7.regex_compile import compile_patterns  # noqa: F401

    fused = tdfa.fuse_dfas(_cap_policy_dfas())
    tab = tdfa.DeviceDFATable(("cap",), fused, "cpu")
    rs = np.random.default_rng(rows_in * 2 + elems_in)
    b, max_len = 900, 48
    alphabet = np.frombuffer(b"/apivsc0123456789rGETPOSxyz.", np.uint8)
    sb = rs.choice(alphabet, (b, max_len)).astype(np.uint8)
    sb[:, :5] = np.frombuffer(b"/api/", np.uint8)
    lens = _chunk_lengths(rs, b, max_len, 1)
    starts = rs.choice(fused.starts, b).astype(np.int32)
    jlo, jhi = jdfa.dfa_match_batch_fused(
        jnp.asarray(fused.trans),
        jnp.asarray((fused.accept & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((fused.accept >> np.uint64(32)).astype(np.uint32)), jnp.asarray(starts),
        jnp.asarray(sb), jnp.asarray(lens), max_len)
    rest = (tab.accept_lo, tab.accept_hi, torch.from_numpy(starts), _view(sb, rows_in, elems_in),
            torch.from_numpy(lens), max_len)
    tlo, thi = tdfa.dfa_match_batch_classes(tab.trans, tab.byte_class, tab.class_trans, *rest)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))
    for bad in ((tab.byte_class[:255], tab.class_trans), (tab.byte_class, tab.class_trans[:-1]),
                (tab.byte_class.to(torch.int32), tab.class_trans),
                (tab.byte_class, tab.class_trans.to(torch.int32))):
        with pytest.raises(ValueError):
            tdfa.dfa_match_batch_classes(tab.trans, *bad, *rest)


# ---------------------------------------------------------------------------
# K7's plain version against the JAX walks
# ---------------------------------------------------------------------------


def _synthetic_table(rs, q: int):
    trans = rs.integers(0, q, (q, 256)).astype(np.int32)
    accept = rs.integers(0, 1 << 63, q, dtype=np.uint64)
    return trans, accept


@pytest.mark.parametrize("q", Q_EDGES)
@pytest.mark.parametrize("layout", DFA_LAYOUTS, ids=lambda l: f"{np.dtype(l[0]).name}-w{l[1]}-"
                         f"m{l[2]}-r{l[3]}-e{l[4]}")
def test_fused_walk_matches_jax_at_layouts(q, layout):
    """dfa_match_batch_fused (the wrapper, on its plain version) against
    the JAX walk on a synthetic Q-state table, at the layout's width,
    max_len and offset."""
    dtype, width, max_len, rows_in, elems_in = layout
    rs = np.random.default_rng(q * 31 + width * 7 + rows_in + elems_in)
    trans, accept = _synthetic_table(rs, q)
    b = 700
    sb = rs.integers(0, 256, (b, width)).astype(dtype)
    lens = _chunk_lengths(rs, b, max_len, np.dtype(dtype).itemsize)
    starts = rs.integers(0, q, b).astype(np.int32)
    jlo, jhi = jdfa.dfa_match_batch_fused(
        jnp.asarray(trans), jnp.asarray((accept & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((accept >> np.uint64(32)).astype(np.uint32)), jnp.asarray(starts),
        jnp.asarray(sb), jnp.asarray(lens), max_len)
    lo, hi = tdfa.accept_words(accept)
    args = (torch.from_numpy(trans), torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(starts), _view(sb, rows_in, elems_in), torch.from_numpy(lens),
            max_len)
    tlo, thi = tdfa.dfa_match_batch_fused(*args)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))
    plo, phi = tdfa.dfa_walk_plain(*args)
    assert torch.equal(plo, tlo) and torch.equal(phi, thi)
    assert np.asarray(jlo).any()


@pytest.mark.parametrize("q", Q_EDGES)
@pytest.mark.parametrize("width, max_len, rows_in, elems_in", [
    (64, 64, 0, 0), (5, 5, 0, 0), (6, 5, 1, 0), (8, 8, 0, 1), (17, 13, 1, 1),
])
def test_single_walk_matches_jax_at_layouts(q, width, max_len, rows_in, elems_in):
    """dfa_match_batch (one scalar start, int32 bytes) against the JAX
    walk at widths that are and are not a multiple of 4 elements, and
    offset views."""
    rs = np.random.default_rng(q + width * 13 + elems_in)
    trans, accept = _synthetic_table(rs, q)
    b = 600
    sb = rs.integers(0, 256, (b, width)).astype(np.int32)
    lens = _chunk_lengths(rs, b, max_len, 4)
    start = int(rs.integers(0, q))
    jlo, jhi = jdfa.dfa_match_batch(
        jnp.asarray(trans), jnp.asarray((accept & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((accept >> np.uint64(32)).astype(np.uint32)), jnp.int32(start),
        jnp.asarray(sb), jnp.asarray(lens), max_len)
    lo, hi = tdfa.accept_words(accept)
    tlo, thi = tdfa.dfa_match_batch(
        torch.from_numpy(trans), torch.from_numpy(lo), torch.from_numpy(hi),
        torch.tensor(start, dtype=torch.int32), _view(sb, rows_in, elems_in),
        torch.from_numpy(lens), max_len)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))


@pytest.mark.parametrize("q", Q_EDGES)
def test_out_of_range_transitions_end_the_walk(q):
    """Entries outside [0, Q) (the kernel's shared table stores them as
    its DEAD sentinel) end the walk with mask 0 in the plain version,
    and a walk that never meets one equals the JAX walk."""
    rs = np.random.default_rng(q)
    trans, accept = _synthetic_table(rs, q)
    bad = rs.random(trans.shape) < 0.01
    broken = np.where(bad, rs.choice(np.array([-1, q, 65535, 65539], np.int32), trans.shape),
                      trans).astype(np.int32)
    b, max_len = 800, 12
    sb = rs.integers(0, 256, (b, max_len)).astype(np.uint8)
    lens = rs.integers(-1, max_len + 2, b).astype(np.int32)
    starts = rs.integers(0, q, b).astype(np.int32)
    lo, hi = tdfa.accept_words(accept)
    acc = (torch.from_numpy(lo), torch.from_numpy(hi))
    rest = (torch.from_numpy(starts), torch.from_numpy(sb), torch.from_numpy(lens), max_len)
    got_lo, _ = tdfa.dfa_walk_plain(torch.from_numpy(broken), *acc, *rest)
    want_lo, _ = tdfa.dfa_walk_plain(torch.from_numpy(trans), *acc, *rest)
    # rows whose walk meets no broken entry agree with the intact table
    state = starts.astype(np.int64)
    hits_bad = lens < 0
    for lvl in range(max_len):
        step = (lvl < np.minimum(lens, max_len)) & ~hits_bad
        idx = state * 256 + sb[:, lvl]
        hits_bad |= step & bad.reshape(-1)[idx]
        state = np.where(step, trans.reshape(-1)[idx], state)
    ok = ~hits_bad
    assert ok.any() and (~ok & (lens >= 0)).any()
    np.testing.assert_array_equal(got_lo.numpy()[ok], want_lo.numpy()[ok])
    assert not got_lo.numpy()[~ok & (lens >= 0)].any()


# ---------------------------------------------------------------------------
# K5's plain version against the JAX walk
# ---------------------------------------------------------------------------


def _identity_trie():
    """An elided trie of fd00::{hi}:{lo}/128 entries (K 13) and the
    same with 2000::/3 (K 0)."""
    ident = [(f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128", i + 1) for i in range(600)]
    return tlpm.build_trie_elided(ident), tlpm.build_trie_elided(ident + [("2000::/3", 999)])


def _v6_addresses(rs, b: int, width: int) -> np.ndarray:
    a = np.zeros((b, width), np.int32)
    a[:, 0] = 0xFD
    a[:, 13] = rs.integers(0, 3, b)
    a[:, 15] = rs.integers(0, 256, b)
    world = rs.random(b) < 0.1
    a[world, :16] = rs.integers(0, 256, (int(world.sum()), 16))
    a[world, :4] = (0x20, 0x01, 0x0D, 0xB8)
    a[:, 16:] = rs.integers(-5, 300, (b, width - 16))  # never read
    return a


def _jax_elided(child, info, common, addr, levels):
    return np.asarray(jpipe._elided_lpm(jnp.asarray(child), jnp.asarray(info),
                                        jnp.asarray(common), jnp.asarray(addr), levels))


@pytest.mark.parametrize("elided", [True, False], ids=["K13", "K0"])
@pytest.mark.parametrize("width, rows_in, elems_in", [
    (16, 0, 0), (20, 0, 0), (17, 0, 0), (16, 1, 0), (16, 0, 1), (17, 2, 3),
])
def test_elided_lpm_matches_jax_at_layouts(elided, width, rows_in, elems_in):
    """elided_lookup (the wrapper, on its plain version) against JAX's
    _elided_lpm at strides 16 and 20 (the vector route on the card), 17
    and offset views (the scalar route)."""
    (child, info, common) = _identity_trie()[0 if elided else 1]
    assert (common.shape[0] == 13) == elided
    rs = np.random.default_rng(width * 3 + rows_in + elems_in + elided)
    addr = _v6_addresses(rs, 3000, width)
    want = _jax_elided(child, info, common, addr, 16)
    tabs = [torch.from_numpy(x) for x in (child, info, common)]
    got = tlpm.elided_lookup(*tabs, _view(addr, rows_in, elems_in), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.5


@pytest.mark.parametrize("width, levels, elems_in", [(4, 4, 0), (5, 4, 0), (5, 4, 1)])
def test_lpm_lookup_matches_jax_at_v4_layouts(width, levels, elems_in):
    """The 4-level classic layout at strides 4 (vector on the card) and
    5, and an offset view (scalar)."""
    rs = np.random.default_rng(width + elems_in)
    prefixes = [("0.0.0.0/0", 1)] + [
        (f"10.{j % 256}.{(j * 7) % 256}.0/{int(rs.choice([16, 24, 28, 32]))}", j + 2)
        for j in range(400)]
    child, info = tlpm.build_trie(prefixes)
    addr = np.zeros((2000, width), np.int32)
    addr[:, 0] = 10
    addr[:, 1:4] = rs.integers(0, 256, (2000, 3))
    addr[:, 4:] = -9  # never read
    want = np.asarray(jlpm.lpm_lookup(jnp.asarray(child), jnp.asarray(info),
                                      jnp.asarray(addr[:, :levels]), levels=levels))
    got = tlpm.lpm_lookup(torch.from_numpy(child), torch.from_numpy(info),
                          _view(addr, 0, elems_in), levels=levels).numpy()
    np.testing.assert_array_equal(got, want)


def test_k16_compares_every_byte_and_walks_none():
    """K = 16 = levels: the compare covers the whole address and no
    level is walked, so every address maps to 0, as in JAX."""
    child, info, _ = _identity_trie()[0]
    rs = np.random.default_rng(16)
    addr = _v6_addresses(rs, 500, 16)
    common = addr[7, :16].copy()
    want = _jax_elided(child, info, common, addr, 16)
    got = tlpm.elided_lookup(*[torch.from_numpy(x) for x in (child, info, common)],
                             torch.from_numpy(addr), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()


@pytest.mark.parametrize("part", ["compared", "walked"])
def test_out_of_range_bytes_by_part(part):
    """Bytes outside [0, 255] in the K compared bytes make the address
    match nothing, as in JAX; in the walked bytes they end the walk,
    which is JAX's result with each such byte moved to FAR (the named
    divergence of tests/test_torch_lpm6.py)."""
    child, info, common = _identity_trie()[0]
    k = common.shape[0]
    rs = np.random.default_rng(7 if part == "compared" else 8)
    addr = _v6_addresses(rs, 3000, 16)
    bad = rs.random(addr.shape) < 0.03
    if part == "compared":
        bad[:, k:] = False
    else:
        bad[:, :k] = False
    vals = rs.choice(np.array([-1, -7, 256, 300, 1 << 20, -(1 << 20)], np.int32), addr.shape)
    raw = np.where(bad, vals, addr).astype(np.int32)
    far = np.where(bad, FAR, addr).astype(np.int32) if part == "walked" else raw
    want = _jax_elided(child, info, common, far, 16)
    tabs = [torch.from_numpy(x) for x in (child, info, common)]
    for rows_in, elems_in in ((0, 0), (0, 1)):
        got = tlpm.elided_lookup(*tabs, _view(raw, rows_in, elems_in), 16).numpy()
        np.testing.assert_array_equal(got, want)
    assert bad.any(axis=1).sum() > 100
