"""Port parity of the L7 walk of a table with a pair table: K8's pair
walk and K7's class route, and of the pair-class form both were
measured against.

The L7 walk (``ops/dfa.py l7_walk_route``) takes a table's pair table
(K8 ``dfa_pair_walk``) for rows under 16 bytes, and its byte classes
(``class_table``: a [256] class map and a uint16 [Q + 1, C] class table
with a sink row and column) on K7's class route from there, walked from
shared memory. ``tools/k8_probe.py`` timed both
against a walk over the pair table's own classes (its
``pair_class_table``: a [256] first-position and a [257]
second-position class map and a uint16 [Q + 1, C0, C1] table,
``tools/k8_pair_classes.cu``), which was slower.

Here the class table's two steps are held against the pair table entry
by entry (sink included), and walked two steps a pair on the host
against the JAX pair walk; the probe's pair-class table likewise, for
fused tables of random automata and for pair tables ``_pair_table`` did
not build, and its budget; the route functions at their boundaries; the
kernel's constants against its source; the pair walk and K7's class
walk (on the CPU, their plain versions) against the JAX pair walk at odd
and even ``max_len`` on uint8 and int32 bytes, with the reference fault
of queue C (a byte past an odd ``max_len``) named and excluded as
``tests/test_torch_dfa.py::test_pair_walk_reference_fault_past_odd_max_len``
does; and ``L7Pipeline`` on both routes. Inputs are made from seeds with
numpy and ``random``.
"""

from __future__ import annotations

import importlib.util
import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.l7 import regex_compile as jrc
from cilium_tpu.ops import dfa as jdfa
from cilium_tpu_torch.convert import dfa_table_from_numpy
from cilium_tpu_torch.datapath import l7_pipeline as tl7rt
from cilium_tpu_torch.l7 import regex_compile as trc
from cilium_tpu_torch.ops import dfa as tdfa

CSRC = Path(tdfa.__file__).resolve().parent.parent / "csrc"
TOOLS = Path(__file__).resolve().parent.parent / "tools"
ATOMS = ["a", "b", "0", "/", "[a-z]", "[0-9]", ".", "x+", "b*", "(ab|ba)", "c?", "[^a]"]
ALPHA, PAD = tdfa.PAIR_ALPHA, tdfa.PAIR_PAD


def _probe():
    """tools/k8_probe.py as a module (its pair_class_table)."""
    spec = importlib.util.spec_from_file_location("k8_probe", TOOLS / "k8_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _probe()


@pytest.fixture(autouse=True)
def _reset():
    tdfa._reset_intern_for_tests()
    tl7rt._reset_for_tests()
    yield
    tdfa._reset_intern_for_tests()
    tl7rt._reset_for_tests()


def _patterns(rng: random.Random, n: int):
    out = []
    while len(out) < n:
        pat = "".join(rng.choice(ATOMS) for _ in range(rng.randrange(1, 6)))
        try:
            re.compile(pat)
        except re.error:
            continue
        out.append(pat)
    return out


def _fused_pair(seed: int, n_fields: int = 2):
    """The same fused table of random automata in both packages."""
    rng = random.Random(seed)
    sets = [_patterns(rng, rng.randrange(2, 6)) for _ in range(n_fields)]
    return (jdfa.fuse_dfas([jrc.compile_patterns(p) for p in sets]),
            tdfa.fuse_dfas([trc.compile_patterns(p) for p in sets]))


def _hand_made(rs, q: int, n0: int, n1: int, bad: float = 0.0) -> np.ndarray:
    """A [Q, 257 * 257] pair table _pair_table did not build: a random
    [Q, n0, n1] table through random class maps of both positions (the
    first position's pad row included), a share ``bad`` of its entries
    outside [0, Q)."""
    small = rs.integers(0, q, (q, n0, n1)).astype(np.int32)
    hit = rs.random(small.shape) < bad
    small[hit] = rs.choice(np.array([-1, q, q + 5, 65535, 1 << 20], np.int32), int(hit.sum()))
    m0 = rs.permutation(np.arange(ALPHA) % n0)
    m1 = rs.permutation(np.arange(ALPHA) % n1)
    return np.ascontiguousarray(small[:, m0][:, :, m1].reshape(q, ALPHA * ALPHA))


def _assert_form_equals(pair: np.ndarray, form) -> None:
    """Entry by entry: every (state, byte, byte or pad) of the pair table
    through the class maps, the sink for entries outside [0, Q), all of
    row Q and the reserved classes."""
    q = pair.shape[0]
    m0, m1, table = form
    assert m0.shape == (256,) and m1.shape == (ALPHA,)
    assert m0.dtype == np.uint8 and m1.dtype == np.uint8 and table.dtype == np.int16
    u = table.view(np.uint16).astype(np.int64)
    c0, c1 = u.shape[1:]
    assert u.shape[0] == q + 1
    assert c0 % tdfa.DFA_CLASS_PAD == 0 and c1 % tdfa.DFA_CLASS_PAD == 0
    assert int(m0.max()) < c0 - 1 and int(m1.max()) < c1 - 1  # the last class is reserved
    p = pair.reshape(q, ALPHA, ALPHA)[:, :256, :].astype(np.int64)
    want = np.where((p >= 0) & (p < q), p, q)
    np.testing.assert_array_equal(u[:q][:, m0][:, :, m1], want)
    assert (u[q] == q).all() and (u[:, c0 - 1, :] == q).all() and (u[:, :, c1 - 1] == q).all()
    assert (u[:, int(m0.max()) + 1:, :] == q).all() and (u[:, :, int(m1.max()) + 1:] == q).all()


# ---------------------------------------------------------------------------
# the probe's pair-class table (tools/k8_probe.py pair_class_table)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_pair_class_table_equals_fused_pair_tables(seed):
    _, tf = _fused_pair(300 + seed, n_fields=1 + seed % 3)
    form = PROBE.pair_class_table(tf.pair)
    assert form is not None
    _assert_form_equals(tf.pair, form)
    # the classes are exact: one slice a class on each axis
    q = tf.pair.shape[0]
    p = tf.pair.reshape(q, ALPHA, ALPHA)[:, :256, :]
    n0 = len(np.unique(p.transpose(1, 0, 2).reshape(256, -1), axis=0))
    n1 = len(np.unique(p.transpose(2, 0, 1).reshape(ALPHA, -1), axis=0))
    assert (int(form[0].max()) + 1, int(form[1].max()) + 1) == (n0, n1)


def test_pair_class_table_of_the_bench_corpus():
    """The bench's 16 path patterns: Q 59, 18 x 19 classes, a [60, 24,
    24] table of 69 120 bytes in place of 15.6 MB."""
    paths = [f"/api/v{i}/[a-z0-9]*" for i in range(8)] + [f"/svc{i}/.*" for i in range(8)]
    f = tdfa.fuse_dfas([trc.compile_patterns(paths)])
    m0, m1, table = PROBE.pair_class_table(f.pair)
    _assert_form_equals(f.pair, (m0, m1, table))
    assert table.shape == (60, 24, 24) and table.nbytes == 69_120 and f.pair.nbytes == 15_587_564
    assert (int(m0.max()) + 1, int(m1.max()) + 1) == (18, 19)


@pytest.mark.parametrize("q, n0, n1, bad", [(40, 9, 11, 0.0), (40, 9, 11, 0.02), (3, 2, 2, 0.1),
                                            (1, 1, 1, 0.0), (70, 30, 5, 0.01)])
def test_pair_class_table_equals_a_hand_made_pair_table(q, n0, n1, bad):
    rs = np.random.default_rng(q * 7 + n0 + n1)
    pair = _hand_made(rs, q, n0, n1, bad)
    form = PROBE.pair_class_table(pair)
    assert form is not None
    _assert_form_equals(pair, form)


@pytest.mark.parametrize("q, n0, n1, fits", [
    (5, 127, 127, True),    # (Q + 1) x 128 x 128 = 98 304 entries
    (6, 127, 127, False),   # 114 688
    (5, 128, 127, False),   # C0 136: 104 448
    (3, 256, 8, False),     # C0 264: past 256 classes
    (3, 8, 257, False),     # C1 264
    (3, 8, 247, True),      # C1 248: 4 x 16 x 248 = 15 872
])
def test_pair_class_table_budget(q, n0, n1, fits):
    """None past DFA_SMEM_ENTRIES and where an axis needs more than 256
    classes (its classes and the reserved one)."""
    rs = np.random.default_rng(q + n0 * 3 + n1)
    small = rs.integers(0, q, (q, n0, n1)).astype(np.int32)
    m0 = np.concatenate([rs.permutation(np.arange(256) % n0), [0]])
    m1 = rs.permutation(np.arange(ALPHA) % n1)
    pair = np.ascontiguousarray(small[:, m0][:, :, m1].reshape(q, -1))
    form = PROBE.pair_class_table(pair)
    assert (form is not None) == fits
    if form is not None:
        assert (int(form[0].max()) + 1, int(form[1].max()) + 1) == (n0, n1)
        _assert_form_equals(pair, form)


def test_pair_class_table_none_past_the_budget_at_q126():
    """A Q 126 table over 40 distinct columns: 40 x 41 classes, (Q + 1)
    x 48 x 48 entries past the budget (a table of
    chip_smoke.edge_checks11)."""
    rs = np.random.default_rng(126)
    base = rs.integers(0, 126, (126, 40)).astype(np.int32)
    trans = base[:, rs.permutation(np.arange(256) % 40)]
    assert PROBE.pair_class_table(tdfa._pair_table(trans)) is None


# ---------------------------------------------------------------------------
# K7's class route on a pair table's single-step table, two steps a pair
# ---------------------------------------------------------------------------


def _assert_two_steps_give_back(pair: np.ndarray, trans: np.ndarray) -> None:
    """K7's class route on ``class_table(trans)``: for every state s,
    byte a and byte b, two steps ``ct[ct[s, class[a]], class[b]]`` are
    ``pair[s, a * 257 + b]`` and one step ``ct[s, class[a]]`` is the half
    pair ``pair[s, a * 257 + pad]``; the sink row and the last column
    (a byte outside [0, 255]) lead only to the sink."""
    q = pair.shape[0]
    bc, table = tdfa.class_table(trans)
    ct = table.view(np.uint16).astype(np.int64)
    p = pair.reshape(q, ALPHA, ALPHA)
    one = ct[:q][:, bc]  # [Q, 256]
    np.testing.assert_array_equal(one, p[:, :256, PAD])
    np.testing.assert_array_equal(ct[one][:, :, bc], p[:, :256, :256])
    assert (ct[q] == q).all() and (ct[:, -1] == q).all()


@pytest.mark.parametrize("seed", range(5))
def test_class_table_two_steps_give_back_fused_pair_tables(seed):
    _, tf = _fused_pair(500 + seed, n_fields=1 + seed % 3)
    _assert_two_steps_give_back(tf.pair, tf.trans)


def test_class_table_two_steps_give_back_the_bench_corpus_pair_table():
    """The bench's 16 path patterns: Q 59 over 18 byte classes, a
    [60, 24] class table of 2 880 bytes where the pair table holds
    15.6 MB and the pair-class table 69 120."""
    paths = [f"/api/v{i}/[a-z0-9]*" for i in range(8)] + [f"/svc{i}/.*" for i in range(8)]
    f = tdfa.fuse_dfas([trc.compile_patterns(paths)])
    _assert_two_steps_give_back(f.pair, f.trans)
    bc, table = tdfa.class_table(f.trans)
    assert table.shape == (60, 24) and table.nbytes == 2_880 and int(bc.max()) + 1 == 18


@pytest.mark.parametrize("n_cols, fits", [(40, True), (255, True), (256, False)])
def test_class_route_fits_at_q126(n_cols, fits):
    """A Q 126 table (the largest with a pair table) over n_cols distinct
    columns: its class table fits unless it needs 256 classes and the
    sink's column (chip_smoke.edge_checks11's table without classes)."""
    rs = np.random.default_rng(n_cols)
    base = rs.integers(0, 126, (126, n_cols)).astype(np.int32)
    trans = np.ascontiguousarray(base[:, rs.permutation(np.arange(256) % n_cols)])
    assert 126 * ALPHA * ALPHA <= tdfa.PAIR_TABLE_CAP_ELEMS
    cls = tdfa.class_table(trans)
    assert (cls is not None) == fits
    if cls is not None:
        assert tdfa.dfa_walk_route(126, 4096, 16, 1, 0, cls[1].shape[1])[0] == "classes"
        _assert_two_steps_give_back(tdfa._pair_table(trans), trans)


def test_class_forms_of_a_jax_table_carried_across():
    """A JAX table's numpy arrays through convert.dfa_table_from_numpy
    give the class form built from the port's own fused table."""
    jf, tf = _fused_pair(320)
    jt = jdfa.DeviceDFATable(("rt",), jf)
    accept = (np.asarray(jt.accept_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        jt.accept_lo).astype(np.uint64)
    got = dfa_table_from_numpy(np.asarray(jt.trans), accept, jt.starts_host, np.asarray(jt.pair),
                               "cpu")
    want = tdfa.DeviceDFATable(("rt",), tf, "cpu")
    assert got.has_pair and got.class_trans is not None
    assert torch.equal(got.byte_class, want.byte_class)
    assert torch.equal(got.class_trans, want.class_trans)


# ---------------------------------------------------------------------------
# the routes and the kernel's constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung", [3, 4, 8, 15, 16, 17, 32, 64, 128, 256])
@pytest.mark.parametrize("has_pair, has_classes, short, long", [
    (True, True, "pair", "classes"), (True, False, "pair", "pair"),
    (False, True, "classes", "classes"), (False, False, "fused", "fused"),
])
def test_l7_walk_route(has_pair, has_classes, short, long, rung):
    """A pair table under 16 bytes a row, the byte classes from there;
    a table without classes keeps its pair table at every rung."""
    assert tdfa.PAIR_WALK_BELOW_RUNG == tdfa.L7_LEN_LADDER[0] == 16
    assert tdfa.l7_walk_route(has_pair, has_classes, rung) == (short if rung < 16 else long)


@pytest.mark.parametrize("row_stride, elem_size, ptr, route", [
    (16, 1, 0, "vector"), (256, 1, 4096, "vector"), (3, 1, 0, "scalar"), (17, 1, 0, "scalar"),
    (16, 1, 1, "scalar"), (16, 1, 8, "scalar"), (4, 4, 0, "vector"), (7, 4, 0, "scalar"),
    (8, 4, 4, "scalar"), (20, 4, 32, "vector"), (0, 1, 0, "vector"),
])
def test_dfa_pair_walk_route_bytes(row_stride, elem_size, ptr, route):
    """K7's 16-byte rule."""
    assert tdfa.dfa_pair_walk_route(row_stride, elem_size, ptr) == route
    for c in (24, 0):
        assert tdfa.dfa_walk_route(59, 100, row_stride, elem_size, ptr, c)[1] == route


@pytest.mark.parametrize("name, value", [
    ("PAIR_ALPHA", tdfa.PAIR_ALPHA), ("PAIR_PAD", tdfa.PAIR_PAD),
])
def test_pair_walk_constants_match_the_kernel_source(name, value):
    text = (CSRC / "dfa_pair_walk.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m is not None and int(m.group(1)) == value


# ---------------------------------------------------------------------------
# the walks against the JAX walk
# ---------------------------------------------------------------------------


def _jax_accept(accept):
    return (jnp.asarray((accept & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((accept >> np.uint64(32)).astype(np.uint32)))


def _classes(tab):
    return tab.byte_class, tab.class_trans


def _batch(tf, max_len: int, dtype):
    """600 rows of a seeded batch, every length <= max_len (an odd cap
    ends on a half pair), a wider batch than max_len, starts of every
    field."""
    rs = np.random.default_rng(max_len)
    b, width = 600, max_len + 3
    sb = rs.choice(np.frombuffer(b"ab0/xcyz\x00", np.uint8), (b, width)).astype(dtype)
    lens = np.where(rs.random(b) < 0.5, rs.integers(-1, min(max_len, 4) + 1, b),
                    rs.integers(-1, max_len + 1, b)).astype(np.int32)
    starts = rs.choice(tf.starts, b).astype(np.int32)
    return sb, lens, starts


def _jax_pair(jf, sb, lens, starts, max_len):
    jlo, jhi = jdfa.dfa_match_batch_pair(
        jnp.asarray(jf.pair), *_jax_accept(jf.accept), jnp.asarray(starts), jnp.asarray(sb),
        jnp.asarray(lens), max_len)
    return np.asarray(jlo), np.asarray(jhi)


MAX_LENS = [0, 1, 2, 3, 16, 17, 31, 64, 127, 128]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32], ids=["u8", "i32"])
@pytest.mark.parametrize("max_len", MAX_LENS)
def test_pair_walk_with_classes_matches_jax(max_len, dtype):
    """K7's class walk of a pair table's single-step table and its class
    form (dfa_match_batch_classes), and the pair walk
    (dfa_match_batch_pair), on the CPU their plain versions, against the
    JAX pair walk, bit for bit."""
    jf, tf = _fused_pair(400 + max_len, n_fields=3)
    tab = tdfa.DeviceDFATable(("w", max_len), tf, "cpu")
    assert tab.has_pair and tab.class_trans is not None
    sb, lens, starts = _batch(tf, max_len, dtype)
    jlo, jhi = _jax_pair(jf, sb, lens, starts, max_len)
    args = (tab.accept_lo, tab.accept_hi, torch.from_numpy(starts), torch.from_numpy(sb),
            torch.from_numpy(lens), max_len)
    for tlo, thi in (tdfa.dfa_match_batch_classes(tab.trans, *_classes(tab), *args),
                     tdfa.dfa_match_batch_pair(tab.pair, *args)):
        np.testing.assert_array_equal(tlo.numpy().view(np.uint32), jlo)
        np.testing.assert_array_equal(thi.numpy().view(np.uint32), jhi)
    assert max_len == 0 or jlo.any() or jhi.any()


def _class_form_walk(tab, sb, lens, starts, max_len):
    """K7's class route on the host, as the kernel walks it: the class
    table (int16 bit views of uint16 states, clamped to the sink Q) two
    steps a pair through the class map, a byte outside [0, 255] to the
    last column, mask 0 for a walk that ends in the sink."""
    bc = tab.byte_class.numpy().astype(np.int64)
    ct = np.minimum(tab.class_trans.numpy().view(np.uint16).astype(np.int64), tab.n_states)
    q, c = tab.n_states, ct.shape[1]
    acc = (tab.accept_hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)) | (
        tab.accept_lo.numpy().view(np.uint32).astype(np.uint64))
    out = np.zeros(len(lens), np.uint64)
    for i, (row, n, s) in enumerate(zip(sb.astype(np.int64), lens, starts)):
        if n < 0 or not 0 <= s < q:
            continue
        cols = [bc[x] if 0 <= x <= 255 else c - 1 for x in row[:min(n, max_len)]]
        for k in range(0, len(cols), 2):
            s = ct[s, cols[k]]
            if k + 1 < len(cols):
                s = ct[s, cols[k + 1]]
        out[i] = acc[s] if s < q else 0
    return out


@pytest.mark.parametrize("dtype", [np.uint8, np.int32], ids=["u8", "i32"])
@pytest.mark.parametrize("max_len", MAX_LENS)
def test_class_form_walk_matches_jax(max_len, dtype):
    """The class form itself, walked as the card walks it (the CPU's
    plain versions walk ``trans``), against the JAX pair walk; int32 rows
    hold -1 past every length, which neither walk may read."""
    jf, tf = _fused_pair(450 + max_len, n_fields=2)
    tab = tdfa.DeviceDFATable(("f", max_len), tf, "cpu")
    sb, lens, starts = _batch(tf, max_len, dtype)
    if dtype is np.int32:
        past = np.arange(sb.shape[1])[None, :] >= np.maximum(lens, 0)[:, None]
        sb[past] = -1
    jlo, jhi = _jax_pair(jf, sb, lens, starts, max_len)
    want = (jhi.astype(np.uint64) << np.uint64(32)) | jlo.astype(np.uint64)
    np.testing.assert_array_equal(_class_form_walk(tab, sb, lens, starts, max_len), want)


def test_pair_walk_with_classes_keeps_the_reference_fault_named():
    """The divergence of queue C, on the class walk the L7 path takes and
    on the pair walk: the automaton of ["ab", "abb", "a"], bytes "abb",
    max_len 3, lengths 3 and 4. JAX's pair walk gives [2, 0] (it reads
    bytes[:, 3], clamped to the last byte); the port's give [2, 2], as
    both single-byte walks do."""
    jd, td = jrc.compile_patterns(["ab", "abb", "a"]), trc.compile_patterns(["ab", "abb", "a"])
    jf, tf = jdfa.fuse_dfas([jd]), tdfa.fuse_dfas([td])
    tab = tdfa.DeviceDFATable(("fault",), tf, "cpu")
    sb = np.frombuffer(b"abbabb", np.uint8).reshape(2, 3).copy()
    lens = np.array([3, 4], np.int32)
    starts = np.repeat(tf.starts, 2)
    jargs = (*_jax_accept(jf.accept), jnp.asarray(starts), jnp.asarray(sb), jnp.asarray(lens), 3)
    assert np.asarray(jdfa.dfa_match_batch_pair(jnp.asarray(jf.pair), *jargs)[0]).tolist() == [2, 0]
    args = (tab.accept_lo, tab.accept_hi, torch.from_numpy(starts), torch.from_numpy(sb),
            torch.from_numpy(lens), 3)
    for got in (tdfa.dfa_match_batch_classes(tab.trans, *_classes(tab), *args),
                tdfa.dfa_match_batch_pair(tab.pair, *args)):
        assert got[0].numpy().view(np.uint32).tolist() == [2, 2]
    assert _class_form_walk(tab, sb, lens, starts, 3).tolist() == [2, 2]


def test_class_walk_refuses_ill_formed_classes():
    """The class form of a pair table's walk is checked as K7's entry
    checks it; the pair walk takes no form."""
    _, tf = _fused_pair(330)
    tab = tdfa.DeviceDFATable(("bad",), tf, "cpu")
    bc, ct = _classes(tab)
    rows = (tab.accept_lo, tab.accept_hi, torch.zeros(4, dtype=torch.int32),
            torch.zeros((4, 16), dtype=torch.uint8), torch.full((4,), 16, dtype=torch.int32), 16)
    for form in ((bc[:255], ct), (bc.int(), ct), (bc, ct[:-1]), (bc, ct.reshape(-1)),
                 (bc, ct.int())):
        with pytest.raises(ValueError):
            tdfa.dfa_match_batch_classes(tab.trans, *form, *rows)
    tdfa.dfa_match_batch_classes(tab.trans, bc, ct, *rows)
    with pytest.raises(TypeError):
        tdfa.dfa_match_batch_pair(tab.pair, *rows, classes=(bc, ct))


# ---------------------------------------------------------------------------
# the L7 pipeline on both routes
# ---------------------------------------------------------------------------


def _pipeline_walk(monkeypatch, seed: int, cap: int):
    """A two-field batch of 700 requests through L7Pipeline on the CPU,
    each walk wrapper spied → (table, calls by wrapper, masks, the plain
    pair walk's masks, rung)."""
    seen = {"pair": [], "classes": [], "fused": []}
    for name, key in (("dfa_match_batch_pair", "pair"), ("dfa_match_batch_classes", "classes"),
                      ("dfa_match_batch_fused", "fused")):
        real = getattr(tl7rt, name)

        def spy(*a, real=real, key=key, **k):
            seen[key].append(a)
            return real(*a, **k)

        monkeypatch.setattr(tl7rt, name, spy)
    _, tf = _fused_pair(seed)
    tab = tdfa.DeviceDFATable(("pipe", cap), tf, "cpu")
    assert tab.has_pair and tab.class_trans is not None
    rng = random.Random(seed)
    fields = [([("".join(rng.choice("ab0/xc") for _ in range(rng.randrange(0, 20)))).encode()
                for _ in range(700)], cap) for _ in range(2)]
    pipe = tl7rt.L7Pipeline(depth=2, device="cpu")
    got = pipe.submit(tab, fields).result()
    starts = np.repeat(tab.starts_host, 700)
    flat = fields[0][0] + fields[1][0]
    rung = tdfa.len_rung(max(map(len, flat)), cap)
    sb, lens = tdfa.strings_to_batch_u8(flat, rung)
    for f in range(2):
        seg = lens[f * 700:(f + 1) * 700]
        seg[seg > cap] = -1
    want = tdfa.masks_u64(*tdfa.dfa_pair_walk_plain(
        tab.pair, tab.accept_lo, tab.accept_hi, torch.from_numpy(starts), torch.from_numpy(sb),
        torch.from_numpy(lens), rung))
    return tab, seen, np.concatenate(got), want, rung


def test_l7_pipeline_hands_the_class_form_through(monkeypatch):
    """From 16 bytes a row, L7Pipeline._walk gives K7's class walk the
    table's own class form (the same tensors) and its single-step table,
    and the masks equal the plain pair walk."""
    tab, seen, got, want, rung = _pipeline_walk(monkeypatch, 340, 24)
    assert rung >= 16 and seen["classes"] and not seen["pair"] and not seen["fused"]
    assert all(a[0] is tab.trans and a[1] is tab.byte_class and a[2] is tab.class_trans
               for a in seen["classes"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [3, 8, 15])
def test_l7_pipeline_walks_the_pair_table_under_16_bytes(monkeypatch, cap):
    """Under 16 bytes a row (a field cap under the ladder's first rung)
    L7Pipeline._walk walks the table's pair table, and the masks equal
    the plain pair walk (rows past the cap fail closed)."""
    tab, seen, got, want, rung = _pipeline_walk(monkeypatch, 350 + cap, cap)
    assert rung == cap and seen["pair"] and not seen["classes"] and not seen["fused"]
    assert all(a[0] is tab.pair for a in seen["pair"])
    np.testing.assert_array_equal(got, want)
