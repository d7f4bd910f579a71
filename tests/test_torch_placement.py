"""Port parity: multi-device placement and the ident-sharded policymap —
``datapath/placement.py``, the placed tables and ``ident_gather_rows``
of ``ops/lookup.py``, the selector-row / column scatters of
``ops/materialize.py`` and the pipeline's ``set_sharding`` /
``set_mesh_2d`` — against the JAX package.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port's
one seam, ``placement.visible_devices``, gives it 8 CPU records with
the same ids. Every compared value is an integer or a bool, so the
tolerance is exact equality.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cilium_tpu import metrics as jmetrics
from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.datapath import placement as jplace
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ops import lookup as jlookup
from cilium_tpu.ops import materialize as jmat
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.convert import policymap_from_numpy
from cilium_tpu_torch.datapath import placement as tplace
from cilium_tpu_torch.ops import lookup as tlookup
from cilium_tpu_torch.ops import materialize as tmat
from test_torch_harness import PKGS, build_world, random_flows
from test_torch_pipeline_ct import ct_equal
from test_torch_pipeline_incremental import INGRESS, EGRESS, Pipes, _add_rule, _alloc, _release
from test_torch_pipeline_v6 import add_v6, v6_flows
from test_torch_submit import metric_deltas

N_EPS = 6
CPU = torch.device("cpu")


def _records(n: int = 8):
    return [tplace.DeviceRecord(i, 0, CPU) for i in range(n)]


@pytest.fixture(autouse=True)
def _eight_cpu_records(monkeypatch):
    """The port's device seam: 8 CPU records, ids 0-7, as JAX's 8
    virtual CPU devices."""
    assert [d.id for d in jax.devices()] == list(range(8))
    monkeypatch.setattr(tplace, "visible_devices", _records)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _whole(x) -> np.ndarray:
    """A port table of any placement (or a JAX array) as uint32 numpy:
    an ident-sharded one from grid row 0's shards, a replicated one
    after checking every copy is equal."""
    if isinstance(x, tlookup.IdentSharded):
        for row in x.shards:
            assert [s.row_lo for s in row] == [k * row[0].rows for k in range(len(row))]
        x = torch.cat([s.tensor for s in x.shards[0]])
    elif isinstance(x, tlookup.Replicated):
        copies = list(x.copies.values())
        for c in copies[1:]:
            assert torch.equal(c, copies[0])
        x = copies[0]
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32) if x.dtype == torch.int32 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


# -- resolve_plan ------------------------------------------------------------

def _plans(mod, case):
    """The plans one case of tests/test_placement.py:77-150 resolves,
    through ``mod``'s placement module."""
    rp, cfg = mod.resolve_plan, mod.PlacementConfig
    if case == "1d":
        return [rp(None, sharding=True)]
    if case == "2d":
        return [rp(None, sharding=True, mesh_2d=True)]
    if case == "ident_axis_4":
        return [rp(cfg(ident_axis=4), sharding=True, mesh_2d=True)]
    if case == "odd_count":
        return [rp(cfg(device_ids=(0, 1, 2)), sharding=True, mesh_2d=True)]
    if case == "stable":
        p1 = rp(None, sharding=True, mesh_2d=True)
        p2 = rp(None, sharding=True, mesh_2d=True, prev=p1)
        assert p2 is p1
        return [p1, p2]
    if case == "generations":
        p1 = rp(None, sharding=True)
        p2 = rp(None, sharding=True, mesh_2d=True, prev=p1)
        p3 = rp(None, sharding=True, mesh_2d=True, excluded=frozenset({7}), prev=p2)
        return [p1, p2, p3]
    if case == "subset":
        return [rp(cfg(device_ids=(2, 3, 4, 5), ident_axis=2), sharding=True, mesh_2d=True)]
    if case == "exclusion_fallback":
        return [rp(cfg(device_ids=(2, 3, 4, 5)), sharding=True, excluded=frozenset({2, 3, 4, 5}))]
    assert case == "no_sharding"
    return [rp(None, sharding=False, mesh_2d=True)]


def _grid_ids(plan):
    if plan.mesh is None:
        return None
    if isinstance(plan.mesh, tuple):
        return [[rec.id for rec in row] for row in plan.mesh]
    ids = np.vectorize(lambda d: d.id)(plan.mesh.devices)
    return ids.reshape(ids.shape[0], -1).tolist()


@pytest.mark.parametrize("case", [
    "1d", "2d", "ident_axis_4", "odd_count", "stable", "generations", "subset",
    "exclusion_fallback", "no_sharding",
])
def test_resolve_plan_matches_jax(case):
    """Field by field: generation, axes, device ids, flows_size, is_2d,
    ident_size, the grid's layout and which shardings exist."""
    for pj, pt in zip(_plans(jplace, case), _plans(tplace, case)):
        for f in ("generation", "axes", "device_ids", "flows_size", "is_2d", "ident_size"):
            assert getattr(pt, f) == getattr(pj, f), f
        assert _grid_ids(pt) == _grid_ids(pj)
        for f in ("flow_sharding", "table_sharding", "ident_sharding"):
            sj, st = getattr(pj, f), getattr(pt, f)
            assert (sj is None) == (st is None), f
            if sj is not None:
                assert st.spec == tuple(sj.spec), f
    for n, want in ((6, 4), (7, 4), (8, 2), (8, 4), (2, 2), (1, 2)):
        assert tplace._ident_factor(n, want) == jplace._ident_factor(n, want)
    assert tplace.EMPTY_PLAN.generation == jplace.EMPTY_PLAN.generation == 0


def test_visible_devices_lists_the_cards(monkeypatch):
    monkeypatch.undo()  # the real seam
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tplace.visible_devices() == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [(d.id, d.process_index, d.device) for d in tplace.visible_devices()] == [
        (0, 0, torch.device("cuda", 0)), (1, 0, torch.device("cuda", 1))]


def test_ident_shards_sit_where_jax_puts_them():
    """A [96, 3] table on the 2D plan: rows 0-47 on the even ids, 48-95
    on the odd ones, in both packages; a [97, 3] table raises."""
    pj = jplace.resolve_plan(None, sharding=True, mesh_2d=True)
    pt = tplace.resolve_plan(None, sharding=True, mesh_2d=True)
    tab = np.arange(96 * 3, dtype=np.int32).reshape(96, 3)
    want = {}
    for s in jax.device_put(jnp.asarray(tab), pj.ident_sharding).addressable_shards:
        want[s.device.id] = (s.index[0].start or 0, np.asarray(s.data))
    held = tlookup.shard_rows(torch.from_numpy(tab), pt.ident_sharding)
    got = {}
    for grid_row, shard_row in zip(pt.mesh, held.shards):
        for rec, shard in zip(grid_row, shard_row):
            got[rec.id] = (shard.row_lo, shard.tensor.numpy())
    assert sorted(got) == sorted(want) == list(range(8))
    for i in range(8):
        assert got[i][0] == want[i][0] == (0 if i % 2 == 0 else 48)
        np.testing.assert_array_equal(got[i][1], want[i][1])
    bad = np.zeros((97, 3), np.int32)
    with pytest.raises(ValueError):
        jax.device_put(jnp.asarray(bad), pj.ident_sharding)
    with pytest.raises(ValueError):
        tlookup.shard_rows(torch.from_numpy(bad), pt.ident_sharding)


# -- ident_gather_rows -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint32", "int32"])
@pytest.mark.parametrize("placed", [False, True])
def test_ident_gather_rows_matches_jax(dtype, placed):
    """uint32 bitmaps and int32 rule tables, replicated and
    ident-sharded, src including -1 and N (all-zero rows in both)."""
    rng = np.random.default_rng(0)
    if dtype == "uint32":
        tab = rng.integers(0, 2**32, size=(96, 6), dtype=np.uint64).astype(np.uint32)
    else:
        tab = rng.integers(-2**31, 2**31 - 1, size=(96, 6)).astype(np.int32)
    src = np.concatenate([rng.integers(0, 96, 41), [-1, 96, 0, 95, 47, 48]]).astype(np.int32)
    jt = jnp.asarray(tab)
    tt = torch.from_numpy(tab.view(np.int32))
    if placed:
        jt = jax.device_put(jt, jplace.resolve_plan(None, sharding=True, mesh_2d=True).ident_sharding)
        tt = tlookup.shard_rows(tt, tplace.resolve_plan(None, sharding=True, mesh_2d=True).ident_sharding)
    want = np.asarray(jlookup.ident_gather_rows(jt, jnp.asarray(src)))
    got = tlookup.ident_gather_rows(tt, torch.from_numpy(src))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(tab.dtype), want)
    assert not want[41:43].any()
    np.testing.assert_array_equal(want[:41], tab[src[:41]])
    if not placed:
        # the plain version on its own, with a shard's row offset
        part = tlookup.ident_gather_rows_plain(torch.from_numpy(tab[48:].view(np.int32)),
                                               torch.from_numpy(src), 48)
        own = (src >= 48) & (src < 96)
        np.testing.assert_array_equal(part.numpy().view(tab.dtype)[own], tab[src[own]])
        assert not part.numpy()[~own].any()


def _grid_shardings(grid: str):
    """(JAX sharding or None, the port's ident GridSharding) of a flows x
    ident grid: 1x1 (one device, an unsharded table), 2x2 (devices 0-3)
    and 2x4 (devices 0-7)."""
    if grid == "1x1":
        return None, tplace.GridSharding(((tplace.DeviceRecord(0, 0, CPU),),), ("ident", None))
    ids, ident = {"2x2": ((0, 1, 2, 3), 2), "2x4": (tuple(range(8)), 4)}[grid]
    pj, pt = (m.resolve_plan(m.PlacementConfig(device_ids=ids, ident_axis=ident), sharding=True,
                             mesh_2d=True) for m in (jplace, tplace))
    assert pt.axes == {"flows": 2, "ident": ident}
    return pj.ident_sharding, pt.ident_sharding


@pytest.mark.parametrize("w", [18, 20])
@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("grid", ["1x1", "2x2", "2x4"])
def test_multi_shard_gather_plain_matches_jax(grid, empty, w):
    """K12's multi-shard plain version — one call over every shard of a
    grid row, the CPU path of the one-launch kernel — equals JAX's
    ident_gather_rows on the same sharded table and the per-shard sum of
    ident_gather_rows_plain (one launch a shard, partials added), with
    ids -1 and N and, with ``empty``, an empty shard listed too."""
    rng = np.random.default_rng(w)
    n = 96
    tab = rng.integers(-2**31, 2**31 - 1, size=(n, w)).astype(np.int32)
    src = np.concatenate([rng.integers(-3, n + 3, 300), [-1, n, 0, n - 1]]).astype(np.int32)
    js, ts = _grid_shardings(grid)
    jt = jnp.asarray(tab) if js is None else jax.device_put(jnp.asarray(tab), js)
    want = np.asarray(jlookup.ident_gather_rows(jt, jnp.asarray(src)))
    assert not want[-4:-2].any()
    held = tlookup.shard_rows(torch.from_numpy(tab), ts)
    src_t = torch.from_numpy(src)
    for grid_row in held.shards:
        shards = list(grid_row)
        if empty:
            shards.append(tlookup.RowShard(n, 0, torch.from_numpy(tab[n:])))
        got = tlookup.ident_gather_shards_plain(shards, src_t)
        per_shard = sum(tlookup.ident_gather_rows_plain(s.tensor, src_t, s.row_lo) for s in shards)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(per_shard.numpy(), want)
        np.testing.assert_array_equal(tlookup.ident_gather_shards(shards, src_t).numpy(), want)
    np.testing.assert_array_equal(tlookup.ident_gather_rows(held, src_t).numpy(), want)


def test_ident_gather_shards_raises_past_the_kernels_list(monkeypatch):
    """The kernel takes at most IDENT_MAX_SHARDS shards a launch; the
    wrapper says so before it reaches the card (the CPU path takes any
    number)."""
    tab = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    many = [tlookup.RowShard(0, 4, tab)] * (tlookup._kernels.IDENT_MAX_SHARDS + 1)
    src = torch.tensor([0, 3, 4], dtype=torch.int32)
    np.testing.assert_array_equal(tlookup.ident_gather_shards(many, src).numpy(),
                                  [[0, 1, 2], [9, 10, 11], [0, 0, 0]])
    monkeypatch.setattr(tlookup._kernels, "dispatch_device", lambda *t: torch.device("cuda"))
    with pytest.raises(ValueError, match="shards on one device"):
        tlookup.ident_gather_shards(many, src)


@pytest.fixture(scope="module")
def attributed_maps():
    """Both directions' JAX materializations with attribution of one
    world, and the port's tables from their arrays."""
    w = build_world("cilium_tpu", 4)
    eng = JaxEngine(w.repo, w.reg)
    compiled, device = eng.snapshot()
    eps = [i.id for i in w.idents[:N_EPS]]
    out = {}
    for ingress in (True, False):
        origin, nr = eng.attribution(ingress)
        st = jmat.materialize_endpoints_state(compiled, device, eps, ingress=ingress,
                                              attrib_origin=origin, n_rules=nr)
        jt = st.tables
        tt = policymap_from_numpy(
            np.asarray(jt.col_ep), np.asarray(jt.col_port), np.asarray(jt.col_proto),
            np.asarray(jt.col_is_l3), np.asarray(jt.id_bits), device="cpu")
        out[ingress] = (jt, tt, st.rule_tab, torch.from_numpy(np.array(st.rule_tab)))
    return compiled, out


@pytest.mark.parametrize("attrib", [False, True])
@pytest.mark.parametrize("placed", [False, True])
def test_lookup_batch_ident_gather_matches_jax(attributed_maps, attrib, placed):
    """lookup_batch(ident_gather=True) — rows (and rule rows) gathered a
    block at a time — equals JAX's, src -1 and N included."""
    compiled, maps = attributed_maps
    n = compiled.id_bits.shape[0]
    rs = np.random.default_rng(8)
    for ingress in (True, False):
        jt, tt, jrt, trt = maps[ingress]
        b = 3000
        ep = rs.integers(-1, N_EPS + 1, b).astype(np.int32)
        src = rs.integers(-1, n + 1, b).astype(np.int32)
        dp = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), b)
        pr = rs.choice(np.array([6, 17], np.int32), b)
        if placed:
            pj = jplace.resolve_plan(None, sharding=True, mesh_2d=True)
            pt = tplace.resolve_plan(None, sharding=True, mesh_2d=True)
            jt = jlookup.shard_tables_ident(jt, pj.ident_sharding, pj.table_sharding)
            jrt = jax.device_put(jrt, pj.ident_sharding)
            tt = tlookup.tables_on(
                tlookup.shard_tables_ident(tt, pt.ident_sharding, pt.table_sharding), CPU)
            trt = tlookup.shard_rows(trt, pt.ident_sharding)
        kw = dict(block=1024, ident_gather=True)
        if attrib:
            kw.update(attrib=True)
        want = jlookup.lookup_batch(jt, *(jnp.asarray(a) for a in (ep, src, dp, pr)),
                                    rule_tab=jrt if attrib else None, **kw)
        got = tlookup.lookup_batch(tt, *(torch.from_numpy(a) for a in (ep, src, dp, pr)),
                                   rule_tab=trt if attrib else None, **kw)
        assert len(got) == len(want) == (4 if attrib else 2)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        assert (got[0].numpy() == 1).any()


# -- K4 over shard lists: the 2D verdict reading rows in place ---------------

def _grid_plans(grid: str):
    """(JAX plan, the port's plan) of a flows x ident grid as
    ``_grid_shardings`` gives it; (None, None) for 1x1 (one device)."""
    if grid == "1x1":
        return None, None
    ids, ident = {"2x2": ((0, 1, 2, 3), 2), "2x4": (tuple(range(8)), 4)}[grid]
    return tuple(m.resolve_plan(m.PlacementConfig(device_ids=ids, ident_axis=ident), sharding=True,
                                mesh_2d=True) for m in (jplace, tplace))


def _gathered_inputs(compiled, seed: int, b: int = 2000):
    """Flows with rows -1 and N among live and random ones, endpoints -1
    to E, a prefilter mask."""
    n = compiled.id_bits.shape[0]
    rs = np.random.default_rng(seed)
    src = rs.integers(-1, n + 1, b).astype(np.int32)
    src[:4] = [-1, n, 0, n - 1]
    return (src, rs.integers(-1, N_EPS + 1, b).astype(np.int32),
            rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), b),
            rs.choice(np.array([6, 17], np.int32), b)), rs.random(b) < 0.1


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("attrib", [False, True])
@pytest.mark.parametrize("grid", ["1x1", "2x2", "2x4"])
def test_shard_list_plain_matches_jax_gather(attributed_maps, grid, attrib, empty):
    """K4's shard-list plain version in gathered mode — the CPU path of
    the one launch that reads each row from the ident shard owning it —
    over each grid row's shards (and, with ``empty``, an empty shard
    listed too) equals JAX lookup_batch(ident_gather=True) and the
    verdict tail on the same sharded tables, ids -1 and N included
    (the contraction's zero row: rule 0 where a column is chosen)."""
    compiled, maps = attributed_maps
    jt, tt, jrt, trt = maps[True]
    n = compiled.id_bits.shape[0]
    n_rules = int(np.asarray(jrt).max()) + 1
    (src, ep, dp, pr), denied = _gathered_inputs(compiled, 21)
    pj, pt = _grid_plans(grid)
    if pj is not None:
        jt = jlookup.shard_tables_ident(jt, pj.ident_sharding, pj.table_sharding)
        jrt = jax.device_put(jrt, pj.ident_sharding)
        held, rheld = (tlookup.shard_rows(x, pt.ident_sharding).shards for x in (tt.id_bits, trt))
    else:
        held, rheld = ((tlookup.RowShard(0, n, tt.id_bits),),), ((tlookup.RowShard(0, n, trt),),)
    jkw = dict(attrib=True, rule_tab=jrt, n_rules=n_rules) if attrib else {}
    want = [np.asarray(x) for x in jpipe._verdict_tail(
        jt, *(jnp.asarray(a) for a in (denied, src, ep, dp, pr)), N_EPS, 512, ident_gather=True,
        **jkw)]
    assert (want[0] == 1).any()
    if attrib:  # an id outside [0, N) whose flow a column covers: rule 0
        assert (want[3][(src < 0) | (src >= n)] == 0).any()
    args = [torch.from_numpy(a) for a in (src, ep, dp, pr)]
    for row, rrow in zip(held, rheld):
        shards, rules = list(row), list(rrow)
        if empty:
            shards.append(tlookup.RowShard(n, 0, tt.id_bits[n:]))
            rules.append(tlookup.RowShard(n, 0, trt[n:]))
        kw = dict(denied_pf=torch.from_numpy(denied), ep_count=N_EPS, block=512,
                  rule_shards=rules if attrib else None, n_rules=n_rules, gathered=True)
        for fn in (tlookup.policymap_verdict_shards_plain, tlookup.policymap_verdict_shards):
            got = fn(tt, shards, *args, **kw)
            assert len(got) == len(want)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), x)


@pytest.mark.parametrize("attrib", [False, True])
@pytest.mark.parametrize("placed", [False, True])
def test_gathered_one_launch_route_equals_per_block_route(attributed_maps, monkeypatch, attrib,
                                                          placed):
    """policymap_verdict_gathered takes one shard-list launch when every
    shard lies on the reader's device (here all of them: CPU records)
    and reads no row through ident_gather_rows; with the seam
    local_row_shards refusing, it takes the per-block route (K12
    gathers, then K4 on each block). Both give the same verdicts,
    redirects, counters, rules, coverage and rule hits."""
    compiled, maps = attributed_maps
    _jt, tt, _jrt, trt = maps[False]
    (src, ep, dp, pr), denied = _gathered_inputs(compiled, 22, b=3000)
    if placed:
        pt = tplace.resolve_plan(None, sharding=True, mesh_2d=True)
        tt = tlookup.tables_on(tlookup.shard_tables_ident(tt, pt.ident_sharding, pt.table_sharding),
                               CPU)
        trt = tlookup.shard_rows(trt, pt.ident_sharding)
    kw = dict(denied_pf=torch.from_numpy(denied), ep_count=N_EPS, block=1024,
              rule_tab=trt if attrib else None, n_rules=500)
    args = [torch.from_numpy(a) for a in (src, ep, dp, pr)]
    gathers = []
    real = tlookup.ident_gather_rows

    def spy(*a, **k):
        gathers.append(a[1].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(tlookup, "ident_gather_rows", spy)
    one = tlookup.policymap_verdict_gathered(tt, *args, **kw)
    assert gathers == []
    monkeypatch.setattr(tlookup, "local_row_shards", lambda tab, device: None)
    blocks = tlookup.policymap_verdict_gathered(tt, *args, **kw)
    assert gathers and sum(gathers) == (2 if attrib else 1) * src.shape[0]
    assert len(one) == len(blocks) == (6 if attrib else 3)
    for a, b in zip(one, blocks):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (one[0].numpy() == 1).any()


def test_2d_batch_reads_rows_in_place(monkeypatch):
    """A 2D batch (every record a CPU one, as on one card's grid) reads
    its policymap and rule rows in place through local_row_shards and
    never through ident_gather_rows; the results == JAX's 2D pipeline
    and the port's unplaced one, attribution on."""
    m = Mesh(4, attrib=True)
    assert m.t._plan.is_2d
    seen = []
    real = tlookup.local_row_shards

    def spy(tab, device):
        seen.append(type(tab).__name__)
        return real(tab, device)

    def boom(*a, **k):
        raise AssertionError("a 2D batch gathered its rows")

    monkeypatch.setattr(tlookup, "local_row_shards", spy)
    monkeypatch.setattr(tlookup, "ident_gather_rows", boom)
    for fam in (4, 6):
        m.run(fam, m.flows(fam, 300, 50 + fam))
    assert seen and set(seen) == {"IdentSharded"}
    m.counters_equal()


# -- the selector scatters ----------------------------------------------------

@pytest.mark.parametrize("placed", [False, True])
def test_patch_selector_rows_and_cols_match_jax(placed):
    """Row and cell scatters into a sel_match copy, replicated or
    ident-sharded: the same table as JAX's, the ident sharding intact,
    and a shard that owns no patched row keeps its tensor."""
    rng = np.random.default_rng(3)
    sel = rng.integers(0, 2**32, size=(96, 5), dtype=np.uint64).astype(np.uint32)
    jt = jnp.asarray(sel)
    tt = torch.from_numpy(sel.view(np.int32))
    pj = jplace.resolve_plan(None, sharding=True, mesh_2d=True)
    pt = tplace.resolve_plan(None, sharding=True, mesh_2d=True)
    if placed:
        jt = jax.device_put(jt, pj.ident_sharding)
        tt = tlookup.shard_rows(tt, pt.ident_sharding)
    rows = [3, 50, 95]
    vals = rng.integers(0, 2**32, size=(3, 5), dtype=np.uint64).astype(np.uint32)
    jt = jmat.patch_selector_rows(jt, rows, vals)
    tt = tmat.patch_selector_rows(tt, rows, vals)
    np.testing.assert_array_equal(_whole(tt), np.asarray(jt))
    # cells: rows 1, 60 × words 0, 3 — only shard 0 for the rows < 48
    cells = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint64).astype(np.uint32)
    before = tt
    jt = jmat.patch_selector_cols(jt, [1, 20], [0, 3], cells)
    tt = tmat.patch_selector_cols(tt, [1, 20], [0, 3], cells)
    np.testing.assert_array_equal(_whole(tt), np.asarray(jt))
    if placed:
        assert jt.sharding.spec == P("ident", None)
        assert isinstance(tt, tlookup.IdentSharded)
        assert tt.shards[0][1] is before.shards[0][1]  # rows 48-95: untouched
        assert tt.shards[0][0] is not before.shards[0][0]
    assert tmat.patch_selector_rows(tt, [], np.zeros((0, 5), np.uint32)) is tt
    assert tmat.patch_selector_cols(tt, [1], [], np.zeros((1, 0), np.uint32)) is tt


# -- the pipeline ------------------------------------------------------------

class Mesh:
    """One pipeline per package with ``sharding`` and ``mesh_2d``, plus
    the port's unplaced pipeline, over the same world; ``kw`` goes to
    every constructor."""

    def __init__(self, seed: int, *, mesh_2d: bool = True, depth: int = 1, ct: bool = False,
                 attrib: bool = False, **kw):
        self.pipes = {}
        for name, pkg, opts in (("j", "cilium_tpu", dict(sharding=True, mesh_2d=mesh_2d)),
                                ("t", "cilium_tpu_torch", dict(sharding=True, mesh_2d=mesh_2d)),
                                ("u", "cilium_tpu_torch", {})):
            w = build_world(pkg, seed)
            if name == "j":
                self.world = w
                self.peers6 = add_v6(w)
            else:
                assert add_v6(w) == self.peers6
            dev = {} if pkg == "cilium_tpu" else {"device": "cpu"}
            ctab = _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=12) if ct else None
            pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
                _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **dev), w.ipcache,
                _mod(pkg, "ipcache.prefilter").PreFilter(), ctab,
                pipeline_depth=depth, **opts, **kw, **dev)
            pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
            if attrib:
                pipe.set_attribution(True)
            pipe.rebuild()
            self.pipes[name] = pipe
        self.j, self.t, self.u = self.pipes["j"], self.pipes["t"], self.pipes["u"]

    def flows(self, fam: int, n: int, seed: int):
        if fam == 4:
            return random_flows(self.world, n, N_EPS, seed)
        return v6_flows(self.peers6, n, seed)

    def run(self, fam: int, flows, names=("j", "t", "u"), **kw):
        """The same call on the three (or on ``names``, the rest already
        in ``out``) → their results, checked equal."""
        call = "process" if fam == 4 else "process_v6"
        out = kw.pop("out", {})
        out.update({k: getattr(self.pipes[k], call)(*flows, **kw) for k in names})
        for k in ("t", "u"):
            assert len(out[k]) == len(out["j"])
            for g, x in zip(out[k], out["j"]):
                np.testing.assert_array_equal(g, np.asarray(x), err_msg=k)
        return out["t"]

    def counters_equal(self):
        np.testing.assert_array_equal(self.t.counters, self.j.counters)
        np.testing.assert_array_equal(self.u.counters, self.j.counters)


@pytest.mark.parametrize("b", [512, 509])
def test_2d_matches_jax_and_unsharded(b):
    """2D dispatch (ident-sharded tables, K12 row reads, flow shards of
    ceil(b / 4)) == JAX's 2D pipeline == the port's unplaced one: v4
    and v6, both directions; the per-shard verdicts_total series move
    alike (509 leaves the last shard three flows short)."""
    m = Mesh(3)
    assert m.t._plan.is_2d and m.t._plan.axes == {"flows": 4, "ident": 2}
    assert isinstance(m.t._placed_pm[INGRESS][2].id_bits, tlookup.IdentSharded)
    for seed in (20, 21):
        for fam in (4, 6):
            for ingress in (True, False):
                flows = m.flows(fam, b, seed + 7 * fam + ingress)
                out = {}
                call = "process" if fam == 4 else "process_v6"
                deltas = metric_deltas(lambda: out.update(
                    {k: getattr(m.pipes[k], call)(*flows, ingress=ingress) for k in ("j", "t")}))
                assert deltas["cilium_tpu"] == deltas["cilium_tpu_torch"]
                assert all("device" in dict(k) for k in deltas["cilium_tpu_torch"][1])
                m.run(fam, flows, names=("u",), out=out, ingress=ingress)
    m.counters_equal()


def test_2d_ct_depth2_attribution_matches_jax():
    """The widest variant — attribution, depth-2 submit, the host CT
    pre-pass with a replayed batch (established hits) — on the 2D plan
    == JAX's 2D pipeline and the port's synchronous unplaced one:
    verdicts, redirects, counters, CT entries and the attribution
    metric deltas."""
    m = Mesh(5, depth=2, ct=True, attrib=True)
    assert m.t._placed.ident2d and m.t._placed.rows[0][2] is not None
    assert isinstance(m.t._placed_rt[INGRESS][2], tlookup.IdentSharded)
    _gen, _src, placed_sel = m.t._placed_sel
    assert isinstance(placed_sel, tlookup.IdentSharded)
    assert m.j._placed_sel[2].sharding.spec == P("ident", None)
    rng = np.random.default_rng(7)
    batches = [m.flows(4, 512, 60 + i) for i in range(4)]
    batches.append(batches[0])
    sports = [rng.integers(1024, 4096, 512).astype(np.int32) for _ in batches]
    sports[-1] = sports[0]

    def series():
        return {pkg: dict(m_.rule_hits_total.series())
                for pkg, m_ in zip(PKGS, (jmetrics, tmetrics))}

    before = series()
    got = {}
    for k in ("j", "t"):
        pend = [m.pipes[k].submit(*f, sports=s) for f, s in zip(batches, sports)]
        got[k] = [pb.result() for pb in pend]
    after = series()
    hits = {pkg: {k: v - before[pkg].get(k, 0.0) for k, v in after[pkg].items()
                  if v != before[pkg].get(k, 0.0)} for pkg in PKGS}
    assert hits["cilium_tpu"] == hits["cilium_tpu_torch"] and hits["cilium_tpu_torch"]
    for f, s, gj, gt in zip(batches, sports, got["j"], got["t"]):
        gu = m.u.process(*f, sports=s)
        for a, b_, c in zip(gt, gj, gu):
            np.testing.assert_array_equal(a, np.asarray(b_))
            np.testing.assert_array_equal(a, c)
    m.counters_equal()
    ct_equal(m.t.conntrack, m.j.conntrack)
    ct_equal(m.u.conntrack, m.j.conntrack)


def test_2d_device_ct_keeps_the_unplaced_tables(monkeypatch):
    """The device-CT path on a 2D plan runs on the pipeline's own
    (unplaced) tables: == JAX's 2D device-CT pipeline and the port's
    unplaced one, and it reads no row through ident_gather_rows nor
    in place through local_row_shards (the 2D verdict's two seams)."""
    now = [7000.0]
    import time as _time
    monkeypatch.setattr(_time, "monotonic", lambda: now[0])
    m = Mesh(2, device_ct_bits=10)
    flows = m.flows(4, 400, 3)
    sp = np.random.default_rng(1).integers(1024, 4096, 400).astype(np.int32)
    real = tlookup.ident_gather_rows

    def boom(*a, **k):
        raise AssertionError("the device-CT path read an ident-sharded row")

    monkeypatch.setattr(tlookup, "ident_gather_rows", boom)
    monkeypatch.setattr(tlookup, "local_row_shards", boom)
    for _ in range(2):
        m.run(4, flows, sports=sp)
        now[0] += 1.0
    monkeypatch.setattr(tlookup, "ident_gather_rows", real)
    m.counters_equal()


def test_delta_patches_keep_the_placed_copies(monkeypatch):
    """A mutation stream on 2D pipelines of both packages (sparse deltas
    on, so the placed sel_match is patched, not re-placed): each
    rebuild equals JAX's (Pipes.check), the placed id_bits / rule tables
    equal the host tables and JAX's placed copies, the ident-sharded
    sel_match equals the engine's, and most steps patch in place."""
    p = Pipes(5, sharding=True, mesh_2d=True, sparse_deltas=True)
    for pipe in p.pipe.values():
        pipe.set_attribution(True)
    assert p.rebuild() is False
    apps = sorted({lb for i in p.w["cilium_tpu"].idents[:N_EPS]
                   for lb in p.w["cilium_tpu"].ident_labels[i.id] if "app=" in lb})
    sel_patches = []
    real = tmat.patch_selector_rows
    monkeypatch.setattr(tmat, "patch_selector_rows",
                        lambda *a, **k: sel_patches.append("rows") or real(*a, **k))
    import cilium_tpu_torch.datapath.pipeline as tpipe
    monkeypatch.setattr(tpipe, "patch_selector_rows", tmat.patch_selector_rows)
    kept = []

    def placed_equal():
        for d in (INGRESS, EGRESS):
            mt, mj = p.pt._mat[d], p.pj._mat[d]
            gen, src, placed = p.pt._placed_pm[d]
            assert src is mt.tables and gen == p.pt._plan.generation
            assert isinstance(placed.id_bits, tlookup.IdentSharded)
            np.testing.assert_array_equal(_whole(placed.id_bits), _whole(mt.tables.id_bits))
            np.testing.assert_array_equal(
                _whole(placed.id_bits), np.asarray(p.pj._placed_pm[d][2].id_bits))
            for f in ("col_ep", "col_port", "col_proto", "col_is_l3"):
                np.testing.assert_array_equal(_whole(getattr(placed, f)),
                                              _whole(getattr(mj.tables, f)))
            rgen, rsrc, rplaced = p.pt._placed_rt[d]
            assert rsrc is mt.rule_tab
            np.testing.assert_array_equal(_whole(rplaced), mt.rule_tab.numpy().view(np.uint32))
        _g, src, sel = p.pt._placed_sel
        np.testing.assert_array_equal(_whole(sel), src.numpy().view(np.uint32))
        np.testing.assert_array_equal(_whole(sel), np.asarray(p.pj._placed_sel[2]))

    placed_equal()
    added = _alloc(p, 0)
    kept.append(p.rebuild())
    placed_equal()
    _add_rule(p, [apps[0]], ["k8s:team=t1", "k8s:env=dev"], label="k8s:policy=s1")
    kept.append(p.rebuild())
    placed_equal()
    _add_rule(p, [apps[-1]], ["k8s:app=a2"], port=80, label="k8s:policy=s2")
    kept.append(p.rebuild())
    placed_equal()
    _release(p, added)
    kept.append(p.rebuild())
    placed_equal()
    _alloc(p, 1)
    kept.append(p.rebuild())
    placed_equal()
    assert sum(kept) >= 4, kept
    assert sel_patches  # the row events patched the placed sel_match


def test_mesh_2d_toggles_off_and_gauges():
    """set_mesh_2d(False) re-forms the 1D grid ({"flows": 8}); the
    placement state and the table-bytes / axis gauges follow JAX's on
    each plan, and the verdicts stay those of the unplaced pipeline."""
    m = Mesh(3)

    def gauges(mod):
        out = {}
        for name in ("mesh_axis_size", "sharded_table_bytes", "device_table_bytes"):
            out[name] = dict(getattr(mod, name).series())
        return out

    def same_state(axis=True):
        """placement_state and the gauges after a rebuild of each (the
        axis gauge moves on a plan change; the unplaced pipeline built
        last moved the port's before the first toggle)."""
        sj, st = m.j.placement_state(), m.t.placement_state()
        assert st == sj
        m.j.rebuild()
        want = gauges(jmetrics)
        m.t.rebuild()
        got = gauges(tmetrics)
        if not axis:
            del want["mesh_axis_size"], got["mesh_axis_size"]
        # device_table_bytes: the series of this plan's placement (the
        # other label stays from earlier rebuilds, the unplaced one's too)
        here = "ident-sharded" if st["ident_sharded"] else "replicated"
        for d in (want, got):
            d["device_table_bytes"] = {
                k: v for k, v in d["device_table_bytes"].items()
                if dict(k)["placement"] == here or dict(k)["family"] == "lpm_trie"}
        assert got == want
        return st

    st = same_state(axis=False)
    assert st["axes"] == {"flows": 4, "ident": 2} and st["ident_sharded"]
    gen = st["generation"]
    for pipe in (m.j, m.t):
        pipe.set_mesh_2d(False)
    st = same_state()
    assert st["axes"] == {"flows": 8} and not st["ident_sharded"]
    assert st["generation"] == gen + 1 and m.t._placed.generation == gen + 1
    assert not m.t._placed.ident2d
    assert isinstance(m.t._placed_pm[INGRESS][2].id_bits, tlookup.Replicated)
    for fam in (4, 6):
        m.run(fam, m.flows(fam, 128, 1))
    for pipe in (m.j, m.t):
        pipe.set_sharding(False)
    st = same_state()
    assert st["axes"] == {} and m.t._placed is None
    m.run(4, m.flows(4, 64, 2))
    m.counters_equal()


def test_off_path_never_invokes_ident_gather(monkeypatch):
    """With MeshSharding2D off the ident gather is unreachable, and so is
    the in-place shard read (local_row_shards): the 1D sharded and the
    unsharded pipelines, rebuild and dispatch."""
    def boom(*a, **k):
        raise AssertionError("ident gather invoked with 2D off")

    monkeypatch.setattr(tlookup, "ident_gather_rows", boom)
    monkeypatch.setattr(tlookup, "local_row_shards", boom)
    m = Mesh(3, mesh_2d=False)
    assert m.t._plan.axes == {"flows": 8} and not m.t._placed.ident2d
    for seed in (40, 41):
        m.run(4, m.flows(4, 192, seed))
        m.run(6, m.flows(6, 192, seed))
    m.counters_equal()


def test_placed_pipeline_needs_devices_of_its_own_type(monkeypatch):
    """A CPU pipeline never places on a card: a plan of CUDA records
    raises on rebuild; the constructor takes every placement argument."""
    w = build_world("cilium_tpu_torch", 0)
    eng = _mod("cilium_tpu_torch", "engine").PolicyEngine(w.repo, w.reg, device="cpu")
    tpipe = _mod("cilium_tpu_torch", "datapath.pipeline")
    pipe = tpipe.DatapathPipeline(eng, w.ipcache, sharding=True, mesh_2d=True,
                                  placement=tplace.PlacementConfig(device_ids=(0, 1)), device="cpu")
    pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
    pipe.rebuild()
    assert pipe.placement_state()["devices"] == [0, 1]
    assert pipe._plan.axes == {"flows": 1, "ident": 2}
    v, r = pipe.process(*random_flows(w, 64, N_EPS, 3))
    assert v.shape == (64,)
    monkeypatch.setattr(tplace, "visible_devices", lambda: [
        tplace.DeviceRecord(i, 0, torch.device("cuda", 0)) for i in range(2)])
    pipe.set_mesh_2d(False)
    with pytest.raises(ValueError, match="placement device"):
        pipe.rebuild()
