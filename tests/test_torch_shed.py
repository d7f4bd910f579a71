"""Port parity: the admission gate's prefilter shed walk (K11
``shed_walk``) and the host code it needs.

- ``flow_class`` is operator-only math: the same law on numpy, on torch
  tensors and on jnp arrays.
- ``compile_shed_table`` of both packages gives the same ``[N, 9]``
  table from the same realized policy, and the port's copy passes the
  reference's own cases.
- ``shed_flows_wide`` / ``shed_flows`` on the CPU (the plain versions
  of K11's two entries) equal JAX's on every lane, with tables built
  by either package, except one named case: an index ``row * 9 + cls``
  past the table, where JAX's uint8 ``jnp.take`` fills 255 and sheds
  and the port does not (ROADMAP queue C).
- ``shed_flows``' stride-8 walk where the row's layout matters: the
  plain version against JAX, bit for bit, on synthetic tries at K 0 to
  16 and levels 8 / 12 / 16 with the mismatch in each byte 0-15 (both
  sides of byte 8, where a 64-byte int32 row's second 32-byte sector
  starts), on the gate's deny-heavy mix, and with bytes outside
  [0, 255] in either half of the row (ROADMAP queue C's first
  reference fault, named), at view offsets that take each route.
- ``AdmissionController``'s AIMD and accounting on the port's copy.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import admission as jadm
from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ipcache.prefilter import PreFilter as JaxPreFilter
from cilium_tpu_torch.convert import shed_table_from_numpy
from cilium_tpu_torch.datapath import admission as tadm
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from cilium_tpu_torch.ipcache.prefilter import PreFilter as TorchPreFilter
from cilium_tpu_torch.ops import lpm as tlpm
from cilium_tpu_torch.ops import shed as tshed
from cilium_tpu_torch.ops.lpm import ipv6_to_bytes, lpm_stride8_plain, lpm_wide_plain
from test_torch_harness import build_world, random_flows
from test_torch_pipeline_v6 import add_v6

N_EPS = 6
INGRESS = 0  # TRAFFIC_INGRESS in both packages
# dports across the three buckets and their edges, negatives included
DPORTS = np.array([-1, 0, 22, 53, 80, 443, 1023, 1024, 8080, 32767, 32768, 40000, 65535],
                  np.int32)
PROTOS = np.array([0, 1, 6, 17, 47, 132, 255], np.int32)


def shed_pipelines(seed: int, deny=()):
    """One pipeline per package over the same world (with v6 peers),
    Prefilter shed on, rebuilt → (jax pipe, port pipe, v4 peers, v6
    peers)."""
    wj = build_world("cilium_tpu", seed)
    wt = build_world("cilium_tpu_torch", seed)
    peers6 = add_v6(wj)
    assert add_v6(wt) == peers6
    pfj, pft = JaxPreFilter(), TorchPreFilter()
    for pf in (pfj, pft):
        if deny:
            pf.insert(pf.revision, list(deny))
    pj = jpipe.DatapathPipeline(JaxEngine(wj.repo, wj.reg), wj.ipcache, pfj,
                                prefilter_shed=True)
    pt = tpipe.DatapathPipeline(TorchEngine(wt.repo, wt.reg, device="cpu"), wt.ipcache, pft,
                                prefilter_shed=True, device="cpu")
    eps = [i.id for i in wj.idents[:N_EPS]]
    pj.set_endpoints(eps)
    pt.set_endpoints(eps)
    pj.rebuild()
    pt.rebuild()
    return pj, pt, wj, peers6


def mixed_classes(n: int, seed: int):
    rs = np.random.default_rng(seed)
    return rs.choice(DPORTS, n).astype(np.int32), rs.choice(PROTOS, n).astype(np.int32)


# ---------------------------------------------------------------------------
def test_flow_class_numpy_torch_jnp():
    d, p = np.meshgrid(DPORTS, PROTOS)
    d, p = d.ravel(), p.ravel()
    host = tadm.flow_class(d, p)
    np.testing.assert_array_equal(host, jadm.flow_class(d, p))
    on_torch = tadm.flow_class(torch.from_numpy(d), torch.from_numpy(p))
    assert isinstance(on_torch, torch.Tensor)
    np.testing.assert_array_equal(on_torch.numpy(), host)
    np.testing.assert_array_equal(np.asarray(jadm.flow_class(jnp.asarray(d), jnp.asarray(p))), host)
    # the shed walk's own copy of the law (ops does not import datapath)
    np.testing.assert_array_equal(
        tshed._flow_class(torch.from_numpy(d), torch.from_numpy(p)).numpy(), host)
    assert tshed.N_SHED_CLASSES == tadm.N_SHED_CLASSES
    # the reference's known cells
    for dport, proto, want in ((80, 6, 0), (8080, 6, 1), (40000, 6, 2), (53, 17, 3),
                               (8080, 17, 4), (40000, 17, 5), (500, 47, 6), (2000, 47, 7),
                               (65535, 132, 8), (0, 6, 0)):
        assert int(tadm.flow_class(dport, proto)) == want


# the reference's TestCompileShedTable cases (tests/test_overload.py),
# run through both packages' compile_shed_table
COMPILE_CASES = {
    "column_coverage": (
        np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0]], bool),
        [[(80, 6), (0, 17)], []],
        [[0] * 9, [0, 1, 1, 1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0, 1, 1, 1], [1] * 9],
    ),
    "wildcard_proto": (np.array([[False, True]]), [[(443, 0)]], [[0, 1, 1, 0, 1, 1, 0, 1, 1]]),
    "port_wildcard": (np.array([[False, True]]), [[(0, 6)]], [[0, 0, 0, 1, 1, 1, 1, 1, 1]]),
    "unknown_proto": (np.array([[False, True]]), [[(500, 47)]], [[1, 1, 1, 1, 1, 1, 0, 1, 1]]),
    "merged_over_endpoints": (
        np.array([[0, 1, 0, 1], [0, 0, 0, 0]], bool), [[(80, 6)], [(0, 0)]], [[0] * 9, [1] * 9],
    ),
    "no_endpoints": (np.zeros((3, 0), bool), [], [[0] * 9] * 3),
}


@pytest.mark.parametrize("case", sorted(COMPILE_CASES))
def test_compile_shed_table_reference_cases(case):
    allow, ep_slots, want = COMPILE_CASES[case]
    got = tadm.compile_shed_table(allow, ep_slots)
    assert got.dtype == np.uint8 and got.shape == (allow.shape[0], tadm.N_SHED_CLASSES)
    np.testing.assert_array_equal(got, np.array(want, np.uint8))
    np.testing.assert_array_equal(got, jadm.compile_shed_table(allow, ep_slots))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compile_shed_table_matches_jax_on_worlds(seed):
    """Each package compiles its own realized ingress policymap: the
    tables are equal, shed something, and every identity row with an
    L3-only allow column is unsheddable."""
    pj, pt, _w, _p6 = shed_pipelines(seed)
    mj, mt = pj._mat[INGRESS], pt._mat[INGRESS]
    np.testing.assert_array_equal(np.asarray(mt.allow_nc), np.asarray(mj.allow_nc))
    assert mt.ep_slots == mj.ep_slots
    tab = tadm.compile_shed_table(mt.allow_nc, mt.ep_slots)
    np.testing.assert_array_equal(tab, jadm.compile_shed_table(mj.allow_nc, mj.ep_slots))
    np.testing.assert_array_equal(pt._shed_tab.numpy(), np.asarray(pj._dp_state[7]))
    assert tab.any() and not tab.all()
    col = 0
    for slots in mt.ep_slots:
        l3 = np.asarray(mt.allow_nc[:, col], bool)
        col += 1 + len(slots)
        assert not tab[l3].any()


def _jax_masks(pj, peer4, peer6, dp, pr, shed_tab=None):
    tab = pj._dp_state[7] if shed_tab is None else jnp.asarray(shed_tab)
    m4 = jpipe.shed_flows_wide(pj._dp_state[0][(INGRESS, 4)], tab, jnp.asarray(peer4),
                               jnp.asarray(dp), jnp.asarray(pr))
    m6 = jpipe.shed_flows(pj._dp_state[0][(INGRESS, 6)], tab, jnp.asarray(peer6),
                          jnp.asarray(dp), jnp.asarray(pr), levels=16)
    return np.asarray(m4), np.asarray(m6)


def _port_masks(pt, peer4, peer6, dp, pr, shed_tab):
    args = [torch.from_numpy(a) for a in (dp, pr)]
    m4 = tpipe.shed_flows_wide(pt._tables[(INGRESS, 4)], shed_tab,
                               torch.from_numpy(peer4.view(np.int32)), *args)
    m6 = tpipe.shed_flows(pt._tables[(INGRESS, 6)], shed_tab, torch.from_numpy(peer6), *args,
                          levels=16)
    assert m4.dtype == torch.bool and m6.dtype == torch.bool
    return m4.numpy(), m6.numpy()


@pytest.mark.parametrize("seed,deny", [(0, ()), (1, ()), (2, ("172.16.0.0/28", "fd00::1:0/124"))])
def test_shed_flows_plain_matches_jax(seed, deny):
    """K11's plain versions against JAX's shed_flows_wide / shed_flows,
    on the same flows (identity peers, CIDR peers, the world; every
    proto / dport bucket edge), with the port's own table and with the
    JAX package's table converted by ``shed_table_from_numpy``. A deny
    set does not change the walk: shedding reads the identity trie."""
    pj, pt, w, peers6 = shed_pipelines(seed, deny)
    peer4, _ep, _dp, _pr = random_flows(w, 600, N_EPS, seed + 40)
    peer6 = ipv6_to_bytes(peers6)[np.random.default_rng(seed).integers(0, len(peers6), 600)]
    dp, pr = mixed_classes(600, seed)
    want4, want6 = _jax_masks(pj, peer4, peer6, dp, pr)
    assert want4.any() and not want4.all() and want6.any() and not want6.all()
    for tab in (pt._shed_tab, shed_table_from_numpy(np.asarray(pj._dp_state[7]), "cpu")):
        got4, got6 = _port_masks(pt, peer4, peer6, dp, pr, tab)
        np.testing.assert_array_equal(got4, want4)
        np.testing.assert_array_equal(got6, want6)


def test_shed_walk_plain_versions_and_refusals():
    """The wrappers take their plain versions on CPU tensors, and refuse
    a table of the wrong width or ragged flows."""
    _pj, pt, w, _p6 = shed_pipelines(0)
    t = pt._tables[(INGRESS, 4)]
    peer4, _ep, dp, pr = random_flows(w, 64, N_EPS, 3)
    args = (torch.from_numpy(peer4.view(np.int32)), torch.from_numpy(dp), torch.from_numpy(pr))
    tries = (t.ip_root_info, t.ip_root_child, t.ip_sub_child, t.ip_sub_info)
    np.testing.assert_array_equal(
        tshed.shed_walk_wide(*tries, pt._shed_tab, t.world_row, *args).numpy(),
        tshed.shed_walk_wide_plain(*tries, pt._shed_tab, t.world_row, *args).numpy())
    with pytest.raises(ValueError, match=r"\[N, 9\]"):
        tshed.shed_walk_wide(*tries, pt._shed_tab[:, :8], t.world_row, *args)
    with pytest.raises(ValueError, match="length"):
        tshed.shed_walk_wide(*tries, pt._shed_tab, t.world_row, args[0], args[1][:5], args[2])


def _rows(pt, peer4, peer6):
    """Each flow's identity row through the port's plain walks."""
    out = []
    for fam in (4, 6):
        t = pt._tables[(INGRESS, fam)]
        if fam == 4:
            hit = lpm_wide_plain(t.ip_root_info, t.ip_root_child, t.ip_sub_child,
                                 t.ip_sub_info, torch.from_numpy(peer4.view(np.int32)))
        else:
            hit = lpm_stride8_plain(t.ip_child, t.ip_info, t.ip_common, torch.from_numpy(peer6),
                                    16)
        out.append(np.where(hit.numpy() > 0, hit.numpy() - 1, t.world_row))
    return out


def test_out_of_range_row_does_not_shed():
    """The one named divergence (ROADMAP queue C). A table cut short of
    the rows the tries give makes their values point past it: JAX's
    uint8 ``jnp.take`` fills those indices with 255 and sheds every such
    lane, the port sheds none of them. Every other lane is equal."""
    pj, pt, w, peers6 = shed_pipelines(0)
    peer4, _ep, _dp, _pr = random_flows(w, 600, N_EPS, 77)
    peer6 = ipv6_to_bytes(peers6)[np.random.default_rng(77).integers(0, len(peers6), 600)]
    dp, pr = mixed_classes(600, 77)
    rows4, rows6 = _rows(pt, peer4, peer6)
    # cut at the median row the v4 identity peers reach: lanes of both
    # families fall on each side
    cut = int(np.median(np.unique(np.concatenate([rows4, rows6]))))
    short = np.asarray(pj._dp_state[7])[:cut]
    want4, want6 = _jax_masks(pj, peer4, peer6, dp, pr, shed_tab=short)
    got4, got6 = _port_masks(pt, peer4, peer6, dp, pr, shed_table_from_numpy(short, "cpu"))
    for want, got, row in ((want4, got4, rows4), (want6, got6, rows6)):
        past = row >= cut
        assert past.any() and (~past).any()
        assert want[past].all(), "JAX sheds every lane past the table"
        assert not got[past].any(), "the port sheds no lane past the table"
        np.testing.assert_array_equal(got[~past], want[~past])



# ---------------------------------------------------------------------------
# the stride-8 walk at K, levels and the byte a mismatch sits in
# ---------------------------------------------------------------------------

FAR = 1 << 24  # a byte value past every table: jnp.take fills
N_ROWS = 64  # shed table rows of the synthetic cases
WORLD_ROW = 5
K_LEVELS = [(k, lv) for lv in (8, 12, 16) for k in (0, 7, 8, 9, 13, 16) if k <= lv]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _view(a: np.ndarray, elems_in: int) -> torch.Tensor:
    """``a`` as a contiguous view ``elems_in`` elements into a buffer."""
    buf = np.zeros(a.size + elems_in + 1, a.dtype)
    buf[elems_in:elems_in + a.size] = a.reshape(-1)
    view = torch.from_numpy(buf)[elems_in:elems_in + a.size].view(a.shape)
    assert view.is_contiguous() and torch.equal(view, _t(a))
    return view


def _case(seed: int, k: int):
    """A trie over address bytes k.. of 40 prefixes that share ``base[:k]``
    (tails 1 to 16 - k bytes long, values 0 .. N_ROWS - 1: rows of the
    table), its ``common`` = ``base[:k]``, and the prefixes' full
    16-byte addresses."""
    rs = np.random.default_rng(seed)
    base = rs.integers(0, 256, 16)
    t = tlpm.TrieBuilder(max(16 - k, 1))
    stored = []
    for _ in range(40 if k < 16 else 0):
        a = base.copy()
        a[k:] = rs.integers(0, 256, 16 - k)
        tail = int(rs.integers(1, 16 - k + 1))
        t.insert(bytes(int(x) for x in a[k:]), 8 * tail, int(rs.integers(0, N_ROWS)))
        stored.append(a)
    child, info = t.arrays()
    stored = np.array(stored or [base], np.int32)
    return child, info, base[:k].astype(np.int32), stored


def _mismatch_addresses(rs, stored: np.ndarray) -> np.ndarray:
    """Each stored address as it is, then with its byte j changed, for
    every j in 0-15: both sides of byte 8."""
    rows = [stored]
    for j in range(16):
        a = stored.copy()
        a[:, j] = (a[:, j] + rs.integers(1, 256, a.shape[0])) % 256
        rows.append(a)
    return np.concatenate(rows).astype(np.int32)


def _classes(rs, b: int):
    dport = rs.choice(np.array([-1, 0, 80, 1023, 1024, 8080, 32767, 32768, 65535], np.int32), b)
    proto = rs.choice(np.array([0, 6, 17, 132], np.int32), b)
    return dport.astype(np.int32), proto.astype(np.int32)


def _table(seed: int, n_rows: int = N_ROWS) -> np.ndarray:
    tab = (np.random.default_rng(seed).random((n_rows, 9)) < 0.5).astype(np.uint8)
    tab[WORLD_ROW] = 1  # the world sheds in every class
    return tab


def _jax_shed(child, info, common, tab, addr, dport, proto, levels):
    arrays = dict(ip_child=child, ip_info=info, ip_common=common)
    jt = jpipe.DatapathTables(
        **{f"{p}_{n}": jnp.asarray(arrays[f"ip_{n}"]) for p in ("pf", "ip", "merged")
           for n in ("child", "info", "common")},
        world_row=jnp.int32(WORLD_ROW), policymap=None,
    )
    return np.asarray(jpipe.shed_flows(jt, jnp.asarray(tab), jnp.asarray(addr),
                                       jnp.asarray(dport), jnp.asarray(proto), levels=levels))


def _port_shed(child, info, common, tab, addr, dport, proto, levels):
    got = tshed.shed_walk_stride8_plain(_t(child), _t(info), _t(common), _t(tab), WORLD_ROW,
                                        addr if isinstance(addr, torch.Tensor) else _t(addr),
                                        _t(dport), _t(proto), levels)
    assert got.dtype == torch.bool
    return got.numpy()


@pytest.mark.parametrize("k, levels", K_LEVELS)
def test_mismatch_in_each_byte_matches_jax(k, levels):
    """A stored address with one byte changed, in each byte 0-15: in the
    compared part the lane matches nothing (the world row), in the
    walked part the walk leaves the prefix there, past ``levels`` the
    byte is never read. Equal to JAX on every lane, on the aligned
    layout and on views 1, 4 and 8 int32 in."""
    child, info, common, stored = _case(100 * k + levels, k)
    rs = np.random.default_rng(k + levels)
    addr = _mismatch_addresses(rs, stored)
    dport, proto = _classes(rs, addr.shape[0])
    tab = _table(k)
    want = _jax_shed(child, info, common, tab, addr, dport, proto, levels)
    for elems_in in (0, 1, 4, 8):
        got = _port_shed(child, info, common, tab, _view(addr, elems_in), dport, proto, levels)
        np.testing.assert_array_equal(got, want)
    # both answers occur where a level is walked, and a change in the
    # compared part always sheds as the world does
    assert want.any() and (k == levels or not want.all())
    n = stored.shape[0]
    for j in range(min(k, 16)):
        lanes = slice((j + 1) * n, (j + 2) * n)
        np.testing.assert_array_equal(
            want[lanes], tab[WORLD_ROW][tshed._flow_class(_t(dport[lanes]), _t(proto[lanes]))
                                        .numpy()] != 0)


def _deny_heavy(seed: int, b: int, n_idents: int):
    """chip_smoke's gate batch at ``b`` flows: make_flows6's peers
    (fd00::{hi}:{lo} over the identities, 1/16 in 2001:db8::/32), then
    3/4 of them moved to 2001:db8::/32 (chip_smoke.deny_heavy)."""
    rs = np.random.default_rng(seed)
    i_sel = rs.integers(0, n_idents, b)
    addr = np.zeros((b, 16), np.int32)
    addr[:, 0] = 0xFD
    addr[:, 13] = (i_sel >> 8) & 255
    addr[:, 15] = i_sel & 255
    world = (rs.random(b) < 1 / 16) | (rs.random(b) < 0.75)
    addr[world] = rs.integers(0, 256, (int(world.sum()), 16))
    addr[world, :4] = (0x20, 0x01, 0x0D, 0xB8)
    dport = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), b).astype(np.int32)
    proto = np.where(dport == 53, 17, 6).astype(np.int32)
    return addr, dport, proto, world


@pytest.mark.parametrize("trie", ["identity", "edge"])
def test_deny_heavy_mix_matches_jax(trie):
    """The gate's deny-heavy mix at 4 097 flows over the bench's
    identity trie (K 13 elided bytes from 0xFD: a world lane fails its
    compare on byte 0) and with 2000::/3 added (K 0: every lane walks
    from byte 0)."""
    n_idents = 600
    ident = [(f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128", i % N_ROWS) for i in range(n_idents)]
    extra = [("2000::/3", WORLD_ROW + 1)] if trie == "edge" else []
    child, info, common = tlpm.build_trie_elided(ident + extra)
    assert common.shape[0] == (13 if trie == "identity" else 0)
    addr, dport, proto, world = _deny_heavy(4097, 4097, n_idents)
    assert 0.7 < world.mean() < 0.85
    tab = _table(3)
    want = _jax_shed(child, info, common, tab, addr, dport, proto, 16)
    for elems_in in (0, 4, 8):
        got = _port_shed(child, info, common, tab, _view(addr, elems_in), dport, proto, 16)
        np.testing.assert_array_equal(got, want)
    assert want[world].all() if trie == "identity" else want.any()
    assert not want.all()


@pytest.mark.parametrize("sector", ["first", "second"])
@pytest.mark.parametrize("k, levels", [(0, 16), (7, 16), (8, 16), (13, 16), (9, 12)])
def test_out_of_range_bytes_by_sector(sector, k, levels):
    """Bytes outside [0, 255] in one 32-byte sector of the row (bytes
    0-7 or 8-15). In the K compared bytes they match nothing, as in JAX.
    In the walked bytes the port ends the walk where JAX's ``jnp.take``
    may read another node's slot (ROADMAP queue C's first reference
    fault): JAX's answer with each such walked byte moved to FAR, every
    lane compared."""
    child, info, common, stored = _case(7 * k + levels + (sector == "second"), k)
    rs = np.random.default_rng(k * 31 + levels)
    addr = _mismatch_addresses(rs, stored)
    cols = slice(0, 8) if sector == "first" else slice(8, 16)
    bad = np.zeros(addr.shape, bool)
    bad[:, cols] = rs.random((addr.shape[0], 8)) < 0.08
    vals = rs.choice(np.array([-1, -7, 256, 300, 1 << 20, -(1 << 20)], np.int32), addr.shape)
    raw = np.where(bad, vals, addr).astype(np.int32)
    walked = bad.copy()
    walked[:, :k] = False
    far = np.where(walked, FAR, raw).astype(np.int32)
    dport, proto = _classes(rs, addr.shape[0])
    tab = _table(k + 1)
    want = _jax_shed(child, info, common, tab, far, dport, proto, levels)
    for elems_in in (0, 4, 8):
        got = _port_shed(child, info, common, tab, _view(raw, elems_in), dport, proto, levels)
        np.testing.assert_array_equal(got, want)
    assert bad.any(axis=1).sum() > 50


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """The stride-8 wrapper on CPU tensors gives the plain version's mask
    at every view offset, records no route, and refuses K past
    ``levels``."""
    child, info, common, stored = _case(5, 13)
    rs = np.random.default_rng(5)
    addr = _mismatch_addresses(rs, stored)
    dport, proto = _classes(rs, addr.shape[0])
    tab = _t(_table(5))
    tlpm.STRIDE8_ROUTES.pop("shed_walk_stride8", None)
    for elems_in in (0, 1, 4, 8):
        args = (_t(child), _t(info), _t(common), tab, WORLD_ROW, _view(addr, elems_in),
                _t(dport), _t(proto))
        np.testing.assert_array_equal(tshed.shed_walk_stride8(*args, 16).numpy(),
                                      tshed.shed_walk_stride8_plain(*args, 16).numpy())
    assert "shed_walk_stride8" not in tlpm.STRIDE8_ROUTES
    with pytest.raises(ValueError, match="stride-8"):
        tshed.shed_walk_stride8(_t(child), _t(info), _t(common), tab, WORLD_ROW, _t(addr),
                                _t(dport), _t(proto), 12)


# the reference's TestAdmissionController cases on the port's copy
def test_admission_aimd_halve_and_regrow():
    c = tadm.AdmissionController(max_depth=8)
    assert c.limit == 8.0
    assert not c.over_budget(6)
    assert c.over_budget(8)
    c.note_queue_full()
    assert c.limit == 4.0
    assert c.over_budget(4) and not c.over_budget(3)
    prev = c.limit
    for _ in range(64):
        c.observe_completion(0.001)
        assert c.limit >= prev
        prev = c.limit
    assert c.limit == 8.0


def test_admission_deadline_overrun_halves():
    c = tadm.AdmissionController(max_depth=4, deadline_ms=10.0)
    c.observe_completion(0.05)
    assert c.limit == 2.0
    assert c.snapshot()["ewma_completion_ms"] == pytest.approx(50.0)


def test_admission_littles_law_projection():
    c = tadm.AdmissionController(max_depth=8, deadline_ms=100.0)
    c._ewma_s = 0.04
    assert not c.over_budget(1)
    assert c.over_budget(2)


def test_admission_shed_accounting_and_armistice():
    c = tadm.AdmissionController(max_depth=4)
    assert not c.shedding()
    c.note_admitted(50)
    c.note_shed("prefilter", 30)
    c.note_shed("deadline", 20)
    assert c.shedding()
    snap = c.snapshot()
    assert snap["shed"] == {"prefilter": 30, "deadline": 20}
    assert snap["admitted_flows"] == 50
    assert snap["shed_ratio"] == pytest.approx(0.5)
    assert snap["shedding"] is True
