"""Port parity: the pipeline's O(delta) rebuild — identity row patches
and rule column patches routed from the engine's delta log — against
the JAX package's.

The same world (``build_world`` plus one IPv6 /128 per identity) goes
through both packages' engines and DatapathPipelines, and the same
mutation sequence is applied to each. After every rebuild the port
must equal the JAX pipeline bit for bit: both directions' materialized
state (``allow_nc``, ``red_nc``, ``rule_nc``, the packed
``tables.id_bits``, ``rule_tab``, the slot layout), every endpoint's
policymap snapshot, and the verdicts, redirects and counters of
``process()`` / ``process_v6()`` on the same flows; both must patch in
place on the same steps and re-materialize on the same fallbacks.
Tolerance 0: every compared value is an integer or a bool. The
port-only cases hold the CT flush, the shed table, the kept tries, the
functional updates, an in-flight batch and the ``placed=`` copies.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu.datapath.admission import compile_shed_table as jax_compile_shed_table
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath.admission import compile_shed_table
from cilium_tpu_torch.ops import materialize as tmat
from test_torch_harness import PKGS, build_world, random_flows
from test_torch_incremental import _labels, _rule
from test_torch_pipeline_v6 import add_v6, v6_flows

N_EPS = 6
INGRESS, EGRESS = 0, 1


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _words(a):
    """Packed words (an int32 bit-view tensor or a JAX uint32 array) as
    uint32 numpy."""
    return a.numpy().view(np.uint32) if isinstance(a, torch.Tensor) else np.asarray(a)


def _entries(snaps):
    return [{(k.identity, k.dport, k.nexthdr, k.direction): v for k, v in s.entries.items()}
            for s in snaps]


class Pipes:
    """One world, engine and pipeline per package; ``kw`` goes to both
    pipeline constructors."""

    def __init__(self, seed: int, *, endpoints: int = N_EPS, **kw):
        self.w = {pkg: build_world(pkg, seed) for pkg in PKGS}
        peers = [add_v6(self.w[pkg]) for pkg in PKGS]
        assert peers[0] == peers[1]
        self.peers6 = peers[0]
        self.eng, self.pipe = {}, {}
        for pkg in PKGS:
            w = self.w[pkg]
            dev = {} if pkg == "cilium_tpu" else {"device": "cpu"}
            self.eng[pkg] = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **dev)
            self.pipe[pkg] = _mod(pkg, "datapath.pipeline").DatapathPipeline(
                self.eng[pkg], w.ipcache, _mod(pkg, "ipcache.prefilter").PreFilter(), **kw, **dev)
            self.pipe[pkg].set_endpoints([i.id for i in w.idents[:endpoints]])
        self.n_eps = endpoints
        self.step = 0

    def each(self, fn):
        return {pkg: fn(pkg, self.w[pkg]) for pkg in PKGS}

    @property
    def pt(self):
        return self.pipe["cilium_tpu_torch"]

    @property
    def pj(self):
        return self.pipe["cilium_tpu"]

    def rebuild(self):
        """Rebuild both → whether each package kept its ``_mat`` objects
        (patched in place); checked equal across packages."""
        kept = {}
        for pkg, pipe in self.pipe.items():
            base = dict(pipe._mat)
            pipe.rebuild()
            kept[pkg] = bool(base) and all(pipe._mat.get(d) is base[d] for d in base)
        assert kept["cilium_tpu"] == kept["cilium_tpu_torch"], kept
        self.check()
        return kept["cilium_tpu_torch"]

    def check(self):
        self.step += 1
        for d in (INGRESS, EGRESS):
            mj, mt = self.pj._mat[d], self.pt._mat[d]
            assert mt.ep_slots == mj.ep_slots and mt.n_cols == mj.n_cols
            np.testing.assert_array_equal(mt.allow_nc, mj.allow_nc)
            np.testing.assert_array_equal(mt.red_nc, mj.red_nc)
            np.testing.assert_array_equal(_words(mt.tables.id_bits), _words(mj.tables.id_bits))
            assert (mt.rule_nc is None) == (mj.rule_nc is None)
            if mt.rule_nc is not None:
                np.testing.assert_array_equal(mt.rule_nc, mj.rule_nc)
                np.testing.assert_array_equal(mt.rule_tab.numpy(), np.asarray(mj.rule_tab))
            assert _entries(self.pt.snapshots(d == INGRESS)) == _entries(self.pj.snapshots(d == INGRESS))
        wj = self.w["cilium_tpu"]
        for pipe in self.pipe.values():
            pipe.counters[:] = 0  # the counters of this check's batches only
        for ingress in (True, False):
            f4 = random_flows(wj, 600, self.n_eps, 100 * self.step + ingress)
            f6 = v6_flows(self.peers6, 400, 100 * self.step + 7 + ingress)
            f6 = (f6[0], f6[1] % self.n_eps, *f6[2:])
            for call, flows in (("process", f4), ("process_v6", f6)):
                got = getattr(self.pt, call)(*flows, ingress=ingress)
                want = getattr(self.pj, call)(*flows, ingress=ingress)
                for g, x in zip(got, want):
                    np.testing.assert_array_equal(g, np.asarray(x), err_msg=call)
        np.testing.assert_array_equal(self.pt.counters, self.pj.counters)


def _alloc(p: Pipes, j: int):
    """A new identity with an ipcache entry, in both packages."""
    def go(pkg, w):
        ident = w.reg.allocate(_labels(pkg, [f"k8s:app=a{j % 8}", f"k8s:team=t{j % 4}",
                                             f"k8s:env={'prod' if j % 2 else 'dev'}"]))
        w.ipcache.upsert(f"172.16.200.{j + 1}/32", ident.id, source="k8s")
        return ident
    return p.each(go)


def _release(p: Pipes, idents):
    p.each(lambda pkg, w: w.reg.release(idents[pkg]))


def _add_rule(p: Pipes, *args, **kw):
    p.each(lambda pkg, w: w.repo.add_list([_rule(pkg, *args, **kw)]))


def _delete(p: Pipes, label: str):
    return p.each(lambda pkg, w: w.repo.delete_by_labels(_labels(pkg, [label]))[1])


def _delta_count(kind="delta"):
    return {pkg: m.engine_refresh_seconds.get_count({"kind": kind})
            for pkg, m in (("cilium_tpu", jmetrics), ("cilium_tpu_torch", tmetrics))}


# -- patches and fallbacks against JAX ---------------------------------------

@pytest.mark.parametrize("seed", [5, 101])
def test_mutation_stream_matches_jax(seed):
    """Identity adds and releases, rule appends (L3, L4, L7, existing and
    new selectors) and deletes, one rebuild after each."""
    p = Pipes(seed)
    p.rebuild()
    d0 = _delta_count()
    # the subjects are the endpoints' apps: every append touches columns
    apps = sorted({lb for i in p.w["cilium_tpu"].idents[:N_EPS]
                   for lb in p.w["cilium_tpu"].ident_labels[i.id] if "app=" in lb})
    added = _alloc(p, 0)
    kept = [p.rebuild()]
    _add_rule(p, [apps[0]], ["k8s:team=t1"], label="k8s:policy=s1")
    kept.append(p.rebuild())
    _add_rule(p, [apps[-1]], ["k8s:app=a2"], port=80, label="k8s:policy=s2")
    kept.append(p.rebuild())
    _add_rule(p, [apps[0]], ["k8s:app=a5", "k8s:env=prod"], port=443, l7_path="/x/.*",
              label="k8s:policy=s3")
    kept.append(p.rebuild())
    _release(p, added)
    kept.append(p.rebuild())
    assert _delete(p, "k8s:policy=s2") == {pkg: 1 for pkg in PKGS}
    kept.append(p.rebuild())
    _alloc(p, 1)
    _delete(p, "k8s:policy=s1")
    kept.append(p.rebuild())
    assert sum(kept) >= 5, kept
    d1 = _delta_count()
    assert d1["cilium_tpu_torch"] - d0["cilium_tpu_torch"] == d1["cilium_tpu"] - d0["cilium_tpu"] >= 5


def test_coalesced_row_events_single_patch():
    """Adds and releases piled up between rebuilds replay as ONE
    coalesced patch per direction, one delta observation."""
    p = Pipes(9)
    primer = [_alloc(p, j) for j in range(2)]
    p.rebuild()
    rows0 = {pkg: m.engine_delta_rows_total.get()
             for pkg, m in (("cilium_tpu", jmetrics), ("cilium_tpu_torch", tmetrics))}
    for j in range(2, 5):
        _alloc(p, j)
        for e in p.eng.values():
            e.refresh()
    _release(p, primer[0])
    for e in p.eng.values():
        e.refresh()
    d0 = _delta_count()
    assert p.rebuild()
    d1 = _delta_count()
    assert {pkg: d1[pkg] - d0[pkg] for pkg in PKGS} == {pkg: 1 for pkg in PKGS}
    assert tmetrics.engine_delta_rows_total.get() - rows0["cilium_tpu_torch"] == \
        jmetrics.engine_delta_rows_total.get() - rows0["cilium_tpu"] == 4


def test_log_truncation_falls_back_to_full():
    p = Pipes(13)
    p.rebuild()
    for e in p.eng.values():
        e.DELTA_LOG_CAP = 2
    for j in range(4):
        _alloc(p, j)
        for e in p.eng.values():
            e.refresh()
    assert p.eng["cilium_tpu_torch"].deltas_since(p.pt._last_delta_seq) is None
    assert not p.rebuild()


def test_slot_growth_falls_back_to_full():
    """A rule giving an endpoint a new (port, proto) needs new columns:
    the column patch refuses and both re-materialize."""
    p = Pipes(4)
    p.rebuild()
    app = next(lb for lb in p.w["cilium_tpu"].ident_labels[p.w["cilium_tpu"].idents[0].id]
               if "app=" in lb)
    _add_rule(p, [app], ["k8s:app=a1"], port=9999)
    assert not p.rebuild()
    _add_rule(p, [app], ["k8s:app=a3"], port=9999)  # the slot exists now
    assert p.rebuild()


def test_attribution_patches_and_delete_goes_full():
    p = Pipes(6)
    for pipe in p.pipe.values():
        pipe.set_attribution(True)
    p.rebuild()
    assert p.pt._mat[INGRESS].rule_nc is not None
    app = next(lb for lb in p.w["cilium_tpu"].ident_labels[p.w["cilium_tpu"].idents[1].id]
               if "app=" in lb)
    _add_rule(p, [app], ["k8s:app=a4"], label="k8s:policy=at")
    assert p.rebuild()
    assert p.pt._attrib_n_rules == p.pj._attrib_n_rules == len(p.w["cilium_tpu_torch"].repo)
    assert p.pt._attrib_names == p.pj._attrib_names
    _alloc(p, 3)
    assert p.rebuild()
    _delete(p, "k8s:policy=at")
    assert not p.rebuild()  # every later rule's index shifts


# -- port-only ---------------------------------------------------------------

def test_ct_flushed_after_a_delta_and_kept_when_nothing_moved(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    p = Pipes(2, device_ct_bits=10)
    p.rebuild()
    flows = random_flows(p.w["cilium_tpu"], 500, N_EPS, 3)
    sports = np.random.default_rng(3).integers(1024, 65535, 500).astype(np.int32)
    pt = p.pt
    for pipe in p.pipe.values():
        pipe.process(*flows, sports=sports)
    st, epoch = pt._device_ct, pt._ct_epoch
    assert st is not None
    pt.rebuild()
    for pipe in p.pipe.values():
        pipe.process(*flows, sports=sports)
    assert pt._ct_epoch == epoch and pt._device_ct is st  # nothing moved
    epochs = {pkg: pipe._ct_epoch for pkg, pipe in p.pipe.items()}
    for step in ("rule", "row"):
        if step == "rule":
            _add_rule(p, ["k8s:app=a1"], ["k8s:app=a2"])
        else:
            _alloc(p, 0)
        assert p.rebuild()
        assert pt._device_ct is None
        moved = {pkg: pipe._ct_epoch - epochs[pkg] for pkg, pipe in p.pipe.items()}
        assert moved["cilium_tpu_torch"] == moved["cilium_tpu"] >= 1
        epochs = {pkg: pipe._ct_epoch for pkg, pipe in p.pipe.items()}
        outs = [pipe.process(*flows, sports=sports) for pipe in p.pipe.values()]
        np.testing.assert_array_equal(outs[1][0], np.asarray(outs[0][0]))
        assert pt._device_ct is not None


def test_shed_table_after_a_delta_equals_a_fresh_compile():
    p = Pipes(1, prefilter_shed=True)
    p.rebuild()
    tab0 = p.pt._shed_tab
    for mutate in (lambda: _alloc(p, 0), lambda: _add_rule(p, ["k8s:app=a0"], ["k8s:app=a6"])):
        mutate()
        assert p.rebuild()
        m = p.pt._mat[INGRESS]
        want = compile_shed_table(m.allow_nc, m.ep_slots)
        np.testing.assert_array_equal(p.pt._shed_tab.numpy(), want)
        mj = p.pj._mat[INGRESS]
        np.testing.assert_array_equal(want, jax_compile_shed_table(mj.allow_nc, mj.ep_slots))
        w = p.w["cilium_tpu_torch"]
        fresh = type(p.pt)(type(p.eng["cilium_tpu_torch"])(w.repo, w.reg, device="cpu"), w.ipcache,
                           prefilter_shed=True, device="cpu")
        fresh.set_endpoints([i.id for i in w.idents[:N_EPS]])
        fresh.rebuild()
        assert fresh._mat[INGRESS].ep_slots == m.ep_slots
        np.testing.assert_array_equal(p.pt._shed_tab.numpy(), fresh._shed_tab.numpy())
        assert p.pt._shed_tab is not tab0
        tab0 = p.pt._shed_tab


def test_rule_delta_keeps_tries_and_row_delta_rebuilds_them():
    p = Pipes(3)
    p.rebuild()
    t4, t6 = p.pt._tables[(INGRESS, 4)], p.pt._tables[(INGRESS, 6)]
    pm = t4.policymap.id_bits
    _add_rule(p, ["k8s:app=a2"], ["k8s:app=a7"])
    assert p.rebuild()
    n4, n6 = p.pt._tables[(INGRESS, 4)], p.pt._tables[(INGRESS, 6)]
    assert n4.ip_root_info is t4.ip_root_info and n6.ip_child is t6.ip_child
    assert n4.policymap.id_bits is not pm  # republished with the patched policymap
    _alloc(p, 0)
    assert p.rebuild()
    assert p.pt._tables[(INGRESS, 4)].ip_root_info is not t4.ip_root_info


def test_tensors_taken_before_a_delta_are_unchanged():
    p = Pipes(4)
    for pipe in p.pipe.values():
        pipe.set_attribution(True)
    p.rebuild()
    held = [p.pt._tables[(d, 4)].policymap.id_bits for d in (INGRESS, EGRESS)]
    held += [p.pt._rule_tabs[d] for d in (INGRESS, EGRESS)]
    _, dev = p.eng["cilium_tpu_torch"].snapshot()
    held += [dev.id_bits, dev.sel_match, dev.ingress.allow_t, dev.egress.s1_mat]
    copies = [t.clone() for t in held]
    _alloc(p, 0)
    _add_rule(p, ["k8s:app=a3"], ["k8s:app=a4"], port=80)
    assert p.rebuild()
    _add_rule(p, ["k8s:app=a5"], ["k8s:team=t2"])
    assert p.rebuild()
    assert not torch.equal(p.pt._tables[(INGRESS, 4)].policymap.id_bits, copies[0]) or \
        not torch.equal(p.pt._tables[(EGRESS, 4)].policymap.id_bits, copies[1])
    for t, c in zip(held, copies):
        assert torch.equal(t, c)


def test_batch_submitted_before_a_delta_keeps_its_verdicts():
    p = Pipes(8, pipeline_depth=2)
    p.rebuild()
    flows = random_flows(p.w["cilium_tpu"], 2000, N_EPS, 11)
    ref = Pipes(8)  # the same world, never mutated: the pre-delta verdicts
    want = ref.pt.process(*flows)
    pend = p.pt.submit(*flows)
    apps = sorted({lb for i in p.w["cilium_tpu"].idents[:N_EPS]
                   for lb in p.w["cilium_tpu"].ident_labels[i.id] if "app=" in lb})
    # every endpoint now admits every uid-labelled peer at L3
    p.each(lambda pkg, w: w.repo.add_list(
        [_rule(pkg, [app], [], peer_exprs=[("k8s:uid", "Exists")]) for app in apps]))
    _alloc(p, 0)
    for pipe in p.pipe.values():
        pipe.rebuild()
    got = pend.result()
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    after = p.pt.process(*flows)
    assert not np.array_equal(after[0], want[0])
    p.check()


def test_placed_tables_are_refused():
    """Placed tables take the same patches (``placed=`` was once
    refused, hence the name): a row patch and a column patch scatter the
    same words into the placed copies — ident-sharded ``id_bits`` and
    rule table, replicated columns on a 2 × 2 grid — which then equal
    the patched state, shard for shard. The JAX comparison of placed
    copies is in tests/test_torch_placement.py."""
    from cilium_tpu_torch.datapath import placement as tplace
    from cilium_tpu_torch.ops import lookup as tlookup

    p = Pipes(0)
    for pipe in p.pipe.values():
        pipe.set_attribution(True)
    p.rebuild()
    compiled, dev = p.eng["cilium_tpu_torch"].snapshot()
    m = p.pt._mat[INGRESS]
    grid = tuple(tuple(tplace.DeviceRecord(2 * r + k, 0, torch.device("cpu")) for k in range(2))
                 for r in range(2))
    ident = tplace.GridSharding(grid, ("ident", None))
    placed = tmat.PlacedTables(
        tlookup.shard_tables_ident(m.tables, ident, tplace.GridSharding(grid, ())),
        tlookup.shard_rows(m.rule_tab, ident))
    ao, nr = p.pt._attrib_origins(compiled)
    n = compiled.id_bits.shape[0]
    ident0 = p.w["cilium_tpu_torch"].idents[0].id
    events = [(compiled.id_to_row[ident0], ident0, True), (n - 1, 0, False)]
    tmat.patch_identity_rows(m, dev, events, attrib_origin=ao[True], n_rules=nr, placed=placed)
    sids = list(range(dev.sel_match.shape[1] * 32))
    assert tmat.patch_endpoints_state(m, compiled, dev, sids, attrib_origin=ao[True],
                                      n_rules=nr, placed=placed)
    for got, want in ((placed.tables.id_bits, m.tables.id_bits), (placed.rule_tab, m.rule_tab)):
        assert isinstance(got, tlookup.IdentSharded)
        for row in got.shards:
            assert torch.equal(torch.cat([s.tensor for s in row]), want)
    assert torch.equal(placed.tables.col_ep.on(torch.device("cpu")), m.tables.col_ep)


def test_a_delta_reads_back_only_endpoint_rows(monkeypatch):
    """The engine refresh of a delta pulls nothing from the device; the
    column patch pulls the [E, S/32] endpoint rows of sel_match and its
    own sweep results, never an [N, ·] table."""
    p = Pipes(5)
    p.rebuild()
    pulls = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        pulls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    te, pt = p.eng["cilium_tpu_torch"], p.pt
    p.w["cilium_tpu_torch"].repo.add_list([_rule("cilium_tpu_torch", ["k8s:app=a1"], ["k8s:app=a0"])])
    te.refresh()
    assert pulls == []
    base = dict(pt._mat)
    pt.rebuild()
    assert all(pt._mat[d] is base[d] for d in base)
    n_rows, s_words = te._device.sel_match.shape
    assert (N_EPS, s_words) in pulls
    assert all(s[0] != n_rows for s in pulls if s), pulls
