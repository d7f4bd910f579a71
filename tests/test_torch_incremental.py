"""Port parity: the engine's incremental refresh (identity row deltas,
rule appends and deletes in place) against the JAX package's.

The same world (``build_world``) goes through both packages' engines,
and the same mutation sequence is applied to each. After every refresh
the port must equal the JAX engine bit for bit: ``id_bits``,
``sel_match``, every ``DeviceTables`` field of both directions, the
host sel_match mirror, the ``deltas_since`` payloads, and the movement
of ``engine_refreshes_total{kind}`` (both take the incremental path on
the same steps and the full path on the same fallbacks). Verdicts of
the patched port engine also equal a fresh full compile of the port.
Tolerance 0: every compared value is an integer or a bool.
"""

from __future__ import annotations

import dataclasses
import importlib
import random

import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu_torch import engine as tengine
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from cilium_tpu_torch.ops.verdict import verdict_batch
from test_torch_harness import PKGS, build_world

KINDS = ("full", "incremental")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _labels(pkg, labels):
    return _mod(pkg, "labels").parse_label_array(labels)


def _rule(pkg, subject, peer, port=None, l7_path=None, label=None, peer_exprs=()):
    """One ingress rule from ``subject`` to ``peer`` labels, with an
    optional port, HTTP path and policy label, through ``pkg``."""
    api = _mod(pkg, "policy.api")
    exprs = tuple(api.MatchExpression(k, op) for k, op in peer_exprs)
    to_ports = ()
    if port is not None:
        l7 = api.L7Rules(http=(api.HTTPRule(path=l7_path),)) if l7_path else api.L7Rules()
        to_ports = (api.PortRule(ports=(api.PortProtocol(port, "TCP"),), rules=l7),)
    ing = api.IngressRule(
        from_endpoints=(api.EndpointSelector.make(peer, match_expressions=exprs),),
        to_ports=to_ports,
    )
    return api.rule(subject, ingress=[ing], labels=[label] if label else None)


class Pair:
    """One world per package, an engine over each, and the metric
    baselines of ``engine_refreshes_total``."""

    def __init__(self, seed: int, **kw):
        self.w = {pkg: build_world(pkg, seed, **kw) for pkg in PKGS}
        self.eng = {
            "cilium_tpu": JaxEngine(self.w["cilium_tpu"].repo, self.w["cilium_tpu"].reg),
            "cilium_tpu_torch": TorchEngine(
                self.w["cilium_tpu_torch"].repo, self.w["cilium_tpu_torch"].reg, device="cpu"),
        }
        self.base = self._counts()

    def _counts(self):
        return {
            pkg: {k: m.engine_refreshes_total.get({"kind": k}) for k in KINDS}
            for pkg, m in (("cilium_tpu", jmetrics), ("cilium_tpu_torch", tmetrics))
        }

    def each(self, fn):
        """fn(pkg, world) on both packages; returns {pkg: result}."""
        return {pkg: fn(pkg, self.w[pkg]) for pkg in PKGS}

    def refresh(self):
        for e in self.eng.values():
            e.refresh()
        self.check()

    def moved(self):
        """engine_refreshes_total{kind} movement since the pair was made
        (equal across packages, checked)."""
        now = self._counts()
        mv = {pkg: {k: now[pkg][k] - self.base[pkg][k] for k in KINDS} for pkg in PKGS}
        assert mv["cilium_tpu"] == mv["cilium_tpu_torch"], mv
        return mv["cilium_tpu_torch"]

    def kinds(self):
        return [k for _, k, _ in self.eng["cilium_tpu_torch"].deltas_since(0)]

    def check(self):
        je, te = self.eng["cilium_tpu"], self.eng["cilium_tpu_torch"]
        jd, td = je._device, te._device
        np.testing.assert_array_equal(td.id_bits.numpy().view(np.uint32), np.asarray(jd.id_bits))
        np.testing.assert_array_equal(td.sel_match.numpy().view(np.uint32), np.asarray(jd.sel_match))
        np.testing.assert_array_equal(te._sel_match_host, je._sel_match_host)
        for direction in ("ingress", "egress"):
            jt, tt = getattr(jd, direction), getattr(td, direction)
            for f in dataclasses.fields(tt):
                np.testing.assert_array_equal(
                    getattr(tt, f.name).numpy(), np.asarray(getattr(jt, f.name)),
                    err_msg=f"{direction}.{f.name}")
        assert te.deltas_since(0) == je.deltas_since(0)
        assert te.delta_seq == je.delta_seq
        jc, tc = je._compiled, te._compiled
        assert (tc.revision, tc.identity_version) == (jc.revision, jc.identity_version)
        assert tc.id_to_row == jc.id_to_row
        self.moved()

    def assert_fresh_parity(self, seed: int = 0):
        """The patched port engine's verdicts equal a fresh full compile
        of the same repository and registry."""
        w = self.w["cilium_tpu_torch"]
        te = self.eng["cilium_tpu_torch"]
        fresh = TorchEngine(w.repo, w.reg, device="cpu")
        fresh.refresh(force=True)
        self.base["cilium_tpu_torch"]["full"] += 1  # not the engine under test
        ids = [i for i in te._compiled.id_to_row if i in fresh._compiled.id_to_row]
        rs = np.random.default_rng(seed)
        b = 2048
        ia, ib = rs.integers(0, len(ids), b), rs.integers(0, len(ids), b)
        dport = rs.choice(np.array([0, 80, 443, 8080, 9100], np.int32), b)
        proto = np.full(b, 6, np.int32)
        hl4 = torch.from_numpy(dport != 0)
        outs = []
        for eng in (te, fresh):
            rows = eng.rows(ids)
            v = verdict_batch(
                eng.device_policy, torch.from_numpy(rows[ia]), torch.from_numpy(rows[ib]),
                torch.from_numpy(dport), torch.from_numpy(proto), hl4,
            )
            outs.append((v.decision.numpy(), v.l3.numpy(), v.l7_redirect.numpy()))
        for a, b_ in zip(*outs):
            np.testing.assert_array_equal(a, b_)


# -- identity deltas ----------------------------------------------------------

@pytest.mark.parametrize("case", ["add", "release", "add_release", "bucket_overflow"])
def test_identity_deltas_match_jax(case):
    p = Pair(3, n_idents=24 if case != "bucket_overflow" else 8)
    p.refresh()
    if case in ("add", "add_release"):
        added = p.each(lambda pkg, w: [
            w.reg.allocate(_labels(pkg, [f"k8s:app=a{j % 8}", f"k8s:team=t{j % 4}"]))
            for j in range(5)])
        p.refresh()
        if case == "add_release":
            p.each(lambda pkg, w: w.reg.release(added[pkg][1]))
            p.refresh()
        assert p.kinds()[0] == "full" and "rows" in p.kinds()[1:] and "full" not in p.kinds()[1:]
        assert p.moved() == {"full": 1, "incremental": 1 + (case == "add_release")}
    elif case == "release":
        victim = p.each(lambda pkg, w: w.idents[-1])
        assert all(p.each(lambda pkg, w: w.reg.release(victim[pkg])).values())
        p.refresh()
        assert p.kinds()[1:] == ["rows"]
        with pytest.raises(KeyError):
            p.eng["cilium_tpu_torch"].rows([victim["cilium_tpu_torch"].id])
        assert p.moved() == {"full": 1, "incremental": 1}
    else:  # a row-bucket crossing falls back to the full path in both
        def grow(pkg, w):
            cap, j = w.reg.padded_rows(), 0
            while w.reg.padded_rows() == cap:
                w.reg.allocate(_labels(pkg, [f"k8s:app=a{j % 8}", f"k8s:uid=u{j}"]))
                j += 1
        p.each(grow)
        p.refresh()
        assert p.kinds()[1:] == ["full"]
        assert p.moved() == {"full": 2, "incremental": 0}
    p.assert_fresh_parity()


def test_tensor_taken_before_a_delta_is_unchanged():
    """Functional updates: a (compiled, device) snapshot taken before a
    delta keeps its device values after it."""
    p = Pair(5)
    p.refresh()
    te = p.eng["cilium_tpu_torch"]
    _, before = te.snapshot()
    copies = {f.name: getattr(before.ingress, f.name).clone() for f in dataclasses.fields(before.ingress)}
    id_bits, sel = before.id_bits.clone(), before.sel_match.clone()
    w = p.w["cilium_tpu_torch"]
    w.reg.allocate(_labels("cilium_tpu_torch", ["k8s:app=a1", "k8s:team=t2"]))
    w.repo.add_list([_rule("cilium_tpu_torch", ["k8s:app=a1"], ["k8s:team=t3"], port=9100)])
    te.refresh()
    after = te.device_policy
    assert not torch.equal(after.id_bits, id_bits) and not torch.equal(after.ingress.s1_mat, copies["s1_mat"])
    assert torch.equal(before.id_bits, id_bits) and torch.equal(before.sel_match, sel)
    for name, t in copies.items():
        assert torch.equal(getattr(before.ingress, name), t), name


# -- rule deltas --------------------------------------------------------------

APPEND_CASES = {
    # existing selectors on both sides (the compiled world's apps)
    "existing_selectors": lambda pkg, j: _rule(pkg, [f"k8s:app=a{j % 8}"], [f"k8s:app=a{(j + 3) % 8}"],
                                               port=80),
    # a peer selector never seen: new conjunct, few matching rows
    # (the row-sparse sel_match window)
    "new_selector_sparse": lambda pkg, j: _rule(pkg, ["k8s:app=a1"], [f"k8s:app=a{j % 8}", "k8s:team=t1"]),
    # a new selector matching most identities (the dense column window)
    "new_selector_dense": lambda pkg, j: _rule(
        pkg, [f"k8s:app=a{j % 8}"], [], peer_exprs=[("k8s:uid", "Exists")] if j == 0 else
        [("k8s:uid", "Exists"), (f"k8s:zz{j}", "DoesNotExist")]),
    "l7": lambda pkg, j: _rule(pkg, [f"k8s:app=a{j % 8}"], [f"k8s:app=a{(j + 1) % 8}"], port=8080,
                               l7_path=f"/v{j}/.*"),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_rule_appends_match_jax(case, monkeypatch):
    windows = {"rows": 0, "dense": 0}
    real_rc, real_cw = tengine._set_rows_cols, tengine._set_col_window

    def rows_cols(*a):
        windows["rows"] += 1
        return real_rc(*a)

    def col_window(*a):
        windows["dense"] += 1
        return real_cw(*a)

    monkeypatch.setattr(tengine, "_set_rows_cols", rows_cols)
    monkeypatch.setattr(tengine, "_set_col_window", col_window)
    p = Pair(7, n_idents=80 if case == "new_selector_dense" else 24)
    p.refresh()
    for j in range(3):
        p.each(lambda pkg, w: w.repo.add_list([APPEND_CASES[case](pkg, j)]))
        p.refresh()
    kinds = p.kinds()
    assert kinds.count("rules") == 3 and "full" not in kinds[1:], kinds
    assert p.moved() == {"full": 1, "incremental": 3}
    if case == "new_selector_sparse":
        assert windows["rows"] >= 1 and windows["dense"] == 0 and "cols" in kinds
    elif case == "new_selector_dense":
        assert windows["dense"] >= 1 and "cols" in kinds
    p.assert_fresh_parity(1)


def test_delete_is_incremental():
    p = Pair(5)
    p.refresh()
    p.each(lambda pkg, w: w.repo.add_list([_rule(pkg, ["k8s:app=a2"], ["k8s:app=a3"], label="k8s:policy=temp")]))
    p.refresh()
    n = p.each(lambda pkg, w: w.repo.delete_by_labels(_labels(pkg, ["k8s:policy=temp"]))[1])
    assert n == {pkg: 1 for pkg in PKGS}
    p.refresh()
    assert p.kinds()[-1] == "rules" and "full" not in p.kinds()[1:]
    assert p.moved() == {"full": 1, "incremental": 2}
    p.assert_fresh_parity(2)


def _small_pair():
    """web / lb / cli identities, no rules yet, in both packages."""
    p = Pair(0, n_rules=0, n_idents=2)
    names = p.each(lambda pkg, w: {
        n: w.reg.allocate(_labels(pkg, [f"k8s:app={n}"])) for n in ("web", "lb", "cli")})
    return p, names


def test_delete_shared_cells_survive():
    """Two rules with the SAME (subject, peer) allow cell: deleting one
    keeps the verdict (refcount, not clear)."""
    p, ids = _small_pair()
    p.each(lambda pkg, w: w.repo.add_list([
        _rule(pkg, ["k8s:app=web"], ["k8s:app=lb"], label=f"k8s:policy=p{i}") for i in (1, 2)]))
    p.refresh()
    te = p.eng["cilium_tpu_torch"]
    web, lb = ids["cilium_tpu_torch"]["web"].id, ids["cilium_tpu_torch"]["lb"].id
    assert te.verdict_one(web, lb, l4=False)[0] == 1
    p.each(lambda pkg, w: w.repo.delete_by_labels(_labels(pkg, ["k8s:policy=p1"])))
    p.refresh()
    assert "full" not in p.kinds()[1:]
    assert te.verdict_one(web, lb, l4=False)[0] == 1
    p.each(lambda pkg, w: w.repo.delete_by_labels(_labels(pkg, ["k8s:policy=p2"])))
    p.refresh()
    assert te.verdict_one(web, lb, l4=False)[0] != 1
    p.assert_fresh_parity()


def test_delete_l4_and_l7_rule():
    p, ids = _small_pair()
    p.each(lambda pkg, w: w.repo.add_list([
        _rule(pkg, ["k8s:app=web"], ["k8s:app=lb"], port=80, label="k8s:policy=keep"),
        _rule(pkg, ["k8s:app=web"], ["k8s:app=cli"], port=8080, l7_path="/api/.*", label="k8s:policy=temp"),
    ]))
    p.refresh()
    te = p.eng["cilium_tpu_torch"]
    web, lb, cli = (ids["cilium_tpu_torch"][n].id for n in ("web", "lb", "cli"))
    assert te.verdict_one(web, cli, 8080)[0] == 1
    p.each(lambda pkg, w: w.repo.delete_by_labels(_labels(pkg, ["k8s:policy=temp"])))
    p.refresh()
    assert "full" not in p.kinds()[1:]
    assert te.verdict_one(web, cli, 8080)[0] != 1 and te.verdict_one(web, lb, 80)[0] == 1
    p.assert_fresh_parity()


@pytest.mark.parametrize("seed", [11, 12])
def test_random_delete_sequences(seed):
    rng = random.Random(seed)
    p = Pair(seed)
    p.refresh()
    for step in range(6):
        if rng.random() < 0.5:
            subj, peer = f"k8s:app=a{rng.randrange(8)}", f"k8s:app=a{rng.randrange(8)}"
            port = 80 if rng.random() < 0.5 else None
            p.each(lambda pkg, w: w.repo.add_list(
                [_rule(pkg, [subj], [peer], port=port, label=f"k8s:policy=step{step}")]))
        else:  # one earlier step's rule (may be a no-op)
            lbl = f"k8s:policy=step{rng.randrange(step + 1)}"
            p.each(lambda pkg, w: w.repo.delete_by_labels(_labels(pkg, [lbl])))
        p.refresh()
        p.assert_fresh_parity(seed + step)
    assert "full" not in p.kinds()[1:]


def test_mixed_identity_and_rule_deltas():
    p = Pair(6)
    p.refresh()
    p.each(lambda pkg, w: w.reg.allocate(_labels(pkg, ["k8s:app=a4", "k8s:team=t1"])))
    p.each(lambda pkg, w: w.repo.add_list([_rule(pkg, ["k8s:app=a4"], ["k8s:app=a5"])]))
    p.refresh()
    kinds = p.kinds()
    assert "rows" in kinds[1:] and "rules" in kinds[1:] and "full" not in kinds[1:]
    assert p.moved() == {"full": 1, "incremental": 1}
    p.assert_fresh_parity()


def test_add_during_refresh_window_not_skipped():
    """A rule batch landing between changes_since() and the revision
    update stays stale and compiles on the NEXT refresh (each op
    advances the revision to its own, never to a re-read)."""
    p = Pair(7)
    p.refresh()
    for pkg in PKGS:
        w = p.w[pkg]
        orig = w.repo.changes_since
        fired = {}

        def racy(revision, w=w, orig=orig, fired=fired, pkg=pkg):
            ops = orig(revision)
            if not fired:
                fired["x"] = True
                w.repo.add_list([_rule(pkg, ["k8s:app=a1"], ["k8s:app=a2"])])
            return ops

        w.repo.changes_since = racy
        w.repo.add_list([_rule(pkg, ["k8s:app=a0"], ["k8s:app=a3"])])
        p.eng[pkg].refresh()
        w.repo.changes_since = orig
        assert p.eng[pkg]._compiled.revision < w.repo.revision
    p.check()
    p.refresh()
    assert p.eng["cilium_tpu_torch"]._compiled.revision == p.w["cilium_tpu_torch"].repo.revision
    assert "full" not in p.kinds()[1:]
    p.assert_fresh_parity()


def test_deltas_since_truncation_and_wait_device():
    p = Pair(2)
    p.refresh()
    for e in p.eng.values():
        e.DELTA_LOG_CAP = 2
    for j in range(4):
        p.each(lambda pkg, w: w.reg.allocate(_labels(pkg, [f"k8s:app=a{j}", f"k8s:team=t{j % 4}"])))
        p.refresh()
    assert p.eng["cilium_tpu_torch"].deltas_since(0) is None
    assert [e[0] for e in p.eng["cilium_tpu_torch"].deltas_since(3)] == [4, 5]
    p.eng["cilium_tpu_torch"].wait_device()  # the CPU: nothing to wait for
    te, je = p.eng["cilium_tpu_torch"], p.eng["cilium_tpu"]
    for rows, words in (([0, 3, 5], None), ([1, 2], [0]), ([10 ** 6], None), ([0], [99])):
        got, want = te.sel_match_rows(rows, words), je.sel_match_rows(rows, words)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
