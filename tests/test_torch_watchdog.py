"""Port parity: the stuck-completion watchdog and the retry backoff — the
reference's ``tests/test_overload.py::TestWatchdog`` and ``TestBackoff``
run through both packages.

- ``stall_ms`` (the constructor or ``set_stall_ms``) arms the port's
  copy of ``datapath/admission.py`` ``Watchdog``; ``admission_state()
  ["watchdog"]`` is its snapshot, as in the reference.
- A completion that waits past the budget is abandoned through the
  quarantine: the waiter unblocks with DROP_DEGRADED inside 2 x the
  budget plus one sweep, and the late result never overwrites it.
- An injected ``SITE_STALL`` and a watched operation (``watching``, the
  full sweep's ``compile`` watch) count a stall and feed the breaker
  alike in both packages.
- ``utils/backoff.py`` is a verbatim copy: the same draws give the
  same durations.

Every wait here is bounded at 5 s.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest
import torch

from cilium_tpu import faults as jfaults
from cilium_tpu import metrics as jmetrics
from cilium_tpu.datapath.admission import Watchdog as JWatchdog
from cilium_tpu.utils.backoff import Backoff as JBackoff
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.datapath import placement as tplace
from cilium_tpu_torch.datapath.admission import Watchdog as TWatchdog
from cilium_tpu_torch.utils import Backoff as TBackoff
from test_torch_harness import PKGS
from test_torch_submit import Pair

DROP_DEGRADED = tpipe.DROP_DEGRADED
METRICS = {PKGS[0]: jmetrics, PKGS[1]: tmetrics}


@pytest.fixture(autouse=True)
def _clean_hubs_and_seam(monkeypatch):
    """Clean hubs, and the port's device seam as JAX's 8 virtual CPU
    devices (the journal's plan generations then agree)."""
    for f in (jfaults, tfaults):
        f.hub.reset()
    monkeypatch.setattr(tplace, "visible_devices",
                        lambda: [tplace.DeviceRecord(i, 0, torch.device("cpu")) for i in range(8)])
    yield
    for f in (jfaults, tfaults):
        f.hub.reset()


def armed(stall_ms: float = 0.0, *, in_ctor: bool = False) -> Pair:
    """Both packages' pipelines (depth 2), rebuilt, with journals on
    lists (``pr.events``) and the watchdog armed when ``stall_ms``: by
    the constructor with ``in_ctor`` (the first rebuild's full sweep,
    JAX's compile included, may then count a compile stall), else by
    set_stall_ms after that rebuild."""
    pr = Pair(3, depth=2, stall_ms=stall_ms if in_ctor else 0.0)
    pr.events = {}
    for pkg, p in pr.pipes.items():
        pr.events[pkg] = []
        p.on_journal = lambda out=pr.events[pkg], **e: out.append(e)
        p.rebuild()
        if stall_ms and not in_ctor:
            p.set_stall_ms(stall_ms)
    return pr


def disarm(pr: Pair) -> None:
    for p in pr.pipes.values():
        p.set_stall_ms(0)
        assert p._watchdog is None


def _timeless(events):
    """Journal events without the stall ages (wall-clock readings)."""
    return [{**e, "attrs": {k: v for k, v in e.get("attrs", {}).items() if k != "age_ms"}}
            for e in events]


def _wait_for(cond, limit: float = 5.0) -> bool:
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


# ---------------------------------------------------------------------------
class TestWatchdog:
    def test_poll_interval_clamped(self):
        for cls in (JWatchdog, TWatchdog):
            assert cls(object(), 1000.0)._poll_s == 0.25
            assert cls(object(), 0.8)._poll_s == 0.001
            assert cls(object(), 50.0)._poll_s == 0.0125

    def test_constructor_and_set_stall_ms_arm_it(self):
        """stall_ms > 0 at construction arms the watchdog;
        admission_state()["watchdog"] is its snapshot in both packages;
        set_stall_ms re-arms it and 0 stops it."""
        pr = armed(40.0, in_ctor=True)
        try:
            # the first rebuild's sweep may have counted a compile stall
            # (JAX's includes its compile): compare all but its clock
            snaps = [p.admission_state()["watchdog"] for p in (pr.j, pr.t)]
            assert snaps[1].keys() == snaps[0].keys()
            for snap in snaps:
                assert {k: snap[k] for k in ("stall_ms", "watching", "alive")} == {
                    "stall_ms": 40.0, "watching": [], "alive": True}
            for p in pr.pipes.values():
                p.set_stall_ms(25.0)
            assert pr.t.admission_state()["watchdog"]["stall_ms"] == 25.0
        finally:
            disarm(pr)
        assert pr.t.admission_state()["watchdog"] is None
        assert pr.t.admission_state() == pr.j.admission_state()

    def test_abandons_stuck_completion(self):
        """A waiter on a wedged completion unblocks with a degraded
        verdict per flow inside 2 x the budget plus one sweep; the
        wedged thread finishes later and its result does not overwrite
        the published one. The same in both packages."""
        pr = armed()
        bt = pr.flows(4, 64, 61)
        outs = {}
        for pkg, p in pr.pipes.items():
            p.process(*bt)
            pend = p.submit(*bt)
            inf = p._inflight[-1]
            orig = inf.finish
            release = threading.Event()
            finished = []

            def wedged(orig=orig, release=release, finished=finished):
                release.wait(5.0)
                out = orig()
                finished.append(out)
                return out

            inf.finish = wedged
            p.set_stall_ms(50.0)
            try:
                sacrificial = threading.Thread(target=pend.result, daemon=True)
                sacrificial.start()
                time.sleep(0.01)  # it enters the wedge
                t0 = time.monotonic()
                v, red = pend.result()
                waited = time.monotonic() - t0
                assert waited < 2 * 0.05 + 0.25
                assert (v == DROP_DEGRADED).all() and not red.any()
                wd = p._watchdog
                assert wd.stalls >= 1 and wd.last_stall["site"] == "dispatch"
            finally:
                release.set()
                sacrificial.join(5.0)
                p.set_stall_ms(0)
            assert not sacrificial.is_alive() and finished  # the late result came
            late = pend.result()
            assert late[0] is v and (late[0] == DROP_DEGRADED).all()
            outs[pkg] = (v, red, p.failsafe_state())
        (jv, jr, js), (tv, tr, ts) = outs[PKGS[0]], outs[PKGS[1]]
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tr, jr)
        assert ts == js and ts["quarantined_batches"] == 1
        kinds = [e["kind"] for e in pr.events[PKGS[1]]]
        assert "watchdog_stall" in kinds and kinds[-1] == "quarantine"
        assert _timeless(pr.events[PKGS[1]]) == _timeless(pr.events[PKGS[0]])

    def test_injected_stall_counts_and_feeds_breaker(self):
        pr = armed()
        s0 = {pkg: m.watchdog_stalls_total.get({"site": "stall"}) for pkg, m in METRICS.items()}
        for f in (jfaults, tfaults):
            f.hub.fail(f.SITE_STALL, f.KIND_TRANSIENT, times=2)
        try:
            for pkg, p in pr.pipes.items():
                p.set_stall_ms(20.0)
                m = METRICS[pkg]
                assert _wait_for(lambda: m.watchdog_stalls_total.get({"site": "stall"}) - s0[pkg] >= 2)
                p.set_stall_ms(0)  # before a third sweep could count more
                assert m.watchdog_stalls_total.get({"site": "stall"}) - s0[pkg] == 2
        finally:
            disarm(pr)
        for p in (pr.j, pr.t):
            assert p.failsafe_state()["breaker_faults"] == 2
        assert pr.t.failsafe_state() == pr.j.failsafe_state()
        assert _timeless(pr.events[PKGS[1]]) == _timeless(pr.events[PKGS[0]])

    def test_watching_external_op(self):
        pr = armed(30.0)
        try:
            for p in (pr.j, pr.t):
                wd = p._watchdog
                with wd.watching("attach"):
                    assert _wait_for(lambda: wd.stalls > 0)
                    time.sleep(0.05)  # more sweeps: still one note
                assert wd.stalls == 1 and wd.last_stall["site"] == "attach"
                assert wd.snapshot()["watching"] == []
        finally:
            disarm(pr)
        assert pr.t.failsafe_state() == pr.j.failsafe_state()

    def test_full_sweep_outliving_the_budget_is_a_compile_stall(self):
        """rebuild(force=True) runs the full sweep under
        ``watching("compile")``: a sweep held past the budget counts one
        compile stall and one breaker fault, in both packages; the
        rebuild itself completes."""
        pr = armed(30.0)
        try:
            for pkg, p in pr.pipes.items():
                real = p._build_mats
                seen = []

                def slow(*a, _r=real, _p=p, _s=seen):
                    _s.append(_p._watchdog.snapshot()["watching"])
                    assert _wait_for(lambda: _p._watchdog.stalls > 0)
                    return _r(*a)

                p._build_mats = slow
                c0 = METRICS[pkg].watchdog_stalls_total.get({"site": "compile"})
                p.rebuild(force=True)
                del p._build_mats
                assert seen == [["compile"]]
                assert p._watchdog.stalls == 1 and p._watchdog.last_stall["site"] == "compile"
                assert METRICS[pkg].watchdog_stalls_total.get({"site": "compile"}) == c0 + 1
        finally:
            disarm(pr)
        assert pr.t.failsafe_state() == pr.j.failsafe_state()
        assert pr.t.failsafe_state()["breaker_faults"] == 1
        assert _timeless(pr.events[PKGS[1]]) == _timeless(pr.events[PKGS[0]])
        bt = pr.flows(4, 96, 7)
        pr.equal(pr.t.process(*bt), pr.j.process(*bt))

    def test_watchdog_off_writes_no_completing_state(self):
        """Off, the completion half never writes ``_completing`` and
        ``admission_state()["watchdog"]`` is None."""
        pr = armed()
        writes = []

        class Spy(type(pr.t)):
            def __setattr__(self, name, value):
                if name == "_completing":
                    writes.append(value)
                super().__setattr__(name, value)

        pr.t.__class__ = Spy
        try:
            pend = pr.t.submit(*pr.flows(4, 64, 3))
            pend.result()
        finally:
            pr.t.__class__ = tpipe.DatapathPipeline
        assert writes == []
        assert pr.t.admission_state()["watchdog"] is None


# ---------------------------------------------------------------------------
class TestBackoff:
    def test_full_jitter_spans_the_range(self):
        b = TBackoff(min_s=1.0, max_s=1.0, factor=1.0, full_jitter=True)
        samples = [b.duration() for _ in range(400)]
        assert all(0.0 <= s <= 1.0 for s in samples)
        assert min(samples) < 0.25 and max(samples) > 0.75

    def test_equal_jitter_keeps_half_floor(self):
        b = TBackoff(min_s=1.0, max_s=1.0, factor=1.0)
        assert all(0.5 <= b.duration() <= 1.0 for _ in range(200))

    def test_max_elapsed_cap(self):
        b = TBackoff(min_s=0.4, max_s=0.4, factor=1.0, jitter=False, max_elapsed_s=1.0)
        assert b.duration() == pytest.approx(0.4)
        assert b.duration() == pytest.approx(0.4)
        assert b.duration() == pytest.approx(0.2)  # clamped to the remainder
        assert b.duration() == 0.0
        assert b.exhausted
        b.reset()
        assert not b.exhausted
        assert b.duration() == pytest.approx(0.4)

    def test_wait_credits_back_unspent_budget(self):
        b = TBackoff(min_s=0.2, max_s=0.2, factor=1.0, jitter=False, max_elapsed_s=0.2)
        ev = threading.Event()
        ev.set()
        assert b.wait(ev) is True
        assert not b.exhausted
        assert b._elapsed < 0.1

    @pytest.mark.parametrize("kw", [
        {"jitter": False}, {}, {"full_jitter": True}, {"jitter": False, "max_elapsed_s": 0.5},
    ], ids=["plain", "equal-jitter", "full-jitter", "capped"])
    def test_durations_match_jax(self, kw):
        """The pipeline's retry backoff (min 5 ms, max 100 ms) and its
        jittered forms: the same draws give the same durations."""
        seqs = []
        for cls in (JBackoff, TBackoff):
            random.seed(19)
            b = cls(min_s=0.005, max_s=0.1, **kw)
            seqs.append([b.duration() for _ in range(12)])
        assert seqs[1] == seqs[0]
        if kw == {"jitter": False}:
            assert seqs[1][:3] == [0.005, 0.01, 0.02] and seqs[1][-1] == 0.1


def test_watchdog_against_racing_completions():
    """Stress: 12 threads submit and resolve 8 batches each on one
    pipeline (depth 4) whose completions sleep 0-6 ms while the watchdog
    abandons those past 2 ms, switch interval shortened. Every result is
    published once: the batch's verdicts or DROP_DEGRADED on every lane,
    never None, the same object on a second read, and the degraded ones
    are exactly the quarantines. (The reference sets an abandoned batch's
    event before the watchdog stores its value: a waiter there can read
    None; ROADMAP queue C.)"""
    import sys

    pr = armed()
    p = pr.t
    bt = pr.flows(4, 48, 9)
    want = p.process(*bt)
    real = p._dispatch_complete
    rs = random.Random(5)

    def slow(enq):
        time.sleep(rs.random() * 0.006)
        return real(enq)

    p._dispatch_complete = slow
    p.breaker_threshold = 1 << 20  # the ladder stays out of it
    got, errors = [], []

    def worker():
        try:
            for _ in range(8):
                h = p.submit(*bt)
                out = h.result()
                assert out is not None and h.result() is out
                got.append(out)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    p.set_stall_ms(2.0)
    try:
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        p.set_stall_ms(0)
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    assert len(got) == 96
    n_degraded = 0
    for v, red in got:
        if (v == DROP_DEGRADED).all():
            n_degraded += 1
            assert not red.any()
        else:
            np.testing.assert_array_equal(v, want[0])
            np.testing.assert_array_equal(red, want[1])
    assert n_degraded == p.failsafe_state()["quarantined_batches"]
