"""Port parity: epoch-swapped full rebuilds (``epoch_swap``).

A delta the O(delta) patches cannot express (a "full" recompile event,
or a rule that grows an endpoint's slot set) re-materializes on a
shadow thread while batches keep the current generation; the install
becomes visible through the next rebuild, which also flushes the
conntrack. The same world and mutation sequence go through both
packages' pipelines with the swap on; the port's shadow is held on a
``threading.Event`` inside ``_build_mats`` (the JAX one where the case
needs both held), so the test sees the old generation serve. After
every publish both packages' materialized state, tries, verdicts,
redirects and counters are equal (``Pipes.check``, tolerance 0), and
both swap, abandon and fall back on the same steps. Port-only: which
rebuilds may kick a shadow, the shadow's state against a synchronous
sweep of the same snapshot, and the kernel launch counter under two
threads.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu_torch import _kernels
from cilium_tpu_torch import metrics as tmetrics
from test_torch_harness import PKGS, random_flows
from test_torch_pipeline_incremental import N_EPS, Pipes, _add_rule, _alloc

INGRESS, EGRESS = 0, 1


class Hold:
    """Wraps a pipeline's ``_build_mats`` so that a shadow waits for
    ``release()`` before it sweeps; records each call's arguments."""

    def __init__(self, pipe):
        self.go = threading.Event()
        self.calls = []
        real = pipe._build_mats

        def held(*args):
            self.calls.append(args)
            if threading.current_thread() is not threading.main_thread():
                assert self.go.wait(60), "the test never released the shadow"
            return real(*args)

        pipe._build_mats = held
        self.real = real

    def release(self):
        self.go.set()


def _swaps():
    return {"cilium_tpu": jmetrics.engine_epoch_swaps_total.get(),
            "cilium_tpu_torch": tmetrics.engine_epoch_swaps_total.get()}


def _slot_growth(p: Pipes):
    """A rule giving endpoint 0's app a new port: the column patch
    refuses (new columns), so the delta route fails."""
    w = p.w["cilium_tpu"]
    app = next(lb for lb in w.ident_labels[w.idents[0].id] if "app=" in lb)
    _add_rule(p, [app], [], port=9443, label="k8s:policy=grow",
              peer_exprs=[("k8s:uid", "Exists")])


def _force(p: Pipes):
    for e in p.eng.values():
        e.refresh(force=True)  # logs a "full" delta


@pytest.mark.parametrize("mutate", [_force, _slot_growth], ids=["full", "slot_growth"])
def test_swap_serves_old_then_publishes(mutate):
    p = Pipes(11, epoch_swap=True)
    p.rebuild()
    wj = p.w["cilium_tpu"]
    f4 = random_flows(wj, 800, N_EPS, 3)
    f4[1][:200], f4[2][:200], f4[3][:200] = 0, 9443, 6  # the grown slot's flows
    old = p.pt.process(*f4)
    holds = {pkg: Hold(pipe) for pkg, pipe in p.pipe.items()}
    base = {pkg: dict(pipe._mat) for pkg, pipe in p.pipe.items()}
    ct0 = {pkg: pipe._ct_epoch for pkg, pipe in p.pipe.items()}
    s0 = _swaps()
    mutate(p)
    for pipe in p.pipe.values():
        pipe.rebuild()  # kicks the shadow; the old generation serves
    shadow = p.pt._shadow_thread
    assert shadow is not None and shadow.is_alive()
    for _ in range(2):  # batches and rebuilds meanwhile: still the old one
        got = p.pt.process(*f4)
        for g, x in zip(got, old):
            np.testing.assert_array_equal(g, x)
        p.pt.rebuild()
        assert p.pt._shadow_thread is shadow
    for pkg, pipe in p.pipe.items():
        assert all(pipe._mat[d] is base[pkg][d] for d in base[pkg])
        assert pipe.policy_epoch == 0 and pipe._ct_epoch == ct0[pkg]
    for h in holds.values():
        h.release()
    for pipe in p.pipe.values():
        assert pipe.wait_epoch_swap(60)
        assert pipe.policy_epoch == 1 and pipe._ct_flush_pending and pipe._tries is None
    s1 = _swaps()
    assert {pkg: s1[pkg] - s0[pkg] for pkg in PKGS} == {pkg: 1 for pkg in PKGS}
    assert p.rebuild()  # the publish of the installed generations
    for pkg, pipe in p.pipe.items():
        assert all(pipe._mat[d] is not base[pkg][d] for d in base[pkg])
        assert pipe._ct_epoch == ct0[pkg] + 1 and not pipe._ct_flush_pending
    after = p.pt.process(*f4)
    if mutate is _slot_growth:
        assert not np.array_equal(after[0], old[0])
    # the shadow's state equals a synchronous sweep of its snapshot
    sync = holds["cilium_tpu_torch"].real(*holds["cilium_tpu_torch"].calls[-1])
    for d in (INGRESS, EGRESS):
        m, s = p.pt._mat[d], sync[d]
        np.testing.assert_array_equal(m.allow_nc, s.allow_nc)
        np.testing.assert_array_equal(m.red_nc, s.red_nc)
        assert torch.equal(m.tables.id_bits, s.tables.id_bits)
    # O(delta) routing goes on against the swapped generation
    _alloc(p, 0)
    assert p.rebuild()
    _add_rule(p, ["k8s:app=a2"], ["k8s:app=a5"])
    assert p.rebuild()


def _bump(kind, pipe, p):
    if kind == "swap_off":
        pipe.set_epoch_swap(False)
    elif kind == "generation":
        with pipe._lock:
            pipe._swap_gen += 1  # what the reference's quarantine does
    elif kind == "endpoints":
        pipe.set_endpoints([i.id for i in p.w["cilium_tpu"].idents[:N_EPS]])
    else:
        pipe.set_attribution(True)


@pytest.mark.parametrize("kind", ["swap_off", "generation", "endpoints", "attribution"])
def test_bump_abandons_the_shadow(kind):
    """A basis move during a shadow abandons it: it does not install.
    The next rebuild sweeps synchronously, or, after a bare generation
    bump with the swap still on, kicks a fresh shadow."""
    p = Pipes(23, epoch_swap=True)
    p.rebuild()
    base = {pkg: dict(pipe._mat) for pkg, pipe in p.pipe.items()}
    holds = [Hold(pipe) for pipe in p.pipe.values()]
    _force(p)
    for pipe in p.pipe.values():
        pipe.rebuild()
        _bump(kind, pipe, p)
    for h in holds:
        h.release()
    for pipe in p.pipe.values():
        assert pipe.wait_epoch_swap(60)
        assert pipe.policy_epoch == 0 and pipe._shadow_exc is None
    kicks = {pkg: len(h.calls) for pkg, h in zip(PKGS, holds)}
    p.rebuild()
    assert {pkg: len(h.calls) - kicks[pkg] for pkg, h in zip(PKGS, holds)} == {pkg: 1 for pkg in PKGS}
    if kind == "generation":
        for pipe in p.pipe.values():
            assert pipe.wait_epoch_swap(60) and pipe.policy_epoch == 1
        p.rebuild()
    for pkg, pipe in p.pipe.items():
        assert all(pipe._mat[d] is not base[pkg][d] for d in base[pkg])
        assert pipe.policy_epoch == (kind == "generation")


def test_shadow_fault_classification():
    """A transient or poisoned shadow death falls back to the
    synchronous sweep; a programmer error re-raises."""
    p = Pipes(41, epoch_swap=True)
    p.rebuild()
    for pipe in p.pipe.values():
        pipe._shadow_exc = TimeoutError("simulated device loss")
    _force(p)
    assert not p.rebuild()
    for pipe in p.pipe.values():
        assert pipe._shadow_exc is None and pipe.policy_epoch == 0
        assert pipe._shadow_thread is None
    for pipe in p.pipe.values():
        pipe._shadow_exc = ValueError("bug")
    _force(p)
    for pipe in p.pipe.values():
        with pytest.raises(ValueError):
            pipe.rebuild()


# -- port-only ---------------------------------------------------------------

def test_only_a_failed_delta_route_kicks_a_shadow(monkeypatch):
    """force, the first build, a new endpoint set, the attribution
    switch and the deltas the patches express all sweep on the calling
    thread; only a delta route that fails kicks a shadow."""
    p = Pipes(7, epoch_swap=True)
    pt = p.pt
    kicks = []
    real = type(pt)._kick_shadow_build
    monkeypatch.setattr(type(pt), "_kick_shadow_build",
                        lambda self, *a: (kicks.append(1), real(self, *a))[1])
    pt.rebuild()
    pt.rebuild(force=True)
    pt.set_endpoints([i.id for i in p.w["cilium_tpu_torch"].idents[1:N_EPS + 1]])
    pt.rebuild()
    pt.set_attribution(True)
    pt.rebuild()
    pt.set_attribution(False)
    pt.rebuild()
    _alloc(p, 2)
    _add_rule(p, ["k8s:app=a1"], ["k8s:app=a3"])
    pt.rebuild()
    assert kicks == [] and pt._shadow_thread is None
    _force(p)
    pt.rebuild()
    assert kicks == [1]
    assert pt.wait_epoch_swap(60) and pt.policy_epoch == 1


def test_launch_counter_loses_no_increment(monkeypatch):
    """Two threads launching the same kernel (a shadow's K2 beside the
    serving thread's) count every launch. The count's read yields the
    interpreter, so an unguarded ``+=`` would lose increments here."""
    real = _kernels.KERNELS["bool_mm"]

    class Yielding(_kernels.Kernel):
        @property
        def launches(self):
            n = self._n
            time.sleep(0)
            return n

        @launches.setter
        def launches(self, n):
            self._n = n

    k = Yielding(real.name, real.symbol, real.argtypes)
    monkeypatch.setattr(_kernels, "library", lambda: types.SimpleNamespace(**{k.symbol: lambda *a: 0}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda", 0)
    n = 2000

    def run():
        for _ in range(n):
            k.launch(dev)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert k.launches == 2 * n
