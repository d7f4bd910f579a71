"""Port: the mesh bootstrap on torch.distributed (``federation/
bootstrap.py``) and the placement records it tags.

The reference's two-process dryrun, on the port: two real OS processes
join one gloo process group over a loopback coordinator, then each
resolves its own MeshPlan; both agree on the plan generation and axis
layout while holding disjoint process indices. The CPU tests have no
card, so each child shows two to torch (``torch.cuda.is_available`` and
``torch.cuda.device_count`` patched, as the placement tests replace
``visible_devices``): ``local_devices`` is 2 and ``global_devices`` the
fleet's sum, 4. The children get a scrubbed environment. The
reference's ``TestPlacementConfig`` runs here against both packages; its
coordinator-mismatch case, which the reference skips when the pytest
process never bootstrapped, runs in a subprocess, beside a failed
rendezvous that must raise within the bootstrap's bounded timeout.
Then the repair of ``datapath/placement.py``: once a bootstrap has run,
``visible_devices()`` tags this process's cards with its rank, and
``eligible_devices`` selects them through its ``process_index`` filter,
not through its fallback.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from test_torch_harness import PKGS

REPO = pathlib.Path(__file__).resolve().parent.parent

# the children's whole environment: no inherited jax, torch or
# torch.distributed settings; gloo on the loopback device
_ENV = {"PATH": "/usr/bin:/bin", "GLOO_SOCKET_IFNAME": "lo"}

_PRELUDE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 2
from cilium_tpu_torch.federation import bootstrap, mesh_bootstrap, placement_config
from cilium_tpu_torch.datapath import placement
"""

_CHILD = _PRELUDE + r"""
summary = mesh_bootstrap({coord!r}, 2, {pid})
cfg = placement_config()
plan = placement.resolve_plan(cfg, sharding=True)
filtered = [d.id for d in placement.visible_devices()
            if d.process_index == cfg.process_index]
print(json.dumps({{
    "summary": summary,
    "again": mesh_bootstrap({coord!r}, 2, {pid}),
    "generation": plan.generation,
    "axes": {{k: int(v) for k, v in plan.axes.items()}},
    "local_devices": len(plan.device_ids),
    "owners": [d.process_index for d in placement.eligible_devices(cfg)],
    "filtered": filtered,
}}))
"""

_MISMATCH = _PRELUDE + r"""
first = mesh_bootstrap({coord!r}, 1, 0)
try:
    mesh_bootstrap("127.0.0.1:1", 1, 0)
except RuntimeError as e:
    print(json.dumps({{"first": first, "error": str(e)}}))
"""

_NO_COORDINATOR = _PRELUDE + r"""
import time
bootstrap.INIT_TIMEOUT_S = 2.0
t0 = time.monotonic()
try:
    mesh_bootstrap({coord!r}, 2, 1)
except RuntimeError as e:
    print(json.dumps({{"error": str(e), "wall": time.monotonic() - t0,
                      "state": bootstrap.bootstrap_state()}}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(scripts, timeout: float = 120.0):
    """Start every script at once, each in its own interpreter; → the
    JSON object each printed last. Every child is killed on the way out."""
    procs = [subprocess.Popen([sys.executable, "-c", s], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=_ENV) for s in scripts]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_mesh_agrees_on_plan():
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run([_CHILD.format(repo=str(REPO), coord=coord, pid=pid) for pid in (0, 1)])
    for pid, o in enumerate(outs):
        s = o["summary"]
        assert s["initialized"] and s["coordinator"] == coord
        assert s["process_index"] == pid
        assert s["process_count"] == 2 and s["num_processes"] == 2
        assert s["local_devices"] == 2
        assert s["global_devices"] == 2 * s["local_devices"]
        assert o["again"] == s  # a second call returns the first summary
        assert o["local_devices"] == 2  # plan filtered to this process
        # the placement repair: this process's cards carry its rank and
        # the process_index filter (not its fallback) selects them
        assert o["owners"] == [pid, pid]
        assert o["filtered"] == [0, 1]
    # the federation contract: one MeshPlan across the fleet
    assert outs[0]["generation"] == outs[1]["generation"]
    assert outs[0]["axes"] == outs[1]["axes"] == {"flows": 2}


def test_coordinator_mismatch_raises_once_initialized():
    coord = f"127.0.0.1:{_free_port()}"
    (o,) = _run([_MISMATCH.format(repo=str(REPO), coord=coord)])
    assert o["first"]["process_count"] == 1
    assert "already initialized" in o["error"] and coord in o["error"]


def test_failed_rendezvous_raises_within_its_bound():
    """Rank 1 of 2 with no coordinator listening: the rendezvous gives up
    at the bootstrap's timeout (2 s here) with the bootstrap's message,
    and no summary is kept."""
    coord = f"127.0.0.1:{_free_port()}"
    (o,) = _run([_NO_COORDINATOR.format(repo=str(REPO), coord=coord)])
    assert o["error"].startswith(
        f"torch.distributed.init_process_group failed for process 1/2 at {coord}: ")
    assert o["state"] is None
    assert o["wall"] < 30.0


def test_bootstrap_timeout_is_bounded():
    from cilium_tpu_torch.federation import bootstrap

    assert 0 < bootstrap.INIT_TIMEOUT_S <= 120.0


class TestPlacementConfig:
    @pytest.fixture(params=PKGS)
    def fed(self, request):
        return importlib.import_module(f"{request.param}.federation")

    def test_defaults_to_config_process_index(self, fed):
        pc = fed.placement_config()
        assert pc.process_index == 0  # cfg.mesh_process_index default

    def test_explicit_index_wins(self, fed):
        assert fed.placement_config(process_index=3).process_index == 3

    def test_bootstrap_state_standalone(self, fed):
        # this pytest process never runs mesh_bootstrap itself
        state = fed.bootstrap.bootstrap_state()
        assert state is None or state["initialized"]


@pytest.fixture()
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_standalone_records_belong_to_process_zero(two_cards):
    from cilium_tpu_torch.datapath import placement
    from cilium_tpu_torch.federation import bootstrap

    assert bootstrap.bootstrap_state() is None
    recs = placement.visible_devices()
    assert [(r.id, r.process_index, str(r.device)) for r in recs] == [
        (0, 0, "cuda:0"), (1, 0, "cuda:1")]


def test_bootstrapped_rank_owns_its_cards(two_cards, monkeypatch):
    """What a bootstrap at rank 1 leaves: a process group at rank 1 and
    its summary. The records carry rank 1, so placement_config()'s
    filter selects them; a config naming another rank matches nothing
    and takes the fallback."""
    import torch.distributed as dist

    from cilium_tpu_torch.datapath import placement
    from cilium_tpu_torch.federation import bootstrap

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(bootstrap, "_summary", {
        "initialized": True, "coordinator": "127.0.0.1:1", "num_processes": 2,
        "process_index": 1, "process_count": 2, "global_devices": 4, "local_devices": 2})
    recs = placement.visible_devices()
    assert [r.process_index for r in recs] == [1, 1]
    cfg = bootstrap.placement_config()
    assert cfg.process_index == 1
    assert [d.process_index for d in recs if d.process_index == cfg.process_index] == [1, 1]
    assert [(d.id, d.process_index) for d in placement.eligible_devices(cfg)] == [(0, 1), (1, 1)]
    plan = placement.resolve_plan(cfg, sharding=True)
    assert plan.device_ids == (0, 1) and plan.axes == {"flows": 2}
    # the fallback stays for a config that names no process of this host
    other = placement.PlacementConfig(process_index=0)
    assert not [d for d in recs if d.process_index == other.process_index]
    assert [d.id for d in placement.eligible_devices(other)] == [0, 1]
