"""Port parity: the daemon and its REST API (``daemon.py``, ``api/server.py``),
its boot probes (``probes.py``) and bugtool (``bugtool.py``).

The copies: the ten modules of this slice equal their references line
for line, but for the lines ``ADAPTED`` names — the ``device=`` keyword
of ``Daemon``, the two probes rewritten on torch, and docstring lines
whose paths into the reference's source tree lose their host prefix.

The reference's Daemon and REST tests run through both packages by
``torch_daemon_bar.run_case``: the port's ``Daemon(device="cpu")`` and
the JAX package's ``Daemon``, each test's reads of either equal:
``test_cli_api.py``'s ``TestDaemon``, ``TestRESTAPI`` and
``TestParityCommands``; ``test_config_maps_cli.py``'s runtime config, map
dumps, state migration and the REST half of ``TestRESTAndCLI``;
``test_health_bugtool.py``'s debuginfo and bugtool (``test_rest_and_cli``
with its ``cilium bugtool`` leg through the port's CLI) and the
registry prober.
"""

from __future__ import annotations

import ast
import difflib
import importlib

import pytest

from test_torch_harness import REPO
from torch_daemon_bar import cases, reset_globals, run_case

COPIES = ["utils/iputil.py", "utils/prefix_counter.py", "utils/dlock.py", "utils/flowdebug.py",
          "utils/loadinfo.py", "utils/nat46.py", "bugtool.py"]
# path → (reference lines, port lines) that differ. daemon.py: the
# docstring's source paths (3, 6, 12), the import of _kernels (25), the
# device keyword (90) resolved once (92) and passed to the engine (98),
# the pipeline (135) and the L7DeviceBatch flip (931). api/server.py:
# the docstring's source paths (4, 5)
ADAPTED = {"daemon.py": ({3, 6, 12, 25, 96}, {3, 6, 12, 25, 90, 92, 98, 135, 931}),
           "api/server.py": ({4, 5}, {4, 5})}
# probes.py: the two probes that asked JAX, rewritten on torch, and the
# docstring's source path (line 3)
PROBES_REWRITTEN = ("_probe_device", "_probe_donation")
PROBES_DOC = {3}

CLI_API = cases("test_cli_api.py", ["TestDaemon", "TestRESTAPI", "TestParityCommands"])
CONFIG = cases("test_config_maps_cli.py", ["TestRuntimeConfig", "TestMapDumps", "TestStateMigration"],
               tests=["TestRESTAndCLI::test_config_and_maps_over_rest"])
BUGTOOL = cases("test_health_bugtool.py", ["TestDebuginfoAndBugtool"],
                tests=["TestProber::test_attach_registry_starts_prober"])


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _differ(path: str):
    a = (REPO / "cilium_tpu" / path).read_text().splitlines()
    b = (REPO / "cilium_tpu_torch" / path).read_text().splitlines()
    ref, port = set(), set()
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if op != "equal":
            ref.update(range(i1 + 1, i2 + 1))
            port.update(range(j1 + 1, j2 + 1))
    return ref, port


def _function_lines(path, names):
    tree = ast.parse(path.read_text())
    return {k for node in tree.body if isinstance(node, ast.FunctionDef) and node.name in names
            for k in range(node.lineno, node.end_lineno + 1)}


@pytest.mark.parametrize("path", COPIES)
def test_copies_equal_the_reference(path):
    assert (REPO / "cilium_tpu_torch" / path).read_text() == (REPO / "cilium_tpu" / path).read_text()


@pytest.mark.parametrize("path", sorted(ADAPTED))
def test_adapted_copies_differ_only_in_the_named_lines(path):
    assert _differ(path) == ADAPTED[path]


def test_probes_differ_only_in_the_two_probes():
    ref, port = _differ("probes.py")
    assert ref and port
    assert ref <= _function_lines(REPO / "cilium_tpu" / "probes.py", PROBES_REWRITTEN) | PROBES_DOC
    assert port <= _function_lines(REPO / "cilium_tpu_torch" / "probes.py",
                                   PROBES_REWRITTEN) | PROBES_DOC
    src = (REPO / "cilium_tpu_torch" / "probes.py").read_text()
    assert "jax" not in src


def test_probe_features_agree():
    """The probe set's keys, its device block's keys and its degraded
    list are equal in both packages: on a machine without a card both
    report the CPU and no accelerator (JAX counts the tests' virtual
    devices, the port one), and donation (the port's in-place add)
    working."""
    out = {}
    for pkg in ("cilium_tpu", "cilium_tpu_torch"):
        reset_globals(pkg)
        out[pkg] = _mod(pkg, "probes").probe_features()
        reset_globals(pkg)
    j, t = out["cilium_tpu"], out["cilium_tpu_torch"]
    assert sorted(t) == sorted(j)
    assert sorted(t["device"]) == sorted(j["device"])
    assert t["degraded"] == j["degraded"] == ["accelerator"]
    assert t["device"] == {"ok": True, "platform": "cpu", "device_kind": "cpu",
                           "device_count": 1, "accelerator": False}
    # JAX counts the tests' 8 virtual CPU devices; the port one CPU
    assert {k: v for k, v in j["device"].items() if k != "device_count"} == {
        k: v for k, v in t["device"].items() if k != "device_count"}
    assert t["device_donation"] is j["device_donation"] is True
    assert (t["l7_dfa"], t["kvstore_sqlite"]) == (j["l7_dfa"], j["kvstore_sqlite"])


def test_probe_donation_is_one_in_place_add(monkeypatch):
    """The port of the reference's donated ``x + 1``: the caller's
    int32[8] buffer is updated in place, and a broken add reads False."""
    import torch

    probes = _mod("cilium_tpu_torch", "probes")
    seen = []
    real = torch.Tensor.add_

    def add_(self, *a, **kw):
        seen.append((self.dtype, tuple(self.shape), self.device.type))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "add_", add_)
    assert probes._probe_donation() is True
    assert seen == [(torch.int32, (8,), "cpu")]
    monkeypatch.setattr(torch.Tensor, "add_", lambda self, *a, **kw: self)
    assert probes._probe_donation() is False


@pytest.mark.parametrize("case", CLI_API)
def test_cli_api(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("case", CONFIG)
def test_config_maps(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("case", BUGTOOL)
def test_debuginfo_bugtool(case, tmp_path):
    run_case(case, tmp_path)
