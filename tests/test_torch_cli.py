"""Port parity: the ``cilium`` command line (``cli.py``), its ``python -m``
entry (``__main__.py``) and ``ClusterNode`` (``cluster.py``).

The copies: ``cluster.py`` and ``__main__.py`` equal their references;
``cli.py`` differs only in the lines ``CLI_ADAPTED`` names — the
docstring's source path, the help and docstring lines that name the
package, the ``--device`` option, the two ``Daemon`` calls that take it
(standalone mode's ``_Surface`` and the ``daemon`` subcommand), the proxy
child's argv and ``version``, which asks torch.

The reference's in-process CLI tests run through both packages by
``torch_daemon_bar.run_case`` (the port's CLI with ``--device cpu``
before its argv, each test's reads and printed output equal):
``test_cli_api.py``'s ``TestCLI`` and ``TestLocalCommands``,
``test_config_maps_cli.py``'s CLI tests, ``test_survive.py``'s two
in-process signal-handler tests and ``test_federation.py``'s CLI surface
and ``FederationMember`` tests.
"""

from __future__ import annotations

import difflib

import pytest

from test_torch_harness import REPO
from torch_daemon_bar import cases, reset_globals, run_case

# reference lines → port lines that differ: the docstring's source path
# (1), the _Surface's device (36, 46), --device (266-267), the help
# lines naming the package's children (355/357, 358/360, 362/364), the
# daemon's Daemon call (623/625), the proxy child's argv (706/708-709),
# version (878-885/881-885, the blank lines between kept), standalone
# mode's _Surface call (973) and run()'s docstring naming the package
# (1474-1475)
CLI_ADAPTED = (
    {1, 36, 46, 355, 358, 362, 623, 706, 878, 879, 881, 882, 883, 884, 885, 973, 1474, 1475},
    {1, 36, 46, 266, 267, 357, 360, 364, 625, 708, 709, 881, 883, 884, 885, 973, 1474, 1475},
)

CLI = (
    cases("test_cli_api.py", ["TestCLI", "TestLocalCommands"])
    + cases("test_config_maps_cli.py", ["TestTraceSourceSelectors"], tests=[
        "TestRESTAndCLI::test_cli_validate_and_config", "TestRESTAndCLI::test_cli_policy_wait"])
    + cases("test_survive.py", tests=[
        "TestDrain::test_signal_handlers_raise_keyboard_interrupt",
        "TestDrain::test_handlers_tolerate_non_main_thread"])
)
FEDERATION = cases("test_federation.py", ["TestCLISurface"], tests=[
    "TestFederationMember::test_identity_numbering_agrees",
    "TestFederationMember::test_cluster_policy_epoch_converges",
    "TestFederationMember::test_cluster_status_surface",
    "TestFederationMember::test_release_keeps_remote_rows_covered",
    "TestFederationMember::test_node_descriptor_rides_epoch_record"])
# version's second line names each package's own runtime: held apart.
# `map list` on a standalone Daemon restored from state.json: its metrics
# map counts the pipeline's counter rows, which exist once the restored
# engine's background refresh has landed and the pipeline rebuilt: thread
# timing, in both packages (the reference test asserts its exit code only)
UNRECORDED = {"test_cli_api.py::TestLocalCommands::test_version": ["capsys.readouterr"],
              "test_cli_api.py::TestLocalCommands::test_cli_labels_and_flush_standalone":
                  ["Daemon.map_list"]}


def _differ(path: str):
    a = (REPO / "cilium_tpu" / path).read_text().splitlines()
    b = (REPO / "cilium_tpu_torch" / path).read_text().splitlines()
    ref, port = set(), set()
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if op != "equal":
            ref.update(range(i1 + 1, i2 + 1))
            port.update(range(j1 + 1, j2 + 1))
    return ref, port


@pytest.mark.parametrize("path", ["cluster.py", "__main__.py"])
def test_copies_equal_the_reference(path):
    assert (REPO / "cilium_tpu_torch" / path).read_text() == (REPO / "cilium_tpu" / path).read_text()


def test_cli_differs_only_in_the_named_lines():
    assert _differ("cli.py") == CLI_ADAPTED


def test_version_names_torch_and_the_reference_first_line(capsys):
    """``version`` builds no Daemon and needs no card: its first line is
    the reference's, its second torch's version, the platform (the
    CPU here) and the device count."""
    import torch

    from cilium_tpu.cli import main as ref_main
    from cilium_tpu_torch.cli import main

    assert ref_main(["version"]) == 0
    ref = capsys.readouterr().out.splitlines()
    assert main(["version"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ref[0]
    assert out[1] == f"torch {torch.__version__} (cpu, 1 device(s))"
    assert len(out) == len(ref) == 2


def test_version_on_a_card(monkeypatch, capsys):
    """With a card the platform is ``gpu`` and the card's name follows."""
    import torch

    from cilium_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert main(["version"]) == 0
    assert capsys.readouterr().out.splitlines()[1] == (
        f"torch {torch.__version__} (gpu: NVIDIA H100 80GB HBM3, 1 device(s))")


def test_device_option_reaches_the_standalone_daemon(monkeypatch, tmp_path):
    """``--device`` is parsed beside ``--socket`` / ``--state`` (None by
    default: the card), and standalone mode's ``_Surface`` builds its
    Daemon with it (the ``daemon`` subcommand and the proxy child:
    ``test_torch_harness.test_entry_points_need_cuda_unless_cpu_is_asked``)."""
    from cilium_tpu_torch import cli

    args = cli.build_parser().parse_args(["--device", "cpu", "status"])
    assert args.device == "cpu"
    assert cli.build_parser().parse_args(["status"]).device is None
    seen = []
    import cilium_tpu_torch.daemon as daemon_mod

    real = daemon_mod.Daemon

    def spy(*a, **kw):
        seen.append(kw.get("device", "<unset>"))
        return real(*a, **kw)

    monkeypatch.setattr(daemon_mod, "Daemon", spy)
    surface = cli._Surface(str(tmp_path / "none.sock"), str(tmp_path / "state"), "cpu")
    try:
        assert surface.status()["endpoints"] == 0
    finally:
        surface._daemon.shutdown()
    assert seen == ["cpu"]
    reset_globals("cilium_tpu_torch")


@pytest.mark.parametrize("case", CLI)
def test_cli(case, tmp_path):
    run_case(case, tmp_path, unrecorded=UNRECORDED.get(case, ()))


@pytest.mark.parametrize("case", FEDERATION)
def test_federation_cli_and_member(case, tmp_path):
    run_case(case, tmp_path)
