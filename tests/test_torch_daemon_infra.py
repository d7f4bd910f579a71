"""Port parity: the daemon's small infrastructure and its surfaces.

Through both packages by ``torch_daemon_bar.run_case`` (the port's
``Daemon(device="cpu")``, each test's reads equal): the ``utils/``
modules this slice completes (``iputil``, ``prefix_counter``, ``dlock``,
``flowdebug``, ``loadinfo``, ``nat46``) with the Daemon's wiring of
routes, probes, prefix lengths, the proxymap, IPAM restore, CNI and the
workload watcher (``test_small_infra.py``, ``test_maps_infra.py``), and
the Daemon's trace, profile, monitor and attribution surfaces
(``test_observe.py``, ``test_profiler.py``, ``test_monitor.py``,
``test_flow_attribution.py``).
"""

from __future__ import annotations

import pytest

from torch_daemon_bar import cases, run_case

INFRA = (
    cases("test_small_infra.py", ["TestNAT46", "TestLoadinfoFlowdebug", "TestDebugLock",
                                  "TestDaemonWiring", "TestProbes"])
    + cases("test_maps_infra.py", ["TestIPUtil", "TestPrefixCounter", "TestProxymapWiring",
                                   "TestIPAMRestore", "TestCNIAndWorkloads"])
)
SURFACES = (
    cases("test_observe.py", ["TestSurfaces"])
    + cases("test_profiler.py", ["TestSurfaces"])
    + cases("test_monitor.py", ["TestDaemonIntegration"])
    + cases("test_flow_attribution.py", tests=["TestOptionWiring::test_flow_attribution_option_name"])
)


@pytest.mark.parametrize("case", INFRA)
def test_infra(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("case", SURFACES)
def test_surfaces(case, tmp_path):
    run_case(case, tmp_path)
