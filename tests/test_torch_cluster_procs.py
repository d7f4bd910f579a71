"""Port parity: the port's CLI agents as processes, alone and joined into
a cluster over the TCP kvstore.

The reference's subprocess tests through both packages by
``torch_daemon_bar.run_case``: each package's own ``python -m
<package>.cli`` processes (the port's with ``--device cpu``, a child's
Python source with ``Daemon(device='cpu', ...)``), and each test's reads
of them equal: ``test_survive.py``'s SIGTERM drain in a real process,
``test_monitor.py``'s agent with ``--launch-monitor`` serving ``cilium
monitor`` clients from the external monitor process,
``test_netstore.py``'s ``TestCrossProcess`` and
``TestThreeProcessCluster`` (``kvstore serve`` and two ``daemon --join
tcp://...`` agents: an endpoint's announcement reaches the other agent,
a killed agent's lease takes it away) and ``test_cluster.py``'s
``TestStandaloneHealthProcess`` (each agent's health sidecar probes the
other node over real sockets). A map read that a test polls until the
cluster converges is compared on its last read. One file, so that one
worker spawns these processes one test at a time. ``test_cni_exec.py``'s
CNI executable runs against the port's own agent in
``test_torch_cni.py``, whose copies name their network namespaces apart
(the reference's is one fixed name, which two runs at once would share).
"""

from __future__ import annotations

import pytest

from torch_daemon_bar import cases, run_case

AGENT = (cases("test_survive.py", tests=["TestDrain::test_sigterm_subprocess_drains_and_exits_zero"])
         + cases("test_monitor.py", tests=[
             "TestStandaloneMonitorProcess::test_daemon_launch_monitor_serves_cli_clients"]))
CLUSTER = (cases("test_netstore.py", ["TestCrossProcess", "TestThreeProcessCluster"])
           + cases("test_cluster.py", ["TestStandaloneHealthProcess"]))


@pytest.mark.parametrize("case", AGENT)
def test_agent_process(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("case", CLUSTER)
def test_cluster_processes(case, tmp_path):
    run_case(case, tmp_path, polled=["APIClient.map_dump"])
