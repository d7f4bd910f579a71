"""Port parity: clustered agents in one process.

``ClusterNode`` (``cluster.py``, a copy) joins two of the port's
``Daemon(device="cpu")`` over one kvstore: identity numbering agreed by
CAS, each node's endpoint addresses in the other's ipcache, tunnels,
routes and the health prober from the node registry, a cross-node flow
held on the peer's pipeline, the pre-join renumbering, leaving, and the
services export. Through both packages by ``torch_daemon_bar.run_case``
(each test's reads equal): ``test_cluster.py``'s
``TestClusterConvergence`` over an in-memory store, and
``test_netstore.py``'s two daemons over the TCP server and its outage
and rejoin tests.
"""

from __future__ import annotations

import pytest

from torch_daemon_bar import cases, run_case

CLUSTER = cases("test_cluster.py", ["TestClusterConvergence"])
NETSTORE = cases("test_netstore.py", ["TestOutageRecovery"],
                 tests=["TestDistributedOverNet::test_two_daemons_cluster_over_tcp"])


@pytest.mark.parametrize("case", CLUSTER)
def test_cluster(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("case", NETSTORE)
def test_cluster_over_tcp(case, tmp_path):
    run_case(case, tmp_path)
