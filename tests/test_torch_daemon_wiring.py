"""Port parity: the Daemon's wiring of the datapath options.

Through both packages by ``torch_daemon_bar.run_case`` (the port's
``Daemon(device="cpu")``, each test's reads equal): the
``TestDaemonWiring`` classes of ``test_placement.py``,
``test_failsafe.py``, ``test_overload.py``, ``test_autotune.py`` and
``test_pipeline_async.py``, and ``test_sparse_deltas.py``'s
``TestSparseDeltasOption``.
"""

from __future__ import annotations

import pytest

from torch_daemon_bar import cases, run_case

WIRING = (
    cases("test_placement.py", ["TestDaemonWiring"])
    + cases("test_failsafe.py", ["TestDaemonWiring"])
    + cases("test_overload.py", ["TestDaemonWiring"])
    + cases("test_autotune.py", ["TestDaemonWiring"])
    + cases("test_pipeline_async.py", ["TestDaemonWiring"])
    + cases("test_sparse_deltas.py", ["TestSparseDeltasOption"])
)


@pytest.mark.parametrize("case", WIRING)
def test_wiring(case, tmp_path):
    run_case(case, tmp_path)
