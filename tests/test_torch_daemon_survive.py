"""Port parity: restarts, drains and the daemon's fleet options.

Through both packages by ``torch_daemon_bar.run_case`` (the port's
``Daemon(device="cpu")``, each test's reads equal):
``test_survive.py``'s ``TestRestartContinuity`` and the drain, the
LifecycleJournal and FleetTelemetry options with their OFF tripwires on
the port's ``observe.journal``, ``observe.fleet`` and
``observe.timeseries`` (``test_journal.py``, ``test_fleetobs.py``), and
the ClusterFederation option's OFF path (``test_federation.py``).
"""

from __future__ import annotations

import pytest

from torch_daemon_bar import cases, run_case

SURVIVE = cases("test_survive.py", ["TestRestartContinuity"],
                tests=["TestDrain::test_drain_sheds_completes_and_persists"])
OPTIONS = (
    cases("test_journal.py", ["TestLifecycleJournalOption"])
    + cases("test_fleetobs.py", ["TestFleetTelemetryOption"])
    + cases("test_federation.py", ["TestOffPath"],
            tests=["TestFederationMember::test_option_requires_membership",
                   "TestFederationMember::test_off_restores_registry_allocator"])
)


@pytest.mark.parametrize("case", SURVIVE)
def test_survive(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("case", OPTIONS)
def test_options(case, tmp_path):
    run_case(case, tmp_path)
