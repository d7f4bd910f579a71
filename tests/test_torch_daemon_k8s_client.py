"""Port parity: the Kubernetes informer against a fake apiserver, on the
Daemon.

``test_k8s_client.py``'s Daemon-built tests (the ``world`` fixture: a
``Daemon`` and a ``K8sWatcher`` on it, fed by an ``Informer`` over the
fake apiserver's LIST and WATCH streams), now on the port's
``Daemon(device="cpu")``, through both packages by
``torch_daemon_bar.run_case`` (each test's reads equal; a resolve that a test polls until the
watch has applied an event is compared on its last read). A file of
its own: each test waits on the fake apiserver's streams.
"""

from __future__ import annotations

import pytest

from torch_daemon_bar import cases, run_case

K8S_CLIENT = cases("test_k8s_client.py", tests=[
    "test_initial_list_populates_daemon", "test_watch_events_apply_live",
    "test_stream_drop_relists_and_heals_missed_delete", "test_410_gone_triggers_relist",
    "test_half_open_watch_recovers_via_read_deadline",
    "test_simultaneous_watch_failures_collapse_to_one_relist"])


@pytest.mark.parametrize("case", K8S_CLIENT)
def test_k8s_client(case, tmp_path):
    run_case(case, tmp_path, polled=["Daemon.policy_resolve"])
