"""Port parity: the policy sources and workload runtimes on the Daemon.

The Daemon-built tests that waited for the daemon, now on the port's
``Daemon(device="cpu")`` in place of the stand-in agents (which keep
their own tests), through both packages by ``torch_daemon_bar.run_case``
(each test's reads equal): the Kubernetes watcher (``test_k8s.py``,
``test_k8s_parity.py``), DNS polling (``test_fqdn.py``), NPDS publishing
(``test_xds.py``), the CRI watcher (``test_runtimes.py``), the Docker
plugin (``test_docker_plugin.py``) and CNI on real veths
(``test_cni_wire.py``, skipped without the netns capability, as the
reference's are).
"""

from __future__ import annotations

import pytest

from cilium_tpu_torch.plugins import netns
from torch_daemon_bar import cases, run_case

SOURCES = (
    cases("test_k8s.py", tests=[
        "test_watcher_end_to_end", "test_watcher_service_churn_retranslates",
        "test_watcher_modified_event_replaces_rules", "test_watcher_out_of_order_delete_then_add",
        "test_watcher_resync_heals_missed_events", "test_watcher_resync_heals_stale_endpoints"])
    + cases("test_k8s_parity.py", ["TestIngressToLB", "TestNodeWatcher", "TestCNPStatus"],
            tests=["test_crd_registration"])
    + cases("test_fqdn.py", ["TestDaemonFQDN"])
    + cases("test_xds.py", tests=[
        "TestNPDS::test_endpoint_policy_resource", "TestNPDS::test_daemon_publishes_npds_and_nphds",
        "TestNPDS::test_endpoint_delete_drops_identity_from_peer_scopes",
        "TestNPDS::test_endpoint_churn_releases_proxy_ports",
        "TestNPDS::test_regen_debounce_folds_bursts"])
    + cases("test_runtimes.py", tests=[
        "TestEventPath::test_pleg_start_die_events_create_endpoints",
        "TestEventPath::test_runtime_outage_is_tolerated"])
    + cases("test_docker_plugin.py", tests=[
        "test_activate_and_capabilities", "test_full_container_lifecycle",
        "test_errors_ride_the_err_field", "test_specific_address_request"])
)
# the endpoint's state as endpoint_add returns it races the debounced
# regeneration's thread
TIMING = {"test_xds.py::TestNPDS::test_regen_debounce_folds_bursts": {
    "unrecorded": ["Daemon.endpoint_add"]}}
CNI_WIRE = cases("test_cni_wire.py", ["TestRealInterfaces", "TestRealPacketsThroughPipeline"])


@pytest.mark.parametrize("case", SOURCES)
def test_sources(case, tmp_path):
    run_case(case, tmp_path, **TIMING.get(case, {}))


@pytest.mark.skipif(not netns.have_netns(), reason="no netns/veth capability")
@pytest.mark.parametrize("case", CNI_WIRE)
def test_cni_wire(case, tmp_path):
    run_case(case, tmp_path)
