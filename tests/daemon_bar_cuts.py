"""Reference tests cut to the part that needs no CLI, in the reference's
own style, for ``torch_daemon_bar`` to run through both packages.

``TestDebuginfoAndBugtool.test_rest_and_cli`` of ``test_health_bugtool.py``
without its ``cilium bugtool`` leg: the CLI comes with the next slice.
"""

from __future__ import annotations

import json

import pytest

RULES = [{
    "endpointSelector": {"matchLabels": {"k8s:app": "web"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"k8s:app": "lb"}}],
                 "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}]}]}],
    "labels": ["k8s:policy=hb"],
}]


class TestDebuginfoAndBugtool:
    @pytest.fixture()
    def daemon(self):
        from cilium_tpu.daemon import Daemon

        d = Daemon(health_probe=lambda a, p: 0.001)
        d.policy_add(json.dumps(RULES))
        d.endpoint_add(7, ["k8s:app=web"], ipv4="10.1.0.7")
        d.endpoint_add(9, ["k8s:app=lb"], ipv4="10.1.0.9")
        d.service_upsert({"ip": "10.96.0.1", "port": 443},
                         [{"ip": "10.1.0.7", "port": 8443}])
        yield d
        d.shutdown()

    def test_rest_and_cli(self, daemon, tmp_path):
        from cilium_tpu.api.client import APIClient
        from cilium_tpu.api.server import APIServer

        sock = str(tmp_path / "api.sock")
        srv = APIServer(daemon, sock)
        srv.start()
        try:
            c = APIClient(sock)
            assert c.health()["total"] == 0
            assert c.health_probe()["total"] == 0
            info = c.debuginfo()
            assert info["status"]["endpoints"] == 2
        finally:
            srv.stop()
