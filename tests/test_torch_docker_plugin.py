"""Port parity: the Docker libnetwork plugin (``plugins/docker.py``).

The 4 tests of the reference's ``test_docker_plugin.py`` over the real
plugin socket (Activate → RequestPool → RequestAddress → CreateEndpoint
→ Join → Leave → DeleteEndpoint → ReleaseAddress), through both
packages. The reference's fixture builds a ``Daemon``; the port has none
until A7c, so each package's plugin fronts
``test_torch_workloads.WorkloadAgent`` (the ``Daemon``-built runs stay in
A7c's bar). Every reply is held equal across packages, and the lifecycle
also verdicts frames to the joined endpoint's address between Join and
Leave. Tolerance 0: every value compared is an integer, a string or a
bool.
"""

from __future__ import annotations

import http.client
import importlib
import json
import socket

import pytest

from test_torch_harness import PKGS
from test_torch_workloads import eth_frame, u32, wns


class _UnixHTTP(http.client.HTTPConnection):
    def __init__(self, path: str):
        super().__init__("localhost")
        self._path = path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(self._path)


def _call(sock_path: str, method: str, body=None):
    c = _UnixHTTP(sock_path)
    c.request("POST", f"/{method}", body=json.dumps(body or {}),
              headers={"Content-Type": "application/json"})
    resp = c.getresponse()
    out = json.loads(resp.read().decode())
    c.close()
    return out


def both(tmp_path, scenario):
    """``scenario(m, d, sock)`` on each package's plugin over its own
    stand-in; the two results must be equal."""
    outs = []
    for pkg in PKGS:
        m = wns(pkg)
        d = m.WorkloadAgent()
        sock = str(tmp_path / f"docker-{pkg}.sock")
        p = importlib.import_module(f"{pkg}.plugins.docker").DockerPlugin(d, sock).start()
        try:
            outs.append(scenario(m, d, sock))
        finally:
            p.stop()
            d.shutdown()
    assert outs[0] == outs[1]
    return outs[0]


def test_activate_and_capabilities(tmp_path):
    def run(m, d, sock):
        act = _call(sock, "Plugin.Activate")
        assert act == {"Implements": ["NetworkDriver", "IpamDriver"]}
        caps = _call(sock, "NetworkDriver.GetCapabilities")
        assert caps == {"Scope": "local"}
        spaces = _call(sock, "IpamDriver.GetDefaultAddressSpaces")
        assert spaces["LocalDefaultAddressSpace"] == "CiliumLocal"
        return [act, caps, spaces, _call(sock, "IpamDriver.GetCapabilities")]

    both(tmp_path, run)


def test_full_container_lifecycle(tmp_path):
    def run(m, d, sock):
        out = []
        pool = _call(sock, "IpamDriver.RequestPool", {"AddressSpace": "CiliumLocal"})
        assert pool["PoolID"] == "CiliumPoolv4" and pool["Pool"] == str(d.ipam.net)
        addr = _call(sock, "IpamDriver.RequestAddress", {"PoolID": pool["PoolID"]})
        ip = addr["Address"].split("/")[0]
        assert d.ipam.owner_of(ip) == "docker"
        eid = "deadbeef" * 8
        out += [pool, addr, _call(sock, "NetworkDriver.CreateNetwork", {"NetworkID": "net1"})]
        r = _call(sock, "NetworkDriver.CreateEndpoint", {
            "NetworkID": "net1", "EndpointID": eid, "Interface": {"Address": addr["Address"]}})
        assert "Err" not in r
        join = _call(sock, "NetworkDriver.Join", {
            "NetworkID": "net1", "EndpointID": eid, "SandboxKey": "/proc/1/ns/net"})
        assert join["InterfaceName"]["DstPrefix"] == "eth"
        eps = d.endpoint_list()
        assert any(e["ipv4"] == ip for e in eps), eps
        info = _call(sock, "NetworkDriver.EndpointOperInfo", {"EndpointID": eid})
        # frames to the joined endpoint: its identity is the docker label's
        ep_id = info["Value"]["ep_id"]
        frames = [eth_frame(u32(f"10.0.0.{k}"), u32(ip), 6, 40000 + k, 80) for k in range(16)]
        enf = m.wire.WireEnforcer(d.pipeline, {ip: ep_id})
        n = enf.process_flows([m.wire.parse_ipv4_frame(f) for f in frames])
        assert n == 16
        out += [r, join, [sorted(e.items()) for e in eps], info, n, sorted(enf.verdicts[ep_id].items())]
        _call(sock, "NetworkDriver.Leave", {"NetworkID": "net1", "EndpointID": eid})
        assert not any(e["ipv4"] == ip for e in d.endpoint_list())
        assert d.pipeline.endpoint_index(ep_id) is None
        # Leave's endpoint_delete released the address (daemon.py:562), so
        # ReleaseAddress finds it free
        assert d.ipam.owner_of(ip) is None
        out.append(_call(sock, "NetworkDriver.DeleteEndpoint", {"EndpointID": eid}))
        out.append(_call(sock, "IpamDriver.ReleaseAddress",
                         {"PoolID": pool["PoolID"], "Address": addr["Address"]}))
        assert d.ipam.owner_of(ip) is None
        return out + [len(d.ipam), d.asks]

    both(tmp_path, run)


def test_errors_ride_the_err_field(tmp_path):
    def run(m, d, sock):
        r1 = _call(sock, "NetworkDriver.Join", {"EndpointID": "unknown"})
        assert "Err" in r1 and "unknown endpoint" in r1["Err"]
        r2 = _call(sock, "NoSuch.Method")
        assert "Err" in r2
        r3 = _call(sock, "IpamDriver.RequestPool", {"V6": True})
        assert "Err" in r3 and "IPv6" in r3["Err"]
        return [r1, r2, r3]

    both(tmp_path, run)


@pytest.mark.parametrize("offset", [100, 2])
def test_specific_address_request(tmp_path, offset):
    def run(m, d, sock):
        base = d.ipam.net.network_address + offset
        r = _call(sock, "IpamDriver.RequestAddress",
                  {"PoolID": "CiliumPoolv4", "Address": str(base)})
        assert r["Address"].split("/")[0] == str(base)
        again = _call(sock, "IpamDriver.RequestAddress",
                      {"PoolID": "CiliumPoolv4", "Address": str(base)})
        assert "Err" in again
        nxt = _call(sock, "IpamDriver.RequestAddress", {"PoolID": "CiliumPoolv4"})
        return [r, again, nxt]

    both(tmp_path, run)
