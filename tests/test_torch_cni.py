"""Port parity: the CNI executable (``plugins/cni_exec.py``), the real
interface plumbing (``plugins/netns.py``, ``plugins/cni.py``) and real
packets through the wire front-end (``datapath/wire.py``).

``test_cni_exec.py``'s 3 tests: ``python -m cilium_tpu_torch.plugins.
cni_exec`` invoked as kubelet invokes it (CNI_* env, config on stdin,
JSON on stdout) against the JAX CLI agent (``python -m cilium_tpu.cli
... daemon``, the one agent with a REST server until A7c), and the JAX
executable against a twin agent: equal stdout JSON and exit codes at
every step. ``test_cni_wire.py``'s 4 tests build a ``Daemon``; here they
run through ``test_torch_workloads.WorkloadAgent`` (the ``Daemon``-built
runs stay in A7c's bar): each package's stand-in plumbs real veths into
real network namespaces, and the real UDP flows sniffed off the port's
veths are verdicted by both packages' enforcers, equal counts. Every
test skips without netns / veth capability, exactly as the reference's
do. Names are unique per test (uuid), and every wait is on a socket or a
poll.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
import uuid

import pytest

from test_torch_harness import PKGS, REPO
from test_torch_workloads import wns

from cilium_tpu_torch.plugins import netns as nsmod

pytestmark = pytest.mark.skipif(not nsmod.have_netns(), reason="no netns/veth capability")


def _invoke(pkg: str, command: str, sock: str, container_id: str, netns_path: str = "",
            cni_args: str = "", conf_text=None):
    env = dict(os.environ)
    env.update({"CNI_COMMAND": command, "CNI_CONTAINERID": container_id, "CNI_IFNAME": "eth0",
                "CNI_PATH": "/opt/cni/bin", "JAX_PLATFORMS": "cpu"})
    if netns_path:
        env["CNI_NETNS"] = netns_path
    if cni_args:
        env["CNI_ARGS"] = cni_args
    conf = conf_text if conf_text is not None else json.dumps({
        "cniVersion": "0.4.0", "name": "cilium-tpu", "type": "cilium-tpu", "socket": sock})
    r = subprocess.run([sys.executable, "-m", f"{pkg}.plugins.cni_exec"], input=conf,
                       capture_output=True, text=True, timeout=90, env=env, cwd=REPO)
    return r.returncode, (json.loads(r.stdout) if r.stdout.strip() else None), r.stderr


@pytest.fixture
def agents(tmp_path):
    """Two twin JAX CLI agents on the same pod CIDR: one for each
    package's executable → {package: socket}."""
    socks, procs = {}, []
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k, pkg in enumerate(PKGS):
        sock = str(tmp_path / f"agent{k}.sock")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cilium_tpu.cli", "--socket", sock, "--state",
             str(tmp_path / f"state{k}"), "daemon", "--pod-cidr", "10.79.0.0/24"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env, cwd=REPO))
        socks[pkg] = sock
    client = importlib.import_module("cilium_tpu_torch.api.client").APIClient
    deadline = time.monotonic() + 90
    for sock in socks.values():
        while True:
            try:
                client(sock, timeout=5).status()
                break
            except OSError:
                assert time.monotonic() < deadline, "agent did not come up"
                time.sleep(0.1)
    yield socks
    for p in procs:
        p.terminate()
        p.wait(timeout=10)


def _endpoints(sock):
    return importlib.import_module("cilium_tpu_torch.api.client").APIClient(sock).endpoint_list()


def test_version(agents):
    outs = [_invoke(pkg, "VERSION", agents[pkg], "any") for pkg in PKGS]
    assert outs[0] == outs[1]
    assert outs[1][0] == 0 and "0.4.0" in outs[1][1]["supportedVersions"]


def test_add_check_del_lifecycle(agents):
    """ADD (real veth, container side carrying the address), CHECK, DEL
    (interface and endpoint gone), DEL again, CHECK → unknown container:
    the JAX executable on one agent, then the port's on its twin, one
    container id and one netns, equal outputs."""
    cid = f"kubelet-{uuid.uuid4().hex[:8]}"
    ns = f"cniexec-{cid[-8:]}"
    path = f"/var/run/netns/{ns}"
    nsmod.create_netns(ns)
    try:
        outs = []
        for pkg in PKGS:
            sock, step = agents[pkg], []
            rc, result, err = _invoke(pkg, "ADD", sock, cid, netns_path=path, cni_args=(
                "IgnoreUnknown=1;K8S_POD_NAMESPACE=shop;K8S_POD_NAME=web-1"))
            assert rc == 0, (result, err)
            ip = result["ips"][0]["address"].split("/")[0]
            assert ip.startswith("10.79.0.") and result["ips"][0]["gateway"] == "10.79.0.1"
            host_if = result["interfaces"][0]["name"]
            assert nsmod._run("link", "show", host_if).returncode == 0
            assert ip in nsmod.netns_run(ns, ["ip", "-o", "addr", "show", "eth0"]).stdout
            ep = next(e for e in _endpoints(sock) if e.get("ipv4") == ip)
            assert any("io.kubernetes.pod.namespace=shop" in str(x) for x in ep["labels"])
            step += [rc, result, ep["id"], sorted(ep["labels"]), ep["identity"]]
            step.append(_invoke(pkg, "CHECK", sock, cid, netns_path=path)[:2])
            step.append(_invoke(pkg, "DEL", sock, cid)[:2])
            assert step[-2][0] == 0 and step[-1][0] == 0
            assert nsmod._run("link", "show", host_if, check=False).returncode != 0
            assert not any(e.get("ipv4") == ip for e in _endpoints(sock))
            step.append(_invoke(pkg, "DEL", sock, cid)[:2])
            assert step[-1][0] == 0
            rc, out, _err = _invoke(pkg, "CHECK", sock, cid, netns_path=path)
            assert rc == 1 and out["code"] == 3
            outs.append(step + [rc, out])
        assert outs[0] == outs[1]
    finally:
        nsmod.delete_netns(ns)


def test_structured_errors_never_tracebacks(agents):
    outs = []
    for pkg in PKGS:
        sock = agents[pkg]
        rc, err, _ = _invoke(pkg, "ADD", sock, "c1")
        assert rc == 1 and err["code"] == 4 and "CNI_NETNS" in err["msg"]
        bad = _invoke(pkg, "ADD", sock, "c2", netns_path="/var/run/netns/none",
                      conf_text="{not json")
        assert bad[0] == 1 and bad[1]["code"] == 6
        down = _invoke(pkg, "ADD", sock + ".nope", "c3", netns_path="/var/run/netns/none")
        assert down[0] == 1 and down[1]["code"] == 11
        newer = _invoke(pkg, "ADD", sock, "c4", netns_path="/var/run/netns/none",
                        conf_text=json.dumps({"cniVersion": "1.0.0", "socket": sock}))
        assert newer[0] == 1 and newer[1]["code"] == 1
        outs.append([err, bad[:2], [down[0], down[1]["code"]], newer[:2],
                     _invoke(pkg, "BOGUS", sock, "c5")[:2]])
    # the down agent's message names its own socket: compare the codes only
    assert outs[0] == outs[1]


# -- test_cni_wire.py through the stand-ins ---------------------------------------------


WIRE_POLICY = json.dumps([{
    "endpointSelector": {"matchLabels": {"k8s:app": "web"}},
    "ingress": [{
        "fromEndpoints": [{"matchLabels": {"k8s:app": "client"}}],
        "toPorts": [{"ports": [{"port": "9053", "protocol": "UDP"}]}],
    }],
    "labels": ["k8s:policy=wire"],
}])


@pytest.fixture
def world():
    """Per package a stand-in on 10.77.0.0/24 where 'web' accepts UDP 9053
    from 'client' only; the containers and namespaces made are cleaned up."""
    made = []

    def make(pkg):
        m = wns(pkg)
        d = m.WorkloadAgent(pod_cidr="10.77.0.0/24")
        d.policy_replace(["k8s:policy=wire"], WIRE_POLICY)
        rec = (m, d, [], [])
        made.append(rec)
        return rec

    yield make
    for m, d, containers, namespaces in made:
        for cid in containers:
            try:
                m.cni.cni_del(d, cid)
            except Exception:
                pass
        for ns in namespaces:
            nsmod.delete_netns(ns)
        d.shutdown()


def _container(rec, app: str, cid: str = None, real: bool = True):
    """A netns and a real CNI ADD (or, ``real`` False, the virtual flow)
    → (container id, CNIResult, netns name)."""
    m, d, containers, namespaces = rec
    cid = cid or f"{app}-{uuid.uuid4().hex[:8]}"
    ns = None
    if real:
        ns = f"ctt-{uuid.uuid4().hex[:11]}"
        nsmod.create_netns(ns)
        namespaces.append(ns)
    res = m.cni.cni_add(d, cid, labels=[f"k8s:app={app}"], netns=ns)
    containers.append(cid)
    return cid, res, ns


@pytest.mark.parametrize("pkg", PKGS)
def test_veth_exists_and_container_connectivity(world, pkg):
    """ADD plumbs a working interface: a real datagram from the container
    reaches a host listener on the gateway, its source the endpoint's
    address."""
    import socket as _socket
    import threading

    _cid, res, ns = _container(world(pkg), "client")
    assert nsmod._run("link", "show", res.interface).returncode == 0
    assert res.ipv4 in nsmod.netns_run(ns, ["ip", "-o", "addr", "show", "eth0"]).stdout
    got = []
    srv = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
    srv.bind((res.gateway, 0))
    port = srv.getsockname()[1]
    srv.settimeout(10)

    def rx():
        try:
            got.append(srv.recvfrom(1024))
        except OSError:
            pass

    t = threading.Thread(target=rx, daemon=True)
    t.start()
    code = ("import socket;s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM);"
            f"s.sendto(b'hello-wire', ('{res.gateway}', {port}))")
    r = nsmod.netns_run(ns, ["python3", "-c", code])
    assert r.returncode == 0, r.stderr
    t.join(timeout=10)
    srv.close()
    assert got and got[0][0] == b"hello-wire"
    assert got[0][1][0] == res.ipv4


@pytest.mark.parametrize("pkg", PKGS)
def test_del_removes_interface(world, pkg):
    rec = world(pkg)
    m, d, containers, _ = rec
    cid, res, _ns = _container(rec, "client")
    assert nsmod._run("link", "show", res.interface).returncode == 0
    assert m.cni.cni_del(d, cid)
    assert nsmod._run("link", "show", res.interface, check=False).returncode != 0
    assert d.ipam.owner_of(res.ipv4) is None
    containers.remove(cid)


@pytest.mark.parametrize("pkg", PKGS)
def test_failure_rolls_back_interface_and_ip(world, pkg):
    """A failed endpoint registration removes the created veth and
    releases the address."""
    rec = world(pkg)
    m, d, _, namespaces = rec
    ns = f"ctt-rb-{uuid.uuid4().hex[:8]}"
    nsmod.create_netns(ns)
    namespaces.append(ns)
    cid = f"rollback-{uuid.uuid4().hex[:8]}"
    before = len(d.ipam)
    real_add = d.endpoint_add
    d.endpoint_add = lambda *a, **k: (_ for _ in ()).throw(ValueError("forced registration failure"))
    try:
        with pytest.raises(m.cni.CNIError):
            m.cni.cni_add(d, cid, labels=["k8s:app=x"], netns=ns)
    finally:
        d.endpoint_add = real_add
    host_if = m.cni.host_ifname(m.cni.endpoint_id_for(cid))
    assert nsmod._run("link", "show", host_if, check=False).returncode != 0, "veth leaked"
    assert len(d.ipam) == before, "IP leaked"


def test_wire_verdicts_match_policy(world):
    """Two containers send real UDP to the web endpoint's address; the
    AF_PACKET front-end on the port stand-in's host veths verdicts every
    captured flow on its pipeline: client forwarded, other dropped by
    policy, with CT creation for the allowed flows. The same captured
    flows through the JAX stand-in (the same containers, plumbed
    virtually): equal verdict counts."""
    port, ref = world("cilium_tpu_torch"), world("cilium_tpu")
    tag = uuid.uuid4().hex[:8]
    made = {}
    for rec, real in ((port, True), (ref, False)):
        made[rec[0].pkg] = {app: _container(rec, app, cid=f"{app}-{tag}", real=real)
                            for app in ("client", "other", "web")}
    m, d = port[0], port[1]
    p = made[m.pkg]
    assert {a: r.ipv4 for a, (_c, r, _n) in p.items()} == {
        a: r.ipv4 for a, (_c, r, _n) in made["cilium_tpu"].items()}
    web = p["web"][1]
    sniffers = [m.wire.VethSniffer(p[a][1].interface).start() for a in ("client", "other")]
    enforcer = m.wire.WireEnforcer(d.pipeline, {web.ipv4: web.endpoint_id})
    flows = []
    try:
        send = ("import socket;s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM);"
                "[s.sendto(b'x', ('{dst}', 9053)) for _ in range(5)]")
        for a in ("client", "other"):
            r = nsmod.netns_run(p[a][2], ["python3", "-c", send.format(dst=web.ipv4)])
            assert r.returncode == 0, r.stderr
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            batch = [f for s in sniffers for f in s.drain()]
            flows += batch
            enforcer.process_flows(batch)
            counts = enforcer.verdicts.get(web.endpoint_id, {})
            if counts.get(m.FORWARD, 0) >= 5 and counts.get(m.DROP_POLICY, 0) >= 5:
                break
            time.sleep(0.05)
    finally:
        for s in sniffers:
            s.stop()
    counts = enforcer.verdicts[web.endpoint_id]
    assert counts.get(m.FORWARD, 0) >= 5, counts
    assert counts.get(m.DROP_POLICY, 0) >= 5, counts
    ref_enf = ref[0].wire.WireEnforcer(ref[1].pipeline, {web.ipv4: web.endpoint_id})
    assert ref_enf.process_flows(flows) == sum(counts.values())
    assert ref_enf.verdicts == enforcer.verdicts
    # CT creation for the allowed flows: a replay finds them established
    est = []
    real = d.conntrack.lookup_batch
    d.conntrack.lookup_batch = lambda *a, **k: est.append(real(*a, **k)) or est[-1]
    enforcer.process_flows(flows)
    assert int((est[0][0] == m.conntrack.CT_ESTABLISHED).sum()) >= 1
