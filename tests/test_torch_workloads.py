"""Port parity: the workload runtimes' host modules (``ipam``, ``mtu``,
``plugins/``, ``workloads``, ``runtimes``, ``datapath/wire``, ``api/``'s
client and unix HTTP scaffold, ``health/``), copied from the JAX package.

The Daemon-free tests of the reference's ``test_maps_infra.py``
(``TestIPAM``) and ``test_small_infra.py`` (``TestMTU``) run through both
packages and must return equal results. The reference's CNI and
workload-watcher tests build a ``Daemon``; the port has none until A7c,
so they run here through ``WorkloadAgent``, a stand-in holding what
``daemon.py`` builds and these modules call: a real ``IPAM`` over the pod
CIDR, an ``EndpointManager`` of real ``Endpoint``s, the identity registry,
the ipcache, the engine, and a pipeline built as ``daemon.py:114-124``
builds it (a prefilter, a ``FlowConntrack``, a ``ServiceManager`` as
``lb=``). One test holds the JAX stand-in to the JAX ``Daemon`` on one
event sequence. ``WireEnforcer`` is held across packages on seeded worlds
and frames: flows enforced, per-endpoint verdict counts and the lanes of
every pipeline call, before and after churn and on the conntrack replay.
``test_maps_infra.py``'s lxcmap assertion (``TestCNIAndWorkloads``) reads
a ``Daemon``'s map and moves to A7c's bar.

The copy check holds the 17 copied modules to their references line for
line. Tolerance 0: every value compared is an integer, a string or a bool.
"""

from __future__ import annotations

import importlib
import ipaddress
import json
import random
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_harness import APPS, PKGS, PORTS, REPO, TEAMS, build_world
from test_torch_k8s import Agent, ns as k8s_ns

# module -> the lines that differ from the reference: each names the package
# (docstrings, the argparse prog), the heavy import a sidecar avoids (JAX in
# the reference, torch in the port), or a reference path outside the repo
COPIED = {
    "api/__init__.py": {3}, "api/unixhttp.py": {7}, "api/client.py": set(),
    "ipam.py": set(), "mtu.py": set(), "plugins/__init__.py": set(),
    "plugins/netns.py": set(), "plugins/cni.py": set(), "plugins/cni_exec.py": {10},
    "plugins/docker.py": {3}, "workloads.py": set(), "runtimes.py": set(),
    "datapath/wire.py": set(), "health/__init__.py": set(), "health/prober.py": set(),
    "health/standalone.py": {17, 198}, "health/__main__.py": {1},
}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def wns(pkg: str):
    """test_torch_k8s.ns(pkg) with the names the workload modules and their
    stand-in need."""
    m = k8s_ns(pkg)
    endpoint = _mod(pkg, "endpoint")
    m.IPAM = _mod(pkg, "ipam").IPAM
    m.IPAMError = _mod(pkg, "ipam").IPAMError
    m.MTUConfig = _mod(pkg, "mtu").MTUConfig
    m.Endpoint = endpoint.Endpoint
    m.EndpointState = endpoint.EndpointState
    m.EndpointManager = endpoint.EndpointManager
    m.PreFilter = _mod(pkg, "ipcache.prefilter").PreFilter
    m.conntrack = _mod(pkg, "datapath.conntrack")
    m.Trigger = _mod(pkg, "utils.trigger").Trigger
    m.cni = _mod(pkg, "plugins.cni")
    m.workloads = _mod(pkg, "workloads")
    m.wire = _mod(pkg, "datapath.wire")
    datapath = _mod(pkg, "datapath")
    m.FORWARD, m.DROP_POLICY = int(datapath.FORWARD), int(datapath.DROP_POLICY)
    m.WorkloadAgent = lambda **kw: WorkloadAgent(m, **kw)
    return m


class WorkloadAgent(Agent):
    """The stand-in for the Daemon that CNI, the Docker plugin and the
    workload watcher drive, over package ``m``. It holds what daemon.py
    builds and they call: ``ipam`` (a real ``IPAM``), ``endpoint_manager``
    (real ``Endpoint``s), the registry, the ipcache, the engine, and
    ``pipeline``, a DatapathPipeline with a PreFilter, ``conntrack=`` a
    FlowConntrack and ``lb=`` a ServiceManager (daemon.py:114-124).
    ``endpoint_add`` / ``endpoint_delete`` / ``endpoint_list`` do what
    daemon.py:506-585 does; a regeneration is
    ``EndpointManager.regenerate_all`` (daemon.py:786), folded on a
    ``Trigger`` when ``regen_debounce`` > 0 (daemon.py:236-250). The
    policy methods are ``Agent``'s. ``world`` (a test_torch_harness.World)
    lends its repository, registry and ipcache."""

    def __init__(self, m, pod_cidr: str = "10.200.0.0/16", regen_debounce: float = 0.0,
                 world=None):
        self.m = m
        self.repo = world.repo if world else m.Repository()
        self.registry = world.reg if world else m.IdentityRegistry()
        self.ipcache = world.ipcache if world else m.IPCache()
        self.prefilter = m.PreFilter()
        self.engine = m.PolicyEngine(self.repo, self.registry, **m.cpu)
        self.conntrack = m.conntrack.FlowConntrack()
        self.services = m.ServiceManager()
        self.pipeline = m.DatapathPipeline(self.engine, self.ipcache, self.prefilter,
                                           conntrack=self.conntrack, lb=self.services, **m.cpu)
        self.ipam = m.IPAM(pod_cidr)
        self.endpoint_manager = m.EndpointManager()
        self._lock = threading.RLock()
        self.asks = []  # every regeneration asked for
        self.regenerations = []  # the reason of every regeneration run
        self.regen_errors = []
        self._covered = 0  # asks a finished regeneration covered
        self._regen_trigger = None
        if regen_debounce > 0:
            self._regen_trigger = m.Trigger(
                lambda reasons: self._regenerate_now("; ".join(reasons) or "debounced",
                                                     len(reasons)),
                min_interval=regen_debounce, name="fleet-regeneration")

    def _regenerate(self, reason: str) -> None:
        self.asks.append(reason)
        if self._regen_trigger is not None:
            self._regen_trigger.trigger(reason)
            return
        self._regenerate_now(reason, 1)

    def _regenerate_now(self, reason: str, n_asks: int) -> None:
        try:
            self.endpoint_manager.regenerate_all(self.pipeline, reason)
        except BaseException as e:  # the trigger's loop swallows it: kept for settle()
            self.regen_errors.append(e)
            raise
        finally:
            self.regenerations.append(reason)
            self._covered += n_asks

    def settle(self, timeout: float = 60.0) -> None:
        """Waits until a finished regeneration covers every ask."""
        deadline = time.monotonic() + timeout
        while self._covered < len(self.asks):
            assert time.monotonic() < deadline, "regenerations did not settle"
            time.sleep(0.01)
        if self.regen_errors:
            raise self.regen_errors[0]

    def _sync_pipeline_endpoints(self) -> None:
        eps = self.endpoint_manager.endpoints()
        self.pipeline.set_endpoints([(ep.id, ep.identity.id) for ep in eps if ep.identity])

    def endpoint_add(self, endpoint_id: int, labels, *, ipv4=None, ipv6=None,
                     pod_name: str = "") -> dict:
        m = self.m
        with self._lock:
            if self.endpoint_manager.lookup(endpoint_id) is not None:
                raise ValueError(f"endpoint {endpoint_id} exists")
            lbls = m.parse_label_array(labels)
            ep = m.Endpoint(endpoint_id, lbls, ipv4=ipv4, ipv6=ipv6, pod_name=pod_name)
            ep.set_state(m.EndpointState.WAITING_FOR_IDENTITY)
            ep.identity = self.registry.allocate(lbls)
            ep.set_state(m.EndpointState.READY)
            self.endpoint_manager.insert(ep)
            if ipv4:
                self.ipcache.upsert(f"{ipv4}/32", ep.identity.id, source=m.SOURCE_AGENT)
            if ipv6:
                self.ipcache.upsert(f"{ipv6}/128", ep.identity.id, source=m.SOURCE_AGENT)
            self._sync_pipeline_endpoints()
            self._regenerate("endpoint created")
        return self._endpoint_model(ep)

    def endpoint_delete(self, endpoint_id: int) -> bool:
        m = self.m
        with self._lock:
            ep = self.endpoint_manager.lookup(endpoint_id)
            if ep is None:
                return False
            self.endpoint_manager.remove(ep)
            if ep.ipv4:
                self.ipcache.delete(f"{ep.ipv4}/32", m.SOURCE_AGENT)
                self.ipam.release(ep.ipv4)
            if ep.ipv6:
                self.ipcache.delete(f"{ep.ipv6}/128", m.SOURCE_AGENT)
            if ep.identity is not None:
                self.registry.release(ep.identity)
            self._sync_pipeline_endpoints()
            self._regenerate("endpoint deleted")
        return True

    def endpoint_list(self) -> list:
        return [self._endpoint_model(ep) for ep in self.endpoint_manager.endpoints()]

    @staticmethod
    def _endpoint_model(ep) -> dict:
        return {"id": ep.id, "labels": list(ep.labels.to_strings()),
                "identity": ep.identity.id if ep.identity else None, "ipv4": ep.ipv4,
                "ipv6": ep.ipv6, "state": str(ep.state.value),
                "policy_revision": ep.policy_revision}

    def shutdown(self) -> None:
        if self._regen_trigger is not None:
            self._regen_trigger.shutdown()
        self.endpoint_manager.shutdown()


def both(scenario):
    """Run ``scenario(m)`` on each package; the two results must be equal."""
    outs = [scenario(wns(pkg)) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


@pytest.fixture(params=PKGS)
def m(request):
    return wns(request.param)


# -- frames ---------------------------------------------------------------------------


def eth_frame(src: int, dst: int, proto: int, sport: int, dport: int, *, vlan=None, frag=0,
              ihl=5, ethertype=0x0800, cut=None) -> bytes:
    """An Ethernet frame carrying an IPv4 packet (802.1Q-tagged with
    ``vlan``), its L4 ports and 8 payload bytes, cut to ``cut`` bytes."""
    l2 = b"\x02\x00\x00\x00\x00\x01\x02\x00\x00\x00\x00\x02"
    l2 += (struct.pack(">HHH", 0x8100, vlan, ethertype) if vlan is not None
           else struct.pack(">H", ethertype))
    opts = bytes(range(4 * (ihl - 5)))
    body = struct.pack(">HH", sport, dport) + b"\x00\x10\x00\x00" + b"payload!"
    ip = struct.pack(">BBHHHBBHII", 0x40 | ihl, 0, 4 * ihl + len(body), 7, frag, 64, proto, 0,
                     src, dst) + opts
    frame = l2 + ip + body
    return frame if cut is None else frame[:cut]


def frame_corpus(seed: int, srcs, dsts, n: int):
    """``n`` seeded frames over ``srcs`` x ``dsts``: plain, 1/8 802.1Q,
    some with IP options, non-first fragments, truncated and non-IPv4."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        port = rng.choice(PORTS + [5432, 22])
        proto = 17 if port == 53 else rng.choice((6, 6, 6, 17, 1))
        kw = {"vlan": rng.randrange(1, 4095) if rng.random() < 1 / 8 else None}
        r = rng.random()
        if r < 0.05:
            kw["ihl"] = rng.randint(6, 15)
        elif r < 0.09:
            kw["frag"] = rng.randint(1, 0x1FFF) | (0x2000 if rng.random() < 0.5 else 0)
        elif r < 0.11:
            kw["frag"] = 0x2000  # more fragments, offset 0: the first fragment
        elif r < 0.13:
            kw["cut"] = rng.randrange(0, 46)
        elif r < 0.15:
            kw["ethertype"] = rng.choice((0x0806, 0x86DD, 0x88CC))
        out.append(eth_frame(rng.choice(srcs), rng.choice(dsts), proto, rng.randrange(1024, 65536),
                             port, **kw))
    return out


def u32(ip: str) -> int:
    return int(ipaddress.IPv4Address(ip))


# -- the copies -----------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(COPIED))
def test_copies_match_the_reference(path):
    """Each port module equals its reference line for line, but for the
    lines COPIED names, each a line that names the package."""
    ref = (REPO / "cilium_tpu" / path).read_text().splitlines()
    port = (REPO / "cilium_tpu_torch" / path).read_text().splitlines()
    assert len(ref) == len(port), path
    differ = {k for k, (x, y) in enumerate(zip(ref, port), 1) if x != y}
    assert differ == COPIED[path], (path, sorted(differ))


def test_api_server_waits_for_the_daemon():
    """``api.APIServer`` came with ``api/server.py`` and the daemon: the
    lazy export resolves to the server, as the client's names do."""
    api = _mod("cilium_tpu_torch", "api")
    assert api.APIServer is _mod("cilium_tpu_torch", "api.server").APIServer
    assert api.APIClient is _mod("cilium_tpu_torch", "api.client").APIClient
    assert api.APIError is _mod("cilium_tpu_torch", "api.client").APIError
    assert api.__all__ == _mod("cilium_tpu", "api").__all__


def test_sidecar_imports_load_no_torch():
    """The CNI executable and the health child start without torch: a
    fresh interpreter imports their modules and the API client's."""
    code = ("import sys\n"
            "import cilium_tpu_torch.api.client, cilium_tpu_torch.api.unixhttp\n"
            "import cilium_tpu_torch.plugins.cni_exec, cilium_tpu_torch.health.standalone\n"
            "import cilium_tpu_torch.health.__main__\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- test_maps_infra.py / test_small_infra.py: IPAM and MTU ------------------------------


def test_ipam_allocate_release_cycle():
    def run(m):
        pool = m.IPAM("10.200.0.0/29", reserve_base=2)
        ips = [pool.allocate_next("a"), pool.allocate_next("b")]
        assert ips == ["10.200.0.2", "10.200.0.3"]
        assert pool.owner_of(ips[0]) == "a"
        remaining = []
        while True:
            try:
                remaining.append(pool.allocate_next())
            except m.IPAMError:
                break
        assert "10.200.0.7" not in ips + remaining
        assert "10.200.0.0" not in ips + remaining
        assert pool.release(ips[0]) and not pool.release(ips[0])
        again = pool.allocate_next()
        assert again == ips[0]
        return [ips, remaining, again, len(pool), pool.capacity]

    both(run)


def test_ipam_explicit_allocate():
    def run(m):
        pool = m.IPAM("10.200.0.0/24")
        assert pool.allocate("10.200.0.77", "restore") == "10.200.0.77"
        errs = []
        for ip in ("10.200.0.77", "10.201.0.1"):
            with pytest.raises(m.IPAMError) as e:
                pool.allocate(ip)
            errs.append(str(e.value))
        # a released explicit address is handed out again before fresh ones
        pool.release("10.200.0.77")
        return [errs, [pool.allocate_next("x") for _ in range(3)], pool.owner_of("10.200.0.2")]

    both(run)


def test_mtu_route_mtu_subtracts_encap():
    def run(m):
        cfg = m.MTUConfig(device_mtu=1500, tunnel="vxlan")
        assert cfg.device == 1500 and cfg.route_mtu == 1450
        assert m.MTUConfig(tunnel="disabled").route_mtu == 1500
        errs = []
        for kw in ({"device_mtu": 100}, {"tunnel": "genve"}, {"device_mtu": 600, "tunnel": "vxlan"}):
            with pytest.raises(ValueError) as e:
                m.MTUConfig(**kw)
            errs.append(str(e.value))
        assert "payload" in errs[2]
        return [cfg.route_mtu, m.MTUConfig(tunnel="geneve").route_mtu, errs]

    both(run)


# -- parse_ipv4_frame ------------------------------------------------------------------


def test_parse_ipv4_frame_corpus():
    """A seeded corpus (plain, 802.1Q, IHL with options, first and
    non-first fragments, non-IPv4) and every frame of a few cut at every
    length up to past its ports: equal tuples (or None) in both packages,
    and the reference's rules on the known cases."""
    srcs = [u32(f"10.0.{i}.1") for i in range(8)]
    dsts = [u32(f"10.77.0.{i}") for i in range(2, 10)]
    frames = frame_corpus(5, srcs, dsts, 3000)
    for kw in ({}, {"vlan": 5}, {"ihl": 7}, {"vlan": 9, "ihl": 15}, {"frag": 40}):
        whole = eth_frame(srcs[0], dsts[0], 6, 40000, 80, **kw)
        frames += [whole[:k] for k in range(len(whole) + 1)]
    outs = {pkg: [_mod(pkg, "datapath.wire").parse_ipv4_frame(f) for f in frames] for pkg in PKGS}
    assert outs["cilium_tpu"] == outs["cilium_tpu_torch"]
    got = outs["cilium_tpu_torch"]
    assert sum(t is None for t in got) > 100 and sum(t is not None for t in got) > 2000
    parse = _mod("cilium_tpu_torch", "datapath.wire").parse_ipv4_frame
    assert parse(eth_frame(srcs[1], dsts[2], 17, 5353, 53, vlan=3)) == (srcs[1], dsts[2], 17, 5353, 53)
    assert parse(eth_frame(srcs[1], dsts[2], 6, 5353, 80, frag=0x2005)) == (srcs[1], dsts[2], 6, 0, 0)
    assert parse(eth_frame(srcs[1], dsts[2], 6, 5353, 80, frag=0x2000)) == (srcs[1], dsts[2], 6, 5353, 80)
    assert parse(eth_frame(srcs[1], dsts[2], 1, 5353, 80)) == (srcs[1], dsts[2], 1, 0, 0)
    assert parse(eth_frame(srcs[1], dsts[2], 6, 1, 2, ihl=4)) is None
    assert parse(eth_frame(srcs[1], dsts[2], 6, 1, 2, ethertype=0x86DD)) is None
    # ports only when the L4 header's first four bytes are there
    whole = eth_frame(srcs[1], dsts[2], 6, 4242, 443, ihl=6)
    assert parse(whole[:14 + 24 + 3]) == (srcs[1], dsts[2], 6, 0, 0)
    assert parse(whole[:14 + 24 + 4]) == (srcs[1], dsts[2], 6, 4242, 443)


# -- TestCNIAndWorkloads through the stand-ins ------------------------------------------


def test_cni_add_del():
    def run(m):
        d = m.WorkloadAgent()
        try:
            res = m.cni.cni_add(d, "abc123def456", labels=["container:app=web"])
            assert res.ipv4 and res.endpoint_id >= 4096
            ep = d.endpoint_manager.lookup(res.endpoint_id)
            assert ep is not None and ep.ipv4 == res.ipv4
            ident = ep.identity.id
            assert d.ipcache.lookup_by_ip(res.ipv4).identity == ident
            assert d.pipeline.endpoint_index(res.endpoint_id) == 0
            assert m.cni.cni_del(d, "abc123def456")
            assert d.endpoint_manager.lookup(res.endpoint_id) is None
            assert d.ipam.owner_of(res.ipv4) is None
            assert d.pipeline.endpoint_index(res.endpoint_id) is None
            assert not m.cni.cni_del(d, "abc123def456")  # idempotent
            return [res.to_dict(), ident, len(d.ipam), d.asks]
        finally:
            d.shutdown()

    out = both(run)
    assert out[0]["interface"] == f"lxc{out[0]['endpoint_id']}" and out[0]["gateway"] == "10.200.0.1"


def test_workload_watcher_sync():
    def run(m):
        wl = m.workloads

        class FakeRuntime:
            def __init__(self):
                self.live = []

            def containers(self):
                return list(self.live)

        d = m.WorkloadAgent()
        try:
            rt = FakeRuntime()
            w = wl.WorkloadWatcher(d, rt)
            rt.live = [wl.ContainerInfo(id="c1" * 6, labels={"app": "web"}),
                       wl.ContainerInfo(id="c2" * 6, labels={wl.IGNORE_LABEL: "true"})]
            assert w.sync() == 1  # ignored container skipped
            ep_id = w.endpoint_of("c1" * 6)
            ep = d.endpoint_manager.lookup(ep_id)
            labels = sorted(str(x) for x in ep.labels)
            assert "container:app=web" in labels
            assert w.endpoint_of("c2" * 6) is None
            # an endpoint that already exists is adopted, not created again
            pre = m.cni.cni_add(d, "c3" * 6, labels=["container:app=db"])
            rt.live.append(wl.ContainerInfo(id="c3" * 6, labels={"app": "db"}))
            assert w.sync() == 1 and w.endpoint_of("c3" * 6) == pre.endpoint_id
            n_eps = len(d.endpoint_manager)
            rt.live = []
            assert w.sync() == 2
            assert d.endpoint_manager.lookup(ep_id) is None and len(d.ipam) == 0
            return [ep_id, labels, ep.ipv4, n_eps, d.asks]
        finally:
            d.shutdown()

    both(run)


def test_ipam_rest(tmp_path):
    """The port's APIClient against the JAX package's APIServer (the one
    agent with a REST server until A7c), and the JAX client after it:
    equal answers."""
    from cilium_tpu.api.server import APIServer
    from cilium_tpu.daemon import Daemon

    d = Daemon(state_dir=str(tmp_path / "state"))
    srv = APIServer(d, str(tmp_path / "api.sock"))
    srv.start()
    try:
        outs = []
        for pkg in ("cilium_tpu_torch", "cilium_tpu"):
            c = _mod(pkg, "api.client").APIClient(str(tmp_path / "api.sock"))
            out = c.ipam_allocate(owner="cni")
            assert out["ip"].startswith("10.200.")
            rel = c.ipam_release(out["ip"])
            assert rel["released"]
            with pytest.raises(_mod(pkg, "api.client").APIError) as e:
                c.endpoint_get(4242)
            outs.append([out, rel, e.value.status, c.endpoint_list()])
        assert outs[0] == outs[1]
    finally:
        srv.stop()
        d.shutdown()


# -- WireEnforcer on seeded worlds ------------------------------------------------------


def _wire_world(m, seed: int, n_eps: int = 8):
    """A harness world behind a stand-in, ``n_eps`` containers through
    cni_add with app / team labels the world's rules select, and 4 096
    seeded frames from the world's peers (and unmapped sources) to the
    endpoints' addresses (and addresses no endpoint holds)."""
    world = build_world(m.pkg, seed)
    d = m.WorkloadAgent(world=world, pod_cidr="10.77.0.0/24")
    rng = random.Random(seed + 1)
    eps = []
    for k in range(n_eps):
        labels = [rng.choice(APPS), rng.choice(TEAMS)]
        eps.append(m.cni.cni_add(d, f"ctr-{seed}-{k}", labels=labels))
    srcs = [u32(ip) for ip in world.peer_ips] + [u32(f"192.0.2.{i}") for i in range(1, 5)]
    srcs += [u32(r.ipv4) for r in eps]
    dsts = [u32(r.ipv4) for r in eps] + [u32("10.77.0.250"), u32("172.16.0.1")]
    return d, eps, frame_corpus(seed, srcs, dsts, 4096)


class Lanes:
    """Keeps every pipeline call's lanes (endpoint index, verdict,
    redirect) and the conntrack pre-pass's established hits."""

    def __init__(self, m, d):
        self.calls, self.established = [], []
        real, lookup = d.pipeline.process, d.conntrack.lookup_batch

        def process(src, ep_idx, dports, protos, **kw):
            v, red = real(src, ep_idx, dports, protos, **kw)
            self.calls.append([np.asarray(ep_idx).tolist(), np.asarray(v).astype(int).tolist(),
                               np.asarray(red).astype(int).tolist()])
            return v, red

        def lookup_batch(*a, **k):
            out = lookup(*a, **k)
            self.established.append(int((out[0] == m.conntrack.CT_ESTABLISHED).sum()))
            return out

        d.pipeline.process = process
        d.conntrack.lookup_batch = lookup_batch


def _counts(enf):
    return sorted((ep, sorted(c.items())) for ep, c in enf.verdicts.items())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_enforcer_parity(seed):
    """Frames parsed and enforced on both packages' stand-ins: the flows
    enforced, each endpoint's verdict counts and every pipeline call's
    lanes are equal, on the first batch, its replay (the CT pre-pass now
    answers the forwarded flows) and after three endpoints leave (their
    flows are skipped, no index points at another endpoint's row)."""
    def run(m):
        d, eps, frames = _wire_world(m, seed)
        try:
            lanes = Lanes(m, d)
            flows = [t for t in map(m.wire.parse_ipv4_frame, frames) if t is not None]
            enf = m.wire.WireEnforcer(d.pipeline, {r.ipv4: r.endpoint_id for r in eps})
            out = [len(flows), enf.process_flows(flows), _counts(enf)]
            out += [enf.process_flows(flows), _counts(enf)]
            gone = [r.endpoint_id for r in eps[:3]]
            for r in eps[:3]:
                assert m.cni.cni_del(d, f"ctr-{seed}-{eps.index(r)}")
            assert all(d.ipam.owner_of(r.ipv4) is None for r in eps[:3])
            enf2 = m.wire.WireEnforcer(d.pipeline, {r.ipv4: r.endpoint_id for r in eps})
            out += [enf2.process_flows(flows), _counts(enf2)]
            assert not set(gone) & set(enf2.verdicts)
            live = {u32(r.ipv4) for r in eps[3:]}
            assert out[-2] == sum(1 for f in flows if f[1] in live)
            codes = {v for call in lanes.calls for v in call[1]}
            assert {m.FORWARD, m.DROP_POLICY} <= codes, codes
            # the replay: established hits for the forwarded, new flows
            assert lanes.established[0] == 0 and lanes.established[1] > 0
            return out + [lanes.calls, lanes.established]
        finally:
            d.shutdown()

    both(run)


def test_debounce_folds_to_equal_tables():
    """A burst of 12 adds and 3 deletes, regenerated at once on one
    stand-in and folded on a Trigger (0.05 s) on another: equal
    endpoints, realized policymaps and wire verdicts after the burst, the
    folded one in fewer regenerations; both packages equal."""
    def run(m):
        res = []
        for debounce in (0.0, 0.05):
            world = build_world(m.pkg, 3)
            d = m.WorkloadAgent(world=world, pod_cidr="10.77.0.0/24", regen_debounce=debounce)
            try:
                rng = random.Random(4)
                added = [m.cni.cni_add(d, f"burst-{k}", labels=[rng.choice(APPS), rng.choice(TEAMS)])
                         for k in range(12)]
                for k in (2, 5, 9):
                    m.cni.cni_del(d, f"burst-{k}")
                d.settle()
                eps = [(ep.id, ep.identity.id, ep.ipv4) for ep in d.endpoint_manager.endpoints()]
                maps = [sorted((k.identity, k.dport, k.nexthdr, int(r)) for k, r in
                               ep.desired.items()) for ep in d.endpoint_manager.endpoints()]
                srcs = [u32(ip) for ip in world.peer_ips]
                flows = [t for t in map(m.wire.parse_ipv4_frame, frame_corpus(
                    6, srcs, [u32(r.ipv4) for r in added], 1024)) if t is not None]
                enf = m.wire.WireEnforcer(d.pipeline, {r.ipv4: r.endpoint_id for r in added})
                res.append([eps, maps, enf.process_flows(flows), _counts(enf)])
                if debounce:
                    assert len(d.regenerations) < len(d.asks) == 15
                    assert d._regen_trigger.fold_count >= 1
                else:
                    assert len(d.regenerations) == len(d.asks) == 15
            finally:
                d.shutdown()
        assert res[0] == res[1]
        return res[0]

    both(run)


# -- the stand-in against the JAX Daemon ---------------------------------------------------


WIRE_POLICY = json.dumps([{
    "endpointSelector": {"matchLabels": {"any:app": "web"}},
    "ingress": [{
        "fromEndpoints": [{"matchLabels": {"any:app": "client"}}],
        "toPorts": [{"ports": [{"port": "9053", "protocol": "UDP"}]}],
    }],
    "labels": ["k8s:policy=wire"],
}])


def _daemon_sequence(m, d):
    """Three cni_adds, a WorkloadWatcher sync (one container adopted by
    its labels' source, one ignored), a cni_del and one frame batch to the
    web and client endpoints through WireEnforcer."""
    wl = m.workloads
    d.policy_replace(["k8s:policy=wire"], WIRE_POLICY)
    res = {app: m.cni.cni_add(d, f"{app}-0123456789", labels=[f"k8s:app={app}"])
           for app in ("web", "client", "other")}

    class Runtime:
        def containers(self):
            return [wl.ContainerInfo(id="watched" * 2, labels={"app": "client"}),
                    wl.ContainerInfo(id="ignored" * 2, labels={wl.IGNORE_LABEL: "true"})]

    w = wl.WorkloadWatcher(d, Runtime())
    assert w.sync() == 1
    other_ip = res["other"].ipv4
    assert m.cni.cni_del(d, "other-0123456789")
    assert d.ipam.owner_of(other_ip) is None
    watched = d.endpoint_manager.lookup(w.endpoint_of("watched" * 2)).ipv4
    srcs = [u32(res["client"].ipv4), u32(other_ip), u32(watched), u32("192.0.2.9")]
    dsts = [u32(res["web"].ipv4), u32(res["client"].ipv4)]
    rng = random.Random(11)
    frames = [eth_frame(rng.choice(srcs), rng.choice(dsts), p, rng.randrange(1024, 65536), port)
              for p, port in [(17, 9053), (6, 80), (17, 53)] for _ in range(64)]
    enf = m.wire.WireEnforcer(d.pipeline, {res["web"].ipv4: res["web"].endpoint_id,
                                           res["client"].ipv4: res["client"].endpoint_id})
    n = enf.process_flows([m.wire.parse_ipv4_frame(f) for f in frames])
    eps = sorted((ep.id, ep.ipv4, ep.identity.id, sorted(str(x) for x in ep.labels))
                 for ep in d.endpoint_manager.endpoints())
    return {"endpoints": eps, "results": {a: r.to_dict() for a, r in res.items()},
            "ipam": len(d.ipam), "enforced": n, "verdicts": _counts(enf)}


def test_stand_in_matches_the_daemon(tmp_path):
    """The JAX stand-in and the JAX Daemon given the same sequence: equal
    endpoint ids, addresses, identities, labels, IPAM occupancy and
    per-endpoint verdict counts."""
    m = wns("cilium_tpu")
    daemon = _mod("cilium_tpu", "daemon").Daemon(state_dir=str(tmp_path / "state"),
                                                 pod_cidr="10.77.0.0/24")
    a = m.WorkloadAgent(pod_cidr="10.77.0.0/24")
    try:
        want = _daemon_sequence(m, daemon)
        got = _daemon_sequence(m, a)
    finally:
        a.shutdown()
        daemon.shutdown()
    assert got == want
    assert len(got["endpoints"]) == 3 and got["enforced"] == 192
    codes = {c for _ep, counts in got["verdicts"] for c, _n in counts}
    assert {m.FORWARD, m.DROP_POLICY} <= codes


def test_stand_in_sequence_matches_across_packages():
    def run(m):
        a = m.WorkloadAgent(pod_cidr="10.77.0.0/24")
        try:
            return _daemon_sequence(m, a)
        finally:
            a.shutdown()

    both(run)
