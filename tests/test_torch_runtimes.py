"""Port parity: the containerd / cri-o adapters (``runtimes.py``).

The reference's ``test_runtimes.py`` through both packages: the CRI wire
codec (``TestWireCodec``, its 3 tests, equal bytes and decodes), the
adapters over a real gRPC server (``TestAdapters``; the server encodes
with one package's codec, both packages' clients list it) and the PLEG
event path into a stand-in agent (``TestEventPath``). Those tests build a
``Daemon``; the port has none until A7c, so they run through
``test_torch_workloads.WorkloadAgent`` (the ``Daemon``-built runs stay
in A7c's bar). The gRPC tests skip without ``grpc``, as the reference's
do; the codec's do not need it. Tolerance 0: every value compared is an
integer, a string, bytes or a bool.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import threading

import pytest

from test_torch_harness import PKGS
from test_torch_workloads import wns


def rt(pkg: str):
    return importlib.import_module(f"{pkg}.runtimes")


class FakeCRIServer:
    """A real gRPC server exposing runtime.v1.RuntimeService/
    ListContainers, its replies encoded with ``codec`` (a package's
    runtimes module): the containerd / cri-o socket, minus the daemon
    behind it."""

    def __init__(self, codec, service: str = "runtime.v1.RuntimeService"):
        grpc = pytest.importorskip("grpc")
        self.codec = codec
        self.lock = threading.Lock()
        self.containers = {}  # id → (name, state, labels)

        def list_containers(request: bytes, context) -> bytes:
            with self.lock:
                blobs = [codec.encode_container(cid, name=n, state=s, labels=lb)
                         for cid, (n, s, lb) in sorted(self.containers.items())]
            return codec.encode_list_containers_response(blobs)

        handler = grpc.method_handlers_generic_handler(service, {
            "ListContainers": grpc.unary_unary_rpc_method_handler(
                list_containers, request_deserializer=lambda b: b,
                response_serializer=lambda b: b),
        })
        self.server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    @property
    def target(self):
        return f"127.0.0.1:{self.port}"

    def run(self, cid, name="c", labels=None):
        with self.lock:
            self.containers[cid] = (name, self.codec.CONTAINER_RUNNING, labels or {})

    def exit(self, cid):
        with self.lock:
            if cid in self.containers:
                n, _s, lb = self.containers[cid]
                self.containers[cid] = (n, self.codec.CONTAINER_EXITED, lb)

    def remove(self, cid):
        with self.lock:
            self.containers.pop(cid, None)

    def stop(self):
        self.server.stop(0)


def both(scenario):
    outs = [scenario(pkg) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


def _info(info):
    return [info.id, info.name, sorted(info.labels.items()), info.running]


# -- TestWireCodec --------------------------------------------------------------------


def test_container_roundtrip():
    def run(pkg):
        r = rt(pkg)
        blob = r.encode_container(
            "abc123", name="web-1", state=r.CONTAINER_RUNNING,
            labels={"app": "web", "io.kubernetes.pod.name": "web-1"}, pod_sandbox_id="sb-9")
        info, sandbox = r.decode_container(blob)
        assert info.id == "abc123" and info.name == "web-1"
        assert info.running is True and sandbox == "sb-9"
        assert info.labels == {"app": "web", "io.kubernetes.pod.name": "web-1"}
        return [blob, _info(info), sandbox]

    both(run)


def test_known_wire_bytes():
    """Protobuf spot checks against hand-computed bytes, and a seeded
    batch of containers encoded by one package and decoded by the other."""
    import random

    def run(pkg):
        r = rt(pkg)
        assert r.encode_container("abc", state=0) == b"\x0a\x03abc"
        assert r.encode_container("a", state=1) == b"\x0a\x01a\x30\x01"
        blob = r.encode_container("a", state=0, labels={"k": "v"})
        assert blob == b"\x0a\x01a" + bytes([0x42, 6, 0x0A, 1]) + b"k" + bytes([0x12, 1]) + b"v"
        rng = random.Random(3)
        return [r.encode_container(f"c{i}" * rng.randint(1, 40), name=f"n{i}",
                                   state=rng.randrange(4),
                                   labels={f"k{j}": "v" * rng.randint(0, 200)
                                           for j in range(rng.randint(0, 5))},
                                   pod_sandbox_id=f"sb{i}" if i % 2 else "")
                for i in range(64)]

    blobs = both(run)
    for a, b in ((PKGS[0], PKGS[1]), (PKGS[1], PKGS[0])):
        got = rt(b).decode_list_containers_response(rt(a).encode_list_containers_response(blobs))
        want = [rt(a).decode_container(x)[0] for x in blobs]
        assert [_info(i) for i in got] == [_info(i) for i in want]


def test_response_roundtrip():
    def run(pkg):
        r = rt(pkg)
        blobs = [r.encode_container(f"c{i}", state=r.CONTAINER_RUNNING) for i in range(3)]
        out = r.decode_list_containers_response(r.encode_list_containers_response(blobs))
        assert [c.id for c in out] == ["c0", "c1", "c2"]
        with pytest.raises(ValueError):
            r.decode_list_containers_response(b"\x0a\x05ab")
        return [_info(c) for c in out]

    both(run)


# -- TestAdapters ----------------------------------------------------------------------


@pytest.mark.parametrize("runtime_cls", ["ContainerdRuntime", "CRIORuntime"])
def test_list_containers_over_real_grpc(runtime_cls):
    """Both packages' clients list a server encoding with either codec."""
    outs = []
    for server_pkg in PKGS:
        srv = FakeCRIServer(rt(server_pkg))
        try:
            srv.run("aaa111", name="web", labels={"app": "web"})
            srv.run("bbb222", name="db")
            srv.exit("bbb222")
            for pkg in PKGS:
                client = getattr(rt(pkg), runtime_cls)(srv.target)
                try:
                    out = {c.id: c for c in client.containers()}
                finally:
                    client.close()
                assert out["aaa111"].running is True
                assert out["aaa111"].labels == {"app": "web"}
                assert out["bbb222"].running is False
                outs.append(sorted(_info(c) for c in out.values()))
        finally:
            srv.stop()
    assert len(outs) == 4 and all(o == outs[0] for o in outs)


# -- TestEventPath ------------------------------------------------------------------------


@pytest.mark.parametrize("runtime_cls", ["ContainerdRuntime", "CRIORuntime"])
def test_pleg_start_die_events_create_endpoints(runtime_cls):
    """Container starts / exits / removals on the runtime socket flow
    through PLEG diffing into the stand-in's endpoints, in both packages."""
    def run(pkg):
        m = wns(pkg)
        r = rt(pkg)
        srv = FakeCRIServer(r)
        d = m.WorkloadAgent()
        client = getattr(r, runtime_cls)(srv.target)
        w = m.workloads.WorkloadWatcher(d, client)
        pleg = r.PLEGPoller(w, client, interval=3600)
        steps = []
        try:
            srv.run("aaa111", name="web", labels={"app": "web"})
            assert pleg.poll_once() == 1
            ep = w.endpoint_of("aaa111")
            assert ep is not None and d.endpoint_manager.lookup(ep) is not None
            lbls = d.endpoint_manager.lookup(ep).identity.labels.to_strings()
            assert "container:app=web" in lbls
            steps.append([ep, sorted(lbls), d.endpoint_manager.lookup(ep).ipv4])
            srv.run("bbb222", name="db")
            assert pleg.poll_once() == 1
            steps.append([w.endpoint_of("bbb222"), len(d.ipam)])
            srv.exit("aaa111")
            assert pleg.poll_once() == 1
            assert w.endpoint_of("aaa111") is None and d.endpoint_manager.lookup(ep) is None
            srv.remove("bbb222")
            assert pleg.poll_once() == 1
            assert w.endpoint_of("bbb222") is None
            assert pleg.poll_once() == 0
            steps.append([len(d.ipam), len(d.endpoint_manager), d.asks])
            return steps
        finally:
            pleg.stop()
            client.close()
            srv.stop()
            d.shutdown()

    both(run)


def test_runtime_outage_is_tolerated():
    """A dead runtime socket emits no die events: state is retained."""
    def run(pkg):
        m = wns(pkg)
        r = rt(pkg)
        srv = FakeCRIServer(r)
        d = m.WorkloadAgent()
        client = r.CRIRuntime(srv.target, timeout=2.0)
        w = m.workloads.WorkloadWatcher(d, client)
        pleg = r.PLEGPoller(w, client, interval=3600)
        try:
            srv.run("aaa111")
            assert pleg.poll_once() == 1
            srv.stop()
            assert pleg.poll_once() == 0
            assert w.endpoint_of("aaa111") is not None
            return [w.endpoint_of("aaa111"), len(d.endpoint_manager), d.asks]
        finally:
            pleg.stop()
            client.close()
            d.shutdown()

    both(run)
