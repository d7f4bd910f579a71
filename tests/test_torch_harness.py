"""Shared world builder for the torch port's parity tests, plus the
port's own package-level checks.

``build_world(pkg, seed)`` builds the same random world — deny
(``from_requires``), L4, L7-HTTP and egress-CIDR rules; identities with
unique labels; one /32 ipcache entry per identity and one entry per
egress CIDR — through either package's ``Repository``,
``IdentityRegistry`` and ``IPCache``, so the JAX package and the port
can be held against each other on identical inputs.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import ipaddress
import pathlib
import random
from typing import List, Optional

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKGS = ("cilium_tpu", "cilium_tpu_torch")

APPS = [f"k8s:app=a{i}" for i in range(8)]
TEAMS = [f"k8s:team=t{i}" for i in range(4)]
ENVS = ["k8s:env=prod", "k8s:env=dev"]
PORTS = [80, 443, 8080, 53]


@dataclasses.dataclass
class World:
    pkg: str
    repo: object
    reg: object
    ipcache: object
    idents: List[object]  # endpoint-capable identities, allocation order
    peer_ips: List[str]  # one IPv4 per ipcache entry, plus one world address
    peer_idents: List[Optional[object]]  # identity behind each peer ip (None = world)
    ident_labels: dict


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _random_rule(api, rng: random.Random, idx: int):
    def selector():
        labels = [rng.choice(APPS)]
        if rng.random() < 0.3:
            labels.append(rng.choice(TEAMS))
        return api.EndpointSelector.make(labels)

    def port_rule():
        port = rng.choice(PORTS)
        proto = "UDP" if port == 53 else "TCP"
        l7 = api.L7Rules()
        if proto == "TCP" and rng.random() < 0.25:
            l7 = api.L7Rules(http=(api.HTTPRule(method="GET", path="/api/.*"),))
        return api.PortRule(ports=(api.PortProtocol(port, proto),), rules=l7)

    subject = [rng.choice(APPS)]
    kw = {}
    if rng.random() < 0.7:
        kw["ingress"] = [api.IngressRule(
            from_endpoints=(selector(),),
            from_requires=(
                (api.EndpointSelector.make([rng.choice(ENVS)]),)
                if rng.random() < 0.2 else ()
            ),
            to_ports=((port_rule(),) if rng.random() < 0.5 else ()),
        )]
    if rng.random() < 0.5:
        if rng.random() < 0.25:
            eg = api.EgressRule(to_cidr=(f"10.{rng.randrange(4)}.0.0/16",))
        else:
            eg = api.EgressRule(
                to_endpoints=(selector(),),
                to_ports=((port_rule(),) if rng.random() < 0.5 else ()),
            )
        kw["egress"] = [eg]
    if not kw:
        kw["ingress"] = [api.IngressRule(from_endpoints=(selector(),))]
    return api.rule(subject, labels=[f"k8s:policy=fz{idx}"], **kw)


def build_world(pkg: str, seed: int, n_rules: int = 24, n_idents: int = 24) -> World:
    """The same random world through ``pkg``'s own modules."""
    api = _mod(pkg, "policy.api")
    labels_mod = _mod(pkg, "labels")
    cidr_mod = _mod(pkg, "labels.cidr")
    rng = random.Random(seed)
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list([_random_rule(api, rng, i) for i in range(n_rules)])
    reg = _mod(pkg, "identity").IdentityRegistry()
    ipcache = _mod(pkg, "ipcache.ipcache").IPCache()
    idents, peer_ips, peer_idents, ident_labels = [], [], [], {}
    for i in range(n_idents):
        labels = [rng.choice(APPS), rng.choice(TEAMS)]
        if rng.random() < 0.6:
            labels.append(rng.choice(ENVS))
        labels.append(f"k8s:uid=u{i}")
        ident = reg.allocate(labels_mod.parse_label_array(labels))
        ident_labels[ident.id] = labels
        ip = f"172.16.{i // 250}.{(i % 250) + 1}"
        ipcache.upsert(f"{ip}/32", ident.id, source="k8s")
        idents.append(ident)
        peer_ips.append(ip)
        peer_idents.append(ident)
    # CIDR identities for every egress to_cidr prefix
    seen = set()
    for r in list(repo.rules):
        for eg in r.egress:
            for cidr in eg.to_cidr:
                if cidr in seen:
                    continue
                seen.add(cidr)
                cid = reg.allocate(
                    labels_mod.LabelArray(cidr_mod.cidr_labels(cidr)), local=True
                )
                ipcache.upsert(cidr, cid.id, source="agent")
                ident_labels[cid.id] = [str(lb) for lb in cid.labels]
                net = ipaddress.ip_network(cidr)
                peer_ips.append(str(net.network_address + rng.randrange(1, 1000)))
                peer_idents.append(cid)
    peer_ips.append("8.8.8.8")  # resolves to reserved:world
    peer_idents.append(None)
    return World(pkg, repo, reg, ipcache, idents, peer_ips, peer_idents, ident_labels)


def random_flows(world: World, n: int, n_eps: int, seed: int):
    """(peer u32 [n], ep_idx [n], dports [n], protos [n]) from numpy."""
    rs = np.random.default_rng(seed)
    ip_u32 = np.array([int(ipaddress.IPv4Address(ip)) for ip in world.peer_ips], np.uint32)
    pick = rs.integers(0, len(ip_u32), n)
    dports = rs.choice(np.array(PORTS + [22], np.int32), n).astype(np.int32)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return ip_u32[pick], rs.integers(0, n_eps, n).astype(np.int32), dports, protos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compiled_policy_arrays_equal(seed):
    """The port's copied compiler lowers the same world to the same
    CompiledPolicy arrays as the JAX package's."""
    compiled = []
    for pkg in PKGS:
        w = build_world(pkg, seed)
        compiled.append(_mod(pkg, "compiler").compile_policy(w.repo, w.reg))
    a, b = compiled
    for field in ("id_bits", "row_ids", "row_live", "conj_req", "conj_forbid",
                  "conj_valid", "req_count"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    assert a.id_to_row == b.id_to_row
    for direction in ("ingress", "egress"):
        da, db = getattr(a, direction), getattr(b, direction)
        for f in dataclasses.fields(da):
            va, vb = getattr(da, f.name), getattr(db, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f"{direction}.{f.name}")
            else:
                assert va == vb, f"{direction}.{f.name}"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in (REPO / "cilium_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_port_imports_neither_jax_nor_reference(path):
    for name in _imports(REPO / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "cilium_tpu", "chex", "flax"), (path, name)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.ipcache.ipcache import IPCache
    from cilium_tpu_torch.policy.repository import Repository

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PolicyEngine(Repository(), IdentityRegistry())
    eng = PolicyEngine(Repository(), IdentityRegistry(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DatapathPipeline(eng, IPCache())
    assert DatapathPipeline(eng, IPCache(), device="cpu").device.type == "cpu"

    # services: the pipeline, the table upload and the LB-only node all
    # default to the card and raise without it, never running the plain path
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.lb_only import LBOnlyDatapath
    from cilium_tpu_torch.lb import Backend, L3n4Addr, ServiceManager

    lbm = ServiceManager()
    lbm.upsert(L3n4Addr("10.96.0.1", 80), [Backend("10.0.0.1", 8080)])
    for make in (lambda **kw: DatapathPipeline(eng, IPCache(), lb=lbm,
                                               conntrack=FlowConntrack(10), **kw),
                 lambda **kw: lbm.build_device(**kw),
                 lambda **kw: LBOnlyDatapath(lbm, FlowConntrack(10), **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        make(device="cpu")
    assert lbm.build_device(device="cpu")[4].fe_port.device.type == "cpu"

    from cilium_tpu_torch.datapath import l7_pipeline
    from cilium_tpu_torch.l7 import HTTPPolicy, KafkaACL
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import match_patterns
    from cilium_tpu_torch.policy.api import HTTPRule, KafkaRule

    http = [(HTTPRule(method="GET"), None)]
    kafka = [(KafkaRule(topic="t"), None)]
    for make in (lambda **kw: HTTPPolicy(http, **kw), lambda **kw: KafkaACL(kafka, **kw),
                 lambda **kw: l7_pipeline.L7Pipeline(**kw),
                 lambda **kw: match_patterns(compile_patterns(["a"]), [b"a"], **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        make(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            l7_pipeline.set_device_batch(True)
        assert not l7_pipeline.device_batch_enabled()
        l7_pipeline.set_device_batch(True, device="cpu")
        assert l7_pipeline.shared_pipeline().device.type == "cpu"
    finally:
        l7_pipeline._reset_for_tests()
