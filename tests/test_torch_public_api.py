"""Port parity: the public names of ``ops`` and ``datapath``.

The port's packages re-export the reference's ``__all__``;
``materialize_endpoints``, ``ip_strings_to_u32`` and the per-flow
``VerdictFastpath`` (``DatapathPipeline.fastpath``) are held against
the JAX package on the same worlds, and the fastpath against the
port's own ``lookup_batch``, as ``tests/test_policymap.py`` and
``TestFastpath`` of ``tests/test_pipeline_incremental.py`` hold the
reference.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest
import torch

from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ops import materialize as jmat
from cilium_tpu.ops.lpm import ip_strings_to_u32 as jax_ip_strings_to_u32
from cilium_tpu_torch.convert import device_policy_from_numpy
from test_torch_harness import PKGS, build_world


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("name", ["ops", "datapath"])
def test_reexports_equal_the_reference(name):
    ref, port = (_mod(pkg, name) for pkg in PKGS)
    assert port.__all__ == ref.__all__
    for attr in port.__all__:
        obj = getattr(port, attr)
        assert getattr(obj, "__module__", f"{port.__name__}.").startswith(port.__name__), attr


def test_public_names_import():
    from cilium_tpu_torch.datapath import (  # noqa: F401
        DROP_POLICY, DROP_PREFILTER, FORWARD, DatapathPipeline, DatapathTables, VerdictFastpath,
    )
    from cilium_tpu_torch.ops import (  # noqa: F401
        DevicePolicy, DeviceTables, EndpointPolicySnapshot, PolicyKey, PolicymapTables, Verdict,
        compute_selector_matches, lookup_batch, materialize_endpoints, pack_bool_bits,
        verdict_batch,
    )

    assert (FORWARD, DROP_POLICY, DROP_PREFILTER) == (1, 2, 3)


def test_ip_strings_to_u32_equals_jax():
    from cilium_tpu_torch.ops.lpm import ip_strings_to_u32

    rs = random.Random(3)
    ips = ["0.0.0.0", "255.255.255.255", "10.0.0.1", "172.16.3.250"] + [
        ".".join(str(rs.randrange(256)) for _ in range(4)) for _ in range(200)]
    got, want = ip_strings_to_u32(ips), jax_ip_strings_to_u32(ips)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert ip_strings_to_u32([]).shape == (0,)


def _keyed(snaps):
    return [{(k.identity, k.dport, k.nexthdr, k.direction): v for k, v in s.entries.items()}
            for s in snaps]


@pytest.mark.parametrize("ingress", [True, False])
@pytest.mark.parametrize("seed", [0, 4])
def test_materialize_endpoints_equals_jax(seed, ingress):
    from cilium_tpu_torch.ops import materialize_endpoints

    w = build_world("cilium_tpu", seed)
    compiled, device = JaxEngine(w.repo, w.reg).snapshot()
    port = device_policy_from_numpy(compiled, device="cpu", sel_match=np.asarray(device.sel_match))
    eps = [i.id for i in w.idents[:8]]
    want_t, want_s = jmat.materialize_endpoints(compiled, device, eps, ingress=ingress)
    got_t, got_s = materialize_endpoints(compiled, port, eps, ingress=ingress, block=512)
    for f in ("col_ep", "col_port", "col_proto", "col_is_l3", "id_bits"):
        np.testing.assert_array_equal(getattr(got_t, f).numpy(), np.asarray(getattr(want_t, f)),
                                      err_msg=f)
    assert _keyed(got_s) == _keyed(want_s)
    assert [s.slots for s in got_s] == [s.slots for s in want_s]


def _policymap_world(pkg):
    """The world of tests/test_policymap.py through ``pkg``'s modules."""
    api = _mod(pkg, "policy.api")
    http = api.L7Rules(http=(api.HTTPRule(method="GET"),))
    sel = api.EndpointSelector.make
    rules = [
        api.rule(["k8s:app=b"], ingress=[
            api.IngressRule(from_endpoints=(sel(["k8s:app=a"]),)),
            api.IngressRule(from_endpoints=(sel(["k8s:app=c"]),),
                            to_ports=(api.PortRule(ports=(api.PortProtocol(80, "TCP"),)),)),
            api.IngressRule(from_endpoints=(sel(["k8s:app=a"]),),
                            to_ports=(api.PortRule(ports=(api.PortProtocol(8080, "TCP"),),
                                                   rules=http),)),
        ]),
        api.rule(["k8s:app=d"], ingress=[
            api.IngressRule(to_ports=(api.PortRule(ports=(api.PortProtocol(53, "ANY"),)),))]),
    ]
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list(rules)
    reg = _mod(pkg, "identity").IdentityRegistry()
    parse = _mod(pkg, "labels").parse_label_array
    idents = {n: reg.allocate(parse([f"k8s:app={n}"])) for n in "abcd"}
    kw = {"device": "cpu"} if pkg == "cilium_tpu_torch" else {}
    return _mod(pkg, "engine").PolicyEngine(repo, reg, **kw), idents


def test_materialize_endpoints_lookup_matches_engine():
    """tests/test_policymap.py test_lookup_matches_engine on the port,
    and its verdicts equal the JAX package's."""
    from cilium_tpu_torch.ops import lookup_batch, materialize_endpoints

    engine, idents = _policymap_world("cilium_tpu_torch")
    compiled = engine.refresh()
    ep_ids = [idents["b"].id, idents["d"].id]
    tables, _ = materialize_endpoints(compiled, engine.device_policy, ep_ids)
    ports = [(0, 6), (80, 6), (8080, 6), (53, 17), (53, 6)]
    cases = [(e, s.id, port, proto) for e in range(2) for s in idents.values()
             for port, proto in ports]
    cols = [np.array(c, np.int32) for c in zip(*cases)]
    dec, red = lookup_batch(
        tables, torch.from_numpy(cols[0]), torch.from_numpy(engine.rows(cols[1].tolist())),
        torch.from_numpy(cols[2]), torch.from_numpy(cols[3]))
    v = engine.verdicts([ep_ids[e] for e in cols[0]], cols[1].tolist(), cols[2].tolist(),
                        cols[3].tolist(), has_l4=[p != 0 for p in cols[2]])
    np.testing.assert_array_equal(dec.numpy(), v.decision.numpy())
    np.testing.assert_array_equal(red.numpy(), v.l7_redirect.numpy())

    jeng, jidents = _policymap_world("cilium_tpu")
    jcompiled = jeng.refresh()
    jt, _ = jmat.materialize_endpoints(jcompiled, jeng.device_policy,
                                       [jidents["b"].id, jidents["d"].id])
    np.testing.assert_array_equal(tables.id_bits.numpy(), np.asarray(jt.id_bits))


def test_materialize_endpoints_snapshot_entries():
    from cilium_tpu_torch.ops import PolicyKey, materialize_endpoints

    engine, idents = _policymap_world("cilium_tpu_torch")
    compiled = engine.refresh()
    _, snaps = materialize_endpoints(compiled, engine.device_policy, [idents["b"].id])
    entries = snaps[0].entries
    a, c = idents["a"].id, idents["c"].id
    assert PolicyKey(a, 0, 0, 0) in entries  # L3-only allow for a
    assert entries[PolicyKey(a, 8080, 6, 0)] == 1  # exact entry, redirect
    assert entries[PolicyKey(c, 80, 6, 0)] == 0  # exact entry, no redirect
    assert PolicyKey(c, 0, 0, 0) not in entries


def _fastpath_world(pkg, seed: int, n_rules: int = 30, n_idents: int = 16):
    """The world of tests/test_pipeline_incremental.py through ``pkg``."""
    api = _mod(pkg, "policy.api")
    parse = _mod(pkg, "labels").parse_label_array
    rng = random.Random(seed)
    rules = []
    for i in range(n_rules):
        peer = api.EndpointSelector.make([f"k8s:app=a{rng.randrange(8)}"])
        subject = [f"k8s:app=a{rng.randrange(8)}"]
        if i % 3 == 0:
            ing = api.IngressRule(from_endpoints=(peer,), to_ports=(
                api.PortRule(ports=(api.PortProtocol(80, "TCP"),)),))
        else:
            ing = api.IngressRule(from_endpoints=(peer,))
        rules.append(api.rule(subject, ingress=[ing]))
    repo = _mod(pkg, "policy.repository").Repository()
    repo.add_list(rules)
    reg = _mod(pkg, "identity").IdentityRegistry()
    idents = [reg.allocate(parse([f"k8s:app=a{rng.randrange(8)}", f"k8s:z=z{i % 3}"]))
              for i in range(n_idents)]
    kw = {"device": "cpu"} if pkg == "cilium_tpu_torch" else {}
    engine = _mod(pkg, "engine").PolicyEngine(repo, reg, **kw)
    ipc = _mod(pkg, "ipcache")
    cache = ipc.IPCache()
    for i, ident in enumerate(idents):
        cache.upsert(f"10.0.{i // 250}.{i % 250 + 1}", ident.id, ipc.SOURCE_AGENT)
    pipe = _mod(pkg, "datapath").DatapathPipeline(engine, cache, **kw)
    pipe.set_endpoints([i.id for i in idents[:6]])
    return reg, engine, pipe, idents


@pytest.mark.parametrize("seed", [0, 2])
def test_fastpath_agrees_with_device(seed):
    """TestFastpath.test_fastpath_agrees_with_device on the port's CPU
    pipeline, and every probe equal to the JAX package's fastpath."""
    from cilium_tpu_torch.datapath import VerdictFastpath
    from cilium_tpu_torch.ops import lookup_batch
    from cilium_tpu_torch.ops.materialize import TRAFFIC_INGRESS

    _, engine, pipe, idents = _fastpath_world("cilium_tpu_torch", seed)
    _, _, jpipe, jidents = _fastpath_world("cilium_tpu", seed)
    fp, jfp = pipe.fastpath(), jpipe.fastpath()
    assert isinstance(fp, VerdictFastpath)
    rng = np.random.default_rng(seed)
    compiled, _ = engine.snapshot()
    rows = {i.id: compiled.id_to_row[i.id] for i in idents}
    t = pipe.rebuild()[(TRAFFIC_INGRESS, 4)]
    for _ in range(300):
        ep = int(rng.integers(0, 6))
        k = int(rng.integers(0, len(idents)))
        dport = int(rng.choice([0, 80, 443]))
        dec, red = fp.lookup(ep, idents[k].id, dport, 6)
        ddec, dred = lookup_batch(
            t.policymap, torch.tensor([ep], dtype=torch.int32),
            torch.tensor([rows[idents[k].id]], dtype=torch.int32),
            torch.tensor([dport], dtype=torch.int32), torch.tensor([6], dtype=torch.int32))
        assert dec == int(ddec[0]), (ep, idents[k].id, dport)
        assert red == bool(dred[0])
        assert (dec, red) == jfp.lookup(ep, jidents[k].id, dport, 6)
    egress = pipe.fastpath(ingress=False)
    assert egress.lookup(0, idents[0].id, 80, 6) == jpipe.fastpath(ingress=False).lookup(
        0, jidents[0].id, 80, 6)


def test_fastpath_sees_identity_patches():
    reg, _, pipe, _ = _fastpath_world("cilium_tpu_torch", 5)
    parse = _mod("cilium_tpu_torch", "labels").parse_label_array
    fp = pipe.fastpath()
    base_mat = pipe._mat
    new = reg.allocate(parse(["k8s:app=a0", "k8s:p=q"]))
    pipe.rebuild()  # row patch: the shared dicts must reflect it
    assert pipe._mat is base_mat
    dec, _ = fp.lookup(0, new.id, 0, 6)
    fresh_dec, _ = pipe.fastpath().lookup(0, new.id, 0, 6)
    assert dec == fresh_dec
