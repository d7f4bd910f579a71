"""ctypes wrapper: the native enforcement front-end.

Consumes the SAME compiled state the device pipeline materializes —
per-endpoint policymap snapshots (ops/materialize.py) and the
ipcache/prefilter prefixes — and answers flow batches entirely in
native code: conntrack probe, deny LPM, identity LPM, 3-step
policymap lookup, per-endpoint counters. This is the SURVEY native
census item 1: the eBPF datapath role, re-hosted as a userspace C++
library fed by the policy tensors the card computed. The device pipeline stays
the batch/cold path and the source of truth; this front-end is the
per-node enforcement loop a non-Python dataplane embeds.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from ..ops.lpm import TrieBuilder, ipv4_to_bytes
from ..ops.materialize import TRAFFIC_INGRESS
from . import build as _build

FORWARD = 1
DROP_POLICY = 2
DROP_PREFILTER = 3

_WHICH_IP4, _WHICH_IP6, _WHICH_DENY4, _WHICH_DENY6 = 0, 1, 2, 3


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeFastpath:
    """One loaded enforcement state (policy + tries + CT)."""

    def __init__(self, ep_count: int, ct_bits: int = 18) -> None:
        self._lib = _build.load()
        self._h = self._lib.nf_create(ep_count, ct_bits)
        self.ep_count = ep_count

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.nf_destroy(h)
            self._h = None

    # -- loading --------------------------------------------------------
    def set_world_identity(self, identity: int) -> None:
        self._lib.nf_set_world(self._h, identity)

    def load_policy_snapshots(self, snapshots: Sequence) -> int:
        """Load per-endpoint EndpointPolicySnapshot dicts (the
        realized policymap the card's materialization produced); snapshot
        order defines the endpoint index, matching the pipeline.
        Raises if the C++ table dropped any entry (a dropped allow
        would silently misenforce). Any load flushes conntrack — the
        established-flow bypass is only sound while the verdict basis
        that admitted the flow still holds (same invariant as
        DatapathPipeline.rebuild)."""
        idents, eps, dports, protos, dirs, reds = [], [], [], [], [], []
        for ep_idx, snap in enumerate(snapshots):
            for key, red in snap.entries.items():
                idents.append(key.identity)
                eps.append(ep_idx)
                dports.append(key.dport)
                protos.append(key.nexthdr)
                dirs.append(key.direction)
                reds.append(1 if red else 0)
        n = len(idents)
        identity = np.asarray(idents, np.uint64)
        ep = np.asarray(eps, np.uint32)
        dport = np.asarray(dports, np.uint32)
        proto = np.asarray(protos, np.uint32)
        dir_ = np.asarray(dirs, np.uint32)
        red = np.asarray(reds, np.uint8)
        loaded = int(self._lib.nf_load_policy(
            self._h, n,
            _ptr(identity, ctypes.c_uint64), _ptr(ep, ctypes.c_uint32),
            _ptr(dport, ctypes.c_uint32), _ptr(proto, ctypes.c_uint32),
            _ptr(dir_, ctypes.c_uint32), _ptr(red, ctypes.c_uint8),
        ))
        if loaded != n:
            raise RuntimeError(
                f"native policy table dropped {n - loaded} of {n} entries "
                "(hash neighborhood overflow)"
            )
        self.ct_flush()
        return loaded

    def _load_trie(self, which: int, prefixes, levels: int) -> None:
        """prefixes: iterable of (cidr_string, value)."""
        import ipaddress

        tb = TrieBuilder(levels)
        for cidr, value in prefixes:
            net = ipaddress.ip_network(cidr, strict=False)
            tb.insert(net.network_address.packed, net.prefixlen, int(value))
        child, info = tb.arrays()
        child = np.ascontiguousarray(child, np.int32)
        info = np.ascontiguousarray(info, np.int32)
        self._lib.nf_load_trie(
            self._h, which, _ptr(child, ctypes.c_int32),
            _ptr(info, ctypes.c_int32), child.shape[0], levels,
        )

    def load_ipcache(self, ipcache) -> None:
        """IP→IDENTITY tries from the authoritative ipcache (values are
        identities, not device rows — this table is standalone).
        Empty lists STILL load (an empty trie): a reload that removed
        the last entry must not leave the previous trie enforcing
        stale mappings. Flushes conntrack (verdict basis moved)."""
        v4 = [(c, e.identity) for c, e in ipcache.items() if ":" not in c]
        v6 = [(c, e.identity) for c, e in ipcache.items() if ":" in c]
        self._load_trie(_WHICH_IP4, v4, 4)
        self._load_trie(_WHICH_IP6, v6, 16)
        self.ct_flush()

    def load_prefilter(self, prefilter) -> None:
        _, cidrs = prefilter.dump()
        v4 = [(c, 1) for c in cidrs if ":" not in c]
        v6 = [(c, 1) for c in cidrs if ":" in c]
        self._load_trie(_WHICH_DENY4, v4, 4)
        self._load_trie(_WHICH_DENY6, v6, 16)
        self.ct_flush()

    def ct_flush(self) -> None:
        self._lib.nf_ct_flush(self._h)

    def set_endpoint_ids(self, ids: Sequence[int]) -> None:
        """Stable endpoint ids per datapath index — the LB flow hash
        input (a positional index would re-pick backends on unrelated
        endpoint churn, same invariant as the device path)."""
        arr = np.ascontiguousarray(ids, np.uint32)
        self._lib.nf_set_endpoint_ids(
            self._h, arr.shape[0], _ptr(arr, ctypes.c_uint32)
        )

    def load_lb(self, manager) -> None:
        """Load BOTH address families' service tables from a
        lb.ServiceManager — built through the SAME build_device() used
        by the device path so frontend order, selection sequences, and
        backend rows are bit-identical (deterministic hash ⇒ identical
        picks, bpf/lib/lb.h lb4/lb6 dual-stack). Flushes conntrack
        (translated CT keys change with the tables). The tables are
        built on the CPU: the C++ tables live in host memory, and a
        round trip through the card buys nothing."""
        tables = manager.build_device(device="cpu")
        for family, stride in ((4, 4), (6, 16)):
            t = tables.get(family)
            if t is None:
                self._load_lb_family(stride, None)
            else:
                self._load_lb_family(stride, t)
        self.ct_flush()

    def _load_lb_family(self, stride: int, t) -> None:
        if t is None:
            z8 = np.zeros(1, np.uint8)
            z32 = np.zeros(1, np.int32)
            self._lib.nf_load_lb(
                self._h, stride, 0, 1,
                _ptr(z8, ctypes.c_uint8), _ptr(z32, ctypes.c_int32),
                _ptr(z32, ctypes.c_int32), _ptr(z32, ctypes.c_int32),
                _ptr(z32, ctypes.c_int32), _ptr(z32, ctypes.c_int32),
                0, _ptr(z8, ctypes.c_uint8), _ptr(z32, ctypes.c_int32),
            )
            return
        fe_addr = np.ascontiguousarray(t.fe_bytes.numpy(), np.uint8)
        be_addr = np.ascontiguousarray(t.be_bytes.numpy(), np.uint8)
        fe_port = np.ascontiguousarray(t.fe_port.numpy(), np.int32)
        fe_proto = np.ascontiguousarray(t.fe_proto.numpy(), np.int32)
        fe_seq = np.ascontiguousarray(t.fe_seq.numpy(), np.int32)
        fe_seq_len = np.ascontiguousarray(t.fe_seq_len.numpy(), np.int32)
        fe_revnat = np.ascontiguousarray(t.fe_revnat.numpy(), np.int32)
        be_port = np.ascontiguousarray(t.be_port.numpy(), np.int32)
        self._lib.nf_load_lb(
            self._h, stride, fe_addr.shape[0], fe_seq.shape[1],
            _ptr(fe_addr, ctypes.c_uint8), _ptr(fe_port, ctypes.c_int32),
            _ptr(fe_proto, ctypes.c_int32), _ptr(fe_seq, ctypes.c_int32),
            _ptr(fe_seq_len, ctypes.c_int32),
            _ptr(fe_revnat, ctypes.c_int32),
            be_addr.shape[0], _ptr(be_addr, ctypes.c_uint8),
            _ptr(be_port, ctypes.c_int32),
        )

    # -- L7 -------------------------------------------------------------
    def load_l7_http(
        self, endpoint_id: int, port: int, http_policy, *,
        ingress: bool = True,
    ) -> None:
        """Load one (endpoint, port, direction)'s HTTP policy into the
        native enforcer (the envoy/cilium_l7policy.cc role): the SAME
        MultiDFA tables HTTPPolicy compiled, plus per-rule accept-bit
        indices and identity scopes. Raises when any rule relies on
        host-only matching (regex demoted from the DFA, or header
        matchers) — refusing loudly beats silently diverging."""
        m, p, hst, rules = http_policy.native_tables()
        n = len(rules)
        m_bit = np.ascontiguousarray([r[0] for r in rules], np.int32)
        p_bit = np.ascontiguousarray([r[1] for r in rules], np.int32)
        h_bit = np.ascontiguousarray([r[2] for r in rules], np.int32)
        scoped = np.ascontiguousarray(
            [1 if r[3] is not None else 0 for r in rules], np.uint8
        )
        off = [0]
        idents: list = []
        for r in rules:
            if r[3] is not None:
                idents.extend(sorted(r[3]))
            off.append(len(idents))
        ident_off = np.ascontiguousarray(off, np.int64)
        ident_arr = np.ascontiguousarray(idents or [0], np.uint64)

        def dfa_args(d):
            if d is None:
                z = np.zeros(256, np.int32)
                za = np.zeros(1, np.uint64)
                return (_ptr(z, ctypes.c_int32), _ptr(za, ctypes.c_uint64),
                        0, 0, (z, za))
            trans = np.ascontiguousarray(d.trans, np.int32)
            accept = np.ascontiguousarray(d.accept, np.uint64)
            return (_ptr(trans, ctypes.c_int32),
                    _ptr(accept, ctypes.c_uint64),
                    trans.shape[0], int(d.start), (trans, accept))

        mt, ma, mq, ms, mk = dfa_args(m)
        pt, pa, pq, ps, pk = dfa_args(p)
        ht, ha, hq, hs, hk = dfa_args(hst)
        self._lib.nf_l7_set_http(
            self._h, endpoint_id, port, 1 if ingress else 0,
            mt, ma, mq, ms, pt, pa, pq, ps, ht, ha, hq, hs,
            n, _ptr(m_bit, ctypes.c_int32), _ptr(p_bit, ctypes.c_int32),
            _ptr(h_bit, ctypes.c_int32), _ptr(scoped, ctypes.c_uint8),
            _ptr(ident_off, ctypes.c_int64),
            _ptr(ident_arr, ctypes.c_uint64),
        )

    def load_l7_kafka(
        self, endpoint_id: int, port: int, kafka_acl, *,
        ingress: bool = True,
    ) -> None:
        """Load one (endpoint, port, direction)'s Kafka ACL vectors +
        interned topic/client tables (pkg/kafka/policy.go MatchesRule,
        natively)."""
        n = len(kafka_acl)
        key_mask = np.ascontiguousarray(kafka_acl.key_mask, np.uint32)
        key_wild = np.ascontiguousarray(kafka_acl.key_wild, np.uint8)
        version = np.ascontiguousarray(kafka_acl.version, np.int32)
        topic_id = np.ascontiguousarray(kafka_acl.topic_id, np.int32)
        clients = kafka_acl.client_id  # list of strings per rule
        cli_tbl = sorted({c for c in clients if c})
        cli_ids = {c: i for i, c in enumerate(cli_tbl)}
        client_id = np.ascontiguousarray(
            [cli_ids.get(c, -1) if c else -1 for c in clients], np.int32
        )
        scoped = np.ascontiguousarray(
            [1 if idents is not None else 0 for _r, idents in kafka_acl._rules],
            np.uint8,
        )
        off = [0]
        idents_flat: list = []
        for _r, idents in kafka_acl._rules:
            if idents is not None:
                idents_flat.extend(sorted(idents))
            off.append(len(idents_flat))
        ident_off = np.ascontiguousarray(off, np.int64)
        ident_arr = np.ascontiguousarray(idents_flat or [0], np.uint64)

        def strtab(strs):
            offs = [0]
            blob = b""
            for s in strs:
                blob += s.encode()
                offs.append(len(blob))
            b = np.frombuffer(blob or b"\0", np.uint8).copy()
            return b, np.ascontiguousarray(offs, np.int64)

        topics = [t for t, _ in sorted(
            kafka_acl._topic_ids.items(), key=lambda kv: kv[1]
        )]
        t_bytes, t_off = strtab(topics)
        c_bytes, c_off = strtab(cli_tbl)
        self._lib.nf_l7_set_kafka(
            self._h, endpoint_id, port, 1 if ingress else 0,
            n, _ptr(key_mask, ctypes.c_uint32),
            _ptr(key_wild, ctypes.c_uint8), _ptr(version, ctypes.c_int32),
            _ptr(topic_id, ctypes.c_int32), _ptr(client_id, ctypes.c_int32),
            _ptr(scoped, ctypes.c_uint8), _ptr(ident_off, ctypes.c_int64),
            _ptr(ident_arr, ctypes.c_uint64),
            len(topics), _ptr(t_bytes, ctypes.c_uint8),
            _ptr(t_off, ctypes.c_int64),
            len(cli_tbl), _ptr(c_bytes, ctypes.c_uint8),
            _ptr(c_off, ctypes.c_int64),
        )

    def check_http_batch(
        self, endpoint_id: int, port: int, requests, *,
        ingress: bool = True, max_len: int = 256,
    ) -> np.ndarray:
        """Native per-request HTTP enforcement → [B] bool allow (the
        same contract as HTTPPolicy.check_batch). Field widths adapt to
        the batch's longest value so overlong strings still match —
        HTTPPolicy deliberately host-walks overlong values rather than
        failing closed, and the native path must agree. Values past
        64KiB raise (bounded allocation; route those to the Python
        path)."""
        from ..l7.http_policy import NativeL7Unsupported
        from ..ops.dfa import strings_to_batch

        n = len(requests)
        enc_m = [r.method.encode() for r in requests]
        enc_p = [r.path.encode() for r in requests]
        enc_h = [r.host.encode() for r in requests]

        def width(encs, floor):
            longest = max(map(len, encs), default=0)
            if longest > 65536:
                raise NativeL7Unsupported(
                    f"request field of {longest} bytes exceeds the "
                    "native 64KiB cap"
                )
            return max(floor, longest)

        m_w = width(enc_m, 16)
        p_w = width(enc_p, max_len)
        h_w = width(enc_h, max_len)
        mb, ml = strings_to_batch(enc_m, m_w)
        pb, pl = strings_to_batch(enc_p, p_w)
        hb, hl = strings_to_batch(enc_h, h_w)
        src = np.ascontiguousarray(
            [r.src_identity for r in requests], np.uint64
        )
        allow = np.empty(n, np.uint8)
        self._lib.nf_l7_http_batch(
            self._h, endpoint_id, port, 1 if ingress else 0, n,
            _ptr(np.ascontiguousarray(mb, np.uint8), ctypes.c_uint8), m_w,
            _ptr(np.ascontiguousarray(ml, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(pb, np.uint8), ctypes.c_uint8),
            p_w,
            _ptr(np.ascontiguousarray(pl, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(hb, np.uint8), ctypes.c_uint8),
            h_w,
            _ptr(np.ascontiguousarray(hl, np.int32), ctypes.c_int32),
            _ptr(src, ctypes.c_uint64), _ptr(allow, ctypes.c_uint8),
        )
        return allow.astype(bool)

    def check_kafka_batch(
        self, endpoint_id: int, port: int, requests, *,
        ingress: bool = True,
    ) -> np.ndarray:
        """Native Kafka ACL enforcement → [B] bool allow (the same
        contract as KafkaACL.check_batch)."""
        from ..ops.dfa import strings_to_batch

        n = len(requests)
        tb, tl = strings_to_batch([r.topic.encode() for r in requests], 255)
        cb, cl = strings_to_batch(
            [r.client_id.encode() for r in requests], 255
        )
        api_key = np.ascontiguousarray([r.api_key for r in requests], np.int32)
        api_ver = np.ascontiguousarray(
            [r.api_version for r in requests], np.int32
        )
        src = np.ascontiguousarray(
            [r.src_identity for r in requests], np.uint64
        )
        allow = np.empty(n, np.uint8)
        self._lib.nf_l7_kafka_batch(
            self._h, endpoint_id, port, 1 if ingress else 0, n,
            _ptr(api_key, ctypes.c_int32), _ptr(api_ver, ctypes.c_int32),
            _ptr(np.ascontiguousarray(tb, np.uint8), ctypes.c_uint8), 255,
            _ptr(np.ascontiguousarray(tl, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(cb, np.uint8), ctypes.c_uint8), 255,
            _ptr(np.ascontiguousarray(cl, np.int32), ctypes.c_int32),
            _ptr(src, ctypes.c_uint64), _ptr(allow, ctypes.c_uint8),
        )
        return allow.astype(bool)

    # -- evaluation -----------------------------------------------------
    def process(
        self,
        src_ips: np.ndarray,  # [B] uint32 IPv4 peer addresses
        ep_idx: np.ndarray,
        dports: np.ndarray,
        protos: np.ndarray,
        *,
        ingress: bool = True,
        sports: Optional[np.ndarray] = None,
    ):
        """Same contract as DatapathPipeline.process → (verdict int8,
        redirect bool)."""
        peer = np.ascontiguousarray(
            ipv4_to_bytes(np.asarray(src_ips)), np.uint8
        )
        return self._eval(peer, 4, ep_idx, dports, protos, sports, ingress)

    def process_v6(
        self, peer_bytes: np.ndarray, ep_idx, dports, protos,
        *, ingress: bool = True, sports=None,
    ):
        peer = np.ascontiguousarray(peer_bytes, np.uint8)
        return self._eval(peer, 16, ep_idx, dports, protos, sports, ingress)

    def _eval(self, peer, stride, ep_idx, dports, protos, sports, ingress):
        n = peer.shape[0]
        ep_idx = np.ascontiguousarray(ep_idx, np.int32)
        dports = np.ascontiguousarray(dports, np.int32)
        protos = np.ascontiguousarray(protos, np.int32)
        verdict = np.empty(n, np.int8)
        redirect = np.empty(n, np.uint8)
        sp = (
            None if sports is None
            else np.ascontiguousarray(sports, np.int32)
        )
        self._lib.nf_eval_batch(
            self._h, n, _ptr(peer, ctypes.c_uint8), stride,
            _ptr(ep_idx, ctypes.c_int32), _ptr(dports, ctypes.c_int32),
            _ptr(protos, ctypes.c_int32),
            None if sp is None else _ptr(sp, ctypes.c_int32),
            1 if ingress else 0,
            _ptr(verdict, ctypes.c_int8), _ptr(redirect, ctypes.c_uint8),
        )
        return verdict, redirect.astype(bool)

    @property
    def counters(self) -> np.ndarray:
        out = np.zeros(max(1, self.ep_count) * 3, np.int64)
        self._lib.nf_counters(self._h, _ptr(out, ctypes.c_int64))
        return out.reshape(-1, 3)

    # -- convenience ----------------------------------------------------
    @classmethod
    def from_pipeline(
        cls, pipeline, *, ingress: bool = True, ct_bits: int = 18
    ) -> "NativeFastpath":
        """Snapshot a DatapathPipeline's realized state into a native
        front-end (both directions are loaded; `ingress` only selects
        which snapshot list defines endpoint order — they share it)."""
        from ..identity.model import ID_WORLD
        from ..ops.materialize import TRAFFIC_EGRESS

        pipeline.rebuild()
        ing = pipeline._mat[TRAFFIC_INGRESS].snapshots
        eg = pipeline._mat[TRAFFIC_EGRESS].snapshots
        from ..ops.materialize import EndpointPolicySnapshot

        nf = cls(ep_count=len(ing), ct_bits=ct_bits)
        nf.set_world_identity(ID_WORLD)
        # both directions share endpoint indices; merge entry dicts
        merged = [
            EndpointPolicySnapshot(
                entries={**a.entries, **b.entries}, slots=a.slots
            )
            for a, b in zip(ing, eg)
        ]
        nf.load_policy_snapshots(merged)
        nf.load_ipcache(pipeline.ipcache)
        nf.load_prefilter(pipeline.prefilter)
        nf.set_endpoint_ids(pipeline._endpoint_ids)
        if pipeline.lb is not None:
            nf.load_lb(pipeline.lb)
        return nf
