"""Kafka ACL enforcement as broadcast-compare tables.

Reference: pkg/kafka/policy.go:144,200 — a request (api_key,
api_version, client_id, topics) matches a rule when every set field
matches, with Role produce/consume expanding to api-key sets
(pkg/policy/api/kafka.go). Deny → synthesized error response
(pkg/kafka/request.go:158).

Tensorization: api-key sets become a 32-bit mask per rule; topics and
client-ids are interned to ids; a batch check is [B, R] broadcast
compares — fully device-friendly, no string work per request after
interning.

With ``L7DeviceBatch`` on, the topic/client-id string→id resolution
rides the same fused DFA path as HTTP (each interned literal becomes
one pattern; the accept bit IS the id), sharing interned device tables
across endpoints with the same ACL. Off, the dict-lookup path below
runs unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import _kernels
from ..datapath import l7_pipeline as l7rt
from ..ops.dfa import fuse_dfas, intern_fused_table
from ..policy.api import KafkaRule
from .http_policy import _DEVICE_BATCH_MIN
from .regex_compile import RegexError, compile_patterns_cached


def _mask_ids(mask: np.ndarray) -> np.ndarray:
    """[B] uint64 one-hot accept masks → [B] int32 literal ids (-2 =
    no match, the dict-lookup miss sentinel). Distinct literals are
    disjoint, so at most one bit is set; frexp's exponent recovers the
    bit index exactly (powers of two are exact in float64)."""
    ids = np.full(mask.shape, -2, np.int32)
    nz = mask != 0
    if nz.any():
        _, e = np.frexp(mask[nz].astype(np.float64))
        ids[nz] = (e - 1).astype(np.int32)
    return ids


@dataclasses.dataclass(frozen=True)
class KafkaRequest:
    api_key: int
    api_version: int = 0
    client_id: str = ""
    topic: str = ""
    src_identity: int = 0


class KafkaACL:
    """All Kafka rules for one (endpoint, port). ``device`` (None =
    the card) is where its literal classification walks run."""

    def __init__(self, rules: Sequence[Tuple[KafkaRule, Optional[Set[int]]]],
                 device=None) -> None:
        self.device = _kernels.resolve_device(device)
        self._rules = list(rules)
        self._topic_ids: Dict[str, int] = {}
        r = len(rules)
        self.key_mask = np.zeros(r, np.uint32)  # bit k = api_key k allowed
        self.key_wild = np.zeros(r, bool)  # rule has no api-key restriction
        self.version = np.full(r, -1, np.int32)  # -1 = wildcard
        self.topic_id = np.full(r, -1, np.int32)
        self.client_id: List[str] = []
        for i, (rule, _idents) in enumerate(rules):
            keys = rule.allowed_api_keys()
            self.key_wild[i] = not keys
            self.key_mask[i] = (
                np.uint32(0xFFFFFFFF)
                if not keys
                else np.uint32(sum(1 << k for k in keys))
            )
            if rule.api_version:
                self.version[i] = int(rule.api_version)
            if rule.topic:
                self.topic_id[i] = self._intern_topic(rule.topic)
            self.client_id.append(rule.client_id)
        # Per-batch-invariant lookup state, hoisted out of check_batch:
        # rebuilding the client-id intern map and the scoped identity
        # arrays per call made every batch pay O(R) dict/array builds —
        # the kafka_acl_rps drag once batches got small and frequent.
        self._cli_ids: Dict[str, int] = (
            {c: k for k, c in enumerate(sorted(set(self.client_id)))}
            if any(self.client_id)
            else {}
        )
        self._rule_cli_id: Optional[np.ndarray] = (
            np.array(
                [self._cli_ids[c] if c else -1 for c in self.client_id],
                np.int32,
            )
            if self._cli_ids
            else None
        )
        self._scoped: List[Tuple[int, np.ndarray]] = [
            (j, np.fromiter(idents, np.int64, len(idents)))
            for j, (_r, idents) in enumerate(self._rules)
            if idents is not None
        ]
        # L7DeviceBatch literal classification (built lazily on first
        # gated batch so the OFF path never touches the device)
        self._fused_ready = False
        self._fused_table = None
        self._fused_fields: List[Tuple[str, int]] = []
        if l7rt.device_batch_enabled():
            self._ensure_fused()

    def _ensure_fused(self) -> None:
        if self._fused_ready:
            return
        self._fused_ready = True
        fields: List[Tuple[str, List[str]]] = []
        # literal ids are accept-bit positions, so id order must equal
        # pattern order; one uint64 mask caps each map at 64 literals
        if self._topic_ids and len(self._topic_ids) <= 64:
            fields.append(
                ("topic", sorted(self._topic_ids, key=self._topic_ids.get))
            )
        if self._cli_ids and len(self._cli_ids) <= 64:
            fields.append(
                ("client_id", sorted(self._cli_ids, key=self._cli_ids.get))
            )
        if not fields:
            return
        try:
            dfas = [
                compile_patterns_cached([re.escape(v) for v in vals])
                for _, vals in fields
            ]
        except RegexError:
            return  # state cap — the dict path serves this ACL
        key = ("kafka", tuple((name, tuple(vals)) for name, vals in fields))
        self._fused_table = intern_fused_table(
            key, lambda: fuse_dfas(dfas), device=self.device
        )
        # a request string longer than every interned literal can't
        # match one, so the field cap is the longest literal: overlong
        # rows fail closed to -2, which is exactly the dict miss
        self._fused_fields = [
            (name, max(len(v.encode()) for v in vals)) for name, vals in fields
        ]
        pipe = l7rt.shared_pipeline()
        if pipe is not None:
            pipe.prewarm(self._fused_table, [c for _, c in self._fused_fields])

    def _device_ids(
        self, requests: Sequence[KafkaRequest]
    ) -> Optional[Dict[str, np.ndarray]]:
        """Resolve topic/client-id strings to interned ids on device →
        {"topic": [B] int32, "client_id": ...} (keys only for fused
        fields), or None when the device path doesn't apply."""
        self._ensure_fused()
        if self._fused_table is None:
            return None
        pipe = l7rt.shared_pipeline()
        if pipe is None:
            return None
        by_name = {
            "topic": lambda r: r.topic,
            "client_id": lambda r: r.client_id,
        }
        encs = [
            [by_name[name](r).encode() for r in requests]
            for name, _ in self._fused_fields
        ]
        pending = pipe.submit(
            self._fused_table,
            [(e, cap) for e, (_, cap) in zip(encs, self._fused_fields)],
            parser="kafka",
        )
        raws = pending.result()
        return {
            name: _mask_ids(raw)
            for raw, (name, _) in zip(raws, self._fused_fields)
        }

    def _intern_topic(self, topic: str) -> int:
        tid = self._topic_ids.get(topic)
        if tid is None:
            tid = len(self._topic_ids)
            self._topic_ids[topic] = tid
        return tid

    def __len__(self) -> int:
        return len(self._rules)

    def check_batch(self, requests: Sequence[KafkaRequest]) -> np.ndarray:
        """→ [B] bool allow (empty rule list allows everything)."""
        n = len(requests)
        if not self._rules:
            return np.ones(n, bool)
        api_key = np.array([r.api_key for r in requests], np.int32)
        version = np.array([r.api_version for r in requests], np.int32)
        dev = (
            self._device_ids(requests)
            if l7rt.device_batch_enabled() and n >= _DEVICE_BATCH_MIN
            else None
        )
        if dev is not None and "topic" in dev:
            topic = dev["topic"]
        else:
            topic = np.array(
                [self._topic_ids.get(r.topic, -2) for r in requests], np.int32
            )
        # [B, R] broadcast compares (the device-friendly form; numpy here
        # because L7 batch sizes are modest — the same expressions jit
        # directly when wired into the proxy fast path).
        # Real api keys exceed 31 (DescribeConfigs=32, SaslAuthenticate=36);
        # the 32-bit mask only constrains rules with an explicit key set —
        # wildcard rules match every key.
        in_mask = (self.key_mask[None, :] >> api_key[:, None].clip(0, 31)) & 1 == 1
        in_range = (api_key[:, None] >= 0) & (api_key[:, None] < 32)
        key_ok = self.key_wild[None, :] | (in_mask & in_range)
        ver_ok = (self.version[None, :] < 0) | (self.version[None, :] == version[:, None])
        top_ok = (self.topic_id[None, :] < 0) | (self.topic_id[None, :] == topic[:, None])
        ok = key_ok & ver_ok & top_ok
        # client-id: interned compare, vectorized over the batch
        # (an O(B·R) Python loop here dominated the batch rate ~20×);
        # the intern map and rule-side id array are __init__ caches
        if self._rule_cli_id is not None:
            if dev is not None and "client_id" in dev:
                req_cli_id = dev["client_id"]
            else:
                req_cli_id = np.array(
                    [self._cli_ids.get(r.client_id, -2) for r in requests],
                    np.int32,
                )
            ok &= (self._rule_cli_id[None, :] < 0) | (
                self._rule_cli_id[None, :] == req_cli_id[:, None]
            )
        # identity scoping: per scoped rule, one vectorized membership
        if self._scoped:
            src = np.array([r.src_identity for r in requests], np.int64)
            for j, idents_arr in self._scoped:
                cand = ok[:, j]
                if cand.any():
                    ok[cand, j] = np.isin(src[cand], idents_arr)
        return ok.any(axis=1)

    @classmethod
    def from_model(cls, rules: List[Dict], device=None) -> "KafkaACL":
        """Rebuild an ACL from the rules_model() JSON an NPDS
        subscriber received (the external proxy's deserialization
        side)."""
        pairs = []
        for d in rules:
            pairs.append((
                KafkaRule(
                    role=d.get("role", ""),
                    api_key=d.get("api_key", ""),
                    api_version=d.get("api_version", ""),
                    client_id=d.get("client_id", ""),
                    topic=d.get("topic", ""),
                ),
                set(d["remote_policies"]) if "remote_policies" in d else None,
            ))
        return cls(pairs, device=device)

    def rules_model(self) -> List[Dict]:
        """JSON-able view of the rules + their identity scopes (the
        NPDS kafka_rules shape, mirroring HTTPPolicy.rules_model)."""
        out: List[Dict] = []
        for rule, idents in self._rules:
            d: Dict = {}
            for key, val in (
                ("role", rule.role), ("api_key", rule.api_key),
                ("api_version", rule.api_version),
                ("client_id", rule.client_id), ("topic", rule.topic),
            ):
                if val:
                    d[key] = val
            if idents is not None:
                d["remote_policies"] = sorted(idents)
            out.append(d)
        return out

    def check(self, request: KafkaRequest) -> bool:
        return bool(self.check_batch([request])[0])
