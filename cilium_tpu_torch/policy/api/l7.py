"""L7 rule models: HTTP and Kafka.

Reference: pkg/policy/api/http.go (PortRuleHTTP — Path/Method/Host are
POSIX extended regexes, Headers are exact-presence matches) and
pkg/policy/api/kafka.go (PortRuleKafka — Role/APIKey/APIVersion/
ClientID/Topic with produce/consume role expansion,
pkg/kafka/policy.go:144).

These are pure data; compilation to DFA transition tables / ACL tables
lives in cilium_tpu.l7.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

# Kafka api-keys (kafka protocol numbers, pkg/policy/api/kafka.go:71-117)
KAFKA_API_KEYS = {
    "produce": 0,
    "fetch": 1,
    "offsets": 2,
    "metadata": 3,
    "leaderandisr": 4,
    "stopreplica": 5,
    "updatemetadata": 6,
    "controlledshutdown": 7,
    "offsetcommit": 8,
    "offsetfetch": 9,
    "findcoordinator": 10,
    "joingroup": 11,
    "heartbeat": 12,
    "leavegroup": 13,
    "syncgroup": 14,
    "describegroups": 15,
    "listgroups": 16,
    "saslhandshake": 17,
    "apiversions": 18,
    "createtopics": 19,
    "deletetopics": 20,
}

# Role → api-key expansion (pkg/policy/api/kafka.go RoleProduce/RoleConsume)
KAFKA_ROLE_PRODUCE = ("produce", "metadata", "apiversions")
KAFKA_ROLE_CONSUME = (
    "fetch",
    "offsets",
    "metadata",
    "offsetcommit",
    "offsetfetch",
    "findcoordinator",
    "joingroup",
    "heartbeat",
    "leavegroup",
    "syncgroup",
    "apiversions",
)

KAFKA_MAX_TOPIC_LEN = 255
_KAFKA_TOPIC_RE = re.compile(r"^[a-zA-Z0-9\._\-]+$")


@dataclasses.dataclass(frozen=True)
class HTTPRule:
    """One HTTP allow clause; empty fields are wildcards. All present
    fields must match for the clause to match (http.go Sanitize)."""

    path: str = ""  # regex, anchored both ends at compile time
    method: str = ""  # regex
    host: str = ""  # regex
    headers: Tuple[str, ...] = ()  # "Name[: value]" exact matches

    def sanitize(self) -> None:
        for pattern, what in ((self.path, "path"), (self.method, "method"), (self.host, "host")):
            if pattern:
                try:
                    re.compile(pattern)
                except re.error as e:
                    raise ValueError(f"invalid {what} regex {pattern!r}: {e}") from e

    def matches(self, method: str, path: str, host: str = "", headers: Optional[dict] = None) -> bool:
        """Host-side oracle evaluation (full-anchored like the envoy-side
        matcher, envoy/cilium_network_policy.h HttpNetworkPolicyRule)."""
        if self.method and not re.fullmatch(self.method, method):
            return False
        if self.path and not re.fullmatch(self.path, path):
            return False
        if self.host and not re.fullmatch(self.host, host):
            return False
        for h in self.headers:
            name, _, want = h.partition(":")
            got = (headers or {}).get(name.strip().lower())
            if got is None:
                return False
            if want and got.strip() != want.strip():
                return False
        return True


@dataclasses.dataclass(frozen=True)
class KafkaRule:
    """One Kafka allow clause (kafka.go PortRuleKafka)."""

    role: str = ""  # "produce" | "consume" (expands to api-key sets)
    api_key: str = ""  # named api key, mutually exclusive with role
    api_version: str = ""  # exact numeric match when set
    client_id: str = ""
    topic: str = ""

    def sanitize(self) -> None:
        if self.role and self.api_key:
            raise ValueError("Kafka rule: role and api_key are mutually exclusive")
        if self.role and self.role.lower() not in ("produce", "consume"):
            raise ValueError(f"invalid Kafka role {self.role!r}")
        if self.api_key and self.api_key.lower() not in KAFKA_API_KEYS:
            raise ValueError(f"unknown Kafka api_key {self.api_key!r}")
        if self.api_version:
            int(self.api_version)  # raises if non-numeric
        if self.topic:
            if len(self.topic) > KAFKA_MAX_TOPIC_LEN:
                raise ValueError("Kafka topic too long")
            if not _KAFKA_TOPIC_RE.match(self.topic):
                raise ValueError(f"invalid Kafka topic {self.topic!r}")

    def allowed_api_keys(self) -> Tuple[int, ...]:
        """Expand role/api_key to the set of allowed protocol numbers;
        empty tuple = all keys allowed (kafka.go GetAPIKeys)."""
        if self.api_key:
            return (KAFKA_API_KEYS[self.api_key.lower()],)
        if self.role.lower() == "produce":
            return tuple(KAFKA_API_KEYS[k] for k in KAFKA_ROLE_PRODUCE)
        if self.role.lower() == "consume":
            return tuple(KAFKA_API_KEYS[k] for k in KAFKA_ROLE_CONSUME)
        return ()

    def matches(self, api_key: int, api_version: int, client_id: str, topic: str) -> bool:
        """Host-side oracle (pkg/kafka/policy.go RequestMessage.MatchesRule)."""
        allowed = self.allowed_api_keys()
        if allowed and api_key not in allowed:
            return False
        if self.api_version and int(self.api_version) != api_version:
            return False
        if self.client_id and self.client_id != client_id:
            return False
        if self.topic and self.topic != topic:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class L7Rules:
    """Union container: at most one protocol may be populated
    (pkg/policy/api/l4.go L7Rules)."""

    http: Tuple[HTTPRule, ...] = ()
    kafka: Tuple[KafkaRule, ...] = ()

    def sanitize(self) -> None:
        if self.http and self.kafka:
            raise ValueError("only one L7 protocol per port rule")
        for r in self.http:
            r.sanitize()
        for r in self.kafka:
            r.sanitize()

    @property
    def parser(self) -> str:
        if self.http:
            return "http"
        if self.kafka:
            return "kafka"
        return ""

    def __bool__(self) -> bool:
        return bool(self.http or self.kafka)
