"""L7 policy enforcement (reference: pkg/proxy, pkg/kafka, envoy/).

The reference redirects L7 flows to Envoy (HTTP, C++ filters enforcing
NPDS policy per request) or a built-in Kafka proxy (Go). Here the
enforcement core is device-shaped: HTTP method/path/host regexes
compile to one multi-pattern DFA per endpoint-port (ops/dfa.py) walked
on the card over request-string batches; Kafka ACLs lower to enum/id tables.
The proxy manager keeps the redirect bookkeeping (port allocation,
redirect lifecycle, access logs) host-side.
"""

from .regex_compile import RegexError, compile_patterns, nfa_from_regex
from .http_policy import HTTPPolicy, HTTPRequest
from .kafka_policy import KafkaACL, KafkaRequest

__all__ = [
    "RegexError",
    "compile_patterns",
    "nfa_from_regex",
    "HTTPPolicy",
    "HTTPRequest",
    "KafkaACL",
    "KafkaRequest",
]
