"""FQDN policy: DNS-name rules resolved into generated CIDR rules
(the pkg/fqdn role — poller + TTL cache + rule translation)."""

from .cache import DNSCache
from .poller import DNSPoller, FQDNTranslator, system_resolver

__all__ = ["DNSCache", "DNSPoller", "FQDNTranslator", "system_resolver"]
