"""xDS-style policy distribution: versioned resource cache,
ADS-shaped subscription streams with ACK/NACK completions, and the
NPDS/NPHDS resource producers (the pkg/envoy/xds + pkg/envoy
server.go roles for external L7 proxies)."""

from .cache import (
    NETWORK_POLICY_HOSTS_TYPE,
    NETWORK_POLICY_TYPE,
    ResourceCache,
)
from .client import XDSClient
from .npds import (
    delete_endpoint_policy,
    endpoint_policy_resource,
    publish_endpoint_policy,
    publish_host_mapping,
    wire_nphds,
)
from .server import XDSServer

__all__ = [
    "NETWORK_POLICY_HOSTS_TYPE",
    "NETWORK_POLICY_TYPE",
    "ResourceCache",
    "XDSClient",
    "XDSServer",
    "delete_endpoint_policy",
    "endpoint_policy_resource",
    "publish_endpoint_policy",
    "publish_host_mapping",
    "wire_nphds",
]
