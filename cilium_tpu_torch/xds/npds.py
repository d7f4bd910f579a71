"""NPDS / NPHDS resource production.

Reference: pkg/envoy/server.go:514,535 (UpdateNetworkPolicy — per-
endpoint L7 policy translated into cilium.NetworkPolicy resources)
and resources.go:88-172 (NPHDS: identity → host addresses, fed from
the ipcache). The daemon publishes both into the xDS ResourceCache;
external proxy processes subscribe via xds/client.py.
"""

from __future__ import annotations

from typing import Iterable, List

from .cache import (
    NETWORK_POLICY_HOSTS_TYPE,
    NETWORK_POLICY_TYPE,
    ResourceCache,
)


def endpoint_policy_resource(endpoint_id: int, proxy) -> dict:
    """One endpoint's cilium.NetworkPolicy: every L7 redirect on the
    endpoint becomes a per-port policy with its rule set."""
    ports: List[dict] = []
    for red in proxy.redirects_for(endpoint_id):
        entry: dict = {
            "port": red.dst_port,
            "ingress": red.ingress,
            "parser": red.parser,
            "proxy_port": red.proxy_port,
        }
        if red.http_policy is not None:
            entry["http_rules"] = red.http_policy.rules_model()
        if red.kafka_acl is not None:
            entry["kafka_rules"] = red.kafka_acl.rules_model()
        ports.append(entry)
    return {"endpoint_id": endpoint_id, "l7_ports": ports}


def publish_endpoint_policy(
    cache: ResourceCache, endpoint_id: int, proxy
) -> int:
    """UpdateNetworkPolicy (server.go:535): upsert the endpoint's
    policy resource; returns the NPDS version it produced."""
    return cache.upsert(
        NETWORK_POLICY_TYPE, str(endpoint_id),
        endpoint_policy_resource(endpoint_id, proxy),
    )


def delete_endpoint_policy(cache: ResourceCache, endpoint_id: int) -> int:
    return cache.delete(NETWORK_POLICY_TYPE, str(endpoint_id))


def publish_host_mapping(
    cache: ResourceCache, ipcache, identity: int
) -> int:
    """NPHDS row for one identity: the reverse identity → addresses
    map (resources.go:88-172). Empty prefix set deletes the row."""
    prefixes = ipcache.prefixes_for_identity(identity)
    if not prefixes:
        return cache.delete(NETWORK_POLICY_HOSTS_TYPE, str(identity))
    return cache.upsert(
        NETWORK_POLICY_HOSTS_TYPE, str(identity),
        {"policy": identity, "host_addresses": sorted(prefixes)},
    )


def wire_nphds(cache: ResourceCache, ipcache) -> None:
    """Subscribe the NPHDS type to ipcache churn: every upsert/delete
    refreshes the affected identities' rows (the ipcache listener
    fan-out of pkg/datapath/ipcache/listener.go, pointed at xDS)."""

    def on_change(key: str, old, new) -> None:
        for e in (old, new):
            if e is not None:
                publish_host_mapping(cache, ipcache, e.identity)

    ipcache.add_listener(on_change, replay=True)
