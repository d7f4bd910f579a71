"""CNI-shaped endpoint plumbing.

Reference: plugins/cilium-cni/cilium-cni.go — ADD creates the veth
pair, asks the daemon for an IP (POST /ipam), then registers the
endpoint (PUT /endpoint/{id}); DEL is symmetric.

Interfaces are REAL when a target netns is given and the host allows
it (plugins/netns.py: veth pair, container end as eth0 with the
allocated address, default route via the host end — the cilium
point-to-point LXC device model); without a netns (or capability) the
flow stays virtual with the same command sequence, result shape, and
failure cleanup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class CNIResult:
    """CNI ADD result (the types.Result subset we produce)."""

    endpoint_id: int
    ipv4: Optional[str]
    interface: str
    gateway: Optional[str] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class CNIError(Exception):
    pass


def cni_add(
    daemon,
    container_id: str,
    *,
    labels: Optional[List[str]] = None,
    ifname: str = "eth0",
    netns: Optional[str] = None,
) -> CNIResult:
    """CNI ADD: allocate an IP, register the endpoint, return the
    result. With ``netns``, also create the REAL veth pair (host side
    lxc<epid>, container side ``ifname`` inside the netns carrying the
    address). On any failure, everything already created is rolled
    back (the reference releases IPAM and deletes the link on error
    too)."""
    ep_id = endpoint_id_for(container_id)
    ip = daemon.ipam.allocate_next(owner=container_id)
    host_if = host_ifname(ep_id)
    gateway = gateway_for(daemon.ipam.net)
    if netns is not None:
        from . import netns as nsmod

        try:
            # /32 on the container side: the cilium point-to-point LXC
            # model — NO connected subnet route, so even same-pod-CIDR
            # peers route via the gateway (the host veth), which is
            # where enforcement sits (cilium-cni.go configures the
            # endpoint address exactly this way)
            nsmod.create_endpoint_veth(
                host_if, netns, f"{ip}/32",
                container_if=ifname, gateway=gateway,
            )
        except Exception as e:
            daemon.ipam.release(ip)
            raise CNIError(f"interface create failed: {e}") from e
    try:
        daemon.endpoint_add(
            ep_id,
            labels or [f"container:id={container_id[:12]}"],
            ipv4=ip,
            pod_name=container_id,
        )
    except Exception as e:
        if netns is not None:
            from . import netns as nsmod

            nsmod.delete_link(host_if)
        daemon.ipam.release(ip)
        raise CNIError(f"endpoint create failed: {e}") from e
    return CNIResult(
        endpoint_id=ep_id,
        ipv4=ip,
        interface=host_if,
        gateway=gateway,
    )


def cni_del(daemon, container_id: str) -> bool:
    """CNI DEL: tear down the endpoint, its host interface (if one was
    plumbed — deleting the host end kills both sides of the veth), and
    release its IP. Idempotent (the CNI spec requires DEL to succeed
    for unknown containers)."""
    ep_id = endpoint_id_for(container_id)
    from . import netns as nsmod

    # unconditional: delete_link never raises (no-op on ip-less hosts),
    # and gating on the capability probe could leak veths if the probe
    # false-negatives after ADDs succeeded
    nsmod.delete_link(host_ifname(ep_id))
    # endpoint_delete releases the endpoint's IPAM address itself; a
    # second release here would race a concurrent ADD that was just
    # handed the freed address and release it out from under the new
    # endpoint.
    return daemon.endpoint_delete(ep_id)


def host_ifname(ep_id: int) -> str:
    """The host-side veth name for an endpoint — ONE definition so
    ADD and DEL (in-process and the cni_exec binary) always agree
    (a divergent name would leak the veth on DEL)."""
    return f"lxc{ep_id}"[:15]  # IFNAMSIZ


def gateway_for(net) -> str:
    """The pod-CIDR gateway address (the host ends of every veth)."""
    import ipaddress as _ipa

    if not hasattr(net, "network_address"):
        net = _ipa.ip_network(str(net))
    return str(net.network_address + 1)


def endpoint_id_for(container_id: str) -> int:
    """Stable endpoint id from a container id (the reference derives
    endpoint ids from the interface; here a stable hash keeps ADD/DEL
    symmetric without shared state)."""
    import hashlib

    h = hashlib.sha256(container_id.encode()).digest()
    return 4096 + (int.from_bytes(h[:4], "big") % (2**20))
