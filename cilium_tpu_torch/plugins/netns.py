"""Real network-interface plumbing for the CNI layer.

Reference: plugins/cilium-cni/cilium-cni.go — ADD creates a veth pair,
moves the container end into the target netns, configures addresses,
and hands the HOST end to the datapath. The reference drives netlink
directly (vishvananda/netlink); here the portable equivalent is
iproute2 (`ip ...` subprocesses) — same kernel objects, same shapes:

    host side:       lxc<epid>  (the bpf_lxc attachment point)
    container side:  eth0 inside the netns, carrying the IPAM address

Everything degrades cleanly: ``have_netns()`` probes capability
(CAP_NET_ADMIN + iproute2) so deployments without it keep the virtual
CNI flow, exactly as before.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional

from ..utils.logging import get_logger

log = get_logger("netns")

_IP = "ip"


class NetnsError(Exception):
    pass


def _run(*args: str, check: bool = True) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        [_IP, *args], capture_output=True, text=True, timeout=10
    )
    if check and proc.returncode != 0:
        raise NetnsError(
            f"ip {' '.join(args)}: rc={proc.returncode} "
            f"{proc.stderr.strip()}"
        )
    return proc


_have: Optional[bool] = None


def have_netns() -> bool:
    """Capability probe (cached): can this process create netns +
    veth? False on unprivileged or ip-less hosts — callers fall back
    to the virtual flow."""
    global _have
    if _have is not None:
        return _have
    import os
    import uuid

    # unique per-probe name: a fixed name could collide with a crashed
    # prior probe's leftover (or a concurrent prober) and cache a
    # false negative for the whole process lifetime
    probe = f"ctpu-probe-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    try:
        _run("netns", "add", probe)
        _run("netns", "del", probe)
        _have = True
    except (NetnsError, OSError, subprocess.TimeoutExpired):
        _have = False
    return _have


def create_netns(name: str) -> None:
    _run("netns", "add", name)


def delete_netns(name: str) -> None:
    _run("netns", "del", name, check=False)


def list_netns() -> List[str]:
    out = _run("netns", "list", check=False).stdout
    return [line.split()[0] for line in out.splitlines() if line.split()]


def create_endpoint_veth(
    host_if: str,
    netns: str,
    ipv4_cidr: str,
    *,
    container_if: str = "eth0",
    gateway: Optional[str] = None,
) -> None:
    """The CNI ADD interface sequence (cilium-cni.go): veth pair, peer
    into the netns as eth0 with the endpoint address, both ends up,
    default route via the gateway. Cleans the host link up on any
    mid-sequence failure so a retry starts fresh."""
    tmp_peer = f"{host_if}_p"[:15]  # IFNAMSIZ
    _run("link", "add", host_if, "type", "veth", "peer", "name", tmp_peer)
    try:
        _run("link", "set", tmp_peer, "netns", netns)
        _run("-n", netns, "link", "set", tmp_peer, "name", container_if)
        _run("-n", netns, "addr", "add", ipv4_cidr, "dev", container_if)
        _run("-n", netns, "link", "set", container_if, "up")
        _run("-n", netns, "link", "set", "lo", "up")
        _run("link", "set", host_if, "up")
        if gateway:
            # the host end is the endpoint's next hop (cilium's
            # point-to-point LXC device model): give it the gateway
            # address scoped to the link and route everything there
            _run("addr", "add", f"{gateway}/32", "dev", host_if,
                 check=False)
            _run("-n", netns, "route", "add", gateway, "dev", container_if)
            _run("-n", netns, "route", "add", "default", "via", gateway)
    except (NetnsError, OSError, subprocess.TimeoutExpired):
        # ANY mid-sequence failure must remove the host link — a
        # leaked lxc* would make every ADD retry fail with EEXIST
        delete_link(host_if)
        raise


def delete_link(host_if: str) -> bool:
    """Remove the host-side veth (kills both ends). Idempotent; never
    raises (DEL must succeed on hosts without iproute2 too)."""
    try:
        return _run("link", "del", host_if, check=False).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def netns_run(netns: str, argv: List[str], timeout: float = 15.0):
    """Run a command inside the netns (tests use this as the
    'container process')."""
    return subprocess.run(
        [_IP, "netns", "exec", netns, *argv],
        capture_output=True, text=True, timeout=timeout,
    )
