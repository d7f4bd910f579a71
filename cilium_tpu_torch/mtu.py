"""MTU derivation.

Reference: pkg/mtu (mtu.go): the device MTU plus the derived route and
tunnel MTUs — tunnel overhead subtracts the encap header so encapsulated
paths don't fragment.
"""

from __future__ import annotations

import dataclasses

ETH_MTU_DEFAULT = 1500
TUNNEL_OVERHEAD_VXLAN = 50  # outer IPv4 + UDP + VXLAN
TUNNEL_OVERHEAD_GENEVE = 50
MIN_MTU = 576  # RFC 791 floor


@dataclasses.dataclass(frozen=True)
class MTUConfig:
    """mtu.go Configuration."""

    device_mtu: int = ETH_MTU_DEFAULT
    tunnel: str = "vxlan"  # vxlan | geneve | disabled

    def __post_init__(self) -> None:
        if self.tunnel not in ("vxlan", "geneve", "disabled"):
            raise ValueError(f"unknown tunnel mode {self.tunnel!r}")
        if self.device_mtu < MIN_MTU:
            raise ValueError(f"device MTU {self.device_mtu} below {MIN_MTU}")
        # the tunnel payload must itself clear the floor — clamping
        # route_mtu UP would advertise more than the encap can carry
        # and reintroduce the fragmentation this module exists to avoid
        if self.tunnel != "disabled" and self.route_mtu < MIN_MTU:
            raise ValueError(
                f"device MTU {self.device_mtu} leaves tunnel payload "
                f"{self.route_mtu} below {MIN_MTU}"
            )

    @property
    def route_mtu(self) -> int:
        """MTU for routes toward remote pods (GetRouteMTU): the tunnel
        payload size when encapsulating, the device MTU otherwise."""
        if self.tunnel == "disabled":
            return self.device_mtu
        overhead = (
            TUNNEL_OVERHEAD_GENEVE if self.tunnel == "geneve"
            else TUNNEL_OVERHEAD_VXLAN
        )
        return self.device_mtu - overhead

    @property
    def device(self) -> int:
        """MTU for local devices (GetDeviceMTU)."""
        return self.device_mtu
