"""Load balancing: service tables, weighted backend selection, revNAT.

The port's stand-in for pkg/loadbalancer + pkg/maps/lbmap +
bpf/lib/lb.h — VIP→backend translation runs as a device stage (the
``lb_translate`` kernel) ahead of the egress policy check.
"""

from .device import LBTables, MAX_SEQ, flow_hash32, lb_translate, lb_translate_plain
from .service import Backend, L3n4Addr, LBService, ServiceManager, build_selection_seq

__all__ = [
    "Backend",
    "L3n4Addr",
    "LBService",
    "LBTables",
    "MAX_SEQ",
    "ServiceManager",
    "build_selection_seq",
    "flow_hash32",
    "lb_translate",
    "lb_translate_plain",
]
