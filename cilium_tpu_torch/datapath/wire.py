"""Wire front-end: REAL packets off endpoint veths into the verdict
pipeline.

Reference position: bpf_lxc.c attached to the endpoint's lxc* device —
every packet entering/leaving the container crosses it and gets a
policy verdict. Without kernel offload, the userspace equivalent is an
AF_PACKET tap on the same host-side veth (created by the CNI layer,
plugins/netns.py): frames are drained into batches, their 5-tuples
parsed host-side, and the batch verdicted in ONE DatapathPipeline
call — the batching trade the whole framework is built around.

This is the demonstration-grade packet path (drop enforcement would
additionally require sitting inline, e.g. via a TAP pair or TC); its
role here is that the enforcement front-end consumes real wire bytes
end to end: netns → veth → AF_PACKET → parse → pipeline verdict.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..monitor.dissect import l2_offsets

ETH_P_ALL = 0x0003
ETH_P_IP = 0x0800

FLOW_FIELDS = ("src", "dst", "proto", "sport", "dport")


def parse_ipv4_frame(frame: bytes) -> Optional[Tuple[int, int, int, int, int]]:
    """Ethernet frame → (src_u32, dst_u32, proto, sport, dport) or None
    for non-IPv4 / truncated frames. Ports are 0 for non-TCP/UDP and
    for non-first fragments (their payload bytes are NOT L4 headers).

    L2 framing (ethertype / 802.1Q / truncation) comes from the shared
    monitor.dissect.l2_offsets rules; this is just the hot-loop tuple
    extraction on top."""
    l2 = l2_offsets(frame)
    if l2 is None:
        return None
    ethertype, ip0, _vlan = l2
    if ethertype != ETH_P_IP or len(frame) < ip0 + 20:
        return None
    ihl = (frame[ip0] & 0x0F) * 4
    if ihl < 20 or len(frame) < ip0 + ihl:
        return None
    proto = frame[ip0 + 9]
    (frag,) = struct.unpack_from(">H", frame, ip0 + 6)
    src, dst = struct.unpack_from(">II", frame, ip0 + 12)
    sport = dport = 0
    if (
        proto in (6, 17)
        and (frag & 0x1FFF) == 0  # first fragment only carries L4
        and len(frame) >= ip0 + ihl + 4
    ):
        sport, dport = struct.unpack_from(">HH", frame, ip0 + ihl)
    return src, dst, proto, sport, dport


class VethSniffer:
    """Collects IPv4 5-tuples from one interface (the endpoint's
    host-side veth) on a background thread."""

    def __init__(self, ifname: str) -> None:
        self.ifname = ifname
        self._sock = socket.socket(
            socket.AF_PACKET, socket.SOCK_RAW, socket.htons(ETH_P_ALL)
        )
        self._sock.bind((ifname, 0))
        self._sock.settimeout(0.2)
        self._lock = threading.Lock()
        self._flows: List[Tuple[int, int, int, int, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "VethSniffer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                frame = self._sock.recv(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            parsed = parse_ipv4_frame(frame)
            if parsed is not None:
                with self._lock:
                    self._flows.append(parsed)

    def drain(self) -> List[Tuple[int, int, int, int, int]]:
        with self._lock:
            out = self._flows
            self._flows = []
        return out

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass


class WireEnforcer:
    """Batches sniffed flows into pipeline verdicts.

    ``dst_endpoints`` maps destination IPv4 (dotted) → local endpoint
    id: a captured packet TO one of those addresses is an ingress flow
    for that endpoint (the tail_ipv4_policy position); everything else
    is ignored. Verdict counters accumulate per endpoint id."""

    def __init__(self, pipeline, dst_endpoints: Dict[str, int]) -> None:
        import ipaddress

        self.pipeline = pipeline
        self._dst_map = {
            int(ipaddress.IPv4Address(ip)): ep_id
            for ip, ep_id in dst_endpoints.items()
        }
        self.verdicts: Dict[int, Dict[int, int]] = {}  # ep → verdict → n

    def process_flows(
        self, flows: List[Tuple[int, int, int, int, int]]
    ) -> int:
        """Verdict one drained batch → number of flows enforced."""
        picked = []
        for src, dst, proto, sport, dport in flows:
            ep_id = self._dst_map.get(dst)
            if ep_id is None:
                continue
            idx = self.pipeline.endpoint_index(ep_id)
            if idx is None:
                continue  # endpoint gone/not synced: never verdict a
                # flow against whatever occupies another index
            picked.append((src, ep_id, idx, dport, proto, sport))
        if not picked:
            return 0
        src_ips = np.asarray([p[0] for p in picked], np.uint32)
        ep_ids = [p[1] for p in picked]
        ep_idx = np.asarray([p[2] for p in picked], np.int32)
        dports = np.asarray([p[3] for p in picked], np.int32)
        protos = np.asarray([p[4] for p in picked], np.int32)
        sports = np.asarray([p[5] for p in picked], np.int32)
        v, _red = self.pipeline.process(
            src_ips, ep_idx, dports, protos, ingress=True, sports=sports
        )
        for ep_id, verdict in zip(ep_ids, v):
            self.verdicts.setdefault(ep_id, {})
            self.verdicts[ep_id][int(verdict)] = (
                self.verdicts[ep_id].get(int(verdict), 0) + 1
            )
        return len(picked)

    def run_from(
        self, sniffers: List[VethSniffer], duration: float,
        poll_s: float = 0.1,
    ) -> int:
        """Drain+verdict loop for ``duration`` seconds → flows enforced."""
        total = 0
        deadline = time.monotonic() + duration
        while time.monotonic() < deadline:
            batch: List[Tuple[int, int, int, int, int]] = []
            for s in sniffers:
                batch.extend(s.drain())
            if batch:
                total += self.process_flows(batch)
            else:
                time.sleep(poll_s)
        return total
