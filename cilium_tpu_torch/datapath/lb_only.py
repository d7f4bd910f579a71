"""Standalone LB datapath mode.

Reference: bpf/bpf_lb.c — a datapath program that ONLY
load-balances (VIP→backend translate + forward, DSR-style), attached
on nodes acting as dedicated load balancers with no policy
enforcement. Same stance here: a pipeline that owns service tables and
a conntrack for flow affinity + revNAT, with no policy engine in the
loop — batches translate on device (lb/device.py lb_translate, the
``lb_translate`` kernel on a CUDA device) and non-service traffic
passes through untouched (bpf_lb.c forwards unmatched traffic).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..lb.device import flow_hash32, lb_translate
from ..ops.lpm import ipv4_to_bytes
from .conntrack import CT_REPLY, FlowConntrack, pack_keys

FORWARD = 1
DROP_NO_SERVICE = 4


class LBOnlyDatapath:
    """VIP→backend translation with per-flow affinity, no policy."""

    def __init__(self, manager, conntrack: Optional[FlowConntrack] = None, device=None):
        self.device = _kernels.resolve_device(device)
        self.lb = manager
        self.conntrack = conntrack
        self._lock = threading.Lock()
        self._tables: Dict[int, object] = {}
        self._version = -1

    def _refresh(self) -> None:
        with self._lock:
            if self.lb.version != self._version:
                self._tables = self.lb.build_device(device=self.device)
                self._version = self.lb.version
                if self.conntrack is not None:
                    # translated CT keys change with the tables
                    self.conntrack.flush()

    def process(
        self,
        dst_ips: np.ndarray,  # [B] uint32 destination addresses
        dports: np.ndarray,
        protos: np.ndarray,
        sports: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """→ (new_dst [B] uint32, new_port [B] int32, verdict [B] int8,
        revnat [B] uint16). Frontend hit with zero backends drops
        (lb4_local slave-lookup failure → DROP_NO_SERVICE); unmatched
        traffic forwards untranslated."""
        self._refresh()
        dst = np.asarray(dst_ips, np.uint32)
        dports = np.asarray(dports, np.int32)
        protos = np.asarray(protos, np.int32)
        b = dst.shape[0]
        t = self._tables.get(4)
        if t is None:
            return dst, dports, np.full(b, FORWARD, np.int8), np.zeros(b, np.uint16)
        peer_bytes = ipv4_to_bytes(dst)
        fh = flow_hash32(
            peer_bytes, sports, dports, protos, np.zeros(b, np.int64)
        )
        nb, npo, rv, ok, nobk = (
            x.cpu().numpy() for x in lb_translate(
                t, *(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
                     for a in (peer_bytes, dports, protos, fh)),
            )
        )
        nb = nb.astype(np.uint32)
        new_dst = (
            (nb[:, 0] << 24) | (nb[:, 1] << 16) | (nb[:, 2] << 8) | nb[:, 3]
        )
        new_port = npo.astype(np.int32)
        revnat = rv.astype(np.uint16)
        verdict = np.where(nobk, np.int8(DROP_NO_SERVICE), np.int8(FORWARD))
        revnat = np.where(ok, revnat, 0).astype(np.uint16)

        if self.conntrack is not None and sports is not None:
            # record forward entries for SERVICE-TRANSLATED flows only
            # (affinity + revNAT restore). Pass-through traffic is not
            # tracked — on a dedicated LB node it dwarfs the service
            # flows and would evict/fill the table, starving revNAT
            # entries (bpf_lb.c tracks only service flows too).
            translated = ok
            if translated.any():
                sp = np.asarray(sports, np.int64)
                ka, kb, kc = pack_keys(
                    np.zeros(b, np.uint64), new_dst.astype(np.uint64),
                    np.zeros(b, np.uint64), sp.astype(np.uint64),
                    new_port.astype(np.uint64), protos.astype(np.uint64),
                    np.ones(b, np.uint64),
                )
                self.conntrack.create_batch(
                    ka[translated], kb[translated], kc[translated],
                    revnat=revnat[translated],
                )
        return new_dst, new_port, verdict, revnat

    def rev_nat(
        self,
        src_ips: np.ndarray,  # [B] uint32 reply SOURCE (backend) addrs
        sports: np.ndarray,  # [B] backend ports
        dports: np.ndarray,  # [B] client ports
        protos: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Reply-direction revNAT: restore the VIP on reply sources
        whose CT entry carries a revNAT id (lb4_rev_nat) →
        (new_src [B] uint32, new_sport [B] int32)."""
        src = np.asarray(src_ips, np.uint32)
        sports = np.asarray(sports, np.int64)
        dports = np.asarray(dports, np.int64)
        protos = np.asarray(protos, np.int64)
        b = src.shape[0]
        new_src = src.copy()
        new_sport = sports.astype(np.int32).copy()
        if self.conntrack is None:
            return new_src, new_sport
        # the reply packet's own tuple: sport = backend port, dport =
        # client port, ingress; lookup_batch's flip matches it against
        # the stored forward (egress) entry
        ka, kb, kc = pack_keys(
            np.zeros(b, np.uint64), src.astype(np.uint64),
            np.zeros(b, np.uint64), sports.astype(np.uint64),
            dports.astype(np.uint64), protos.astype(np.uint64),
            np.zeros(b, np.uint64),
        )
        state, _slot, rev = self.conntrack.lookup_batch(
            ka, kb, kc, refresh=False, want_revnat=True
        )
        rev[state != CT_REPLY] = 0
        for i in np.nonzero(rev)[0]:
            fe = self.lb.rev_nat(int(rev[i]))
            if fe is not None and ":" not in fe.ip:
                parts = [int(x) for x in fe.ip.split(".")]
                new_src[i] = (
                    (parts[0] << 24) | (parts[1] << 16)
                    | (parts[2] << 8) | parts[3]
                )
                new_sport[i] = fe.port
        return new_src, new_sport
