"""ip→identity kvstore synchronization.

Re-design of pkg/ipcache/kvstore.go: each node
announces its endpoints' {IP → identity, hostIP} under
``cilium/state/ip/v1/<cluster>/…`` (lease-bound), and every node's
IPIdentityWatcher merges the global view into its local IPCache with
source=kvstore — which in this framework triggers the identity-LPM
trie rebuild in the datapath pipeline (ipcache listeners → version
bump → DatapathPipeline.rebuild).
"""

from __future__ import annotations

import json
from typing import Optional

from ..kvstore.backend import (
    BackendOperations,
    EventTypeDelete,
    EventTypeListDone,
    Watcher,
)
from .ipcache import IPCache, SOURCE_KVSTORE

from ..kvstore.paths import IP_IDENTITIES_PATH


class IPIdentitySync:
    """One node's announce + watch loop on the ip→identity prefix."""

    def __init__(
        self,
        backend: BackendOperations,
        ipcache: IPCache,
        *,
        cluster: str = "default",
        base_path: str = IP_IDENTITIES_PATH,
    ) -> None:
        self.backend = backend
        self.ipcache = ipcache
        self.prefix = f"{base_path}/{cluster}/"
        self._watcher: Watcher = backend.list_and_watch(
            f"ipcache-{cluster}", self.prefix
        )
        # cidr → payload of every local announcement, for lease-loss
        # resync (the periodic kvstore sync of ipcache/kvstore.go)
        self._announced: dict = {}
        self.pump()

    # ------------------------------------------------------------------
    def _key(self, cidr: str) -> str:
        return self.prefix + cidr

    def announce(
        self, cidr: str, identity: int, host_ip: Optional[str] = None
    ) -> None:
        """Publish a local ip→identity mapping (lease-bound: dies with
        this node, the upsertToKVStore path of ipcache/kvstore.go)."""
        cidr = self.ipcache._norm(cidr)
        payload = {"ip": cidr, "identity": identity}
        if host_ip is not None:
            payload["host_ip"] = host_ip
        self.backend.update(
            self._key(cidr), json.dumps(payload, sort_keys=True).encode(), lease=True
        )
        self._announced[cidr] = payload

    def withdraw_all(self) -> int:
        """Withdraw every announcement this node made (cluster leave —
        relying on lease expiry would leave peers routing to the
        departed node for a full TTL)."""
        cidrs = list(self._announced)
        for cidr in cidrs:
            self.withdraw(cidr)
        return len(cidrs)

    def withdraw(self, cidr: str) -> None:
        cidr = self.ipcache._norm(cidr)
        self.backend.delete(self._key(cidr))
        self._announced.pop(cidr, None)

    def resync(self) -> int:
        """Re-publish every local announcement (anti-entropy after a
        lease loss wiped our lease-bound keys). Returns keys written."""
        for cidr, payload in self._announced.items():
            self.backend.update(
                self._key(cidr), json.dumps(payload, sort_keys=True).encode(),
                lease=True,
            )
        return len(self._announced)

    def pump(self) -> int:
        """Merge pending watch events into the local IPCache
        (InitIPIdentityWatcher loop). Returns events applied."""
        n = 0
        for ev in self._watcher.drain():
            n += 1
            if ev.typ == EventTypeListDone:
                continue
            cidr = ev.key[len(self.prefix):]
            if ev.typ == EventTypeDelete:
                self.ipcache.delete(cidr, SOURCE_KVSTORE)
            else:
                try:
                    payload = json.loads((ev.value or b"{}").decode())
                except ValueError:
                    continue
                self.ipcache.upsert(
                    cidr,
                    int(payload.get("identity", 0)),
                    source=SOURCE_KVSTORE,
                    host_ip=payload.get("host_ip"),
                )
        return n

    def close(self) -> None:
        self.backend.stop_watcher(self._watcher)
