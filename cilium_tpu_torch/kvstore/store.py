"""SharedStore: a replicated key set over the kvstore watch fabric.

Re-design of pkg/kvstore/store/store.go: every node
contributes lease-bound local keys under a common prefix and observes
every other node's keys via ListAndWatch. Used for the node registry
(pkg/node/store.go:60) and health state; here also the carrier for
ip→identity announcements.

Local keys are written with ``update_local_key_sync`` and re-written by
``sync_local_keys`` (the periodic anti-entropy sync of the reference's
SynchronizationInterval) so a lease loss self-heals on the next sync.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional

from .backend import (
    BackendOperations,
    EventTypeDelete,
    EventTypeListDone,
    Watcher,
)
from .. import faults as _faults


class SharedStore:
    """One node's view of a replicated key set.

    Keys are (name → dict) pairs; values travel as JSON. Observers fire
    on remote create/modify/delete after :meth:`pump` applies pending
    watch events (deterministic, controller-driven delivery).
    """

    def __init__(
        self,
        backend: BackendOperations,
        prefix: str,
        *,
        on_update: Optional[Callable[[str, dict], None]] = None,
        on_delete: Optional[Callable[[str, Optional[dict]], None]] = None,
    ) -> None:
        self.backend = backend
        self.prefix = prefix.rstrip("/") + "/"
        self._lock = threading.RLock()
        self._local: Dict[str, dict] = {}
        self.shared: Dict[str, dict] = {}  # full replicated view incl. local
        self._on_update = on_update
        self._on_delete = on_delete
        self._watcher: Watcher = backend.list_and_watch(
            f"store-{prefix}", self.prefix
        )
        self.synced = False
        self.pump()

    # ------------------------------------------------------------------
    def _key_path(self, name: str) -> str:
        return self.prefix + name

    def pump(self) -> int:
        """Apply pending watch events to the shared view; fires
        observers. Returns events applied."""
        if _faults.hub.active:
            try:
                _faults.hub.check(_faults.SITE_KVSTORE)
            except _faults.FaultError as e:
                if e.kind == _faults.KIND_POISONED:
                    raise
                # transient partition: events stay queued in the
                # watcher and apply on the next pump — the replicated
                # view is eventually consistent by design
                return 0
        n = 0
        for ev in self._watcher.drain():
            n += 1
            if ev.typ == EventTypeListDone:
                self.synced = True
                continue
            name = ev.key[len(self.prefix):]
            if ev.typ == EventTypeDelete:
                with self._lock:
                    old = self.shared.pop(name, None)
                if self._on_delete:
                    self._on_delete(name, old)
            else:
                try:
                    value = json.loads((ev.value or b"{}").decode())
                except ValueError:
                    continue
                with self._lock:
                    self.shared[name] = value
                if self._on_update:
                    self._on_update(name, value)
        return n

    # -- local keys -----------------------------------------------------
    def update_local_key_sync(self, name: str, value: dict) -> None:
        """Write (and remember) a local key; lease-bound so it dies with
        this node (store.go UpdateLocalKeySync)."""
        with self._lock:
            self._local[name] = value
        self.backend.update(
            self._key_path(name), json.dumps(value, sort_keys=True).encode(),
            lease=True,
        )

    def delete_local_key(self, name: str) -> None:
        with self._lock:
            self._local.pop(name, None)
        self.backend.delete(self._key_path(name))

    def sync_local_keys(self) -> int:
        """Anti-entropy: re-write every local key (periodic sync role).
        Returns the number of keys written."""
        with self._lock:
            items = list(self._local.items())
        for name, value in items:
            self.backend.update(
                self._key_path(name), json.dumps(value, sort_keys=True).encode(),
                lease=True,
            )
        return len(items)

    def local_keys(self) -> List[str]:
        with self._lock:
            return list(self._local)

    def close(self) -> None:
        self.backend.stop_watcher(self._watcher)
