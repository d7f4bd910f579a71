"""Distributed identity allocation: kvstore CAS + local registry sync.

The reference's AllocateIdentity (pkg/identity/allocator.go:122) allocates the {labels → small integer} binding
through the kvstore allocator so every node in the cluster numbers
identities identically; the local cache follows the kvstore watch.

Here the same contract feeds the card: identity numbers pick device
tensor rows, so cluster-wide agreement on numbering is what lets every
node's compiled policy tensors stay row-compatible. The flow is:

    allocate(labels)
      └ kvstore CAS (Allocator.allocate on the sorted-label key)
          └ registry.insert_global(num, labels)     # local row assign
              └ engine observer → device row patch  # (engine.py)

and remote allocations arrive as watch events through :meth:`pump`,
inserting remote identities into the registry so their rows exist
before any flow from that node shows up.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..kvstore.allocator import Allocator
from ..kvstore.backend import BackendOperations
from ..labels import LabelArray, parse_label_array
from .model import Identity, MAX_USER_IDENTITY, MIN_USER_IDENTITY
from .registry import IdentityRegistry

from ..kvstore.paths import IDENTITIES_PATH, key_to_label_strings


def labels_to_key(labels: LabelArray) -> str:
    """Canonical allocator key for a label set (the globalIdentity key
    of allocator.go:31 — sorted label serialization)."""
    return labels.sorted_key()


def key_to_labels(key: str) -> LabelArray:
    return parse_label_array(key_to_label_strings(key))


class DistributedIdentityAllocator:
    """Cluster-wide identity allocation for one node.

    Wraps a kvstore :class:`Allocator` on the identities path and keeps
    the node's :class:`IdentityRegistry` in sync both ways:

    - local ``allocate``/``release`` go through kvstore CAS, then the
      registry;
    - remote create/delete events land via :meth:`pump` (controller-
      driven), inserting/releasing the corresponding registry entries.
    """

    def __init__(
        self,
        backend: BackendOperations,
        registry: IdentityRegistry,
        node_name: str,
        *,
        base_path: str = IDENTITIES_PATH,
    ) -> None:
        self.registry = registry
        self.node_name = node_name
        self._lock = threading.RLock()
        # ids this node inserted into the registry on behalf of REMOTE
        # allocations (so remote deletes release exactly one ref)
        self._remote_held: Dict[int, str] = {}
        self.alloc = Allocator(
            backend,
            base_path,
            suffix=node_name,
            min_id=MIN_USER_IDENTITY,
            max_id=MAX_USER_IDENTITY,
            on_event=self._on_allocator_event,
        )
        self.pump()

    # ------------------------------------------------------------------
    def _on_allocator_event(self, op: str, id_: int, key: Optional[str]) -> None:
        if op == "upsert":
            assert key is not None
            with self._lock:
                if id_ in self._remote_held:
                    return  # already mirrored
                # Local allocations insert via allocate(); only mirror
                # ids we don't already hold locally.
                if self.registry.get(id_) is not None:
                    return
                try:
                    self.registry.insert_global(id_, key_to_labels(key))
                except ValueError:
                    # Conflicting binding (e.g. the labels were bound
                    # locally outside the kvstore path): skip — the
                    # reference logs-and-skips invalid remote entries
                    # (allocator cache.go invalidKey); crashing the
                    # watch pump would be strictly worse.
                    return
                self._remote_held[id_] = key
        elif op == "delete":
            with self._lock:
                if id_ in self._remote_held:
                    del self._remote_held[id_]
                    self.registry.release_by_id(id_)

    def pump(self) -> int:
        """Apply pending kvstore watch events (remote allocations /
        releases) into the registry. Returns events applied."""
        return self.alloc.pump()

    # ------------------------------------------------------------------
    def allocate(self, labels: LabelArray) -> Identity:
        """Cluster-consistent AllocateIdentity (allocator.go:122)."""
        key = labels_to_key(labels)
        num, _is_new = self.alloc.allocate(key)
        with self._lock:
            # The local use takes its OWN registry reference; a remote
            # mirror (if the watch event landed first) keeps its ref and
            # is released only by the master-key delete event — the two
            # holds are independent, so neither release can strand the
            # other.
            return self.registry.insert_global(num, labels)

    def release(self, ident: Identity) -> bool:
        """Release the local use; slave-key removal lets GC reap the
        number once no node uses it."""
        self.alloc.release(labels_to_key(ident.labels))
        freed = self.registry.release(ident)
        if freed:
            # The identity may still be live cluster-wide (other nodes'
            # slave keys keep the master key alive). Re-mirror it as a
            # remote hold so local policy rows keep covering it until
            # the master-key delete event arrives.
            key = labels_to_key(ident.labels)
            with self._lock:
                if (
                    ident.id not in self._remote_held
                    and self.alloc.backend.get(
                        self.alloc._master_key(ident.id)
                    ) is not None
                ):
                    try:
                        self.registry.insert_global(ident.id, ident.labels)
                        self._remote_held[ident.id] = key
                        freed = False
                    except ValueError:
                        pass
        return freed

    def run_gc(self):
        return self.alloc.run_gc()

    def resync(self) -> int:
        """Lease-loss recovery: re-create our slave/master keys
        (allocator.go localKeySync + recreateMasterKey)."""
        return self.alloc.resync_local_keys()

    def close(self) -> None:
        self.alloc.close()
