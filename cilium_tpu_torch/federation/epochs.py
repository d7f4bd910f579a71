"""Node registry + policy-epoch exchange over the kvstore watch fabric.

# policyd: hot

Every federated node publishes one lease-bound record — its node
descriptor plus its current ``policy_epoch`` (the EpochSwap counter a
full rebuild bumps when the shadow generation swaps in) — under
``CLUSTER_EPOCHS_PATH`` and watches every peer's record through a
:class:`SharedStore` (pkg/kvstore/store role, as the node registry
does for connectivity).

The *cluster epoch* is the convergence floor: the minimum published
``policy_epoch`` across every known node. A rule pushed at one node is
provably enforced fleet-wide once the cluster epoch reaches the epoch
of the rebuild that installed it — that is exactly what the
``wait_cluster_epoch`` barrier polls for (bounded, ROBUST002: every
wait in here carries a timeout).

Failure modes: a dead node's record dies with its lease, so it stops
holding the floor down; a partitioned node keeps serving its LAST
converged tables (the exchange is an observability/barrier plane, not
an enforcement gate) and its staleness is visible to every peer as a
rising ``cluster_epoch_lag``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .. import metrics as _metrics
from ..kvstore.backend import BackendOperations
from ..kvstore.paths import CLUSTER_EPOCHS_PATH
from ..kvstore.store import SharedStore


class EpochExchange:
    """One node's view of the fleet's policy epochs."""

    def __init__(
        self,
        backend: BackendOperations,
        node_name: str,
        *,
        cluster: str = "default",
        descriptor: Optional[dict] = None,
        epoch_source: Optional[Callable[[], int]] = None,
        base_path: str = CLUSTER_EPOCHS_PATH,
    ) -> None:
        self.node_name = node_name
        self.cluster = cluster
        self.key_name = f"{cluster}/{node_name}"
        self._descriptor = dict(descriptor or {})
        self._epoch_source = epoch_source or (lambda: 0)
        self._last_published: Optional[int] = None
        self._seq = 0
        self.store = SharedStore(backend, base_path)

    # ------------------------------------------------------------------
    def local_epoch(self) -> int:
        return int(self._epoch_source())

    def publish(self, epoch: Optional[int] = None, *, force: bool = False) -> bool:
        """Publish (descriptor, policy_epoch) when the epoch moved (or
        ``force`` — anti-entropy resync after a lease loss). True when
        a write happened."""
        e = self.local_epoch() if epoch is None else int(epoch)
        if not force and e == self._last_published:
            return False
        self._seq += 1
        rec = dict(self._descriptor)
        rec.update(
            {
                "node": self.node_name,
                "cluster": self.cluster,
                "policy_epoch": e,
                "seq": self._seq,
            }
        )
        self.store.update_local_key_sync(self.key_name, rec)
        self._last_published = e
        return True

    def pump(self) -> int:
        """Apply pending peer events; refresh the cluster gauges."""
        n = self.store.pump()
        view = self.view()
        _metrics.cluster_nodes.set(float(len(view)))
        _metrics.cluster_epoch_lag.set(float(self.epoch_lag(view)))
        return n

    # -- fleet view ------------------------------------------------------
    def view(self) -> Dict[str, dict]:
        """name → published record for every node of this cluster
        (including self once the watch round-tripped)."""
        return {
            name: rec
            for name, rec in dict(self.store.shared).items()
            if rec.get("cluster") == self.cluster
        }

    def cluster_epoch(self, view: Optional[Dict[str, dict]] = None) -> int:
        """The convergence floor: min published policy_epoch across
        every known node (self included — an unpublished local bump
        cannot claim fleet convergence)."""
        v = self.view() if view is None else view
        epochs = [int(r.get("policy_epoch", 0)) for r in v.values()]
        local = self.local_epoch()
        if not epochs:
            return local
        return min(epochs + [local])

    def epoch_lag(self, view: Optional[Dict[str, dict]] = None) -> int:
        return max(0, self.local_epoch() - self.cluster_epoch(view))

    # -- the barrier -----------------------------------------------------
    def wait_cluster_epoch(
        self,
        epoch: Optional[int] = None,
        timeout: float = 10.0,
        *,
        poll: float = 0.02,
        min_nodes: int = 1,
        pump: Optional[Callable[[], object]] = None,
    ) -> bool:
        """Convergence barrier: True once at least ``min_nodes`` nodes
        are publishing and EVERY one of them reports ``policy_epoch >=
        epoch`` (default: this node's current local epoch). Bounded
        poll — returns False at the deadline; a caller-supplied
        ``pump`` runs each round (in-process multi-node tests drive
        their peers' controllers through it)."""
        target = self.local_epoch() if epoch is None else int(epoch)
        deadline = time.monotonic() + timeout
        while True:
            self.publish()
            if pump is not None:
                pump()
            self.pump()
            view = self.view()
            if len(view) >= min_nodes and all(
                int(r.get("policy_epoch", 0)) >= target for r in view.values()
            ):
                return True
            now = time.monotonic()
            if now >= deadline:
                return False
            time.sleep(min(poll, deadline - now))

    # ------------------------------------------------------------------
    def sync(self) -> int:
        """Anti-entropy: re-write our lease-bound record (heartbeat
        path; self-heals a lease loss)."""
        return self.store.sync_local_keys()

    def close(self) -> None:
        try:
            self.store.delete_local_key(self.key_name)
        except (ConnectionError, TimeoutError, OSError, RuntimeError):
            pass  # backend gone; the lease reaps our record
        self.store.close()
