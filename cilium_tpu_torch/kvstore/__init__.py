"""Distributed-state fabric: kvstore backend, CAS allocator, shared
store, clustermesh (reference: pkg/kvstore + pkg/kvstore/allocator +
pkg/kvstore/store + pkg/clustermesh)."""

from .backend import (
    BackendOperations,
    EventTypeCreate,
    EventTypeDelete,
    EventTypeListDone,
    EventTypeModify,
    InMemoryBackend,
    InMemoryStore,
    KVEvent,
    KVLock,
    LockTimeout,
    Watcher,
)
from .allocator import Allocator, AllocatorError
from .clustermesh import ClusterMesh, RemoteCluster
from .filestore import FileBackend, FlakyBackend
from .netstore import KVStoreServer, NetBackend, backend_from_target
from .store import SharedStore

__all__ = [
    "Allocator",
    "AllocatorError",
    "BackendOperations",
    "ClusterMesh",
    "EventTypeCreate",
    "EventTypeDelete",
    "EventTypeListDone",
    "EventTypeModify",
    "FileBackend",
    "FlakyBackend",
    "InMemoryBackend",
    "InMemoryStore",
    "KVEvent",
    "KVLock",
    "KVStoreServer",
    "LockTimeout",
    "NetBackend",
    "backend_from_target",
    "RemoteCluster",
    "SharedStore",
    "Watcher",
]
