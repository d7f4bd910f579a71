"""Shared kvstore path constants + the identity key codec.

Kept dependency-free so kvstore modules and identity/ipcache sync
layers can share them without import cycles. Path layout mirrors the
reference's stable kvstore schema (pkg/kvstore/allocator, pkg/node/
store.go NodeStorePrefix, pkg/ipcache/kvstore.go IPIdentitiesPath).
"""

IDENTITIES_PATH = "cilium/state/identities/v1"
NODES_PATH = "cilium/state/nodes/v1"
IP_IDENTITIES_PATH = "cilium/state/ip/v1"
# policyd-fed: per-node descriptor + policy_epoch records (the
# federation epoch exchange; federation/epochs.py)
CLUSTER_EPOCHS_PATH = "cilium/state/epochs/v1"
# policyd-fleetobs: per-node telemetry frames, published beside the
# epoch records (observe/fleet.py TelemetryExchange)
CLUSTER_TELEMETRY_PATH = "cilium/state/telemetry/v1"
# policyd-journal: per-node lifecycle-journal tail frames
# (observe/journal.py JournalExchange)
CLUSTER_JOURNAL_PATH = "cilium/state/journal/v1"


def key_to_label_strings(key: str):
    """Allocator key (LabelArray.sorted_key: ';'-joined labels) →
    label strings."""
    return [t for t in key.split(";") if t]
