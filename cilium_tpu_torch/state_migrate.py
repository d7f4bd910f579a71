"""State-snapshot schema migration.

Reference: bpf/cilium-map-migrate.c — when an upgrade changes the
pinned-map format, a standalone migrator converts the persisted state
so traffic keeps flowing across agent upgrades. Here the persisted
state is the daemon's state.json; every schema change lands as one
entry in MIGRATIONS and restore runs the chain from whatever version
it finds to SCHEMA_VERSION. Usable standalone:

    python -m cilium_tpu_torch.state_migrate /var/run/ctpu/state.json
"""

from __future__ import annotations

import json
from typing import Callable, Dict

SCHEMA_VERSION = 3


def _v1_to_v2(snap: Dict) -> Dict:
    """v1 (unversioned, pre-services): add the services list and tag
    legacy generated CIDR entries with their owning translator (the
    generatedBy ownership model; untagged generated entries are
    service-owned by the compatibility rule in k8s/rule_translate)."""
    snap.setdefault("services", [])
    for rule in snap.get("rules", []):
        for direction in ("ingress", "egress"):
            for r in rule.get(direction, []) or []:
                for cs_field in ("fromCIDRSet", "toCIDRSet"):
                    for c in r.get(cs_field, []) or []:
                        if c.get("generated") and not c.get("generatedBy"):
                            c["generatedBy"] = "service"
    return snap


def _v2_to_v3(snap: Dict) -> Dict:
    """v2 → v3 (policyd-survive): add the conntrack-snapshot stanza.
    v3 state.json records where the CT snapshot lives and the policy
    basis it was saved against; a v2 file predates CT persistence, so
    the stanza restores empty — a cold (flushed) conntrack, exactly
    what a v2 daemon restart produced."""
    snap.setdefault("ct", {"snapshot": None, "basis": None})
    return snap


MIGRATIONS: Dict[int, Callable[[Dict], Dict]] = {
    1: _v1_to_v2,
    2: _v2_to_v3,
}


def migrate(snap: Dict) -> Dict:
    """Run the migration chain up to SCHEMA_VERSION (idempotent)."""
    version = int(snap.get("schema", 1))
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"snapshot schema {version} is newer than this build "
            f"({SCHEMA_VERSION}) — refusing to downgrade"
        )
    while version < SCHEMA_VERSION:
        fn = MIGRATIONS.get(version)
        if fn is None:
            raise ValueError(f"no migration from schema {version}")
        snap = fn(snap)
        version += 1
        snap["schema"] = version
    return snap


def migrate_file(path: str) -> int:
    """Migrate a state file in place; returns the resulting schema."""
    with open(path) as f:
        snap = json.load(f)
    before = int(snap.get("schema", 1))
    snap = migrate(snap)
    if snap["schema"] != before:
        tmp = path + ".migrate.tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1)
        import os

        os.replace(tmp, path)
    return snap["schema"]


def main(argv=None) -> int:
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        print("usage: python -m cilium_tpu_torch.state_migrate <state.json>",
              file=sys.stderr)
        return 2
    schema = migrate_file(args[0])
    print(f"{args[0]}: schema {schema}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
