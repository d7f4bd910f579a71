"""Conntrack snapshot — the pinned-CT-map persistence analog.

Reference: the kernel datapath's conntrack maps are PINNED — they keep
admitting established flows while the agent restarts, and
bpf/cilium-map-migrate.c carries them across upgrades. Our host
`FlowConntrack` dies with the process, so the equivalent is a disk
snapshot beside the compiled-policy snapshot: packed key/meta arrays
with REMAINING lifetimes (the table's own clock is monotonic and does
not survive a process), stamped with the policy basis the entries were
verdicted under.

The basis stamp is what keeps established-bypass-survives-revoke
correct across a restart that raced a rule change: the restore path
(daemon.restore_state) KEEPS the entries only when the restored
compiled snapshot carries the same (revision, identity_version,
vocab_version) — otherwise the entries may bypass rules that no longer
allow them, so the table restores cold (flush), exactly what the
transactional CT flush would have done in-process.

Write path: atomic tmp + fsync + rename like every other state file,
with one injectable fault site (``SITE_STATE_WRITE``). An injected
fault there models the failure the atomic idiom cannot fully rule out
— power loss where the rename persisted but the data blocks did not —
by leaving a TORN file at the final path; the tolerant loader then
classifies it and the caller falls back to a cold flush, never a crash.

Only the host table is snapshotted, as in the JAX package: the device
conntrack (``device_ct_bits``) has no snapshot and starts empty after a
restart. Within a process, a held rebuild keeps it (the pipeline's
``_ct_restore_hold``).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

from .. import faults as _faults
from .conntrack import FlowConntrack

CT_SNAPSHOT_SCHEMA = 1

# Bounded restore: a snapshot larger than this is somebody else's file
# (or corruption that survived the zip CRC) — cap what one boot will
# re-place rather than stalling first-verdict behind a giant insert.
MAX_RESTORE_ENTRIES = 1 << 20


def save_ct_state(
    path: str,
    ct: FlowConntrack,
    *,
    basis: Tuple[int, int, int],
    ct_epoch: int,
) -> int:
    """Atomically write the CT snapshot; → payload size in bytes.

    ``basis`` is the compiled-policy basis (revision, identity_version,
    vocab_version) the live entries were verdicted under; ``ct_epoch``
    is the pipeline's flush-epoch counter at save time. Both ride in
    the meta blob for the restore-side keep-vs-flush decision and for
    bugtool provenance."""
    arrays = ct.snapshot_arrays()
    meta = {
        "schema": CT_SNAPSHOT_SCHEMA,
        "basis": [int(b) for b in basis],
        "ct_epoch": int(ct_epoch),
        "entries": int(len(arrays["ka"])),
        "saved_at": time.time(),
    }
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), np.uint8
    ).copy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()

    if _faults.hub.active:
        try:
            _faults.hub.check(_faults.SITE_STATE_WRITE)
        except _faults.FaultError:
            # Torn-write injection: leave a truncated file at the FINAL
            # path (the post-rename-pre-data power-loss shape the
            # tmp+rename idiom cannot prevent) so chaos rounds exercise
            # the loader's tolerance, then surface the fault.
            with open(path, "wb") as f:
                f.write(payload[: max(1, len(payload) // 2)])
            raise

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ct.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(payload)


def load_ct_state(path: str) -> Optional[dict]:
    """→ {ka, kb, kc, ttl, packets, revnat, basis, ct_epoch, entries,
    saved_at} or None when the file is absent, truncated, torn, corrupt,
    or from another schema — a bad CT snapshot must degrade to a cold
    flush, never to a crash (same contract as load_compiled_state)."""
    import zipfile

    _bad = (OSError, ValueError, KeyError, zipfile.BadZipFile)
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("schema") != CT_SNAPSHOT_SCHEMA:
                return None
            n = min(int(meta["entries"]), MAX_RESTORE_ENTRIES)
            out = {
                k: z[k][:n].copy()
                for k in ("ka", "kb", "kc", "ttl", "packets", "revnat")
            }
            out["basis"] = tuple(int(b) for b in meta["basis"])
            out["ct_epoch"] = int(meta["ct_epoch"])
            out["entries"] = int(meta["entries"])
            out["saved_at"] = float(meta.get("saved_at", 0.0))
            return out
    except _bad:
        return None
