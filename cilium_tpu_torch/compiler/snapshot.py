"""Compiled-policy + policymap snapshots — the pinned-map persistence
analog.

Reference: the kernel datapath keeps enforcing out of PINNED BPF maps
while the agent restarts (daemon/state.go:53,135 restores endpoints
against maps that never stopped serving). Our device tables die with
the process, so the equivalent is a disk snapshot of the COMPILED
state: the policy compiler's output arrays plus the materialized
policymaps. A restarting daemon re-loads and re-uploads these in
seconds — enforcement is live on last-known-good state long before the
O(identities × rules) recompile would finish; the normal refresh path
then re-derives when (and only when) the inputs actually move.

Format: one ``.npz`` holding every array field (discovered via
dataclass introspection — the schema follows the dataclasses) plus a
JSON metadata entry for scalars and the id→row map. The format is the
JAX package's, array for array and key for key: a file either package
writes loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .program import CompiledPolicy, DirectionProgram

SNAPSHOT_SCHEMA = 1


def _array_fields(obj) -> Dict[str, np.ndarray]:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
    return out


def _host(col: torch.Tensor, dtype) -> np.ndarray:
    """A policymap column tensor as a host array of the file's dtype:
    the port's columns live on the card, where ``np.asarray`` cannot
    read them."""
    return col.cpu().numpy().astype(dtype, copy=False)


def save_compiled_state(
    path: str,
    compiled: CompiledPolicy,
    sel_match_host: np.ndarray,
    mats: Optional[Dict[int, object]] = None,  # direction → MaterializedState
) -> None:
    """Atomically write the snapshot (tmp + rename, like every other
    state file in this repo)."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, object] = {
        "schema": SNAPSHOT_SCHEMA,
        "revision": compiled.revision,
        "identity_version": compiled.identity_version,
        "vocab_version": compiled.vocab_version,
        "num_words": compiled.num_words,
        "num_selectors": compiled.num_selectors,
        "ing_s_pad": compiled.ingress.s_pad,
        "eg_s_pad": compiled.egress.s_pad,
    }
    for k, v in _array_fields(compiled).items():
        arrays[f"cp.{k}"] = v
    for prefix, d in (("ing", compiled.ingress), ("eg", compiled.egress)):
        for k, v in _array_fields(d).items():
            arrays[f"{prefix}.{k}"] = v
    ids = np.fromiter(compiled.id_to_row.keys(), np.int64,
                      len(compiled.id_to_row))
    rows = np.fromiter(compiled.id_to_row.values(), np.int64,
                       len(compiled.id_to_row))
    arrays["map.ids"] = ids
    arrays["map.rows"] = rows
    arrays["sel_match"] = sel_match_host

    mat_meta = {}
    for direction, st in (mats or {}).items():
        p = f"mat{direction}"
        arrays[f"{p}.allow_nc"] = st.allow_nc
        arrays[f"{p}.red_nc"] = st.red_nc
        arrays[f"{p}.ep_rows"] = st.ep_rows
        t = st.tables
        arrays[f"{p}.col_ep"] = _host(t.col_ep, np.int32)
        arrays[f"{p}.col_port"] = _host(t.col_port, np.int32)
        arrays[f"{p}.col_proto"] = _host(t.col_proto, np.int32)
        arrays[f"{p}.col_is_l3"] = _host(t.col_is_l3, np.bool_)
        mat_meta[str(direction)] = {
            "ingress": st.ingress,
            "n_cols": st.n_cols,
            "endpoint_identity_ids": list(st.endpoint_identity_ids),
            "ep_slots": [[list(s) for s in slots] for slots in st.ep_slots],
        }
    meta["mats"] = mat_meta
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), np.uint8
    ).copy()

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".compiled.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_snapshot_basis(path: str) -> Optional[Tuple[int, int, int]]:
    """→ (revision, identity_version, vocab_version) of the snapshot on
    disk, or None when absent/corrupt. Reads only the JSON meta member —
    the CT restore path (policyd-survive) compares this against the
    basis stamped into the CT snapshot to decide keep-vs-flush, and must
    not pay for decoding the full array set to do so."""
    import zipfile

    _bad = (OSError, ValueError, KeyError, zipfile.BadZipFile)
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("schema") != SNAPSHOT_SCHEMA:
                return None
            return (
                int(meta["revision"]),
                int(meta["identity_version"]),
                int(meta["vocab_version"]),
            )
    except _bad:
        return None


def load_compiled_state(path: str):
    """→ (CompiledPolicy, sel_match_host, {direction: mat fields dict})
    or None when the file is absent, truncated, corrupt, or from
    another schema — a bad snapshot must degrade to a recompile, never
    to a crash."""
    import zipfile

    _bad = (OSError, ValueError, KeyError, zipfile.BadZipFile)
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("schema") != SNAPSHOT_SCHEMA:
                return None
            return _decode(z, meta)
    except _bad:
        return None


def _decode(z, meta):

    def direction(prefix: str, s_pad: int) -> DirectionProgram:
        kw = {"s_pad": s_pad}
        for f in dataclasses.fields(DirectionProgram):
            key = f"{prefix}.{f.name}"
            if key in z:
                kw[f.name] = z[key]
        return DirectionProgram(**kw)

    cp_kw = {
        "revision": meta["revision"],
        "identity_version": meta["identity_version"],
        "vocab_version": meta["vocab_version"],
        "num_words": meta["num_words"],
        "num_selectors": meta["num_selectors"],
        "id_to_row": dict(
            zip(z["map.ids"].tolist(), z["map.rows"].tolist())
        ),
        "ingress": direction("ing", meta["ing_s_pad"]),
        "egress": direction("eg", meta["eg_s_pad"]),
    }
    for f in dataclasses.fields(CompiledPolicy):
        key = f"cp.{f.name}"
        if key in z:
            cp_kw[f.name] = z[key].copy()  # incremental paths mutate
    compiled = CompiledPolicy(**cp_kw)

    mats: Dict[int, dict] = {}
    for dkey, m in (meta.get("mats") or {}).items():
        p = f"mat{dkey}"
        mats[int(dkey)] = {
            "ingress": m["ingress"],
            "n_cols": m["n_cols"],
            "endpoint_identity_ids": m["endpoint_identity_ids"],
            "ep_slots": [
                [tuple(s) for s in slots] for slots in m["ep_slots"]
            ],
            "allow_nc": z[f"{p}.allow_nc"],
            "red_nc": z[f"{p}.red_nc"],
            "ep_rows": z[f"{p}.ep_rows"],
            "col_ep": z[f"{p}.col_ep"],
            "col_port": z[f"{p}.col_port"],
            "col_proto": z[f"{p}.col_proto"],
            "col_is_l3": z[f"{p}.col_is_l3"],
        }
    return compiled, z["sel_match"].copy(), mats
