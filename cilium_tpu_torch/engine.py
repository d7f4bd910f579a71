"""PolicyEngine: the device-backed policy resolver.

The counterpart of the reference's per-endpoint regeneration entry
points (pkg/endpoint/policy.go regeneratePolicy →
repository.AllowsIngress*): owns a Repository + IdentityRegistry,
compiles them into device tensors, refreshes when revisions move, and
answers batched verdict queries.

Refresh is incremental where the reference's is per-endpoint (the
revision gate of pkg/endpoint/policy.go:506-552): identity churn
becomes row updates of ``id_bits`` and ``sel_match``, rule appends that
fit the existing shape buckets set matrix cells in place
(compiler.DirectionPacker) with only the new selector columns computed,
and rule deletes retract refcounted cells. Each update is one torch
indexing op per tensor, out of place: a (compiled, device) snapshot
taken before it keeps its values. Full recompiles happen on a row
bucket crossing, vocab word growth, a rule the packers cannot append
or never attributed, or a truncated repository log. Every refresh
logs a delta (``deltas_since``) that the pipeline replays onto its
materialized policymaps. Verdict attribution (``attribution``,
``verdicts(attrib=True)``, ``explain_one``) reads the rule-origin
tables of the kept compile state.

Compiled-state snapshots (the pinned-map persistence analog):
``save_snapshot`` writes the compiler's arrays, the ``sel_match``
mirror and optionally the materialized policymaps in the JAX package's
format (``compiler/snapshot.py``); ``restore_snapshot`` loads them and
uploads the tables without a compile or a K1 launch. A restore that
does not trust the file's counters serves the loaded tables while the
first ``refresh()`` recompiles on a background thread (on the card, on
a side CUDA stream); ``wait_refreshed`` joins it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from . import faults as _faults
from . import metrics as _metrics
from . import u8proto
from .compiler import CompiledPolicy, compile_policy_state, host_selector_matches, try_append_rules
from .compiler.program import CompileState, rule_origin_arrays, subject_sids, unpack_conjuncts
from .convert import device_policy_from_numpy
from .identity import IdentityRegistry
from .identity.model import MAX_USER_IDENTITY
from .ops.verdict import ALLOW, ATTR_NAMES, AttribTables, DevicePolicy, DeviceTables, Verdict, verdict_batch
from .policy.repository import Repository

PROTO_TCP = u8proto.TCP
PROTO_UDP = u8proto.UDP


# The scatter helpers: one out-of-place torch indexing op each (never
# index_put_: a published snapshot or an in-flight batch may still hold
# the old tensor). Indices are exact, never padded, never repeated.
def _set_rows(buf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return buf.index_put((idx,), rows)


def _set_rows_cols(
    buf: torch.Tensor,
    rows: torch.Tensor,  # [k] int64
    cols: torch.Tensor,  # [w] int64
    vals: torch.Tensor,  # [k, w]
) -> torch.Tensor:
    """Sparse rows × word-window scatter for sel_match: a new selector
    matching k identities uploads O(k · window) words, not [N, S/32]."""
    return buf.index_put((rows[:, None], cols[None, :]), vals)


def _set_col_window(buf: torch.Tensor, start_word: int, window: torch.Tensor) -> torch.Tensor:
    """Dense fallback when most identities match the appended
    selectors: the whole touched word window [N, w] (still O(N · w),
    never the full matrix)."""
    return buf.slice_scatter(window, dim=1, start=start_word, end=start_word + window.shape[1])


def _pack_match_words(m: np.ndarray) -> np.ndarray:
    """[k, S] bool → [k, S/32] uint32 in sel_match bit order (S is a
    multiple of 128, so the byte view folds cleanly into words)."""
    packed = np.packbits(m, axis=1, bitorder="little")  # [k, S/8] uint8
    return packed.view(np.uint32).reshape(m.shape[0], m.shape[1] // 32)


# DirectionPacker write names → DeviceTables fields; the transposed
# fields take (j, i)
_TRANSPOSED = {"deny": "deny_t", "allow": "allow_t", "en": "en_t", "ee": "ee_t"}
_DIRECT = {
    "s1": "s1_mat", "p1": "p1_mat", "gpn": "gpn_mat", "gpe": "gpe_mat",
    "s7": "s7_mat", "p7": "p7_mat", "g7": "g7_mat",
}


class PolicyEngine:
    # Delta-log ring consumed by DatapathPipeline for incremental
    # policymap materialization.
    DELTA_LOG_CAP = 512

    def __init__(
        self, repo: Repository, registry: IdentityRegistry, device=None
    ) -> None:
        self.device = _kernels.resolve_device(device)
        self.repo = repo
        self.registry = registry
        self._lock = threading.Lock()
        self._compiled: Optional[CompiledPolicy] = None
        self._state: Optional[CompileState] = None
        self._device: Optional[DevicePolicy] = None
        # host mirror of sel_match ([N, S/32] uint32), pulled once per
        # full refresh; the incremental paths update it in place
        self._sel_match_host: Optional[np.ndarray] = None
        self._attrib_cache: Optional[tuple] = None
        # Dense row table for the compact ranges (reserved + user,
        # < 65536) and a dict for sparse local/CIDR identities.
        self._low_rows: Optional[np.ndarray] = None
        self._high_rows: dict = {}
        self._conj_unpacked = None  # cached unpack_conjuncts result
        # Identity change feed (registry observer) + outward delta log.
        self._pending_idents: List[Tuple[object, bool]] = []
        registry.observe(lambda ident, added: self._pending_idents.append((ident, added)))
        self.delta_seq = 0
        self._delta_log: List[Tuple[int, str, tuple]] = []
        self.install_gen = 0  # bumps on every full refresh
        self._bg_refresh: Optional[threading.Thread] = None
        # the CUDA event recorded after the latest background refresh's
        # device work (None on the CPU, or before one ran)
        self._bg_ready: Optional[torch.cuda.Event] = None

    # ------------------------------------------------------------------
    def _log_delta(self, kind: str, payload: tuple) -> None:
        self.delta_seq += 1
        self._delta_log.append((self.delta_seq, kind, payload))
        if len(self._delta_log) > self.DELTA_LOG_CAP:
            del self._delta_log[: len(self._delta_log) - self.DELTA_LOG_CAP]

    def deltas_since(self, seq: int):
        """Refresh deltas with seq > ``seq`` (oldest first), or None when
        the log has been truncated past that point (consumer must do a
        full rebuild)."""
        with self._lock:
            if seq >= self.delta_seq:
                return []
            if self._delta_log and self._delta_log[0][0] > seq + 1:
                return None
            if not self._delta_log and self.delta_seq > seq:
                return None
            return [e for e in self._delta_log if e[0] > seq]

    def _stale(self) -> bool:
        c = self._compiled
        return (
            c is None
            or c.revision != self.repo.revision
            or c.identity_version != self.registry.version
        )

    def refresh(self, force: bool = False) -> CompiledPolicy:
        """Recompile, or patch incrementally, if the repository or the
        identities moved (the revision gate of pkg/endpoint/policy.go:506).

        A snapshot-restored engine with untrusted counters (revision < 0)
        refreshes in the background instead: the restored tables keep
        serving verdicts while the full compile runs (the continuity the
        reference gets from maps that outlive the agent,
        daemon/state.go:53,135), and this call returns the restored
        compile. A restored engine carries no CompileState, so a rule
        delta on it takes the full path. Every other refresh is
        synchronous."""
        with self._lock:
            if not force and not self._stale():
                return self._compiled  # type: ignore[return-value]
            if not force and self._compiled is not None and self._compiled.revision < 0:
                self._kick_background_refresh()
                return self._compiled
            if force or self._compiled is None:
                return self._full_refresh()

            t0 = time.perf_counter()
            c = self._compiled
            rule_ops = []
            if c.revision != self.repo.revision:
                rule_ops = self.repo.changes_since(c.revision)
                if rule_ops is None or any(op not in ("add", "delete") for _, op, _ in rule_ops):
                    return self._full_refresh()
            if rule_ops and self._state is None:
                # a snapshot-restored engine has no CompileState for the
                # packers to append to or retract from
                return self._full_refresh()
            if not self._apply_identity_delta():
                return self._full_refresh()
            # Each applied op advances c.revision to ITS revision (never a
            # re-read of repo.revision): a concurrent AddList landing
            # between changes_since() and here must stay stale so the
            # next refresh picks it up.
            for rev, op, payload in rule_ops:
                if op == "add":  # payload: the rules added at that rev
                    if not self._apply_rule_append(list(payload), rev):
                        return self._full_refresh()
                elif len(payload) < 2 or not self._apply_rule_delete(list(payload[1]), rev):
                    return self._full_refresh()  # "delete": (labels, deleted rules)
            _metrics.engine_refresh_seconds.observe(time.perf_counter() - t0, {"kind": "incremental"})
            _metrics.engine_refreshes_total.inc({"kind": "incremental"})
            return c

    @staticmethod
    def _compute_full(
        repo, registry, device
    ) -> Tuple[CompiledPolicy, CompileState, DevicePolicy]:
        """Host compile, upload, and the selector match on the device;
        lock-free, so the background refresh runs it while restored
        tables serve."""
        compiled, state = compile_policy_state(repo, registry)
        return compiled, state, device_policy_from_numpy(compiled, device=device)

    def _install_compiled(
        self, compiled: CompiledPolicy, state: CompileState, device: DevicePolicy
    ) -> None:
        """Swap a full-refresh result in (lock held)."""
        low = np.full(MAX_USER_IDENTITY + 1, -1, np.int32)
        high: dict = {}
        for ident, row in compiled.id_to_row.items():
            if ident < low.size:
                low[ident] = row
            else:
                high[ident] = row
        self._low_rows = low
        self._high_rows = high
        self._device = device
        # the one [N, S/32] pull: the host mirror the deltas patch
        self._sel_match_host = device.sel_match.cpu().numpy().view(np.uint32).copy()
        self._compiled = compiled
        self._state = state
        self._conj_unpacked = None
        self._pending_idents.clear()
        self.install_gen += 1
        self._log_delta("full", ())

    def _full_refresh(self) -> CompiledPolicy:
        t0 = time.perf_counter()
        compiled, state, device = self._compute_full(self.repo, self.registry, self.device)
        self._install_compiled(compiled, state, device)
        _metrics.engine_refresh_seconds.observe(time.perf_counter() - t0, {"kind": "full"})
        _metrics.engine_refreshes_total.inc({"kind": "full"})
        return compiled

    def _up(self, a) -> torch.Tensor:
        """numpy → tensor on the engine's device; uint32 words travel as
        int32 bit views."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def _idx(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    # -- incremental paths ---------------------------------------------
    def _apply_identity_delta(self) -> bool:
        """Apply pending identity adds/releases as device row updates.
        False → caller must full-rebuild."""
        c = self._compiled
        assert c is not None
        target_version = self.registry.version
        if c.identity_version == target_version:
            return True
        pend = list(self._pending_idents)
        # The observer feed must cover exactly the version gap; if the
        # engine attached late or events were lost, rebuild.
        if len(pend) != target_version - c.identity_version:
            return False
        if self.registry.padded_rows() != c.id_bits.shape[0]:
            # row-capacity bucket crossed → the device tables reshape
            _metrics.jit_shape_buckets_total.inc({"site": "engine_rows", "result": "miss"})
            return False
        _metrics.jit_shape_buckets_total.inc({"site": "engine_rows", "result": "hit"})

        vocab = self.registry.vocab
        plans: List[Tuple[int, bool, object]] = []
        for ident, added in pend:
            row = self.registry.row(ident.id)
            if row is None:
                return False
            if added:
                bits = vocab.identity_bits(ident.labels)  # may grow vocab
                plans.append((row, True, (ident, bits)))
            else:
                plans.append((row, False, ident))
        if vocab.num_words > c.num_words:
            return False  # new label words → conjunct arrays reshape

        events: List[Tuple[int, int, bool]] = []
        for row, added, info in plans:
            if added:
                ident, bits = info
                c.id_bits[row] = vocab.pack(bits, c.num_words)
                c.row_ids[row] = ident.id
                c.row_live[row] = True
                c.id_to_row[ident.id] = row
                self._set_row_index(ident.id, row)
                events.append((row, ident.id, True))
            else:
                ident = info
                c.id_bits[row] = 0
                c.row_live[row] = False
                c.id_to_row.pop(ident.id, None)
                self._set_row_index(ident.id, -1)
                events.append((row, ident.id, False))

        idx = np.asarray(sorted({row for row, _, _ in events}), np.int64)
        # sel_match rows recomputed on the host (a small [k, S] match);
        # the unpacked conjunct operands are cached across churn
        sub_bits = c.id_bits[idx]
        if self._conj_unpacked is None:
            self._conj_unpacked = unpack_conjuncts(c.conj_req, c.conj_forbid)
        m = host_selector_matches(
            sub_bits, c.conj_req, c.conj_forbid, c.conj_valid, c.req_count,
            unpacked=self._conj_unpacked,
        )  # [k, S]
        words = _pack_match_words(m)
        assert self._sel_match_host is not None
        self._sel_match_host[idx] = words

        device = self._device
        assert device is not None
        rows = self._idx(idx)
        self._device = DevicePolicy(
            id_bits=_set_rows(device.id_bits, rows, self._up(sub_bits)),
            sel_match=_set_rows(device.sel_match, rows, self._up(words)),
            ingress=device.ingress, egress=device.egress,
        )
        # Only the processed prefix is consumed — events racing in during
        # this delta stay queued and are covered by the next refresh.
        c.identity_version = target_version
        del self._pending_idents[: len(pend)]
        _metrics.engine_delta_rows_total.inc(value=len(events))
        # payload: (row, identity_id, live) events in apply order
        self._log_delta("rows", tuple(events))
        return True

    def _patch_tables(self, tables: DeviceTables, writes) -> DeviceTables:
        """Apply a DirectionPacker write log as one scatter per touched
        field: only the touched cells travel to the device. Each write
        carries its value (1 for appends, 0 for delete retractions)."""
        if not writes:
            return tables
        # one write per cell, the last one (a sequential scatter's
        # result): torch's index_put leaves duplicate indices unordered
        by_name: dict = {}
        for name, i, j, v in writes:
            if name in ("group_no_peers", "port_vocab"):
                by_name.setdefault(name, {})[i] = (i, j, v)
            else:
                by_name.setdefault(name, {})[(i, j)] = (i, j, v)
        reps: dict = {}
        for name, cells in by_name.items():
            items = list(cells.values())
            ii = self._idx([x[0] for x in items])
            jj = [x[1] for x in items]
            vv = [x[2] for x in items]
            if name in _TRANSPOSED:
                field = _TRANSPOSED[name]
                reps[field] = getattr(tables, field).index_put((self._idx(jj), ii), self._up(np.asarray(vv, np.int8)))
            elif name in _DIRECT:
                field = _DIRECT[name]
                reps[field] = getattr(tables, field).index_put((ii, self._idx(jj)), self._up(np.asarray(vv, np.int8)))
            elif name == "group_no_peers":
                reps["group_no_peers"] = tables.group_no_peers.index_put((ii,), self._up(np.asarray(vv, bool)))
            elif name == "port_vocab":  # (pid, port, proto)
                reps["ports"] = tables.ports.index_put((ii,), self._up(np.asarray(jj, np.int32)))
                reps["protos"] = tables.protos.index_put((ii,), self._up(np.asarray(vv, np.int32)))
            else:  # pragma: no cover - unknown write kind
                raise KeyError(name)
        return dataclasses.replace(tables, **reps)

    def _apply_rule_append(self, rules, revision: int) -> bool:
        """Append a rule batch in place, advancing the compiled revision
        to the op's own revision. False → full rebuild needed."""
        c = self._compiled
        assert c is not None and self._state is not None
        res = try_append_rules(c, self._state, self.registry, rules, revision)
        if res is None:
            return False
        self._conj_unpacked = None  # conjunct rows changed
        old_s, new_s = res
        new_match = None
        if new_s > old_s:
            # New selector columns: match against ALL identities, then
            # OR the bits into the packed words (the columns were zero).
            m = host_selector_matches(
                c.id_bits, c.conj_req[old_s:new_s], c.conj_forbid[old_s:new_s],
                c.conj_valid[old_s:new_s], c.req_count[old_s:new_s],
            )  # [N, k]
            sm = self._sel_match_host
            assert sm is not None
            for j, sid in enumerate(range(old_s, new_s)):
                col = m[:, j]
                if col.any():
                    sm[:, sid >> 5] |= col.astype(np.uint32) << np.uint32(sid & 31)
            # only the word window the new selector bits land in moves,
            # and only for the rows that matched
            cols = np.arange(old_s >> 5, ((new_s - 1) >> 5) + 1, dtype=np.int64)
            touched = np.nonzero(m.any(axis=1))[0]
            new_match = self._scatter_sel_window(sm, touched, cols)
            if touched.size:
                # payload: (sel_lo, sel_hi, touched identity rows)
                self._log_delta("cols", (old_s, new_s, tuple(int(r) for r in touched)))
                _metrics.engine_delta_cols_total.inc(value=int(touched.size))
        device = self._device
        assert device is not None
        self._device = DevicePolicy(
            id_bits=device.id_bits,
            sel_match=new_match if new_match is not None else device.sel_match,
            ingress=self._patch_tables(device.ingress, self._state.ingress.take_writes()),
            egress=self._patch_tables(device.egress, self._state.egress.take_writes()),
        )
        # payload: op + the subject selector ids the batch touches —
        # every verdict term is subject-gated, so these columns bound
        # the policymap cells the delta can change
        self._log_delta("rules", ("add", subject_sids(rules, self._state.table)))
        return True

    def _scatter_sel_window(self, sm: np.ndarray, touched: np.ndarray, cols: np.ndarray):
        """Upload the changed sel_match word window: a row-sparse
        scatter when few identities matched, the dense column window
        otherwise."""
        device = self._device
        assert device is not None
        if touched.size == 0:
            # no identity matches the new selectors: their bits stay zero
            return device.sel_match
        if touched.size <= max(8, sm.shape[0] // 4):
            return _set_rows_cols(
                device.sel_match, self._idx(touched), self._idx(cols), self._up(sm[np.ix_(touched, cols)])
            )
        return _set_col_window(device.sel_match, int(cols[0]), self._up(sm[:, cols]))

    def _apply_rule_delete(self, rules, revision: int) -> bool:
        """Retract a deleted rule batch in place (repository.go
        DeleteByLabels:286): refcounted matrix cells drop to zero and
        are scattered as value-0 writes. False → full rebuild needed (a
        rule this compile never attributed)."""
        c = self._compiled
        state = self._state
        assert c is not None and state is not None
        ing, eg = state.ingress, state.egress
        keys = [id(r) for r in rules]
        # check attribution FIRST: a partial removal (ingress done,
        # egress unknown) would leave the two directions inconsistent
        if any(k not in ing.rule_cells or k not in eg.rule_cells for k in keys):
            return False
        for k in keys:
            ing.remove_rule(k)
            eg.remove_rule(k)
        ing.refresh_entry_views()
        eg.refresh_entry_views()
        device = self._device
        assert device is not None
        self._device = DevicePolicy(
            id_bits=device.id_bits,
            sel_match=device.sel_match,
            ingress=self._patch_tables(device.ingress, ing.take_writes()),
            egress=self._patch_tables(device.egress, eg.take_writes()),
        )
        c.revision = revision
        # deletes only retract cells under the removed rules' subject
        # selectors; the selectors stay interned
        self._log_delta("rules", ("del", subject_sids(rules, state.table)))
        return True

    def _kick_background_refresh(self) -> None:
        """Start (at most one) background full refresh (lock held). Its
        result installs only if no other full refresh installed while it
        ran: installing then would roll enforcement back to an older
        rule set.

        On the card the upload and K1 run on a side stream that first
        waits for the serving stream; an event recorded after them is
        waited on by the serving stream before the install publishes, so
        no batch reads a table whose upload is still in flight, and the
        install's ``sel_match`` pull reads after it too. A failure
        leaves the restored tables serving (the next refresh retries),
        except a programmer error or a kernel that cannot build or
        launch (``KernelError``), which re-raises on the thread
        (``threading.excepthook``)."""
        t = self._bg_refresh
        if t is not None and t.is_alive():
            return
        gen = self.install_gen  # what the result would replace
        streams = None
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            streams = (main, side)

        def run():
            try:
                if streams is None:
                    result = self._compute_full(self.repo, self.registry, self.device)
                    ready = None
                else:
                    main, side = streams
                    with torch.cuda.stream(side):
                        result = self._compute_full(self.repo, self.registry, self.device)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    # made on the side stream, read on the serving one:
                    # the allocator must not reuse their blocks before
                    # the serving stream's work on them ends
                    dp = result[2]
                    tables = [getattr(t, f.name) for t in (dp.ingress, dp.egress)
                              for f in dataclasses.fields(t)]
                    for x in (dp.id_bits, dp.sel_match, *tables):
                        x.record_stream(main)
                    # off the lock: the install then never waits on the card
                    ready.synchronize()
                with self._lock:
                    if self.install_gen != gen:
                        return
                    if streams is None:
                        self._install_compiled(*result)
                    else:
                        self._bg_ready = ready
                        main.wait_event(ready)
                        with torch.cuda.stream(main):
                            self._install_compiled(*result)
            except Exception as e:
                if isinstance(e, _kernels.KernelError) or _faults.classify(e) == _faults.KIND_ERROR:
                    raise
                from .utils.logging import get_logger

                get_logger("engine").warning(
                    "background refresh failed",
                    fields={"err": f"{type(e).__name__}: {e}"},
                )

        t = threading.Thread(target=run, name="policyd-bg-refresh", daemon=True)
        self._bg_refresh = t
        t.start()

    def wait_refreshed(self, timeout: Optional[float] = None) -> bool:
        """Block until a pending background refresh (if any) lands; tests
        and shutdown paths use it, serving paths never do."""
        t = self._bg_refresh
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    # -- compiled-state snapshots (pinned-map persistence analog) -------
    def save_snapshot(self, path: str, mats=None) -> None:
        """Persist the compiled arrays (and optionally the materialized
        policymaps, {direction: MaterializedState}) so a restart can load
        instead of re-deriving (the daemon/state.go:53,135 role). The
        arrays are copied under the engine lock (the incremental paths
        mutate them in place); the serialize and fsync run outside it."""
        import copy as _copy

        from .compiler.snapshot import save_compiled_state

        with self._lock:
            if self._compiled is None or self._sel_match_host is None:
                raise RuntimeError("nothing compiled to snapshot")
            c = self._compiled

            def copy_arrays(obj):
                return dataclasses.replace(obj, **{
                    f.name: getattr(obj, f.name).copy()
                    for f in dataclasses.fields(obj)
                    if isinstance(getattr(obj, f.name), np.ndarray)
                })

            compiled = copy_arrays(c)
            compiled.id_to_row = dict(c.id_to_row)
            compiled.ingress = copy_arrays(c.ingress)
            compiled.egress = copy_arrays(c.egress)
            sel_match = self._sel_match_host.copy()
            mats_copy = None
            if mats:
                # the device tables are never written in place: sharing
                # them is a snapshot already
                mats_copy = {
                    d: dataclasses.replace(
                        st,
                        allow_nc=st.allow_nc.copy(),
                        red_nc=st.red_nc.copy(),
                        ep_rows=st.ep_rows.copy(),
                        ep_slots=_copy.deepcopy(st.ep_slots),
                        endpoint_identity_ids=list(st.endpoint_identity_ids),
                    )
                    for d, st in mats.items()
                }
        save_compiled_state(path, compiled, sel_match, mats_copy)

    def restore_snapshot(self, path: str, *, trust_counters: bool = False):
        """Load a snapshot and bring the device tables up on it: →
        {direction: MaterializedState} (empty if none were saved), or
        None when the file is absent or unreadable. The loaded state
        serves at once; ``refresh()`` re-derives when the inputs move.
        ``id_bits`` and ``sel_match`` upload as int32 bit views (no
        selector match runs), the engine keeps no CompileState, and a
        "full" delta is logged.

        ``trust_counters`` may only be True when the live repository and
        registry are the very objects the snapshot was taken from: then
        equal revision counters mean equal content and ``refresh()``
        stays a no-op. Across a restart the counters come from a dead
        process (a fresh repository restarts its numbering), so the
        default re-stamps them to -1, and the first ``refresh()``
        recompiles in the background while the restored tables serve."""
        from .compiler.snapshot import load_compiled_state
        from .ops.materialize import state_from_snapshot

        loaded = load_compiled_state(path)
        if loaded is None:
            return None
        compiled, sel_match_host, mat_fields = loaded
        if not trust_counters:
            compiled.revision = -1
            compiled.identity_version = -1
        device = device_policy_from_numpy(compiled, device=self.device, sel_match=sel_match_host)
        with self._lock:
            self._device = device
            self._sel_match_host = sel_match_host
            low = np.full(MAX_USER_IDENTITY + 1, -1, np.int32)
            high: dict = {}
            for ident, row in compiled.id_to_row.items():
                if ident < low.size:
                    low[ident] = row
                else:
                    high[ident] = row
            self._low_rows = low
            self._high_rows = high
            self._compiled = compiled
            self._state = None  # no incremental state: rule ops rebuild
            self._conj_unpacked = None
            self._pending_idents.clear()
            self._log_delta("full", ())
        return {
            d: state_from_snapshot(compiled.row_ids, f, device=self.device)
            for d, f in mat_fields.items()
        }

    def wait_device(self) -> None:
        """Block until every queued device update (row scatters,
        sel_match windows, table patches) has completed: a synchronize
        of the engine's device, nothing on the CPU. The refresh path
        never calls it; benches and tests use it as the completion edge
        of a delta."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _set_row_index(self, ident_id: int, row: int) -> None:
        assert self._low_rows is not None
        if ident_id < self._low_rows.size:
            self._low_rows[ident_id] = row
        elif row < 0:
            self._high_rows.pop(ident_id, None)
        else:
            self._high_rows[ident_id] = row

    def sel_match_rows(
        self, rows: Sequence[int], words: Optional[Sequence[int]] = None
    ) -> Optional[np.ndarray]:
        """Final-state copy of the host sel_match mirror: the requested
        identity rows (× the requested packed words, all when None), or
        None when nothing is compiled or an index is out of bounds."""
        ridx = np.asarray(rows, np.int64)
        widx = None if words is None else np.asarray(words, np.int64)
        with self._lock:
            sm = self._sel_match_host
            if sm is None:
                return None
            if ridx.size and (ridx.min() < 0 or ridx.max() >= sm.shape[0]):
                return None
            if widx is not None and widx.size and (widx.min() < 0 or widx.max() >= sm.shape[1]):
                return None
            if widx is None:
                return sm[ridx].copy()
            return sm[np.ix_(ridx, widx)].copy()

    @property
    def device_policy(self) -> DevicePolicy:
        self.refresh()
        assert self._device is not None
        return self._device

    def snapshot(self) -> Tuple[CompiledPolicy, DevicePolicy]:
        """A consistent (compiled, device) pair from one refresh."""
        self.refresh()
        with self._lock:
            assert self._compiled is not None and self._device is not None
            return self._compiled, self._device

    @staticmethod
    def _rows_snapshot(low: np.ndarray, high: dict, identity_ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(identity_ids, dtype=np.int64)
        rows = np.empty(ids.shape, np.int32)
        in_low = ids < low.size
        if (ids < 0).any():
            raise KeyError("negative identity in batch")
        rows[in_low] = low[ids[in_low]]
        for i in np.nonzero(~in_low)[0]:
            rows[i] = high.get(int(ids[i]), -1)
        if (rows < 0).any():
            raise KeyError("unknown identity in batch")
        return rows

    def rows(self, identity_ids: Sequence[int]) -> np.ndarray:
        self.refresh()
        assert self._low_rows is not None
        return self._rows_snapshot(self._low_rows, self._high_rows, identity_ids)

    def rows_or_negative(self, identity_ids: np.ndarray) -> np.ndarray:
        """[B] device rows with -1 for unknown/invalid identities."""
        self.refresh()
        with self._lock:
            low = self._low_rows
            high = dict(self._high_rows)
        assert low is not None
        ids = np.asarray(identity_ids, np.int64)
        rows = np.full(ids.shape, -1, np.int32)
        ok = (ids > 0) & (ids < low.size)
        rows[ok] = low[ids[ok]]
        hi = ids >= low.size
        if hi.any():
            uniq, inv = np.unique(ids[hi], return_inverse=True)
            vals = np.fromiter((high.get(int(u), -1) for u in uniq), np.int32, len(uniq))
            rows[hi] = vals[inv]
        return rows

    # -- verdict attribution (policyd-flows) ---------------------------
    def attribution(
        self, ingress: bool = True, expect_revision: Optional[int] = None
    ):
        """(AttribTables, n_rules) for the attribution kernel variant,
        or None when the engine carries no compile state. Cached per
        (install_gen, revision): identity churn keeps the cache, any
        rule movement (append, delete, full refresh) rebuilds it from
        the packers' rule_cells refcounts.

        ``expect_revision`` lets a caller that already holds a
        (compiled, device) snapshot demand tables consistent with it: a
        rule mutation racing the two reads returns None (the caller's
        next rebuild re-materializes with matching tables) instead of
        shape-mismatched origin arrays."""
        self.refresh()
        with self._lock:
            state, c = self._state, self._compiled
            if state is None or c is None:
                return None
            if expect_revision is not None and c.revision != expect_revision:
                return None
            key = (self.install_gen, c.revision)
            cache = self._attrib_cache
            if cache is None or cache[0] != key:
                with self.repo._lock:
                    rules = list(self.repo.rules)
                keys = [id(r) for r in rules]
                tabs = {}
                for ing, packer in ((True, state.ingress), (False, state.egress)):
                    d, a, k = rule_origin_arrays(packer, keys)
                    tabs[ing] = AttribTables(
                        deny_rule=self._up(d),
                        allow_rule=self._up(a),
                        combo_rule=self._up(k),
                    )
                cache = self._attrib_cache = (key, tabs, len(rules))
            return cache[1][ingress], cache[2]

    def verdicts(
        self,
        subj_ids: Sequence[int],
        peer_ids: Sequence[int],
        dports: Sequence[int],
        protos: Sequence[int],
        *,
        ingress: bool = True,
        has_l4: Optional[Sequence[bool]] = None,
        attrib: bool = False,
    ):
        """Batched verdicts by identity number. ``subj`` is the endpoint
        whose policy applies (dst for ingress, src for egress). With
        ``attrib=True`` → (Verdict, Attribution, hits[R]); raises
        RuntimeError when rule-origin tables are unavailable."""
        origin = n_rules = None
        if attrib:
            at = self.attribution(ingress)
            if at is None:
                raise RuntimeError(
                    "verdict attribution unavailable: engine has no compile state"
                )
            origin, n_rules = at
        # device + row tables from one lock acquisition, so row indices
        # of a newer compile never meet older device tables
        self.refresh()
        with self._lock:
            device = self._device
            low = self._low_rows.copy() if self._low_rows is not None else None
            high = dict(self._high_rows)
        assert device is not None and low is not None
        _metrics.verdict_batches.inc({"path": "engine"})
        n = len(subj_ids)
        hl4 = np.ones(n, dtype=bool) if has_l4 is None else np.asarray(has_l4, bool)
        args = (
            device,
            self._up(self._rows_snapshot(low, high, subj_ids)),
            self._up(self._rows_snapshot(low, high, peer_ids)),
            self._up(np.asarray(dports, np.int32)),
            self._up(np.asarray(protos, np.int32)),
            self._up(hl4),
        )
        if not attrib:
            return verdict_batch(*args, ingress=ingress)
        return verdict_batch(
            *args, ingress=ingress, attrib=True, origin=origin, n_rules=n_rules
        )

    def explain_one(
        self,
        subj_id: int,
        peer_id: int,
        dport: int = 0,
        proto: int = PROTO_TCP,
        *,
        ingress: bool = True,
        l4: bool = True,
    ) -> dict:
        """Replay ONE flow through the verdict kernel with attribution
        on and name the deciding rule — the `cilium policy trace`-style
        explain backend."""
        verdict, at, _hits = self.verdicts(
            [subj_id], [peer_id], [dport], [proto],
            ingress=ingress, has_l4=[l4], attrib=True,
        )
        rule_idx = int(at.rule[0])
        reason = int(at.reason[0])
        origins = self.repo.rule_origins()
        return {
            "decision": int(verdict.decision[0]),
            "allowed": int(verdict.decision[0]) == ALLOW,
            "l3": int(verdict.l3[0]),
            "l7_redirect": bool(verdict.l7_redirect[0]),
            "reason_code": reason,
            "reason": ATTR_NAMES.get(reason, str(reason)),
            "rule_index": rule_idx,
            "rule": origins[rule_idx] if 0 <= rule_idx < len(origins) else None,
        }

    def verdict_one(
        self,
        subj_id: int,
        peer_id: int,
        dport: int = 0,
        proto: int = PROTO_TCP,
        *,
        ingress: bool = True,
        l4: bool = True,
    ) -> Tuple[int, int]:
        """Single query → (decision, l3_decision); the `cilium policy
        trace` fast path."""
        v = self.verdicts(
            [subj_id], [peer_id], [dport], [proto], ingress=ingress, has_l4=[l4]
        )
        return int(v.decision[0]), int(v.l3[0])
