"""Selector interning + lowering to packed conjunct bitmaps.

Every distinct EndpointSelector that appears anywhere in the rule
repository (subject selectors, peer allows, requires, CIDR-derived,
entity-derived) is interned to a small integer id. Each selector lowers
to a disjunction of conjuncts (require_bits, forbid_bits) over the
LabelVocab (selector.py conjuncts()); the table packs those into

    conj_req    [S, CPS, W] uint32   required-bit words
    conj_forbid [S, CPS, W] uint32   forbidden-bit words
    conj_valid  [S, CPS]    bool     padding mask
    req_count   [S, CPS]    int32    popcount(conj_req) for the matmul test

so the device kernel can evaluate, for identity bitmap b,

    matches(s) = any_c[ conj_valid[s,c]
                        & (popcount(b & req)  == req_count[s,c])
                        & (popcount(b & forbid) == 0) ]

as two int8 matmuls over the unpacked bit axis (ops/bitmap.py).

Selector id 0 is reserved for the wildcard selector (matches every
identity: zero require, zero forbid) so padded table entries can point
at a well-defined id.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..labels import LabelVocab
from ..policy.api import EndpointSelector

WILDCARD_SELECTOR_ID = 0


def selector_word_window(sel_lo: int, sel_hi: int) -> np.ndarray:
    """Packed sel_match word indices covering selector ids
    [sel_lo, sel_hi) — the column window a selector-append delta
    scatters (ops/materialize.py patch_selector_cols). Appends land in
    one or two words for typical batch sizes, so the CSR payload for a
    selector touching k identities is O(k · window) uint32 words."""
    if sel_hi <= sel_lo:
        return np.zeros(0, np.int32)
    return np.arange(sel_lo >> 5, ((sel_hi - 1) >> 5) + 1, dtype=np.int32)


def selector_col_delta(
    sel_match_host: np.ndarray,  # [N, S/32] uint32 host mirror
    ident_rows: np.ndarray,  # [k] touched identity rows
    sel_lo: int,
    sel_hi: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR column-delta for a selector append: (rows, word_cols, vals)
    where ``vals[i, j] = sel_match_host[rows[i], word_cols[j]]`` — the
    final-state packed words for exactly the identities the new
    selectors [sel_lo, sel_hi) matched. Feed to patch_selector_cols;
    the payload is O(k · window), never the full matrix."""
    words = selector_word_window(sel_lo, sel_hi)
    rows = np.asarray(ident_rows, np.int32)
    if rows.size == 0 or words.size == 0:
        return rows, words, np.zeros((rows.size, words.size), np.uint32)
    return rows, words, sel_match_host[np.ix_(rows, words)]


class SelectorTable:
    """Grow-only EndpointSelector → id interner with device lowering."""

    def __init__(self) -> None:
        self._ids: Dict[EndpointSelector, int] = {}
        self._sels: List[EndpointSelector] = []
        self.intern(EndpointSelector.wildcard())  # id 0

    def intern(self, sel: EndpointSelector) -> int:
        sid = self._ids.get(sel)
        if sid is None:
            sid = len(self._sels)
            self._ids[sel] = sid
            self._sels.append(sel)
        return sid

    def __len__(self) -> int:
        return len(self._sels)

    def selector(self, sid: int) -> EndpointSelector:
        return self._sels[sid]

    def lower_bits(self, vocab: LabelVocab) -> List[List[Tuple[List[int], List[int]]]]:
        """Intern every selector's bits into the vocab (must run before
        identity packing so the final word count covers everything)."""
        return [sel.conjuncts(vocab) for sel in self._sels]

    def pack(
        self,
        lowered: List[List[Tuple[List[int], List[int]]]],
        vocab: LabelVocab,
        num_words: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Pack lowered conjuncts to (conj_req, conj_forbid, conj_valid,
        req_count) with CPS = max conjuncts per selector."""
        cps = max(1, max(len(c) for c in lowered))
        s = len(lowered)
        conj_req = np.zeros((s, cps, num_words), dtype=np.uint32)
        conj_forbid = np.zeros((s, cps, num_words), dtype=np.uint32)
        conj_valid = np.zeros((s, cps), dtype=bool)
        req_count = np.zeros((s, cps), dtype=np.int32)
        for i, conjs in enumerate(lowered):
            for j, (require, forbid) in enumerate(conjs):
                conj_req[i, j] = vocab.pack(require, num_words)
                conj_forbid[i, j] = vocab.pack(forbid, num_words)
                conj_valid[i, j] = True
                req_count[i, j] = len(set(require))
        return conj_req, conj_forbid, conj_valid, req_count
