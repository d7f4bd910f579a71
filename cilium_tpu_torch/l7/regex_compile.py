"""POSIX-egrep-subset regex → multi-pattern DFA transition tables.

Reference semantics: pkg/policy/api/http.go:23-28 — HTTP rule fields
(Path, Method, Host) are anchored POSIX regexes compiled with Go's
regexp. The supported subset here covers what HTTP policies use:
literals, '.', character classes [a-z0-9_] with negation and escapes,
alternation '|', grouping '()', quantifiers * + ? and {m}/{m,}/{m,n}
(n bounded), and escaped metacharacters. Patterns are fully anchored
(Go wraps with ^(?:...)$ — server.go:316 getHTTPRule uses anchored
matchers).

Pipeline: parse → Thompson NFA → subset-construction DFA over the
byte alphabet, with *all patterns combined into one DFA* whose accept
sets are per-state pattern bitmasks — one table walk classifies a
string against every pattern at once (the vmapped-NFA-tables idea from
BASELINE.json). State count is capped; overflow raises RegexError and
the caller falls back to host-side matching.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

MAX_REPEAT = 32
MAX_DFA_STATES = 4096
ALPHABET = 256


class RegexError(ValueError):
    pass


# -- parser (recursive descent) -> NFA fragments ---------------------------
# NFA: states are ints; transitions: List[Dict[int, Set[int]]] byte→states;
# epsilon: List[Set[int]].


class _NFA:
    def __init__(self) -> None:
        self.trans: List[Dict[int, Set[int]]] = []
        self.eps: List[Set[int]] = []

    def new_state(self) -> int:
        self.trans.append({})
        self.eps.append(set())
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].add(b)

    def add_byte(self, a: int, byte: int, b: int) -> None:
        self.trans[a].setdefault(byte, set()).add(b)


_META = set("().[]*+?{}|\\^$")

_ESCAPE_CLASSES = {
    "d": set(range(ord("0"), ord("9") + 1)),
    "w": set(range(ord("a"), ord("z") + 1))
    | set(range(ord("A"), ord("Z") + 1))
    | set(range(ord("0"), ord("9") + 1))
    | {ord("_")},
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C},
}


def _class_for_escape(c: str) -> Optional[Set[int]]:
    """\\d/\\w/\\s → byte set, uppercase → complement, else None."""
    if c in _ESCAPE_CLASSES:
        return _ESCAPE_CLASSES[c]
    if c.isupper() and c.lower() in _ESCAPE_CLASSES:
        return set(range(ALPHABET)) - _ESCAPE_CLASSES[c.lower()]
    return None


class _Parser:
    """Grammar: alt := concat ('|' concat)* ; concat := repeat* ;
    repeat := atom ('*'|'+'|'?'|'{m,n}')* ; atom := literal | '.' |
    class | '(' alt ')'."""

    def __init__(self, pattern: str, nfa: _NFA) -> None:
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> Tuple[int, int]:
        start, end = self.alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return start, end

    def alt(self) -> Tuple[int, int]:
        frags = [self.concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self.concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for fs, fe in frags:
            self.nfa.add_eps(s, fs)
            self.nfa.add_eps(fe, e)
        return s, e

    def concat(self) -> Tuple[int, int]:
        frags: List[Tuple[int, int]] = []
        while self.peek() is not None and self.peek() not in "|)":
            frags.append(self.repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        for (a_s, a_e), (b_s, b_e) in zip(frags, frags[1:]):
            self.nfa.add_eps(a_e, b_s)
        return frags[0][0], frags[-1][1]

    def repeat(self) -> Tuple[int, int]:
        frag = self.atom()
        while self.peek() in ("*", "+", "?", "{"):
            op = self.peek()
            if op == "{":
                save = self.i
                reps = self._parse_brace()
                if reps is None:
                    self.i = save
                    break
                lo, hi = reps
                frag = self._repeat_range(frag, lo, hi)
            else:
                self.take()
                if op == "*":
                    frag = self._star(frag)
                elif op == "+":
                    s2 = self._star(self._clone(frag))
                    self.nfa.add_eps(frag[1], s2[0])
                    frag = (frag[0], s2[1])
                else:  # '?'
                    s, e = self.nfa.new_state(), self.nfa.new_state()
                    self.nfa.add_eps(s, frag[0])
                    self.nfa.add_eps(frag[1], e)
                    self.nfa.add_eps(s, e)
                    frag = (s, e)
        return frag

    def _parse_brace(self) -> Optional[Tuple[int, int]]:
        # '{m}' '{m,}' '{m,n}' — returns None when not a valid brace
        # (POSIX treats a stray '{' as a literal).
        assert self.take() == "{"
        num = ""
        while self.peek() is not None and self.peek().isdigit():
            num += self.take()
        if not num:
            return None
        lo = int(num)
        hi: Optional[int] = lo
        if self.peek() == ",":
            self.take()
            num2 = ""
            while self.peek() is not None and self.peek().isdigit():
                num2 += self.take()
            hi = int(num2) if num2 else None  # {m,} = unbounded
        if self.peek() != "}":
            return None
        self.take()
        bound = hi if hi is not None else lo
        if (hi is not None and hi < lo) or bound > MAX_REPEAT:
            raise RegexError(f"repeat bound too large (max {MAX_REPEAT})")
        return lo, hi

    # -- fragment combinators ------------------------------------------
    def _star(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, frag[0])
        self.nfa.add_eps(frag[1], e)
        self.nfa.add_eps(s, e)
        self.nfa.add_eps(frag[1], frag[0])
        return s, e

    def _clone(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        """Deep-copy the subgraph reachable from frag start (bounded by
        construction: quantified atoms are parsed before cloning)."""
        mapping: Dict[int, int] = {}
        stack = [frag[0]]
        reach = set()
        while stack:
            s = stack.pop()
            if s in reach:
                continue
            reach.add(s)
            for tgts in self.nfa.trans[s].values():
                stack.extend(tgts)
            stack.extend(self.nfa.eps[s])
        for s in reach:
            mapping[s] = self.nfa.new_state()
        for s in reach:
            for byte, tgts in self.nfa.trans[s].items():
                for t in tgts:
                    if t in mapping:
                        self.nfa.add_byte(mapping[s], byte, mapping[t])
            for t in self.nfa.eps[s]:
                if t in mapping:
                    self.nfa.add_eps(mapping[s], mapping[t])
        return mapping[frag[0]], mapping[frag[1]]

    def _repeat_range(
        self, frag: Tuple[int, int], lo: int, hi: Optional[int]
    ) -> Tuple[int, int]:
        """{lo,hi} expansion; hi None = unbounded ({m,} → m copies with
        a trailing star)."""
        s = self.nfa.new_state()
        e = self.nfa.new_state()
        n_copies = hi if hi is not None else max(lo, 1)
        if n_copies == 0:  # {0} / {0,0} matches only the empty string
            self.nfa.add_eps(s, e)
            return s, e
        parts = [frag] + [self._clone(frag) for _ in range(n_copies - 1)]
        self.nfa.add_eps(s, parts[0][0])
        for (a_s, a_e), (b_s, b_e) in zip(parts, parts[1:]):
            self.nfa.add_eps(a_e, b_s)
        self.nfa.add_eps(parts[-1][1], e)
        if hi is None:
            # unbounded tail: loop the last copy
            self.nfa.add_eps(parts[-1][1], parts[-1][0])
        # optional tail: copies beyond `lo` may exit early
        if lo == 0:
            self.nfa.add_eps(s, e)
        for idx in range(max(lo, 1), n_copies):
            self.nfa.add_eps(parts[idx - 1][1], e)
        return s, e

    # -- atoms ----------------------------------------------------------
    def atom(self) -> Tuple[int, int]:
        c = self.peek()
        if c is None or c in "*+?|)":
            raise RegexError(f"unexpected {c!r} at {self.i}")
        if c == "(":
            self.take()
            frag = self.alt()
            if self.peek() != ")":
                raise RegexError("unbalanced parenthesis")
            self.take()
            return frag
        if c == "[":
            return self._char_class()
        if c == ".":
            self.take()
            return self._byte_set(set(range(ALPHABET)) - {0x0A})
        if c == "\\":
            self.take()
            if self.peek() is None:
                raise RegexError("trailing backslash")
            return self._escape(self.take())
        if c in ("^", "$"):
            # Anchors are implicit (full match); explicit ones at the
            # edges are accepted as no-ops for Go-pattern compatibility.
            self.take()
            s = self.nfa.new_state()
            return s, s
        self.take()
        return self._byte_set({ord(c)})

    def _escape(self, c: str) -> Tuple[int, int]:
        cls = _class_for_escape(c)
        if cls is not None:
            return self._byte_set(cls)
        return self._byte_set({ord(c)})

    def _char_class(self) -> Tuple[int, int]:
        assert self.take() == "["
        negate = False
        if self.peek() == "^":
            negate = True
            self.take()
        chars: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unbalanced character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            self.take()
            if c == "\\":
                nxt = self.take()
                cls = _class_for_escape(nxt)
                if cls is not None:
                    chars |= cls
                    continue
                cv = ord(nxt)
            else:
                cv = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.take()
                hi_c = self.take()
                if hi_c == "\\":
                    hi_c = self.take()
                for b in range(cv, ord(hi_c) + 1):
                    chars.add(b)
            else:
                chars.add(cv)
        if negate:
            chars = set(range(ALPHABET)) - chars
        return self._byte_set(chars)

    def _byte_set(self, bytes_: Set[int]) -> Tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for b in bytes_:
            self.nfa.add_byte(s, b, e)
        return s, e


def nfa_from_regex(pattern: str, nfa: Optional[_NFA] = None) -> Tuple[_NFA, int, int]:
    nfa = nfa or _NFA()
    start, end = _Parser(pattern, nfa).parse()
    return nfa, start, end


# -- subset construction ----------------------------------------------------


@dataclasses.dataclass
class MultiDFA:
    """Combined DFA: ``trans [Q, 256] int32`` (state 0 = dead sink),
    ``accept [Q] uint64`` pattern bitmask (bit i = pattern i accepts),
    ``start`` state id."""

    trans: np.ndarray
    accept: np.ndarray
    start: int
    n_patterns: int

    def match_str(self, s: bytes) -> int:
        """Host-side walk → accept bitmask (for tests/fallback)."""
        q = self.start
        for b in s:
            q = int(self.trans[q, b])
            if q == 0:
                return 0
        return int(self.accept[q])


def compile_patterns(patterns: Sequence[str], max_states: int = MAX_DFA_STATES) -> MultiDFA:
    """Compile ≤64 anchored patterns into one multi-accept DFA."""
    if len(patterns) > 64:
        raise RegexError("at most 64 patterns per DFA (accept bitmask is u64)")
    nfa = _NFA()
    starts: List[int] = []
    ends: Dict[int, int] = {}  # nfa end state → pattern idx
    for idx, p in enumerate(patterns):
        _, s, e = nfa_from_regex(p, nfa)
        starts.append(s)
        ends[e] = idx

    def eclose(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = eclose(frozenset(starts))
    # DFA state 0 = dead sink; real states from 1.
    ids: Dict[FrozenSet[int], int] = {start_set: 1}
    table: List[List[int]] = [[0] * ALPHABET, [0] * ALPHABET]
    accepts: List[int] = [0, _accept_mask(start_set, ends)]
    work = [start_set]
    while work:
        cur = work.pop()
        cur_id = ids[cur]
        by_byte: Dict[int, Set[int]] = {}
        for s in cur:
            for byte, tgts in nfa.trans[s].items():
                by_byte.setdefault(byte, set()).update(tgts)
        for byte, tgts in by_byte.items():
            nxt = eclose(frozenset(tgts))
            nid = ids.get(nxt)
            if nid is None:
                nid = len(table)
                if nid > max_states:
                    raise RegexError(f"DFA state cap exceeded ({max_states})")
                ids[nxt] = nid
                table.append([0] * ALPHABET)
                accepts.append(_accept_mask(nxt, ends))
                work.append(nxt)
            table[cur_id][byte] = nid
    return MultiDFA(
        trans=np.asarray(table, np.int32),
        accept=np.asarray(accepts, np.uint64),
        start=1,
        n_patterns=len(patterns),
    )


def _accept_mask(states: FrozenSet[int], ends: Dict[int, int]) -> int:
    mask = 0
    for s in states:
        idx = ends.get(s)
        if idx is not None:
            mask |= 1 << idx
    return mask


# -- compile interning ------------------------------------------------------
# Subset construction is the expensive half of policy compile; N
# endpoints with the same rule set produce the same pattern tuples, so
# the host MultiDFA is interned by (patterns, max_states) — the same
# content-addressed discipline ops.dfa uses for the device tables.
# Successes only: a RegexError must re-raise per call site (demotion
# probing in http_policy depends on it).
_COMPILE_CACHE_CAP = 256
_compile_lock = threading.Lock()
_compile_cache: "OrderedDict[Tuple, MultiDFA]" = OrderedDict()


def compile_patterns_cached(
    patterns: Sequence[str], max_states: int = MAX_DFA_STATES
) -> MultiDFA:
    """``compile_patterns`` with an interned result. Callers must
    treat the returned MultiDFA as immutable — it is shared."""
    key = (tuple(patterns), max_states)
    with _compile_lock:
        hit = _compile_cache.get(key)
        if hit is not None:
            _compile_cache.move_to_end(key)
            return hit
    built = compile_patterns(patterns, max_states)
    with _compile_lock:
        raced = _compile_cache.get(key)
        if raced is not None:
            _compile_cache.move_to_end(key)
            return raced
        _compile_cache[key] = built
        while len(_compile_cache) > _COMPILE_CACHE_CAP:
            _compile_cache.popitem(last=False)
    return built
