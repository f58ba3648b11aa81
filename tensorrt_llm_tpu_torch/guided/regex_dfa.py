"""Byte-level regex → NFA → DFA compiler for guided decoding.

Port of ``tensorrt_llm_tpu/guided/regex_dfa.py``, unchanged (pure
Python and numpy).

Self-contained replacement for the xgrammar/llguidance matcher backends
(reference: tensorrt_llm/_torch/pyexecutor/grammar_matcher.py:4-7 — the
engine compiles constraints to per-state token bitmasks; kernel side
cpp/tensorrt_llm/kernels/logitsBitmask.cu). The supported regex subset:

    literals, '.', escapes (\\d \\w \\s \\n \\t \\r \\\\ etc.),
    classes [a-z0-9_] and negation [^...], grouping (...), alternation |,
    quantifiers * + ? and bounded {m,n}.

Compilation: Thompson NFA → subset-construction DFA over the 256-byte
alphabet. Token masks are computed *vectorized*: all vocab tokens' UTF-8
bytes sit in one [V, Lmax] matrix and the DFA transition table is applied
Lmax times with numpy gathers — per decoding step the mask for a DFA
state costs O(V·Lmax) table lookups and is cached per state.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

DEAD = -1


# --------------------------------------------------------------------- #
# Parsing to NFA (Thompson construction)
# --------------------------------------------------------------------- #
class _NFA:
    def __init__(self):
        self.transitions: List[Dict[int, Set[int]]] = []   # state -> byte -> states
        self.eps: List[Set[int]] = []                      # epsilon moves

    def new_state(self) -> int:
        self.transitions.append({})
        self.eps.append(set())
        return len(self.transitions) - 1

    def add(self, s: int, byte: int, t: int):
        self.transitions[s].setdefault(byte, set()).add(t)

    def add_eps(self, s: int, t: int):
        self.eps[s].add(t)


_CLASS_ESCAPES = {
    "d": set(range(0x30, 0x3A)),
    "w": set(range(0x30, 0x3A)) | set(range(0x41, 0x5B))
         | set(range(0x61, 0x7B)) | {0x5F},
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B},
    "n": {0x0A}, "t": {0x09}, "r": {0x0D},
}


def _escape_set(ch: str) -> Set[int]:
    if ch in _CLASS_ESCAPES:
        return set(_CLASS_ESCAPES[ch])
    if ch in ("D", "W", "S"):
        return set(range(256)) - _CLASS_ESCAPES[ch.lower()]
    return {ord(ch) & 0xFF} if ord(ch) < 256 else set()


class _Parser:
    """Recursive-descent regex parser building NFA fragments
    (fragment = (start, accept))."""

    def __init__(self, pattern: str, nfa: Optional["_NFA"] = None):
        self.p = pattern
        self.i = 0
        self.nfa = nfa if nfa is not None else _NFA()

    def parse(self) -> Tuple[int, int]:
        frag = self._alternation()
        if self.i != len(self.p):
            raise ValueError(f"unexpected '{self.p[self.i]}' at {self.i}")
        return frag

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _parse_escape(self) -> Set[int]:
        """Consume the char(s) after a backslash; supports \\xNN hex."""
        ch = self._next()
        if ch == "x":
            hex_digits = self._next() + self._next()
            return {int(hex_digits, 16)}
        return _escape_set(ch)

    def _next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def _alternation(self):
        frags = [self._concat()]
        while self._peek() == "|":
            self._next()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, a = self.nfa.new_state(), self.nfa.new_state()
        for fs, fa in frags:
            self.nfa.add_eps(s, fs)
            self.nfa.add_eps(fa, a)
        return s, a

    def _concat(self):
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._quantified())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        start, acc = frags[0]
        for fs, fa in frags[1:]:
            self.nfa.add_eps(acc, fs)
            acc = fa
        return start, acc

    def _quantified(self):
        frag = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self._next()
                frag = self._star(frag)
            elif ch == "+":
                self._next()
                fs, fa = frag
                st = self._star(self._clone(frag))
                self.nfa.add_eps(fa, st[0])
                frag = (fs, st[1])
            elif ch == "?":
                self._next()
                fs, fa = frag
                self.nfa.add_eps(fs, fa)
                frag = (fs, fa)
            elif ch == "{":
                frag = self._bounded(frag)
            else:
                return frag

    def _star(self, frag):
        fs, fa = frag
        s, a = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, fs)
        self.nfa.add_eps(s, a)
        self.nfa.add_eps(fa, fs)
        self.nfa.add_eps(fa, a)
        return s, a

    def _clone(self, frag):
        """Clone the sub-NFA reachable from frag (for + / {m,n})."""
        fs, fa = frag
        mapping: Dict[int, int] = {}
        stack = [fs]
        mapping[fs] = self.nfa.new_state()
        while stack:
            s = stack.pop()
            for byte, targets in list(self.nfa.transitions[s].items()):
                for t in targets:
                    if t not in mapping:
                        mapping[t] = self.nfa.new_state()
                        stack.append(t)
                    self.nfa.add(mapping[s], byte, mapping[t])
            for t in list(self.nfa.eps[s]):
                if t not in mapping:
                    mapping[t] = self.nfa.new_state()
                    stack.append(t)
                self.nfa.add_eps(mapping[s], mapping[t])
        if fa not in mapping:
            mapping[fa] = self.nfa.new_state()
        return mapping[fs], mapping[fa]

    def _bounded(self, frag):
        # {m}, {m,}, {m,n}
        assert self._next() == "{"
        num = ""
        while self._peek() and self._peek().isdigit():
            num += self._next()
        m = int(num or 0)
        n = m
        if self._peek() == ",":
            self._next()
            num2 = ""
            while self._peek() and self._peek().isdigit():
                num2 += self._next()
            n = int(num2) if num2 else -1
        if self._next() != "}":
            raise ValueError("unterminated {}")
        if n != -1 and n < m:
            raise ValueError("bad bounds {m,n}")
        # Pre-clone EVERY copy from the pristine fragment BEFORE any
        # wiring. _clone copies everything *reachable*, so cloning
        # after copy k was chained in swallowed copies 1..k into copy
        # k+1 — a quadratic-and-worse NFA blowup that made {0,64}
        # string bounds uncompilable (minutes -> ms with pre-cloning).
        unbounded = n == -1
        ncopies = m if unbounded else n
        copies = []
        if ncopies > 0:
            copies = [frag] + [self._clone(frag)
                               for _ in range(ncopies - 1)]
        tail_star = self._clone(frag) if unbounded else None
        start = self.nfa.new_state()
        acc = start
        for i in range(m):
            fs, fa = copies[i]
            self.nfa.add_eps(acc, fs)
            acc = fa
        if unbounded:
            st = self._star(tail_star)
            self.nfa.add_eps(acc, st[0])
            return start, st[1]
        end = self.nfa.new_state()
        for i in range(m, n):
            fs, fa = copies[i]
            self.nfa.add_eps(acc, end)     # stop before this copy
            self.nfa.add_eps(acc, fs)
            acc = fa
        self.nfa.add_eps(acc, end)
        return start, end

    def _atom(self):
        ch = self._next()
        nfa = self.nfa
        if ch == "(":
            frag = self._alternation()
            if self._next() != ")":
                raise ValueError("unbalanced parens")
            return frag
        if ch == "[":
            return self._char_class()
        s, a = nfa.new_state(), nfa.new_state()
        if ch == ".":
            for b in range(256):
                if b != 0x0A:
                    nfa.add(s, b, a)
        elif ch == "\\":
            for b in self._parse_escape():
                nfa.add(s, b, a)
        else:
            data = ch.encode("utf-8")
            cur = s
            for i, b in enumerate(data):
                nxt = a if i == len(data) - 1 else nfa.new_state()
                nfa.add(cur, b, nxt)
                cur = nxt
        return s, a

    def _char_class(self):
        nfa = self.nfa
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        allowed: Set[int] = set()
        prev: Optional[int] = None
        while True:
            ch = self._next()
            if ch == "]":
                break
            if ch == "\\":
                esc = self._parse_escape()
                allowed |= esc
                # single-byte escapes can anchor a range (e.g. \x00-\x1f)
                prev = next(iter(esc)) if len(esc) == 1 else None
                continue
            if ch == "-" and prev is not None and self._peek() not in (None, "]"):
                hi_ch = self._next()
                if hi_ch == "\\":
                    esc = self._parse_escape()
                    hi = next(iter(esc)) if len(esc) == 1 else prev
                else:
                    hi = ord(hi_ch)
                allowed |= set(range(prev, hi + 1))
                prev = None
                continue
            b = ord(ch)
            if b < 256:
                allowed.add(b)
            else:
                for bb in ch.encode("utf-8"):
                    allowed.add(bb)
            prev = b if b < 256 else None
        if negate:
            allowed = set(range(256)) - allowed
        s, a = nfa.new_state(), nfa.new_state()
        for b in allowed:
            nfa.add(s, b, a)
        return s, a


# --------------------------------------------------------------------- #
# DFA (subset construction) + vectorized token masks
# --------------------------------------------------------------------- #
class DFA:
    def __init__(self, table: np.ndarray, accepting: np.ndarray,
                 start: int):
        self.table = table          # i32[nstates, 256]; DEAD = -1
        self.accepting = accepting  # bool[nstates]
        self.start = start

    @property
    def num_states(self) -> int:
        return self.table.shape[0]


def compile_regex(pattern: str, max_states: int = 40000) -> DFA:
    parser = _Parser(pattern)
    start, accept = parser.parse()
    return determinize(parser.nfa, start, {accept}, max_states)


def determinize(nfa: "_NFA", start: int, accepts: Set[int],
                max_states: int = 20000) -> DFA:
    """Subset construction over an arbitrary NFA (programmatically built
    fragments — structural tags — share this path with parsed regexes)."""

    def closure(states: frozenset) -> frozenset:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    index: Dict[frozenset, int] = {start_set: 0}
    rows: List[np.ndarray] = []
    accepting: List[bool] = []
    work = [start_set]
    while work:
        cur = work.pop()
        i = index[cur]
        while len(rows) <= i:
            rows.append(np.full(256, DEAD, np.int32))
            accepting.append(False)
        accepting[i] = bool(accepts & cur)
        moves: Dict[int, Set[int]] = {}
        for s in cur:
            for byte, targets in nfa.transitions[s].items():
                moves.setdefault(byte, set()).update(targets)
        for byte, targets in moves.items():
            nxt = closure(frozenset(targets))
            if nxt not in index:
                if len(index) >= max_states:
                    raise ValueError("regex DFA too large")
                index[nxt] = len(index)
                work.append(nxt)
            rows[i][byte] = index[nxt]
    table = np.stack(rows)
    acc = np.asarray(accepting, bool)
    # pad rows for states discovered but whose rows index beyond current
    if table.shape[0] < len(index):
        extra = len(index) - table.shape[0]
        table = np.concatenate(
            [table, np.full((extra, 256), DEAD, np.int32)])
        acc = np.concatenate([acc, np.zeros(extra, bool)])
    return DFA(table, acc, 0)


class TokenMaskCache:
    """Per-DFA-state vocab bitmasks, computed vectorized and cached."""

    def __init__(self, dfa: DFA, token_bytes: np.ndarray,
                 token_lens: np.ndarray):
        self.dfa = dfa
        self.token_bytes = token_bytes    # u8[V, Lmax]
        self.token_lens = token_lens      # i32[V]
        self._cache: Dict[int, np.ndarray] = {}
        # final-state cache: state after consuming token from dfa state
        self._final: Dict[int, np.ndarray] = {}

    def final_states(self, state: int) -> np.ndarray:
        """DFA state after consuming each token from ``state`` (DEAD=-1)."""
        if state in self._final:
            return self._final[state]
        V, L = self.token_bytes.shape
        cur = np.full(V, state, np.int64)
        table = self.dfa.table
        for j in range(L):
            active = self.token_lens > j
            alive = (cur >= 0) & active
            nxt = np.where(alive, table[np.clip(cur, 0, None),
                                        self.token_bytes[:, j]], cur)
            cur = np.where(active, np.where(cur >= 0, nxt, DEAD), cur)
        cur = cur.astype(np.int32)
        self._final[state] = cur
        return cur

    def mask(self, state: int) -> np.ndarray:
        """bool[V]: tokens whose bytes keep the DFA alive from ``state``."""
        if state not in self._cache:
            fin = self.final_states(state)
            m = (fin != DEAD) & (self.token_lens > 0)
            self._cache[state] = m
        return self._cache[state]


# --------------------------------------------------------------------- #
# Structural tags (reference: xgrammar structural_tag via
# grammar_matcher.py): free text until a begin tag appears, then
# constrained content, the end tag, then free text again — repeatable.
# The free-text scanner is an Aho–Corasick automaton over the begin
# literals embedded as deterministic NFA states, so emitting any begin
# tag FORCES the matcher into that structure's content DFA.
# --------------------------------------------------------------------- #
def _aho_corasick(literals: List[bytes]):
    """Byte-level AC automaton: returns (delta, terminal) where
    delta[node][byte] -> node and terminal[node] is the pattern index
    completed at (or via suffix of) that node, else -1."""
    goto: List[Dict[int, int]] = [{}]
    term: List[int] = [-1]
    for idx, lit in enumerate(literals):
        node = 0
        for b in lit:
            nxt = goto[node].get(b)
            if nxt is None:
                nxt = len(goto)
                goto[node][b] = nxt
                goto.append({})
                term.append(-1)
            node = nxt
        term[node] = idx
    # BFS failure links
    from collections import deque
    fail = [0] * len(goto)
    dq = deque(goto[0].values())
    while dq:
        u = dq.popleft()
        for b, v in goto[u].items():
            dq.append(v)
            f = fail[u]
            while f and b not in goto[f]:
                f = fail[f]
            fail[v] = goto[f].get(b, 0) if goto[f].get(b, 0) != v else 0
            if term[fail[v]] >= 0 and term[v] < 0:
                term[v] = term[fail[v]]
    # resolved transitions
    delta = []
    for u in range(len(goto)):
        row = {}
        for b in range(256):
            n = u
            while n and b not in goto[n]:
                n = fail[n]
            row[b] = goto[n].get(b, 0)
        delta.append(row)
    return delta, term


def build_structural_dfa(structures: List[Tuple[str, Optional[str], str]],
                         max_states: int = 20000) -> DFA:
    """``structures``: (begin, content_regex_or_None, end) triples.
    None content = unconstrained until the end literal (scan for it)."""
    nfa = _NFA()
    begins = [s[0].encode() for s in structures]
    delta, term = _aho_corasick(begins)
    base = [nfa.new_state() for _ in delta]       # scan states

    content_starts: List[int] = []
    for begin, content, end in structures:
        if content:
            p = _Parser(content, nfa)
            c_start, c_acc = p.parse()
        else:
            # scan-until-end: AC over the single end literal
            d2, t2 = _aho_corasick([end.encode()])
            sub = [nfa.new_state() for _ in d2]
            for u, row in enumerate(d2):
                if t2[u] >= 0:
                    continue
                for b, v in row.items():
                    nfa.add(sub[u], b, sub[v])
            c_start = sub[0]
            c_acc = sub[[i for i, t in enumerate(t2) if t >= 0][0]]
            content_starts.append(c_start)
            # end literal already consumed by the scan: loop back
            nfa.add_eps(c_acc, base[0])
            continue
        content_starts.append(c_start)
        prev = c_acc
        for b in end.encode():
            nxt = nfa.new_state()
            nfa.add(prev, b, nxt)
            prev = nxt
        nfa.add_eps(prev, base[0])                # repeatable

    for u, row in enumerate(delta):
        if term[u] >= 0:
            # completing a begin tag forces that structure's content
            nfa.add_eps(base[u], content_starts[term[u]])
            continue
        for b, v in row.items():
            nfa.add(base[u], b, base[v])

    accepts = {base[u] for u in range(len(delta)) if term[u] < 0}
    return determinize(nfa, base[0], accepts, max_states)
