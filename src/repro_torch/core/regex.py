"""Regex engine: parse -> NFA (Thompson) -> DFA (subset construction).

Byte-alphabet (0..255). Supports the subset needed for grammar terminals:
literals, escapes (\\d \\w \\s \\n \\t \\r \\f \\. etc.), char classes
[a-z0-9_] and negations [^...], '.', alternation '|', grouping '(...)',
quantifiers * + ? {m} {m,} {m,n}, and a case-insensitive flag (for "SELECT"i
style literal terminals).

DFAs carry numpy transition tables [num_states, 256] for vectorized walks
(used heavily by the mask-store construction).
"""
from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field
from typing import Optional

ALPHABET = 256
DOT_EXCLUDES = frozenset(b"\n")  # '.' matches everything except newline


# --------------------------------------------------------------------------
# Regex AST
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class RNode:
    pass


@dataclass(frozen=True)
class RChars(RNode):
    """A set of byte values (char class / literal char)."""
    chars: frozenset


@dataclass(frozen=True)
class RConcat(RNode):
    parts: tuple


@dataclass(frozen=True)
class RAlt(RNode):
    options: tuple


@dataclass(frozen=True)
class RStar(RNode):
    inner: RNode


@dataclass(frozen=True)
class RPlus(RNode):
    inner: RNode


@dataclass(frozen=True)
class ROpt(RNode):
    inner: RNode


@dataclass(frozen=True)
class REpsilon(RNode):
    pass


_CLASS_SHORTCUTS = {
    ord("d"): frozenset(range(ord("0"), ord("9") + 1)),
    ord("w"): frozenset(
        list(range(ord("a"), ord("z") + 1))
        + list(range(ord("A"), ord("Z") + 1))
        + list(range(ord("0"), ord("9") + 1))
        + [ord("_")]
    ),
    ord("s"): frozenset(b" \t\n\r\f\v"),
}
_ESCAPES = {
    ord("n"): ord("\n"),
    ord("t"): ord("\t"),
    ord("r"): ord("\r"),
    ord("f"): ord("\f"),
    ord("v"): ord("\v"),
    ord("0"): 0,
    ord("a"): 7,
    ord("b"): 8,
}


class RegexSyntaxError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: bytes, ignore_case: bool = False):
        self.p = pattern
        self.i = 0
        self.ignore_case = ignore_case

    def peek(self) -> Optional[int]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> int:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> RNode:
        node = self.parse_alt()
        if self.i != len(self.p):
            raise RegexSyntaxError(f"trailing input at {self.i} in {self.p!r}")
        return node

    def parse_alt(self) -> RNode:
        opts = [self.parse_concat()]
        while self.peek() == ord("|"):
            self.next()
            opts.append(self.parse_concat())
        if len(opts) == 1:
            return opts[0]
        return RAlt(tuple(opts))

    def parse_concat(self) -> RNode:
        parts = []
        while True:
            c = self.peek()
            if c is None or c in (ord("|"), ord(")")):
                break
            parts.append(self.parse_quant())
        if not parts:
            return REpsilon()
        if len(parts) == 1:
            return parts[0]
        return RConcat(tuple(parts))

    def parse_quant(self) -> RNode:
        atom = self.parse_atom()
        while True:
            c = self.peek()
            if c == ord("*"):
                self.next()
                atom = RStar(atom)
            elif c == ord("+"):
                self.next()
                atom = RPlus(atom)
            elif c == ord("?"):
                self.next()
                atom = ROpt(atom)
            elif c == ord("{"):
                save = self.i
                rep = self._try_repeat()
                if rep is None:
                    self.i = save
                    break
                lo, hi = rep
                atom = self._expand_repeat(atom, lo, hi)
            else:
                break
        return atom

    def _try_repeat(self):
        # at '{'
        self.next()
        num1 = b""
        while self.peek() is not None and ord("0") <= self.peek() <= ord("9"):
            num1 += bytes([self.next()])
        if not num1:
            return None
        if self.peek() == ord("}"):
            self.next()
            n = int(num1)
            return (n, n)
        if self.peek() != ord(","):
            return None
        self.next()
        num2 = b""
        while self.peek() is not None and ord("0") <= self.peek() <= ord("9"):
            num2 += bytes([self.next()])
        if self.peek() != ord("}"):
            return None
        self.next()
        return (int(num1), int(num2) if num2 else None)

    @staticmethod
    def _expand_repeat(atom: RNode, lo: int, hi: Optional[int]) -> RNode:
        parts = [atom] * lo
        if hi is None:
            parts.append(RStar(atom))
        else:
            parts.extend([ROpt(atom)] * (hi - lo))
        if not parts:
            return REpsilon()
        if len(parts) == 1:
            return parts[0]
        return RConcat(tuple(parts))

    def _maybe_fold_case(self, chars: frozenset) -> frozenset:
        if not self.ignore_case:
            return chars
        out = set(chars)
        for c in chars:
            if ord("a") <= c <= ord("z"):
                out.add(c - 32)
            elif ord("A") <= c <= ord("Z"):
                out.add(c + 32)
        return frozenset(out)

    def parse_atom(self) -> RNode:
        c = self.peek()
        if c is None:
            return REpsilon()
        if c == ord("("):
            self.next()
            # swallow non-capturing / flags prefix (?: (?i: etc. -- treat as group
            if self.peek() == ord("?"):
                self.next()
                while self.peek() is not None and self.peek() != ord(")") and self.peek() != ord(":"):
                    self.next()
                if self.peek() == ord(":"):
                    self.next()
            node = self.parse_alt()
            if self.peek() != ord(")"):
                raise RegexSyntaxError(f"unbalanced paren in {self.p!r}")
            self.next()
            return node
        if c == ord("["):
            return self.parse_class()
        if c == ord("."):
            self.next()
            return RChars(frozenset(set(range(ALPHABET)) - set(DOT_EXCLUDES)))
        if c == ord("\\"):
            self.next()
            e = self.next()
            if e in _CLASS_SHORTCUTS:
                return RChars(self._maybe_fold_case(_CLASS_SHORTCUTS[e]))
            if e in (ord("D"), ord("W"), ord("S")):
                base = _CLASS_SHORTCUTS[e + 32]
                return RChars(frozenset(set(range(ALPHABET)) - set(base)))
            if e == ord("x"):
                lit = int(bytes([self.next(), self.next()]).decode(), 16)
                return RChars(frozenset([lit]))
            lit = _ESCAPES.get(e, e)
            return RChars(self._maybe_fold_case(frozenset([lit])))
        if c in (ord("*"), ord("+"), ord("?"), ord(")")):
            raise RegexSyntaxError(f"unexpected {chr(c)!r} at {self.i} in {self.p!r}")
        self.next()
        return RChars(self._maybe_fold_case(frozenset([c])))

    def parse_class(self) -> RNode:
        self.next()  # '['
        negate = False
        if self.peek() == ord("^"):
            negate = True
            self.next()
        chars: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexSyntaxError(f"unterminated class in {self.p!r}")
            if c == ord("]") and not first:
                self.next()
                break
            first = False
            if c == ord("\\"):
                self.next()
                e = self.next()
                if e in _CLASS_SHORTCUTS:
                    chars |= set(_CLASS_SHORTCUTS[e])
                    continue
                if e == ord("x"):
                    lo = int(bytes([self.next(), self.next()]).decode(), 16)
                else:
                    lo = _ESCAPES.get(e, e)
            else:
                self.next()
                lo = c
            if self.peek() == ord("-") and self.i + 1 < len(self.p) and self.p[self.i + 1] != ord("]"):
                self.next()
                c2 = self.peek()
                if c2 == ord("\\"):
                    self.next()
                    e2 = self.next()
                    if e2 == ord("x"):
                        hi = int(bytes([self.next(), self.next()]).decode(), 16)
                    else:
                        hi = _ESCAPES.get(e2, e2)
                else:
                    self.next()
                    hi = c2
                chars |= set(range(lo, hi + 1))
            else:
                chars.add(lo)
        if negate:
            chars = set(range(ALPHABET)) - chars
        return RChars(self._maybe_fold_case(frozenset(chars)))


def parse_regex(pattern: str | bytes, ignore_case: bool = False) -> RNode:
    if isinstance(pattern, str):
        pattern = pattern.encode("utf-8")
    return _Parser(pattern, ignore_case=ignore_case).parse()


def literal_regex(text: str | bytes, ignore_case: bool = False) -> RNode:
    """AST matching exactly `text` (optionally case-insensitively)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    parts = []
    for c in text:
        chars = frozenset([c])
        if ignore_case:
            if ord("a") <= c <= ord("z"):
                chars = frozenset([c, c - 32])
            elif ord("A") <= c <= ord("Z"):
                chars = frozenset([c, c + 32])
        parts.append(RChars(chars))
    if not parts:
        return REpsilon()
    if len(parts) == 1:
        return parts[0]
    return RConcat(tuple(parts))


# --------------------------------------------------------------------------
# NFA (Thompson construction)
# --------------------------------------------------------------------------

class NFA:
    def __init__(self):
        self.eps: list[list[int]] = []          # state -> eps successors
        self.trans: list[list[tuple[frozenset, int]]] = []  # state -> [(chars, succ)]
        self.start = self.new_state()
        self.accept: int = -1

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int):
        self.eps[a].append(b)

    def add_trans(self, a: int, chars: frozenset, b: int):
        self.trans[a].append((chars, b))


def _build(nfa: NFA, node: RNode, entry: int) -> int:
    """Wire `node` starting at state `entry`; return exit state."""
    if isinstance(node, REpsilon):
        return entry
    if isinstance(node, RChars):
        out = nfa.new_state()
        nfa.add_trans(entry, node.chars, out)
        return out
    if isinstance(node, RConcat):
        cur = entry
        for part in node.parts:
            cur = _build(nfa, part, cur)
        return cur
    if isinstance(node, RAlt):
        out = nfa.new_state()
        for opt in node.options:
            s = nfa.new_state()
            nfa.add_eps(entry, s)
            e = _build(nfa, opt, s)
            nfa.add_eps(e, out)
        return out
    if isinstance(node, RStar):
        hub = nfa.new_state()
        nfa.add_eps(entry, hub)
        e = _build(nfa, node.inner, hub)
        nfa.add_eps(e, hub)
        return hub
    if isinstance(node, RPlus):
        e = _build(nfa, node.inner, entry)
        # loop: from e back via inner again
        hub = nfa.new_state()
        nfa.add_eps(e, hub)
        e2 = _build(nfa, node.inner, hub)
        nfa.add_eps(e2, hub)
        return hub
    if isinstance(node, ROpt):
        out = nfa.new_state()
        nfa.add_eps(entry, out)
        e = _build(nfa, node.inner, entry)
        nfa.add_eps(e, out)
        return out
    raise TypeError(node)


def nfa_from_ast(node: RNode) -> NFA:
    nfa = NFA()
    nfa.accept = _build(nfa, node, nfa.start)
    return nfa


# --------------------------------------------------------------------------
# DFA (subset construction over byte equivalence classes)
# --------------------------------------------------------------------------

class DFA:
    """Deterministic finite automaton over bytes.

    trans: np.ndarray [num_states, 256] int32 (DEAD = num_states-th implicit? no:
           dead state is an explicit state with all-self transitions and not live)
    """

    def __init__(self, trans: np.ndarray, start: int, finals: np.ndarray):
        self.trans = trans                  # [Q, 256] int32
        self.start = int(start)
        self.finals = finals.astype(bool)   # [Q]
        self.live = self._compute_live()    # [Q] bool

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def _compute_live(self) -> np.ndarray:
        Q = self.num_states
        live = self.finals.copy()
        # reverse reachability from finals
        # build reverse adjacency once
        radj: list[set] = [set() for _ in range(Q)]
        for q in range(Q):
            for s in set(self.trans[q].tolist()):
                radj[s].add(q)
        frontier = [q for q in range(Q) if live[q]]
        while frontier:
            nxt = []
            for q in frontier:
                for p in radj[q]:
                    if not live[p]:
                        live[p] = True
                        nxt.append(p)
            frontier = nxt
        return live

    def step(self, q: int, byte: int) -> int:
        return int(self.trans[q, byte])

    def walk(self, q: int, data: bytes) -> int:
        for b in data:
            q = int(self.trans[q, b])
        return q

    def accepts(self, data: bytes) -> bool:
        return bool(self.finals[self.walk(self.start, data)])

    def is_live(self, q: int) -> bool:
        return bool(self.live[q])

    def walk_live(self, q: int, data: bytes) -> int:
        """Walk, stopping early in the dead sink if we fall out of live states."""
        for b in data:
            q = int(self.trans[q, b])
            if not self.live[q]:
                return q
        return q


def dfa_from_nfa(nfa: NFA) -> DFA:
    """Subset construction. Returns DFA whose state 0 is the start; the last
    state index may be a dead sink (all transitions self, non-final)."""
    n = len(nfa.eps)

    # epsilon closures
    import collections
    eclo: list[frozenset] = []
    for s in range(n):
        seen = {s}
        stack = [s]
        while stack:
            x = stack.pop()
            for y in nfa.eps[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        eclo.append(frozenset(seen))

    start_set = eclo[nfa.start]
    state_ids: dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    queue = collections.deque([start_set])

    # Precompute per-NFA-state char transition as (mask over 256, succ)
    while queue:
        cur = queue.popleft()
        # For each byte, target set
        row = np.full(ALPHABET, -1, dtype=np.int64)
        # gather moves: char -> set of targets. Use numpy mask accumulation.
        move: dict[int, set] = {}
        for s in cur:
            for chars, succ in nfa.trans[s]:
                for c in chars:
                    move.setdefault(c, set()).update(eclo[succ])
        # canonicalize target sets
        cache: dict[frozenset, int] = {}
        for c, tgt in move.items():
            ftgt = frozenset(tgt)
            if ftgt in cache:
                row[c] = cache[ftgt]
                continue
            if ftgt not in state_ids:
                state_ids[ftgt] = len(order)
                order.append(ftgt)
                queue.append(ftgt)
            row[c] = state_ids[ftgt]
            cache[ftgt] = row[c]
        rows.append(row)

    Q = len(order)
    dead = Q  # dead sink
    trans = np.full((Q + 1, ALPHABET), dead, dtype=np.int32)
    for q, row in enumerate(rows):
        valid = row >= 0
        trans[q, valid] = row[valid]
    finals = np.zeros(Q + 1, dtype=bool)
    for q, st in enumerate(order):
        if nfa.accept in st:
            finals[q] = True
    return DFA(trans, 0, finals)


def minimize(dfa: DFA) -> DFA:
    """Moore partition refinement (fine for our state counts)."""
    Q = dfa.num_states
    # initial partition: final vs non-final (and keep dead separate implicitly)
    part = dfa.finals.astype(np.int64).copy()
    nparts = 2
    while True:
        # signature: (part, parts of successors for each byte) -- hash rows
        succ_parts = part[dfa.trans]  # [Q, 256]
        sig = np.concatenate([part[:, None], succ_parts], axis=1)
        _, new_part = np.unique(sig, axis=0, return_inverse=True)
        new_n = int(new_part.max()) + 1
        if new_n == nparts:
            # Moore refinement only splits blocks, so equal counts => stable.
            part = new_part
            break
        part = new_part
        nparts = new_n
    # rebuild
    new_trans = np.zeros((nparts, ALPHABET), dtype=np.int32)
    new_finals = np.zeros(nparts, dtype=bool)
    for q in range(Q):
        new_trans[part[q]] = part[dfa.trans[q]]
        if dfa.finals[q]:
            new_finals[part[q]] = True
    return DFA(new_trans, int(part[dfa.start]), new_finals)


def compile_regex(pattern: str | bytes, ignore_case: bool = False,
                  do_minimize: bool = True) -> DFA:
    ast = parse_regex(pattern, ignore_case=ignore_case)
    dfa = dfa_from_nfa(nfa_from_ast(ast))
    return minimize(dfa) if do_minimize else dfa


def compile_literal(text: str | bytes, ignore_case: bool = False) -> DFA:
    dfa = dfa_from_nfa(nfa_from_ast(literal_regex(text, ignore_case=ignore_case)))
    return minimize(dfa)
