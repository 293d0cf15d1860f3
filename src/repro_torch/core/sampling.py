"""Random sentence sampling from a CFG (used by the synthetic data
pipeline and by property tests as a source of guaranteed-valid strings).

Derivation is depth-bounded: below the budget, expansion prefers the
shortest-derivation production for each nonterminal so sampling always
terminates.
"""
from __future__ import annotations

import random

from .grammar import Grammar
from .regex import DFA


def _min_depths(grammar: Grammar) -> dict[str, int]:
    """Min derivation depth per nonterminal (terminals = 0)."""
    INF = 10 ** 9
    depth = {nt: INF for nt in grammar.nonterminals}
    changed = True
    while changed:
        changed = False
        for p in grammar.productions:
            d = 0
            for sym in p.rhs:
                d = max(d, depth.get(sym, 0) if sym in grammar.nonterminals
                        else 0)
            d += 1
            if d < depth[p.lhs]:
                depth[p.lhs] = d
                changed = True
    return depth


_DIST_CACHE: dict[int, list] = {}


def _dist_to_accept(dfa: DFA) -> list:
    key = id(dfa)
    if key in _DIST_CACHE:
        return _DIST_CACHE[key]
    import collections
    Q = dfa.num_states
    dist = [None] * Q
    radj = [[] for _ in range(Q)]
    for q in range(Q):
        for c in range(256):
            radj[int(dfa.trans[q, c])].append((q, c))
    dq = collections.deque()
    for q in range(Q):
        if dfa.finals[q]:
            dist[q] = 0
            dq.append(q)
    while dq:
        q = dq.popleft()
        for (p, c) in radj[q]:
            if dist[p] is None:
                dist[p] = dist[q] + 1
                dq.append(p)
    _DIST_CACHE[key] = dist
    return dist


def sample_terminal_string(dfa: DFA, rng: random.Random,
                           max_len: int = 12) -> bytes:
    """Random shortest-biased string accepted by a DFA."""
    dist = _dist_to_accept(dfa)
    out = bytearray()
    q = dfa.start
    while True:
        if dfa.finals[q] and (len(out) >= 1 or dist[q] == 0):
            # stochastically stop; always stop at max_len
            if len(out) >= max_len or rng.random() < 0.45:
                return bytes(out)
        # choose a char that keeps (or brings) us near acceptance
        choices = []
        for c in range(256):
            nq = int(dfa.trans[q, c])
            if dist[nq] is not None:
                budget_ok = dist[nq] + len(out) < max_len + 2
                if budget_ok:
                    choices.append((c, nq))
        if not choices:
            # must already be final (dist[q]==0), else walk greedily
            if dfa.finals[q]:
                return bytes(out)
            choices = [(c, int(dfa.trans[q, c])) for c in range(256)
                       if dist[int(dfa.trans[q, c])] is not None]
        # bias toward printable ascii
        printable = [(c, nq) for (c, nq) in choices if 32 <= c < 127]
        c, q = rng.choice(printable or choices)
        out.append(c)


class GrammarSampler:
    def __init__(self, grammar: Grammar, seed: int = 0,
                 max_terminal_len: int = 10):
        self.grammar = grammar
        self.rng = random.Random(seed)
        self.by_lhs = grammar.prods_by_lhs()
        self.min_depth = _min_depths(grammar)
        self.max_terminal_len = max_terminal_len
        self._needs_space_cache: dict[tuple, bool] = {}
        # layout-sensitive (%indent) grammars: INDENT/DEDENT are synthetic
        # (no lexeme of their own) and NEWLINE lexemes must carry the
        # following line's indentation, so the sampler renders them
        # canonically instead of sampling their DFAs.
        self._indent = grammar.indent_spec
        self._level = 0
        self._nl_buf = b""

    def _expand(self, sym: str, budget: int, out: list[bytes]):
        g = self.grammar
        if sym not in g.nonterminals:
            if self._indent is not None:
                nl_t, ind_t, ded_t = self._indent
                if sym == ind_t:
                    self._level += 4
                    return
                if sym == ded_t:
                    self._level = max(0, self._level - 4)
                    return
                if sym == nl_t:
                    # buffered: the newline and the next line's indent must
                    # reach the glue step as ONE piece, so no separator can
                    # be inserted inside the NEWLINE lexeme
                    self._nl_buf = b"\n"
                    return
            dfa = g.terminals[sym].dfa
            from .lexer import LexError, lex_partial
            for _ in range(50):
                s = sample_terminal_string(dfa, self.rng,
                                           self.max_terminal_len)
                # the sampled string must actually *lex* as this terminal
                # (e.g. a random NAME must not collide with a keyword)
                try:
                    toks, rem = lex_partial(g, s)
                except LexError:
                    continue
                if not rem and len(toks) == 1 and toks[0].type == sym:
                    if self._indent is not None and self._nl_buf:
                        s = self._nl_buf + b" " * self._level + s
                        self._nl_buf = b""
                    out.append(s)
                    return
            raise RuntimeError(f"cannot sample terminal {sym}")
        prods = self.by_lhs[sym]
        if budget <= self.min_depth[sym]:
            # forced: pick a minimal production
            best = min(prods, key=lambda p: max(
                [self.min_depth.get(s, 0) for s in p.rhs] or [0]))
            choices = [best]
        else:
            choices = [p for p in prods
                       if max([self.min_depth.get(s, 0)
                               for s in p.rhs] or [0]) < budget]
            if not choices:
                choices = [min(prods, key=lambda p: max(
                    [self.min_depth.get(s, 0) for s in p.rhs] or [0]))]
        p = self.rng.choice(choices)
        for s in p.rhs:
            self._expand(s, budget - 1, out)

    def sample_batch(self, n: int, budget: int = 24,
                     max_bytes: int | None = None) -> list[bytes]:
        """n syntactically valid strings (benchmark corpora / property
        tests / synthetic-data batches for the training pipeline)."""
        return [self.sample(budget, max_bytes) for _ in range(n)]

    def sample(self, budget: int = 24, max_bytes: int | None = None) -> bytes:
        """One syntactically valid string; pieces are separated by a space
        whenever gluing them would merge two lexical tokens. `max_bytes`
        retries with shrinking budget (derivations can blow up)."""
        b = budget
        for _ in range(16):
            pieces: list[bytes] = []
            self._level = 0
            self._nl_buf = b""
            self._expand(self.grammar.start, b, pieces)
            s = self._glue(pieces)
            if max_bytes is None or len(s) <= max_bytes:
                return s
            b = max(3, b - 3)
        return s

    def _lex_sig(self, data: bytes):
        from .lexer import LexError, lex_partial
        try:
            toks, rem = lex_partial(self.grammar, data)
        except LexError:
            return None
        return ([(t.type, t.value) for t in toks
                 if t.type not in self.grammar.ignores], rem)

    def _glue(self, pieces: list[bytes]) -> bytes:
        """Linear-time glue: only the boundary window is re-lexed."""
        out = bytearray()
        for piece in pieces:
            if not piece:
                continue
            if not out:
                out += piece
                continue
            w = 16
            while True:
                tail = bytes(out[-w:])
                sig_glued = self._lex_sig(tail + piece)
                sig_spaced = self._lex_sig(tail + b" " + piece)
                if sig_glued is not None or sig_spaced is not None:
                    break
                if w >= len(out):
                    break
                # the window started mid-token (e.g. inside a string
                # literal with bytes that are dead outside strings) and
                # nothing lexes: widen until the boundary re-lex is honest
                w *= 2
            if sig_glued is not None and sig_glued == sig_spaced:
                out += piece
            elif sig_spaced is None:
                # whitespace is not lexable in this grammar (compact
                # formats like jsonmsg): direct glue is the only option —
                # such grammars must delimit adjacent terminals
                # punctuationally, which the boundary re-lex confirms
                out += piece
            else:
                out += b" " + piece
        return bytes(out)
