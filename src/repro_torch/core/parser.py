"""Incremental LR parser producing accept sequences + remainder (paper §4.2,
§4.5, Appendix A.3).

`IncrementalParser.partial_parse(C_k)` returns a `ParseResult` with:
  * accept_sequences: list of 1- or 2-length terminal-name tuples (the set A)
  * remainder r (bytes) — suffix of C_k whose lexical type may still change
  * eos_allowed — whether C_k ∈ L(G) (the EOS token may be emitted)

Incrementality (App. A.3): parser stacks are cached per prefix of the
non-ignored lexical token list; re-parsing after the LLM appends a token
restores the longest cached prefix and parses only the new tail.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .grammar import END, Grammar
from .lexer import (LexError, LexToken, lex_partial, lex_partial_state,
                    postlex_indent)
from .lr import LRTable, build_lr_table


class ParseError(ValueError):
    pass


@dataclass(slots=True)
class ParseResult:
    accept_sequences: list        # list[tuple[str, ...]]
    remainder: bytes
    eos_allowed: bool
    tokens: list = field(default_factory=list)
    case: int = 1                 # 1 or 2 (paper's remainder cases)


class IncrementalParser:
    def __init__(self, grammar: Grammar, table: LRTable | None = None,
                 lalr: bool = True, max_accept: int | None = None):
        self.grammar = grammar
        self.table = table or build_lr_table(grammar, lalr=lalr)
        self.ignores = set(grammar.ignores)
        self.parse_terminal_list = list(grammar.parse_terminals)
        self.max_accept = max_accept
        # incremental cache: token keys + stack snapshots (tuples).
        # _cache_toks holds the LexToken objects themselves: the lex and
        # postlex caches reuse prefix token objects verbatim, so an `is`
        # scan resolves the common prefix without tuple compares.
        self._cache_keys: list[tuple] = []
        self._cache_toks: list = []
        self._cache_stacks: list[tuple] = [(self.table.start_state,)]
        # persistent accept-set memo (paper App. A.3's "parser residue"
        # carried across steps): A(stack) and END-acceptability are pure
        # functions of the hashable stack tuple, and generation re-visits
        # the same stacks for many consecutive steps (the committed token
        # list only changes when a lexeme closes, while the remainder
        # grows byte by byte). LALR accept sets cost one simulated
        # reduce-loop per terminal, so the memo turns the dominant
        # per-step parser cost into a dict hit. Bounded; never stale
        # (the LR table is fixed per parser), so reset_cache() keeps it.
        self._accept_memo: dict[tuple, list] = {}
        self._end_memo: dict[tuple, bool] = {}
        # accept-SEQUENCE memo: the full accept_sequences list of a step
        # is a pure function of (branch, parser stack, final-token type,
        # indent context) — everything except the remainder bytes — so
        # consecutive decode steps that only grow the current lexeme
        # rebuild nothing. Values are shared read-only lists (callers
        # never mutate accept_sequences); the PARSE_DEAD sentinel caches
        # the no-acceptable-terminals ParseError so oracle probes that
        # keep hitting the same dead configuration stay cheap.
        self._seq_memo: dict[tuple, tuple] = {}
        self._eof_memo: dict[tuple, bool] = {}
        # incremental lexing: (data, tokens, filtered-tokens) snapshots.
        # `tip` tracks the
        # most recent text, `base` the prefix it extended — together they
        # serve both the engine's committed text (base) and the oracle's
        # one-token probes (tip) with O(delta) relexing.
        self._lex_tip: tuple | None = None
        self._lex_base: tuple | None = None
        # whole-step result cache: partial_parse(data) repeated with the
        # SAME bytes returns the previous (never-mutated) ParseResult —
        # the engine re-parses the committed text right after the oracle
        # probed that exact extension, and saturated slots repeat texts.
        self._pp_cache: tuple | None = None
        # case-1 memo fast path keyed by the identity of the (cached,
        # identity-stable) head stack — skips re-hashing the stack tuple
        self._c1_fast: dict[tuple, tuple] = {}
        # filtered (non-ignored) view of the tip's token list, maintained
        # incrementally alongside it; read-only for consumers.
        self._lex_ffilt: list = []
        # postlex fold resume slots (%indent grammars): 2-entry LRU of
        # (toks, prefix_state); validated by object identity before use.
        self._postlex_tip: tuple | None = None
        self._postlex_base: tuple | None = None

    _PARSE_DEAD = ("dead",)

    # ---------------- incremental lexing ----------------

    def _lex_partial_cached(self, data: bytes):
        """lex_partial with O(delta) resume. Every committed token except
        the final one is immutable under appended bytes (its DFA walk
        died strictly before the old end of input); the final unit's walk
        state is carried forward, so appended bytes continue that walk
        instead of relexing the token. Returns (tokens, unlexed) exactly
        like lex_partial; the returned token list is freshly built and
        safe to slice."""
        src = self._lex_tip
        if src is None or len(data) < len(src[0]) \
                or not data.startswith(src[0]):
            src = self._lex_base
            if src is not None and (len(data) < len(src[0])
                                    or not data.startswith(src[0])):
                src = None
        ignores = self.ignores
        lps = lex_partial_state
        if src is not None and (src[3] is not None or src[1]):
            stoks = src[1]
            sf = src[2]
            st = src[3]
            # drop the old final token when the resumed walk re-emits it
            # (a walk state at its pos), or when no walk state survived
            # and it must be relexed from its own start.
            if st is None or (stoks and stoks[-1].pos == st[0]):
                keep = stoks[:-1]
                kf = sf[:-1] if sf and sf[-1] is stoks[-1] else sf
            else:
                keep = stoks
                kf = sf
            if st is not None:
                tail, unlexed, nst = lps(self.grammar, data, 0, st)
            else:
                tail, unlexed, nst = lps(self.grammar, data,
                                         stoks[-1].pos)
            toks = keep + tail
            # filter(keep) == src ffilt minus the dropped token (iff the
            # filter kept it) — O(1) + O(|tail|), not O(n).
            ffilt = kf + [t for t in tail if t.type not in ignores]
        else:
            toks, unlexed, nst = lps(self.grammar, data)
            ffilt = [t for t in toks if t.type not in ignores]
        self._lex_tip = (data, toks, ffilt, nst)
        self._lex_ffilt = ffilt
        if src is not None and len(src[0]) < len(data):
            self._lex_base = src
        return toks, unlexed

    # ---------------- LR machinery ----------------

    def _shift(self, stack: list, term: str) -> bool:
        """Perform reduces until `term` can be shifted; mutate stack.
        Returns False (stack possibly dirty) if `term` is not acceptable."""
        action = self.table.action
        goto = self.table.goto
        prods = self.table.productions
        while True:
            ent = action[stack[-1]].get(term)
            if ent is None:
                return False
            op = ent[0]
            if op == "s":
                stack.append(ent[1])
                return True
            if op == "acc":
                return True
            # reduce
            prod = prods[ent[1]]
            if len(prod.rhs):
                del stack[-len(prod.rhs):]
            nxt = goto[stack[-1]].get(prod.lhs)
            if nxt is None:
                return False
            stack.append(nxt)

    def _can_shift(self, stack: tuple, term: str) -> bool:
        if not self.table.lalr:
            # canonical LR(1): immediate error detection — table presence
            # is exact.
            return term in self.table.action[stack[-1]]
        s = list(stack)
        return self._shift(s, term)

    _MEMO_CAP = 1 << 13   # entries; cleared wholesale on overflow

    def accept_terminals(self, stack: tuple) -> list[str]:
        """A(stack): acceptable next terminals (paper's immediate-error-
        detection accept set), excluding END. Memoized per stack tuple;
        callers treat the returned list as read-only."""
        memo = self._accept_memo
        out = memo.get(stack)
        if out is None:
            if not self.table.lalr:
                out = [t for t in self.table.action[stack[-1]]
                       if t != END]
            else:
                out = [t for t in self.parse_terminal_list
                       if self._can_shift(stack, t)]
            if len(memo) >= self._MEMO_CAP:
                memo.clear()
            memo[stack] = out
        return out

    def _end_acceptable(self, stack: tuple) -> bool:
        memo = self._end_memo
        ok = memo.get(stack)
        if ok is None:
            ok = self._can_shift(stack, END)
            if len(memo) >= self._MEMO_CAP:
                memo.clear()
            memo[stack] = ok
        return ok

    # ---------------- incremental prefix parsing ----------------

    def _parse_tokens(self, toks: list[LexToken]) -> tuple:
        """Parse non-ignored tokens, using/updating the prefix cache.
        Returns the final stack (tuple)."""
        ck = self._cache_keys
        ct = self._cache_toks
        cp = 0
        nt = len(toks)
        maxcp = min(nt, len(ck))
        # fast path: shared token objects (the lex/postlex caches reuse
        # prefix objects) — then fall back to (type, value) compares for
        # any relexed-but-identical region.
        while cp < maxcp and toks[cp] is ct[cp]:
            cp += 1
        if cp == nt and nt == len(ck):
            return self._cache_stacks[nt]
        while cp < maxcp:
            k = ck[cp]
            t = toks[cp]
            if k[0] != t.type or k[1] != t.value:
                break
            cp += 1
        # truncate stale cache
        del ck[cp:]
        del ct[cp:]
        del self._cache_stacks[cp + 1:]
        stack = list(self._cache_stacks[cp])
        for i in range(cp, len(toks)):
            t = toks[i]
            if not self._shift(stack, t.type):
                raise ParseError(
                    f"unexpected {t.type} ({t.value!r}) at byte {t.pos}")
            ck.append((t.type, t.value))
            ct.append(t)
            self._cache_stacks.append(tuple(stack))
        # return the cached snapshot: identity-stable across steps whose
        # committed tokens are unchanged (memo keys hash it every step)
        return self._cache_stacks[len(toks)]

    def parse_from_scratch_stack(self, toks: list[LexToken]) -> tuple:
        stack = [self.table.start_state]
        for t in toks:
            if not self._shift(stack, t.type):
                raise ParseError(
                    f"unexpected {t.type} ({t.value!r}) at byte {t.pos}")
        return tuple(stack)

    def reset_cache(self):
        self._cache_keys = []
        self._cache_toks = []
        self._cache_stacks = [(self.table.start_state,)]
        # the accept-set/sequence memos are pure functions of the LR
        # table and survive resets; only the per-text state is dropped
        self._lex_tip = None
        self._lex_base = None
        self._lex_ffilt = []
        self._pp_cache = None
        self._postlex_tip = None
        self._postlex_base = None

    # ---------------- the paper's partial parse ----------------

    def partial_parse(self, data: bytes, incremental: bool = True) -> ParseResult:
        if incremental:
            pp = self._pp_cache
            if pp is not None and pp[0] == data:
                return pp[1]
            toks, unlexed = self._lex_partial_cached(data)
            res = self._parse_step(toks, unlexed, True)
            self._pp_cache = (data, res)
            return res
        toks, unlexed = lex_partial(self.grammar, data)
        return self._parse_step(toks, unlexed, False)

    def _parse_step(self, toks: list, unlexed: bytes,
                    incremental: bool) -> ParseResult:
        if self.grammar.indent_spec is not None:
            return self._partial_parse_indent(toks, unlexed, incremental)
        ignores = self.ignores
        memo = self._seq_memo

        if unlexed:
            # Case 2: unlexed suffix u — parse ALL lexed tokens, 1-length
            # sequences from the accept set.
            parse_toks = (self._lex_ffilt if incremental
                          else [t for t in toks if t.type not in ignores])
            stack = (self._parse_tokens(parse_toks) if incremental
                     else self.parse_from_scratch_stack(parse_toks))
            hit = memo.get(("c2", stack))
            if hit is None:
                a1 = self.accept_terminals(stack)
                seqs = [(t,) for t in a1]
                seqs += [(ig,) for ig in self.grammar.ignores]
                hit = (self._cap(seqs), False)
                self._memo_put(("c2", stack), hit)
            return ParseResult(hit[0], unlexed, eos_allowed=False,
                               tokens=toks, case=2)

        # Case 1: input ends at a complete lexical token l_f (possibly none)
        if not toks:
            stack = (self._parse_tokens([]) if incremental
                     else self.parse_from_scratch_stack([]))
            hit = memo.get(("c0", stack))
            if hit is None:
                a0 = self.accept_terminals(stack)
                seqs = [(t,) for t in a0]
                seqs += [(ig,) for ig in self.grammar.ignores]
                hit = (self._cap(seqs), self._end_acceptable(stack))
                self._memo_put(("c0", stack), hit)
            return ParseResult(hit[0], b"", eos_allowed=hit[1],
                               tokens=toks, case=1)

        lf = toks[-1]
        if incremental:
            ff = self._lex_ffilt
            parse_head = ff[:-1] if ff and ff[-1] is lf else ff
            stack0 = self._parse_tokens(parse_head)
        else:
            parse_head = [t for t in toks[:-1] if t.type not in ignores]
            stack0 = self.parse_from_scratch_stack(parse_head)
        fkey = (id(stack0), lf.type)
        fhit = self._c1_fast.get(fkey)
        if fhit is not None and fhit[0] is stack0:
            hit = fhit[1]
        else:
            hit = memo.get((stack0, lf.type))
            if hit is None:
                hit = self._build_case1(stack0, lf.type)
                self._memo_put((stack0, lf.type), hit)
            if len(self._c1_fast) >= self._MEMO_CAP:
                self._c1_fast.clear()
            self._c1_fast[fkey] = (stack0, hit)
        if hit is self._PARSE_DEAD:
            raise ParseError(
                f"unexpected {lf.type} ({lf.value!r}) at byte "
                f"{lf.pos}: no acceptable terminals")
        return ParseResult(hit[0], lf.value, eos_allowed=hit[1],
                           tokens=toks, case=1)

    def _build_case1(self, stack0: tuple, lf_type: str):
        """(accept_sequences, eos) for a flat-grammar Case-1 step — a
        pure function of (stack0, lf_type). Returns the _PARSE_DEAD
        sentinel when no terminal is acceptable."""
        a0 = self.accept_terminals(stack0)
        shifted = True
        if lf_type in self.ignores:
            eos = self._end_acceptable(stack0)
            a1 = a0
        else:
            s = list(stack0)
            if self._shift(s, lf_type):
                stack1 = tuple(s)
                eos = self._end_acceptable(stack1)
                a1 = self.accept_terminals(stack1)
            else:
                # l_f's current type is not acceptable here — but the token
                # may still grow into an acceptable terminal (e.g. "!" ->
                # "!=", identifier prefix -> keyword). Only the 1-length
                # A0 sequences apply (paper §4.5 Case 1).
                shifted = False
                eos = False
                a1 = []
                if not a0:
                    return self._PARSE_DEAD
        seqs = []
        if shifted:
            seqs += [(lf_type, t1) for t1 in a1]
            seqs += [(lf_type, ig) for ig in self.grammar.ignores]
        seqs += [(t0,) for t0 in a0 if t0 != lf_type]
        return (self._cap(seqs), eos)

    def _memo_put(self, key, val):
        memo = self._seq_memo
        if len(memo) >= self._MEMO_CAP:
            memo.clear()
        memo[key] = val

    # ---------------- indent-aware partial parse (%indent grammars) -------

    def _indent_eof_ok(self, stack: tuple, levels: tuple, paren: int,
                       has_content: bool) -> bool:
        """EOF closure: the last logical line needs no trailing newline
        byte — emit an implicit NEWLINE (when any content exists), then
        one DEDENT per open level, then END must be shiftable. Memoized:
        a pure function of (stack, open-level count, has_content) once
        the bracket-depth gate passes."""
        if paren > 0:
            return False
        key = (stack, len(levels), has_content)
        memo = self._eof_memo
        ok = memo.get(key)
        if ok is None:
            nl_t, _ind_t, ded_t = self.grammar.indent_spec
            s = list(stack)
            if has_content and not self._shift(s, nl_t):
                ok = False
            else:
                ok = True
                for _ in range(len(levels) - 1):
                    if not self._shift(s, ded_t):
                        ok = False
                        break
                if ok:
                    ok = self._can_shift(tuple(s), END)
            if len(memo) >= self._MEMO_CAP:
                memo.clear()
            memo[key] = ok
        return ok

    def _postlex_cached(self, toks: list, unlexed: bytes):
        """postlex_indent with fold resume: reuse a prefix_state from a
        recent call whose token prefix is unchanged. Validation is an
        object-identity scan — the lex cache shares prefix LexToken
        objects across steps, so a hit costs O(k) pointer compares and
        the fold itself re-processes only the final token."""
        resume = None
        n = len(toks)
        for ent in (self._postlex_tip, self._postlex_base):
            if ent is None:
                continue
            ptoks, state = ent
            k = state[0]
            if k >= n or k > len(ptoks):
                continue
            ok = True
            for i in range(k):
                if toks[i] is not ptoks[i]:
                    ok = False
                    break
            if ok:
                resume = state
                break
        res = postlex_indent(self.grammar, toks, unlexed, resume=resume)
        if res.prefix_state is not None:
            old = self._postlex_tip
            self._postlex_tip = (toks, res.prefix_state)
            if old is not None and old[1][0] < res.prefix_state[0]:
                self._postlex_base = old
        return res

    def _partial_parse_indent(self, toks: list, unlexed: bytes,
                              incremental: bool) -> ParseResult:
        g = self.grammar
        nl_t, ind_t, ded_t = g.indent_spec
        synth = g.synthetic_terminals
        res = (self._postlex_cached(toks, unlexed) if incremental
               else postlex_indent(g, toks, unlexed))
        parse_all = [t for t in res.tokens if t.type not in self.ignores]

        def accepts(stack: tuple) -> list:
            # INDENT/DEDENT are zero-width — they never head an accept
            # sequence (no byte can lex into them); the pending-NEWLINE
            # branch expansion below accounts for them instead.
            return [t for t in self.accept_terminals(stack)
                    if t not in synth]

        def parse(ts):
            return (self._parse_tokens(ts) if incremental
                    else self.parse_from_scratch_stack(ts))

        memo = self._seq_memo

        if unlexed:
            # Case 2: everything lexed is committed (new bytes extend the
            # unlexed suffix, never a committed token).
            stack = parse(parse_all)
            hit = memo.get(("i2", stack))
            if hit is None:
                seqs = [(t,) for t in accepts(stack)]
                seqs += [(ig,) for ig in g.ignores]
                hit = (self._cap(seqs), False)
                self._memo_put(("i2", stack), hit)
            return ParseResult(hit[0], unlexed, eos_allowed=False,
                               tokens=toks, case=2)

        if res.pending is not None:
            # Trailing NEWLINE with its indent level still open: the next
            # line may land on the current level, one deeper (INDENT), or
            # any enclosing one (DEDENT+) — and more newline/comment bytes
            # may extend the lexeme first. Union the accept sets over all
            # reachable branches; the exact oracle re-checks on commit.
            stack0 = parse(parse_all)
            has = any(t.type not in synth for t in parse_all)
            key = ("ip", stack0, len(res.levels), has)
            hit = memo.get(key)
            if hit is None:
                hit = self._build_pending(stack0, len(res.levels), has)
                self._memo_put(key, hit)
            if hit is self._PARSE_DEAD:
                raise ParseError(
                    f"unexpected {nl_t} at byte {res.pending.pos}")
            eos = self._indent_eof_ok(stack0, res.levels, res.paren, has)
            return ParseResult(hit[0], res.pending.value,
                               eos_allowed=eos, tokens=toks, case=1)

        if toks and toks[-1].type == nl_t and res.paren > 0:
            # Trailing NEWLINE inside brackets: dropped from the parse
            # (implicit line joining) but still the lexical remainder.
            stack0 = parse(parse_all)
            hit = memo.get(("ib", stack0))
            if hit is None:
                seqs = [(nl_t, t1) for t1 in accepts(stack0)]
                seqs += [(nl_t, ig) for ig in g.ignores]
                hit = (self._cap(seqs), False)
                self._memo_put(("ib", stack0), hit)
            return ParseResult(hit[0], toks[-1].value,
                               eos_allowed=False, tokens=toks, case=1)

        if not toks:
            stack = parse([])
            hit = memo.get(("i0", stack))
            if hit is None:
                a0 = accepts(stack)
                seqs = [(t,) for t in a0] + [(ig,) for ig in g.ignores]
                hit = (self._cap(seqs), self._can_shift(stack, END))
                self._memo_put(("i0", stack), hit)
            return ParseResult(hit[0], b"", eos_allowed=hit[1],
                               tokens=toks, case=1)

        # Case 1 with a real (or ignored) final token: identical to the
        # flat-grammar path, except the head went through the post-lexer
        # and EOS uses the EOF closure. The seqs are a pure function of
        # (stack0, lf.type); EOS also needs the indent context, so the
        # memo records WHICH stack the EOF closure starts from.
        lf = toks[-1]
        head_parse = [t for t in res.tokens[:-1] if t.type not in self.ignores]
        stack0 = parse(head_parse)
        has_head = any(t.type not in synth for t in head_parse)
        key = ("i1", stack0, lf.type)
        hit = memo.get(key)
        if hit is None:
            hit = self._build_indent_case1(stack0, lf.type)
            self._memo_put(key, hit)
        if hit is self._PARSE_DEAD:
            raise ParseError(
                f"unexpected {lf.type} ({lf.value!r}) at byte "
                f"{lf.pos}: no acceptable terminals")
        seqs, eos_mode, stack1 = hit
        if eos_mode == 0:                         # ignored l_f: no shift
            eos = self._indent_eof_ok(stack0, res.levels, res.paren,
                                      has_head)
        elif eos_mode == 1:                       # shifted l_f
            eos = self._indent_eof_ok(stack1, res.levels, res.paren,
                                      True)
        else:
            eos = False                           # unshiftable, growing l_f
        return ParseResult(seqs, lf.value, eos_allowed=eos,
                           tokens=toks, case=1)

    def _build_pending(self, stack0: tuple, nlevels: int, has: bool):
        """Accept sequences for the open-NEWLINE branch union — a pure
        function of (stack0, open-level count, has-content)."""
        g = self.grammar
        nl_t, ind_t, ded_t = g.indent_spec
        synth = g.synthetic_terminals

        def accepts(stack):
            return [t for t in self.accept_terminals(stack)
                    if t not in synth]

        if has:
            s = list(stack0)
            if not self._shift(s, nl_t):
                return self._PARSE_DEAD
            s1 = tuple(s)
        else:
            s1 = stack0         # leading blank/comment lines: no NEWLINE
        branch = list(accepts(s1))
        s = list(s1)
        if self._shift(s, ind_t):
            branch += accepts(tuple(s))
        s = list(s1)
        for _ in range(nlevels - 1):
            if not self._shift(s, ded_t):
                break
            branch += accepts(tuple(s))
        seqs = [(nl_t, t1) for t1 in dict.fromkeys(branch)]
        seqs += [(nl_t, ig) for ig in g.ignores]
        return (self._cap(seqs),)

    def _build_indent_case1(self, stack0: tuple, lf_type: str):
        """(accept_sequences, eos_mode, stack1) for an indent Case-1
        step. eos_mode selects the EOF-closure start: 0 = stack0 with
        the head's has_content (ignored l_f), 1 = the post-shift stack1
        with content (shifted l_f), 2 = EOS impossible (unshiftable,
        still-growing l_f)."""
        g = self.grammar
        synth = g.synthetic_terminals

        def accepts(stack):
            return [t for t in self.accept_terminals(stack)
                    if t not in synth]

        a0 = accepts(stack0)
        shifted = True
        eos_mode, stack1 = 0, None
        if lf_type in self.ignores:
            a1 = a0
        else:
            s = list(stack0)
            if self._shift(s, lf_type):
                stack1 = tuple(s)
                eos_mode = 1
                a1 = accepts(stack1)
            else:
                shifted = False
                eos_mode = 2
                a1 = []
                if not a0:
                    return self._PARSE_DEAD
        seqs = []
        if shifted:
            seqs += [(lf_type, t1) for t1 in a1]
            seqs += [(lf_type, ig) for ig in g.ignores]
        seqs += [(t0,) for t0 in a0 if t0 != lf_type]
        return (self._cap(seqs), eos_mode, stack1)

    def _cap(self, seqs):
        # dedupe, keep order
        seen = set()
        out = []
        for s in seqs:
            if s not in seen:
                seen.add(s)
                out.append(s)
        if self.max_accept is not None:
            out = out[: self.max_accept]
        return out

    # ---------------- whole-string recognition (for tests/benchmarks) ----

    def recognize(self, data: bytes) -> bool:
        """C ∈ L(G)?"""
        try:
            toks, unlexed = lex_partial(self.grammar, data)
        except LexError:
            return False
        if unlexed:
            return False
        if self.grammar.indent_spec is not None:
            try:
                res = postlex_indent(self.grammar, toks, b"", at_eof=True)
            except LexError:
                return False
            if res.paren > 0:
                return False
            toks = res.tokens
        parse_toks = [t for t in toks if t.type not in self.ignores]
        stack = [self.table.start_state]
        for t in parse_toks:
            if not self._shift(stack, t.type):
                return False
        return self._can_shift(tuple(stack), END)
