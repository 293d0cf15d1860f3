"""Maximal-munch lexer over the grammar's combined lexer DFA (paper §4.2).

`lex_partial` implements the paper's partial-output lexing with the two
remainder cases:

* Case 1 — the input ends exactly at a complete lexical token: the token
  list includes the final token; the caller treats the final token as the
  remainder `r` (its type may still change as the LLM extends the text).
* Case 2 — the input ends with a suffix that is not (yet) a complete
  token but is a live prefix of some terminal: that suffix is returned as
  the unlexed remainder `u`.

A dead suffix (no terminal can ever match) raises LexError — such a
string is not in L_p(G) for any grammar over these terminals.

For layout-sensitive grammars (`%indent NEWLINE INDENT DEDENT`),
`postlex_indent` runs after `lex_partial` and synthesizes INDENT/DEDENT
tokens around committed NEWLINE tokens, Python-tokenizer style:

* the NEWLINE terminal's lexeme carries the following line's leading
  spaces (and any comments / blank lines it absorbed); its indentation
  column is compared against an indent stack;
* a trailing NEWLINE whose lexeme may still grow (mid-generation the
  text often ends inside `"\n    "`) is returned as *pending* — its
  indent effect is deliberately uncommitted so partial inputs never
  commit to an indent level the next token could still change;
* NEWLINE tokens inside unclosed brackets are dropped (implicit line
  joining);
* leading blank/comment lines emit no NEWLINE.

The indent stack counts leading spaces only; the column of a committed
line that matches no enclosing level raises IndentationError (a
LexError — such text is not in L_p(G)).
"""
from __future__ import annotations

from dataclasses import dataclass

from .grammar import Grammar


class LexError(ValueError):
    def __init__(self, msg, pos=None):
        super().__init__(msg)
        self.pos = pos


class IndentationError_(LexError):
    """Committed line indentation matches no enclosing level."""


@dataclass
class LexToken:
    type: str
    value: bytes
    pos: int


def lex_partial_state(grammar: Grammar, data: bytes, start: int = 0,
                      state: "tuple | None" = None):
    """Stateful maximal-munch lex. Returns (tokens, unlexed_suffix,
    walk_state). unlexed_suffix == b'' means Case 1 (or empty input);
    non-empty means Case 2.

    `walk_state` is (pos, q, j, last_acc, last_tag) — the DFA walk of
    the final, still-extendable unit at the end of `data` (None when the
    input ends exactly at a dead-stopped token boundary). Passing it
    back as `state` on a later call whose data extends the original
    continues that walk over only the appended bytes, reproducing the
    fresh walk's outcome exactly; the caller must drop its previously
    returned final token when one was emitted at `state[0]` (that token
    is re-emitted, possibly extended). See
    IncrementalParser._lex_partial_cached.

    `start` resumes lexing at a byte offset (token positions stay
    absolute): every committed token except the final one is decided by
    bytes the DFA already consumed, so an incremental caller without a
    walk state may keep `tokens[:-1]` and relex from `tokens[-1].pos`."""
    dfa = grammar.lexer_dfa
    tags = grammar.lexer_tags
    trans = dfa.trans
    live = dfa.live
    finals = dfa.finals
    tokens: list[LexToken] = []
    pos = start
    n = len(data)
    resume = state
    while pos < n or resume is not None:
        if resume is not None:
            pos, q, j, last_acc, last_tag = resume
            resume = None
        else:
            q = dfa.start
            j = pos
            last_acc = -1
            last_tag = None
        while j < n:
            nq = trans[q, data[j]]
            if not live[nq]:
                break
            q = nq
            j += 1
            if finals[q]:
                last_acc = j
                last_tag = tags[q]
        if j == n and live[q] and q != dfa.start:
            # reached end of input while a token is still in progress
            st = (pos, q, j, last_acc, last_tag)
            if finals[q]:
                tokens.append(LexToken(last_tag, data[pos:j], pos))
                return tokens, b"", st
            return tokens, data[pos:], st
        if last_acc < 0:
            raise LexError(
                f"no terminal matches at byte {pos} ({data[pos:pos+12]!r})",
                pos=pos)
        tokens.append(LexToken(last_tag, data[pos:last_acc], pos))
        pos = last_acc
    return tokens, b"", None


def lex_partial(grammar: Grammar, data: bytes, start: int = 0):
    """Returns (tokens, unlexed_suffix) — `lex_partial_state` without the
    resumable walk state."""
    tokens, unlexed, _st = lex_partial_state(grammar, data, start)
    return tokens, unlexed


# --------------------------------------------------------------------------
# Indentation post-lex pass (%indent grammars)
# --------------------------------------------------------------------------

_OPENERS = (b"(", b"[", b"{")
_CLOSERS = (b")", b"]", b"}")


@dataclass
class IndentResult:
    """Output of `postlex_indent`.

    tokens:  committed token stream with INDENT/DEDENT synthesized and
             bracket-joined NEWLINEs dropped — safe to feed the parser.
    pending: the trailing NEWLINE token whose lexeme may still grow
             (partial input, bracket depth 0), indent effect NOT yet
             applied; None when the tail is committed or at_eof.
    levels:  the committed indent stack (always starts with 0).
    paren:   unclosed-bracket depth over the committed tokens.
    has_content: a committed non-ignored, non-synthetic token exists
             (controls leading-NEWLINE suppression and the EOF closure).
    """
    tokens: list
    pending: "LexToken | None"
    levels: tuple
    paren: int
    has_content: bool
    # fold state immediately before the final token was processed:
    # (k, tokens-out tuple, levels tuple, paren, has_content). Passing it
    # back as `resume` (with toks[:k] unchanged) re-folds only the tail.
    prefix_state: "tuple | None" = None


def _indent_col(value: bytes) -> "int | None":
    """Column opened by a committed NEWLINE lexeme: spaces after its last
    newline byte. None when the lexeme holds no newline (a pure trailing
    comment — only possible at the very end of the input)."""
    i = value.rfind(b"\n")
    if i < 0:
        return None
    col = 0
    j = i + 1
    while j < len(value) and value[j] == 0x20:
        col += 1
        j += 1
    return col


def postlex_indent(grammar: Grammar, toks: list, unlexed: bytes = b"",
                   at_eof: bool = False,
                   resume: "tuple | None" = None) -> IndentResult:
    """Synthesize INDENT/DEDENT for an `%indent` grammar.

    Partial-input safety: a trailing NEWLINE token that could still be
    extended by future bytes (more spaces deepen the line, a fresh
    newline resets it entirely) is returned as `pending` instead of
    committing an indent decision. Every non-trailing NEWLINE is
    committed — its lexeme was terminated by a real token, so its column
    can never change again.

    With `at_eof=True` (whole-input recognition) the Python-tokenizer EOF
    closure is applied instead: a final NEWLINE (the last logical line
    needs no trailing newline byte) followed by one DEDENT per open
    level.

    `resume` is a `prefix_state` from a previous call whose first k
    tokens are unchanged (the caller must verify this — object identity
    over `toks[:k]` suffices, see IncrementalParser): the fold restarts
    after token k-1 instead of from the top, so a decode step that only
    appends bytes re-folds O(1) tokens. Only the final token's handling
    differs between calls (pending vs committed), and `prefix_state` is
    snapshotted strictly before it, so resumed and from-scratch folds
    agree exactly.
    """
    nl_t, ind_t, ded_t = grammar.indent_spec
    ignores = set(grammar.ignores)
    out: list[LexToken] = []
    levels = [0]
    paren = 0
    has_content = False
    pending = None
    n = len(toks)
    start = 0
    if resume is not None and resume[0] < n:
        start, r_out, r_levels, paren, has_content = resume
        out = list(r_out)
        levels = list(r_levels)
    snapshot = None
    for i in range(start, n):
        t = toks[i]
        if i == n - 1 and not at_eof:
            snapshot = (i, tuple(out), tuple(levels), paren, has_content)
        if t.type == nl_t:
            if paren > 0:
                continue                    # implicit line joining
            if i == n - 1 and not unlexed:
                pending = t                 # open tail: defer the decision
                break
            end = t.pos + len(t.value)
            if has_content:
                out.append(t)
            col = _indent_col(t.value)
            if col is None:
                continue
            if col > levels[-1]:
                levels.append(col)
                out.append(LexToken(ind_t, b"", end))
            else:
                while col < levels[-1]:
                    levels.pop()
                    out.append(LexToken(ded_t, b"", end))
                if col != levels[-1]:
                    raise IndentationError_(
                        f"unindent to column {col} at byte {t.pos} matches "
                        f"no enclosing indentation level", pos=t.pos)
            continue
        out.append(t)
        if t.type not in ignores:
            has_content = True
            if len(t.value) == 1:
                if t.value in _OPENERS:
                    paren += 1
                elif t.value in _CLOSERS and paren > 0:
                    paren -= 1
    if at_eof:
        end = (toks[-1].pos + len(toks[-1].value)) if toks else 0
        if has_content and paren == 0:
            out.append(LexToken(nl_t, b"", end))
            while len(levels) > 1:
                levels.pop()
                out.append(LexToken(ded_t, b"", end))
        pending = None
        snapshot = None
    return IndentResult(out, pending, tuple(levels), paren, has_content,
                        prefix_state=snapshot)
