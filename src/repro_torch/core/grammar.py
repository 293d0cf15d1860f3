"""Lark-flavoured EBNF grammar frontend.

Parses grammar text like the paper's Figure 3 / Appendix A.8 into:
  * a set of named terminals, each compiled to a byte-level DFA,
  * BNF productions (EBNF sugar ``[]``, ``()``, ``*``, ``+``, ``?`` expanded
    into helper nonterminals),
  * an ``%ignore`` list (whitespace/comments),
  * a combined lexer DFA with tagged finals for maximal-munch lexing.

Supported surface syntax (subset of Lark):
  rule_name: item* ("|" item*)* ("->" alias)?
  TERMINAL(.prio)?: <terminal expression over strings/regexes/terminal refs>
  "literal"  "literal"i  /regex/  [optional]  (group)  x* x+ x?
  %ignore TERMINAL | "lit" | /re/
  %declare NAME (accepted, declared terminals get an impossible-match DFA
                 unless defined elsewhere)
  %indent NEWLINE_TERM INDENT_TERM DEDENT_TERM (opt into the layout-
                 sensitive post-lex pass in core/lexer.py: the named
                 NEWLINE terminal must have a lexer definition; the
                 INDENT/DEDENT terminals are auto-%declare'd and are
                 synthesized, never lexed)
  // comments
"""
from __future__ import annotations

import re as _pyre
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .regex import (
    DFA, RAlt, RChars, RConcat, REpsilon, RNode, ROpt, RPlus, RStar,
    compile_regex, dfa_from_nfa, literal_regex, minimize, nfa_from_ast,
    parse_regex, NFA, _build,
)

END = "$END"  # end-of-input terminal for the LR parser


@dataclass
class Terminal:
    name: str
    ast: RNode
    priority: int = 0
    from_literal: bool = False     # literal terminals win lexer ties
    dfa: Optional[DFA] = None

    def compile(self):
        if self.dfa is None:
            self.dfa = minimize(dfa_from_nfa(nfa_from_ast(self.ast)))
        return self.dfa


@dataclass(frozen=True)
class Production:
    lhs: str
    rhs: tuple  # tuple[str] symbol names; terminals are uppercase/__ANON
    idx: int = -1


class GrammarError(ValueError):
    pass


# --------------------------------------------------------------------------
# Meta-tokenizer for grammar text
# --------------------------------------------------------------------------

_TOKEN_RE = _pyre.compile(
    r"""
      (?P<WS>[ \t]+)
    | (?P<COMMENT>//[^\n]*)
    | (?P<STRING>"(?:\\.|[^"\\])*"i?)
    | (?P<REGEX>/(?:\\.|[^/\\\n])+/[imslux]*)
    | (?P<ARROW>->)
    | (?P<NAME>[?!]?[A-Za-z_][A-Za-z0-9_]*(\.\d+)?)
    | (?P<OP>[:|()\[\]*+?~])
    | (?P<NL>\n)
    | (?P<PCT>%[a-z]+)
    """,
    _pyre.VERBOSE,
)


def _tokenize_meta(text: str):
    text = text.replace("\\\n", " ")  # line continuation
    toks = []
    i = 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise GrammarError(f"bad grammar char {text[i]!r} at offset {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("WS", "COMMENT"):
            continue
        toks.append((kind, m.group()))
    toks.append(("EOF", ""))
    return toks


def _unescape_string(tok: str) -> tuple[bytes, bool]:
    """'"abc"i?' -> (b'abc', ignore_case)"""
    icase = tok.endswith("i")
    if icase:
        tok = tok[:-1]
    body = tok[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            n = body[i + 1]
            mapping = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "\\": "\\",
                       '"': '"', "'": "'", "/": "/", "0": "\0"}
            out.append(mapping.get(n, n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out).encode(), icase


def _regex_body(tok: str) -> tuple[str, bool]:
    """'/re/flags' -> (pattern, ignore_case)."""
    end = tok.rfind("/")
    flags = tok[end + 1:]
    return tok[1:end], "i" in flags


# --------------------------------------------------------------------------
# Grammar parser (recursive descent over meta tokens)
# --------------------------------------------------------------------------

class _Expansion:
    """One alternative of a rule body: a list of items."""
    def __init__(self, items):
        self.items = items  # list of _Item


class _Item:
    def __init__(self, atom, quant=None):
        self.atom = atom    # ('str', bytes, icase)|('re', pat, icase)|('name', n)|('group', [_Expansion])|('opt', [_Expansion])
        self.quant = quant  # None | '*' | '+' | '?'


class _DefParser:
    def __init__(self, toks, pos):
        self.toks = toks
        self.pos = pos

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def skip_nl(self):
        while self.peek()[0] == "NL":
            self.next()

    def at_def_boundary(self) -> bool:
        """True if current position starts a new definition (NAME ':' or %...)."""
        k, v = self.peek()
        if k == "EOF":
            return True
        if k == "PCT":
            return True
        if k == "NAME":
            j = self.pos + 1
            if j < len(self.toks) and self.toks[j] == ("OP", ":"):
                return True
        return False

    def parse_alts(self, stop_at_newline_boundary=True):
        alts = [self.parse_seq()]
        while True:
            # skip newlines, but stop if a new definition begins
            save = self.pos
            self.skip_nl()
            if self.peek() == ("OP", "|"):
                self.next()
                alts.append(self.parse_seq())
            else:
                self.pos = save
                break
        return alts

    def parse_seq(self) -> _Expansion:
        items = []
        while True:
            k, v = self.peek()
            if k in ("EOF", "NL") or (k == "OP" and v in ("|", ")", "]")):
                break
            if k == "ARROW":
                self.next()
                self.next()  # alias name, discarded (tree shaping irrelevant)
                break
            items.append(self.parse_item())
        return _Expansion(items)

    def parse_item(self) -> _Item:
        atom = self.parse_atom()
        quant = None
        k, v = self.peek()
        if k == "OP" and v in ("*", "+", "?"):
            self.next()
            quant = v
        return _Item(atom, quant)

    def parse_atom(self):
        k, v = self.next()
        if k == "STRING":
            s, icase = _unescape_string(v)
            return ("str", s, icase)
        if k == "REGEX":
            pat, icase = _regex_body(v)
            return ("re", pat, icase)
        if k == "NAME":
            name = v.lstrip("?!")
            if "." in name:
                name = name.split(".")[0]
            return ("name", name)
        if k == "OP" and v == "(":
            self.skip_nl()
            alts = self.parse_alts()
            self.skip_nl()
            nk, nv = self.next()
            if (nk, nv) != ("OP", ")"):
                raise GrammarError(f"expected ')', got {nv!r}")
            return ("group", alts)
        if k == "OP" and v == "[":
            self.skip_nl()
            alts = self.parse_alts()
            self.skip_nl()
            nk, nv = self.next()
            if (nk, nv) != ("OP", "]"):
                raise GrammarError(f"expected ']', got {nv!r}")
            return ("opt", alts)
        if k == "OP" and v == "~":
            # Lark's "up to N" — not needed; treat as error
            raise GrammarError("~ repetition not supported")
        raise GrammarError(f"unexpected token {v!r} in rule body")


# --------------------------------------------------------------------------
# Grammar
# --------------------------------------------------------------------------

_PUNCT_NAMES = {
    "+": "PLUS", "-": "MINUS", "*": "STAR", "/": "SLASH", "(": "LPAR",
    ")": "RPAR", "[": "LSQB", "]": "RSQB", "{": "LBRACE", "}": "RBRACE",
    ",": "COMMA", ":": "COLON", ";": "SEMICOLON", ".": "DOT", "=": "EQUAL",
    "<": "LESSTHAN", ">": "MORETHAN", "!": "BANG", "|": "VBAR", "&": "AMP",
    "%": "PERCENT", "^": "CIRCUMFLEX", "~": "TILDE", "@": "AT", "?": "QMARK",
    '"': "DQUOTE", "'": "QUOTE", "#": "HASH", "$": "DOLLAR", "\\": "BACKSLASH",
}


def _anon_name_for(text: bytes, icase: bool) -> str:
    s = text.decode("utf-8", "replace")
    if _pyre.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", s):
        base = s.upper()
    else:
        parts = [_PUNCT_NAMES.get(ch, f"C{ord(ch)}") for ch in s]
        base = "_".join(parts) or "EMPTY"
    if icase:
        base += "_I"
    return "__" + base


class Grammar:
    """A compiled grammar: terminals (with DFAs), BNF productions, lexer DFA."""

    def __init__(self, text: str, start: str = "start", name: str = "grammar"):
        self.name = name
        self.start = start
        self.terminals: dict[str, Terminal] = {}
        self.ignores: list[str] = []
        # (newline_term, indent_term, dedent_term) when the grammar is
        # layout-sensitive (%indent); None otherwise.
        self.indent_spec: Optional[tuple[str, str, str]] = None
        self.productions: list[Production] = []
        self.nonterminals: set[str] = set()
        self._helper_counter = 0
        self._term_defs: dict[str, tuple[list, int]] = {}  # name -> (alts, prio)
        self._literal_names: dict[tuple[bytes, bool], str] = {}
        self._parse_text(text)
        self._compile_terminals()
        self._build_lexer_dfa()
        self._index()

    # ---------------- parsing the grammar text ----------------

    def _parse_text(self, text: str):
        toks = _tokenize_meta(text)
        p = _DefParser(toks, 0)
        rule_defs: list[tuple[str, list]] = []
        while True:
            p.skip_nl()
            k, v = p.peek()
            if k == "EOF":
                break
            if k == "PCT":
                p.next()
                if v == "%ignore":
                    atom = p.parse_atom()
                    self.ignores.append(self._atom_terminal_name(atom))
                elif v == "%declare":
                    while p.peek()[0] == "NAME":
                        name = p.next()[1]
                        self._term_defs.setdefault(name, ([], 0))
                elif v == "%indent":
                    names = []
                    while p.peek()[0] == "NAME":
                        names.append(p.next()[1])
                    if len(names) != 3:
                        raise GrammarError(
                            "%indent takes exactly three terminal names: "
                            "NEWLINE INDENT DEDENT")
                    self.indent_spec = tuple(names)
                    # INDENT/DEDENT are synthesized by the post-lex pass;
                    # they participate in parsing but never in lexing.
                    for synth in names[1:]:
                        self._term_defs.setdefault(synth, ([], 0))
                elif v == "%import":
                    # consume rest of line
                    while p.peek()[0] not in ("NL", "EOF"):
                        p.next()
                else:
                    raise GrammarError(f"unknown directive {v}")
                continue
            if k != "NAME":
                raise GrammarError(f"expected definition, got {v!r}")
            name_tok = p.next()[1]
            prio = 0
            name = name_tok.lstrip("?!")
            if "." in name:
                name, ps = name.split(".", 1)
                prio = int(ps)
            colon = p.next()
            if colon != ("OP", ":"):
                raise GrammarError(f"expected ':' after {name}")
            p.skip_nl()
            alts = p.parse_alts()
            if name.isupper():
                self._term_defs[name] = (alts, prio)
            else:
                rule_defs.append((name, alts))

        for name, alts in rule_defs:
            self.nonterminals.add(name)
        for name, alts in rule_defs:
            for exp in alts:
                rhs = []
                for item in exp.items:
                    rhs.append(self._lower_item(item))
                self._add_production(name, tuple(rhs))

        if self.start not in self.nonterminals:
            raise GrammarError(f"no start rule {self.start!r}")
        if self.indent_spec is not None:
            nl_alts, _ = self._term_defs.get(self.indent_spec[0], ([], 0))
            if not nl_alts:
                raise GrammarError(
                    f"%indent newline terminal {self.indent_spec[0]!r} "
                    "has no lexer definition")

    def _atom_terminal_name(self, atom) -> str:
        kind = atom[0]
        if kind == "name":
            return atom[1]
        if kind == "str":
            return self._literal_terminal(atom[1], atom[2])
        if kind == "re":
            name = f"__ANONRE_{len(self._term_defs)}"
            self._term_defs[name] = ([_Expansion([_Item(atom)])], 0)
            return name
        raise GrammarError(f"cannot use {kind} here")

    def _literal_terminal(self, text: bytes, icase: bool) -> str:
        key = (text, icase)
        if key not in self._literal_names:
            name = _anon_name_for(text, icase)
            while name in self._term_defs and self._literal_names.get(key) != name:
                name += "_"
            self._literal_names[key] = name
            self._term_defs[name] = ([_Expansion([_Item(("str", text, icase))])], 0)
        return self._literal_names[key]

    def _fresh_nt(self, tag: str) -> str:
        self._helper_counter += 1
        name = f"__{tag}_{self._helper_counter}"
        self.nonterminals.add(name)
        return name

    def _lower_item(self, item: _Item) -> str:
        """Lower one EBNF item to a single symbol name, creating helper rules."""
        sym = self._lower_atom(item.atom)
        if item.quant is None:
            return sym
        if item.quant == "?":
            nt = self._fresh_nt("opt")
            self._add_production(nt, ())
            self._add_production(nt, (sym,))
            return nt
        if item.quant == "*":
            nt = self._fresh_nt("star")
            self._add_production(nt, ())
            self._add_production(nt, (nt, sym))
            return nt
        if item.quant == "+":
            nt = self._fresh_nt("plus")
            self._add_production(nt, (sym,))
            self._add_production(nt, (nt, sym))
            return nt
        raise GrammarError(item.quant)

    def _lower_atom(self, atom) -> str:
        kind = atom[0]
        if kind == "str":
            return self._literal_terminal(atom[1], atom[2])
        if kind == "re":
            return self._atom_terminal_name(atom)
        if kind == "name":
            return atom[1]
        if kind == "group":
            nt = self._fresh_nt("grp")
            for exp in atom[1]:
                rhs = tuple(self._lower_item(it) for it in exp.items)
                self._add_production(nt, rhs)
            return nt
        if kind == "opt":
            nt = self._fresh_nt("opt")
            self._add_production(nt, ())
            for exp in atom[1]:
                rhs = tuple(self._lower_item(it) for it in exp.items)
                self._add_production(nt, rhs)
            return nt
        raise GrammarError(kind)

    def _add_production(self, lhs: str, rhs: tuple):
        self.nonterminals.add(lhs)
        self.productions.append(Production(lhs, rhs, len(self.productions)))

    # ---------------- terminal compilation ----------------

    def _term_ast(self, name: str, visiting=None) -> RNode:
        visiting = visiting or set()
        if name in visiting:
            raise GrammarError(f"recursive terminal {name}")
        if name not in self._term_defs:
            raise GrammarError(f"undefined terminal {name}")
        alts, _ = self._term_defs[name]
        if not alts:
            # %declare'd with no def: never matches (empty alternation over
            # an impossible char class)
            return RChars(frozenset())
        visiting = visiting | {name}
        opts = []
        for exp in alts:
            parts = [self._item_ast(it, visiting) for it in exp.items]
            if not parts:
                opts.append(REpsilon())
            elif len(parts) == 1:
                opts.append(parts[0])
            else:
                opts.append(RConcat(tuple(parts)))
        return opts[0] if len(opts) == 1 else RAlt(tuple(opts))

    def _item_ast(self, item: _Item, visiting) -> RNode:
        node = self._atom_ast(item.atom, visiting)
        if item.quant == "*":
            node = RStar(node)
        elif item.quant == "+":
            node = RPlus(node)
        elif item.quant == "?":
            node = ROpt(node)
        return node

    def _atom_ast(self, atom, visiting) -> RNode:
        kind = atom[0]
        if kind == "str":
            return literal_regex(atom[1], ignore_case=atom[2])
        if kind == "re":
            return parse_regex(atom[1], ignore_case=atom[2])
        if kind == "name":
            return self._term_ast(atom[1], visiting)
        if kind in ("group",):
            opts = []
            for exp in atom[1]:
                parts = [self._item_ast(it, visiting) for it in exp.items]
                opts.append(parts[0] if len(parts) == 1 else
                            (RConcat(tuple(parts)) if parts else REpsilon()))
            return opts[0] if len(opts) == 1 else RAlt(tuple(opts))
        if kind == "opt":
            return ROpt(self._atom_ast(("group", atom[1]), visiting))
        raise GrammarError(kind)

    def _compile_terminals(self):
        used: set[str] = set()
        for prod in self.productions:
            for sym in prod.rhs:
                if sym not in self.nonterminals:
                    used.add(sym)
        used.update(self.ignores)
        for name in used:
            if name not in self._term_defs:
                raise GrammarError(f"undefined symbol {name}")
        # also compile defined-but-unused named terminals that other terminals
        # reference only indirectly -- they don't need DFAs.
        for name in sorted(used):
            alts, prio = self._term_defs[name]
            is_lit = False
            if len(alts) == 1 and len(alts[0].items) == 1:
                it = alts[0].items[0]
                if it.quant is None and it.atom[0] == "str":
                    is_lit = True
            ast = self._term_ast(name)
            term = Terminal(name, ast, priority=prio, from_literal=is_lit)
            term.compile()
            if not term.dfa.live[term.dfa.start] and alts:
                raise GrammarError(f"terminal {name} matches nothing")
            self.terminals[name] = term

    # ---------------- combined lexer DFA ----------------

    def _build_lexer_dfa(self):
        """Union NFA over all terminals, tagged finals by winning terminal."""
        order = sorted(self.terminals)
        nfa = NFA()
        accept_of: dict[int, str] = {}
        for name in order:
            ast = self.terminals[name].ast
            s = nfa.new_state()
            nfa.add_eps(nfa.start, s)
            e = _build(nfa, ast, s)
            accept_of[e] = name

        # subset construction with tags
        import collections
        n = len(nfa.eps)
        eclo = []
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

        def winner(states: frozenset) -> Optional[str]:
            cands = [accept_of[s] for s in states if s in accept_of]
            if not cands:
                return None
            # priority, then literal-over-regex, then name for determinism
            return max(
                cands,
                key=lambda nm: (self.terminals[nm].priority,
                                self.terminals[nm].from_literal,
                                # longer literals not needed: longest-match is
                                # positional; tie at same length/prio -> stable
                                -order.index(nm)),
            )

        start_set = eclo[nfa.start]
        ids = {start_set: 0}
        olist = [start_set]
        queue = collections.deque([start_set])
        rows = []
        while queue:
            cur = queue.popleft()
            row = np.full(256, -1, dtype=np.int64)
            move: dict[int, set] = {}
            for s in cur:
                for chars, succ in nfa.trans[s]:
                    for c in chars:
                        move.setdefault(c, set()).update(eclo[succ])
            cache = {}
            for c, tgt in move.items():
                f = frozenset(tgt)
                if f not in cache:
                    if f not in ids:
                        ids[f] = len(olist)
                        olist.append(f)
                        queue.append(f)
                    cache[f] = ids[f]
                row[c] = cache[f]
            rows.append(row)
        Q = len(olist)
        dead = Q
        trans = np.full((Q + 1, 256), dead, dtype=np.int32)
        for q, row in enumerate(rows):
            v = row >= 0
            trans[q, v] = row[v]
        finals = np.zeros(Q + 1, dtype=bool)
        tags = [None] * (Q + 1)
        for q, st in enumerate(olist):
            w = winner(st)
            if w is not None:
                finals[q] = True
                tags[q] = w
        self.lexer_dfa = DFA(trans, 0, finals)
        self.lexer_tags = tags

    # ---------------- indexing ----------------

    def _index(self):
        self.terminal_names = sorted(self.terminals)
        self.term_id = {t: i for i, t in enumerate(self.terminal_names)}
        self.parse_terminals = [t for t in self.terminal_names
                                if t not in self.ignores]
        self.synthetic_terminals = (frozenset(self.indent_spec[1:])
                                    if self.indent_spec else frozenset())
        # global DFA state numbering for the mask store: concatenate all
        # terminal DFAs; states of terminal i are offset by state_offset[i]
        self.state_offset: dict[str, int] = {}
        off = 0
        for t in self.terminal_names:
            self.state_offset[t] = off
            off += self.terminals[t].dfa.num_states
        self.total_dfa_states = off

    def prods_by_lhs(self):
        by = {}
        for p in self.productions:
            by.setdefault(p.lhs, []).append(p)
        return by

    def __repr__(self):
        return (f"Grammar({self.name}: {len(self.productions)} prods, "
                f"{len(self.terminals)} terminals, "
                f"{self.total_dfa_states} DFA states)")
