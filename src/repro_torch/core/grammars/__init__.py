"""Builtin grammars (paper §4.7: "shipped with several built-in grammars").

`load_grammar(name)` compiles (and memoizes) the grammar + LR table.
The builtin definitions are embedded in `builtin_defs.py` (no data files
required); users add or override grammars by dropping `<name>.lark` files
here or calling `Grammar(text)` directly.
"""
from __future__ import annotations

import os

from ..grammar import Grammar
from ..lr import build_lr_table
from .builtin_defs import EMBEDDED

_DIR = os.path.dirname(__file__)
_CACHE: dict[tuple[str, bool], tuple] = {}

BUILTIN = ("json", "calc", "sql", "minilang", "jsonmsg", "python_mini")


def grammar_text(name: str) -> str:
    path = os.path.join(_DIR, f"{name}.lark")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    if name in EMBEDDED:
        return EMBEDDED[name]
    raise FileNotFoundError(f"no builtin grammar {name!r}; have {BUILTIN}")


def load_grammar(name: str, lalr: bool = True):
    """Returns (Grammar, LRTable), memoized per-process."""
    key = (name, lalr)
    if key not in _CACHE:
        g = Grammar(grammar_text(name), name=name)
        t = build_lr_table(g, lalr=lalr)
        _CACHE[key] = (g, t)
    return _CACHE[key]
