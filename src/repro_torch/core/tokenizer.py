"""Deterministic synthetic byte-level tokenizer.

The offline container has no pretrained tokenizers, but the paper's core
difficulty — *token misalignment* (LLM tokens spanning / splitting grammar
terminals) — only needs a vocabulary of multi-byte tokens that cross
terminal boundaries. This tokenizer is BPE-shaped: 256 byte tokens plus a
deterministic list of multi-byte merges (keywords with/without leading
space, punctuation bigrams, digit pairs, letter n-grams). `encode` is
greedy longest-match (maximal munch over the vocab trie), mirroring how a
trained BPE behaves on code-like text.

ids: 0=PAD, 1=EOS, 2=BOS, 3..258 = single bytes, 259.. = merges.
"""
from __future__ import annotations

import string

PAD_ID, EOS_ID, BOS_ID = 0, 1, 2
_NUM_SPECIAL = 3

_KEYWORDS = [
    "true", "false", "null", "fn", "let", "if", "else", "while", "for",
    "in", "return", "break", "continue", "struct", "int", "float", "str",
    "bool", "nil", "math_exp", "math_sqrt", "math_sin", "math_cos", "math",
    "select", "from", "where", "group", "by", "order", "having", "limit",
    "join", "on", "as", "and", "or", "not", "count", "sum", "avg", "min",
    "max", "distinct", "between", "like", "exists", "union", "left",
    "right", "inner", "asc", "desc", "offset", "is",
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "ORDER", "HAVING", "LIMIT",
    "JOIN", "ON", "AS", "AND", "OR", "NOT", "COUNT", "SUM", "AVG", "MIN",
    "MAX", "DISTINCT", "BETWEEN", "LIKE", "EXISTS", "UNION",
    "name", "value", "type", "id", "key", "data", "list", "item", "index",
    "result", "args", "len", "total", "self", "this", "print", "range",
    # python keywords (python_mini): make real token/terminal misalignment
    # — "def" is one token but also a NAME prefix ("define"), "None"/"True"
    # straddle the keyword-vs-NAME choice the mask must keep open
    "def", "class", "elif", "pass", "None", "True", "False", "import",
    "lambda", "yield", "def ", "return ", "    ",
]
_PUNCT_MERGES = [
    '":', '",', '" ', ' "', '{"', '"}', '):', ');', ')(', '()', '())',
    '();', '[]', '{}', '))', '((', '],', '};', ', ', ': ', '; ', ' (',
    ' )', ' {', ' }', ' [', ' ]', ' =', '= ', ' == ', ' != ', ' <= ',
    ' >= ', ' < ', ' > ', ' + ', ' - ', ' * ', ' / ', ' && ', ' || ',
    '->', '=>', '//', '/*', '*/', '\n\n', '\n  ', '\n    ', '    ',
    '  ', '."', '".', '...', 'e+', 'e-', 'E+', '0.', '1.', '("', '")',
]


def _merge_strings(vocab_size: int) -> list[bytes]:
    """Deterministic multi-byte token list, most useful first."""
    out: list[bytes] = []
    seen: set[bytes] = set()

    def add(s):
        b = s.encode() if isinstance(s, str) else s
        if len(b) >= 2 and b not in seen:
            seen.add(b)
            out.append(b)

    for kw in _KEYWORDS:
        add(kw)
        add(" " + kw)
    for pm in _PUNCT_MERGES:
        add(pm)
    for a in "0123456789":
        for b in "0123456789":
            add(a + b)
    letters = "etaoinshrdlucmfwypvbgkqjxz"
    for a in letters:
        for b in letters:
            add(a + b)
    for a in letters[:12]:
        add(" " + a)
    for a in letters[:12]:
        for b in letters[:12]:
            for c in letters[:12]:
                add(a + b + c)
                if len(out) > vocab_size:  # enough material
                    return out
    # fallback filler: longer digit strings
    i = 0
    while len(out) <= vocab_size:
        add(f"{i:04d}")
        i += 1
    return out


class ByteTokenizer:
    def __init__(self, vocab_size: int = 2048):
        if vocab_size < _NUM_SPECIAL + 256 + 16:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size
        self.id_to_bytes: list[bytes] = [b"", b"", b""]  # PAD, EOS, BOS
        for b in range(256):
            self.id_to_bytes.append(bytes([b]))
        n_merges = vocab_size - len(self.id_to_bytes)
        merges = _merge_strings(n_merges)[:n_merges]
        self.id_to_bytes.extend(merges)
        assert len(self.id_to_bytes) == vocab_size
        # trie for greedy longest-match encode
        self._trie: dict = {}
        for tid, tb in enumerate(self.id_to_bytes):
            if tid < _NUM_SPECIAL:
                continue
            node = self._trie
            for ch in tb:
                node = node.setdefault(ch, {})
            node[-1] = tid
        self.max_token_len = max(len(b) for b in self.id_to_bytes)

    def encode(self, data: bytes | str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        if isinstance(data, str):
            data = data.encode("utf-8")
        ids = [BOS_ID] if add_bos else []
        i, n = 0, len(data)
        while i < n:
            node = self._trie
            best = None
            j = i
            while j < n and data[j] in node:
                node = node[data[j]]
                j += 1
                if -1 in node:
                    best = (node[-1], j)
            tid, i = best  # single bytes always match, so best is never None
            ids.append(tid)
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids) -> bytes:
        return b"".join(self.id_to_bytes[int(t)] for t in ids
                        if int(t) >= _NUM_SPECIAL)

    def decode_str(self, ids) -> str:
        return self.decode(ids).decode("utf-8", "replace")

    def token_bytes(self) -> list[bytes]:
        """Per-id byte strings (specials are b'')."""
        return list(self.id_to_bytes)

    @property
    def num_special(self):
        return _NUM_SPECIAL
