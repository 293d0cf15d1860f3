"""Host-side draft proposers for draft-verify speculation.

Structured generation is self-similar — JSON keys, SQL column lists and
code idioms repeat within one response — so the cheapest useful draft
model is the slot's *own* emitted history: find the longest suffix of the
history that occurred earlier, and propose whatever followed it then
(prompt-lookup / lookahead-style drafting, no neural draft model).

Two implementations share the interface {``append(token)``,
``propose(k) -> list[int]``, per-request lifetime}:

  * `SuffixAutomatonProposer` — an online suffix automaton over the
    token stream. `append` is amortized O(1); `propose` walks the suffix
    link chain of the last state to the deepest state whose first
    occurrence ended before the current position, i.e. the LONGEST
    previously-seen suffix, with no fixed n-gram cap.
  * `NGramProposer` — a bounded-n last-occurrence hash index; simpler,
    fixed O(max_n) per append/propose.

Proposers never see the grammar: drafts are filtered against the exact
parser oracle by the scheduler before they reach the verify pass.
"""
from __future__ import annotations


class _SamState:
    __slots__ = ("len", "link", "next", "first_end")

    def __init__(self, length: int, link: int, first_end: int):
        self.len = length
        self.link = link
        self.next = {}
        self.first_end = first_end


class SuffixAutomatonProposer:
    """Online suffix automaton over a slot's emitted token ids.

    min_match: shortest previously-seen suffix worth drafting from —
    1-token coincidences draft mostly-rejected continuations."""

    def __init__(self, min_match: int = 1):
        self.min_match = min_match
        self.states = [_SamState(0, -1, -1)]
        self.last = 0
        self.history: list[int] = []

    # ---- classic SAM extend (Blumer et al.), with first_end tracking ----
    def append(self, token: int) -> None:
        self.history.append(token)
        end = len(self.history) - 1
        sts = self.states
        cur = len(sts)
        sts.append(_SamState(sts[self.last].len + 1, -1, end))
        p = self.last
        while p != -1 and token not in sts[p].next:
            sts[p].next[token] = cur
            p = sts[p].link
        if p == -1:
            sts[cur].link = 0
        else:
            q = sts[p].next[token]
            if sts[p].len + 1 == sts[q].len:
                sts[cur].link = q
            else:
                clone = len(sts)
                cs = _SamState(sts[p].len + 1, sts[q].link,
                               sts[q].first_end)
                cs.next = dict(sts[q].next)
                sts.append(cs)
                while p != -1 and sts[p].next.get(token) == q:
                    sts[p].next[token] = clone
                    p = sts[p].link
                sts[q].link = clone
                sts[cur].link = clone
        self.last = cur

    def extend(self, tokens) -> None:
        for t in tokens:
            self.append(t)

    def match_len(self) -> int:
        """Length of the longest suffix of the history that also occurs
        earlier (0 if none)."""
        st = self._earlier_state()
        return self.states[st].len if st else 0

    def _earlier_state(self) -> int:
        """Deepest suffix-link ancestor of `last` whose first occurrence
        ended before the current end — i.e. the longest suffix with an
        earlier occurrence. 0 (root) means no such suffix."""
        n = len(self.history)
        p = self.last
        while p != -1 and self.states[p].first_end >= n - 1:
            p = self.states[p].link
        return max(p, 0)

    def propose(self, k: int) -> list:
        if k <= 0 or len(self.history) < 2:
            return []
        st = self._earlier_state()
        if st == 0 or self.states[st].len < self.min_match:
            return []
        cont = self.states[st].first_end + 1   # index after the earlier hit
        return self.history[cont: cont + k]


class NGramProposer:
    """Last-occurrence n-gram index (bounded context, O(max_n) updates)."""

    def __init__(self, max_n: int = 4, min_match: int = 1):
        self.max_n = max_n
        self.min_match = max(1, min_match)
        self.history: list[int] = []
        self._index: dict = {}     # ngram tuple -> position AFTER occurrence

    def append(self, token: int) -> None:
        self.history.append(token)
        h = self.history
        i = len(h) - 1             # continuations of grams ending at i-1
        for L in range(1, self.max_n + 1):
            if i - L < 0:
                break
            self._index[tuple(h[i - L: i])] = i

    def extend(self, tokens) -> None:
        for t in tokens:
            self.append(t)

    def propose(self, k: int) -> list:
        h = self.history
        n = len(h)
        if k <= 0 or n < 2:
            return []
        for L in range(min(self.max_n, n - 1), self.min_match - 1, -1):
            pos = self._index.get(tuple(h[n - L:]))
            if pos is not None and pos < n:
                return h[pos: pos + k]
        return []


def make_proposer(kind: str = "sam", ngram_n: int = 4, min_match: int = 1):
    if kind == "sam":
        return SuffixAutomatonProposer(min_match=min_match)
    if kind == "ngram":
        return NGramProposer(max_n=ngram_n, min_match=min_match)
    raise ValueError(f"unknown proposer kind: {kind}")
