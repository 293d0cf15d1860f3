"""Canonical LR(1) / LALR(1) parser-table generator (paper §4.5).

The paper uses LR(1) tables because of the immediate-error-detection
property: `action[state, τ]` being present iff τ is an acceptable next
terminal, which gives O(|Γ|) accept-set computation. We build canonical
LR(1) item sets and optionally merge same-core states (LALR). With LALR
merging, reduce entries may exist for unacceptable terminals, so the
accept-set computation falls back to shift-simulation (also implemented,
in parser.py).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

from .grammar import END, Grammar, Production

ACCEPT_PROD = "$accept"


@dataclass
class LRTable:
    grammar: Grammar
    productions: list            # augmented (prod 0 = $accept -> start $END-implicit)
    action: list                 # state -> dict[term] -> ('s', st)|('r', prodidx)|('acc',)
    goto: list                   # state -> dict[nt] -> state
    start_state: int = 0
    lalr: bool = True

    @property
    def num_states(self):
        return len(self.action)


class LRConflict(ValueError):
    pass


def _compute_first(prods, nonterminals):
    first = {nt: set() for nt in nonterminals}
    nullable = set()
    changed = True
    while changed:
        changed = False
        for p in prods:
            if p.lhs == ACCEPT_PROD:
                tgt = first.setdefault(p.lhs, set())
            else:
                tgt = first[p.lhs]
            n = len(tgt)
            was_nullable = p.lhs in nullable
            all_null = True
            for sym in p.rhs:
                if sym in nonterminals or sym == ACCEPT_PROD:
                    tgt |= first.get(sym, set())
                    if sym not in nullable:
                        all_null = False
                        break
                else:
                    tgt.add(sym)
                    all_null = False
                    break
            if all_null and not was_nullable:
                nullable.add(p.lhs)
                changed = True
            if len(tgt) != n:
                changed = True
    return first, nullable


def build_lr_table(grammar: Grammar, lalr: bool = True) -> LRTable:
    prods = [Production(ACCEPT_PROD, (grammar.start,), 0)]
    for p in grammar.productions:
        prods.append(Production(p.lhs, p.rhs, len(prods)))
    nonterminals = set(grammar.nonterminals) | {ACCEPT_PROD}
    by_lhs = collections.defaultdict(list)
    for p in prods:
        by_lhs[p.lhs].append(p.idx)
    first, nullable = _compute_first(prods, nonterminals)

    def first_of_seq(seq, la):
        out = set()
        for sym in seq:
            if sym in nonterminals:
                out |= first.get(sym, set())
                if sym not in nullable:
                    return out
            else:
                out.add(sym)
                return out
        out.add(la)
        return out

    # item = (prod_idx, dot, lookahead)
    def closure(items: frozenset) -> frozenset:
        out = set(items)
        stack = list(items)
        while stack:
            (pi, d, la) = stack.pop()
            rhs = prods[pi].rhs
            if d < len(rhs) and rhs[d] in nonterminals:
                B = rhs[d]
                las = first_of_seq(rhs[d + 1:], la)
                for qi in by_lhs[B]:
                    for b in las:
                        it = (qi, 0, b)
                        if it not in out:
                            out.add(it)
                            stack.append(it)
        return frozenset(out)

    def goto_set(items: frozenset, X: str) -> frozenset:
        nxt = set()
        for (pi, d, la) in items:
            rhs = prods[pi].rhs
            if d < len(rhs) and rhs[d] == X:
                nxt.add((pi, d + 1, la))
        return closure(frozenset(nxt)) if nxt else frozenset()

    start = closure(frozenset({(0, 0, END)}))
    states = {start: 0}
    order = [start]
    trans: list[dict] = [dict()]
    queue = collections.deque([start])
    while queue:
        st = queue.popleft()
        sid = states[st]
        symbols = set()
        for (pi, d, la) in st:
            rhs = prods[pi].rhs
            if d < len(rhs):
                symbols.add(rhs[d])
        for X in symbols:
            tgt = goto_set(st, X)
            if tgt not in states:
                states[tgt] = len(order)
                order.append(tgt)
                trans.append(dict())
                queue.append(tgt)
            trans[sid][X] = states[tgt]

    if lalr:
        # merge states with identical cores
        core_of = {}
        merged_id = {}
        merged_items: list[set] = []
        for i, st in enumerate(order):
            core = frozenset((pi, d) for (pi, d, la) in st)
            if core not in core_of:
                core_of[core] = len(merged_items)
                merged_items.append(set(st))
            else:
                merged_items[core_of[core]].update(st)
            merged_id[i] = core_of[core]
        new_trans = [dict() for _ in merged_items]
        for i, tr in enumerate(trans):
            for X, j in tr.items():
                new_trans[merged_id[i]][X] = merged_id[j]
        order = [frozenset(s) for s in merged_items]
        trans = new_trans
        start_state = merged_id[0]
    else:
        start_state = 0

    action: list[dict] = [dict() for _ in order]
    goto: list[dict] = [dict() for _ in order]
    conflicts = []
    for sid, st in enumerate(order):
        for X, j in trans[sid].items():
            if X in nonterminals:
                goto[sid][X] = j
            else:
                action[sid][X] = ("s", j)
        for (pi, d, la) in st:
            rhs = prods[pi].rhs
            if d == len(rhs):
                if pi == 0:
                    action[sid][END] = ("acc",)
                    continue
                prev = action[sid].get(la)
                ent = ("r", pi)
                if prev is None:
                    action[sid][la] = ent
                elif prev != ent:
                    if prev[0] == "s":
                        # shift/reduce: prefer shift (matches Lark/yacc default)
                        conflicts.append((sid, la, prev, ent, "sr"))
                    else:
                        conflicts.append((sid, la, prev, ent, "rr"))
                        # deterministic: keep lowest production index
                        if ent[1] < prev[1]:
                            action[sid][la] = ent
    rr = [c for c in conflicts if c[4] == "rr"]
    if rr:
        msgs = []
        for sid, la, prev, ent, _ in rr[:5]:
            msgs.append(f"state {sid} on {la}: {prev} vs {ent} "
                        f"({prods[prev[1]]}) vs ({prods[ent[1]]})")
        raise LRConflict(f"{len(rr)} reduce/reduce conflicts:\n" + "\n".join(msgs))

    return LRTable(grammar=grammar, productions=prods, action=action,
                   goto=goto, start_state=start_state, lalr=lalr)
