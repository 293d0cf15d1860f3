"""Online grammar-mask computation (paper Algorithm 2 + §4.3), on top of
the context-split mask store (docs/architecture.md).

Per decoding step the host no longer unions accept-row sets. It:

  1. groups the accept sequences by first terminal τ1 — walks τ1's DFA
     on the remainder ONCE per live terminal (not once per sequence)
     and ORs each sequence into a per-state accept-bits word (bit 0 =
     the length-1 α=0 sequence, bit 1+tid(τ2) = follow terminal τ2);
  2. emits precomputed store ROW IDS for everything the offline
     classification resolved: the group's base row (family M0 when the
     α=0 bit is set, else the shared CI row), the follow terminals'
     start-state rows when the walk landed in F (position-0 splits),
     and the legacy M1 rows the classifier marked big (`cd_big`);
  3. overlays the remaining context-dependent residue — a few tokens
     per step on the builtin grammars — as a packed [W] uint32 word
     vector scatter from the store's `cd_token`/`cd_follow` tables.

The union of (rows ∪ residue words) is BITWISE equal to the legacy
full accept-row union (tests/test_context_split.py fuzzes this), so
token-for-token output identity holds in every serving mode; only
*where* the bits come from changed. The expensive part — ORing the
rows and applying mask+sample to the logits — runs on the accelerator
(`repro.kernels.fused_select`, the paper's GPU-offload adapted to TPU).

`GrammarConstraint` also implements the paper's *opportunistic masking*
(§5 Baselines, Beurer-Kellner et al. 2024): first let the model propose a
token, and only compute the full mask if the proposal is syntactically
invalid.

Two mask modes select between the store's row families
(docs/grammars.md): `grammar_mask` (default — the paper's sound
overapproximation) and `grammar_strict` (terminal-boundary-aligned
underapproximation; strict ⊆ mask bitwise). Both families SHARE the
context-independent rows; the mode picks the family's M0/M1 rows and
which half of the residue tables applies.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .grammar import Grammar
from .lexer import LexError
from .lr import LRTable
from .mask_store import MaskStore
from .parser import IncrementalParser, ParseError
from .tokenizer import ByteTokenizer, EOS_ID


# base accept-row width: the batched engine's [B, A] row matrix uses
# one A for every slot, so the default lives here rather than per-call.
# This is a PADDING bucket, never a cap — steps whose row set overflows
# it get a wider (power-of-two multiple) row vector, so the mask always
# covers EVERY accept sequence (paper soundness; a silent cap here
# over-constrains the mask and bans grammar-valid tokens). With the
# context split the emitted rows are deduplicated per group, so typical
# steps use a handful of rows and the bucket rarely grows.
MAX_ACCEPT = 48


def accept_width(n_rows: int, base: int = MAX_ACCEPT) -> int:
    """Smallest power-of-two multiple of `base` holding n_rows rows.

    Row vectors/matrices are padded to these buckets so the jitted fused
    mask+sample call specializes once per bucket (wide accept sets are
    rare) instead of once per distinct row count."""
    a = max(1, int(base))
    while a < n_rows:
        a *= 2
    return a


@dataclass
class StepGroups:
    """Result of the accept-sequence grouping (the ci_lookup stage)."""
    groups: dict                 # global DFA state -> accept-bits int
    eos_allowed: bool
    num_sequences: int           # |A| before grouping (diagnostics)


@dataclass
class StepMask:
    """Host-side result for one sequence at one decoding step."""
    rows: np.ndarray          # [>= max_accept] int32 store row ids, -1 pad
                              # (width grows in accept_width buckets; the
                              # valid prefix + cd_words cover ALL accept
                              # sequences)
    eos_allowed: bool
    num_sequences: int        # |A| before grouping (diagnostics)
    cd_words: np.ndarray = field(default=None, repr=False)
                              # [W] uint32 context-dependent residue
                              # overlay, ORed into the row union on
                              # device (None == all-zero)


class GrammarConstraint:
    """Per-sequence constrained-decoding state (owns an incremental parser)."""

    MODES = ("grammar_mask", "grammar_strict")

    def __init__(self, grammar: Grammar, table: LRTable, store: MaskStore,
                 tokenizer: ByteTokenizer, max_accept: int = MAX_ACCEPT,
                 mode: str = "grammar_mask"):
        if mode not in self.MODES:
            raise ValueError(f"unknown grammar mode {mode!r}; "
                             f"expected one of {self.MODES}")
        self.grammar = grammar
        self.store = store
        self.tokenizer = tokenizer
        self.parser = IncrementalParser(grammar, table)
        self.max_accept = max_accept
        self.mode = mode
        self._stride = store.row_stride
        # the two approximation families share state addressing AND the
        # context-independent rows; the family index only selects the
        # M0/M1 half of the packed store and the residue-table half, so
        # everything downstream (batched row matrices, the device union
        # kernel, jump-forward popcounts) is mode-oblivious
        self._fam = 1 if mode == "grammar_strict" else 0
        # persistent per-step residue caches: the parser returns the
        # SAME accept_sequences object while the stack configuration
        # repeats (its seq memo), so the per-first-terminal walk plan,
        # the row-id emission, and the residue overlay all collapse to
        # dict hits on consecutive decode steps. All values are shared
        # read-only; keys are pure functions of the inputs.
        self._plan_memo: dict[int, tuple] = {}
        self._sg_memo: dict[tuple, tuple] = {}
        self._sg_last: "tuple | None" = None
        self._rows_memo: dict[tuple, list] = {}
        self._rows_fast: dict[int, tuple] = {}
        self._arr_fast: dict[tuple, tuple] = {}
        self._cd_fast: dict[int, tuple] = {}
        self._cd_memo: dict[tuple, "np.ndarray | None"] = {}
        # whole-batch result memos (hosted on the batch's first live
        # constraint): while every slot's walk states are saturated the
        # assembled [B, A] row matrix / [B, W] residue matrix repeat
        # verbatim, so the batch stages return the SAME arrays — callers
        # (the engine dispatch) treat them as read-only.
        self._batch_memo: dict[tuple, tuple] = {}
        self._cd_batch_memo: dict[tuple, tuple] = {}
        # incremental remainder walk: (plan entry, remainder, states).
        # walk(start, r) restarts from the previous step's states when r
        # only grew — the common case while a lexeme is being extended —
        # so each step walks O(|delta|) bytes, not O(|r|).
        self._walk: "tuple | None" = None

    _MEMO_CAP = 1 << 12

    def reset(self):
        self.parser.reset_cache()
        self._walk = None

    # ---- Algorithm 2 (host part), stage 1: accept sequences -> groups --

    def step_groups(self, partial_output: bytes) -> StepGroups:
        """Parse + one DFA walk per live first-terminal: the accept
        sequences collapse into {global state: accept bits} (bit 0 =
        α=0 sequence present, bit 1+tid(τ2) = follow terminal τ2).

        The per-first-terminal plan (t1 -> OR of accept bits, in first-
        occurrence order) depends only on the accept_sequences object —
        which the parser's seq memo returns shared across steps — so it
        is cached by object identity; only the remainder walk (O(|r|)
        per distinct t1) runs every step."""
        res = self.parser.partial_parse(partial_output)
        r = res.remainder
        grammar = self.grammar
        seqs = res.accept_sequences
        ent = self._plan_memo.get(id(seqs))
        if ent is None or ent[0] is not seqs:
            bits_by_t1: dict[str, int] = {}
            term_id = grammar.term_id
            for seq in seqs:
                bit = (1 if len(seq) == 1
                       else 1 << (1 + term_id[seq[1]]))
                t1 = seq[0]
                bits_by_t1[t1] = bits_by_t1.get(t1, 0) | bit
            plan = [(grammar.terminals[t1].dfa, grammar.state_offset[t1],
                     bits) for t1, bits in bits_by_t1.items()]
            if len(self._plan_memo) >= self._MEMO_CAP:
                self._plan_memo.clear()
            # the seqs reference keeps the id() stable for the cache key
            ent = (seqs, plan)
            self._plan_memo[id(seqs)] = ent
        plan = ent[1]
        w = self._walk
        if w is not None and w[0] is ent and len(r) >= len(w[1]) \
                and r.startswith(w[1]):
            qs = w[2]
            delta = r[len(w[1]):]
            if delta:
                qs = [p[0].walk_live(q, delta)
                      for p, q in zip(plan, qs)]
        else:
            qs = [dfa.walk_live(dfa.start, r) for dfa, _off, _bits in plan]
        self._walk = (ent, r, qs)
        # share ONE groups dict per (plan, walk states): the walks
        # saturate inside a growing lexeme, so consecutive steps reuse
        # the same object — and the row/residue stages can then memoize
        # by object identity instead of re-hashing the contents.
        eos = res.eos_allowed
        last = self._sg_last
        if last is not None and last[0] is ent and qs == last[1] \
                and last[2].eos_allowed == eos:
            return last[2]
        skey = (id(ent), tuple(qs))
        hit = self._sg_memo.get(skey)
        if hit is not None and hit[0] is ent:
            sg = hit[1]
            if sg.eos_allowed != eos:
                sg = StepGroups(groups=sg.groups, eos_allowed=eos,
                                num_sequences=len(seqs))
                self._sg_memo[skey] = (ent, sg)
            self._sg_last = (ent, qs, sg)
            return sg
        groups: dict[int, int] = {}
        for i, (dfa, off, bits) in enumerate(plan):
            q = qs[i]
            if dfa.live[q]:
                groups[off + q] = bits
        sg = StepGroups(groups=groups, eos_allowed=eos,
                        num_sequences=len(seqs))
        if len(self._sg_memo) >= self._MEMO_CAP:
            self._sg_memo.clear()
        self._sg_memo[skey] = (ent, sg)
        self._sg_last = (ent, qs, sg)
        return sg

    # ---- stage 2: groups -> precomputed store row ids (ci_lookup) ------

    def group_rows(self, groups: dict) -> list:
        """Deduplicated store row ids covering everything the offline
        classification precomputed: base row (family M0 / shared CI),
        position-0 follow-split start rows, and big-residue M1 rows.
        Memoized on the groups signature (walk states saturate inside a
        growing lexeme, so consecutive steps repeat it); the returned
        list is shared and read-only."""
        fast = self._rows_fast.get(id(groups))
        if fast is not None and fast[0] is groups:
            return fast[1]
        gkey = tuple(groups.items())
        cached = self._rows_memo.get(gkey)
        if cached is not None:
            if len(self._rows_fast) >= self._MEMO_CAP:
                self._rows_fast.clear()
            self._rows_fast[id(groups)] = (groups, cached)
            return cached
        st = self.store
        fam = self._fam
        stride = self._stride
        fam_off = fam * st.strict_offset
        rows: list[int] = []
        seen = set()
        for s0, bits in groups.items():
            base = (fam_off + s0 * stride if bits & 1
                    else st.strict_offset + s0 * stride)
            if base not in seen:
                seen.add(base)
                rows.append(base)
            fbits = bits & ~1
            if not fbits:
                continue
            if st.state_finals[s0]:
                fb = fbits >> 1
                g = 0
                while fb:
                    if fb & 1:
                        rid = st.row_follow_start(fam, g)
                        if rid not in seen:
                            seen.add(rid)
                            rows.append(rid)
                    fb >>= 1
                    g += 1
            bigsel = st.cd_big_bits(fam, s0) & fbits
            while bigsel:
                j = bigsel.bit_length() - 1          # j = 1 + tid(τ_g)
                rid = fam_off + s0 * stride + j
                if rid not in seen:
                    seen.add(rid)
                    rows.append(rid)
                bigsel &= ~(1 << j)
        if len(self._rows_memo) >= self._MEMO_CAP:
            self._rows_memo.clear()
        self._rows_memo[gkey] = rows
        if len(self._rows_fast) >= self._MEMO_CAP:
            self._rows_fast.clear()
        self._rows_fast[id(groups)] = (groups, rows)
        return rows

    def _rows_array(self, rows: list, off: int) -> np.ndarray:
        """int32 view of a (shared, memoized) row-id list with the slot's
        store offset pre-added; cached per (row list, offset) since both
        repeat across steps. Read-only."""
        key = (id(rows), off)
        hit = self._arr_fast.get(key)
        if hit is not None and hit[0] is rows:
            return hit[1]
        arr = np.array(rows, dtype=np.int32)
        if off:
            arr += np.int32(off)
        if len(self._arr_fast) >= self._MEMO_CAP:
            self._arr_fast.clear()
        self._arr_fast[key] = (rows, arr)
        return arr

    # ---- stage 3: groups -> residue overlay words (cd_check) -----------

    def cd_overlay(self, groups: dict) -> np.ndarray | None:
        """[W] uint32 packed overlay of the context-dependent residue
        selected by the accept bits, or None when no residue token is
        selected (the common case on the builtin grammars). Memoized on
        the groups signature; callers copy the returned words, never
        mutate them."""
        fast = self._cd_fast.get(id(groups))
        if fast is not None and fast[0] is groups:
            return fast[1]
        gkey = tuple(groups.items())
        if gkey in self._cd_memo:
            out = self._cd_memo[gkey]
            if len(self._cd_fast) >= self._MEMO_CAP:
                self._cd_fast.clear()
            self._cd_fast[id(groups)] = (groups, out)
            return out
        st = self.store
        fam = self._fam
        out = None
        for s0, bits in groups.items():
            fbits = bits & ~1
            if not fbits:
                continue
            lo, hi = st.cd_range(fam, s0)
            if hi <= lo:
                continue
            fol = st.cd_follow[lo:hi]
            if st.follow_words == 1:
                sel = (fol[:, 0] & np.uint64(fbits)) != 0
            else:
                fw = np.array([(fbits >> (64 * k)) & 0xFFFFFFFFFFFFFFFF
                               for k in range(st.follow_words)],
                              dtype=np.uint64)
                sel = (fol & fw[None, :]).any(axis=1)
            if sel.any():
                if out is None:
                    out = np.zeros(st.num_words, dtype=np.uint32)
                np.bitwise_or.at(out, st.cd_word[lo:hi][sel],
                                 st.cd_bit[lo:hi][sel])
        if len(self._cd_memo) >= self._MEMO_CAP:
            self._cd_memo.clear()
        self._cd_memo[gkey] = out
        if len(self._cd_fast) >= self._MEMO_CAP:
            self._cd_fast.clear()
        self._cd_fast[id(groups)] = (groups, out)
        return out

    # ---- composed per-sequence step (sequential engine, tests) ---------

    def step_rows(self, partial_output: bytes) -> StepMask:
        sg = self.step_groups(partial_output)
        rows = self.group_rows(sg.groups)
        arr = np.full(accept_width(len(rows), self.max_accept), -1,
                      dtype=np.int32)
        arr[:len(rows)] = rows
        return StepMask(rows=arr, eos_allowed=sg.eos_allowed,
                        num_sequences=sg.num_sequences,
                        cd_words=self.cd_overlay(sg.groups))

    # ---- batched host side of Algorithm 2 (one row matrix per step) -----

    @staticmethod
    def ci_rows_batch(constraints, texts, max_accept: int = MAX_ACCEPT,
                      row_offsets=None):
        """The ci_lookup stage for a batch: parse, group, and emit the
        precomputed row ids per slot.

        constraints: length-B list of GrammarConstraint or None (None =
        unconstrained slot -> all-pad rows, eos False). texts: length-B
        list of partial outputs (bytes). row_offsets: optional [B] int
        offsets shifting each slot's row ids into a store concatenated
        across grammars (the engine keeps one device array for all
        grammars; a slot's rows index its grammar's block).

        Returns (rows [B, A] int32 with -1 pad, eos_allowed [B] bool,
        num_sequences [B] int32, groups_list length-B) — the groups are
        handed to `cd_overlay_batch` so the engine can time the residue
        stage separately. `max_accept` is the BASE width of A: when some
        slot's row set overflows it, A grows to the next accept_width
        bucket so no row is ever dropped (soundness)."""
        B = len(constraints)
        per_slot = []
        A = max_accept
        first = None
        for b, gc in enumerate(constraints):
            if gc is None:
                per_slot.append(None)
                continue
            if first is None:
                first = gc
            sg = gc.step_groups(texts[b])
            r = gc.group_rows(sg.groups)
            if len(r) > A:
                A = accept_width(len(r), max_accept)
            per_slot.append((sg, r))
        # whole-batch memo: same per-slot (groups, eos, offset) -> the
        # exact same output arrays (same groups => same rows => same A;
        # nseq is a function of the accept plan the groups came from).
        # id() keys are validated against kept references before use.
        klist = []
        for b, item in enumerate(per_slot):
            if item is None:
                klist.append(-1)
            else:
                klist.append(id(item[0].groups))
                klist.append(item[0].eos_allowed)
                klist.append(0 if row_offsets is None
                             else int(row_offsets[b]))
        key = tuple(klist)
        if first is not None:
            hit = first._batch_memo.get(key)
            if hit is not None:
                refs = hit[0]
                for b, item in enumerate(per_slot):
                    if item is None:
                        if refs[b] is not None:
                            hit = None
                            break
                    elif refs[b] is not item[0].groups:
                        hit = None
                        break
                if hit is not None:
                    return hit[1]
        rows = np.full((B, A), -1, dtype=np.int32)
        eos = np.zeros(B, dtype=bool)
        nseq = np.zeros(B, dtype=np.int32)
        groups_list = [None] * B
        for b, item in enumerate(per_slot):
            if item is None:
                continue
            sg, r = item
            off = int(row_offsets[b]) if row_offsets is not None else 0
            arr = constraints[b]._rows_array(r, off)
            rows[b, :arr.size] = arr
            eos[b] = sg.eos_allowed
            nseq[b] = sg.num_sequences
            groups_list[b] = sg.groups
        if first is not None:
            memo = first._batch_memo
            if len(memo) >= GrammarConstraint._MEMO_CAP:
                memo.clear()
            memo[key] = (tuple(g for g in groups_list),
                         (rows, eos, nseq, groups_list))
        return rows, eos, nseq, groups_list

    @staticmethod
    def cd_overlay_batch(constraints, groups_list, num_words: int):
        """The cd_check stage for a batch: [B, W] uint32 residue words
        (all-zero rows for unconstrained or residue-free slots)."""
        B = len(constraints)
        first = None
        for gc in constraints:
            if gc is not None:
                first = gc
                break
        klist = [num_words]
        for g in groups_list:
            klist.append(-1 if g is None else id(g))
        key = tuple(klist)
        if first is not None:
            hit = first._cd_batch_memo.get(key)
            if hit is not None:
                refs = hit[0]
                for b, g in enumerate(groups_list):
                    if (refs[b] is not g) if g is not None \
                            else (refs[b] is not None):
                        hit = None
                        break
                if hit is not None:
                    return hit[1]
        cd = np.zeros((B, num_words), dtype=np.uint32)
        for b, gc in enumerate(constraints):
            if gc is None or groups_list[b] is None:
                continue
            w = gc.cd_overlay(groups_list[b])
            if w is not None:
                cd[b] = w
        if first is not None:
            memo = first._cd_batch_memo
            if len(memo) >= GrammarConstraint._MEMO_CAP:
                memo.clear()
            memo[key] = (tuple(g for g in groups_list), cd)
        return cd

    @staticmethod
    def step_rows_batch(constraints, texts, max_accept: int = MAX_ACCEPT,
                        row_offsets=None):
        """Composed batch step: (rows [B, A], cd [B, W], eos [B],
        nseq [B]). The engine's dispatch path calls the two stages
        directly to attribute ci_lookup and cd_check separately."""
        rows, eos, nseq, groups_list = GrammarConstraint.ci_rows_batch(
            constraints, texts, max_accept, row_offsets)
        W = 0
        for gc in constraints:
            if gc is not None:
                W = gc.store.num_words
                break
        cd = GrammarConstraint.cd_overlay_batch(constraints, groups_list,
                                                W or 1)
        return rows, cd, eos, nseq

    # ---- packed union (host reference; device path is in kernels/) -----

    def union_packed(self, sm: StepMask) -> np.ndarray:
        """OR of the step's store rows and residue overlay — the exact
        packed mask the device computes."""
        packed = self.store.union_rows(sm.rows)
        if sm.cd_words is not None:
            packed |= sm.cd_words
        return packed

    # ---- forced-continuation query (speculation / jump-forward) ---------

    def forced_step(self, partial_output: bytes):
        """Classify this step's mask for the jump-forward analyzer.

        Returns (kind, token, step_mask):
          ("token", t, sm) — exactly one token survives the mask union,
                         EOS is not allowed, and t passes the exact
                         oracle: the grammar (as seen through this step's
                         row set + residue — the same bits the engine
                         masks with) forces t, so it can be emitted
                         without a model call.
          ("eos", None, sm)  — mask empty but C_k ∈ L(G): EOS is forced.
          ("dead", None, sm) — mask empty and EOS disallowed (the
                         engine's mask_exhausted outcome).
          ("free", None, sm) — more than one candidate; the model must
                         choose. The returned StepMask is this step's row
                         set, so the caller can mask without recomputing.

        Fast path: the union can only collapse to <= 1 token if every
        member row allows <= 1 (build-time per-row popcount gather) and
        the residue overlay is empty — decided without touching the
        packed words.
        """
        sm = self.step_rows(partial_output)
        valid = sm.rows[sm.rows >= 0]
        if valid.size and int(self.store.row_popcounts()[valid].max()) > 1:
            return ("free", None, sm)
        packed = self.union_packed(sm)              # one union feeds both
        n = self.store.popcount_packed(packed)
        if n == 0:
            return (("eos", None, sm) if sm.eos_allowed
                    else ("dead", None, sm))
        if n == 1 and not sm.eos_allowed:
            t = self.store.sole_from_packed(packed)
            if t is not None and self.is_valid_extension(partial_output, t):
                return ("token", t, sm)
            # sole candidate is a mask over-approximation the oracle
            # rejects: the exact allowed set is empty (matches the plain
            # engine's demote -> exhausted path)
            return ("dead", None, sm)
        return ("free", None, sm)

    # ---- host reference mask (numpy; the device path lives in kernels/) --

    def token_mask(self, partial_output: bytes) -> np.ndarray:
        """Full boolean vocab mask (reference / tests / CPU serving)."""
        sm = self.step_rows(partial_output)
        mask = self.store.unpack(self.union_packed(sm))
        if sm.eos_allowed:
            mask[EOS_ID] = True
        return mask

    # ---- validity oracle (used by tests and opportunistic masking) ------

    def is_valid_extension(self, partial_output: bytes, token_id: int) -> bool:
        """partial_output + token stays in L_p(G)?

        Never over-approximates (safe for the opportunistic fast path):
        the parse must succeed AND the remainder must still be a viable
        prefix of some *acceptable* terminal. It may under-approximate in
        the rare case where the final lexical token's type must change in
        the future — then the caller just falls back to the mask.
        """
        if token_id == EOS_ID:
            return self.parser.partial_parse(partial_output).eos_allowed
        tb = self.tokenizer.id_to_bytes[token_id]
        if not tb:
            return False
        try:
            # incremental: the prefix-stack cache makes the hypothetical
            # extension O(delta); a rejected hypothesis merely truncates
            # the cache back on the next prefix-diverging call
            res = self.parser.partial_parse(partial_output + tb)
        except (ParseError, LexError):
            return False
        if not res.remainder:
            return True
        if res.eos_allowed:
            # the extended text is itself a complete sentence (exact:
            # eos_allowed shifts the final token and checks acceptance).
            # Without this, a grammar with NO ignore terminals rejected
            # the token that exactly completes the sentence — the accept
            # sequences only describe CONTINUATIONS of the remainder
            return True
        for seq in res.accept_sequences:
            dfa = self.grammar.terminals[seq[0]].dfa
            q = dfa.walk_live(dfa.start, res.remainder)
            if dfa.live[q]:
                return True
        return False
