"""The DFA mask store (paper §4.3, Def. 12) — precomputed offline.

For every live DFA state `q` (over all terminals' DFAs, globally numbered)
the store holds packed boolean vocabulary masks:

  * M0 row  — tokens t with dmatch(t, q, ())          [α = 0]
  * M1 rows — tokens t with dmatch(t, q, (τ',)) per τ' [α = 1]

dmatch (Def. 10) decomposes, for a token t walked from q on terminal τ's
DFA, into:
  cond 1: the walk ends in a live state of D_τ
  cond 2: some *proper* prefix of t lands in F_τ (α = 0 only)
  cond 3: some prefix (incl. ε and all of t) lands in F_τ and the rest of
          t "pmatches" τ' from its start state (α = 1)

Construction is vectorized with numpy over the whole vocabulary at once:
tokens are a padded [V, L] byte matrix; a DFA walk from any state is L
gather steps over the transition table. Complexity matches the paper's
O(|Q_Ω|·|V|·|Γ|^α) with tiny constants; stores are cached on disk keyed by
(grammar, vocab) fingerprints (paper §6.4 reports one-time costs only).

The store holds TWO row families over the same state addressing:

  * grammar_mask rows (the paper's dmatch, OVERapproximate): a token is
    kept if any tokenization could keep the text in L_p(G) — including
    tokens that overshoot a terminal boundary into arbitrary bytes
    (cond 2 / the "rest of t is arbitrary" allowance of cond 3).
  * grammar_strict rows (UNDERapproximate, terminal-boundary-aligned):
    the overshoot allowances are dropped — a token survives only if its
    bytes walk entirely inside the current terminal (cond 1), or split
    exactly once at a final state of the current terminal with the rest
    walking live inside the single lookahead terminal τ'. Strict masks
    never admit a token the mask family bans (strict ⊆ mask, bitwise),
    at the cost of banning some tokens an exact oracle would allow.

Row layout (used by the serving kernel): row(q, α=0) = q·(|Γ|+1);
row(q, τ') = q·(|Γ|+1) + 1 + tid(τ'). The strict family is the same
layout shifted by `strict_offset` = total_states·(|Γ|+1); the packed
array is [2R, W]. Packed as uint32 little-endian bit-words: word w bit
b ⇔ token id w·32+b.

The per-state build is shardable: `build_rows_shard` computes the rows
for any global-state range (the offline parallel builder
`scripts/build_mask_store.py` farms shards to worker processes) and
`assemble_store` concatenates shard outputs and atomically publishes
the store through the fingerprinted disk cache.

Context split (layout v4, XGrammar-style): every (state, token) pair is
classified offline into a context-INDEPENDENT majority — acceptance
decided by the DFA walk alone (dmatch cond 1: the token's bytes walk
live inside the current terminal; the CI row of state `s` is the
strict-M0 / end_live row `packed[strict_offset + s*stride]`, shared by
BOTH families) — and a context-DEPENDENT part whose acceptance depends
on the step's accept sequences. The CD part decomposes further, and
every sub-class except the last is resolved by choosing PRECOMPUTED
store rows (device-resident ids, zero host bit work):

  * α=0 overshoot (family M0 bits beyond end_live): selected by one
    accept-set boolean — when the length-1 sequence is present the
    runtime emits the family M0 row (a superset of the CI row) as the
    group's base row instead of the CI row.
  * position-0 follow splits: when the remainder walk lands IN F, every
    token that pmatches follow terminal τ' from its start is allowed —
    and that set is exactly the store row of τ''s DFA START state
    (mask-family M0 row / strict CI row; an identity of the suffix
    tables, asserted by tests). The runtime emits those per-follow
    start rows whenever `finals[s]`.
  * interior (j>0) splits whose residue is BIG (> CD_ROW_THRESHOLD
    tokens): the legacy M1 row id is emitted directly; `cd_big` bit
    1+g of `[fam*S + s]` marks these rows.
  * interior splits with a SMALL residue — the only per-token work
    left: `cd_token` lists the tokens per (family, state) with a
    per-token follow bitmask `cd_follow` (bit 1+g = M1[τ_g]-residue,
    matching row addressing; bit 0 reserved), indexed by
    `cd_ptr[fam*S + s]`. The runtime overlay is a
    select-by-accept-bits scatter over this residue — a few tokens per
    step on the builtin grammars, replacing the wide accept-row
    unions on the host hot path.

The classification (`derive_context_split`) is a pure function of the
packed rows plus per-state finals flags and the per-terminal
start-state rows (both derivable from grammar + packed), so shard
outputs concatenate bitwise deterministically and `--verify` can
re-derive it independently. Per-row popcounts and the [256, W]
first-byte table are also precomputed at build time (they used to be
lazy per-process work).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np

from .grammar import Grammar
from .tokenizer import ByteTokenizer, EOS_ID, PAD_ID

# On-disk cache layout version, hashed into the cache fingerprint. Bump
# whenever the packed representation changes (word dtype, bit order, row
# addressing, padding) so stale caches written by an older layout MISS
# instead of being loaded as garbage masks. v4: context-split tables
# (cd_ptr/cd_token/cd_follow) + build-time popcount and first-byte
# tables ride in the same npz.
STORE_LAYOUT_VERSION = 4

# Context-dependent rows whose interior-split residue exceeds this many
# tokens are kept as whole precomputed M1 rows (`cd_big`) instead of
# entering the per-token residue tables: the per-step scatter stays a
# few tokens while pathological states cost one extra device row id.
# Folded into the cache fingerprint — changing it must miss stale caches.
CD_ROW_THRESHOLD = 16


def compute_row_popcounts(packed: np.ndarray) -> np.ndarray:
    """[rows] int32 allowed-token count per packed row. 256-entry
    popcount LUT over the uint8 view: same result as unpackbits().sum()
    at 1/8 the transient memory (no [R, V] bit expansion next to the
    resident model)."""
    lut = np.unpackbits(
        np.arange(256, dtype=np.uint8)[:, None], axis=1
    ).sum(axis=1, dtype=np.int32)
    return lut[packed.view(np.uint8)].sum(axis=1, dtype=np.int32)


def compute_first_byte_table(tokenizer: ByteTokenizer,
                             words: int) -> np.ndarray:
    """[256, words] uint32: row c is the packed bitmask of vocab tokens
    whose first byte is c (special / empty tokens excluded)."""
    fb = np.zeros((256, words), np.uint32)
    for tid, b in enumerate(tokenizer.id_to_bytes):
        if b and tid < tokenizer.vocab_size:
            fb[b[0], tid // 32] |= np.uint32(1 << (tid % 32))
    return fb


def compute_state_finals(grammar: Grammar, lo: int = 0,
                         hi: int | None = None) -> np.ndarray:
    """[hi-lo] bool: global DFA state s+lo is a FINAL state of its
    terminal's DFA. Final states admit position-0 follow splits (the
    remainder already completes the terminal), which the runtime
    resolves with the follow terminal's start-state row."""
    if hi is None:
        hi = grammar.total_dfa_states
    finals = np.zeros(hi - lo, dtype=bool)
    for name in grammar.terminal_names:
        dfa = grammar.terminals[name].dfa
        off = grammar.state_offset[name]
        for q in range(max(0, lo - off), min(dfa.num_states, hi - off)):
            finals[off + q - lo] = bool(dfa.finals[q])
    return finals


def term_start_states(grammar: Grammar) -> np.ndarray:
    """[G] int32 global DFA state of each terminal's start state, in
    `terminal_names` order — the addressing base for the position-0
    follow-split rows."""
    return np.array([grammar.state_offset[t] + grammar.terminals[t].dfa.start
                     for t in grammar.terminal_names], dtype=np.int32)


def pm0_rows_from_packed(grammar: Grammar, packed: np.ndarray,
                         stride: int) -> tuple[np.ndarray, np.ndarray]:
    """([G, W], [G, W]) uint32 pmatch-from-start rows per family, read
    from a FULL packed array: mask family = M0 row of the terminal's
    start state, strict family = its CI (strict-M0) row."""
    starts = term_start_states(grammar)
    strict_offset = packed.shape[0] // 2
    return (packed[starts * stride],
            packed[strict_offset + starts * stride])


def derive_context_split(mask_packed: np.ndarray, strict_packed: np.ndarray,
                         stride: int, vocab_size: int,
                         finals: np.ndarray, pm0_mask: np.ndarray,
                         pm0_strict: np.ndarray,
                         threshold: int = CD_ROW_THRESHOLD):
    """Classify (state, token) pairs into the context-dependent residue,
    per row family — a pure function of the packed rows plus the
    per-state `finals` flags (aligned to this packed slice) and the
    per-terminal pmatch-from-start rows `pm0_*` [G, W] (the start-state
    rows of the FULL store; see `pm0_rows_from_packed`).

    For state `s` the context-independent bits are the strict-M0 /
    end_live row `strict_packed[s*stride]` (cond 1 — shared by both
    families). The context-dependent remainder of M1[τ_g] beyond those
    bits is classified per (family, state, follow):

      * if `finals[s]`, the position-0 split contribution — exactly the
        pm0 row of τ_g — is subtracted: the runtime emits that
        precomputed row directly, so it never enters the tables;
      * a residue still larger than `threshold` tokens marks bit 1+g of
        `cd_big[fam*S + s]`: the runtime emits the legacy M1 row id
        (also precomputed) for these;
      * otherwise the residue tokens enter `cd_token` (ascending —
        deterministic for shard concatenation and bitwise --verify)
        with follow bit 1+g set in `cd_follow`.

    Returns (cd_ptr [2S+1] int64, cd_token [N] int32,
    cd_follow [N, FW] uint64, cd_big [2S, FW] uint64),
    FW = ceil(stride/64); the residue of (family f, state s) lives at
    cd_token[cd_ptr[f*S+s] : cd_ptr[f*S+s+1]].
    """
    S = mask_packed.shape[0] // stride
    FW = (stride + 63) // 64
    cd_ptr = np.zeros(2 * S + 1, dtype=np.int64)
    cd_big = np.zeros((2 * S, FW), dtype=np.uint64)
    pclut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(axis=1, dtype=np.int32)
    tok_parts: list = []
    fol_parts: list = []
    n = 0
    for fam, (fam_rows, pm0) in enumerate(((mask_packed, pm0_mask),
                                           (strict_packed, pm0_strict))):
        for s in range(S):
            rows = fam_rows[s * stride + 1:(s + 1) * stride]   # M1 only
            ci = strict_packed[s * stride]
            extra = rows & ~ci[None, :]
            if finals[s]:
                extra = extra & ~pm0
            pcs = pclut[extra.view(np.uint8)].sum(axis=1, dtype=np.int32)
            big = pcs > threshold
            for g in np.nonzero(big)[0]:
                j = 1 + int(g)                       # bit 1+tid(τ_g)
                cd_big[fam * S + s, j >> 6] |= np.uint64(1) << np.uint64(j & 63)
            extra = np.where(big[:, None], np.uint32(0), extra)
            union = np.bitwise_or.reduce(extra, axis=0)
            if union.any():
                bits = np.unpackbits(union.view(np.uint8),
                                     bitorder="little")[:vocab_size]
                toks = np.nonzero(bits)[0].astype(np.int32)
                cols = (extra[:, toks >> 5]
                        >> (toks & 31).astype(np.uint32)) & np.uint32(1)
                fol = np.zeros((toks.size, FW), dtype=np.uint64)
                for g in range(stride - 1):
                    j = 1 + g                       # bit 1+tid(τ_g)
                    fol[:, j >> 6] |= (cols[g].astype(np.uint64)
                                       << np.uint64(j & 63))
                tok_parts.append(toks)
                fol_parts.append(fol)
                n += toks.size
            cd_ptr[fam * S + s + 1] = n
    cd_token = (np.concatenate(tok_parts) if tok_parts
                else np.zeros(0, np.int32))
    cd_follow = (np.concatenate(fol_parts) if fol_parts
                 else np.zeros((0, FW), np.uint64))
    return cd_ptr, cd_token, cd_follow, cd_big


def _concat_context_splits(splits, stride: int):
    """Concatenate per-shard context splits (each family-major over its
    OWN state range) into the global family-major layout. Bitwise equal
    to `derive_context_split` over the concatenated packed rows."""
    FW = (stride + 63) // 64
    tok_parts: list = []
    fol_parts: list = []
    big_parts: list = []
    count_parts: list = []
    for fam in range(2):
        for ptr, tok, fol, big in splits:
            Si = (ptr.shape[0] - 1) // 2
            lo, hi = int(ptr[fam * Si]), int(ptr[(fam + 1) * Si])
            tok_parts.append(tok[lo:hi])
            fol_parts.append(fol[lo:hi])
            big_parts.append(big[fam * Si:(fam + 1) * Si])
            count_parts.append(np.diff(ptr[fam * Si:(fam + 1) * Si + 1]))
    counts = (np.concatenate(count_parts) if count_parts
              else np.zeros(0, np.int64))
    cd_ptr = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=cd_ptr[1:])
    cd_token = (np.concatenate(tok_parts) if tok_parts
                else np.zeros(0, np.int32))
    cd_follow = (np.concatenate(fol_parts) if fol_parts
                 else np.zeros((0, FW), np.uint64))
    cd_big = (np.concatenate(big_parts) if big_parts
              else np.zeros((0, FW), np.uint64))
    return cd_ptr, cd_token, cd_follow, cd_big


class MaskStore:
    def __init__(self, grammar: Grammar, tokenizer: ByteTokenizer,
                 packed: np.ndarray, meta: dict, split=None,
                 row_pc: np.ndarray | None = None,
                 fb: np.ndarray | None = None):
        self.grammar = grammar
        self.tokenizer = tokenizer
        self.packed = packed            # [rows, words] uint32
        self.meta = meta
        self.num_terminals = len(grammar.terminal_names)
        self.row_stride = self.num_terminals + 1
        # the strict family occupies the second half of the packed array
        self.strict_offset = packed.shape[0] // 2
        self.num_states = self.strict_offset // self.row_stride
        # per-state finals flags and per-terminal start states: the
        # runtime's position-0 follow-split addressing (cheap, from the
        # grammar — never serialized)
        self.state_finals = compute_state_finals(grammar)
        self.term_start = term_start_states(grammar)
        # context-split tables: loaded from the v4 cache / shard builds,
        # or re-derived here (raw constructions — same pure function)
        if split is None:
            pm0_mask, pm0_strict = pm0_rows_from_packed(
                grammar, packed, self.row_stride)
            split = derive_context_split(
                packed[:self.strict_offset], packed[self.strict_offset:],
                self.row_stride, tokenizer.vocab_size,
                self.state_finals, pm0_mask, pm0_strict)
        self.cd_ptr, self.cd_token, self.cd_follow, self.cd_big = split
        self.follow_words = self.cd_follow.shape[1]
        # residue scatter addressing, precomputed once: token t sets bit
        # cd_bit[i] of word cd_word[i] of the step's overlay
        self.cd_word = (self.cd_token >> 5).astype(np.int64)
        self.cd_bit = np.uint32(1) << (self.cd_token & 31).astype(np.uint32)
        self._row_pc = row_pc           # build-time per-row popcounts
        self._fb = fb                   # build-time first-byte bitmasks

    # ---- row addressing ----
    def global_state(self, terminal: str, q: int) -> int:
        return self.grammar.state_offset[terminal] + q

    def row_m0(self, terminal: str, q: int, strict: bool = False) -> int:
        off = self.strict_offset if strict else 0
        return self.global_state(terminal, q) * self.row_stride + off

    def row_m1(self, terminal: str, q: int, next_terminal: str,
               strict: bool = False) -> int:
        tid = self.grammar.term_id[next_terminal]
        off = self.strict_offset if strict else 0
        return (self.global_state(terminal, q) * self.row_stride
                + 1 + tid + off)

    def row_ci(self, global_state: int) -> int:
        """Context-independent row of a global DFA state: the strict-M0
        / end_live row, shared by BOTH families (the mode only selects
        which CD residue table applies)."""
        return self.strict_offset + global_state * self.row_stride

    def row_fam_m0(self, fam: int, global_state: int) -> int:
        """Family M0 row of a global state — the base row when the
        accept set contains the length-1 (α=0) sequence. For the strict
        family this coincides with the CI row."""
        return fam * self.strict_offset + global_state * self.row_stride

    def row_follow_start(self, fam: int, tid: int) -> int:
        """pmatch-from-start row of follow terminal tid: the store row
        of its DFA start state (mask M0 / strict CI) — emitted when the
        remainder walk lands in F (position-0 split)."""
        return (fam * self.strict_offset
                + int(self.term_start[tid]) * self.row_stride)

    def cd_range(self, fam: int, global_state: int) -> tuple[int, int]:
        """[lo, hi) slice of cd_token/cd_follow holding the residue of
        (family fam: 0 = grammar_mask, 1 = grammar_strict; state)."""
        i = fam * self.num_states + global_state
        return int(self.cd_ptr[i]), int(self.cd_ptr[i + 1])

    def cd_big_bits(self, fam: int, global_state: int) -> int:
        """Python int bitmask of big CD rows at (family, state): bit
        1+g set means M1[τ_g]'s residue overflowed CD_ROW_THRESHOLD and
        the legacy row id must be emitted when τ_g is a follow."""
        w = self.cd_big[fam * self.num_states + global_state]
        out = 0
        for k in range(self.follow_words - 1, -1, -1):
            out = (out << 64) | int(w[k])
        return out

    # ---- host-side mask ops (reference; device path is in kernels/) ----
    def union_rows(self, rows) -> np.ndarray:
        """OR of packed rows -> packed [words] uint32."""
        out = np.zeros(self.packed.shape[1], dtype=np.uint32)
        for r in rows:
            if r >= 0:
                out |= self.packed[r]
        return out

    def unpack(self, packed_row: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(packed_row.view(np.uint8), bitorder="little")
        return bits[: self.tokenizer.vocab_size].astype(bool)

    # ---- forced-continuation queries (speculation / jump-forward) ------
    # The spec subsystem (repro.spec.jump) asks, per step, "how many
    # tokens survive this step's mask union, and which one if exactly
    # one?" — popcount + sole-survivor extraction on the packed rows,
    # without ever materializing the [V] boolean mask.

    def row_popcounts(self) -> np.ndarray:
        """[rows] int32 allowed-token count per packed row. Precomputed
        at build time and shipped in the v4 cache; raw constructions
        compute it once here. The jump-forward analyzer uses it as a
        short-circuit: the union of a row set can only collapse to <= 1
        token if every member row already allows <= 1, so per-step
        forced detection is a gather + max instead of a mask union."""
        if self._row_pc is None:
            self._row_pc = compute_row_popcounts(self.packed)
        return self._row_pc

    @staticmethod
    def popcount_packed(packed: np.ndarray) -> int:
        """Allowed-token count of an already-unioned packed row. Padding
        bits past vocab_size are zero by construction, so a plain bit
        count over the packed words is exact."""
        return int(np.unpackbits(packed.view(np.uint8)).sum())

    @staticmethod
    def sole_from_packed(packed: np.ndarray):
        """Single allowed token id of an already-unioned packed row, or
        None when the popcount is not exactly 1."""
        nz = np.nonzero(packed)[0]
        if nz.size != 1:
            return None
        word = int(packed[nz[0]])
        if word & (word - 1):               # more than one bit in the word
            return None
        return int(nz[0]) * 32 + word.bit_length() - 1

    def union_popcount(self, rows) -> int:
        """Number of vocabulary tokens allowed by the OR of `rows`."""
        return self.popcount_packed(self.union_rows(rows))

    def allowed_first_bytes(self, packed_union: np.ndarray) -> np.ndarray:
        """[256] bool: byte c is True iff some token allowed by the packed
        union starts with c. When exactly one byte survives, EVERY valid
        tokenization of the continuation begins with it — the byte is
        grammar-FORCED even though several tokens (prefix-nested merges)
        remain in the mask. The jump-forward analyzer chains this to
        recover forced literal byte-strings that token-level popcount
        misses. [256, words] first-byte bitmasks precomputed at build
        time (computed once here on raw constructions), one AND per
        query."""
        if self._fb is None:
            self._fb = compute_first_byte_table(self.tokenizer,
                                                self.packed.shape[1])
        return (self._fb & packed_union[None, :]).any(axis=1)

    def sole_survivor(self, rows):
        """If exactly one token survives the union of `rows`, return its
        id; else None."""
        return self.sole_from_packed(self.union_rows(rows))

    @property
    def num_rows(self):
        return self.packed.shape[0]

    @property
    def num_words(self):
        return self.packed.shape[1]

    def nbytes(self):
        return self.packed.nbytes


def _fingerprint(grammar: Grammar, tok: ByteTokenizer) -> str:
    h = hashlib.sha256()
    # layout version + packed-word geometry first: a cache produced by an
    # older packed layout must not fingerprint-match (it would load as
    # wrong masks — soundness, not just staleness)
    words = (tok.vocab_size + 31) // 32
    # ":ctxsplit" folds the context-split classification into the
    # fingerprint explicitly (beyond the version bump): any change to
    # how CI/CD tables are derived must miss stale caches
    h.update(f"layout{STORE_LAYOUT_VERSION}:uint32le:w{words}"
             f":ctxsplit2-t{CD_ROW_THRESHOLD}".encode())
    h.update(grammar.name.encode())
    for t in grammar.terminal_names:
        h.update(t.encode())
        h.update(grammar.terminals[t].dfa.trans.tobytes())
        h.update(grammar.terminals[t].dfa.finals.tobytes())
    h.update(str(tok.vocab_size).encode())
    # hash EVERY token, length-prefixed: two vocabs sharing a prefix and
    # total byte length must not collide onto the same cached store
    for b in tok.id_to_bytes:
        h.update(len(b).to_bytes(4, "little"))
        h.update(b)
    return h.hexdigest()[:16]


class _Prep:
    """Shared per-(grammar, vocab) precomputation reused by every shard:
    the padded token byte-matrix and the packed suffix-pmatch tables for
    both row families."""
    __slots__ = ("V", "L", "T", "tok_len", "nonempty", "terms", "G",
                 "stride", "lanes", "S_bits", "Ss_bits")


def _prep(grammar: Grammar, tokenizer: ByteTokenizer) -> _Prep:
    p = _Prep()
    V = p.V = tokenizer.vocab_size
    toks = tokenizer.token_bytes()
    L = p.L = max(1, max(len(b) for b in toks))
    if L + 1 > 64:
        raise ValueError("token length > 63 unsupported by packed build")
    T = p.T = np.zeros((V, L), dtype=np.int32)
    tok_len = p.tok_len = np.zeros(V, dtype=np.int32)
    for i, b in enumerate(toks):
        tok_len[i] = len(b)
        if b:
            T[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    # special tokens (len 0) must never be "valid": we make their rows 0
    nonempty = p.nonempty = tok_len > 0

    terms = p.terms = grammar.terminal_names
    G = p.G = len(terms)
    p.stride = G + 1

    # ---- per-terminal suffix pmatch tables S[g, v, i]:
    #   mask family   — dmatch(t[i:], start(τ_g), ()) (end live OR a
    #                   proper prefix of the suffix lands in F)
    #   strict family — the suffix's ENTIRE walk stays live (no
    #                   overshoot past a terminal boundary)
    # for i in 0..L (i > len -> False). Packed over the split index i
    # into uint64 bit-lanes so the per-state M1 computation is a single
    # AND+nonzero over [G, V] (instead of a [G, V, L] reduction) —
    # TPU-thinking applied to the host build.
    S = np.zeros((G, V, L + 1), dtype=bool)
    Ss = np.zeros((G, V, L + 1), dtype=bool)
    for g, name in enumerate(terms):
        dfa = grammar.terminals[name].dfa
        trans, finals, live = dfa.trans, dfa.finals, dfa.live
        # suffix walk: for each start position i, walk from q0 over
        # t[i:]; each walk is <= L steps over [V] vectors.
        for i in range(L + 1):
            ok = tok_len >= i
            st = np.full(V, dfa.start, dtype=np.int32)
            hitF = np.zeros(V, dtype=bool)   # F hit strictly before suffix end
            for j in range(i, L):
                act = j < tok_len
                hitF |= ok & act & finals[st]       # prefix ending at j (proper)
                st_new = trans[st, T[:, j]]
                st = np.where(act, st_new, st)
            end_live = live[st]
            base_ok = ok & nonempty
            # mask: dmatch(suffix, q0, ()) = end live (cond1) or
            # proper-prefix in F (cond2); strict: end live only
            S[g, :, i] = base_ok & (end_live | hitF)
            Ss[g, :, i] = base_ok & end_live
            # note: empty suffix (i == len): cond1 with ε -> q0 live == True
            isempty = (tok_len == i) & live[dfa.start]
            S[g, :, i] |= isempty
            Ss[g, :, i] |= isempty
        # tokens shorter than i already masked by ok

    # bit-pack S over the split axis: S_bits[g, v] bit i <-> S[g, v, i]
    lanes = p.lanes = (np.uint64(1) << np.arange(L + 1, dtype=np.uint64))
    p.S_bits = (S.astype(np.uint64) * lanes[None, None, :]).sum(
        axis=2, dtype=np.uint64)
    p.Ss_bits = (Ss.astype(np.uint64) * lanes[None, None, :]).sum(
        axis=2, dtype=np.uint64)
    return p


def _pack_rows(rows: np.ndarray, V: int) -> np.ndarray:
    """[rows, V] bool -> [rows, W] uint32, little-endian bit-words."""
    Wbits = ((V + 31) // 32) * 32
    padded = np.zeros((rows.shape[0], Wbits), dtype=bool)
    padded[:, :V] = rows
    packed = np.packbits(padded, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32)


def build_rows_shard(grammar: Grammar, tokenizer: ByteTokenizer,
                     lo: int, hi: int, prep: _Prep | None = None):
    """Packed rows + context split for the global DFA states [lo, hi).

    Returns (mask_packed, strict_packed, split), the packed halves
    uint32 of shape [(hi-lo)·stride, W] and `split` the shard-local
    (cd_ptr, cd_token, cd_follow) from `derive_context_split`. Shards
    concatenated in global-state order reproduce the full store (and
    its CI/CD tables) bit-for-bit regardless of how the range
    [0, total_dfa_states) was split — the parallel offline builder
    relies on this.
    """
    p = prep if prep is not None else _prep(grammar, tokenizer)
    V, L, T, tok_len = p.V, p.L, p.T, p.tok_len
    nonempty, G, stride, lanes = p.nonempty, p.G, p.stride, p.lanes
    n = hi - lo
    mask_rows = np.zeros((n * stride, V), dtype=bool)
    strict_rows = np.zeros((n * stride, V), dtype=bool)
    pos = np.arange(L + 1)[None, :]
    for name in p.terms:
        dfa = grammar.terminals[name].dfa
        trans, finals, live = dfa.trans, dfa.finals, dfa.live
        off = grammar.state_offset[name]
        for q in range(max(0, lo - off), min(dfa.num_states, hi - off)):
            if not live[q]:
                continue  # dead-state rows stay all-zero (never queried)
            st = np.full(V, q, dtype=np.int32)
            # hitF_at[v, i]: state after consuming t[:i] is in F  (i=0..L)
            hitF_at = np.zeros((V, L + 1), dtype=bool)
            hitF_at[:, 0] = finals[q]
            for j in range(L):
                act = j < tok_len
                st_new = trans[st, T[:, j]]
                st = np.where(act, st_new, st)
                hitF_at[:, j + 1] = act & finals[st]
            end_live = live[st] & nonempty
            proper = hitF_at & (pos < tok_len[:, None])   # strict prefix in F
            anyF = hitF_at & (pos <= tok_len[:, None])    # any prefix incl. full
            anyF_bits = (anyF.astype(np.uint64) *
                         lanes[None, :]).sum(axis=1, dtype=np.uint64)
            r0 = (off + q - lo) * stride
            # mask M0: cond1 | cond2; strict M0: cond1 only (the token
            # must stay inside the current terminal)
            mask_rows[r0] = end_live | proper.any(axis=1)
            strict_rows[r0] = end_live
            # M1[τ']: cond1 | (split in F and suffix pmatches τ'), with
            # the family's own suffix table
            m1 = (p.S_bits & anyF_bits[None, :]) != 0
            m1s = (p.Ss_bits & anyF_bits[None, :]) != 0
            mask_rows[r0 + 1: r0 + 1 + G] = m1 | end_live
            strict_rows[r0 + 1: r0 + 1 + G] = m1s | end_live

    # never allow specials through the grammar mask (EOS handled separately)
    mask_rows[:, ~nonempty] = False
    strict_rows[:, ~nonempty] = False
    mask_packed = _pack_rows(mask_rows, V)
    strict_packed = _pack_rows(strict_rows, V)
    # the shard may not contain the terminals' start states, so the
    # pmatch-from-start rows come from the prep suffix tables (bit 0 =
    # split position 0); identical to the start-state rows of the full
    # store — tests assert the identity
    pm0_mask = _pack_rows(
        ((p.S_bits & np.uint64(1)) != 0) & nonempty[None, :], V)
    pm0_strict = _pack_rows(
        ((p.Ss_bits & np.uint64(1)) != 0) & nonempty[None, :], V)
    split = derive_context_split(
        mask_packed, strict_packed, stride, V,
        compute_state_finals(grammar, lo, hi), pm0_mask, pm0_strict)
    return mask_packed, strict_packed, split


def assemble_store(grammar: Grammar, tokenizer: ByteTokenizer, parts,
                   cache_dir: str | None = None, verbose: bool = False,
                   t0: float | None = None) -> MaskStore:
    """Concatenate shard outputs (in global-state order, covering the
    whole state space) into the [2R, W] packed array plus the global
    context-split / popcount / first-byte tables, and publish it all
    atomically through the disk cache."""
    fp = _fingerprint(grammar, tokenizer)
    stride = len(grammar.terminal_names) + 1
    packed = np.concatenate([part[0] for part in parts] +
                            [part[1] for part in parts], axis=0)
    if any(len(part) < 3 for part in parts):
        # legacy 2-tuple parts (tests, old pickles): derive globally —
        # the full packed array carries the start-state rows
        pm0_mask, pm0_strict = pm0_rows_from_packed(grammar, packed, stride)
        split = derive_context_split(
            packed[:packed.shape[0] // 2], packed[packed.shape[0] // 2:],
            stride, tokenizer.vocab_size,
            compute_state_finals(grammar), pm0_mask, pm0_strict)
    else:
        split = _concat_context_splits([part[2] for part in parts], stride)
    cd_ptr, cd_token, cd_follow, cd_big = split
    row_pc = compute_row_popcounts(packed)
    fb = compute_first_byte_table(tokenizer, packed.shape[1])
    per_state = np.diff(cd_ptr)
    meta = {
        "build_seconds": time.time() - (t0 if t0 is not None else time.time()),
        "rows": int(packed.shape[0]),
        "bytes": int(packed.nbytes),
        "grammar": grammar.name,
        "vocab": tokenizer.vocab_size,
        "cached": False,
        # context-split shape: total residue entries, the worst
        # per-(family, state) residue as a fraction of the vocab (the
        # "almost everything is precomputable" claim, measured), and how
        # many (state, follow) rows fell back to whole-row gathers
        "cd_entries": int(cd_token.shape[0]),
        "cd_max_tokens": int(per_state.max()) if per_state.size else 0,
        "cd_max_frac": (float(per_state.max()) / tokenizer.vocab_size
                        if per_state.size else 0.0),
        "cd_big_rows": int(compute_row_popcounts(
            cd_big.view(np.uint32)).sum()) if cd_big.size else 0,
    }
    if verbose:
        print(f"[mask_store] {grammar.name}: {meta['rows']} rows x "
              f"{packed.shape[1]} words, {meta['bytes']/1e6:.1f} MB, "
              f"cd_max {meta['cd_max_tokens']}/{tokenizer.vocab_size} "
              f"tok, {meta['build_seconds']:.1f}s")
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"maskstore_{grammar.name}_{fp}.npz")
        # atomic publish, safe under concurrent multi-process (and
        # multi-thread) builds: mkstemp gives each writer a private
        # temp file in the SAME directory (os.replace must not cross
        # filesystems), the pid in the prefix aids debugging, and
        # os.replace atomically publishes — concurrent builders race
        # benignly (last writer wins, all write identical bytes) and
        # readers never see a torn .npz. The unlink is tolerant: the
        # temp name is private, so ENOENT can only mean our own
        # os.replace already consumed it.
        fd, tmp = tempfile.mkstemp(
            dir=cache_dir,
            prefix=f".maskstore_{grammar.name}_{fp}.{os.getpid()}.")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, packed=packed, cd_ptr=cd_ptr,
                                    cd_token=cd_token, cd_follow=cd_follow,
                                    cd_big=cd_big, row_pc=row_pc, fb=fb)
            os.replace(tmp, path)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        meta["path"] = path
    return MaskStore(grammar, tokenizer, packed, meta, split=split,
                     row_pc=row_pc, fb=fb)


def load_cached_store(grammar: Grammar, tokenizer: ByteTokenizer,
                      cache_dir: str | None) -> "MaskStore | None":
    """The cache-hit path, shared by the serial and parallel builders."""
    if not cache_dir:
        return None
    fp = _fingerprint(grammar, tokenizer)
    path = os.path.join(cache_dir, f"maskstore_{grammar.name}_{fp}.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    # the v4 fingerprint guarantees the split tables are present; the
    # guard keeps a hand-rolled npz (tests) loadable by re-deriving
    split = ((z["cd_ptr"], z["cd_token"], z["cd_follow"], z["cd_big"])
             if "cd_big" in z.files else None)
    return MaskStore(grammar, tokenizer, z["packed"],
                     {"cached": True, "path": path}, split=split,
                     row_pc=z["row_pc"] if "row_pc" in z.files else None,
                     fb=z["fb"] if "fb" in z.files else None)


def build_mask_store(grammar: Grammar, tokenizer: ByteTokenizer,
                     cache_dir: str | None = None,
                     verbose: bool = False) -> MaskStore:
    cached = load_cached_store(grammar, tokenizer, cache_dir)
    if cached is not None:
        return cached
    t0 = time.time()
    prep = _prep(grammar, tokenizer)
    part = build_rows_shard(grammar, tokenizer, 0,
                            grammar.total_dfa_states, prep)
    return assemble_store(grammar, tokenizer, [part],
                          cache_dir=cache_dir, verbose=verbose, t0=t0)
