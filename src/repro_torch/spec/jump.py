"""Jump-forward: forced-continuation analysis over the DFA mask store.

In structured outputs the grammar frequently determines the next token
outright — JSON punctuation, keyword tails (`tru` → `e`), mandatory
quotes. The paper's mask store already knows this: when the union of the
step's mask rows has popcount 1 (and EOS is not simultaneously legal),
the masked distribution has a single support point, so ANY selector —
greedy, temperature, top-k/p — must pick it. `jump_forward` chains that
observation: it walks `GrammarConstraint.forced_step` until the grammar
stops forcing, emitting the whole run with zero model forward passes.

Soundness w.r.t. the tokenizer: each forced token is re-checked against
the exact parser oracle (`is_valid_extension`) before it is emitted, so a
mask over-approximation can never smuggle in an invalid token. The
emitted ids are exactly what the plain engine's masked argmax would have
produced (single support point), which is what makes greedy speculative
decoding token-for-token identical to the plain batched engine.

`forced_literal` recovers byte-level forcing the token popcount misses
(many prefix-nested tokens, one shared first byte). In literal mode the
forced literal is emitted as its STANDALONE canonical tokenization
(`tokenizer.encode(literal)`), never as a re-encoding of prefix+literal:
re-encoding could merge a token across the injection point and
retroactively change already-emitted history. `retokenize_aligned` is
the diagnostic for exactly that hazard — when it reports misalignment,
the standalone encoding the engine emits is the same locally-greedy
boundary the plain engine would have produced, just not the globally
canonical one.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.constrain import GrammarConstraint
from repro_torch.core.tokenizer import ByteTokenizer


@dataclass
class JumpResult:
    tokens: list = field(default_factory=list)   # forced token ids, in order
    text: bytes = b""                            # their concatenated bytes
    eos: bool = False       # EOS itself is forced after `tokens`
    dead_end: bool = False  # mask empty, EOS disallowed (engine stops slot)
    stop_mask: object = None  # StepMask at the stop point ("free" only):
                              # the engine reuses it as the first
                              # selection position's rows, so the jump
                              # analysis costs no extra step_rows

    def __len__(self):
        return len(self.tokens)


def jump_forward(gc: GrammarConstraint, text: bytes, max_tokens: int,
                 literal: bool = False) -> JumpResult:
    """Chase forced continuations from `text` for up to `max_tokens`
    emitted tokens.

    Default mode emits only tokens with mask-union popcount 1 (single
    support point of the masked distribution): every selector would pick
    them, so greedy speculative decoding stays token-for-token identical
    to the plain engine.

    literal=True additionally chases byte-level forcing: when the mask
    still holds several tokens but they all START with the same byte
    (prefix-nested merges: 'n'/'na'/'name'), the byte — and often a whole
    literal like '"name":' — is grammar-determined even though the
    tokenization is not. The forced literal is re-tokenized standalone
    with the canonical maximal-munch encoder (see the module docstring
    for why not prefix+literal) and each canonical token is re-validated
    against the exact oracle before emission. This emits more tokens per
    jump (XGrammar-style context expansion) at the price of exact
    plain-engine equivalence: the engine would have spelled the same
    BYTES with a possibly different token split.
    """
    res = JumpResult()
    cur = text
    while True:
        kind, tok, sm = gc.forced_step(cur)
        if kind == "token" and len(res.tokens) < max_tokens:
            res.tokens.append(tok)
            tb = gc.tokenizer.id_to_bytes[tok]
            res.text += tb
            cur += tb
            continue
        if kind == "free" and literal and len(res.tokens) < max_tokens:
            lit = forced_literal(
                gc, cur, max_bytes=4 * (max_tokens - len(res.tokens)),
                first_mask=sm)
            # standalone canonical tokenization tiles the literal
            # exactly, and every literal prefix is in L_p(G) by
            # construction of the byte chain; the (incremental, cheap)
            # oracle re-check below is the belt-and-suspenders the rest
            # of the engine applies to every mask-derived decision
            ids = gc.tokenizer.encode(lit) if lit else []
            emitted = 0
            for t in ids:
                if len(res.tokens) >= max_tokens or \
                        not gc.is_valid_extension(cur, t):
                    break
                tb = gc.tokenizer.id_to_bytes[t]
                res.tokens.append(t)
                res.text += tb
                cur += tb
                emitted += 1
            if emitted == len(ids) and emitted > 0:
                continue            # forcing may resume past the literal
            if emitted:
                break               # partial literal: mask at cur unknown
            # nothing emitted: text unchanged, fall through (sm valid)
        res.eos = kind == "eos"
        res.dead_end = kind == "dead"
        if kind in ("free", "token"):
            # "token" here = budget exhausted mid-run: sm is the (forced)
            # mask at the stop text, still the right selection rows
            res.stop_mask = sm
        break
    return res


def forced_literal(gc: GrammarConstraint, text: bytes,
                   max_bytes: int = 256, first_mask=None) -> bytes:
    """The grammar-forced continuation of `text` as a BYTE string.

    Per step, unions the mask rows and asks the store which FIRST bytes
    the allowed tokens span (`MaskStore.allowed_first_bytes`); exactly
    one surviving byte means every valid tokenization starts with it, so
    it is appended and the walk repeats. Stops at the first real branch,
    at an EOS-legal point (the output may end instead of continuing), or
    at `max_bytes`. `first_mask` reuses an already-computed StepMask for
    the first step."""
    out = b""
    cur = text
    sm = first_mask
    while len(out) < max_bytes:
        if sm is None:
            sm = gc.step_rows(cur)
        if sm.eos_allowed:
            break
        fb = gc.store.allowed_first_bytes(gc.union_packed(sm))
        nz = np.nonzero(fb)[0]
        if nz.size != 1:
            break
        out += bytes([int(nz[0])])
        cur = text + out
        sm = None
    return out


def retokenize_aligned(tok: ByteTokenizer, prefix_ids: list,
                       literal: bytes) -> list | None:
    """Detokenize–retokenize realignment check for a forced literal.

    Encodes (decoded prefix + literal) with the canonical maximal-munch
    encoder and checks the canonical stream preserves `prefix_ids` as an
    exact prefix. Returns the canonical token ids for `literal` if the
    boundary is stable, else None — the merge table fused a token across
    the injection point, so no continuation tokenization can make the
    full stream canonical. `jump_forward` sidesteps the hazard by always
    emitting the STANDALONE encoding of the literal (locally greedy from
    the boundary — the same boundary the plain engine produces when it
    samples token-by-token); this check is the diagnostic/test oracle
    for that reasoning, quantifying how often a jump lands on a
    non-canonical boundary.
    """
    prefix_bytes = b"".join(tok.id_to_bytes[int(t)] for t in prefix_ids
                            if int(t) >= tok.num_special)
    canon = tok.encode(prefix_bytes + literal)
    pref = [int(t) for t in prefix_ids if int(t) >= tok.num_special]
    if canon[: len(pref)] != pref:
        return None
    return canon[len(pref):]
