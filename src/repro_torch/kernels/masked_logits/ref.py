"""Plain PyTorch version of the grammar mask (the reference's
`kernels/masked_logits/ref.py`).

Semantics: for each batch row b, union the packed mask-store rows
`rows[b, :]` (int32 row ids, -1 = padding) seeded with the residue words
`cd[b]`, unpack the resulting bitmask, and replace logits outside the
mask with NEG_INF. `eos_allowed[b]` additionally opens the EOS position
(an `eos_id` outside [0, V) opens nothing: the sharded engine passes one
on the ranks that do not own EOS);
rows whose `constrained[b]` is False pass through unmasked.

`kernels/masked_logits/ops.py` takes these for CPU tensors and launches
`csrc/masked_logits.cu` for CUDA tensors; `fused_select` composes the
[B, V] form as the mask half of its plain version.
"""
from __future__ import annotations

import torch

from ...core.decoding import union_packed_rows, unpack_mask_words

NEG_INF = -1e30


def masked_logits_ref(logits, store, rows, eos_allowed, eos_id: int = 1,
                      constrained=None, cd=None):
    """logits [B,V], store [R,W] int32 (uint32 bits), rows [B,A] int32,
    eos_allowed [B] bool, constrained [B] bool (optional), cd [B,W] int32
    (optional) -> masked logits [B,V] in logits' dtype."""
    B, V = logits.shape
    words = union_packed_rows(store, rows)
    if cd is not None:
        words = words | cd
    mask = unpack_mask_words(words, V)
    if 0 <= eos_id < V:         # an id outside [0, V) is never opened
        mask[:, eos_id] |= eos_allowed
    if constrained is not None:
        mask |= ~constrained[:, None]
    return logits.masked_fill(~mask, NEG_INF)


def masked_logits_span_ref(logits, store, rows, eos_allowed,
                           eos_id: int = 1, constrained=None, cd=None):
    """[B,K,V] span form (draft-verify speculation): position k of slot b
    has its own rows [B,K,A], eos flag [B,K], constrained flag [B,K] and
    cd overlay [B,K,W]. Delegates to the [B,V] form on the flattened
    (b, k) axis, so the two stay identical by construction."""
    B, K, V = logits.shape
    out = masked_logits_ref(
        logits.reshape(B * K, V), store, rows.reshape(B * K, -1),
        eos_allowed.reshape(B * K), eos_id=eos_id,
        constrained=None if constrained is None
        else constrained.reshape(B * K),
        cd=None if cd is None else cd.reshape(B * K, -1))
    return out.reshape(B, K, V)
