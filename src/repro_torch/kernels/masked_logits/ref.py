"""Plain PyTorch version of the mask half of the fused select (the
reference's `kernels/masked_logits/ref.py::masked_logits_ref`).

Semantics: for each batch row b, union the packed mask-store rows
`rows[b, :]` (int32 row ids, -1 = padding) seeded with the residue words
`cd[b]`, unpack the resulting bitmask, and replace logits outside the
mask with NEG_INF. `eos_allowed[b]` additionally opens the EOS position;
rows whose `constrained[b]` is False pass through unmasked.

Its Hopper kernel comes with the speculative and sequential paths; today
`fused_select` composes this plain version as its reference.
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
    mask[:, eos_id] |= eos_allowed
    if constrained is not None:
        mask |= ~constrained[:, None]
    return logits.masked_fill(~mask, NEG_INF)
