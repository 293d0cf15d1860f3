"""Plain PyTorch version of the fused mask + filter + sample step (the
reference's `kernels/fused_select/ref.py::fused_select_ref`, noise form).

One call takes a decode step from raw logits to selected token ids:
packed mask-row union (precomputed row gather + residue overlay) → EOS /
unconstrained handling → temperature scaling → `topk_topp_filter` →
greedy argmax or `argmax(filtered + noise)`. `ok[b]` says whether row b
kept any allowed logit (the engine's `any(masked > NEG_INF / 2)`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..masked_logits.ref import NEG_INF, masked_logits_ref
from ...core.decoding import topk_topp_filter


def _mix64(x: int) -> int:
    """splitmix64 finalizer: every output bit depends on every input bit
    (torch's CPU generator seeds from the low 32 bits only)."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def gumbel_noise(keys: np.ndarray, vocab_size: int,
                 device="cpu") -> torch.Tensor:
    """[B, V] f32 standard-Gumbel noise, one stream per slot: row b is
    drawn from a torch.Generator on `device` seeded with a hash of the
    64 bits of `keys[b]` (uint32 [B, 2]), so a slot's stream depends only
    on its own key. The numbers are torch's, not jax.random's: the tests
    hand both engines the same noise through the engine's `noise_fn`."""
    dev = torch.device(device)
    tiny = torch.finfo(torch.float32).tiny
    out = torch.empty((keys.shape[0], vocab_size), dtype=torch.float32,
                      device=dev)
    for b in range(keys.shape[0]):
        g = torch.Generator(device=dev)
        g.manual_seed(_mix64((int(keys[b, 0]) << 32) | int(keys[b, 1])))
        u = torch.rand(vocab_size, generator=g, device=dev)
        out[b] = -torch.log(-torch.log(u.clamp(min=tiny)))
    return out


def fused_select_ref(logits, store, rows, cd, eos_allowed, constrained,
                     greedy_flags, temperature, top_k, top_p, *,
                     noise=None, eos_id: int = 1):
    """-> (ids [B] int32, masked [B, V], ok [B] bool). `noise` None is
    the all-greedy variant: no filter, every row takes the masked
    argmax."""
    masked = masked_logits_ref(logits, store, rows, eos_allowed,
                               eos_id=eos_id, constrained=constrained,
                               cd=cd)
    ok = (masked > NEG_INF / 2).any(dim=-1)
    arg = torch.argmax(masked, dim=-1).to(torch.int32)
    if noise is None:
        return arg, masked, ok
    scaled = masked / torch.clamp(temperature, min=1e-6)[:, None]
    scaled = topk_topp_filter(scaled, top_k, top_p)
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    return torch.where(greedy_flags, arg, sampled), masked, ok
