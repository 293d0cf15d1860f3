"""Decoding algorithms, composable with grammar masks (paper §2.1 / §3.2:
"any algorithm that could be applied to V can instead be applied to V_k").

PyTorch port of `repro.core.decoding`. All selectors operate on a
(possibly masked) logits tensor. Sampling is in noise form: the caller
hands in standard-Gumbel noise and the sampled id is
`argmax(filtered + noise)`, which is what `jax.random.categorical` draws
for the same noise; feeding both sides the same noise is how the port is
held token-for-token to the reference.

Packed mask words travel as int32 tensors holding the uint32 bit
patterns: torch's uint32 lacks bitwise kernels on some builds, and OR /
shift-then-mask-one give the same bits on either type.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

NEG_INF = -1e30


def apply_bool_mask(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logits [..., V], mask [..., V] bool -> masked logits."""
    return logits.masked_fill(~mask, NEG_INF)


def unpack_mask_words(packed: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """packed [..., W] int32 (uint32 bits) -> bool [..., W*32][:vocab]
    (little-endian: bit j of word w is id 32w + j)."""
    bits = torch.arange(32, dtype=torch.int32, device=packed.device)
    unpacked = (packed[..., :, None] >> bits) & 1
    out = unpacked.reshape(*packed.shape[:-1], -1)
    return out[..., :vocab_size].bool()


def union_packed_rows(store: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """store [R, W] int32, rows [..., A] int32 (-1 pad) -> [..., W] int32:
    the bitwise OR of the selected rows."""
    gathered = store[rows.clamp(min=0).long()]              # [..., A, W]
    gathered = gathered.masked_fill((rows < 0)[..., None], 0)
    out = torch.zeros_like(gathered[..., 0, :])
    for a in range(gathered.shape[-2]):
        out |= gathered[..., a, :]
    return out


# ---------------------------- selectors -----------------------------------

def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def topk_topp_filter(scaled: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    """Support filter shared by every sampler of the port (the same rules
    as the reference's `topk_topp_filter`).

    scaled [..., V] temperature-scaled logits; top_k [...] int32 (<= 0
    disables); top_p [...] f32 (>= 1.0 disables). Boundary semantics:

      * top-k keeps ties with the k-th largest logit (strictly-below
        demotion), so the kept set can exceed k;
      * top-p keeps tokens while the sorted cumulative probability is
        < top_p, PLUS the first token at/over the boundary
        (inclusive-first-over), plus any tie with that cutoff logit;
      * top_p >= 1.0 disables the nucleus filter EXACTLY.
    """
    V = scaled.shape[-1]
    kidx = torch.clip(torch.where(top_k > 0, top_k, V), 1, V) - 1
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, kidx[..., None].long())
    scaled = torch.where(scaled < kth, NEG_INF, scaled)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    p = torch.where(top_p < 1.0, top_p, 2.0)[..., None]
    cutoff_idx = torch.clamp((cum < p).sum(dim=-1, keepdim=True), max=V - 1)
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
    return torch.where(scaled < cutoff, NEG_INF, scaled)


def sample(logits: torch.Tensor, noise: torch.Tensor,
           temperature: float = 1.0, top_k: Optional[int] = None,
           top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature / top-k / top-p sampling over the last axis, with
    standard-Gumbel `noise` of logits' shape. The support set is
    `topk_topp_filter`, as in `select_batch`."""
    scaled = logits / max(temperature, 1e-6)
    if top_k is not None or top_p is not None:
        lead = logits.shape[:-1]
        scaled = topk_topp_filter(
            scaled,
            torch.full(lead, 0 if top_k is None else top_k,
                       dtype=torch.int32, device=logits.device),
            torch.full(lead, 1.0 if top_p is None else top_p,
                       dtype=torch.float32, device=logits.device))
    return torch.argmax(scaled + noise, dim=-1)


def select_batch(logits: torch.Tensor, noise: Optional[torch.Tensor],
                 greedy_flags: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row token selection over a whole decode batch in one call.

      logits       [B, V]  (already grammar-masked where applicable)
      noise        [B, V]  f32 standard-Gumbel noise (None: all greedy)
      greedy_flags [B]     bool — row ignores sampling params, takes argmax
      temperature  [B]     f32
      top_k        [B]     int32, <= 0 disables
      top_p        [B]     f32, >= 1.0 disables

    Returns [B] int32 ids."""
    arg = torch.argmax(logits, dim=-1)
    if noise is None:
        return arg.to(torch.int32)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    scaled = topk_topp_filter(scaled, top_k, top_p)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(greedy_flags, arg, sampled).to(torch.int32)


def select_span(logits: torch.Tensor, noise: Optional[torch.Tensor],
                greedy_flags: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Span form of `select_batch`: logits and noise [B, S, V]; the
    per-slot decode configs broadcast across the span. -> [B, S] int32."""
    B, S, V = logits.shape
    rep = lambda a: torch.repeat_interleave(a, S, dim=0)
    ids = select_batch(logits.reshape(B * S, V),
                       None if noise is None else noise.reshape(B * S, V),
                       rep(greedy_flags), rep(temperature), rep(top_k),
                       rep(top_p))
    return ids.reshape(B, S)


@dataclass
class DecodeConfig:
    method: str = "greedy"            # greedy | sample
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    def select(self, logits: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.method == "greedy":
            return greedy(logits)
        if self.method == "sample":
            if noise is None:
                raise ValueError("sampling needs Gumbel noise")
            return sample(logits, noise, self.temperature, self.top_k,
                          self.top_p)
        raise ValueError(self.method)

    @staticmethod
    def batch_arrays(configs: list["DecodeConfig"]):
        """Stack per-slot configs into `select_batch` parameter arrays
        (greedy [B] bool, temperature [B] f32, top_k [B] i32, top_p [B] f32)."""
        for c in configs:
            if c.method not in ("greedy", "sample"):
                raise ValueError(c.method)
        return (np.array([c.method == "greedy" for c in configs], bool),
                np.array([c.temperature for c in configs], np.float32),
                np.array([c.top_k or 0 for c in configs], np.int32),
                np.array([1.0 if c.top_p is None else c.top_p
                          for c in configs], np.float32))


# ------------------------- host-level beam search --------------------------

def beam_search(step_fn: Callable, init_state, beam_width: int,
                max_steps: int, eos_id: int):
    """Generic host-driven beam search.

    step_fn(state, token_history) -> (log_probs over V [np], new_state).
    The grammar mask composes by step_fn masking its log_probs — beam is
    just another selector over V_k (paper generality).
    Returns list of (tokens, score) best-first.
    """
    beams = [([], 0.0, init_state, False)]
    for _ in range(max_steps):
        if all(done for (_, _, _, done) in beams):
            break
        cand = []
        for toks, score, state, done in beams:
            if done:
                cand.append((toks, score, state, True))
                continue
            logp, new_state = step_fn(state, toks)
            top = np.argsort(logp)[::-1][:beam_width]
            for t in top:
                if not np.isfinite(logp[t]):
                    continue
                cand.append((toks + [int(t)], score + float(logp[t]),
                             new_state, int(t) == eos_id))
        if not cand:
            break
        cand.sort(key=lambda c: c[1], reverse=True)
        beams = cand[:beam_width]
    return [(toks, score) for toks, score, _, done in beams]
