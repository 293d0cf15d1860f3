"""Shared model components of the dense path: norms, RoPE, projections,
FFN, embeddings, the loss and their init (port of `repro.models.common`).

Parameters are plain dicts of tensors in the JAX package's layout
(`wq [D, H*Dh]`, ...), so the weight bridge is a copy per leaf. Rounding
points follow the reference: `rms_norm` reduces in fp32 and rounds the
inverse to x's dtype before the multiply; `apply_rope` works in fp32 and
casts back; matrix products take operands in their dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..distributed.api import current_mesh, current_vocab, vocab_all_reduce

NEG_INF = -1e30


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ----------------------------- init helpers -------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1) * scale (default 1/sqrt(fan_in), fan_in = shape[-2]),
    drawn in fp32 on the generator's device and cast to `dtype`. A leaf
    stacked over layers (3 dims or more) is drawn one layer at a time, so
    the fp32 draw never holds more than one layer: qwen3-moe's expert
    leaf [48, 128, 2048, 768] would take 38.6 GB in fp32 at once. The
    draw is scaled in place: kimi-k2's one-layer expert leaf [384, 7168,
    2048] is 22.5 GB in fp32, and a scaled copy would double it."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:     # abstract params: shapes only, nothing drawn
        return out
    for part in (out if len(shape) >= 3 else (out,)):
        part.copy_(torch.randn(part.shape, generator=gen,
                               dtype=torch.float32, device=gen.device)
                   .mul_(scale))
    return out


# ----------------------------- norms / rope -------------------------------

def rms_norm(x, weight, eps):
    sq = torch.einsum("...d,...d->...", x.float(), x.float())
    inv = torch.rsqrt(sq / x.shape[-1] + eps)
    return (x * inv[..., None].to(x.dtype)) * weight


def rope_frequencies(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim, theta, device) -> torch.Tensor:
    """fp32 frequencies on `device`, built once: a host-to-device copy per
    call would synchronize the stream on every layer of every step."""
    return torch.tensor(rope_frequencies(head_dim, theta),
                        dtype=torch.float32, device=device)


def apply_rope(x, positions, theta):
    """x [..., S, H, Dh], positions [..., S] (broadcastable)."""
    dh = x.shape[-1]
    freqs = _rope_freqs(dh, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


def matmul(x, w):
    """x @ w in the wider of their dtypes, as JAX promotes a mixed product
    (an fp32 activation against a bf16 weight: the weight upcast, which
    is exact); operands of one dtype multiply as they are."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


# ----------------------------- attention layer -----------------------------

def init_attention(gen, cfg, dtype, lead=()):
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (*lead, D, H * Dh), dtype=dtype),
        "wk": dense_init(gen, (*lead, D, K * Dh), dtype=dtype),
        "wv": dense_init(gen, (*lead, D, K * Dh), dtype=dtype),
        "wo": dense_init(gen, (*lead, H * Dh, D), dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * Dh), ("bk", K * Dh), ("bv", K * Dh)):
            p[name] = torch.zeros((*lead, n), dtype=dtype,
                                  device=gen.device)
    return p


def qkv_proj(p, x, cfg):
    B, S, D = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(B, S, H, Dh), k.reshape(B, S, K, Dh),
            v.reshape(B, S, K, Dh))


def attn_out(p, o):
    B, S, H, Dh = o.shape
    return matmul(o.reshape(B, S, H * Dh), p["wo"])


# ----------------------------- FFN -----------------------------------------

def init_ffn(gen, d_model, d_ff, dtype, lead=()):
    return {
        "w_gate": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype=dtype),
    }


def ffn(p, x):
    h = torch.nn.functional.silu(matmul(x, p["w_gate"])) * \
        matmul(x, p["w_up"])
    return matmul(h, p["w_down"])


# ----------------------------- embedding -----------------------------------

def init_embed(gen, cfg, dtype):
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=1.0,
                             dtype=dtype),
         "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  dtype=dtype)
    return p


def embed_tokens(p, tokens):
    """tokens [...] -> [..., D]. Under a sharded engine whose vocabulary
    is split (`distributed.api.current_vocab()`), `p["embed"]` holds only
    this rank's rows [v0, v1): each rank looks up the ids it owns, zeros
    elsewhere, and one all-reduce SUM adds the single true row to zeros,
    which is exact."""
    vs = current_vocab()
    if vs is None or not vs.split:
        return p["embed"][tokens.long()]
    local = tokens.long() - vs.v0
    own = (local >= 0) & (local < vs.width)
    rows = p["embed"][local.clamp(0, vs.width - 1)]
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    return vocab_all_reduce(rows, current_mesh())


def lm_logits(p, x, cfg):
    """-> logits [..., V], or [..., V_s] of this rank's vocab ids when the
    params are a rank's shard (`bridge.shard_params`): each column is the
    whole contraction over D, as in the unsharded product (tied configs
    use the embed's rows transposed)."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["lm_head"]


def cross_entropy_loss(logits, labels, mask=None):
    """logits [B,S,V] (any float dtype), labels [B,S] int -> mean NLL in
    fp32 over the positions `mask` keeps. The gold logit is gathered
    (the reference's iota compare picks the same value)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
