"""Shared model components of the dense path: norms, RoPE, projections,
FFN, embeddings, the loss and their init (port of `repro.models.common`).

Parameters are plain dicts of tensors in the JAX package's layout
(`wq [D, H*Dh]`, ...), so the weight bridge is a copy per leaf. Rounding
points follow the reference: `rms_norm` reduces in fp32 and rounds the
inverse to x's dtype before the multiply; `apply_rope` works in fp32 and
casts back; matrix products take operands in their dtype.

Under a trunk split (`distributed.api.current_trunk()`: a trunk-sharded
engine, or a train step on a (data, model) mesh) a rank holds the column
blocks of wq/wk/wv/w_gate/w_up and the row blocks of wo/w_down
(Megatron) and runs over the rank-local config (H/M, K/M heads), with
Megatron's collectives, autograd Functions that serving runs under
no_grad: `api.model_copy` before each split column block (the identity;
backward, the input's gradient summed over the model ranks) and
`api.model_sum` after each row block (`attn_out`, `ffn`: the partial
products summed). `qkv_proj` takes the rank's columns of the whole 1-D
QKV biases. Where M does not divide the kv heads (`TrunkPlan.gathers`:
the caches then split their sequence or head_dim, or stay whole) the
column blocks may cut inside a head: `qkv_proj` gathers them into whole
heads (`api.model_gather_stack`, whose backward sums the ranks' partial
gradients), and `attn_out` takes the rank's columns of the whole
attention output before its wo rows.

In a train step whose vocabulary splits (`distributed.api.train_model()`)
the rank holds the V/M rows `param_spec` gives embed and lm_head: the
lookup sums one true row and zeros (`model_sum`), the head takes
`model_copy` before its columns (`lm_logits`).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..distributed.api import (current_mesh, current_trunk, current_vocab,
                               model_copy, model_gather_stack, model_sum,
                               train_model, vocab_all_reduce)

NEG_INF = -1e30


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ----------------------------- init helpers -------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1) * scale (default 1/sqrt(fan_in), fan_in = shape[-2]),
    drawn in fp32 on the generator's device and cast to `dtype`
    (`draw_block` of the whole leaf). A leaf
    stacked over layers (3 dims or more) is drawn one layer at a time, so
    the fp32 draw never holds more than one layer: qwen3-moe's expert
    leaf [48, 128, 2048, 768] would take 38.6 GB in fp32 at once. The
    draw is scaled in place: kimi-k2's one-layer expert leaf [384, 7168,
    2048] is 22.5 GB in fp32, and a scaled copy would double it."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    shape = tuple(shape)
    if isinstance(gen, HeldDraws):
        return gen.hold(shape, scale, dtype)
    if gen.device.type == "meta":   # abstract params: shapes only
        return torch.empty(shape, dtype=dtype, device="meta")
    return draw_block(gen, HeldDraw(shape, scale, dtype, 0),
                      tuple(slice(0, s) for s in shape))


@dataclass(frozen=True)
class HeldDraw:
    """A `dense_init` draw held back: its shape, scale, dtype and its
    place in the generator's stream."""
    shape: tuple
    scale: float
    dtype: torch.dtype
    order: int


class HeldDraws:
    """The generator `Model.init(gen, cut=...)` hands to the init
    functions: `dense_init` records each draw (`HeldDraw`) instead of
    making it; zeros and ones are made on `device` as usual."""

    def __init__(self, device):
        self.device = device
        self.n = 0

    def hold(self, shape, scale, dtype) -> HeldDraw:
        self.n += 1
        return HeldDraw(shape, scale, dtype, self.n)


def draw_block(gen: torch.Generator, held: HeldDraw, sl) -> torch.Tensor:
    """The block `sl` (one slice a dim) of a leaf of `held.shape`: fp32
    normal draws from `gen` (one layer at a time for a stacked leaf, so
    at most one layer of the whole leaf is ever held), scaled in place,
    each cut to the block and cast. Every block of a leaf makes the same
    draws, so blocks cut apart fit together bit for bit; `dense_init` is
    the block of every slice whole."""
    shape, dev = held.shape, gen.device
    out = torch.empty(tuple(s.stop - s.start for s in sl), dtype=held.dtype,
                      device=dev)

    def one(part_shape):
        return torch.randn(part_shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(held.scale)
    if len(shape) < 3:
        out.copy_(one(shape)[sl])
        return out
    for i in range(shape[0]):
        layer = one(shape[1:])
        if sl[0].start <= i < sl[0].stop:
            out[i - sl[0].start].copy_(layer[sl[1:]])
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


def _cols(b, span):
    """A whole 1-D bias -> its columns `span` (the rank's block of the
    leaf it biases, under a trunk split), or all of it (span None)."""
    return b if span is None else b[..., span[0]:span[1]]


def _whole_cols(parts):
    """A gathering split's [(y [B, S, n], span)] -> each y whole: the
    column blocks (span not None) go in one `model_gather_stack`, whose
    rank order is the columns' order."""
    out = [y for y, _ in parts]
    cut = [i for i, (_, span) in enumerate(parts) if span is not None]
    if not cut:
        return out
    got = model_gather_stack(torch.cat([out[i] for i in cut], -1),
                             current_mesh())              # [M, B, S, sum]
    off = 0
    for i in cut:
        n = out[i].shape[-1]
        blk = got[..., off:off + n]                       # [M, B, S, n]
        out[i] = blk.permute(1, 2, 0, 3).reshape(*blk.shape[1:3], -1)
        off += n
    return out


def qkv_proj(p, x, cfg):
    """q [B, S, H, Dh], k and v [B, S, K, Dh]. Under a trunk split the
    column blocks read x through `model_copy` (in a train step their
    input's gradient is summed over the ranks), a whole leaf reads x
    itself (every rank computes its whole gradient), and a whole bias's
    columns go through `model_copy` (the rank's gradient covers only its
    columns). Where the rank gathers whole heads, the attention's output
    gradient is a partial (the rank uses only its wo rows), so a whole
    k/v takes `model_copy` as well, and the blocks join by
    `model_gather_stack`. `model_copy` is the identity forward."""
    B, S, D = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    tp, mesh = current_trunk(), current_mesh()
    spans = (None,) * 3 if tp is None else \
        (tp.q_cols, tp.kv_cols, tp.kv_cols)
    gathers = tp is not None and tp.gathers
    xs = model_copy(x, mesh) if any(spans) else x
    out = []
    for (w, b), span in zip((("wq", "bq"), ("wk", "bk"), ("wv", "bv")),
                            spans):
        y = matmul(x if span is None else xs, p[w])
        if b in p:
            y = y + (p[b] if span is None else
                     _cols(model_copy(p[b], mesh, "bias-grad"), span))
        if span is None and gathers and any(spans):
            y = model_copy(y, mesh, "kv-grad")
        out.append(y)
    if gathers:
        out = _whole_cols(list(zip(out, spans)))
    q, k, v = out
    return (q.reshape(B, S, H, Dh), k.reshape(B, S, K, Dh),
            v.reshape(B, S, K, Dh))


def attn_out(p, o):
    """o [B,S,H,Dh] @ wo; under a trunk split of wo's rows (`wo_rows`)
    the rank's rows give a partial sum over H*Dh, summed over the ranks
    (`model_sum`): o holds the rank's heads (head split), or every head,
    of which the rank takes its rows' columns (where it gathers; wo
    whole where M does not divide H*Dh, and nothing to reduce)."""
    B, S, H, Dh = o.shape
    o = o.reshape(B, S, H * Dh)
    tp = current_trunk()
    rows = None if tp is None else tp.wo_rows
    if rows is not None and tp.gathers:
        o = o[..., rows[0]:rows[1]]
    y = matmul(o, p["wo"])
    if rows is not None:
        y = model_sum(y, current_mesh())
    return y


# ----------------------------- FFN -----------------------------------------

def init_ffn(gen, d_model, d_ff, dtype, lead=()):
    return {
        "w_gate": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype=dtype),
    }


def ffn(p, x):
    """SwiGLU; under a trunk split of d_ff the rank's block reads x
    through `model_copy` and gives a partial sum over d_ff, summed over
    the ranks (`model_sum`); an FFN kept whole is neither."""
    tp = current_trunk()
    split = tp is not None and tp.ff_split
    if split:
        x = model_copy(x, current_mesh())
    h = torch.nn.functional.silu(matmul(x, p["w_gate"])) * \
        matmul(x, p["w_up"])
    y = matmul(h, p["w_down"])
    if split:
        y = model_sum(y, current_mesh())
    return y


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
    which is exact. In a train step whose vocabulary is split
    (`api.train_model()`), the rank holds embed's rows [v0, v1) of
    `param_spec` and the sum is `model_sum` (the lookup's gradient goes
    to the rank's own rows)."""
    tm = train_model()
    if tm is not None and tm[1] is not None:
        (v0, v1), n = tm[1], tm[1][1] - tm[1][0]
        local = tokens.long() - v0
        own = (local >= 0) & (local < n)
        rows = p["embed"][local.clamp(0, n - 1)]
        rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
        return model_sum(rows, tm[0], "lookup")
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
    use the embed's rows transposed). In a train step whose vocabulary
    is split, the rank's rows of the vocabulary -> [..., V/M], its input
    through `model_copy`."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    tm = train_model()
    if tm is not None and tm[1] is not None:
        x = model_copy(x, tm[0])
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
