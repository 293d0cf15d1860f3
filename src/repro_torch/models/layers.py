"""The `attn` layer kind with its explicit KV cache (port of the dense
subset of `repro.models.layers`).

KV caches store rotated K plus a per-slot absolute-position array
(`kv_pos`, -1 = empty) so ring-buffer (sliding-window) and linear caches
share one masking rule: valid <=> 0 <= kv_pos <= q_pos (and
q_pos - kv_pos < window).

Unlike the functional reference, decode writes the new K/V into the
cache IN PLACE (the cache dict passed in is the one returned), which
saves a full cache copy per layer per step.
"""
from __future__ import annotations

import torch

from .common import NEG_INF, apply_rope, attn_out, ffn, qkv_proj, rms_norm
from ..kernels.flash_attention.ops import attention


def _window_of(cfg, ctx):
    return ctx.get("window", cfg.sliding_window)


def _cache_len(cfg, ctx, seq_len):
    w = _window_of(cfg, ctx)
    L = ctx.get("cache_len", seq_len)
    return min(L, w) if w else L


def init_kv_cache(cfg, batch, length, dtype, device, lead=()):
    K = cfg.num_kv_heads
    Dh = cfg.resolved_head_dim
    return {
        "k": torch.zeros((*lead, batch, length, K, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((*lead, batch, length, K, Dh), dtype=dtype,
                         device=device),
        "kv_pos": torch.full((*lead, batch, length), -1, dtype=torch.int32,
                             device=device),
    }


def _self_attention_prefill(p, x, cfg, ctx):
    """Returns (out, cache) — cache covers the last `cache_len` positions
    (ring layout slot = pos % cache_len). Attention runs through the
    flash_attention op (the Hopper kernel on the card)."""
    B, S, D = x.shape
    dev = x.device
    q, k, v = qkv_proj(p, x, cfg)
    positions = torch.arange(S, device=dev)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=_window_of(cfg, ctx),
                  chunk=cfg.attn_chunk)
    L = _cache_len(cfg, ctx, S)
    take = torch.arange(L, device=dev) + max(0, S - L)   # last L positions
    slot = take % L
    # true_len < S marks bucket-padded prompt tail positions as empty:
    # kv_pos = -1 keeps them unattendable. Positions past S (cache longer
    # than the prompt) read the last row, as the reference's clamped
    # gather does; kv_pos = -1 hides them too.
    limit = min(S, int(ctx["true_len"])) if "true_len" in ctx else S
    src = take.clamp(max=S - 1)
    cache = init_kv_cache(cfg, B, L, x.dtype, dev)
    cache["k"][:, slot] = k[:, src]
    cache["v"][:, slot] = v[:, src]
    cache["kv_pos"][:, slot] = torch.where(
        take < limit, take, -1).to(torch.int32)[None, :].expand(B, L)
    return attn_out(p, o), cache


def _self_attention_decode(p, x, cache, cfg, ctx):
    """x [B,S,D] (S = 1 plain decode); ctx['pos'] is a scalar or [B]
    int tensor of absolute START positions — span query i sits at
    absolute position pos + i. ctx['feed_mask'] [B,S] bool (optional)
    gates cache writes per position. Writes go into `cache` in place;
    position-addressed masking (kv_pos <= q_pos) makes a rewrite of a
    position idempotent."""
    B, S, D = x.shape
    dev = x.device
    pos = torch.as_tensor(ctx["pos"], dtype=torch.int32,
                          device=dev).expand(B)
    qpos = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                       device=dev)[None, :]     # [B,S]
    q, k, v = qkv_proj(p, x, cfg)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    kc, vc, kvp = cache["k"], cache["v"], cache["kv_pos"]
    L = kc.shape[1]
    slot = (qpos % L).long()                                    # [B,S]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    kn, vn, pn = k.to(kc.dtype), v.to(vc.dtype), qpos
    feed = ctx.get("feed_mask")
    if feed is not None:
        kn = torch.where(feed[..., None, None], kn, kc[bidx, slot])
        vn = torch.where(feed[..., None, None], vn, vc[bidx, slot])
        pn = torch.where(feed, pn, kvp[bidx, slot])
    kc[bidx, slot] = kn
    vc[bidx, slot] = vn
    kvp[bidx, slot] = pn

    w = _window_of(cfg, ctx)
    valid = (kvp[:, None, :] >= 0) & (kvp[:, None, :] <= qpos[:, :, None])
    if w:
        valid &= kvp[:, None, :] > (qpos[:, :, None] - w)
    Dh = q.shape[-1]
    K = kc.shape[2]
    G = cfg.num_heads // K
    qg = (q * torch.tensor(1.0 / Dh ** 0.5, dtype=q.dtype)).reshape(
        B, S, K, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float())
    s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr.to(vc.dtype).float(),
                     vc.float())
    o = o.reshape(B, S, cfg.num_heads, Dh).to(x.dtype)
    return attn_out(p, o), cache


# ---- "attn": self-attention + dense FFN (pre-norm residual) ----

def attn_prefill(p, x, cfg, ctx):
    o, cache = _self_attention_prefill(p["attn"],
                                       rms_norm(x, p["ln1"], cfg.norm_eps),
                                       cfg, ctx)
    x = x + o
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache


def attn_decode(p, x, cache, cfg, ctx):
    o, cache = _self_attention_decode(p["attn"],
                                      rms_norm(x, p["ln1"], cfg.norm_eps),
                                      cache, cfg, ctx)
    x = x + o
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache


KIND_PREFILL = {"attn": attn_prefill}
KIND_DECODE = {"attn": attn_decode}
