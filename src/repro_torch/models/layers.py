"""Layer kinds with their explicit caches (port of `repro.models.layers`):
`attn` (self-attention + dense FFN), `moe` (self-attention + routed
experts), `rec` (RG-LRU + dense FFN, RecurrentGemma), `ssm` (Mamba2),
Whisper's `enc` (non-causal encoder layer, train form only: the model
runs it on the frames) and `dec` (causal self-attention, cross attention
to the encoder's output, FFN), and the vlm's `cross` (tanh-gated cross
attention to the image embeddings, FFN).

Each kind has init_<kind>(gen, cfg, dtype, lead) -> params stacked on
`lead`, <kind>_train(params, x, cfg, ctx) -> (x, aux {"lb", "z"}),
<kind>_prefill(params, x, cfg, ctx) -> (x, cache) and
<kind>_decode(params, x, cache, cfg, ctx) -> (x, cache). Training runs
attention through the differentiable flash_attention op (the Hopper
forward and backward kernels on the card). ctx holds
"cache_len", "true_len", "pos", "feed_mask", "page_table", "window"
(a per-model window override: the hybrid arch's local attention),
"enc_out" (the audio arch's encoded frames, which `dec` attends to) and
"image_embeds" (the vlm's image tokens, which `cross` attends to).

KV caches store rotated K plus a per-slot absolute-position array
(`kv_pos`, -1 = empty) so ring-buffer (sliding-window) and linear caches
share one masking rule: valid <=> 0 <= kv_pos <= q_pos (and
q_pos - kv_pos < window).

Under a trunk-sharded engine where M does not divide the kv heads
(`TrunkPlan.gathers`) q/k/v come whole from `qkv_proj`, and each kind of
cache takes the branch the reference's `cache_spec` gives its length
(`TrunkPlan.cache` for the dense caches, `.pool` for the page pools):
  * "seq": a rank's dense cache holds its positions `positions` of the L
    (k/v [B, L/M, K, Dh]) and its pools the in-page offsets `offsets` of
    every page ([P, ps/M, K, Dh]); decode attends over them
    (`attend_partial`, `paged_attention_partial`) and joins the ranks'
    partials by their log-sum-exp (`_join`);
  * "dh": k/v hold the rank's head_dim block `head_dims` = [d0, d1) of
    every position ([B, L, K, dw], [P, ps, K, dw]); decode forms its fp32
    partial scores (`dh_scores`, `paged_attention_scores`), all-reduces
    them, masks and softmaxes once, multiplies P by its V block
    (`dh_values`, `paged_attention_values`) and gathers the blocks
    (`_dh_join`), as the reference's jnp path runs under GSPMD;
  * "whole": every rank holds and attends over the whole cache, as one
    device does.
kv_pos stays whole in every branch, as the reference's `cache_spec`
keeps it. Prefill attends as one device does (the flash kernel on the
gathered q/k/v) and writes the rank's share of every cache.

Unlike the functional reference, decode writes the new K/V into the
cache IN PLACE (the cache dict passed in is the one returned), which
saves a full cache copy per layer per step. The same holds for the paged
KV pools: a span feed scatters its K/V into the shared pool leaves in
place.
"""
from __future__ import annotations

import torch

from .common import (apply_rope, attn_out, ffn, init_attention, init_ffn,
                     matmul, qkv_proj, rms_norm)
from .moe import init_moe, moe_ffn
from .rglru import init_rglru, rglru_decode, rglru_prefill, rglru_train
from .ssm import init_ssm, ssm_decode, ssm_prefill, ssm_train
from ..distributed.api import (all_gather_last, all_gather_stack,
                               current_mesh, current_trunk,
                               trunk_all_reduce)
from ..kernels.flash_attention.ops import attention, qscale
from ..kernels.flash_attention.ref import qscale_tensor
from ..kernels.paged_attention.ops import (paged_attention,
                                          paged_attention_partial,
                                          paged_attention_scores,
                                          paged_attention_values)
from ..kernels.paged_attention.ref import (attend, attend_partial,
                                           combine_partials, dh_probs,
                                           dh_scores, dh_values)


def _window_of(cfg, ctx):
    return ctx.get("window", cfg.sliding_window)


def _cache_len(cfg, ctx, seq_len):
    w = _window_of(cfg, ctx)
    L = ctx.get("cache_len", seq_len)
    return min(L, w) if w else L


def _kv_split(kind):
    """(this rank's TrunkPlan, its split of the `kind` caches: "cache"
    the dense ones, "pool" the page pools) where the rank gathers whole
    q/k/v, else (None, None): a cache then holds the local config's kv
    heads whole."""
    tp = current_trunk()
    if tp is None or not tp.gathers:
        return None, None
    split = getattr(tp, kind)
    if split is None:
        raise ValueError(f"trunk_shard: this rank's plan was made without "
                         f"a length for its {kind} caches")
    return tp, split


def _block(t, tp, split):
    """t [..., Dh] -> the rank's head_dim block under "dh", else t."""
    return t[..., tp.head_dims[0]:tp.head_dims[1]] if split == "dh" else t


def init_kv_cache(cfg, batch, length, dtype, device, lead=()):
    """k/v [*lead, batch, n, K, dw]: n the length and dw the head_dim, or
    under a trunk-sharded engine's split of the dense caches (planned for
    this length) the rank's share of the positions (`TrunkPlan.positions`,
    "seq") or of head_dim (`TrunkPlan.head_dims`, "dh"); kv_pos
    [*lead, batch, length] whole."""
    K = cfg.num_kv_heads
    Dh = cfg.resolved_head_dim
    tp, split = _kv_split("cache")
    n = tp.positions[1] - tp.positions[0] if split == "seq" else length
    dw = tp.head_dims[1] - tp.head_dims[0] if split == "dh" else Dh
    return {
        "k": torch.zeros((*lead, batch, n, K, dw), dtype=dtype,
                         device=device),
        "v": torch.zeros((*lead, batch, n, K, dw), dtype=dtype,
                         device=device),
        "kv_pos": torch.full((*lead, batch, length), -1, dtype=torch.int32,
                             device=device),
    }


def _join(o, lse, dtype):
    """The ranks' partial attentions (fp32 o [B,S,H,Dh], lse [B,S,H])
    joined by their log-sum-exp: one all-gather of [o | lse]."""
    got = all_gather_stack(torch.cat([o, lse[..., None]], -1),
                           current_mesh())
    return combine_partials(got[..., :-1], got[..., -1], dtype)


def _dh_join(s, valid, values, dtype, out_dtype):
    """The head_dim split's attention from this rank's fp32 partial
    scores s [B,S,H,L]: one all-reduce joins them, the mask valid
    [B,S,L] and the fp32 softmax apply once (P rounded to `dtype`, the
    values'), `values(P)` gives the rank's fp32 block of P.V's channels,
    rounded to `out_dtype`, and one all-gather joins the blocks in rank
    order, which is channel order -> [B,S,H,Dh]."""
    mesh = current_mesh()
    s = trunk_all_reduce(s, mesh)
    o = values(dh_probs(s, valid, dtype)).to(out_dtype)
    return all_gather_last(o, (o.shape[-1],) * mesh.size, mesh)


def _self_attention_train(p, x, cfg, ctx):
    """Causal self-attention over the whole sequence (the ctx window, if
    any) through the differentiable attention op."""
    B, S, D = x.shape
    q, k, v = qkv_proj(p, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=_window_of(cfg, ctx),
                  chunk=cfg.attn_chunk)
    return attn_out(p, o)


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
    tp, split = _kv_split("cache")
    cache = init_kv_cache(cfg, B, L, x.dtype, dev)
    if split == "seq":  # the rank's positions [lo, hi) only
        lo, hi = tp.positions
        mine = (slot >= lo) & (slot < hi)
        cache["k"][:, slot[mine] - lo] = k[:, src[mine]]
        cache["v"][:, slot[mine] - lo] = v[:, src[mine]]
    else:               # every position: its head_dim block under "dh"
        cache["k"][:, slot] = _block(k, tp, split)[:, src]
        cache["v"][:, slot] = _block(v, tp, split)[:, src]
    cache["kv_pos"][:, slot] = torch.where(
        take < limit, take, -1).to(torch.int32)[None, :].expand(B, L)
    return attn_out(p, o), cache


def _paged_attention_decode(p, x, cache, cfg, ctx):
    """Paged twin of `_self_attention_decode`: the cache is a global page
    pool {"k","v": [P, ps, K, Dh]} shared by every slot, and
    ctx["page_table"] [B, nP] (int32, -1 = unmapped) names each slot's
    pages. Span position i of slot b writes its K/V at
    (page_table[b, (pos+i)//ps], (pos+i)%ps) in place; a position whose
    page is unmapped, whose page index falls past the table (padding of
    a span near max_len) or whose feed_mask is False writes nothing.
    Attention reads back through the page table
    (`kernels.paged_attention`). Rejected speculative writes roll back as
    in the dense path: positions past the commit frontier are masked
    (idx <= q_pos) and overwritten on re-feed. Under a split of the
    pools (`TrunkPlan.pool`): "seq", the pools hold the rank's offsets
    [o0, o1) of pages of ps = M (o1 - o0) positions, and the rank writes
    positions at those offsets only and joins its partial attention with
    the other ranks'; "dh", they hold its head_dim block [d0, d1) of
    every position, and the rank writes that block and runs the kernel's
    head_dim form around the joins (`_dh_join`); "whole", as one
    device."""
    B, S, D = x.shape
    dev = x.device
    kp, vp = cache["k"], cache["v"]                     # [P,ps(/M),K,dw]
    P, psl, K, dw = kp.shape
    tp, split = _kv_split("pool")
    ps = psl * tp.size if split == "seq" else psl
    o0 = tp.offsets[0] if split == "seq" else 0
    pos = torch.as_tensor(ctx["pos"], dtype=torch.int32,
                          device=dev).expand(B)
    qpos = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                       device=dev)[None, :]     # [B,S]
    q, k, v = qkv_proj(p, x, cfg)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    pt = ctx["page_table"]
    nP = pt.shape[1]
    pidx = (qpos // ps).long()
    inb = pidx < nP
    page = torch.where(inb, torch.gather(pt, 1, pidx.clamp(max=nP - 1)),
                       -1)                                      # [B,S]
    ok = page >= 0
    feed = ctx.get("feed_mask")
    if feed is not None:
        ok &= feed
    off = (qpos % ps).long() - o0
    if split == "seq":
        ok &= (off >= 0) & (off < psl)
    dest = (page.long() * psl + off)[ok]
    kp.view(P * psl, K, dw)[dest] = _block(k, tp, split)[ok].to(kp.dtype)
    vp.view(P * psl, K, dw)[dest] = _block(v, tp, split)[ok].to(vp.dtype)
    if split == "seq":
        o = _join(*paged_attention_partial(q, kp, vp, pt, pos, ps, o0),
                  q.dtype)
    elif split == "dh":
        idx = torch.arange(nP * ps, dtype=torch.int32, device=dev)
        mapped = (pt >= 0).repeat_interleave(ps, dim=1)         # [B,L]
        valid = mapped[:, None, :] & (idx[None, None, :] <=
                                      qpos[:, :, None])
        o = _dh_join(paged_attention_scores(q, kp, pt, tp.head_dims[0]),
                     valid, lambda pr: paged_attention_values(pr, vp, pt),
                     vp.dtype, q.dtype)
    else:
        o = paged_attention(q, kp, vp, pt, pos)
    return attn_out(p, o), cache


def _self_attention_decode(p, x, cache, cfg, ctx):
    """x [B,S,D] (S = 1 plain decode; S > 1 a speculative or prefill
    span); ctx['pos'] is a scalar or [B] int tensor of absolute START
    positions — span query i sits at absolute position pos + i.
    ctx['feed_mask'] [B,S] bool (optional) gates cache writes per
    position. Writes go into `cache` in place; position-addressed masking
    (kv_pos <= q_pos) makes a rewrite of a position idempotent. With a
    page table in ctx the slot's KV lives in the shared paged pool
    instead (`_paged_attention_decode`). Under a split of the dense
    caches (`TrunkPlan.cache`) the rank writes its positions ("seq") or
    its head_dim block ("dh") and joins the ranks' attention (module
    docstring)."""
    if "page_table" in ctx:
        return _paged_attention_decode(p, x, cache, cfg, ctx)
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
    L = kvp.shape[1]            # kv_pos is whole under every split
    slot = (qpos % L).long()                                    # [B,S]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    feed = ctx.get("feed_mask")
    pn = qpos if feed is None else torch.where(feed, qpos, kvp[bidx, slot])
    tp, split = _kv_split("cache")
    if split == "seq":  # the rank's positions [lo, hi) only
        lo, hi = tp.positions
        mine = (slot >= lo) & (slot < hi)
        if feed is not None:
            mine &= feed
        kc[bidx[mine], slot[mine] - lo] = k[mine].to(kc.dtype)
        vc[bidx[mine], slot[mine] - lo] = v[mine].to(vc.dtype)
    else:               # its head_dim block under "dh"
        kn = _block(k, tp, split).to(kc.dtype)
        vn = _block(v, tp, split).to(vc.dtype)
        if feed is not None:
            kn = torch.where(feed[..., None, None], kn, kc[bidx, slot])
            vn = torch.where(feed[..., None, None], vn, vc[bidx, slot])
        kc[bidx, slot] = kn
        vc[bidx, slot] = vn
    kvp[bidx, slot] = pn

    w = _window_of(cfg, ctx)
    valid = (kvp[:, None, :] >= 0) & (kvp[:, None, :] <= qpos[:, :, None])
    if w:
        valid &= kvp[:, None, :] > (qpos[:, :, None] - w)
    if split == "seq":
        o = _join(*attend_partial(q, kc, vc, valid[..., lo:hi]), q.dtype)
    elif split == "dh":
        o = _dh_join(dh_scores(q, kc, tp.head_dims[0]), valid,
                     lambda pr: dh_values(pr, vc), vc.dtype, q.dtype)
    else:
        o = attend(q, kc, vc, valid)
    return attn_out(p, o), cache


# ---- "attn": self-attention + dense FFN (pre-norm residual) ----

def _norm(gen, cfg, dtype, lead):
    return torch.ones((*lead, cfg.d_model), dtype=dtype, device=gen.device)


def init_attn_layer(gen, cfg, dtype, lead=()):
    return {"ln1": _norm(gen, cfg, dtype, lead),
            "attn": init_attention(gen, cfg, dtype, lead),
            "ln2": _norm(gen, cfg, dtype, lead),
            "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, lead)}


def _zero_aux(x):
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    return {"lb": z, "z": z}


def attn_train(p, x, cfg, ctx):
    x = x + _self_attention_train(p["attn"],
                                  rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                  ctx)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, _zero_aux(x)


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


# ---- "moe": self-attention + MoE FFN ----

def init_moe_layer(gen, cfg, dtype, lead=()):
    return {"ln1": _norm(gen, cfg, dtype, lead),
            "attn": init_attention(gen, cfg, dtype, lead),
            "ln2": _norm(gen, cfg, dtype, lead),
            "moe": init_moe(gen, cfg, dtype, lead)}


def moe_train(p, x, cfg, ctx):
    x = x + _self_attention_train(p["attn"],
                                  rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                  ctx)
    y, aux = moe_ffn(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, {"lb": aux["lb_loss"], "z": aux["z_loss"]}


def moe_prefill(p, x, cfg, ctx):
    o, cache = _self_attention_prefill(p["attn"],
                                       rms_norm(x, p["ln1"], cfg.norm_eps),
                                       cfg, ctx)
    x = x + o
    y, _ = moe_ffn(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, cache


def moe_decode(p, x, cache, cfg, ctx):
    o, cache = _self_attention_decode(p["attn"],
                                      rms_norm(x, p["ln1"], cfg.norm_eps),
                                      cache, cfg, ctx)
    x = x + o
    y, _ = moe_ffn(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, cache


# ---- "rec": RG-LRU recurrent block + FFN (RecurrentGemma) ----

def init_rec_layer(gen, cfg, dtype, lead=()):
    return {"ln1": _norm(gen, cfg, dtype, lead),
            "rec": init_rglru(gen, cfg, dtype, lead),
            "ln2": _norm(gen, cfg, dtype, lead),
            "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, lead)}


def rec_train(p, x, cfg, ctx):
    x = x + rglru_train(p["rec"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, _zero_aux(x)


def rec_prefill(p, x, cfg, ctx):
    o, cache = rglru_prefill(p["rec"], rms_norm(x, p["ln1"], cfg.norm_eps),
                             cfg)
    x = x + o
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache


def rec_decode(p, x, cache, cfg, ctx):
    o, cache = rglru_decode(p["rec"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cache, cfg)
    x = x + o
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache


# ---- "ssm": Mamba2 block (no separate FFN; norm + SSD + residual) ----

def init_ssm_layer(gen, cfg, dtype, lead=()):
    return {"ln1": _norm(gen, cfg, dtype, lead),
            "ssm": init_ssm(gen, cfg, dtype, lead)}


def ssm_layer_train(p, x, cfg, ctx):
    return (x + ssm_train(p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                          cfg), _zero_aux(x))


def ssm_layer_prefill(p, x, cfg, ctx):
    o, cache = ssm_prefill(p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                           cfg)
    return x + o, cache


def ssm_layer_decode(p, x, cache, cfg, ctx):
    o, cache = ssm_decode(p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                          cache, cfg)
    return x + o, cache


# ---- cross attention (shared by `dec` and vlm's `cross`) ----

def _cross_kv(p, mem, cfg):
    """K and V of the memory mem [B, Sm, D] -> two [B, Sm, K, Dh], in the
    wider of mem's and the weights' dtypes (fp32 memory under bf16
    weights gives fp32 K/V, as the reference's promotion does)."""
    B, Sm, D = mem.shape
    K, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    k = matmul(mem, p["wk"])
    v = matmul(mem, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return k.reshape(B, Sm, K, Dh), v.reshape(B, Sm, K, Dh)


def _cross_attention(p, x, k, v, cfg):
    """Every query of x [B, S, D] over every memory key (no positions, no
    RoPE): the non-causal attention op at any S and Sm. K/V wider than
    the queries (the only mixed case: fp32 memory under bf16 weights)
    run as the reference runs them: q scaled and rounded in its own
    dtype, then scores, P and P.V in fp32 (the fp32 kernel route), the
    output cast back to q's dtype. The fp32 route scales q inside the
    kernel, so the rounded q^ is handed to it divided by that scale
    (pre-rounded)."""
    B, S, D = x.shape
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    q = matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, H, Dh)
    if k.dtype == q.dtype:
        o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    else:
        qh = (q * qscale_tensor(q.dtype, Dh)).to(k.dtype) / qscale(k.dtype,
                                                                  Dh)
        o = attention(qh, k, v, causal=False,
                      chunk=cfg.attn_chunk).to(q.dtype)
    return attn_out(p, o)


# ---- "cross": tanh-gated cross attention to image tokens + FFN (VLM) ----

def init_cross_layer(gen, cfg, dtype, lead=()):
    """The attention and FFN of an `attn` layer plus the residual gate
    [*lead, 1], zeros as in the reference (tanh(0) = 0: at init a cross
    layer adds no attention)."""
    return {**init_attn_layer(gen, cfg, dtype, lead),
            "gate": torch.zeros((*lead, 1), dtype=dtype, device=gen.device)}


def _memory(ctx):
    return ctx["image_embeds"] if "image_embeds" in ctx else ctx["enc_out"]


def _gated_cross(p, x, k, v, cfg):
    """x + tanh(gate) * cross attention (tanh in fp32, cast to x's
    dtype), then the FFN."""
    g = torch.tanh(p["gate"].float()).to(x.dtype)
    x = x + g * _cross_attention(p["attn"],
                                 rms_norm(x, p["ln1"], cfg.norm_eps),
                                 k, v, cfg)
    return x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))


def cross_train(p, x, cfg, ctx):
    k, v = _cross_kv(p["attn"], _memory(ctx), cfg)
    return _gated_cross(p, x, k, v, cfg), _zero_aux(x)


def cross_prefill(p, x, cfg, ctx):
    """-> (x, {"k", "v"}): the memory's K/V, kept for every decode step."""
    k, v = _cross_kv(p["attn"], _memory(ctx), cfg)
    return _gated_cross(p, x, k, v, cfg), {"k": k, "v": v}


def cross_decode(p, x, cache, cfg, ctx):
    """Reads the prefill's K/V; writes nothing."""
    return _gated_cross(p, x, cache["k"], cache["v"], cfg), cache


# ---- "enc": non-causal encoder layer (Whisper encoder) ----

def init_enc_layer(gen, cfg, dtype, lead=()):
    return init_attn_layer(gen, cfg, dtype, lead)


def enc_train(p, x, cfg, ctx):
    """Pre-norm self-attention over all frames (RoPE at arange(S) on q
    and k, as the reference) + FFN."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_proj(p["attn"], h, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    x = x + attn_out(p["attn"], o)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, _zero_aux(x)


# ---- "dec": decoder layer with self + cross attention (Whisper) ----

def init_dec_layer(gen, cfg, dtype, lead=()):
    return {"ln1": _norm(gen, cfg, dtype, lead),
            "attn": init_attention(gen, cfg, dtype, lead),
            "lnx": _norm(gen, cfg, dtype, lead),
            "xattn": init_attention(gen, cfg, dtype, lead),
            "ln2": _norm(gen, cfg, dtype, lead),
            "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, lead)}


def dec_train(p, x, cfg, ctx):
    x = x + _self_attention_train(p["attn"],
                                  rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                  ctx)
    k, v = _cross_kv(p["xattn"], ctx["enc_out"], cfg)
    x = x + _cross_attention(p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps),
                             k, v, cfg)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, _zero_aux(x)


def dec_prefill(p, x, cfg, ctx):
    """-> (x, {"self": the self-attention cache, "cross": {"k", "v"}}):
    the cross K/V of the encoder's output, kept for every decode step."""
    o, self_cache = _self_attention_prefill(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, ctx)
    x = x + o
    k, v = _cross_kv(p["xattn"], ctx["enc_out"], cfg)
    x = x + _cross_attention(p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps),
                             k, v, cfg)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, {"self": self_cache, "cross": {"k": k, "v": v}}


def dec_decode(p, x, cache, cfg, ctx):
    """The self cache is written in place; the cross K/V are read."""
    o, _ = _self_attention_decode(p["attn"],
                                  rms_norm(x, p["ln1"], cfg.norm_eps),
                                  cache["self"], cfg, ctx)
    x = x + o
    x = x + _cross_attention(p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps),
                             cache["cross"]["k"], cache["cross"]["v"], cfg)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, cache


KIND_INIT = {"attn": init_attn_layer, "moe": init_moe_layer,
             "cross": init_cross_layer, "rec": init_rec_layer,
             "ssm": init_ssm_layer, "enc": init_enc_layer,
             "dec": init_dec_layer}
KIND_TRAIN = {"attn": attn_train, "moe": moe_train, "cross": cross_train,
              "rec": rec_train, "ssm": ssm_layer_train, "enc": enc_train,
              "dec": dec_train}
KIND_PREFILL = {"attn": attn_prefill, "moe": moe_prefill,
                "cross": cross_prefill, "rec": rec_prefill,
                "ssm": ssm_layer_prefill, "dec": dec_prefill}
KIND_DECODE = {"attn": attn_decode, "moe": moe_decode,
               "cross": cross_decode, "rec": rec_decode,
               "ssm": ssm_layer_decode, "dec": dec_decode}
