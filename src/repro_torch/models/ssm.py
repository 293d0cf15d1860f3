"""Mamba2 / SSD (state-space duality) block (port of `repro.models.ssm`)
[arXiv:2405.21060].

Prefill (and training, `ssm_train`: the same forward without the cache)
runs the chunked SSD algorithm in fp32 as the reference does:
the sequence is split into chunks of Q = min(ssm_chunk, S) tokens; the
intra-chunk terms are batched products, and the inter-chunk term is a
first-order recurrence over the chunk states (a Python loop over the
chunks, the reference's `lax.scan`). The reference asserts S % Q == 0,
and so does the port: a recurrent arch prefills at exact length, so a
prompt longer than one chunk must be a whole number of chunks. Decode is
the O(1) recurrent update h' = exp(dt.A).h + dt.(B x) with the depthwise
conv's last K-1 inputs carried in the cache.

Layout: d_inner = expand * d_model, heads Hs = d_inner / ssm_head_dim
(P), state N = cfg.ssm_state, one B/C group. Decode writes the new `h`
and `conv` into the cache dict it is given IN PLACE (the model's decode
loop hands in views of the stacked cache) and returns the same dict.

Under a trunk-sharded engine (`distributed.api.current_trunk()`, the
plan's `ssm_*` blocks, each None where the reference's rule leaves the
leaf whole) a rank holds w_in's columns `ssm_in` of [z | xBC | dt],
conv_w's and the conv cache's xBC channels `ssm_conv`, the state's heads
`ssm_heads` and w_out's rows `ssm_rows`; norm_w, conv_b, A_log, D and
dt_bias stay whole. A layer then issues three collectives when every
block splits (mamba2-370m at M = 2, 4, 8): one all-gather joins the
ranks' projection columns into the whole [z | xBC | dt] (a rank's conv
channels and heads need columns other ranks project), one joins the
conv outputs into the whole xBC (a rank's heads read every B and C
channel), and one all-reduce carries [the unscaled w_out partial | the
gated norm's fp32 sum of squares]: the norm's scale is one number a row,
so it multiplies the summed partials after the reduce, and the norm over
the whole d_inner costs no collective of its own. A whole leaf drops its
gather; with the heads whole the rank normalizes the whole y itself and
the all-reduce carries the partial alone (none when w_out is whole).
The rank's cache holds its heads' state and its conv channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.api import (all_gather_last, current_mesh, current_trunk,
                               trunk_all_reduce)
from .common import dense_init

_NORM_EPS = 1e-6        # the gated norm's, as the reference's


def init_ssm(gen, cfg, dtype, lead=()):
    D, Din, Hs, N, Kc = (cfg.d_model, cfg.ssm_inner, cfg.ssm_heads,
                         cfg.ssm_state, cfg.conv_kernel)
    conv_dim = Din + 2 * N           # conv over x, B, C (mamba2 layout)
    dev = gen.device
    f32 = torch.float32
    return {
        # in_proj -> [z, xBC, dt]
        "w_in": dense_init(gen, (*lead, D, 2 * Din + 2 * N + Hs),
                           dtype=dtype),
        "conv_w": dense_init(gen, (*lead, Kc, conv_dim), scale=0.5,
                             dtype=dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "A_log": torch.zeros((*lead, Hs), dtype=f32, device=dev),
        "D": torch.ones((*lead, Hs), dtype=f32, device=dev),
        "dt_bias": torch.zeros((*lead, Hs), dtype=f32, device=dev),
        "w_out": dense_init(gen, (*lead, Din, D), dtype=dtype),
        "norm_w": torch.ones((*lead, Din), dtype=dtype, device=dev),
    }


def _split_proj(cfg, proj):
    Din, N = cfg.ssm_inner, cfg.ssm_state
    z = proj[..., :Din]
    xBC = proj[..., Din:Din + Din + 2 * N]
    dt = proj[..., Din + Din + 2 * N:]
    return z, xBC, dt


def _blocks(cfg):
    """(this rank's plan under a trunk split, else None; its conv
    channels [c0, c1); its heads [h0, h1)), the ranges whole where the
    plan leaves them so."""
    tp = current_trunk()
    conv, heads = (0, cfg.ssm_inner + 2 * cfg.ssm_state), (0, cfg.ssm_heads)
    if tp is None:
        return None, conv, heads
    return tp, tp.ssm_conv or conv, tp.ssm_heads or heads


def _whole(y, tp, block):
    """y holding the rank's columns of the plan's `block` (ssm_in or
    ssm_conv) joined with the other ranks' into the whole last dim (one
    all-gather of equal blocks); y itself when the leaf is whole."""
    span = None if tp is None else getattr(tp, block)
    if span is None:
        return y
    return all_gather_last(y, (span[1] - span[0],) * tp.size,
                           current_mesh())


def _out(params, y, z, dtype, tp):
    """The gated norm over the whole d_inner, then w_out. y [.., n] holds
    the SSD output of the rank's heads (all of them unsplit), z [.., n]
    the gate of the same channels. Under a trunk split of the heads (so
    of w_out's rows, the same channels) one all-reduce sums [the w_out
    partial of the unscaled (y silu(z)) norm_w | its sum of squares]
    and the norm's scale multiplies the sum; else y is whole, normalized
    as one device does, and w_out's rows, when split, give a partial
    sum, all-reduced."""
    if tp is None or tp.ssm_heads is None:
        y = _gated_norm(y, z, params["norm_w"]).to(dtype)
        rows = None if tp is None else tp.ssm_rows
        if rows is None:
            return y @ params["w_out"]
        return trunk_all_reduce(y[..., rows[0]:rows[1]] @ params["w_out"],
                                current_mesh())
    r0, r1 = tp.ssm_rows
    g = y * F.silu(z.float())
    part = (g * params["norm_w"][r0:r1].float()).to(dtype) @ params["w_out"]
    red = trunk_all_reduce(torch.cat(
        [part.float(), torch.sum(torch.square(g), dim=-1, keepdim=True)],
        -1), current_mesh())
    var = red[..., -1:] / params["norm_w"].shape[-1]
    return (red[..., :-1] * torch.rsqrt(var + _NORM_EPS)).to(dtype)


def _causal_conv_train(xBC, w, b):
    """Depthwise causal conv over seq. xBC [B,S,C], w [K,C]."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _gated_norm(y, z, w, eps=_NORM_EPS):
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * w.float()


def ssm_train(params, x, cfg):
    """x [B,S,D] -> [B,S,D] via chunked SSD (no cache)."""
    return _ssd_forward(params, x, cfg, return_state=False)[0]


def ssm_prefill(params, x, cfg):
    """x [B,S,D] -> (y [B,S,D], cache {"h", "conv"}); the final recurrent
    state feeds decode."""
    return _ssd_forward(params, x, cfg, return_state=True)


def _ssd_forward(params, x, cfg, return_state: bool):
    B, S, D = x.shape
    Din, N, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)
    nch = S // Q
    tp, (c0, c1), (h0, h1) = _blocks(cfg)
    Hs = h1 - h0                                            # the rank's

    proj = _whole(x @ params["w_in"], tp, "ssm_in")
    z, xBC_raw, dt_raw = _split_proj(cfg, proj)
    xBC_raw = xBC_raw[..., c0:c1]
    xBC = _whole(_causal_conv_train(xBC_raw, params["conv_w"],
                                    params["conv_b"][..., c0:c1]),
                 tp, "ssm_conv")
    xs = xBC[..., h0 * P:h1 * P].reshape(B, S, Hs, P).float()
    Bmat = xBC[..., Din:Din + N].float()                    # [B,S,N]
    Cmat = xBC[..., Din + N:].float()                       # [B,S,N]
    dt = F.softplus(dt_raw[..., h0:h1].float() +
                    params["dt_bias"][h0:h1])               # [B,S,Hs]
    A = -torch.exp(params["A_log"][h0:h1])                  # [Hs]
    a = dt * A                                              # log-decay

    xs_c = xs.reshape(B, nch, Q, Hs, P)
    B_c = Bmat.reshape(B, nch, Q, N)
    C_c = Cmat.reshape(B, nch, Q, N)
    dt_c = dt.reshape(B, nch, Q, Hs)
    acs = torch.cumsum(a.reshape(B, nch, Q, Hs), dim=2)     # [B,nch,Q,Hs]

    # --- intra-chunk: L[b,c,i,j,h] = exp(acs_i - acs_j) for i >= j ---
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]    # [B,nch,Q,Q,Hs]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    # exp of the masked entries' -inf, not where(causal, exp(diff), 0):
    # the same values, but exp(diff) overflows above the diagonal (diff >
    # 88 within a 256-token chunk) and its gradient is then 0 * inf = NaN
    # (the reference's gradient at mamba2-370m's chunk; ROADMAP queue 3)
    Lmat = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                 -torch.inf))
    CB = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    M = CB[..., None] * Lmat                                # [B,nch,Q,Q,Hs]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M,
                           xs_c * dt_c[..., None])

    # --- chunk states: S_c = sum_j exp(acs_Q - acs_j) B_j (dt_j x_j)^T ---
    decay_to_end = torch.exp(acs[:, :, -1:, :] - acs)       # [B,nch,Q,Hs]
    state_c = torch.einsum("bcjn,bcjh,bcjhp->bchnp",
                           B_c, decay_to_end * dt_c, xs_c)  # [B,nch,Hs,N,P]

    # --- inter-chunk recurrence over the chunk states ---
    chunk_decay = torch.exp(acs[:, :, -1, :])               # [B,nch,Hs]
    h = torch.zeros((B, Hs, N, P), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nch):
        h_prevs.append(h)                                   # state BEFORE c
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                    # [B,nch,Hs,N,P]

    # --- inter-chunk output: y_j += C_j exp(acs_j) h_prev ---
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", C_c, h_prev,
                           torch.exp(acs))

    y = (y_intra + y_inter).reshape(B, S, Hs, P)
    y = y + params["D"][None, None, h0:h1, None] * xs
    out = _out(params, y.reshape(B, S, Hs * P), z[..., h0 * P:h1 * P],
               x.dtype, tp)
    if not return_state:
        return out, None
    K = cfg.conv_kernel - 1
    conv_cache = (xBC_raw[:, S - K:, :] if S >= K else
                  F.pad(xBC_raw, (0, 0, K - S, 0)))
    return out, {"h": h, "conv": conv_cache.to(x.dtype)}


def init_ssm_cache(cfg, batch, dtype, device, lead=()):
    """{"h": [*lead, batch, Hs, N, P] fp32, "conv": [*lead, batch, K-1,
    C]}: under a trunk split the rank's heads and conv channels."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    _, (c0, c1), (h0, h1) = _blocks(cfg)
    return {
        "h": torch.zeros((*lead, batch, h1 - h0, N, P), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, c1 - c0),
                            dtype=dtype, device=device),
    }


def ssm_decode(params, x, cache, cfg):
    """x [B,1,D], one step -> ([B,1,D], cache written in place)."""
    B = x.shape[0]
    Din, N, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim
    tp, (c0, c1), (h0, h1) = _blocks(cfg)
    Hs = h1 - h0                                            # the rank's
    proj = _whole(x[:, 0] @ params["w_in"], tp, "ssm_in")
    z, xBC, dt_raw = _split_proj(cfg, proj)
    hist = torch.cat([cache["conv"],
                      xBC[:, None, c0:c1].to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(),
                            params["conv_w"].float()) + \
        params["conv_b"][c0:c1].float()
    xBC = _whole(F.silu(conv_out), tp, "ssm_conv")

    xs = xBC[:, h0 * P:h1 * P].reshape(B, Hs, P)
    Bv = xBC[:, Din:Din + N]
    Cv = xBC[:, Din + N:]
    dt = F.softplus(dt_raw[:, h0:h1].float() + params["dt_bias"][h0:h1])
    A = -torch.exp(params["A_log"][h0:h1])
    dec = torch.exp(dt * A)                                 # [B,Hs]
    h = cache["h"] * dec[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bv, dt, xs)
    y = torch.einsum("bn,bhnp->bhp", Cv, h)
    y = y + params["D"][None, h0:h1, None] * xs
    out = _out(params, y.reshape(B, Hs * P), z[:, h0 * P:h1 * P], x.dtype,
               tp)[:, None, :]
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
