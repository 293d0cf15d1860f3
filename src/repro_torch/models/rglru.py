"""RG-LRU recurrent block (RecurrentGemma / Griffin; port of
`repro.models.rglru`) [arXiv:2402.19427].

Gated linear recurrence h_t = a_t.h_{t-1} + sqrt(1 - a_t^2).(i_t * x_t)
with a_t = exp(-c.softplus(lambda).r_t), inside Griffin's block: a GeLU
branch (the tanh approximation, `jax.nn.gelu`'s default) times conv1d ->
RG-LRU, then an output projection.

Prefill (and training, `rglru_train`: the same forward without the
cache) scans the sequence in log depth (Hillis-Steele): ceil(log2 S)
rounds, each combining every position with the one `offset` before it
by (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), the operator of the
reference's `lax.associative_scan`. That is a handful of elementwise
launches per round over [B, S, R] fp32, instead of S rounds of a
sequential loop; the sums associate in another order than the
reference's tree, which the parity tests bound. At recurrentgemma-9b's
13-token end-to-end prompt (R 4096, fp32, 4 rounds) it takes 0.0264 ms
of device time against 0.0308 ms for a sequential loop over the
positions, on an NVIDIA H100 80GB HBM3 at 700.00 W (`chip_smoke.py`
phase 8; PERF.md §5).
Decode is the O(1) update; it writes `h` and `conv` into the cache dict
it is given IN PLACE and returns the same dict.

Under a trunk-sharded engine (`distributed.api.current_trunk()`) a rank
holds the block `rec_width` of R of every leaf the reference's rules
split on it: w_gelu's, w_rec's, conv_w's, w_a's and w_i's columns, w_out's
rows, the state's and the conv cache's channels (b_a, b_i and lam stay
whole). u, v and the conv run on the rank's width; the gates contract
over the whole of R, so one all-gather joins the ranks' conv outputs;
the scan and the state run on the rank's width, and one all-reduce sums
the w_out partials: two collectives a layer (the `rec` layer's FFN adds
its own all-reduce, `common.ffn`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.api import (all_gather_last, current_mesh, current_trunk,
                               trunk_all_reduce)
from .common import dense_init

_C = 8.0


def init_rglru(gen, cfg, dtype, lead=()):
    D, R, Kc = cfg.d_model, cfg.lru_dim, cfg.conv_kernel
    dev = gen.device
    f32 = torch.float32
    return {
        "w_gelu": dense_init(gen, (*lead, D, R), dtype=dtype),
        "w_rec": dense_init(gen, (*lead, D, R), dtype=dtype),
        "conv_w": dense_init(gen, (*lead, Kc, R), scale=0.5, dtype=dtype),
        "conv_b": torch.zeros((*lead, R), dtype=dtype, device=dev),
        "w_a": dense_init(gen, (*lead, R, R), dtype=dtype),
        "b_a": torch.zeros((*lead, R), dtype=f32, device=dev),
        "w_i": dense_init(gen, (*lead, R, R), dtype=dtype),
        "b_i": torch.zeros((*lead, R), dtype=f32, device=dev),
        "lam": torch.full((*lead, R), 0.7, dtype=f32, device=dev),
        "w_out": dense_init(gen, (*lead, R, D), dtype=dtype),
    }


def _causal_conv(x, w, b):
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + S, :] * w[i] for i in range(K))
    return out + b


def _width(cfg):
    """(plan, this rank's block [r0, r1) of R) under a trunk split of R;
    (None, the whole R) otherwise."""
    tp = current_trunk()
    if tp is None or tp.rec_width is None:
        return None, (0, cfg.lru_dim)
    return tp, tp.rec_width


def _gates(params, x, tp, cols):
    """x [.., R] -> (a, b) in fp32 at the channels `cols` of R (all of
    them unsplit). Under a trunk split of R (`tp`) x holds the rank's
    channels: they are joined into the whole row for the w_a and w_i
    contractions (one all-gather)."""
    xf = x.float()
    xw = xf
    if tp is not None:
        xw = all_gather_last(x, (cols[1] - cols[0],) * tp.size,
                             current_mesh()).float()
    c = slice(*cols)
    r = torch.sigmoid(xw @ params["w_a"].float() + params["b_a"][..., c])
    i = torch.sigmoid(xw @ params["w_i"].float() + params["b_i"][..., c])
    log_a = -_C * F.softplus(params["lam"][..., c]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * \
        (i * xf)
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1, in ceil(log2 S)
    rounds -> h (all positions)."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_train(params, x, cfg):
    """x [B,S,D] -> [B,S,D] (no cache)."""
    return _rglru_forward(params, x, cfg, return_state=False)[0]


def rglru_prefill(params, x, cfg):
    """x [B,S,D] -> (y [B,S,D], cache {"h", "conv"})."""
    return _rglru_forward(params, x, cfg, return_state=True)


def _out(y, params, tp):
    """y @ w_out, its partials all-reduced under a trunk split of R."""
    y = y @ params["w_out"]
    return y if tp is None else trunk_all_reduce(y, current_mesh())


def _rglru_forward(params, x, cfg, return_state: bool):
    tp, (r0, r1) = _width(cfg)
    u = F.gelu(x @ params["w_gelu"], approximate="tanh")
    v_raw = x @ params["w_rec"]
    v = _causal_conv(v_raw, params["conv_w"], params["conv_b"][..., r0:r1])
    a, b = _gates(params, v, tp, (r0, r1))
    h = linear_scan(a, b)                            # [B,S,R] fp32
    y = _out((u.float() * h).to(x.dtype), params, tp)
    if not return_state:
        return y, None
    K = cfg.conv_kernel - 1
    S = x.shape[1]
    conv_cache = (v_raw[:, S - K:, :] if S >= K else
                  F.pad(v_raw, (0, 0, K - S, 0)))
    return y, {"h": h[:, -1, :], "conv": conv_cache.to(x.dtype)}


def init_rglru_cache(cfg, batch, dtype, device, lead=()):
    """{"h": [*lead, batch, R] fp32, "conv": [*lead, batch, K-1, R]}: R the
    rank's width under a trunk split."""
    _, (r0, r1) = _width(cfg)
    R = r1 - r0
    return {
        "h": torch.zeros((*lead, batch, R), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, R),
                            dtype=dtype, device=device),
    }


def rglru_decode(params, x, cache, cfg):
    """x [B,1,D] -> ([B,1,D], cache written in place)."""
    tp, (r0, r1) = _width(cfg)
    u = F.gelu(x[:, 0] @ params["w_gelu"], approximate="tanh")
    v_raw = x[:, 0] @ params["w_rec"]
    hist = torch.cat([cache["conv"],
                      v_raw[:, None, :].to(cache["conv"].dtype)], dim=1)
    v = torch.einsum("bkc,kc->bc", hist.float(),
                     params["conv_w"].float()) + \
        params["conv_b"][r0:r1].float()
    a, b = _gates(params, v, tp, (r0, r1))
    h = a * cache["h"] + b
    y = _out((u.float() * h).to(x.dtype), params, tp)[:, None, :]
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return y, cache
