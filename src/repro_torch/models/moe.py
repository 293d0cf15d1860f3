"""Top-k routed Mixture-of-Experts FFN (port of `repro.models.moe`).

Capacity-based grouped dispatch, as the reference: each batch row is a
routing group. A pair (token, slot) gets its position within its expert
from a stable argsort over the row's expert ids; pairs past the capacity
C are dropped. Tokens are scattered into a [B, E, C, D] buffer, the
expert FFNs run as batched matrix products over E (every expert runs on
every call, whatever its load), and the outputs are gathered back and
combined with the gates.

Parity points with the reference:
- the router runs in fp32 (`x.float() @ router`, the router leaf is
  fp32) while the experts run in the model dtype;
- top-k breaks ties by the lower expert index, as `jax.lax.top_k` does:
  a stable descending sort of the probabilities, cut at k;
- the dispatch is an accumulating `index_put_` in which a dropped pair
  adds an exact zero at (expert 0, slot 0), as the reference's
  `.at[].add` does, so the kept set and its values are exact.

Expert parallelism (a trunk split whose plan splits the experts,
`distributed.api.current_trunk()`: a trunk-sharded engine, or a train
step on a (data, model) mesh): rank r holds experts [r*E/M, (r+1)*E/M)
and their router columns. x reaches the router and the dispatch through
`api.model_copy` (the identity; in a train step its gradient is summed
over the ranks). The rank's router logits are gathered into the whole
[B, S, E] row (`api.model_gather_router`), so top-k, the positions and
the drops are computed on every rank from the same row with the global E
and capacity; the rank dispatches and runs only its experts' pairs, and
`api.model_sum` adds the ranks' combined outputs. The gather gives the
row twice: the routing's copy carries a partial gradient (the gates
weight only the rank's own experts), the aux losses' a whole one (lb and
z run alike on every rank).

Aux outputs: load-balance loss (Switch-style f.P) and router z-loss,
both over every token of the batch. In a data-parallel train step
(`distributed.api.current_data()`, each rank a block of the rows) the
rank's router-probability sums, expert counts, squared log-sum-exps and
token count are all-reduced (one collective a layer) before the
fractions are formed, so lb and z are the global batch's; routing and
capacity stay row-local and need no collective.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.api import (current_data, current_mesh, current_trunk,
                               data_all_reduce, global_share, model_copy,
                               model_gather_router, model_sum)
from .common import dense_init


def init_moe(gen, cfg, dtype, lead=()):
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    return {
        "router": dense_init(gen, (*lead, D, E), dtype=torch.float32),
        "w_gate": dense_init(gen, (*lead, E, D, Fd), dtype=dtype),
        "w_up": dense_init(gen, (*lead, E, D, Fd), dtype=dtype),
        "w_down": dense_init(gen, (*lead, E, Fd, D), dtype=dtype),
    }


def capacity(cfg, num_tokens: int) -> int:
    k, E = cfg.experts_per_token, cfg.num_experts
    c = math.ceil(k * num_tokens / E * cfg.moe_capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(params, x, cfg):
    """x [B,S,D] -> (y [B,S,D], aux dict)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    dev = x.device

    tp = current_trunk()
    split = tp is not None and tp.experts_split
    if split:
        x = model_copy(x, current_mesh(), "experts-grad")
    logits = x.float() @ params["router"]                     # [B,S,E]
    aux_logits = None
    if split:           # the routing's row and the aux losses' row
        logits, aux_logits = model_gather_router(logits, current_mesh())
    probs = torch.softmax(logits, dim=-1)
    srt, order_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt[..., :k], order_e[..., :k]               # [B,S,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # ---- slot positions within (row, expert): stable argsort ----
    e_flat = idx.reshape(B, S * k)                            # [B,S*k]
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=-1) - counts            # exclusive
    pos_sorted = torch.arange(S * k, device=dev)[None, :] - \
        torch.gather(starts, 1, sorted_e)
    pos = torch.zeros((B, S * k), dtype=torch.int64, device=dev)
    pos.scatter_(1, order, pos_sorted)
    keep = pos < C

    # ---- dispatch: accumulate into [B, E_r, C, D] (row-local) over the
    # experts [e0, e0 + E_r) this rank holds (all of them unsplit) ----
    E_r = params["w_gate"].shape[0]
    e0 = tp.rank * E_r if split else 0
    mine = keep & (e_flat >= e0) & (e_flat < e0 + E_r) if split else keep
    tok_of_pair = torch.arange(S * k, device=dev) // k
    src = x[:, tok_of_pair]                                   # [B,S*k,D]
    contrib = torch.where(mine[..., None], src, torch.zeros_like(src))
    e_safe = torch.where(mine, e_flat - e0, 0)
    p_safe = torch.where(mine, pos, 0)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S * k)
    buf = torch.zeros((B, E_r, C, D), dtype=x.dtype, device=dev)
    buf.index_put_((bidx, e_safe, p_safe), contrib, accumulate=True)

    # ---- expert FFNs (batched over B, E) ----
    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"])) * \
        torch.einsum("becd,edf->becf", buf, params["w_up"])
    y_buf = torch.einsum("becf,efd->becd", h, params["w_down"])

    # ---- combine: gather back, weight by gates, sum the k slots ----
    out_pairs = y_buf[bidx, e_safe, p_safe]
    out_pairs = torch.where(mine[..., None], out_pairs,
                            torch.zeros_like(out_pairs))
    out_pairs = out_pairs * gates.reshape(B, S * k)[..., None].to(x.dtype)
    y = out_pairs.reshape(B, S, k, D).sum(dim=2)
    if split:           # the other ranks' experts' share
        y = model_sum(y, current_mesh(), "experts-sum")

    # ---- aux losses (Switch f.P, router z-loss) ----
    if aux_logits is not None:
        logits, probs = aux_logits, torch.softmax(aux_logits, dim=-1)
    data = current_data()
    if data is not None:
        lb_loss, z_loss = global_aux(probs, counts, logits, k, data)
        return y, {"lb_loss": lb_loss, "z_loss": z_loss}
    me = probs.mean(dim=(0, 1))                               # [E]
    ce = counts.sum(0).float() / (B * S * k)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}


def global_aux(probs, counts, logits, k: int, mesh):
    """(lb_loss, z_loss) over the GLOBAL batch from this rank's rows: the
    probability sums, expert counts, squared log-sum-exps and token count
    all-reduced in one collective; each loss is the global value, and its
    gradient this rank's rows' share of it."""
    E = probs.shape[-1]
    me_sum = probs.sum(dim=(0, 1))
    z_sum = (torch.logsumexp(logits, dim=-1) ** 2).sum()
    n = probs.new_tensor([probs.shape[0] * probs.shape[1]])
    g = data_all_reduce(torch.cat([me_sum.detach(), counts.sum(0).float(),
                                   z_sum.detach()[None], n]), mesh,
                        call="moe")
    tokens = g[-1]
    me = global_share(me_sum, g[:E]) / tokens
    ce = g[E:2 * E] / (tokens * k)
    return E * torch.sum(me * ce), global_share(z_sum, g[2 * E]) / tokens
