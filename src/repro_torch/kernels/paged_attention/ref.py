"""Plain PyTorch version of page-table attention (the reference's
`kernels/paged_attention/ref.py::paged_attention_ref`): gather, then
attend.

The slot's dense view is rebuilt from its page table
(`pool[page_table[b]]` -> [B, L, K, Dh], L = nP * ps) and attended by
`attend`, the very function the dense decode path
(`models/layers.py::_self_attention_decode`) calls, so on the same KV the
two are bitwise twins on the CPU and paged serving gives the dense
engine's tokens.

Position convention: the token stored at (page_table[b, j], o) sits at
absolute position j * ps + o of slot b's sequence. Entry l is attendable
iff its page is mapped (page_table >= 0) and l <= q_pos; positions past
the frontier hold stale or unwritten data and are masked, which is also
what rolls back rejected speculative writes.

The partial forms serve a cache split on its sequence dim over M ranks
(a trunk-sharded engine whose kv heads M does not divide): each rank
attends over the positions it holds only and returns its fp32 output
unrounded with each row's log-sum-exp, and `combine_partials` joins the
ranks' partials. A row with no valid position on a rank gets o = 0 and
lse = NEG_INF there, so the combine gives that rank no weight (the plain
softmax would spread it uniformly over masked garbage). A pool split on
the in-page offset holds [P, ps/M, K, Dh] a rank: local offset o of page
j is absolute position j * ps + base + o, base = rank * ps/M.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attend(q, kc, vc, valid):
    """Exact-softmax GQA attention of span queries over a gathered cache:
    q [B,S,H,Dh] (roped, unscaled), kc/vc [B,L,K,Dh], valid [B,S,L] bool
    -> [B,S,H,Dh] in q's dtype. q is scaled in its own dtype, scores and
    softmax are fp32, and P is rounded to the value dtype before P.V."""
    B, S, H, Dh = q.shape
    K = kc.shape[2]
    qg = (q * torch.tensor(1.0 / Dh ** 0.5, dtype=q.dtype)).reshape(
        B, S, K, H // K, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float())
    s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr.to(vc.dtype).float(),
                     vc.float())
    return o.reshape(B, S, H, Dh).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, page_table, pos):
    """q [B,S,H,Dh] (roped, unscaled); k_pool/v_pool [P,ps,K,Dh];
    page_table [B,nP] int32 (-1 = unmapped); pos [B] int32 absolute start
    positions (span query i of slot b sits at pos[b] + i)
    -> [B,S,H,Dh] in q's dtype. Full causal attention, no window."""
    P, ps, K, Dh = k_pool.shape
    B, S = q.shape[:2]
    nP = page_table.shape[1]
    L = nP * ps
    dev = q.device
    safe = page_table.clamp(min=0).long()                     # [B, nP]
    kc = k_pool[safe].reshape(B, L, K, Dh)
    vc = v_pool[safe].reshape(B, L, K, Dh)
    qpos = pos.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=dev)[None, :]            # [B, S]
    idx = torch.arange(L, dtype=torch.int32, device=dev)
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)  # [B, L]
    valid = mapped[:, None, :] & (idx[None, None, :] <= qpos[:, :, None])
    return attend(q, kc, vc, valid)


def attend_partial(q, kc, vc, valid):
    """`attend` over one rank's share of the cache: q [B,S,H,Dh], kc/vc
    [B,Lr,K,Dh], valid [B,S,Lr] -> (o [B,S,H,Dh] fp32, not rounded to
    q's dtype; lse [B,S,H] fp32, the log-sum-exp of the scaled scores).
    P is rounded to the value dtype before P.V, as in `attend`. Rows
    with no valid position: o 0, lse NEG_INF."""
    B, S, H, Dh = q.shape
    K = kc.shape[2]
    qg = (q * torch.tensor(1.0 / Dh ** 0.5, dtype=q.dtype)).reshape(
        B, S, K, H // K, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float())
    s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr.to(vc.dtype).float(),
                     vc.float()).reshape(B, S, H, Dh)
    lse = torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2).reshape(B, S, H)
    live = valid.any(-1)[:, :, None]                          # [B,S,1]
    return (torch.where(live[..., None], o, 0.0),
            torch.where(live, lse, NEG_INF))


def combine_partials(o, lse, dtype):
    """Join M ranks' partials: o [M,...,Dh] fp32, lse [M,...] fp32 ->
    sum_r w_r o_r in `dtype`, w_r = exp(lse_r - max) / sum exp(lse -
    max) (a rank's NEG_INF row weighs 0). Added in rank order, so every
    rank that holds the same partials gets the same bits."""
    w = torch.exp(lse - lse.amax(0))
    return ((w[..., None] * o).sum(0) / w.sum(0)[..., None]).to(dtype)


def paged_attention_partial_ref(q, k_pool, v_pool, page_table, pos, ps,
                                base):
    """`paged_attention_ref` over one rank's offsets of every page:
    k_pool/v_pool [P, psl, K, Dh] hold offsets [base, base + psl) of
    pages of `ps` positions -> (o fp32, lse fp32) as `attend_partial`."""
    P, psl, K, Dh = k_pool.shape
    B, S = q.shape[:2]
    nP = page_table.shape[1]
    dev = q.device
    safe = page_table.clamp(min=0).long()
    kc = k_pool[safe].reshape(B, nP * psl, K, Dh)
    vc = v_pool[safe].reshape(B, nP * psl, K, Dh)
    qpos = pos.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=dev)[None, :]
    loc = torch.arange(nP * psl, dtype=torch.int32, device=dev)
    idx = loc // psl * ps + base + loc % psl               # absolute
    mapped = (page_table >= 0).repeat_interleave(psl, dim=1)
    valid = mapped[:, None, :] & (idx[None, None, :] <= qpos[:, :, None])
    return attend_partial(q, kc, vc, valid)


def dh_scores(q, kc, d0: int):
    """q [B,S,H,Dh] (roped, unscaled, every channel), kc [B,L,K,dw] one
    rank's channels [d0, d0 + dw) of the cache -> [B,S,H,L] fp32: the
    scaled q's channels [d0, d0 + dw) dotted with kc, q scaled in its own
    dtype as in `attend`."""
    B, S, H, Dh = q.shape
    L, K, dw = kc.shape[1:]
    qs = (q * torch.tensor(1.0 / Dh ** 0.5, dtype=q.dtype))[..., d0:d0 + dw]
    s = torch.einsum("bqkgd,blkd->bqkgl",
                     qs.reshape(B, S, K, H // K, dw).float(), kc.float())
    return s.reshape(B, S, H, L)


def dh_probs(s, valid, dtype):
    """Joined fp32 scores [B,S,H,L] and valid [B,S,L] -> P [B,S,H,L] in
    `dtype`: masked to NEG_INF, softmax in fp32, rounded as `attend`
    rounds P before P.V."""
    s = torch.where(valid[:, :, None, :], s, NEG_INF)
    return torch.softmax(s, dim=-1).to(dtype)


def dh_values(p, vc):
    """P [B,S,H,L] (the value dtype) and vc [B,L,K,dw] one rank's
    channels of the cache -> [B,S,H,dw] fp32: P.V over those channels."""
    B, S, H, L = p.shape
    K, dw = vc.shape[2:]
    o = torch.einsum("bqkgl,blkd->bqkgd",
                     p.reshape(B, S, K, H // K, L).float(), vc.float())
    return o.reshape(B, S, H, dw)


def _gathered(pool, page_table):
    """The slots' pages of `pool` [P, ps, K, dw] in table order -> [B,
    nP * ps, K, dw] (an unmapped page reads page 0)."""
    B, nP = page_table.shape
    ps, K, dw = pool.shape[1:]
    return pool[page_table.clamp(min=0).long()].reshape(B, nP * ps, K, dw)


def paged_scores_ref(q, k_pool, page_table, d0: int):
    """`dh_scores` through a page table: k_pool [P, ps, K, dw] holds
    channels [d0, d0 + dw) of every page; page_table [B, nP] int32 ->
    [B,S,H,nP*ps] fp32, position l = j * ps + o at (page_table[b, j], o)."""
    return dh_scores(q, _gathered(k_pool, page_table), d0)


def paged_values_ref(p, v_pool, page_table):
    """`dh_values` through a page table: P [B,S,H,nP*ps] (the value
    dtype), v_pool [P, ps, K, dw] -> [B,S,H,dw] fp32."""
    return dh_values(p, _gathered(v_pool, page_table))
