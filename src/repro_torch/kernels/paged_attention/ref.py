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
