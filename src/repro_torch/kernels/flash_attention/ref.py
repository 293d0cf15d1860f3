"""Plain PyTorch version of the flash_attention kernel: the port of the
reference model's own attention, `repro.models.common.chunked_attention`
(online softmax over KV chunks, additionally blocked over queries).

Rounding points follow the reference: q is scaled in its own dtype (the
scale rounded to that dtype, as JAX rounds a weak-typed Python scalar),
scores and the P.V product accumulate in fp32 from operands in their own
dtype, probabilities are rounded to the value dtype before P.V.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q [B,Sq,H,Dh], k [B,Sk,K,Dh] with H = K*G -> scores [B,H,Sq,Sk]
    (fp32 accumulation)."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_out(p, v):
    """p [B,H,Sq,Sk], v [B,Sk,K,Dh] -> [B,Sq,H,Dh] (fp32 accumulation)."""
    B, H, Sq, Sk = p.shape
    K = v.shape[2]
    pg = p.reshape(B, K, H // K, Sq, Sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg.float(), v.float())
    return o.reshape(B, Sq, H, v.shape[-1])


def _mask_scores(s, Sq, Sk_chunk, kv_start, q_offset, causal, window,
                 kv_valid_len):
    """s [B,H,Sq,Sk_chunk]; positions: q_pos = q_offset + iq,
    kv_pos = kv_start + ik."""
    dev = s.device
    iq = torch.arange(Sq, device=dev)[:, None] + q_offset
    ik = torch.arange(Sk_chunk, device=dev)[None, :] + kv_start
    mask = torch.ones((Sq, Sk_chunk), dtype=torch.bool, device=dev)
    if causal:
        mask &= ik <= iq
    if window:
        mask &= ik > iq - window
    m = mask[None, None]
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, device=dev)
        if vl.dim() == 0:
            m = m & (ik < vl)[None, None]
        else:
            m = m & (ik[None] < vl[:, None, None])[:, None]
    return torch.where(m, s, NEG_INF)


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      window: int = 0, chunk: int = 1024,
                      kv_valid_len=None, q_chunk: int = 0):
    """q [B,Sq,H,Dh]; k,v [B,Sk,K,Dh] (GQA). `q_offset`: absolute
    position of q[0]. `window` > 0 = sliding window. `kv_valid_len`
    (scalar or [B]) masks out cache positions >= valid."""
    Sq = q.shape[1]
    q_chunk = q_chunk or chunk
    if Sq > q_chunk and Sq % q_chunk == 0:
        return torch.cat([
            _kv_chunked_attention(
                q[:, i * q_chunk:(i + 1) * q_chunk], k, v, causal=causal,
                q_offset=q_offset + i * q_chunk, window=window, chunk=chunk,
                kv_valid_len=kv_valid_len)
            for i in range(Sq // q_chunk)], dim=1)
    return _kv_chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 window=window, chunk=chunk,
                                 kv_valid_len=kv_valid_len)


def _kv_chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                          window: int = 0, chunk: int = 1024,
                          kv_valid_len=None):
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    qf = q * torch.tensor(1.0 / math.sqrt(Dh), dtype=q.dtype)

    if Sk <= chunk:
        s = _gqa_scores(qf, k)
        s = _mask_scores(s, Sq, Sk, 0, q_offset, causal, window, kv_valid_len)
        p = torch.softmax(s, dim=-1)
        return _gqa_out(p.to(q.dtype), v).to(q.dtype)

    nchunks = (Sk + chunk - 1) // chunk
    pad = nchunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        base_valid = kv_valid_len if kv_valid_len is not None else Sk
    else:
        base_valid = kv_valid_len
    K = v.shape[2]
    G = H // K
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for idx in range(nchunks):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        s = _gqa_scores(qf, kb)                          # [B,H,Sq,chunk]
        s = _mask_scores(s, Sq, chunk, idx * chunk, q_offset, causal,
                         window, base_valid)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        pg = p.to(vb.dtype).reshape(B, K, G, Sq, chunk)
        og = torch.einsum("bkgqs,bskd->bkgqd", pg.float(), vb.float())
        acc = acc * alpha[..., None] + og.reshape(B, H, Sq, Dh)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)              # [B,Sq,H,Dh]
