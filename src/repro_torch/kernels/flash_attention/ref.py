"""Plain PyTorch version of the flash_attention kernel: the port of the
reference model's own attention, `repro.models.common.chunked_attention`
(online softmax over KV chunks, additionally blocked over queries).

Rounding points follow the reference: q is scaled in its own dtype (the
scale rounded to that dtype, as JAX rounds a weak-typed Python scalar),
scores and the P.V product accumulate in fp32 from operands in their own
dtype, probabilities are rounded to the value dtype before P.V.

`chunked_attention(..., return_lse=True)` also gives each row's fp32
log-sum-exp [B,H,Sq] of its scaled, masked scores, and `attention_bwd`
is the plain version of the backward kernel (`csrc/flash_attention_bwd.cu`):
the gradients that `jax.vjp` of the reference's `chunked_attention`
gives, in the FlashAttention-2 form, from the forward's output and LSE.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _acc(t):
    """`t` in its accumulation dtype: fp32, or fp64 for an fp64 input
    (which only `gradcheck` gives)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _gqa_scores(q, k):
    """q [B,Sq,H,Dh], k [B,Sk,K,Dh] with H = K*G -> scores [B,H,Sq,Sk]
    (fp32 accumulation)."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", _acc(qg), _acc(k))
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_out(p, v):
    """p [B,H,Sq,Sk], v [B,Sk,K,Dh] -> [B,Sq,H,Dh] (fp32 accumulation)."""
    B, H, Sq, Sk = p.shape
    K = v.shape[2]
    pg = p.reshape(B, K, H // K, Sq, Sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", _acc(pg), _acc(v))
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
                      kv_valid_len=None, q_chunk: int = 0,
                      return_lse: bool = False):
    """q [B,Sq,H,Dh]; k,v [B,Sk,K,Dh] (GQA). `q_offset`: absolute
    position of q[0]. `window` > 0 = sliding window. `kv_valid_len`
    (scalar or [B]) masks out cache positions >= valid. With
    `return_lse` -> (out, lse [B,H,Sq] fp32)."""
    Sq = q.shape[1]
    q_chunk = q_chunk or chunk
    if Sq > q_chunk and Sq % q_chunk == 0:
        parts = [_kv_chunked_attention(
            q[:, i * q_chunk:(i + 1) * q_chunk], k, v, causal=causal,
            q_offset=q_offset + i * q_chunk, window=window, chunk=chunk,
            kv_valid_len=kv_valid_len) for i in range(Sq // q_chunk)]
        out = torch.cat([o for o, _ in parts], dim=1)
        if return_lse:
            return out, torch.cat([lse for _, lse in parts], dim=2)
        return out
    out, lse = _kv_chunked_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, window=window,
                                     chunk=chunk, kv_valid_len=kv_valid_len)
    return (out, lse) if return_lse else out


def qscale_tensor(dtype, Dh: int) -> torch.Tensor:
    """1/sqrt(Dh) as a 0-dim tensor of `dtype`: q is scaled in its own
    dtype."""
    return torch.tensor(1.0 / math.sqrt(Dh), dtype=dtype)


def _kv_chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                          window: int = 0, chunk: int = 1024,
                          kv_valid_len=None):
    """-> (out [B,Sq,H,Dh], lse [B,H,Sq] fp32)."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    qf = q * qscale_tensor(q.dtype, Dh)

    if Sk <= chunk:
        s = _gqa_scores(qf, k)
        s = _mask_scores(s, Sq, Sk, 0, q_offset, causal, window, kv_valid_len)
        p = torch.softmax(s, dim=-1)
        return (_gqa_out(p.to(q.dtype), v).to(q.dtype),
                torch.logsumexp(s, dim=-1))

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
    f32 = torch.promote_types(q.dtype, torch.float32)
    acc = torch.zeros((B, H, Sq, Dh), dtype=f32, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, dtype=f32, device=q.device)
    denom = torch.zeros((B, H, Sq), dtype=f32, device=q.device)
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
        og = torch.einsum("bkgqs,bskd->bkgqd", _acc(pg), _acc(vb))
        acc = acc * alpha[..., None] + og.reshape(B, H, Sq, Dh)
        m = m_new
    denom = torch.clamp(denom, min=1e-30)
    out = acc / denom[..., None]
    return (out.transpose(1, 2).to(q.dtype),            # [B,Sq,H,Dh]
            m + torch.log(denom))


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                  window: int = 0, q_offset=None, q_chunk: int = 1024):
    """Gradients (dq, dk, dv) of `chunked_attention(q, k, v)` (queries
    right-aligned to keys unless `q_offset` is given) for the output
    gradient `do`, from the forward's output `o` and its `lse`. The
    backward kernel's arithmetic, query block by query block:
      P = exp(s - lse) (0 where masked), from the scaled q q^ = q*scale;
      dV = round(P)^T dO, P rounded to v's dtype as the forward rounds it
           before P.V;
      D = sum_d dO*O per row; dS = P * (dO V^T - D);
      dK = dS^T q^;  d(q^) = dS K, rounded to q's dtype, then times the
           scale in q's dtype (q was scaled in its own dtype).
    Sums in fp32 (fp64 for fp64 inputs); outputs in the inputs' dtypes."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    q_offset = Sk - Sq if q_offset is None else q_offset
    scale = qscale_tensor(q.dtype, Dh)
    qh = q * scale
    kf, vf = _acc(k), _acc(v)
    dk = torch.zeros((B, Sk, K, Dh), dtype=kf.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    dqh = []
    for i0 in range(0, Sq, q_chunk):
        qc = qh[:, i0:i0 + q_chunk]
        n = qc.shape[1]
        doc = _acc(do[:, i0:i0 + n])
        s = _mask_scores(_gqa_scores(qc, k), n, Sk, 0, q_offset + i0,
                         causal, window, None)             # [B,H,n,Sk]
        p = torch.exp(s - lse[:, :, i0:i0 + n, None])
        pg = _acc(p.to(v.dtype)).reshape(B, K, G, n, Sk)
        dog = doc.reshape(B, n, K, G, Dh)
        dv += torch.einsum("bkgqs,bqkgd->bskd", pg, dog)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf).reshape(B, H, n, Sk)
        dvec = (doc * _acc(o[:, i0:i0 + n])).sum(-1).transpose(1, 2)
        ds = (p * (dp - dvec[..., None])).reshape(B, K, G, n, Sk)
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds,
                           _acc(qc).reshape(B, n, K, G, Dh))
        dqh.append(torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
                   .reshape(B, n, H, Dh))
    dq = torch.cat(dqh, dim=1).to(q.dtype) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)
