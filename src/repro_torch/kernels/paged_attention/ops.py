"""Public op: attention through a page table.

`paged_attention` ([B, S] query spans, every paged feed of the engine)
and `paged_attention_decode` (its S = 1 form) read each slot's KV from
the shared page pools through the slot's page table.

A CPU tensor takes the plain version (`ref.py`, a bitwise twin of the
dense decode attention there); a CUDA tensor launches the Hopper kernel
(`csrc/paged_attention.cu`) or raises. There is no other routing and no
fallback. `paged_attention.launches` counts kernel launches (never
plain-version calls); the decode form launches through it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])
_SMEM_MAX = 200 * 1024      # of the 227 KB a Hopper block may use
_MAX_ROW_ELEMS = 4096       # rows x Dh accumulators per block (16/thread)


def _rows_per_block(rows, L, ps, Dh):
    """Query rows per block: as many as the score buffer (rows x L fp32)
    and the per-thread accumulators allow, at most 32."""
    fixed = (ps * (Dh + 1) + 8) * 4
    fit = (_SMEM_MAX - fixed) // ((Dh + L + 1) * 4)
    R = min(32, rows, fit, _MAX_ROW_ELEMS // Dh)
    if R < 1:
        raise ValueError(f"paged_attention: L={L} positions do not fit one "
                         f"block's shared memory")
    return R


def paged_attention(q, k_pool, v_pool, page_table, pos):
    """q [B,S,H,Dh] (roped, unscaled); k_pool/v_pool [P,ps,K,Dh];
    page_table [B,nP] int32 (-1 = unmapped); pos [B] int32 absolute
    start positions -> [B,S,H,Dh] in q's dtype."""
    dev = q.device
    if dev.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, pos)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention: dtypes {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype} (need one of "
                         f"f32/bf16)")
    B, S, H, Dh = q.shape
    P, ps, K, _ = k_pool.shape
    nP = page_table.shape[1]
    if tuple(k_pool.shape) != (P, ps, K, Dh) or \
            tuple(v_pool.shape) != (P, ps, K, Dh) or H % K or Dh > 256 or \
            tuple(page_table.shape) != (B, nP) or \
            page_table.dtype != torch.int32 or B > 65535:
        raise ValueError(f"paged_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
                         f"page table {tuple(page_table.shape)} "
                         f"{page_table.dtype}")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    q, k_pool, v_pool, page_table, pos = (
        t.contiguous() for t in (q, k_pool, v_pool, page_table, pos))
    L = nP * ps
    rows = S * (H // K)
    R = _rows_per_block(rows, L, ps, Dh)
    smem = (R * Dh + ps * (Dh + 1) + R * L + 8) * 4
    lib = _build.load()
    fn = lib.paged_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    qscale = float(torch.tensor(1.0 / math.sqrt(Dh), dtype=q.dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(page_table), ptr(pos),
            ptr(out), _DTYPES[q.dtype], B, S, H, K, Dh, ps, nP, R, smem,
            qscale, ctypes.c_void_p(stream))
    _build.check(lib, rc, "paged_attention launch")
    paged_attention.launches += 1
    return out


def paged_attention_decode(q, k_pool, v_pool, page_table, pos):
    """Decode ([B, 1]) form: q [B,H,Dh] -> [B,H,Dh]."""
    return paged_attention(q[:, None], k_pool, v_pool, page_table,
                           pos)[:, 0]


paged_attention.launches = 0
