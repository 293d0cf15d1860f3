"""Public op: blocked attention with queries right-aligned to keys.

A CPU tensor takes the plain version (`ref.chunked_attention`); a CUDA
tensor launches the Hopper kernel (`csrc/flash_attention.cu`) or raises.
`attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import chunked_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              chunk: int = 1024):
    """q [B,Sq,H,Dh]; k,v [B,Sk,K,Dh] (H a multiple of K, Sq <= Sk) ->
    [B,Sq,H,Dh] in q's dtype. q positions are right-aligned to k
    positions (q_offset = Sk - Sq). `chunk` is the plain version's KV
    chunk (the model config's attn_chunk); the kernel tiles on its own."""
    dev = q.device
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if dev.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, q_offset=Sk - Sq,
                                 window=window, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} (need one of f32/bf16)")
    if tuple(k.shape) != (B, Sk, K, Dh) or tuple(v.shape) != tuple(k.shape) \
            or H % K or Sq > Sk or Dh not in (32, 64, 128):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = _build.load()
    fn = lib.flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    qscale = float(torch.tensor(1.0 / math.sqrt(Dh), dtype=q.dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            _DTYPES[q.dtype], B, Sq, Sk, H, K, Dh, qscale, int(causal),
            int(window), ctypes.c_void_p(stream))
    _build.check(lib, rc, "flash_attention launch")
    attention.launches += 1
    return out


attention.launches = 0
