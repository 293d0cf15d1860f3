"""Public op: blocked attention with queries right-aligned to keys.

A CPU tensor takes the plain version (`ref.chunked_attention`); a CUDA
tensor launches the Hopper kernel (`csrc/flash_attention.cu`) or raises.
`attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from .ref import chunked_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_QSCALE: dict = {}          # (dtype, Dh) -> 1/sqrt(Dh) rounded to dtype
_LAUNCH: dict = {}          # "fn" -> the C entry point, typed once
_SMEM_CHECKED: set = set()  # (dtype code, Dh) whose plan the library confirmed


# bf16 keys per K/V tile and cp.async stages, by head_dim (Tiles<D> in
# the kernel); the kernel is instantiated for these head_dims only
BF16_TILES = {32: (128, 3), 64: (128, 2), 128: (128, 2), 256: (64, 2)}


class Plan(NamedTuple):
    """One launch: grid, threads and dynamic shared memory per block."""
    grid: tuple
    threads: int
    smem: int


def launch_plan(dtype, B: int, Sq: int, H: int, Dh: int) -> Plan:
    """The kernel's launch for q [B,Sq,H,Dh] of `dtype`. bf16: grid (H,
    q tiles of 64 rows, B), 4 warps, the q tile and a ring of `stages`
    K and V tiles of `keys` keys in bf16 (BF16_TILES). fp32: grid (q
    tiles of 64 rows, H, B), 128 threads, a q tile, a K and a V tile of
    32 keys and a 64 x 32 P tile in fp32 (rows padded by one word).
    `flash_attention_smem_bytes` in the library must agree."""
    nqt = -(-Sq // 64)
    if dtype == torch.bfloat16:
        keys, stages = BF16_TILES[Dh]
        return Plan((H, nqt, B), 128, 2 * (64 + 2 * stages * keys) * Dh)
    return Plan((nqt, H, B), 128,
                4 * (64 * (Dh + 1) + 32 * (Dh + 1) + 32 * Dh + 64 * 33))


def qscale(dtype, Dh: int) -> float:
    """1/sqrt(Dh) rounded to `dtype`, as the plain version scales q."""
    key = (dtype, Dh)
    s = _QSCALE.get(key)
    if s is None:
        s = _QSCALE[key] = float(torch.tensor(1.0 / math.sqrt(Dh),
                                              dtype=dtype))
    return s


def _launcher():
    fn = _LAUNCH.get("fn")
    if fn is None:
        lib = _build.load()
        fn = lib.flash_attention_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        _LAUNCH["lib"] = lib
        _LAUNCH["fn"] = fn
    return _LAUNCH["lib"], fn


def aligned(t):
    """`t` contiguous and 16-byte aligned (the attention kernels copy 16
    bytes at a time): a view that is not is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
            or H % K or Sq > Sk or Dh not in BF16_TILES:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    q, k, v = aligned(q), aligned(k), aligned(v)
    lib, fn = _launcher()
    code = _DTYPES[q.dtype]
    if (code, Dh) not in _SMEM_CHECKED:
        want = launch_plan(q.dtype, B, Sq, H, Dh).smem
        got = lib.flash_attention_smem_bytes(code, Dh)
        if got != want:
            raise RuntimeError(f"flash_attention: launch plan asks for "
                               f"{want} bytes of shared memory, the kernel "
                               f"for {q.dtype}, Dh={Dh} uses {got}")
        _SMEM_CHECKED.add((code, Dh))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
            B, Sq, Sk, H, K, Dh, qscale(q.dtype, Dh), int(causal),
            int(window), stream)
    _build.check(lib, rc, "flash_attention launch")
    attention.launches += 1
    return out


attention.launches = 0
