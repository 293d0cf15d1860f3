"""Public op: blocked attention with queries right-aligned to keys, and
its gradient.

A CPU tensor takes the plain versions (`ref.chunked_attention`,
`ref.attention_bwd`); a CUDA tensor launches the Hopper kernels
(`csrc/flash_attention.cu` forward, `csrc/flash_attention_bwd.cu`
backward) or raises. `attention` is differentiable: when grad is enabled
and an input needs it, it runs as a `torch.autograd.Function` whose
forward also keeps each row's log-sum-exp and whose backward is
`attention_backward`. Without grad (serving) it is the plain forward
launch, writing no LSE. `attention.launches` counts forward launches,
`attention_backward.launches` backward ones.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from .ref import attention_bwd, chunked_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
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


# backward, bf16 (Bf16Bwd<D> in csrc/flash_attention_bwd.cu): dK/dV
# blocks of BWD_KEYS keys, 16 keys a warp, BWD_KEY_WARPS[Dh] warps sharing
# each 16 keys (each accumulating Dh / that many columns of dK and dV),
# in steps of BWD_STEP[Dh] query columns; dq blocks of BWD_ROWS query
# rows, 4 warps; 64-row q^/dO tiles (dkdv) and 64-key K/V tiles (dq)
# through a ring of BWD_STAGES in bf16.
BWD_KEYS = BWD_ROWS = 64
BWD_STAGES = 2
BWD_KEY_WARPS = {32: 1, 64: 1, 128: 1, 256: 2}
BWD_STEP = {32: 64, 64: 64, 128: 32, 256: 32}


def bwd_exchange_bytes(Dh: int) -> int:
    """Shared memory in which the warps that share each 16 keys trade
    their part of a step's packed P^T and dS^T (4 words per 8 columns a
    lane), in two parities; 0 where one warp holds the 16 keys."""
    wd = BWD_KEY_WARPS[Dh]
    if wd == 1:
        return 0
    words = 4 * BWD_STEP[Dh] // wd // 8
    return 4 * 2 * (4 * wd) * 32 * words


# backward, fp32: (query rows, keys) per tile by head_dim (BwdTiles<D>).
# dK and dV accumulate in registers, so shared memory holds fp32 K, V,
# q^, dO tiles and the P and dS tiles; at head_dim 256 the tiles shrink
# to 32 x 16 to stay small.
BWD_TILES = {32: (64, 64), 64: (64, 64), 128: (64, 32), 256: (32, 16)}
BWD_THREADS = 256


def bwd_launch_plan(dtype, B: int, Sq: int, Sk: int, H: int, KH: int,
                    Dh: int) -> dict:
    """The backward's three launches for q of `dtype`: "dot" (D =
    rowsum dO*O), "dkdv" and "dq". `flash_attention_bwd_smem_bytes` in
    the library must agree.

    bf16: "dot" runs Dh / 8 lanes a row (one 16-byte chunk each; it also
    writes q^), 256 threads a block; "dkdv" grid (KH * B, key tiles), key
    tile 0 (which sees every query in causal attention) first, 128 *
    BWD_KEY_WARPS[Dh] threads, shared memory for the K and V tiles,
    BWD_STAGES of (q^ and dO tiles, lse and D rows) and, where two warps
    share each 16 keys, their exchange slots; "dq" grid (H * B,
    query tiles), 128 threads, the q^ and dO tiles and BWD_STAGES of K
    and V tiles. fp32: "dot" a warp per row, 8 rows per block; "dkdv"
    grid (key tiles, KH, B) and "dq" grid (query tiles, H, B), all of
    BWD_THREADS threads; padded [rows][Dh + 1] fp32 tiles of K and V plus
    q^ and dO, the [BQ][BK + 1] P and dS tiles (dq keeps only dS) and two
    [BQ] row vectors (lse, D)."""
    if dtype == torch.bfloat16:
        tile = 2 * BWD_KEYS * Dh                  # bytes of a bf16 tile
        return {"dot": Plan((-(-B * Sq * H * (Dh // 8) // 256), 1, 1), 256,
                            0),
                "dkdv": Plan((KH * B, -(-Sk // BWD_KEYS), 1),
                             128 * BWD_KEY_WARPS[Dh],
                             2 * tile + BWD_STAGES * (2 * tile
                                                      + 4 * 2 * BWD_ROWS)
                             + bwd_exchange_bytes(Dh)),
                "dq": Plan((H * B, -(-Sq // BWD_ROWS), 1), 128,
                           2 * tile + BWD_STAGES * 2 * tile)}
    BQ, BK = BWD_TILES[Dh]
    tiles = 2 * BK * (Dh + 1) + 2 * BQ * (Dh + 1) + 2 * BQ
    return {"dot": Plan((-(-B * Sq * H // 8), 1, 1), BWD_THREADS, 0),
            "dkdv": Plan((-(-Sk // BK), KH, B), BWD_THREADS,
                         4 * (tiles + 2 * BQ * (BK + 1))),
            "dq": Plan((-(-Sq // BQ), H, B), BWD_THREADS,
                       4 * (tiles + BQ * (BK + 1)))}


def bwd_scratch(q):
    """The backward kernel's scratch for q [B,Sq,H,Dh]: (D [B,H,Sq] fp32,
    q^ of q's shape in bf16, or None for fp32, whose kernel scales q in
    shared memory), both from torch.empty on q's device."""
    B, Sq, H, _ = q.shape
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return dvec, (torch.empty_like(q) if q.dtype == torch.bfloat16
                  else None)


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
        bwd = lib.flash_attention_bwd_launch
        bwd.argtypes = _BWD_ARGTYPES
        bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
        _LAUNCH["lib"] = lib
        _LAUNCH["bwd"] = bwd
        _LAUNCH["fn"] = fn
    return _LAUNCH["lib"], fn


def aligned(t):
    """`t` contiguous and 16-byte aligned (the attention kernels copy 16
    bytes at a time): a view that is not is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_inputs(q, k, v, causal, window):
    """Shape, device and dtype checks of a kernel launch -> (B, Sq, Sk,
    H, K, Dh). Sq > Sk is taken only where the mask reads no positions
    (not causal, no window) and there are keys: right-aligned, some
    causal query rows would see no key at all."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, K, Dh) or tuple(v.shape) != tuple(k.shape) \
            or H % K or Dh not in BF16_TILES or \
            (Sq > Sk and (causal or window > 0 or Sk == 0)):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (causal {causal}, window "
                         f"{window})")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} (need one of f32/bf16)")
    return B, Sq, Sk, H, K, Dh


def _forward(q, k, v, causal, window, chunk, want_lse):
    """One forward -> (out, lse [B,H,Sq] fp32 or None). CPU: the plain
    version; CUDA: the kernel, which writes the LSE only when asked."""
    if q.device.type == "cpu":
        res = chunked_attention(q, k, v, causal=causal,
                                q_offset=k.shape[1] - q.shape[1],
                                window=window, chunk=chunk,
                                return_lse=want_lse)
        return res if want_lse else (res, None)
    B, Sq, Sk, H, K, Dh = _check_inputs(q, k, v, causal, window)
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
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None, code, B, Sq, Sk, H, K,
            Dh, qscale(q.dtype, Dh), int(causal), int(window), stream)
    _build.check(lib, rc, "flash_attention launch")
    attention.launches += 1
    return out, lse


class _Attention(torch.autograd.Function):
    """Differentiable attention: forward with LSE, backward by
    `attention_backward` (the kernel on the card, the plain version on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = _forward(q, k, v, causal, window, chunk, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, do,
                                        causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              chunk: int = 1024):
    """q [B,Sq,H,Dh]; k,v [B,Sk,K,Dh] (H a multiple of K) -> [B,Sq,H,Dh]
    in q's dtype. With `causal` or a `window`, q positions are
    right-aligned to k positions (q_offset = Sk - Sq) and Sq <= Sk. Not
    causal and without a window (the encoder's self-attention, cross
    attention to encoder frames) every query sees every key, at any Sq
    and Sk. `chunk` is the plain version's KV chunk (the model config's
    attn_chunk); the kernel tiles on its own. Differentiable in q, k and
    v."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window, chunk)
    return _forward(q, k, v, causal, window, chunk, want_lse=False)[0]


attention.launches = 0


def attention_with_lse(q, k, v, *, causal: bool = True, window: int = 0,
                       chunk: int = 1024):
    """The forward that training runs -> (out, lse [B,H,Sq] fp32): the
    same output as `attention`, plus each row's log-sum-exp of its
    scaled, masked scores. Counts in `attention.launches`."""
    return _forward(q, k, v, causal, window, chunk, want_lse=True)


def attention_backward(q, k, v, out, lse, do, *, causal: bool = True,
                       window: int = 0):
    """(dq, dk, dv) of `attention(q, k, v)` for the output gradient `do`,
    given the forward's `out` and `lse`. CPU: `ref.attention_bwd`; CUDA:
    the backward kernel (three launches: D = rowsum(dO*O), with q^ in
    bf16; dK/dV with one block per key tile and KV head; dQ), or
    raises."""
    if q.device.type == "cpu":
        return attention_bwd(q, k, v, out, lse, do, causal=causal,
                             window=window)
    B, Sq, Sk, H, K, Dh = _check_inputs(q, k, v, causal, window)
    if out.shape != q.shape or do.shape != q.shape or \
            out.dtype != q.dtype or lse.shape != (B, H, Sq) or \
            lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} "
                         f"{out.dtype}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    q, k, v, out, lse = map(aligned, (q, k, v, out, lse))
    do = aligned(do.to(q.dtype))
    lib, _ = _launcher()
    bwd = _LAUNCH["bwd"]
    code = _DTYPES[q.dtype]
    if ("bwd", code, Dh) not in _SMEM_CHECKED:
        plan = bwd_launch_plan(q.dtype, B, Sq, Sk, H, K, Dh)
        for i, name in enumerate(("dkdv", "dq")):
            got = lib.flash_attention_bwd_smem_bytes(code, Dh, i)
            if got != plan[name].smem:
                raise RuntimeError(f"flash_attention backward: the {name} "
                                   f"plan asks for {plan[name].smem} bytes "
                                   f"of shared memory, the kernel for "
                                   f"{q.dtype}, Dh={Dh} uses {got}")
        _SMEM_CHECKED.add(("bwd", code, Dh))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    dvec, qhat = bwd_scratch(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dvec.data_ptr(),
             qhat.data_ptr() if qhat is not None else None, code, B, Sq, Sk,
             H, K, Dh, qscale(q.dtype, Dh), int(causal), int(window), stream)
    _build.check(lib, rc, "flash_attention backward launch")
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0
