"""Public op: fused grammar-mask + filter + sample on the device.

`fused_mask_select` turns a decode step's (logits, precomputed row ids,
residue words, per-slot decode configs, Gumbel noise) into the selected
token ids, the masked logits (the engine's resample and exact-fallback
paths reuse them) and the per-row `ok` flag, in ONE call.

A CPU tensor takes the plain version (`ref.py`); a CUDA tensor launches
the Hopper kernel (`csrc/fused_select.cu`) or raises. There is no other
routing and no fallback. `fused_mask_select.launches` counts kernel
launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import NEG_INF, fused_select_ref, gumbel_noise  # noqa: F401

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(
            f"fused_select: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def fused_mask_select(logits, store, rows, cd, eos_allowed, constrained,
                      greedy_flags, temperature, top_k, top_p, *,
                      noise=None, eos_id: int = 1):
    """-> (ids [B] int32, masked [B, V], ok [B] bool).

    logits [B,V] f32|bf16; store [R,W] int32 (uint32 bits); rows [B,A]
    int32 (-1 pad); cd [B,W] int32 or None; eos_allowed / constrained /
    greedy_flags [B] bool; temperature / top_p [B] f32; top_k [B] int32;
    noise [B,V] f32 standard-Gumbel, or None for the all-greedy variant
    (every row takes the masked argmax)."""
    dev = logits.device
    if dev.type == "cpu":
        return fused_select_ref(logits, store, rows, cd, eos_allowed,
                                constrained, greedy_flags, temperature,
                                top_k, top_p, noise=noise, eos_id=eos_id)
    if dev.type != "cuda":
        raise ValueError(f"fused_select: unsupported device {dev}")
    if logits.dtype not in _DTYPES or logits.dim() != 2 or \
            not logits.is_contiguous():
        raise ValueError("fused_select: logits must be a contiguous [B, V] "
                         f"f32/bf16 tensor, got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    R, W = store.shape
    A = rows.shape[1]
    if V % 32 or W * 32 < V or W > 12288 or A < 1:
        raise ValueError(f"fused_select: unsupported V={V}, W={W}, A={A}")
    _check(store, "store", torch.int32, (R, W), dev)
    _check(rows, "rows", torch.int32, (B, A), dev)
    if cd is not None:
        _check(cd, "cd", torch.int32, (B, W), dev)
    for name, t in (("eos_allowed", eos_allowed),
                    ("constrained", constrained),
                    ("greedy_flags", greedy_flags)):
        _check(t, name, torch.bool, (B,), dev)
    _check(temperature, "temperature", torch.float32, (B,), dev)
    _check(top_k, "top_k", torch.int32, (B,), dev)
    _check(top_p, "top_p", torch.float32, (B,), dev)
    if noise is not None:
        _check(noise, "noise", torch.float32, (B, V), dev)
    lib = _build.load()
    fn = lib.fused_select_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ids = torch.empty(B, dtype=torch.int32, device=dev)
    masked = torch.empty_like(logits)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    neg = float(torch.tensor(NEG_INF, dtype=logits.dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_ptr(logits), _DTYPES[logits.dtype], _ptr(store), _ptr(rows),
            _ptr(cd), _ptr(eos_allowed), _ptr(constrained),
            _ptr(greedy_flags), _ptr(temperature), _ptr(top_k), _ptr(top_p),
            _ptr(noise), _ptr(ids), _ptr(masked), _ptr(ok), B, V, W, A, R,
            eos_id, neg, 0 if noise is None else 1,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, "fused_select launch")
    fused_mask_select.launches += 1
    return ids, masked, ok


fused_mask_select.launches = 0
