"""Public op: grammar-mask application on the device.

`apply_grammar_mask` ([B, V], the sequential path) and
`apply_grammar_mask_span` ([B, K, V], speculative verify) union each
row's precomputed store rows with its residue words, open EOS where the
parser allows it, and fill everything outside the mask with -1e30.
Rows whose `constrained` flag is False pass through unchanged.

A CPU tensor takes the plain version (`ref.py`); a CUDA tensor launches
the Hopper kernel (`csrc/masked_logits.cu`; one kernel serves both
forms, the [B, V] form being the span form with K = 1) or raises. There
is no other routing and no fallback. Each entry point's `.launches`
counts its kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import NEG_INF, masked_logits_ref, masked_logits_span_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(
            f"masked_logits: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(logits, store, rows, eos_allowed, constrained, cd, eos_id):
    """The kernel over N = B*K flattened rows: logits [N,V], rows [N,A],
    eos / constrained [N] bool, cd [N,W] int32 or None -> [N,V]."""
    dev = logits.device
    if logits.dtype not in _DTYPES or not logits.is_contiguous():
        raise ValueError("masked_logits: logits must be a contiguous "
                         f"f32/bf16 tensor, got {logits.dtype}")
    N, V = logits.shape
    R, W = store.shape
    A = rows.shape[1]
    if W * 32 < V or A < 1 or N < 1:
        raise ValueError(f"masked_logits: unsupported V={V}, W={W}, A={A}, "
                         f"rows={N}")
    _check(store, "store", torch.int32, (R, W), dev)
    _check(rows, "rows", torch.int32, (N, A), dev)
    _check(eos_allowed, "eos_allowed", torch.bool, (N,), dev)
    if constrained is not None:
        _check(constrained, "constrained", torch.bool, (N,), dev)
    if cd is not None:
        _check(cd, "cd", torch.int32, (N, W), dev)
    lib = _build.load()
    fn = lib.masked_logits_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty_like(logits)
    neg = float(torch.tensor(NEG_INF, dtype=logits.dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_ptr(logits), _DTYPES[logits.dtype], _ptr(store), _ptr(rows),
            _ptr(eos_allowed), _ptr(constrained), _ptr(cd), _ptr(out),
            N, V, W, A, eos_id, neg, ctypes.c_void_p(stream))
    _build.check(lib, rc, "masked_logits launch")
    return out


def apply_grammar_mask(logits, store, rows, eos_allowed, *, eos_id: int = 1,
                       constrained=None, cd=None):
    """logits [B,V] f32|bf16; store [R,W] int32 (uint32 bits); rows [B,A]
    int32 (-1 pad); eos_allowed [B] bool; constrained [B] bool or None
    (all constrained); cd [B,W] int32 or None -> [B,V] in logits' dtype."""
    dev = logits.device
    if dev.type == "cpu":
        return masked_logits_ref(logits, store, rows, eos_allowed,
                                 eos_id=eos_id, constrained=constrained,
                                 cd=cd)
    if dev.type != "cuda":
        raise ValueError(f"masked_logits: unsupported device {dev}")
    if logits.dim() != 2:
        raise ValueError(f"masked_logits: logits must be [B, V], got "
                         f"{tuple(logits.shape)}")
    out = _launch(logits, store, rows, eos_allowed, constrained, cd, eos_id)
    apply_grammar_mask.launches += 1
    return out


def apply_grammar_mask_span(logits, store, rows, eos_allowed, *,
                            eos_id: int = 1, constrained=None, cd=None):
    """Span form: logits [B,K,V]; rows [B,K,A]; eos_allowed and
    constrained [B,K] bool; cd [B,K,W] int32 or None -> [B,K,V]."""
    dev = logits.device
    if dev.type == "cpu":
        return masked_logits_span_ref(logits, store, rows, eos_allowed,
                                      eos_id=eos_id,
                                      constrained=constrained, cd=cd)
    if dev.type != "cuda":
        raise ValueError(f"masked_logits_span: unsupported device {dev}")
    if logits.dim() != 3:
        raise ValueError(f"masked_logits_span: logits must be [B, K, V], "
                         f"got {tuple(logits.shape)}")
    B, K, V = logits.shape
    flat = lambda t: None if t is None else t.reshape(B * K, *t.shape[2:])
    out = _launch(flat(logits), store, flat(rows), flat(eos_allowed),
                  flat(constrained), flat(cd), eos_id)
    apply_grammar_mask_span.launches += 1
    return out.reshape(B, K, V)


apply_grammar_mask.launches = 0
apply_grammar_mask_span.launches = 0
