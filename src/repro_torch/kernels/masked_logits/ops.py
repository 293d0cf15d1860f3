"""Public op: grammar-mask application on the device.

`apply_grammar_mask` ([B, V], the sequential path) and
`apply_grammar_mask_span` ([B, K, V], speculative verify) union each
row's precomputed store rows with its residue words, open EOS where the
parser allows it, and fill everything outside the mask with -1e30.
Rows whose `constrained` flag is False pass through unchanged. An
`eos_id` outside [0, V) opens nothing (the kernel bounds it).

`apply_grammar_mask_shard` and `apply_grammar_mask_span_shard` are the
sharded engine's shard-local forms: a rank's logits [.., V_s] hold vocab
ids [v0, v1), its store and residue words are words [w0, w1) with
v0 = 32*w0, so bit j of its word i is its column 32*i + j and the same
kernel runs on them unchanged; only the EOS id moves to the rank's
column (out of range on every other rank).

A CPU tensor takes the plain version (`ref.py`); a CUDA tensor launches
the Hopper kernel (`csrc/masked_logits.cu`; one kernel serves both
forms, the [B, V] form being the span form with K = 1) or raises. There
is no other routing and no fallback. Each entry point's `.launches`
counts its kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import NEG_INF, masked_logits_ref, masked_logits_span_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 6 + [ctypes.c_uint] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
_NEG: dict = {}             # dtype -> bits of NEG_INF rounded to dtype
_LAUNCH: dict = {}          # "fn" -> the C entry point, typed once

THREADS = 128               # most threads per block
MAX_TILE = 4096             # vocab entries per block (kMaxTile)
MAX_IDS = 8192              # row ids a block lists (kMaxIds)
SMS = 132                   # streaming multiprocessors of an H100 SXM
UNION_BUDGET = 1 << 20      # A x tile: a block's union reads, in tokens


class Plan(NamedTuple):
    """One launch: the 16-byte path or the scalar one, vocab entries per
    block, threads per block, the grid (rows, tiles) and dynamic shared
    memory per block (the row's compacted id list)."""
    vec: bool
    tile: int
    threads: int
    grid: tuple
    smem: int


@functools.lru_cache(maxsize=256)
def launch_plan(N: int, V: int, W: int, A: int, dtype,
                aligned: bool = True) -> Plan:
    """The kernel's launch for N rows of V logits of `dtype`, W store
    words per row and A row ids per row; `aligned` says whether the
    logits, output, store and cd pointers are all 16-byte aligned.

    The vector path (16-byte accesses) needs aligned pointers, rows of a
    whole number of 16-byte groups (V * elem % 16 == 0) and store rows of
    whole uint4 word groups (W % 4 == 0); anything else takes the scalar
    path. The tile is a power of two from one union access (128 tokens
    on the vector path, 32 on the scalar one) to MAX_TILE, halved from
    MAX_TILE while the grid holds fewer blocks than the card has SMs (so
    one row still fills the card) or while a block's union could read
    more than UNION_BUDGET tokens of store rows (A x tile: a wide accept
    bucket spreads its store reads over more SMs). Many rows at the
    engine's bucket launch blocks of MAX_TILE entries. Threads: one per
    16-byte access of the tile (one per entry on the scalar path), from
    one warp to THREADS; a larger tile gives each thread up to 8 (32)
    accesses. `masked_logits_plan_smem` in the library must agree."""
    elem = 2 if dtype == torch.bfloat16 else 4
    vec = bool(aligned) and (V * elem) % 16 == 0 and W % 4 == 0
    unit = 128 if vec else 32
    tile = MAX_TILE
    while tile > unit and (N * -(-V // tile) < SMS
                           or A * tile > UNION_BUDGET):
        tile //= 2
    per_access = 16 // elem if vec else 1
    threads = min(THREADS, max(32, tile // per_access))
    return Plan(vec, tile, threads, (N, -(-V // tile)), 4 * A)


def _neg_bits(dtype) -> int:
    """The bits of NEG_INF rounded to `dtype`, as the plain version
    fills."""
    n = _NEG.get(dtype)
    if n is None:
        view, mask = ((torch.int16, 0xFFFF) if dtype == torch.bfloat16
                      else (torch.int32, 0xFFFFFFFF))
        n = _NEG[dtype] = torch.tensor(NEG_INF, dtype=dtype).view(
            view).item() & mask
    return n


def _launcher():
    fn = _LAUNCH.get("fn")
    if fn is None:
        lib = _build.load()
        fn = lib.masked_logits_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.masked_logits_plan_smem.argtypes = [ctypes.c_int] * 10
        lib.masked_logits_plan_smem.restype = ctypes.c_int
        _LAUNCH["lib"] = lib
        _LAUNCH["fn"] = fn
    return _LAUNCH["lib"], fn


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(
            f"masked_logits: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    if W * 32 < V or not 1 <= A <= MAX_IDS or N < 1 or R < 1:
        raise ValueError(f"masked_logits: unsupported V={V}, W={W}, A={A}, "
                         f"R={R}, rows={N}, eos_id={eos_id}")
    _check(store, "store", torch.int32, (R, W), dev)
    _check(rows, "rows", torch.int32, (N, A), dev)
    _check(eos_allowed, "eos_allowed", torch.bool, (N,), dev)
    if constrained is not None:
        _check(constrained, "constrained", torch.bool, (N,), dev)
    if cd is not None:
        _check(cd, "cd", torch.int32, (N, W), dev)
    out = torch.empty_like(logits)
    aligned = (logits.data_ptr() | out.data_ptr() | store.data_ptr()
               | (0 if cd is None else cd.data_ptr())) % 16 == 0
    plan = launch_plan(N, V, W, A, logits.dtype, aligned)
    lib, fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(logits.data_ptr(), _DTYPES[logits.dtype], store.data_ptr(),
            rows.data_ptr(), eos_allowed.data_ptr(), _ptr(constrained),
            _ptr(cd), out.data_ptr(), N, V, W, A, R, eos_id,
            _neg_bits(logits.dtype), plan.tile, plan.threads, int(plan.vec),
            stream)
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


def apply_grammar_mask_shard(logits, store, rows, eos_allowed, shard, *,
                             eos_id: int = 1, constrained=None, cd=None):
    """Row form on one rank's block: logits [B,V_s], store [R,W_s], cd
    [B,W_s] or None; `shard` the rank's `VocabShard`. Launches count as
    `apply_grammar_mask`'s."""
    return apply_grammar_mask(logits, store, rows, eos_allowed,
                              eos_id=shard.local_id(eos_id),
                              constrained=constrained, cd=cd)


def apply_grammar_mask_span_shard(logits, store, rows, eos_allowed, shard,
                                  *, eos_id: int = 1, constrained=None,
                                  cd=None):
    """Span form on one rank's block: logits [B,K,V_s], store [R,W_s], cd
    [B,K,W_s] or None. Launches count as `apply_grammar_mask_span`'s."""
    return apply_grammar_mask_span(logits, store, rows, eos_allowed,
                                   eos_id=shard.local_id(eos_id),
                                   constrained=constrained, cd=cd)


apply_grammar_mask.launches = 0
apply_grammar_mask_span.launches = 0
