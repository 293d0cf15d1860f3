"""Public op: fused grammar-mask + filter + sample on the device.

`fused_mask_select` turns a decode step's (logits, precomputed row ids,
residue words, per-slot decode configs, Gumbel noise) into the selected
token ids, the masked logits (the engine's resample and exact-fallback
paths reuse them) and the per-row `ok` flag, in ONE call.

A CPU tensor takes the plain version (`ref.py`); a CUDA tensor launches
the Hopper kernel (`csrc/fused_select.cu`) or raises. There is no other
routing and no fallback. `fused_mask_select.launches` counts kernel
launches (never plain-version calls).

`fused_mask_select_sharded` is the sharded engine's route: each rank
masks its own vocab block (`masked_logits`, shard-local), one all-gather
joins the masked rows, and this kernel selects on the whole row,
unconstrained (rows = -1, no residue, flags off), as the engine's
resample already does. Every rank holds the same row and noise, so every
rank selects the same ids.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ...distributed.api import all_gather_last
from ..masked_logits.ops import apply_grammar_mask_shard
from .ref import NEG_INF, fused_select_ref, gumbel_noise  # noqa: F401

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG: dict = {}             # dtype -> NEG_INF rounded to dtype
_LAUNCH: dict = {}          # "fn" -> the C entry point, typed once
_SMEM_CHECKED: set = set()  # (dtype code, W) whose plan the library confirmed

THREADS = 1024              # one block per row
CAP = 4096                  # candidate-list entries (kCap in the kernel)
BINS = 4096                 # first-level histogram: top 12 key bits
MAX_WORDS = 12288           # union words the kernel takes (V <= 393216)


class Plan(NamedTuple):
    """One launch: threads per block (one block per row), the candidate
    list's capacity, dynamic shared memory per block, the entries of one
    16-byte access (`vec`) and the tokens the union's last word covers
    (`tail`: V % 32, or 32 when V is a multiple of 32)."""
    V: int
    threads: int
    cap: int
    smem: int
    vec: int
    tail: int

    def list_route(self, top_k: int) -> bool:
        """Whether a sampled row whose top_k is on may take the candidate
        list: 0 < top_k < V and top_k <= cap. It does when its candidates
        (the entries at or above the first-level bin of rank top_k) fit
        `cap`; a row whose top_k is above `cap` takes the radix route. (A
        row with top_k off and top_p < 1 may take the list by mass.)"""
        return 0 < top_k < self.V and top_k <= self.cap


@functools.lru_cache(maxsize=64)
def launch_plan(V: int, W: int, dtype) -> Plan:
    """The kernel's launch for [B, V] logits of `dtype` and W union words:
    the candidate list (8 B per entry: fp32 key and index, whatever the
    dtype), the first-level histogram (4 B per bin) and the union (4 B per
    word). `fused_select_smem_bytes` in the library must agree.

    Every pass reads a row 16 bytes at a time (8 bf16 or 4 fp32 entries),
    so V must be a multiple of 8: each row then starts 16-byte aligned,
    and no access straddles two union words (32 is a multiple of 8). V
    need not be a multiple of 32 (mamba2's 50280): the last word covers
    V % 32 tokens, its higher bits are zero in the store and never read.
    Raises ValueError for a shape the kernel does not take."""
    if V < 8 or V % 8 or W * 32 < V or W > MAX_WORDS:
        raise ValueError(f"fused_select: unsupported V={V}, W={W}")
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return Plan(V, THREADS, CAP, 8 * CAP + 4 * BINS + 4 * W, vec,
                V % 32 or 32)


def _neg(dtype) -> float:
    """NEG_INF rounded to `dtype`, as the plain version fills."""
    n = _NEG.get(dtype)
    if n is None:
        n = _NEG[dtype] = float(torch.tensor(NEG_INF, dtype=dtype))
    return n


def _launcher():
    fn = _LAUNCH.get("fn")
    if fn is None:
        lib = _build.load()
        fn = lib.fused_select_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_select_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.fused_select_smem_bytes.restype = ctypes.c_int
        _LAUNCH["lib"] = lib
        _LAUNCH["fn"] = fn
    return _LAUNCH["lib"], fn


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(
            f"fused_select: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    if A < 1:
        raise ValueError(f"fused_select: unsupported A={A}")
    plan = launch_plan(V, W, logits.dtype)
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
    if logits.data_ptr() % 16:      # the kernel reads 16 bytes at a time
        logits = logits.clone()
    lib, fn = _launcher()
    code = _DTYPES[logits.dtype]
    if (code, W) not in _SMEM_CHECKED:
        want = plan.smem
        got = lib.fused_select_smem_bytes(code, W)
        if got != want:
            raise RuntimeError(f"fused_select: launch plan asks for {want} "
                               f"bytes of shared memory, the kernel for "
                               f"{logits.dtype}, W={W} uses {got}")
        _SMEM_CHECKED.add((code, W))
    ids = torch.empty(B, dtype=torch.int32, device=dev)
    masked = torch.empty_like(logits)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_ptr(logits), code, _ptr(store), _ptr(rows), _ptr(cd),
            _ptr(eos_allowed), _ptr(constrained), _ptr(greedy_flags),
            _ptr(temperature), _ptr(top_k), _ptr(top_p), _ptr(noise),
            _ptr(ids), _ptr(masked), _ptr(ok), B, V, W, A, R, eos_id,
            _neg(logits.dtype), 0 if noise is None else 1, stream)
    _build.check(lib, rc, "fused_select launch")
    fused_mask_select.launches += 1
    return ids, masked, ok


fused_mask_select.launches = 0


def fused_mask_select_sharded(logits, store, rows, cd, eos_allowed,
                              constrained, greedy_flags, temperature, top_k,
                              top_p, *, shard, mesh, blank_store, noise=None,
                              eos_id: int = 1):
    """The [B, V] selection of a rank whose vocabulary block is `shard`
    (a `VocabShard`) on `mesh`: logits [B,V_s] its block, store [R,W_s]
    and cd [B,W_s] its words; `blank_store` a zero [1, W] store (the
    whole-row call reads none of it). -> (ids [B] int32, masked [B, V]
    whole, ok [B] bool), the same on every rank."""
    masked = all_gather_last(
        apply_grammar_mask_shard(logits, store, rows, eos_allowed, shard,
                                 eos_id=eos_id, constrained=constrained,
                                 cd=cd), shard.widths, mesh)
    B = masked.shape[0]
    off = torch.zeros(B, dtype=torch.bool, device=masked.device)
    return fused_mask_select(
        masked, blank_store,
        torch.full((B, 1), -1, dtype=torch.int32, device=masked.device),
        None, off, off, greedy_flags, temperature, top_k, top_p,
        noise=noise, eos_id=eos_id)


def fused_mask_select_span(logits, store, rows, cd, eos_allowed,
                           constrained, greedy_flags, temperature, top_k,
                           top_p, *, noise=None, eos_id: int = 1):
    """Span ([B, S, V]) form for speculative verification: every draft
    position carries its own row set, residue, eos and constrained flag;
    the per-slot decode configs broadcast across the span. Flattens
    (b, s) and delegates to `fused_mask_select` (one launch on the card),
    so it equals the batch form by construction.
    -> (ids [B, S], masked [B, S, V], ok [B, S])."""
    B, S, V = logits.shape
    rep = lambda a: torch.repeat_interleave(a, S, dim=0)
    ids, masked, ok = fused_mask_select(
        logits.reshape(B * S, V), store, rows.reshape(B * S, -1),
        None if cd is None else cd.reshape(B * S, -1),
        eos_allowed.reshape(B * S), constrained.reshape(B * S),
        rep(greedy_flags), rep(temperature), rep(top_k), rep(top_p),
        noise=None if noise is None else noise.reshape(B * S, V),
        eos_id=eos_id)
    return ids.reshape(B, S), masked.reshape(B, S, V), ok.reshape(B, S)
