"""Public op: attention through a page table.

`paged_attention` ([B, S] query spans, every paged feed of the engine)
and `paged_attention_decode` (its S = 1 form) read each slot's KV from
the shared page pools through the slot's page table.

A CPU tensor takes the plain version (`ref.py`, a bitwise twin of the
dense decode attention there); a CUDA tensor launches the Hopper kernel
(`csrc/paged_attention.cu`) or raises. There is no other routing and no
fallback. `paged_attention.launches` counts kernel launches (never
plain-version calls); the decode form launches through it.

`paged_attention_partial` is the same kernel over one rank's share of a
pool split on the in-page offset (a trunk-sharded engine's sequence
split): pools [P, ps/M, K, Dh] holding offsets [base, base + ps/M) of
pages of `ps` positions -> the rank's fp32 output, not rounded, and each
row's fp32 log-sum-exp (`ref.paged_attention_partial_ref`; rows with no
valid position on the rank: 0 and NEG_INF). Its launches count in
`paged_attention_partial.launches`.

`paged_attention_scores` and `paged_attention_values` are the head_dim
form (a pool split on head_dim: [P, ps, K, dw] a rank), two launches of
`csrc/paged_attention.cu` around the caller's all-reduce: the rank's
fp32 partial scores through the page table, then the joined
probabilities times its V block (`ref.paged_scores_ref`,
`ref.paged_values_ref`). Each counts in its own `.launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..flash_attention.ops import aligned, qscale
from .ref import (paged_attention_partial_ref, paged_attention_ref,
                  paged_scores_ref, paged_values_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 16
             + [ctypes.c_float, ctypes.c_void_p])
SMEM_MAX = 200 * 1024       # of the 227 KB a Hopper block may use
MAX_CLUSTER = 8             # the portable thread-block cluster size
MAX_ROWS = 32               # query rows per cluster
MMA_ROWS = 16               # bf16 spans of at least one mma row tile
                            # take tiles of exactly one
VALUES_OUT = 1024           # (row, channel) outputs a values block holds
_LAUNCH: dict = {}          # C entry point name -> the function, typed once


class Plan(NamedTuple):
    """One launch: a cluster of `C` blocks per (slot, kv head, tile of
    `R` query rows), `tiles` tiles; block `rank` of a cluster takes pages
    `pages_of(plan, rank, nP)` in chunks of `cpp` pages; `mma` runs both
    products on tensor cores; `smem` dynamic bytes per block."""
    C: int
    ppb: int
    cpp: int
    R: int
    tiles: int
    mma: bool
    smem: int


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def block_smem(R: int, ppb: int, cpp: int, ps: int, Dh: int, esz: int,
               mma: bool = False) -> int:
    """Dynamic shared memory of one block, laid out as the kernel lays it
    out: a chunk of K or V pages in their dtype (rows padded to 16 for
    mma), then the q rows (fp32; bf16 with the bf16 P rows for mma),
    fp32 P.V partials, scores over the block's positions, four per-row
    statistics, and the block's page ids."""
    if mma:
        kv = _up16(cpp * ps) * Dh * esz
        qp = _up16(R) * (Dh + _up16(ppb * ps)) * esz
    else:
        kv = cpp * ps * Dh * esz
        qp = R * Dh * 4
    return kv + qp + R * Dh * 4 + R * ppb * ps * 4 + 4 * R * 4 + ppb * 4


@functools.lru_cache(maxsize=256)
def launch_plan(S: int, H: int, K: int, Dh: int, ps: int, nP: int,
                esz: int) -> Plan:
    """Split the slot's nP pages over a cluster of at most MAX_CLUSTER
    blocks (ceil(nP / C) contiguous pages each, no block left empty) and
    pick the query rows per cluster (at most MAX_ROWS) and the pages per
    shared-memory chunk so that a block fits SMEM_MAX. bf16 spans of at
    least MMA_ROWS rows (Dh a multiple of 16) whose pages fit one chunk
    take the tensor-core products in tiles of MMA_ROWS rows (faster than
    tiles of 24-96 rows at 32 and 128 pages on an NVIDIA H100 80GB HBM3 at
    700 W; PERF.md)."""
    rows = S * (H // K)
    C = min(MAX_CLUSTER, nP)
    ppb = -(-nP // C)
    C = -(-nP // ppb)
    if esz == 2 and Dh % 16 == 0 and rows >= MMA_ROWS:
        smem = block_smem(MMA_ROWS, ppb, ppb, ps, Dh, esz, True)
        if smem <= SMEM_MAX:
            return Plan(C, ppb, ppb, MMA_ROWS, -(-rows // MMA_ROWS), True,
                        smem)
    for R in range(min(MAX_ROWS, rows), 0, -1):
        room = SMEM_MAX - block_smem(R, ppb, 0, ps, Dh, esz)
        cpp = min(ppb, room // (ps * Dh * esz))
        if cpp >= 1:
            return Plan(C, ppb, cpp, R, -(-rows // R), False,
                        block_smem(R, ppb, cpp, ps, Dh, esz))
    raise ValueError(f"paged_attention: {nP} pages of {ps} positions do "
                     f"not fit one block's shared memory")


def pages_of(plan: Plan, rank: int, nP: int) -> range:
    """The pages that block `rank` of a cluster reads (as the kernel)."""
    beg = min(nP, rank * plan.ppb)
    return range(beg, min(nP, beg + plan.ppb))


_SIGNATURES = {
    "paged_attention_launch": _ARGTYPES,
    "paged_scores_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p],
    "paged_values_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_void_p]}


def _launcher(name="paged_attention_launch"):
    fn = _LAUNCH.get(name)
    if fn is None:
        lib = _build.load()
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LAUNCH["lib"] = lib
        _LAUNCH[name] = fn
    return _LAUNCH["lib"], fn


def _launch(q, k_pool, v_pool, page_table, pos, ps, base, partial):
    """Check the inputs and launch the kernel -> out (q's dtype), or
    (o fp32, lse fp32) when `partial`; the pools hold offsets [base,
    base + k_pool.shape[1]) of pages of `ps` positions."""
    dev = q.device
    name = "paged_attention_partial" if partial else "paged_attention"
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype} (need one of f32/bf16)")
    B, S, H, Dh = q.shape
    P, psl, K, _ = k_pool.shape
    nP = page_table.shape[1]
    esz = q.element_size()
    nch = Dh * esz // 16
    if tuple(k_pool.shape) != (P, psl, K, Dh) or \
            tuple(v_pool.shape) != (P, psl, K, Dh) or H % K or Dh > 256 or \
            Dh * esz % 16 or not (nch in (1, 2, 4) or nch % 8 == 0) or \
            tuple(page_table.shape) != (B, nP) or nP < 1 or \
            page_table.dtype != torch.int32 or B > 65535 or \
            not 0 <= base <= ps - psl:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}, page table "
                         f"{tuple(page_table.shape)} {page_table.dtype}, "
                         f"offsets [{base}, {base + psl}) of {ps}")
    plan = launch_plan(S, H, K, Dh, psl, nP, esz)
    if K * plan.tiles > 65535:
        raise ValueError(f"{name}: {S} span rows x {K} kv heads exceed "
                         f"the grid")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    q, page_table, pos = (t.contiguous() for t in (q, page_table, pos))
    k_pool, v_pool = aligned(k_pool), aligned(v_pool)
    lib, fn = _launcher()
    if partial:
        out = torch.empty(q.shape, dtype=torch.float32, device=dev)
        lse = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    else:
        out, lse = torch.empty_like(q), None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], B,
            S, H, K, Dh, psl, ps, base, nP, plan.R, plan.C, plan.ppb,
            plan.cpp, int(plan.mma), plan.smem, qscale(q.dtype, Dh), stream)
    _build.check(lib, rc, f"{name} launch")
    return (out, lse) if partial else out


def _device(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def paged_attention(q, k_pool, v_pool, page_table, pos):
    """q [B,S,H,Dh] (roped, unscaled); k_pool/v_pool [P,ps,K,Dh];
    page_table [B,nP] int32 (-1 = unmapped); pos [B] int32 absolute
    start positions -> [B,S,H,Dh] in q's dtype."""
    if _device(q, "paged_attention") == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, pos)
    out = _launch(q, k_pool, v_pool, page_table, pos, k_pool.shape[1], 0,
                  False)
    paged_attention.launches += 1
    return out


def paged_attention_partial(q, k_pool, v_pool, page_table, pos, ps: int,
                            base: int):
    """One rank's partial attention over a pool split on the in-page
    offset: k_pool/v_pool [P, psl, K, Dh] hold offsets [base, base + psl)
    of pages of `ps` positions; the rest as `paged_attention` -> (o
    [B,S,H,Dh] fp32, lse [B,S,H] fp32)."""
    if _device(q, "paged_attention_partial") == "cpu":
        return paged_attention_partial_ref(q, k_pool, v_pool, page_table,
                                           pos, ps, base)
    out = _launch(q, k_pool, v_pool, page_table, pos, int(ps), int(base),
                  True)
    paged_attention_partial.launches += 1
    return out


def values_rows(S: int, G: int, dw: int) -> int:
    """Query rows a values block takes: as many of the S * G rows of a
    (slot, kv head) as keep its (row, channel) outputs within
    VALUES_OUT (8 fp32 accumulators a thread), at least one."""
    return max(1, min(S * G, VALUES_OUT // dw))


def paged_attention_scores(q, k_pool, page_table, d0: int):
    """The head_dim form's first launch: q [B,S,H,Dh] (roped, unscaled,
    every channel); k_pool [P,ps,K,dw] channels [d0, d0 + dw) of every
    position; page_table [B,nP] int32 -> fp32 partial scores
    [B,S,H,nP*ps] (`ref.paged_scores_ref`)."""
    if _device(q, "paged_attention_scores") == "cpu":
        return paged_scores_ref(q, k_pool, page_table, d0)
    B, S, H, Dh = q.shape
    P, ps, K, dw = k_pool.shape
    nP = page_table.shape[1]
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or H % K or \
            not 0 <= d0 <= Dh - dw or tuple(page_table.shape) != (B, nP) \
            or nP < 1 or page_table.dtype != torch.int32 or B > 65535 or \
            ps * (dw + 1) * 4 > SMEM_MAX:
        raise ValueError(f"paged_attention_scores: unsupported q "
                         f"{tuple(q.shape)} {q.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}, page table "
                         f"{tuple(page_table.shape)} {page_table.dtype}, "
                         f"channels [{d0}, {d0 + dw})")
    q, k_pool, page_table = (t.contiguous() for t in (q, k_pool,
                                                       page_table))
    out = torch.empty((B, S, H, nP * ps), dtype=torch.float32,
                      device=q.device)
    lib, fn = _launcher("paged_scores_launch")
    rc = fn(q.data_ptr(), k_pool.data_ptr(), page_table.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], B, S, H, K, Dh, dw, int(d0),
            ps, nP, qscale(q.dtype, Dh),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "paged_attention_scores launch")
    paged_attention_scores.launches += 1
    return out


def paged_attention_values(p, v_pool, page_table):
    """The head_dim form's second launch: p [B,S,H,nP*ps] the joined
    probabilities in the value dtype; v_pool [P,ps,K,dw]; page_table
    [B,nP] int32 -> fp32 [B,S,H,dw] (`ref.paged_values_ref`)."""
    if _device(p, "paged_attention_values") == "cpu":
        return paged_values_ref(p, v_pool, page_table)
    B, S, H, L = p.shape
    P, ps, K, dw = v_pool.shape
    nP = page_table.shape[1]
    R = values_rows(S, H // max(K, 1), dw)
    if p.dtype not in _DTYPES or v_pool.dtype != p.dtype or H % K or \
            L != nP * ps or tuple(page_table.shape) != (B, nP) or \
            nP < 1 or page_table.dtype != torch.int32 or \
            R * dw > VALUES_OUT or -(-S * (H // K) // R) > 65535 or \
            (ps * dw + R * ps) * 4 > SMEM_MAX:
        raise ValueError(f"paged_attention_values: unsupported p "
                         f"{tuple(p.shape)} {p.dtype}, pool "
                         f"{tuple(v_pool.shape)} {v_pool.dtype}, page table "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    p, v_pool, page_table = (t.contiguous() for t in (p, v_pool,
                                                       page_table))
    out = torch.empty((B, S, H, dw), dtype=torch.float32, device=p.device)
    lib, fn = _launcher("paged_values_launch")
    rc = fn(p.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            out.data_ptr(), _DTYPES[p.dtype], B, S, H, K, dw, ps, nP, R,
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, rc, "paged_attention_values launch")
    paged_attention_values.launches += 1
    return out


def paged_attention_decode(q, k_pool, v_pool, page_table, pos):
    """Decode ([B, 1]) form: q [B,H,Dh] -> [B,H,Dh]."""
    return paged_attention(q[:, None], k_pool, v_pool, page_table,
                           pos)[:, 0]


paged_attention.launches = 0
paged_attention_partial.launches = 0
paged_attention_scores.launches = 0
paged_attention_values.launches = 0
