"""The attention wrappers' launch planning, pure Python (no card needed).

For every span width the paged engine feeds (`FEED_BUCKETS`), the page
counts of smollm-360m and syncode-demo at max_len 512 and 2048 (16-token
pages, the engine's default), head_dims 32/64/128 and both dtypes, the
paged plan must fit a Hopper block's shared memory (227 KB), keep the
cluster within the portable size (8 blocks), give every page of a slot
to exactly one block of its cluster, and cover every query row; the
flash plan must fit shared memory and cover every query row.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import launch_plan as flash_plan
from repro_torch.kernels.paged_attention.ops import (
    MAX_CLUSTER, block_smem, launch_plan, pages_of)
from repro_torch.serving.engine import FEED_BUCKETS

SMEM_LIMIT = 227 * 1024         # a Hopper block's shared memory
PAGE_SIZE = 16


def _check_paged(S, H, K, Dh, ps, nP, esz):
    plan = launch_plan(S, H, K, Dh, ps, nP, esz)
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == block_smem(plan.R, plan.ppb, plan.cpp, ps, Dh, esz,
                                   plan.mma)
    assert not plan.mma or (esz == 2 and plan.cpp == plan.ppb
                            and Dh % 16 == 0)
    assert 1 <= plan.C <= MAX_CLUSTER
    assert 1 <= plan.cpp <= plan.ppb
    owners = [r for p in range(nP) for r in range(plan.C)
              if p in pages_of(plan, r, nP)]
    assert len(owners) == nP                   # each page exactly once
    assert all(len(pages_of(plan, r, nP)) > 0 for r in range(plan.C))
    rows = S * (H // K)
    assert 1 <= plan.R <= 32 and plan.tiles * plan.R >= rows
    assert (plan.tiles - 1) * plan.R < rows    # no empty tile
    return plan


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("S", FEED_BUCKETS)
@pytest.mark.parametrize("max_len", [512, 2048])
@pytest.mark.parametrize("arch", ["smollm-360m", "syncode-demo"])
def test_paged_plan_fits_and_covers_every_page(arch, max_len, S, Dh):
    cfg = get_config(arch)
    nP = -(-max_len // PAGE_SIZE)
    for esz in (2, 4):
        _check_paged(S, cfg.num_heads, cfg.num_kv_heads, Dh, PAGE_SIZE, nP,
                     esz)


@pytest.mark.parametrize("nP", [1, 3, 7, 9, 33, 127, 1000])
@pytest.mark.parametrize("ps", [8, 32])
def test_paged_plan_odd_page_counts(nP, ps):
    """Page counts the split does not divide, and a 16000-position slot
    that needs chunks of pages."""
    for esz in (2, 4):
        plan = _check_paged(8, 15, 5, 128, ps, nP, esz)
        if nP * ps >= 16000 and esz == 4:
            assert plan.cpp < plan.ppb


def test_paged_plan_served_shape():
    """smollm-360m's paged run: 32 pages of 16, one cluster of 8 blocks
    of 4 pages per (slot, kv head); S = 32 spans (96 rows) in six tiles of
    16 rows on tensor cores in bf16."""
    plan = launch_plan(1, 15, 5, 64, 16, 32, 2)
    assert (plan.C, plan.ppb, plan.cpp, plan.R, plan.tiles, plan.mma) == (
        8, 4, 4, 3, 1, False)
    plan = launch_plan(32, 15, 5, 64, 16, 32, 2)
    assert (plan.R, plan.tiles, plan.mma) == (16, 6, True)
    assert not launch_plan(32, 15, 5, 64, 16, 32, 4).mma   # fp32: FMA


@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
@pytest.mark.parametrize("Sq", [1, 16, 17, 300, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_fits_and_covers_every_row(Sq, Dh, dtype):
    plan = flash_plan(dtype, 2, Sq, 15, Dh)
    assert plan.smem <= SMEM_LIMIT
    assert plan.threads == 128
    tiles = plan.grid[1] if dtype == torch.bfloat16 else plan.grid[0]
    assert tiles * 64 >= Sq > (tiles - 1) * 64
    assert sorted(plan.grid) == sorted((tiles, 15, 2)) and plan.grid[2] == 2


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_at_the_new_archs(arch, dtype):
    """recurrentgemma-9b (16 query heads over one KV head, head_dim 256)
    and qwen3-moe-30b-a3b (32 over 4, head_dim 128) at their prompt
    bucket and at 4096 keys: the plan fits a block's shared memory. At
    head_dim 256 the bf16 kernel takes 64-key tiles in two stages (160
    KB); the 128-key tiles of the narrower heads would need 288 KB."""
    from repro_torch.kernels.flash_attention.ops import BF16_TILES
    cfg = get_config(arch)
    Dh = cfg.resolved_head_dim
    for Sq in (32, 2048, 4096):
        plan = flash_plan(dtype, 1, Sq, cfg.num_heads, Dh)
        assert plan.smem <= SMEM_LIMIT
    if Dh == 256:
        assert BF16_TILES[256] == (64, 2)
        assert flash_plan(torch.bfloat16, 1, 32, 16, 256).smem == \
            2 * (64 + 2 * 2 * 64) * 256 == 163840
        assert 2 * (64 + 2 * 2 * 128) * 256 > SMEM_LIMIT


# The bf16 backward kernel's per-thread registers (Bf16Bwd<D> in
# csrc/flash_attention_bwd.cu): whether dkdv keeps the K and V A fragments
# in registers and dq the q^ and dO ones, and the steps (query columns a
# warp forms in dkdv, keys in dq) whose S and dP accumulators (fp32) and
# packed bf16 P and dS fragments a thread holds besides its dK/dV or dQ
# accumulators.
KREG_MAX, QREG_MAX = 64, 128
DKDV_STEP = {32: 64, 64: 64, 128: 32, 256: 16}
DQ_STEP = {32: 32, 64: 32, 128: 64, 256: 32}
# the training and serving shapes, and ragged small ones
BWD_SHAPES = ((8, 1024, 15, 5), (4, 1024, 32, 4), (2, 4096, 16, 1),
              (1, 17, 8, 8), (3, 333, 16, 2))


def _bwd_registers(Dh):
    """fp32 accumulators plus register-held fragments of one thread in
    each product pass of the bf16 backward -> (dkdv, dq)."""
    from repro_torch.kernels.flash_attention.ops import BWD_KEY_WARPS
    def steps(n):               # S, dP in fp32; P, dS packed in bf16
        return 2 * 16 * n // 32 + 2 * 16 * n // 64
    frags = 2 * 16 * Dh // 64                   # two 16 x Dh bf16 tiles
    dkdv = 2 * 16 * (Dh // BWD_KEY_WARPS[Dh]) // 32 \
        + steps(DKDV_STEP[Dh]) + (frags if Dh <= KREG_MAX else 0)
    dq = 16 * Dh // 32 + steps(DQ_STEP[Dh]) \
        + (frags if Dh <= QREG_MAX else 0)
    return dkdv, dq


def _dkdv_visible_rows(t, Sq, Sk, window):
    """Query rows that see a key of causal key tile t (its block's work
    per query head)."""
    k0, kmax = 64 * t, min(64 * t + 64, Sk) - 1
    lo = max(0, k0 - (Sk - Sq))
    hi = min(Sq, kmax + window - (Sk - Sq)) if window else Sq
    return max(0, hi - lo)


@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
def test_backward_plan_fits_at_every_head_dim(Dh):
    """The backward kernel's plan. bf16: shared memory equals the
    kernel's formula (K and V tiles of 64 keys, then two stages of 64-row
    q^ and dO tiles with their lse and D rows for dK/dV; the q^ and dO
    tiles, then two stages of 64-key K and V tiles for dQ) and fits 227
    KB at every head_dim (at 256: 214,016, with the 16 KB in which the two
    warps that share each 16 keys trade their halves of P^T and dS^T,
    and 196,608 bytes); a thread's accumulators and register-held
    fragments take at most 232 of its 255 registers (at 256 each warp of a pair
    accumulates half of Dh: 128 registers, where one warp would need
    256); the grids
    cover every key and query row; dK/dV blocks go heaviest first (the
    kernel maps block (x, y) to KV head x % K, batch x // K, key tile y:
    causal, key tile 0 sees the most queries; with a window over Sq = Sk
    every tile sees a window's worth but the last) and visit every
    (batch, KV head, key tile) exactly once. fp32: the FMA kernel's plan,
    as before."""
    from repro_torch.kernels.flash_attention.ops import (
        BWD_KEY_WARPS, BWD_THREADS, BWD_TILES, bwd_launch_plan)
    tile = 2 * 64 * Dh
    for (B, S, H, K) in BWD_SHAPES:
        for Sq, Sk in ((S, S), (max(1, S // 3), S)):
            plan = bwd_launch_plan(torch.bfloat16, B, Sq, Sk, H, K, Dh)
            assert plan["dkdv"].smem == 2 * tile + 2 * (2 * tile + 4 * 128) \
                + (2 * 8 * 32 * 8 * 4 if Dh == 256 else 0)
            assert plan["dq"].smem == 2 * tile + 2 * 2 * tile
            for name in ("dkdv", "dq"):
                assert 0 < plan[name].smem <= SMEM_LIMIT, (name, plan[name])
            assert plan["dkdv"].threads == 128 * BWD_KEY_WARPS[Dh]
            assert plan["dq"].threads == 128
            assert plan["dkdv"].grid == (K * B, -(-Sk // 64), 1)
            assert plan["dq"].grid == (H * B, -(-Sq // 64), 1)
            assert (plan["dkdv"].grid[1] - 1) * 64 < Sk
            assert (plan["dq"].grid[1] - 1) * 64 < Sq
            assert plan["dot"].grid[0] * 256 >= B * Sq * H * (Dh // 8)
            x, y, _ = plan["dkdv"].grid
            order = [(xx // K, xx % K, yy) for yy in range(y)
                     for xx in range(x)]
            assert sorted(order) == [(b, kh, t) for b in range(B)
                                     for kh in range(K) for t in range(y)]
            for window in ((0, 2048, 100) if Sq == Sk else (0,)):
                work = [_dkdv_visible_rows(t, Sq, Sk, window)
                        for _, _, t in order]
                assert work == sorted(work, reverse=True), window
    dkdv_regs, dq_regs = _bwd_registers(Dh)
    assert 2 * 16 * (Dh // BWD_KEY_WARPS[Dh]) // 32 <= 128
    assert dkdv_regs <= 232 and dq_regs <= 232, (dkdv_regs, dq_regs)
    if Dh == 256:
        assert 2 * 16 * Dh // 32 == 256 > 255     # why two warps share
        assert bwd_launch_plan(torch.bfloat16, 1, 64, 64, 16, 1,
                               Dh)["dkdv"].smem == 214016
    BQ, BK = BWD_TILES[Dh]
    for (B, S, H, K) in BWD_SHAPES:
        plan = bwd_launch_plan(torch.float32, B, S, S, H, K, Dh)
        for name in ("dkdv", "dq"):
            assert plan[name].threads == BWD_THREADS == 256
            assert 0 < plan[name].smem <= SMEM_LIMIT, (name, plan[name])
        assert plan["dkdv"].grid == (-(-S // BK), K, B)
        assert plan["dq"].grid == (-(-S // BQ), H, B)
        assert plan["dot"].grid[0] * 8 >= B * S * H
        assert plan["dkdv"].smem == 4 * (
            2 * BK * (Dh + 1) + 2 * BQ * (Dh + 1) + 2 * BQ
            + 2 * BQ * (BK + 1))
    # per-thread register tiles of the fp32 kernel (BwdTiles<D>): the S
    # tile BQ x BK, dK/dV BK x Dh and dQ BQ x Dh each hold a whole number
    # of elements per thread, 16 or 32 fp32 accumulators at most
    for rows, cols in ((BQ, BK), (BK, Dh), (BQ, Dh)):
        per = rows * cols / BWD_THREADS
        assert per == int(per) and 1 <= per <= 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_scratch_shapes(dtype):
    """The backward's scratch (from torch.empty): D [B, H, Sq] in fp32,
    and for bf16 a q^ buffer of q's shape and dtype (the dot pass writes
    round(q * scale) there for the cp.async ring); fp32 needs none."""
    from repro_torch.kernels.flash_attention.ops import bwd_scratch
    q = torch.zeros((2, 37, 6, 64), dtype=dtype)
    dvec, qhat = bwd_scratch(q)
    assert dvec.shape == (2, 6, 37) and dvec.dtype == torch.float32
    if dtype == torch.bfloat16:
        assert qhat.shape == q.shape and qhat.dtype == torch.bfloat16
        assert qhat.data_ptr() != q.data_ptr()
    else:
        assert qhat is None


def test_ptxas_report_reads_registers_and_spills():
    """`_build.ptxas_report` over a build log in the form nvcc 12.8's
    `-Xptxas -v` writes (the lines phase 9 reads to fail on a spilling
    backward kernel): one entry per kernel, in order."""
    from repro_torch.kernels._build import ptxas_report
    log = """== flash_attention_bwd.cu (rc 0)
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120bwd_dkdv_bf16_kernelILi256EEEvPKS' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120bwd_dkdv_bf16_kernelILi256EEEvPKS
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113bwd_dq_kernelILi64EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113bwd_dq_kernelILi64EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers
"""
    got = ptxas_report(log)
    assert [r["kernel"] for r in got] == [
        "_ZN12_GLOBAL__N_120bwd_dkdv_bf16_kernelILi256EEEvPKS",
        "_ZN12_GLOBAL__N_113bwd_dq_kernelILi64EEEvPKf"]
    assert [(r["registers"], r["spill_stores"], r["spill_loads"],
             r["stack"]) for r in got] == [(255, 8, 12, 8), (118, 0, 0, 0)]
