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


@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
def test_backward_plan_fits_at_every_head_dim(Dh):
    """The backward kernel's plan: dK and dV accumulate in registers, so a
    block's shared memory holds fp32 K, V, q^ and dO tiles, P and dS and
    two row vectors, within 227 KB at every head_dim (at 256 with 32 x 16
    tiles: 64-key fp32 tiles of K, V, dK and dV alone would be 256 KB);
    the grids cover every key and query row; each product's register
    tile splits its block's output over the 256 threads exactly."""
    from repro_torch.kernels.flash_attention.ops import (
        BWD_THREADS, BWD_TILES, bwd_launch_plan)
    BQ, BK = BWD_TILES[Dh]
    assert 4 * 4 * 64 * Dh > SMEM_LIMIT or Dh < 256
    for (B, S, H, K) in ((8, 1024, 15, 5), (4, 1024, 32, 4),
                         (2, 4096, 16, 1), (1, 17, 8, 8)):
        plan = bwd_launch_plan(B, S, S, H, K, Dh)
        for name in ("dkdv", "dq"):
            assert plan[name].threads == BWD_THREADS == 256
            assert 0 < plan[name].smem <= SMEM_LIMIT, (name, plan[name])
        assert plan["dkdv"].grid == (-(-S // BK), K, B)
        assert plan["dq"].grid == (-(-S // BQ), H, B)
        assert plan["dot"].grid[0] * 8 >= B * S * H
        assert plan["dkdv"].smem == 4 * (
            2 * BK * (Dh + 1) + 2 * BQ * (Dh + 1) + 2 * BQ
            + 2 * BQ * (BK + 1))
    # per-thread register tiles (BwdTiles<D> in the kernel): the S tile
    # BQ x BK, dK/dV BK x Dh and dQ BQ x Dh each hold a whole number of
    # elements per thread, 16 or 32 fp32 accumulators at most
    for rows, cols in ((BQ, BK), (BK, Dh), (BQ, Dh)):
        per = rows * cols / BWD_THREADS
        assert per == int(per) and 1 <= per <= 32
