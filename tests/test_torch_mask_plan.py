"""masked_logits's launch planning, pure Python (no card needed).

`launch_plan(N, V, W, A, dtype, aligned)` picks the kernel's path (16-byte
accesses or one element at a time), its vocab tile and its threads. The
plan must stay inside what the kernel takes (the checks of
`masked_logits_plan_smem` in `csrc/masked_logits.cu`, restated here), take
the vector path exactly when the pointers are 16-byte aligned, a row is a
whole number of 16-byte groups and a store row a whole number of uint4
word groups, fill the card's 132 SMs at one row, and keep the block count
bounded at many rows.
"""
import pytest
import torch

from repro_torch.kernels.masked_logits.ops import (MAX_IDS, MAX_TILE, SMS,
                                                   THREADS, UNION_BUDGET,
                                                   launch_plan)

GRID_Y = 65535                  # CUDA's limit on gridDim.y (the tiles)
GRID_X = 2 ** 31 - 1            # and on gridDim.x (the rows)
SMEM_LIMIT = 48 * 1024 - 4 * 1024 - 512 - 16   # dynamic smem, no opt-in


def _elem(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _kernel_takes(plan, N, V, W, A, dtype):
    """The kernel's own checks of a plan (plan_smem in the source)."""
    unit = 128 if plan.vec else 32
    per_access = 16 // _elem(dtype) if plan.vec else 1
    max_per = 8 if plan.vec else 32
    tile = plan.tile
    return (unit <= tile <= MAX_TILE and tile & (tile - 1) == 0
            and tile // unit <= plan.threads <= 256
            and plan.threads % 32 == 0
            and _pow2_at_least(-(-(tile // per_access) // plan.threads))
            <= max_per
            and plan.grid == (N, -(-V // tile))
            and plan.grid[0] <= GRID_X and plan.grid[1] <= GRID_Y
            and plan.smem == 4 * A <= 4 * MAX_IDS <= SMEM_LIMIT)


@pytest.mark.parametrize("A", [1, 48, 384, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 8, 64, 4096])
@pytest.mark.parametrize("V", [1000, 2080, 32000, 49152, 151936])
def test_plan_within_the_kernel_limits(V, N, dtype, A):
    W = -(-V // 32)
    plan = launch_plan(N, V, W, A, dtype)
    assert _kernel_takes(plan, N, V, W, A, dtype)
    assert plan.threads <= THREADS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,W,aligned", [
    (49152, 1536, True), (1000, 32, True), (32000, 1000, True),
    (49152, 1537, True),            # store rows padded to W % 4 != 0
    (2080, 65, True),               # W = 65
    (1001, 32, True),               # a row is not whole 16-byte groups
    (49152, 1536, False),           # an offset pointer
    (1000, 32, False)])
def test_vector_path_only_on_aligned_shapes(V, W, aligned, dtype):
    plan = launch_plan(4, V, W, 48, dtype, aligned)
    want = aligned and (V * _elem(dtype)) % 16 == 0 and W % 4 == 0
    assert plan.vec == want
    assert _kernel_takes(plan, 4, V, W, 48, dtype)
    assert plan.tile % (128 if plan.vec else 32) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_path_cases(dtype):
    """V = 2080 (65 store words), an odd V, and a logits view one element
    past an aligned start take the scalar path. (V = 1000 is whole 16-byte
    groups in both dtypes with W = 32: it takes the vector path with a
    ragged last tile.)"""
    assert not launch_plan(3, 2080, 65, 48, dtype).vec
    assert not launch_plan(3, 1001, 32, 48, dtype).vec
    assert not launch_plan(3, 49152, 1536, 48, dtype, False).vec
    plan = launch_plan(3, 1000, 32, 48, dtype)
    assert plan.vec and 1000 % plan.tile != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_row_fills_the_card(dtype):
    plan = launch_plan(1, 49152, 1536, 48, dtype)
    blocks = plan.grid[0] * plan.grid[1]
    assert blocks >= SMS == 132
    # the largest tile that does: half of it would be a second wave
    assert plan.grid[0] * -(-49152 // (2 * plan.tile)) < SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_many_rows_launch_full_tiles(dtype):
    """The span at the engine's bucket (B*K = 64 rows, A = 48) launches
    768 blocks of MAX_TILE entries, not thousands of small ones."""
    plan = launch_plan(64, 49152, 1536, 48, dtype)
    assert plan.tile == MAX_TILE
    assert plan.grid == (64, 12)
    assert plan.grid[0] * plan.grid[1] <= 1024
    plan = launch_plan(8, 49152, 1536, 48, dtype)
    assert plan.grid[0] * plan.grid[1] >= SMS


@pytest.mark.parametrize("A", [48, 96, 192, 384, 768, 8192])
@pytest.mark.parametrize("N", [1, 8, 64])
def test_wide_accept_sets_take_smaller_tiles(N, A):
    """A block's union reads at most UNION_BUDGET tokens of store rows
    (A ids x tile) unless the tile is already one union access, and the
    tile is never smaller than that or than the SM rule asks."""
    plan = launch_plan(N, 49152, 1536, A, torch.bfloat16)
    assert A * plan.tile <= UNION_BUDGET or plan.tile == 128
    bigger = 2 * plan.tile
    assert bigger > MAX_TILE or A * bigger > UNION_BUDGET or \
        N * -(-49152 // bigger) < SMS
    assert launch_plan(64, 49152, 1536, 384, torch.bfloat16).tile == 2048


def test_plan_is_cached():
    a = launch_plan(8, 49152, 1536, 48, torch.bfloat16)
    assert launch_plan(8, 49152, 1536, 48, torch.bfloat16) is a
