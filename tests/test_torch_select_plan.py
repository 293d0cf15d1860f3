"""fused_select's launch planning, pure Python (no card needed).

For vocabularies from 512 to 393216 entries (the wrapper's limit of 12288
union words), both logit dtypes and 1, 48 or 96 accepted rows, the plan
must fit a Hopper block's shared memory (227 KB), hold a candidate list
of at least 1024 entries (far above the served top_k of 40 and its ties),
send every row whose top_k the list cannot hold to the radix route, and
ask for the shared memory its parts add up to.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_select.ops import (BINS, MAX_WORDS, THREADS,
                                                  launch_plan)

SMEM_LIMIT = 227 * 1024         # a Hopper block's shared memory


@pytest.mark.parametrize("A", [1, 48, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [512, 2048, 49152, 151936, 393216])
def test_select_plan_fits_and_routes(V, dtype, A):
    W = V // 32
    assert W <= MAX_WORDS
    plan = launch_plan(V, W, dtype)
    assert plan.smem <= SMEM_LIMIT
    assert plan.threads == THREADS == 1024
    assert plan.cap >= 1024
    # list (fp32 key + int32 index), 12-bit histogram, union words; the
    # accepted rows are ORed into the union in place and take no room
    assert plan.smem == 8 * plan.cap + 4 * BINS + 4 * W
    assert BINS == 1 << 12
    assert plan == launch_plan(V, W, dtype)    # A plays no part
    assert plan.list_route(40) == (40 < V)
    assert not plan.list_route(plan.cap + 1)
    assert not plan.list_route(0) and not plan.list_route(-1)
    assert not plan.list_route(V) and not plan.list_route(V + 5)
    assert plan.list_route(min(plan.cap, V - 1))


def test_select_plan_largest_union_fits():
    """A store padded to the most union words the kernel takes."""
    plan = launch_plan(32, MAX_WORDS, torch.bfloat16)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [50280, 151936, 256000, 520])
def test_select_plan_vocab_not_a_multiple_of_32(V, dtype):
    """mamba2-370m's V = 50280 (V % 32 = 8): the store keeps (V + 31) //
    32 words per row. The kernel's 16-byte accesses tile the row exactly
    (V % vec == 0), each lies inside one union word, and the last word
    covers the tail's V % 32 tokens."""
    W = (V + 31) // 32
    plan = launch_plan(V, W, dtype)
    assert plan.vec == (8 if dtype == torch.bfloat16 else 4)
    assert V % plan.vec == 0
    starts = np.arange(0, V, plan.vec)
    assert ((starts % 32) + plan.vec <= 32).all()      # one word each
    assert starts[-1] // 32 == W - 1                     # the tail word
    assert plan.tail == V - 32 * (W - 1) == (V % 32 or 32)
    assert plan.smem == 8 * plan.cap + 4 * BINS + 4 * W <= SMEM_LIMIT


@pytest.mark.parametrize("V,W", [(50276, 1572), (50281, 1572), (4, 1),
                                 (50280, 1571), (32 * (MAX_WORDS + 1),
                                                 MAX_WORDS + 1)])
def test_select_plan_refuses_what_the_kernel_does_not_take(V, W):
    """A row that is not a whole number of 16-byte groups of bf16, a
    store too narrow for V, or more union words than the kernel holds."""
    with pytest.raises(ValueError):
        launch_plan(V, W, torch.bfloat16)
