"""The port's routed MoE FFN (`repro_torch.models.moe`) against the
reference's (`repro.models.moe`) on the same weights: the reference's
`init_moe` params, bridged leaf by leaf, on a reduced qwen3-moe config
(4 experts, top-2).

Checked: the output and the aux losses at the default capacity, at a
capacity factor low enough that pairs are dropped (the kept set must be
the reference's: a pair kept on one side and dropped on the other moves
the output by O(1)), with two experts whose router columns are equal so
that their probabilities tie on every token (top-k must break the tie by
the lower expert index, as `jax.lax.top_k` does), in fp32 and bf16; and
a model with `first_dense_layers = 1` (a dense group before the MoE
group) through prefill and decode.

Tolerances as in tests/test_torch_model.py: fp32 within atol 1e-4 plus
rtol 2e-6 (matrix sums in another order), bf16 within atol 2**-3 (both
sides round at the same points; the expert products and the k-way sum
in bf16 differ only in fp32 summation order)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model as torch_build_model

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-4, rtol=2e-6),
       "bfloat16": dict(atol=2.0 ** -3, rtol=0)}


def _cfgs(dtype, **over):
    cfg = replace(get_config("qwen3-moe-30b-a3b").reduced(), dtype=dtype,
                  **over)
    tcfg = replace(torch_get_config("qwen3-moe-30b-a3b").reduced(),
                   dtype=dtype, **over)
    return cfg, tcfg


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL[dtype])


def _run(dtype, S=16, tie=False, **over):
    cfg, tcfg = _cfgs(dtype, **over)
    jp = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(3), cfg,
                                              jnp.dtype(dtype)))
    if tie:
        jp["router"][:, 2] = jp["router"][:, 1]
    rng = np.random.default_rng(0)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, S, cfg.d_model)),
                               jnp.dtype(dtype)))
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            cfg)
    ty, taux = tmoe.moe_ffn(bridge.to_torch(jp), bridge.leaf_to_torch(x),
                            tcfg)
    assert ty.dtype == bridge.leaf_to_torch(x).dtype
    _close(ty, jy, dtype, "moe output")
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5, err_msg=name)
    return cfg, jp, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype):
    _run(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
def test_dropped_pairs_match_reference(dtype, tie):
    """64 tokens x top-2 over 4 experts at capacity factor 0.25: C = 8
    slots per expert for an average load of 32, so most pairs drop."""
    cfg, jp, x = _run(dtype, S=64, tie=tie, moe_capacity_factor=0.25)
    C = jmoe.capacity(cfg, 64)
    assert C == tmoe.capacity(cfg, 64) == 8
    logits = x.astype(np.float32) @ jp["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :2]
    load = np.stack([np.bincount(r.ravel(), minlength=4) for r in top])
    assert load.max() > C                       # pairs were dropped
    if tie:                                     # the tie decides the order
        assert (np.sort(top, -1) == [1, 2]).all(-1).any()


def test_topk_ties_break_by_lower_index():
    """Equal probabilities: the lower expert index comes first, so it
    takes the earlier slot position."""
    cfg, tcfg = _cfgs("float32", moe_capacity_factor=0.25)
    p = bridge.to_torch(jax.tree.map(np.array, jmoe.init_moe(
        jax.random.PRNGKey(1), cfg, jnp.float32)))
    p["router"].zero_()                         # every expert ties
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    jy, _ = jmoe.moe_ffn(jax.tree.map(jnp.asarray, bridge.to_numpy(p)),
                         jnp.asarray(x.numpy()), cfg)
    ty, _ = tmoe.moe_ffn(p, x, tcfg)
    _close(ty, jy, "float32", "all-tied routing")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_dense_layer_model_matches_reference(dtype):
    """num_layers 2 with first_dense_layers 1: groups (attn x 1, moe x
    1); prefill logits and caches, then decode steps."""
    cfg, tcfg = _cfgs(dtype, first_dense_layers=1)
    jm = jax_build_model(cfg)
    tm = torch_build_model(tcfg, device="cpu")
    assert [g for g, _ in tm_groups(tm)] == [("attn",), ("moe",)]
    np_params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = bridge.to_torch(np_params)
    rng = np.random.default_rng(1)
    toks = rng.integers(3, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])},
                        cache_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :10])},
                        cache_len=24)
    _close(tl, jl, dtype, "prefill logits")
    pos = np.array([10, 10], np.int32)
    for step in range(3):
        tok = toks[:, 10 + step]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, _ = tm.decode_step(tp, tc, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        _close(tl, jl, dtype, f"decode logits, step {step}")
        for tg, jg in zip(tc, jc):
            np.testing.assert_array_equal(tg[0]["kv_pos"].numpy(),
                                          np.asarray(jg[0]["kv_pos"]))
            _close(tg[0]["k"], jg[0]["k"], dtype, "k cache")
        pos = pos + 1


def tm_groups(model):
    from repro_torch.models.model import layer_groups
    return layer_groups(model.cfg)
