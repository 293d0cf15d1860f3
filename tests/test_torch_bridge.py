"""Weight bridge between the JAX package and the PyTorch port: every leaf
of the reference's param and cache trees round-trips bitwise (fp32 and
bf16), and the port's own init draws the same tree of shapes, dtypes and
scales."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.model import build_model as torch_build_model


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_caches_round_trip_bitwise(dtype):
    cfg = replace(get_config("syncode-demo"), dtype=dtype)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    caches = model.init_decode_caches(2, 16)
    for tree in (params, caches):
        np_tree = jax.tree.map(np.asarray, tree)
        back = bridge.to_numpy(bridge.to_torch(np_tree))
        orig = _leaves(np_tree)
        got = _leaves(back)
        assert [p for p, _ in orig] == [p for p, _ in got]
        for (path, a), (_, b) in zip(orig, got):
            if a.dtype == jnp.bfloat16:
                assert b.dtype == np.uint16, path
                np.testing.assert_array_equal(a.view(np.uint16), b)
                np.testing.assert_array_equal(
                    np.asarray(b.view(jnp.bfloat16), np.float32),
                    np.asarray(a, np.float32))
            else:
                assert b.dtype == a.dtype, path
                np.testing.assert_array_equal(a, b)


def test_bf16_leaf_lands_as_torch_bf16():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = bridge.leaf_to_torch(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_matches_reference_tree(dtype):
    """Model.init(generator) gives the reference's tree: same paths,
    shapes and dtypes, normal x 1/sqrt(fan_in) weights, unit embedding
    scale, ones for norms."""
    cfg = replace(get_config("syncode-demo"), dtype=dtype)
    ref = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    tcfg = replace(torch_get_config("syncode-demo"), dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    got = torch_build_model(tcfg, device="cpu").init(gen)
    rl, gl = _leaves(ref), _leaves(got)
    assert [jax.tree_util.keystr(p) for p, _ in rl] == \
        [jax.tree_util.keystr(p) for p, _ in gl]
    for (path, r), (_, g) in zip(rl, gl):
        assert tuple(g.shape) == tuple(r.shape), path
        assert g.dtype == getattr(torch, str(r.dtype)), path
    flat = {jax.tree_util.keystr(p): t.float() for p, t in gl}
    D = cfg.d_model
    assert abs(flat["['embed_block']['embed']"].std().item() - 1.0) < 0.02
    assert abs(flat["['groups'][0][0]['attn']['wq']"].std().item()
               * D ** 0.5 - 1.0) < 0.02
    assert abs(flat["['groups'][0][0]['ffn']['w_down']"].std().item()
               * cfg.d_ff ** 0.5 - 1.0) < 0.02
    assert bool((flat["['groups'][0][0]['ln1']"] == 1).all())
