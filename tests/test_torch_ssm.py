"""The port's Mamba2 / SSD block (`repro_torch.models.ssm`) against the
reference's (`repro.models.ssm`) on the same weights: the reference's
`init_ssm` params, bridged leaf by leaf, on a reduced mamba2-370m config
(d_model 256, state 32, head_dim 32, chunk 32). The leaves that init
leaves constant (A_log, D, dt_bias, conv_b) get random values so that
every term of the recurrence is exercised.

Checked: `ssm_prefill` at S < chunk (one chunk of S), S = chunk and S =
2 x chunk (two chunks: the inter-chunk recurrence), and S shorter than
the conv history; then several `ssm_decode` steps against the prefill
cache. The output and the `h` / `conv` caches are compared each time.
The reference's `S % Q == 0` assert is kept: a prompt longer than a
chunk that is not a whole number of chunks raises on both sides.

Tolerances as in tests/test_torch_model.py: fp32 within atol 1e-4 plus
rtol 2e-6 (the SSD products sum in another order), bf16 within atol
2**-3. In a bf16 run the fp32 `h` cache is held to the bf16 tolerance
too: it sums products of bf16 activations, and XLA may keep an
elementwise chain (the depthwise conv, SiLU) in fp32 where torch rounds
each step to bf16, so its inputs differ by bf16 ulps."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-4, rtol=2e-6),
       "bfloat16": dict(atol=2.0 ** -3, rtol=0)}


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL[dtype])


def _setup(dtype):
    cfg = replace(get_config("mamba2-370m").reduced(), dtype=dtype)
    tcfg = replace(torch_get_config("mamba2-370m").reduced(), dtype=dtype)
    jp = jax.tree.map(np.array, jssm.init_ssm(jax.random.PRNGKey(2), cfg,
                                              jnp.dtype(dtype)))
    rng = np.random.default_rng(5)
    jp["A_log"] = rng.normal(scale=0.5, size=jp["A_log"].shape).astype(
        np.float32)
    jp["D"] = rng.normal(size=jp["D"].shape).astype(np.float32)
    jp["dt_bias"] = rng.normal(scale=0.5, size=jp["dt_bias"].shape).astype(
        np.float32)
    jp["conv_b"] = np.asarray(jnp.asarray(
        rng.normal(scale=0.3, size=jp["conv_b"].shape), jnp.dtype(dtype)))
    return cfg, tcfg, jp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 13, 32, 64])
def test_prefill_then_decode_match_reference(dtype, S):
    cfg, tcfg, jp = _setup(dtype)
    assert cfg.ssm_chunk == 32
    jpj, tp = jax.tree.map(jnp.asarray, jp), bridge.to_torch(jp)
    rng = np.random.default_rng(S)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, S + 4, cfg.d_model)),
                               jnp.dtype(dtype)))
    tx = bridge.leaf_to_torch(x)
    jy, jc = jssm.ssm_prefill(jpj, jnp.asarray(x[:, :S]), cfg)
    ty, tc = tssm.ssm_prefill(tp, tx[:, :S], tcfg)
    _close(ty, jy, dtype, "prefill output")
    _close(tc["h"], jc["h"], dtype, "h cache")
    _close(tc["conv"], jc["conv"], dtype, "conv cache")
    for step in range(4):
        jy, jc = jssm.ssm_decode(jpj, jnp.asarray(x[:, S + step:S + step + 1]),
                                 jc, cfg)
        ty, tc2 = tssm.ssm_decode(tp, tx[:, S + step:S + step + 1], tc,
                                  tcfg)
        assert tc2 is tc                        # written in place
        _close(ty, jy, dtype, f"decode output, step {step}")
        _close(tc["h"], jc["h"], dtype, f"h cache, step {step}")
        _close(tc["conv"], jc["conv"], dtype, f"conv cache, step {step}")


def test_cache_shapes_and_chunk_assert_match_reference():
    cfg, tcfg, jp = _setup("float32")
    jc = jssm.init_ssm_cache(cfg, 3, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 3, torch.float32, "cpu", lead=(2,))
    for name in ("h", "conv"):
        assert tuple(tc[name].shape) == (2, *jc[name].shape)
        assert str(tc[name].dtype)[6:] == str(jc[name].dtype)
    x = np.zeros((1, 40, cfg.d_model), np.float32)   # 40 % 32 != 0
    with pytest.raises(AssertionError):
        jssm.ssm_prefill(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), cfg)
    with pytest.raises(AssertionError):
        tssm.ssm_prefill(bridge.to_torch(jp), torch.from_numpy(x), tcfg)
