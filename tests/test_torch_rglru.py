"""The port's RG-LRU block (`repro_torch.models.rglru`) against the
reference's (`repro.models.rglru`) on the same weights: the reference's
`init_rglru` params, bridged leaf by leaf, on a reduced
recurrentgemma-9b config (d_model 256, lru_width 256). The gate biases,
the conv bias and lambda (constant at init) get random values.

Checked: `rglru_prefill` (the port's log-depth scan against the
reference's `lax.associative_scan`) at lengths that are and are not
powers of two and shorter than the conv history, then several
`rglru_decode` steps against the prefill cache, output and `h` / `conv`
caches each time; the scan alone against a sequential loop in float64;
and the tanh-approximate GeLU.

Tolerances as in tests/test_torch_model.py: fp32 within atol 1e-4 plus
rtol 2e-6 (the scan associates its products in another order), bf16
within atol 2**-3. In a bf16 run the fp32 `h` cache is held to the bf16
tolerance too: its inputs are bf16 products, which XLA and torch round
at different points (XLA may keep a fused elementwise chain in fp32)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import rglru as jrg
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import rglru as trg

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-4, rtol=2e-6),
       "bfloat16": dict(atol=2.0 ** -3, rtol=0)}


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL[dtype])


def _setup(dtype):
    cfg = replace(get_config("recurrentgemma-9b").reduced(), dtype=dtype)
    tcfg = replace(torch_get_config("recurrentgemma-9b").reduced(),
                   dtype=dtype)
    jp = jax.tree.map(np.array, jrg.init_rglru(jax.random.PRNGKey(4), cfg,
                                               jnp.dtype(dtype)))
    rng = np.random.default_rng(6)
    for name in ("b_a", "b_i"):
        jp[name] = rng.normal(size=jp[name].shape).astype(np.float32)
    jp["lam"] = rng.uniform(-1.0, 2.0, size=jp["lam"].shape).astype(
        np.float32)
    jp["conv_b"] = np.asarray(jnp.asarray(
        rng.normal(scale=0.3, size=jp["conv_b"].shape), jnp.dtype(dtype)))
    return cfg, tcfg, jp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 16, 25])
def test_prefill_then_decode_match_reference(dtype, S):
    cfg, tcfg, jp = _setup(dtype)
    jpj, tp = jax.tree.map(jnp.asarray, jp), bridge.to_torch(jp)
    rng = np.random.default_rng(S)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, S + 4, cfg.d_model)),
                               jnp.dtype(dtype)))
    tx = bridge.leaf_to_torch(x)
    jy, jc = jrg.rglru_prefill(jpj, jnp.asarray(x[:, :S]), cfg)
    ty, tc = trg.rglru_prefill(tp, tx[:, :S], tcfg)
    _close(ty, jy, dtype, "prefill output")
    _close(tc["h"], jc["h"], dtype, "h cache")
    _close(tc["conv"], jc["conv"], dtype, "conv cache")
    for step in range(4):
        xs = x[:, S + step:S + step + 1]
        jy, jc = jrg.rglru_decode(jpj, jnp.asarray(xs), jc, cfg)
        ty, tc2 = trg.rglru_decode(tp, tx[:, S + step:S + step + 1], tc,
                                   tcfg)
        assert tc2 is tc                        # written in place
        _close(ty, jy, dtype, f"decode output, step {step}")
        _close(tc["h"], jc["h"], dtype, f"h cache, step {step}")
        _close(tc["conv"], jc["conv"], dtype, f"conv cache, step {step}")


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_log_depth_scan_equals_sequential_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, size=(2, S, 8)))
    b = torch.from_numpy(rng.normal(size=(2, S, 8)))
    h, want = torch.zeros(2, 8, dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(trg.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12,
                               atol=1e-12)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               atol=1e-6)
    cfg, tcfg, _ = _setup("float32")
    jc = jrg.init_rglru_cache(cfg, 3, jnp.float32)
    tc = trg.init_rglru_cache(tcfg, 3, torch.float32, "cpu")
    for name in ("h", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
