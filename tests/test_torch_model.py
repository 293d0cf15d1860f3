"""The port's dense model (`repro_torch.models`) against the reference's
(`repro.models`) with the same weights: the reference's
`Model.init(PRNGKey(0))` params, bridged leaf by leaf.

Checked: prefill logits over a bucket-padded prompt (`true_len`), the
prefill caches, then several decode steps against those caches (per-row
positions, a ring cache under a sliding window, `feed_mask`-gated
writes), and the components of `models/common.py` one by one.

Tolerances: fp32 logits and caches within atol 1e-4 plus rtol 2e-6 (the
frameworks sum matrix products in different orders; the relative term
covers the tied-embedding logits of smollm-360m, which reach ~160, where
fp32's own spacing is 1.5e-5). bf16 logits within atol 2**-3,
four bf16 ulps at the logits' largest magnitude (about 5): both sides
round at the same points (rms_norm's inverse, RoPE's cast back, q's
scale, P before P.V), so only the order of the fp32 sums feeding those
roundings differs. `kv_pos` must be equal."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import common as jcommon
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import common as tcommon
from repro_torch.models.model import build_model as torch_build_model

TOL = {"float32": dict(atol=1e-4, rtol=2e-6),
       "bfloat16": dict(atol=2.0 ** -3, rtol=0)}


def _pair(arch, dtype, reduced=False, **over):
    """-> (jax model, jax params, port model, port params) with the
    reference's weights; biases (zero at init) get random values so the
    bias path is exercised."""
    cfg = get_config(arch)
    tcfg = torch_get_config(arch)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    cfg = replace(cfg, dtype=dtype, **over)
    tcfg = replace(tcfg, dtype=dtype, **over)
    jm = jax_build_model(cfg)
    np_params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv"):
        attn = np_params["groups"][0][0]["attn"]
        if name in attn:
            attn[name] = np.asarray(jnp.asarray(
                rng.normal(size=attn[name].shape) * 0.3, attn[name].dtype))
    jparams = jax.tree.map(jnp.asarray, np_params)
    return (jm, jparams, torch_build_model(tcfg, device="cpu"),
            bridge.to_torch(np_params))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dtype, what):
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=what,
                               **TOL[dtype])


def _assert_caches(tc, jc, dtype):
    for tg, jg in zip(tc, jc):
        for t, j in zip(tg, jg):
            np.testing.assert_array_equal(t["kv_pos"].numpy(),
                                          np.asarray(j["kv_pos"]))
            _close(t["k"], j["k"], dtype, "k cache")
            _close(t["v"], j["v"], dtype, "v cache")


# (arch, dtype, reduced, config overrides)
CONFIGS = [
    ("syncode-demo", "float32", False, {}),
    ("syncode-demo", "bfloat16", False, {}),
    ("smollm-360m", "float32", True, {}),            # tied embeddings
    ("syncode-demo", "float32", False, {"sliding_window": 8}),
    ("syncode-demo", "float32", False, {"qkv_bias": True}),
]


@pytest.mark.parametrize("arch,dtype,reduced,over", CONFIGS,
                         ids=lambda c: str(c))
def test_prefill_then_decode_match_reference(arch, dtype, reduced, over):
    jm, jp, tm, tp = _pair(arch, dtype, reduced, **over)
    V = jm.cfg.vocab_size
    rng = np.random.default_rng(0)
    B, S, n, cache_len = 2, 16, 11, 32
    toks = rng.integers(3, V, size=(B, S + 4)).astype(np.int32)
    prompt = toks[:, :S].copy()
    prompt[:, n:] = 0                          # bucket padding
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)},
                        cache_len=cache_len, true_len=n)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                        cache_len=cache_len, true_len=n)
    _close(tl, jl, dtype, "prefill logits")
    _assert_caches(tc, jc, dtype)

    pos = np.array([n, n - 3], np.int32)        # per-row positions
    for step in range(3):
        tok = toks[:, n + step]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert tc2 is tc                        # written in place
        _close(tl, jl, dtype, f"decode logits, step {step}")
        _assert_caches(tc, jc, dtype)
        pos = pos + 1


def test_feed_mask_gates_decode_writes():
    """feed_mask [B, 1] False leaves a row's cache slot untouched, as the
    reference's span decode does (decode_span with S = 1)."""
    jm, jp, tm, tp = _pair("syncode-demo", "float32")
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 2048, size=(2, 8)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=16)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                       cache_len=16)
    tok = np.array([5, 9], np.int32)
    pos = np.array([8, 8], np.int32)
    feed = np.array([[True], [False]])
    jl, jc = jm.decode_span(jp, jc, jnp.asarray(tok[:, None]),
                            jnp.asarray(pos), feed_mask=jnp.asarray(feed))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                            torch.from_numpy(pos),
                            batch_ctx={"feed_mask": torch.from_numpy(feed)})
    _close(tl, jl[:, 0], "float32", "logits")
    _assert_caches(tc, jc, "float32")
    assert int(tc[0][0]["kv_pos"][0, 1, 8]) == -1     # row 1 not written


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_common_components_match_reference(dtype):
    rng = np.random.default_rng(4)
    jdt = jnp.dtype(dtype)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 5, 64)) * 3, jdt))
    w = np.asarray(jnp.asarray(rng.normal(size=(64,)), jdt))
    tx, tw = bridge.leaf_to_torch(x), bridge.leaf_to_torch(w)
    _close(tcommon.rms_norm(tx, tw, 1e-5),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), dtype,
           "rms_norm")
    q = np.asarray(jnp.asarray(rng.normal(size=(2, 5, 4, 32)), jdt))
    positions = np.arange(3, 8, dtype=np.int32)[None, :].repeat(2, 0)
    _close(tcommon.apply_rope(bridge.leaf_to_torch(q),
                              torch.from_numpy(positions), 10000.0),
           jcommon.apply_rope(jnp.asarray(q), jnp.asarray(positions),
                              10000.0), dtype, "apply_rope")
    np.testing.assert_allclose(tcommon.rope_frequencies(32, 10000.0),
                               np.asarray(jcommon.rope_frequencies(
                                   32, 10000.0)), rtol=1e-6)
