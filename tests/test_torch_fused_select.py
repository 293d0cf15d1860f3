"""The port's fused mask + filter + sample (`repro_torch.kernels.fused_select`,
plain version on the CPU) against the reference's Pallas kernel
(`fused_select(interpret=True)`) and its jnp ref (`fused_select_ref`), on
the same numpy inputs.

Tolerance: none. `masked` and the ids must be bitwise equal, greedy and
sampled; `ok` must equal `any(masked > -5e29)` of the reference. Sampled
ids agree bitwise because both sides get the same Gumbel noise (drawn by
JAX from the same keys). The inputs are kept away from the nucleus edge:
a row whose cumulative softmax lands within 1e-5 of top_p gets its top_p
moved to the middle of the gap around it, because there the order of the
cumulative sum (which differs between the frameworks) may cut one token
differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_select.kernel import fused_select as jax_kernel
from repro.kernels.fused_select.ref import fused_select_ref as jax_ref
from repro.kernels.fused_select.ref import gumbel_noise as jax_gumbel
from repro.kernels.masked_logits.ref import masked_logits_ref as jax_mask
from repro_torch.kernels.fused_select import ops
from repro_torch.kernels.masked_logits.ref import masked_logits_ref

EDGE = 1e-5


def _off_edge(scaled, top_k, top_p):
    """-> top_p with every row moved EDGE away from the cumulative
    softmax of its sorted, top-k-filtered row (float64 on the host)."""
    top_p = top_p.copy()
    for b, (row, k, p) in enumerate(zip(scaled, top_k, top_p)):
        if p >= 1.0:
            continue
        srt = np.sort(row.astype(np.float64))[::-1]
        if 0 < k < row.size:
            row = np.where(row < srt[k - 1], -1e30, row)
            srt = np.sort(row.astype(np.float64))[::-1]
        e = np.exp(srt - srt[0])
        cum = np.cumsum(e / e.sum())
        if np.abs(cum - p).min() > EDGE:
            continue
        i = int(np.searchsorted(cum, p))
        lo = cum[i - 1] if i > 0 else 0.0
        top_p[b] = np.float32((lo + cum[min(i, cum.size - 1)]) / 2)
        assert np.abs(cum - top_p[b]).min() > EDGE, "no room off the edge"
    return top_p


def _inputs(seed, B, V, R, A, dtype=np.float32):
    """The reference test's random step (test_fused_select._step_inputs)
    as numpy, plus the disable edges of top-k (k >= V) and top-p (1.0)."""
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 2 ** 32, size=(R, V // 32), dtype=np.uint32)
    rows = rng.integers(-1, R, size=(B, A)).astype(np.int32)
    cd = rng.integers(0, 2 ** 32, size=(B, V // 32), dtype=np.uint32)
    cd[rng.random(B) < 0.5] = 0
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    eos = rng.integers(0, 2, size=(B,)).astype(bool)
    cons = rng.integers(0, 2, size=(B,)).astype(bool)
    greedy = rng.integers(0, 2, size=(B,)).astype(bool)
    temp = rng.uniform(0.4, 1.6, size=(B,)).astype(np.float32)
    top_k = rng.integers(0, 12, size=(B,)).astype(np.int32)
    top_p = rng.uniform(0.5, 1.2, size=(B,)).astype(np.float32)
    top_k[0], top_p[-1] = V + 5, 1.0
    keys = rng.integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32)
    if dtype != np.float32:
        logits = np.asarray(jnp.asarray(logits, dtype))
    masked = np.asarray(jax_mask(jnp.asarray(logits), jnp.asarray(store),
                                 jnp.asarray(rows), jnp.asarray(eos),
                                 constrained=jnp.asarray(cons),
                                 cd=jnp.asarray(cd)), np.float32)
    top_p = _off_edge(masked / np.maximum(temp, 1e-6)[:, None], top_k, top_p)
    return dict(logits=logits, store=store, rows=rows, cd=cd, eos=eos,
                cons=cons, greedy=greedy, temp=temp, top_k=top_k,
                top_p=top_p, keys=keys)


def _args_jax(x):
    return tuple(jnp.asarray(x[n]) for n in (
        "logits", "store", "rows", "cd", "eos", "cons", "greedy", "temp",
        "top_k", "top_p"))


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _args_torch(x):
    return tuple(_t(x[n]) for n in (
        "logits", "store", "rows", "cd", "eos", "cons", "greedy", "temp",
        "top_k", "top_p"))


def _bits(a):
    """Bit image of masked logits (f32 or bf16, numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


SHAPES = [(1, 512, 32, 4), (4, 2048, 300, 12), (3, 1024, 64, 48),
          (4, 2048, 300, 96)]


@pytest.mark.parametrize("B,V,R,A", SHAPES)
def test_sampled_matches_kernel_and_ref_bitwise(B, V, R, A):
    x = _inputs(B * V + A, B, V, R, A)
    noise = np.array(jax_gumbel(jnp.asarray(x["keys"]), V))
    ids_k, masked_k = jax_kernel(*_args_jax(x), jnp.asarray(noise),
                                 mode="sample", interpret=True)
    ids_r, masked_r = jax_ref(*_args_jax(x), noise=jnp.asarray(noise))
    before = ops.fused_mask_select.launches
    ids, masked, ok = ops.fused_mask_select(*_args_torch(x),
                                            noise=torch.from_numpy(noise))
    assert ops.fused_mask_select.launches == before   # plain version only
    for want_ids, want_masked in ((ids_k, masked_k), (ids_r, masked_r)):
        np.testing.assert_array_equal(_bits(masked), _bits(want_masked))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(
        ok.numpy(), (np.asarray(masked_r) > -5e29).any(-1))
    assert ids.dtype == torch.int32 and ok.dtype == torch.bool


@pytest.mark.parametrize("B,V,R,A", SHAPES)
def test_greedy_variant_matches_kernel_bitwise(B, V, R, A):
    """noise=None is the all-greedy variant (the reference's host-static
    mode="greedy"): every row takes the masked argmax."""
    x = _inputs(B * V + A + 1, B, V, R, A)
    ids_k, masked_k = jax_kernel(*_args_jax(x), jnp.zeros((B, V)),
                                 mode="greedy", interpret=True)
    ids_r, masked_r = jax_ref(*_args_jax(x))
    ids, masked, ok = ops.fused_mask_select(*_args_torch(x))
    for want_ids, want_masked in ((ids_k, masked_k), (ids_r, masked_r)):
        np.testing.assert_array_equal(_bits(masked), _bits(want_masked))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(
        ok.numpy(), (np.asarray(masked_r) > -5e29).any(-1))


@pytest.mark.parametrize("greedy_only", [False, True])
def test_bf16_logits_match_ref_bitwise(greedy_only):
    """bf16 logits: the -1e30 fill is bf16's rounding of -1e30 on both
    sides, and the temperature divide promotes to f32 as in JAX."""
    B, V, R, A = 4, 2048, 300, 12
    x = _inputs(11, B, V, R, A, dtype=jnp.bfloat16)
    noise = None if greedy_only else np.array(
        jax_gumbel(jnp.asarray(x["keys"]), V))
    ids_r, masked_r = jax_ref(
        *_args_jax(x), noise=None if noise is None else jnp.asarray(noise))
    ids, masked, _ = ops.fused_mask_select(
        *_args_torch(x), noise=None if noise is None else
        torch.from_numpy(noise))
    assert masked.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(masked), _bits(masked_r))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))


def test_mask_half_matches_reference_without_residue():
    """masked_logits_ref with cd / constrained left out, as the reference
    defaults them."""
    x = _inputs(5, 3, 1024, 64, 8)
    want = np.asarray(jax_mask(jnp.asarray(x["logits"]),
                               jnp.asarray(x["store"]),
                               jnp.asarray(x["rows"]), jnp.asarray(x["eos"]),
                               eos_id=7))
    got = masked_logits_ref(_t(x["logits"]), _t(x["store"]), _t(x["rows"]),
                            _t(x["eos"]), eos_id=7)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wrapper_refuses_other_devices():
    """Only the CPU takes the plain version; a device that is neither CPU
    nor CUDA raises instead of falling back."""
    x = _args_torch(_inputs(3, 1, 512, 32, 4))
    meta = tuple(t.to("meta") for t in x)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_mask_select(*meta)
