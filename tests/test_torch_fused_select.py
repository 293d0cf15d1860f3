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
from _torch_select_cases import (CASES, EXPECTED_ROUTES, case_inputs,
                                 mask_np, routes)

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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_edge_rows_match_ref_bitwise(case, bf16):
    """The rows that reach the card kernel's two routes and their edges
    (ties at the k-th value, fewer allowed ids than top_k, an all-masked
    row, top_k 0 with top_p < 1, a candidate set over the list's
    capacity, the engine's resample form): the port's plain version
    against the reference's, bitwise, off the nucleus edge."""
    V = 8192
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    cap = ops.launch_plan(V, V // 32, torch.float32).cap
    x = case_inputs(case, V, cap, seed=CASES.index(case), bf16=bf16)
    assert EXPECTED_ROUTES[case] <= set(routes(x, cap))
    x["top_p"] = _off_edge(mask_np(x) / np.maximum(x["temp"], 1e-6)[:, None],
                           x["top_k"], x["top_p"])
    names = ("logits", "store", "rows", "cd", "eos", "cons", "greedy",
             "temp", "top_k", "top_p")
    jx = tuple(None if x[n] is None else jnp.asarray(x[n]) for n in names)
    jx = (jx[0].astype(dtype),) + jx[1:]
    tx = tuple(None if x[n] is None else _t(x[n]) for n in names)
    tx = (tx[0].to(torch.bfloat16 if bf16 else torch.float32),) + tx[1:]
    noise = np.array(jax_gumbel(jnp.asarray(x["keys"]), V))
    for nz in (None, noise):
        ids_r, masked_r = jax_ref(*jx, noise=None if nz is None
                                  else jnp.asarray(nz))
        ids, masked, ok = ops.fused_mask_select(
            *tx, noise=None if nz is None else torch.from_numpy(nz))
        np.testing.assert_array_equal(_bits(masked), _bits(masked_r))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
        np.testing.assert_array_equal(
            ok.numpy(), (np.asarray(masked_r, np.float32) > -5e29).any(-1))
    if case == "all_masked":
        assert not ok.any() and not ids.any()


@pytest.mark.parametrize("sampled", [False, True])
def test_span_form_matches_reference_span(sampled):
    """`fused_mask_select_span` against the reference's span form on a
    [B, S, V] span (per-position rows, residue, eos and constrained flag;
    per-slot decode configs broadcast across the span), and against the
    port's own batch form on the flattened rows: ids and masked bitwise,
    ok equal."""
    from repro.kernels.fused_select.ops import \
        fused_mask_select_span as jax_span
    B, S, V, R, A = 2, 3, 512, 40, 6
    x = _inputs(17 + sampled, B * S, V, R, A)
    for n in ("greedy", "temp", "top_k"):
        x[n] = np.repeat(x[n][:B], S)
    masked_np = np.asarray(jax_mask(
        jnp.asarray(x["logits"]), jnp.asarray(x["store"]),
        jnp.asarray(x["rows"]), jnp.asarray(x["eos"]),
        constrained=jnp.asarray(x["cons"]), cd=jnp.asarray(x["cd"])),
        np.float32)
    x["top_p"] = np.repeat(x["top_p"][:B], S)
    # no position sits at its nucleus edge (there the frameworks' sum
    # orders may cut differently), so top_p stays one value per slot
    np.testing.assert_array_equal(_off_edge(
        masked_np / np.maximum(x["temp"], 1e-6)[:, None], x["top_k"],
        x["top_p"]), x["top_p"])
    noise = np.array(jax_gumbel(jnp.asarray(x["keys"]), V)) if sampled \
        else None
    span = lambda a: a.reshape((B, S) + a.shape[1:])
    j = _args_jax(x)
    ids_r, masked_r = jax_span(
        j[0].reshape(B, S, V), j[1], j[2].reshape(B, S, A),
        j[3].reshape(B, S, -1), j[4].reshape(B, S), j[5].reshape(B, S),
        *(a[::S] for a in j[6:]),
        noise=None if noise is None else jnp.asarray(noise).reshape(B, S, V))
    t = _args_torch(x)
    nz = None if noise is None else torch.from_numpy(noise)
    ids, masked, ok = ops.fused_mask_select_span(
        span(t[0]), t[1], span(t[2]), span(t[3]), span(t[4]), span(t[5]),
        *(a[::S].contiguous() for a in t[6:]),
        noise=None if nz is None else span(nz))
    assert ids.shape == (B, S) and masked.shape == (B, S, V) and \
        ok.shape == (B, S)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(_bits(masked), _bits(masked_r))
    flat = ops.fused_mask_select(*t, noise=nz)
    np.testing.assert_array_equal(ids.reshape(-1).numpy(), flat[0].numpy())
    np.testing.assert_array_equal(_bits(masked.reshape(B * S, V)),
                                  _bits(flat[1]))
    np.testing.assert_array_equal(ok.reshape(-1).numpy(), flat[2].numpy())
