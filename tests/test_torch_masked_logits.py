"""The port's grammar mask (`repro_torch.kernels.masked_logits`, plain
version on the CPU) against the reference's Pallas kernels
`masked_logits` / `masked_logits_span` (interpret mode, as
tests/test_kernels.py runs them), its ops (`apply_grammar_mask*`, with
the `constrained` pass-through) and its jnp refs, on the same numpy
inputs: cd residue words, the EOS override, -1 row pads, constrained
pass-through, and vocab sizes that are not a multiple of the port
kernel's tile.

Tolerance: none. The outputs are copies of the logits or the -1e30 fill,
so they must be bitwise equal, in fp32 and in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_logits.kernel import masked_logits as jax_kernel
from repro.kernels.masked_logits.kernel import \
    masked_logits_span as jax_span_kernel
from repro.kernels.masked_logits.ops import apply_grammar_mask as jax_apply
from repro.kernels.masked_logits.ops import \
    apply_grammar_mask_span as jax_apply_span
from repro.kernels.masked_logits.ref import masked_logits_ref as jax_ref
from repro.kernels.masked_logits.ref import \
    masked_logits_span_ref as jax_span_ref
from repro_torch.kernels.masked_logits.ops import (apply_grammar_mask,
                                                   apply_grammar_mask_span)
from repro_torch.kernels.masked_logits.ref import (masked_logits_ref,
                                                   masked_logits_span_ref)


def _inputs(seed, lead, V, R, A, dtype):
    """Random mask step over rows of shape `lead` (B or (B, K)), as numpy;
    one row has only pads, half the cd rows are zero."""
    rng = np.random.default_rng(seed)
    lead = tuple(np.atleast_1d(lead))
    W = -(-V // 32)
    N = int(np.prod(lead))
    store = rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
    rows = rng.integers(-1, R, size=(N, A)).astype(np.int32)
    rows[0] = -1
    cd = rng.integers(0, 2 ** 32, size=(N, W), dtype=np.uint32)
    cd[rng.random(N) < 0.5] = 0
    logits = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    if dtype != np.float32:
        logits = np.asarray(jnp.asarray(logits, dtype))
    eos = rng.random(N) < 0.5
    cons = rng.random(N) < 0.7
    cons[0] = True
    shape = lambda a: a.reshape(*lead, *a.shape[1:])
    return (shape(logits), store, shape(rows), shape(eos), shape(cd),
            shape(cons))


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _bits(x):
    """Exact bit image of a float array or tensor."""
    if isinstance(x, torch.Tensor):
        w = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.view(w).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.name == "bfloat16" else np.int32)


DTYPES = [np.float32, jnp.bfloat16]


# (B, V, R, A, block_v): V = 2080 and 1056 are not multiples of the port
# kernel's 2048-entry tile; A = 70 is past the 48-row base bucket
CASES = [(3, 256, 20, 4, 128), (4, 2080, 64, 70, 160),
         (2, 1056, 40, 9, 96)]


@pytest.mark.parametrize("B,V,R,A,block_v", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_logits_matches_reference_kernel(B, V, R, A, block_v, dtype):
    logits, store, rows, eos, cd, cons = _inputs(B * V + A, B, V, R, A,
                                                 dtype)
    want = jax_kernel(jnp.asarray(logits), jnp.asarray(store),
                      jnp.asarray(rows), jnp.asarray(eos), jnp.asarray(cd),
                      block_v=block_v, interpret=True)
    got = masked_logits_ref(_t(logits), _t(store), _t(rows), _t(eos),
                            cd=_t(cd))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(want), _bits(jax_ref(jnp.asarray(logits), jnp.asarray(store),
                                   jnp.asarray(rows), jnp.asarray(eos),
                                   cd=jnp.asarray(cd))))


@pytest.mark.parametrize("B,V,R,A,block_v", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_grammar_mask_matches_reference_op(B, V, R, A, block_v,
                                                 dtype):
    """The op with the constrained pass-through, with and without cd."""
    logits, store, rows, eos, cd, cons = _inputs(B * V + 7, B, V, R, A,
                                                 dtype)
    for use_cd in (True, False):
        want = jax_apply(jnp.asarray(logits), jnp.asarray(store),
                         jnp.asarray(rows), jnp.asarray(eos),
                         backend="pallas", block_v=block_v,
                         constrained=jnp.asarray(cons),
                         cd=jnp.asarray(cd) if use_cd else None)
        got = apply_grammar_mask(_t(logits), _t(store), _t(rows), _t(eos),
                                 constrained=_t(cons),
                                 cd=_t(cd) if use_cd else None)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B,K,V,R,A,block_v", [(3, 4, 256, 64, 6, 128),
                                               (2, 3, 2080, 30, 50, 416)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_logits_span_matches_reference_kernel(B, K, V, R, A, block_v,
                                                     dtype):
    logits, store, rows, eos, cd, cons = _inputs(B * K * V, (B, K), V, R,
                                                 A, dtype)
    want = jax_span_kernel(jnp.asarray(logits), jnp.asarray(store),
                           jnp.asarray(rows), jnp.asarray(eos),
                           jnp.asarray(cd), block_v=block_v, interpret=True)
    got = masked_logits_span_ref(_t(logits), _t(store), _t(rows), _t(eos),
                                 cd=_t(cd))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(want), _bits(jax_span_ref(
            jnp.asarray(logits), jnp.asarray(store), jnp.asarray(rows),
            jnp.asarray(eos), cd=jnp.asarray(cd))))
    want_op = jax_apply_span(
        jnp.asarray(logits), jnp.asarray(store), jnp.asarray(rows),
        jnp.asarray(eos), backend="pallas", block_v=block_v,
        constrained=jnp.asarray(cons), cd=jnp.asarray(cd))
    got_op = apply_grammar_mask_span(_t(logits), _t(store), _t(rows),
                                     _t(eos), constrained=_t(cons),
                                     cd=_t(cd))
    np.testing.assert_array_equal(_bits(got_op), _bits(want_op))


def test_span_form_is_the_row_form_on_flattened_rows():
    """The one CUDA kernel serves both entry points by flattening (b, k):
    the plain versions agree the same way."""
    logits, store, rows, eos, cd, cons = _inputs(5, (2, 3), 1000, 16, 5,
                                                 np.float32)
    span = apply_grammar_mask_span(_t(logits), _t(store), _t(rows), _t(eos),
                                   constrained=_t(cons), cd=_t(cd))
    flat = apply_grammar_mask(_t(logits.reshape(6, -1)), _t(store),
                              _t(rows.reshape(6, -1)), _t(eos.reshape(6)),
                              constrained=_t(cons.reshape(6)),
                              cd=_t(cd.reshape(6, -1)))
    assert torch.equal(span.reshape(6, -1), flat)
    # the plain version leaves the launch counters alone
    assert apply_grammar_mask.launches == 0
    assert apply_grammar_mask_span.launches == 0


def test_eos_override_and_passthrough_rows():
    """EOS opens exactly when eos_allowed; an unconstrained row is the
    logits unchanged; an all-pad row with no cd keeps only EOS."""
    V = 64
    store = np.zeros((2, 2), np.uint32)
    rows = np.full((3, 2), -1, np.int32)
    logits = np.arange(3 * V, dtype=np.float32).reshape(3, V)
    eos = np.array([True, False, False])
    cons = np.array([True, True, False])
    out = apply_grammar_mask(_t(logits), _t(store), _t(rows), _t(eos),
                             constrained=_t(cons)).numpy()
    assert out[0, 1] == logits[0, 1] and (np.delete(out[0], 1) == -1e30).all()
    assert (out[1] == -1e30).all()
    np.testing.assert_array_equal(out[2], logits[2])
