"""The port's attention (`repro_torch.kernels.flash_attention`, plain
version on the CPU) against the reference's `models/common.py::
chunked_attention` (the function its model runs), the kernel's oracle
`flash_attention/ref.py::attention_ref` and the Pallas kernel
`flash_attention(interpret=True)`, on the same numpy inputs: causal,
sliding window, GQA, non-causal (at Sq < Sk and Sq > Sk: cross
attention to encoder frames), and ragged query lengths right-aligned to
the keys.

Tolerances: fp32 outputs within atol 1e-5 (the frameworks sum the scores
and P.V in different orders; a mask error would move an output by O(1)).
bf16 outputs within atol 2**-6, two bf16 ulps at the values' scale of 1:
q is scaled and P rounded to bf16 at the same points on both sides, and
only the fp32 sums feeding those roundings differ in order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.common import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import chunked_attention

ATOL_F32 = 1e-5
ATOL_BF16 = 2.0 ** -6


def _qkv(seed, B, Sq, Sk, H, K, Dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, K, Dh)).astype(np.float32)
    if dtype != np.float32:
        q, k, v = (np.asarray(jnp.asarray(a, dtype)) for a in (q, k, v))
    return q, k, v


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# (B, Sq, Sk, H, K, Dh, window, causal)
CASES = [
    (1, 7, 7, 4, 2, 32, 0, True),        # ragged square, GQA G=2
    (2, 5, 40, 6, 2, 16, 0, True),       # Sq < Sk, right-aligned
    (1, 24, 24, 8, 8, 32, 6, True),      # sliding window, no GQA
    (2, 16, 48, 4, 1, 32, 10, True),     # window + ragged + G=4
    (1, 9, 33, 6, 3, 16, 0, False),      # non-causal
    (2, 40, 32, 4, 2, 64, 0, False),     # non-causal Sq > Sk (cross)
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal", CASES)
def test_op_matches_reference_attention_fp32(B, Sq, Sk, H, K, Dh, window,
                                             causal):
    q, k, v = _qkv(Sq * 100 + Sk, B, Sq, Sk, H, K, Dh)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    wants = {
        "attention_ref": attention_ref(jq, jk, jv, causal=causal,
                                       window=window),
        "flash_attention": flash_attention(jq, jk, jv, causal=causal,
                                           window=window, interpret=True),
        "chunked_attention": jax_chunked(jq, jk, jv, causal=causal,
                                         q_offset=Sk - Sq, window=window),
    }
    before = ops.attention.launches
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert ops.attention.launches == before     # plain version only
    assert got.shape == (B, Sq, H, Dh) and got.dtype == torch.float32
    for name, want in wants.items():
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                   atol=ATOL_F32, err_msg=name)


@pytest.mark.parametrize("Sq,Sk,chunk,q_chunk,window", [
    (12, 40, 16, 0, 0),      # KV chunks with a padded last chunk
    (32, 32, 8, 8, 0),       # q blocks + KV chunks
    (32, 32, 8, 8, 5),       # ... with a sliding window
    (6, 50, 16, 0, 9),       # right-aligned, padded, windowed
])
def test_chunked_paths_match_reference_fp32(Sq, Sk, chunk, q_chunk, window):
    """The blocked paths of the plain version (KV chunks, q blocks, the
    padded tail chunk) against the reference's same function."""
    B, H, K, Dh = 2, 4, 2, 16
    q, k, v = _qkv(Sq + Sk + chunk, B, Sq, Sk, H, K, Dh)
    want = jax_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                       q_offset=Sk - Sq, window=window, chunk=chunk,
                       q_chunk=q_chunk)
    got = chunked_attention(_t(q), _t(k), _t(v), causal=True,
                            q_offset=Sk - Sq, window=window, chunk=chunk,
                            q_chunk=q_chunk)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("valid", [19, [7, 30]])
def test_kv_valid_len_matches_reference_fp32(valid):
    """kv_valid_len (scalar or per row) masks cache positions >= valid."""
    B, Sq, Sk, H, K, Dh = 2, 1, 32, 4, 2, 16
    q, k, v = _qkv(77, B, Sq, Sk, H, K, Dh)
    for chunk in (64, 8):
        want = jax_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                           q_offset=Sk - 1, chunk=chunk,
                           kv_valid_len=jnp.asarray(valid))
        got = chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                q_offset=Sk - 1, chunk=chunk,
                                kv_valid_len=torch.tensor(valid))
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                   atol=ATOL_F32)


@pytest.mark.parametrize("Sq,Sk,chunk,window", [(7, 7, 1024, 0),
                                                (16, 48, 1024, 10),
                                                (24, 40, 16, 0)])
def test_bf16_matches_reference_chunked(Sq, Sk, chunk, window):
    B, H, K, Dh = 1, 6, 2, 32
    q, k, v = _qkv(Sq * 7 + Sk, B, Sq, Sk, H, K, Dh, dtype=jnp.bfloat16)
    want = jax_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                       q_offset=Sk - Sq, window=window, chunk=chunk)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                        chunk=chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=ATOL_BF16)


def test_masks_are_exact():
    """q = 0 makes every visible score equal, so output channel c is the
    share of VISIBLE keys whose position has bit c set: any masking error
    shows as a whole fraction, far above the fp32 tolerance."""
    B, H, K, Dh = 1, 4, 2, 16
    for Sq, Sk, window in ((7, 7, 0), (40, 40, 9), (5, 37, 0), (5, 37, 4)):
        q = np.zeros((B, Sq, H, Dh), np.float32)
        k = np.random.default_rng(Sk).normal(size=(B, Sk, K, Dh)).astype(
            np.float32)
        pos = np.arange(Sk)
        bits = ((pos[:, None] >> np.arange(6)[None, :]) & 1).astype(
            np.float32)
        v = np.zeros((B, Sk, K, Dh), np.float32)
        v[0, :, :, :6] = bits[:, None, :]
        out = ops.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                            chunk=16).numpy()
        qpos = np.arange(Sq) + (Sk - Sq)
        vis = pos[None, :] <= qpos[:, None]
        if window:
            vis &= pos[None, :] > qpos[:, None] - window
        want = (vis.astype(np.float64) @ bits) / vis.sum(1, keepdims=True)
        np.testing.assert_allclose(out[0, :, :, :6],
                                   np.broadcast_to(want[:, None, :],
                                                   (Sq, H, 6)),
                                   rtol=0, atol=ATOL_F32)


def test_wrapper_refuses_other_devices():
    q, k, v = (_t(a).to("meta") for a in _qkv(1, 1, 4, 4, 2, 1, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.attention(q, k, v)


@pytest.mark.parametrize("Sq,Sk,causal,window,ok", [
    (40, 32, False, 0, True), (1, 1500, False, 0, True),
    (2048, 1500, False, 0, True), (40, 32, True, 0, False),
    (40, 32, False, 8, False), (3, 0, False, 0, False)])
def test_kernel_shape_check(Sq, Sk, causal, window, ok):
    """The launch's shape check takes Sq > Sk only where the mask reads no
    positions (not causal, no window) and there are keys; a shape it takes
    then fails only on the device (these tensors lie on the CPU)."""
    q = torch.zeros((1, Sq, 4, 64))
    k = torch.zeros((1, Sk, 2, 64))
    with pytest.raises(ValueError,
                       match="unsupported device" if ok else
                       "unsupported shapes"):
        ops._check_inputs(q, k, k, causal, window)
