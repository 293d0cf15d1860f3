"""The attention gradient of the port on the CPU: `ref.attention_bwd` (the
plain version of the backward kernel) against `jax.vjp` of the
reference's `chunked_attention`, the differentiable `attention` op
against torch autograd through the plain forward, and a float64
`gradcheck`. Inputs are drawn with numpy.

Tolerances: fp32 gradients within 1e-5 of each gradient's largest
magnitude (sum orders differ: XLA's autodiff of the online softmax
against the FlashAttention-2 form); the LSE within 1e-5 of an fp64
numpy log-sum-exp; bf16 within 2**-6 of the largest magnitude (the
reference's autodiff rounds dP to bf16 where the FA-2 form keeps it in
fp32). A bf16 emulation of the backward kernel's rounding points (dS
rounded to bf16 before the dK and dQ products) is held within 2**-5 of
the plain version, the card test's tolerance, and within 2**-6 of
`jax.vjp`."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import chunked_attention as jax_attention
from repro_torch.kernels.flash_attention.ops import (
    attention, attention_backward, attention_with_lse)
from repro_torch.kernels.flash_attention.ref import (attention_bwd,
                                                    chunked_attention)

torch.set_num_threads(1)


def _inputs(B, S, H, K, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in
            ((B, S, H, Dh), (B, S, K, Dh), (B, S, K, Dh), (B, S, H, Dh))]


def _close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, (
            np.abs(g - w).max(), scale)


@pytest.mark.parametrize("chunk", [64, 1024], ids=["scan", "softmax"])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("H,K", [(8, 4), (15, 5)])
def test_plain_backward_matches_jax_vjp(H, K, Dh, window, chunk):
    """S = 192 over chunk 64 runs the reference's query-blocked online
    softmax scan (three KV chunks); chunk 1024 its one-shot softmax."""
    q, k, v, do = _inputs(2, 192, H, K, Dh, seed=H * Dh + window)
    out, vjp = jax.vjp(lambda q, k, v: jax_attention(
        q, k, v, causal=True, window=window, chunk=chunk),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = chunked_attention(tq, tk, tv, causal=True, window=window,
                               chunk=chunk, return_lse=True)
    _close([o], [out], 1e-5)
    _close(attention_bwd(tq, tk, tv, o, lse, tdo, causal=True,
                         window=window), want, 1e-5)


@pytest.mark.parametrize("window", [0, 40])
def test_plain_backward_bf16_matches_jax_vjp(window):
    q, k, v, do = _inputs(1, 128, 15, 5, 64, seed=9)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(
        q, k, v, causal=True, window=window, chunk=1024), jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = chunked_attention(tq, tk, tv, causal=True, window=window,
                               return_lse=True)
    got = attention_bwd(tq, tk, tv, o, lse, tdo, causal=True, window=window)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close(got, want, 2.0 ** -6)


def _bf16(x):
    """x rounded to bf16 (nearest even), back in fp32."""
    return x.to(torch.bfloat16).float()


def _kernel_rounding_bwd(q, k, v, o, lse, do, window):
    """A bf16 emulation of the backward kernel's bf16 route
    (csrc/flash_attention_bwd.cu) at its rounding points, from bf16
    tensors: q^ = round(q * scale); S = q^ K^T and dP = dO V^T summed in
    fp32; P = exp(S - lse), 0 where masked; dV = round(P)^T dO; D =
    rowsum(dO * O); dS = P (dP - D), rounded to bf16 before dK = dS^T q^
    and d(q^) = dS K (the route's one extra rounding point); dq =
    round(round(d(q^)) * scale); outputs rounded to bf16."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.bfloat16).float()
    qh = _bf16(q.float() * scale).reshape(B, Sq, K, G, Dh)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, K, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, kf)
    pos = torch.arange(Sq)[:, None] + Sk - Sq
    kp = torch.arange(Sk)[None, :]
    vis = (kp <= pos) & ((kp > pos - window) if window else True)
    p = torch.where(vis, torch.exp(s - lse.reshape(B, K, G, Sq, 1)), 0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", _bf16(p), dof)
    dvec = (do.float() * o.float()).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = _bf16(p * (dp - dvec.reshape(B, K, G, Sq, 1)))
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qh)
    dqh = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Sq, H, Dh)
    return (_bf16(_bf16(dqh) * scale).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


@pytest.mark.parametrize("H,K,Dh,window", [(8, 2, 64, 0), (8, 2, 64, 40),
                                           (6, 1, 32, 24), (4, 4, 128, 0)])
def test_bf16_kernel_rounding_matches_plain_and_jax(H, K, Dh, window):
    """The bf16 backward kernel's rounding design, emulated on the CPU
    from numpy inputs (GQA, MQA, a window): within 2**-5 of the plain
    version's largest magnitude (the card test's tolerance for the
    kernel) and within this file's 2**-6 bf16 bound of `jax.vjp` of the
    reference's `chunked_attention`, so a rounding point that breaks the
    contract shows here before the card sees it."""
    q, k, v, do = _inputs(1, 160, H, K, Dh, seed=H * Dh + window + 1)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(
        q, k, v, causal=True, window=window, chunk=1024), jq, jk, jv)
    want_jax = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = chunked_attention(tq, tk, tv, causal=True, window=window,
                               return_lse=True)
    got = _kernel_rounding_bwd(tq, tk, tv, o, lse, tdo, window)
    plain = attention_bwd(tq, tk, tv, o, lse, tdo, causal=True,
                          window=window)
    _close(got, [g.float().numpy() for g in plain], 2.0 ** -5)
    _close(got, want_jax, 2.0 ** -6)


@pytest.mark.parametrize("chunk", [32, 1024], ids=["scan", "softmax"])
def test_lse_matches_fp64(chunk):
    """The plain forward's LSE (either branch) is the log-sum-exp of the
    scaled, masked scores, with the window."""
    q, k, v, _ = _inputs(1, 96, 4, 2, 32, seed=4)
    _, lse = chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, window=40, chunk=chunk,
                               return_lse=True)
    s = np.einsum("bqkgd,bskd->bkgqs", q.reshape(1, 96, 2, 2, 32)
                  .astype(np.float64), k.astype(np.float64)) / math.sqrt(32)
    s = s.reshape(1, 4, 96, 96)
    i, j = np.arange(96)[:, None], np.arange(96)[None, :]
    s = np.where((j <= i) & (j > i - 40), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (1, 4, 96) and lse.dtype == torch.float32
    assert np.abs(lse.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("window", [0, 24])
def test_attention_op_grads_match_torch_autograd(window):
    """The differentiable op on the CPU (a Function: plain forward with
    LSE, `ref.attention_bwd` backward) against torch autograd through
    the plain forward; the kernels' launch counters do not move."""
    q, k, v, do = map(torch.from_numpy, _inputs(2, 80, 6, 2, 32, seed=2))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = attention.launches, attention_backward.launches
    attention(*ins, causal=True, window=window, chunk=32).backward(do)
    assert (attention.launches, attention_backward.launches) == launches
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    chunked_attention(*ref_ins, causal=True, window=window,
                      chunk=32).backward(do)
    _close([t.grad for t in ins], [t.grad.numpy() for t in ref_ins], 1e-5)


def test_attention_op_without_grad_is_the_plain_forward():
    """No grad needed: the serving path, the same values, no LSE."""
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 40, 4, 2, 32, seed=3))
    out = attention(q, k, v, causal=True, window=0, chunk=16)
    assert torch.equal(out, chunked_attention(q, k, v, causal=True,
                                              chunk=16))
    o2, lse = attention_with_lse(q, k, v, causal=True, chunk=16)
    assert torch.equal(out, o2) and lse.shape == (1, 4, 40)


@pytest.mark.parametrize("window", [0, 3])
def test_attention_op_gradcheck_fp64(window):
    """torch.autograd.gradcheck of the Function in float64 (the plain
    versions accumulate fp64 inputs in fp64), GQA 4/2, causal."""
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(rng.normal(size=s)).requires_grad_()
           for s in ((1, 7, 4, 8), (1, 7, 2, 8), (1, 7, 2, 8))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: attention(q, k, v, causal=True, window=window),
        ins, eps=1e-6, atol=1e-6)


def test_backward_right_aligned_queries():
    """Sq < Sk (queries right-aligned to keys): the plain backward
    against torch autograd through the plain forward."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(1, 20, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 50, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    do = torch.from_numpy(rng.normal(size=(1, 20, 4, 32)).astype(np.float32))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    chunked_attention(*ins, causal=True, q_offset=30).backward(do)
    o, lse = chunked_attention(q, k, v, causal=True, q_offset=30,
                               return_lse=True)
    _close(attention_bwd(q, k, v, o, lse, do, causal=True),
           [t.grad.numpy() for t in ins], 1e-5)


@pytest.mark.parametrize("Sq,Sk,chunk", [(48, 32, 1024), (48, 32, 16),
                                         (1, 40, 1024), (20, 50, 16)])
def test_plain_backward_non_causal_matches_jax_vjp(Sq, Sk, chunk):
    """Non-causal at Sq > Sk and Sq < Sk (an encoder's and a decoder's
    cross attention; chunk 16 runs the reference's KV-chunked scan): the
    plain backward from the plain forward's output and LSE against
    `jax.vjp` of the reference's `chunked_attention(causal=False)`."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    q, do = (rng.normal(size=(2, Sq, 4, 32)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, Sk, 2, 32)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(
        q, k, v, causal=False, chunk=chunk), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_with_lse(tq, tk, tv, causal=False, chunk=chunk)
    _close(attention_backward(tq, tk, tv, o, lse, tdo, causal=False),
           want, 1e-5)
