"""The port's page-table attention (`repro_torch.kernels.paged_attention`,
plain version on the CPU) against the reference's Pallas kernel
`paged_attention_span` (interpret mode) and its jnp ref, on the same numpy
inputs; against the port's own dense decode attention; and the paged
layer's cache writes against the reference layer's.

Tolerances: fp32 within atol 1e-5 and bf16 within atol 2**-6 against the
reference (the frameworks sum scores and P.V in different orders; q is
scaled and P rounded to the value dtype at the same points). Within the
port the plain paged attention and the dense decode attention are the
same function on the same gathered KV, so they must agree bitwise: that
is what keeps paged serving on the dense engine's tokens."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.paged_attention.kernel import paged_attention_span
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro.models import layers as jax_layers
from repro.models.common import init_attention as jax_init_attention
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_decode)
from repro_torch.kernels.paged_attention.ref import (attend,
                                                     paged_attention_ref)
from repro_torch.models import layers
from repro_torch.models.model import build_model

ATOL_F32 = 1e-5
ATOL_BF16 = 2.0 ** -6


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _inputs(seed, B, S, H, K, Dh, ps, nP, P, dtype=np.float32):
    """q, pools, a page table with -1 holes and a page shared between two
    slots, and start positions that keep every span row inside L."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, Dh)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, Dh)).astype(np.float32)
    pt = rng.permutation(P)[:B * nP].reshape(B, nP).astype(np.int32)
    pt[rng.random((B, nP)) < 0.25] = -1
    pt[:, 0] = np.abs(pt[:, 0])
    if B > 1:
        pt[1, 0] = pt[0, 0]                          # shared first page
    pos = rng.integers(1, nP * ps - S + 1, size=B).astype(np.int32)
    if dtype != np.float32:
        q, kp, vp = (np.asarray(jnp.asarray(a, dtype)) for a in (q, kp, vp))
    return q, kp, vp, pt, pos


CASES = [(2, 1, 4, 2, 16, 4, 6, 16), (3, 5, 6, 2, 32, 8, 4, 14),
         (2, 8, 4, 4, 16, 2, 9, 20)]


@pytest.mark.parametrize("B,S,H,K,Dh,ps,nP,P", CASES)
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_paged_attention_matches_reference(B, S, H, K, Dh, ps, nP, P,
                                           dtype):
    q, kp, vp, pt, pos = _inputs(B * S + nP, B, S, H, K, Dh, ps, nP, P,
                                 dtype)
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, pt, pos))
    kern = paged_attention_span(*args, interpret=True)
    ref = jax_ref(*args)
    got = paged_attention(*(_t(a) for a in (q, kp, vp, pt, pos)))
    atol = ATOL_F32 if dtype == np.float32 else ATOL_BF16
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(_f32(got), _f32(kern), rtol=0, atol=atol)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=atol)
    if S == 1:
        dec = paged_attention_decode(_t(q[:, 0]), _t(kp), _t(vp), _t(pt),
                                     _t(pos))
        assert torch.equal(dec, got[:, 0])
    assert paged_attention.launches == 0        # plain version only


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_is_bitwise_the_dense_decode_attention(dtype):
    """The same KV, once in a dense [B, L] cache and once scattered over
    pages: the plain paged attention equals the dense decode attention
    (`attend` over the dense cache with its kv_pos mask) bit for bit."""
    B, S, H, K, Dh, ps, nP, P = 3, 4, 6, 2, 16, 4, 5, 24
    L = nP * ps
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(B, S, H, Dh)).astype(
        np.float32)).to(dtype)
    kc = torch.from_numpy(rng.normal(size=(B, L, K, Dh)).astype(
        np.float32)).to(dtype)
    vc = torch.from_numpy(rng.normal(size=(B, L, K, Dh)).astype(
        np.float32)).to(dtype)
    pos = torch.tensor([3, 9, L - S], dtype=torch.int32)
    pt = torch.from_numpy(rng.permutation(P)[:B * nP].reshape(B, nP)
                          .astype(np.int32))
    kp = torch.zeros((P, ps, K, Dh), dtype=dtype)
    vp = torch.zeros((P, ps, K, Dh), dtype=dtype)
    for b in range(B):
        for j in range(nP):
            kp[pt[b, j]] = kc[b, j * ps:(j + 1) * ps]
            vp[pt[b, j]] = vc[b, j * ps:(j + 1) * ps]
    qpos = pos[:, None] + torch.arange(S, dtype=torch.int32)[None, :]
    kv_pos = torch.arange(L, dtype=torch.int32)[None, :].expand(B, L)
    valid = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <=
                                         qpos[:, :, None])
    dense = attend(q, kc, vc, valid)
    paged = paged_attention_ref(q, kp, vp, pt, pos)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(paged.view(bits), dense.view(bits))


def test_unmapped_pages_never_contribute():
    """Rewriting every pool page a slot does not map (and the stale
    positions past its frontier) leaves its output bitwise unchanged."""
    q, kp, vp, pt, pos = _inputs(3, 2, 3, 4, 2, 16, 4, 6, 16)
    ps = kp.shape[1]
    before = paged_attention(*(_t(a) for a in (q, kp, vp, pt, pos)))
    kp2, vp2 = kp.copy(), vp.copy()
    rng = np.random.default_rng(9)
    for b in range(2):
        mapped = set(pt[b][pt[b] >= 0].tolist())
        for p in range(kp.shape[0]):
            if p not in mapped and p not in set(pt[1 - b].tolist()):
                kp2[p] = rng.normal(size=kp2[p].shape) * 100
                vp2[p] = rng.normal(size=vp2[p].shape) * 100
    # positions past the last query of slot 0, inside its last used page
    last = pos[0] + q.shape[1] - 1
    j, o = divmod(int(last) + 1, ps)
    if j < pt.shape[1] and pt[0, j] >= 0 and pt[0, j] not in pt[1]:
        kp2[pt[0, j], o:] = 1e4
        vp2[pt[0, j], o:] = 1e4
    after = paged_attention(*(_t(a) for a in (q, kp2, vp2, pt, pos)))
    assert torch.equal(after, before)


def test_out_of_range_page_lookups_drop_their_writes():
    """A span whose last positions index past the page table (a padded
    span near max_len), an unmapped page and a feed_mask-gated position
    write nothing, as the reference layer drops them; the written pool
    entries and the outputs match the reference layer's."""
    jcfg = replace(get_config("syncode-demo"), dtype="float32", d_model=64,
                   num_heads=4, num_kv_heads=2, head_dim=16)
    tcfg = replace(torch_get_config("syncode-demo"), dtype="float32",
                   d_model=64, num_heads=4, num_kv_heads=2, head_dim=16)
    jp = jax_init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    B, S, P, ps, nP, K, Dh = 2, 6, 10, 4, 3, 2, 16
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, Dh)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, Dh)).astype(np.float32)
    pt = np.array([[2, 5, 7], [1, -1, 3]], np.int32)
    pos = np.array([8, 2], np.int32)       # slot 0: positions 12, 13 -> OOB
    fm = np.ones((B, S), bool)
    fm[1, 0] = False
    jctx = {"pos": jnp.asarray(pos), "page_table": jnp.asarray(pt),
            "feed_mask": jnp.asarray(fm), "paged_backend": "jnp"}
    jo, jc = jax_layers._paged_attention_decode(
        jp, jnp.asarray(x), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        jcfg, jctx)
    cache = {"k": _t(kp), "v": _t(vp)}
    tctx = {"pos": _t(pos), "page_table": _t(pt), "feed_mask": _t(fm)}
    to, tc = layers._paged_attention_decode(tp, _t(x), cache, tcfg, tctx)
    assert tc is cache                                  # written in place
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=0, atol=1e-5)
    # nothing outside the mapped, in-range, fed positions changed
    written = np.zeros((P, ps), bool)
    for b in range(B):
        for i in range(S):
            p = int(pos[b]) + i
            if p // ps < nP and pt[b, p // ps] >= 0 and fm[b, i]:
                written[pt[b, p // ps], p % ps] = True
    assert written.sum() == 4 + 1
    np.testing.assert_array_equal(tc["k"].numpy()[~written], kp[~written])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)


def test_paged_span_decode_is_bitwise_the_dense_span_decode():
    """Model level, fp32 syncode-demo cut to two layers: the same token
    spans fed through dense caches and through page tables give the same
    logits bit for bit (L = max_len = nP * ps)."""
    cfg = replace(torch_get_config("syncode-demo"), dtype="float32",
                  num_layers=2)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    B, ps, nP = 2, 8, 4
    L = ps * nP
    dense = m.init_decode_caches(B, L)
    pools = m.init_paged_caches(2 * nP + 1, ps)
    pt = torch.tensor([[3, 0, 5, 8], [1, 2, 4, 6]], dtype=torch.int32)
    rng = np.random.default_rng(1)
    pos = torch.zeros(B, dtype=torch.int32)
    for S in (5, 3, 1, 1):
        toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
        ld, _ = m.decode_span(params, dense, toks, pos)
        lp, _ = m.decode_span(params, pools, toks, pos,
                              batch_ctx={"page_table": pt})
        assert torch.equal(ld.view(torch.int32), lp.view(torch.int32))
        pos = pos + S
