"""Selectors of the port (`repro_torch.core.decoding`) against the
reference (`repro.core.decoding`) on the same numpy inputs: kept-token
sets of `topk_topp_filter` bitwise on fp32, `select_batch` ids equal with
the same Gumbel noise (the reference draws it from its keys; the port
takes it as an input), and the packed-mask helpers bit for bit.

Inputs are drawn away from the nucleus edge: the cumulative softmax is
summed in another order by each framework, so a row whose mass lands
within a few ulps of top_p may legitimately cut one token differently.
`_assert_off_edge` checks that margin for every row used (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decoding as jd
from repro.kernels.fused_select.ref import gumbel_noise as jax_gumbel
from repro_torch.core import decoding as td

EDGE = 1e-5


def _assert_off_edge(scaled, top_k, top_p):
    """Every row's sorted cumulative softmax stays EDGE away from top_p
    (float64 on the host)."""
    for row, k, p in zip(scaled, top_k, top_p):
        if p >= 1.0:
            continue
        srt = np.sort(row.astype(np.float64))[::-1]
        if 0 < k < row.size:
            row = np.where(row < srt[k - 1], -1e30, row)
            srt = np.sort(row.astype(np.float64))[::-1]
        e = np.exp(srt - srt[0])
        cum = np.cumsum(e / e.sum())
        assert np.abs(cum - p).min() > EDGE, "input too close to the edge"


def _inputs(seed, B, V):
    rng = np.random.default_rng(seed)
    scaled = (rng.normal(size=(B, V)) * rng.uniform(0.5, 3.0)).astype(
        np.float32)
    scaled[rng.random((B, V)) < 0.3] = -1e30     # masked entries
    top_k = rng.integers(-1, 40, size=B).astype(np.int32)
    top_p = rng.uniform(0.3, 1.2, size=B).astype(np.float32)
    return scaled, top_k, top_p


@pytest.mark.parametrize("seed,B,V", [(0, 8, 256), (1, 4, 2048),
                                      (2, 16, 512), (3, 2, 49152)])
def test_topk_topp_filter_kept_sets_bitwise(seed, B, V):
    scaled, top_k, top_p = _inputs(seed, B, V)
    _assert_off_edge(scaled, top_k, top_p)
    want = np.asarray(jd.topk_topp_filter(jnp.asarray(scaled),
                                          jnp.asarray(top_k),
                                          jnp.asarray(top_p)))
    got = td.topk_topp_filter(torch.from_numpy(scaled),
                              torch.from_numpy(top_k),
                              torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(want, got)


def test_filter_tie_rules_match_reference():
    """top-k keeps ties with the k-th value; top-p is inclusive-first-over
    with ties; top_p >= 1 disables exactly; top_k <= 0 or >= V disables."""
    rows = np.array([[3.0, 2.0, 2.0, 2.0, 1.0, 0.0, -1.0, -2.0]] * 6,
                    np.float32)
    top_k = np.array([2, 0, 9, -1, 3, 1], np.int32)
    top_p = np.array([1.0, 0.5, 1.0, 0.999, 0.2, 1.5], np.float32)
    want = np.asarray(jd.topk_topp_filter(jnp.asarray(rows),
                                          jnp.asarray(top_k),
                                          jnp.asarray(top_p)))
    got = td.topk_topp_filter(torch.from_numpy(rows),
                              torch.from_numpy(top_k),
                              torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(want, got)
    assert (got[0] > -1e29).sum() == 4      # k=2 keeps the 2.0 ties


@pytest.mark.parametrize("seed,B,V", [(4, 8, 512), (5, 4, 2048)])
def test_select_batch_ids_match_with_shared_noise(seed, B, V):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, V)).astype(np.float32) * 2
    logits[rng.random((B, V)) < 0.5] = -1e30
    keys = rng.integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32)
    greedy = rng.random(B) < 0.3
    temp = rng.uniform(0.4, 1.6, size=B).astype(np.float32)
    top_k = rng.integers(0, 20, size=B).astype(np.int32)
    top_p = rng.uniform(0.5, 1.2, size=B).astype(np.float32)
    _assert_off_edge(logits / np.maximum(temp, 1e-6)[:, None], top_k, top_p)
    want = np.asarray(jd.select_batch(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(greedy),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))
    noise = np.asarray(jax_gumbel(jnp.asarray(keys), V))
    got = td.select_batch(torch.from_numpy(logits), torch.from_numpy(noise),
                          torch.from_numpy(greedy), torch.from_numpy(temp),
                          torch.from_numpy(top_k),
                          torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(want, got)
    # all-greedy form (no noise) is the plain argmax
    np.testing.assert_array_equal(
        td.select_batch(torch.from_numpy(logits), None, None, None, None,
                        None).numpy(), logits.argmax(-1))


def test_select_span_matches_reference():
    rng = np.random.default_rng(6)
    B, S, V = 3, 4, 256
    logits = rng.normal(size=(B, S, V)).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, size=(B, S, 2), dtype=np.uint32)
    greedy = np.array([False, True, False])
    temp = np.array([0.7, 1.0, 1.3], np.float32)
    top_k = np.array([0, 5, 9], np.int32)
    top_p = np.array([1.0, 0.9, 1.0], np.float32)
    want = np.asarray(jd.select_span(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(greedy),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))
    noise = np.asarray(jax_gumbel(jnp.asarray(keys.reshape(B * S, 2)),
                                  V)).reshape(B, S, V)
    got = td.select_span(torch.from_numpy(logits), torch.from_numpy(noise),
                         torch.from_numpy(greedy), torch.from_numpy(temp),
                         torch.from_numpy(top_k),
                         torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(want, got)


def test_scalar_sample_matches_reference():
    rng = np.random.default_rng(7)
    V = 300
    logits = rng.normal(size=(V,)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    for temp, k, p in ((1.0, None, None), (0.7, 20, None), (1.3, None, 0.8),
                       (0.9, 10, 0.6)):
        want = int(jd.sample(jnp.asarray(logits), key, temp, k, p))
        noise = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
        got = int(td.sample(torch.from_numpy(logits),
                            torch.from_numpy(noise), temp, k, p))
        assert want == got, (temp, k, p)
        dc = td.DecodeConfig(method="sample", temperature=temp, top_k=k,
                             top_p=p)
        assert int(dc.select(torch.from_numpy(logits),
                             torch.from_numpy(noise))) == want
    assert int(td.DecodeConfig().select(torch.from_numpy(logits))) == \
        int(np.argmax(logits))


def test_batch_arrays_match_reference():
    cfgs = [td.DecodeConfig(), td.DecodeConfig("sample", 0.5, 7, 0.9),
            td.DecodeConfig("sample", 1.2, None, None)]
    ref = jd.DecodeConfig.batch_arrays(
        [jd.DecodeConfig(c.method, c.temperature, c.top_k, c.top_p)
         for c in cfgs])
    for a, b in zip(ref, td.DecodeConfig.batch_arrays(cfgs)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_packed_mask_helpers_bitwise():
    rng = np.random.default_rng(8)
    R, W, B, A, V = 40, 16, 5, 7, 500
    store = rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
    rows = rng.integers(-1, R, size=(B, A)).astype(np.int32)
    want_u = np.asarray(jd.union_packed_rows(jnp.asarray(store),
                                             jnp.asarray(rows)))
    got_u = td.union_packed_rows(torch.from_numpy(store.view(np.int32)),
                                 torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(want_u, got_u.view(np.uint32))
    want_m = np.asarray(jd.unpack_mask_words(jnp.asarray(want_u), V))
    got_m = td.unpack_mask_words(torch.from_numpy(got_u), V).numpy()
    np.testing.assert_array_equal(want_m, got_m)


def test_beam_search_matches_reference():
    rng = np.random.default_rng(9)
    table = np.log(rng.dirichlet(np.ones(12), size=(6, 12)))
    table[:, :, 3] = -np.inf                       # a masked token

    def step(state, toks):
        return table[len(toks), (toks[-1] if toks else 0)], state

    assert td.beam_search(step, None, 3, 5, eos_id=1) == \
        jd.beam_search(step, None, 3, 5, eos_id=1)
