"""The port's vlm family (llama-3.2-vision-90b: the `cross` layer kind and
the `Model` with its (attn x (e - 1), cross) groups) against the
reference's, on the reduced config (`cfg.reduced()`: 2 layers, one
("attn", "cross") period, cross_attn_every 2, 16 image tokens, d_model
256, 4 query heads over 2 KV heads of 64) with the reference's
`Model.init(PRNGKey(0))` params bridged leaf by leaf.

The gate hides the cross path: it starts at zero, so tanh(gate) = 0 and
a cross layer adds no attention, and no gradient reaches its q, K and V.
Every comparison here sets every `gate` leaf to GATE on both sides
(`_sides`), and one test checks that the logits then move with the image
embeddings (and do not with the gate at zero).

Checked: `layer_groups` (a remainder group at num_layers 3), the gates'
init and bridge; `cross_train`, `cross_prefill`
(output and its {"k", "v"} cache) and `cross_decode` against it;
`Model.prefill` over a bucket-padded prompt then `decode_step`s, logits
and every cache leaf; fp32 image embeddings under bf16 weights (the
random pipeline's draw): the reference returns fp32 cross K/V from
prefill and the port does too; the loss and every gradient leaf; in fp32
and bf16. The text is longer than the 16 image tokens (S = 24 and 40)
and shorter (S = 8), so cross attention runs Sq > Sk and Sq < Sk.

Tolerances as in tests/test_torch_archs.py: fp32 within atol 1e-4 plus
rtol 2e-6; bf16 four bf16 ulps at the compared tensor's largest
magnitude, at least 2**-3. Loss and gradients: fp32 1e-5 relative and
1e-4 of each leaf's largest magnitude (tests/test_torch_train_parity.py);
bf16 1e-4 relative and four bf16 ulps at each leaf's largest magnitude.
`kv_pos` must be equal."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro.models.model import layer_groups as jax_layer_groups
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import layers as tlayers
from repro_torch.models.model import _slice
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.models.model import layer_groups
from repro_torch.training.tree import flatten_with_path, leaves, unflatten

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
DTYPES = ["float32", "bfloat16"]
B = 2
GATE = 0.5


def _tol(dtype, want):
    if dtype == "float32":
        return dict(atol=1e-4, rtol=2e-6)
    top = float(np.abs(want).max()) if np.size(want) else 0.0
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    return dict(atol=max(2.0 ** -3, 4 * ulp), rtol=0)


def _close(got, want, dtype, what):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **_tol(dtype, want))


def set_gates(jax_params, value):
    """The reference's params with every `gate` leaf set to `value`."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, value)
        if getattr(path[-1], "key", None) == "gate" else a, jax_params)


_SIDES = {}


def _sides(dtype, gate=GATE):
    """-> (jax model, jax params, port model, port params), the gates set
    to `gate` on both sides; cached."""
    key = (dtype, gate)
    if key not in _SIDES:
        cfg = replace(get_config(ARCH).reduced(), dtype=dtype)
        tcfg = replace(torch_get_config(ARCH).reduced(), dtype=dtype)
        jm = jax_build_model(cfg)
        jp = set_gates(jm.init(jax.random.PRNGKey(0)), gate)
        np_params = jax.tree.map(np.array, jp)
        _SIDES[key] = (jm, jax.tree.map(jnp.asarray, np_params),
                       torch_build_model(tcfg, device="cpu"),
                       bridge.to_torch(np_params))
    return _SIDES[key]


def _both(a, dtype):
    """numpy fp32 -> (jax array, torch tensor) rounded to `dtype` alike."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, bridge.leaf_to_torch(np.asarray(j))


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params)


def _embeds(cfg, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _caches_close(tc, jc, dtype, what):
    """Nested cache trees: same dtypes, kv_pos equal, the rest close."""
    if isinstance(tc, dict):
        assert sorted(tc) == sorted(jc), what
        for k in tc:
            _caches_close(tc[k], jc[k], dtype, f"{what}.{k}")
    elif isinstance(tc, (list, tuple)):
        assert len(tc) == len(jc), what
        for i, (t, j) in enumerate(zip(tc, jc)):
            _caches_close(t, j, dtype, f"{what}[{i}]")
    elif what.endswith("kv_pos"):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc),
                                      err_msg=what)
    else:
        assert str(tc.dtype)[6:] == str(jc.dtype), what
        _close(tc, jc, dtype, what)


@pytest.mark.parametrize("over,want", [
    ({}, [(("attn", "cross"), 1)]),
    ({"num_layers": 3}, [(("attn", "cross"), 1), (("attn",), 1)]),
    ({"num_layers": 7, "cross_attn_every": 3},
     [(("attn", "attn", "cross"), 2), (("attn",), 1)]),
    ({"num_layers": 1}, [(("attn",), 1)]),
], ids=["reduced", "remainder", "period 3", "no period"])
def test_vlm_layer_groups_match_reference(over, want):
    cfg = torch_get_config(ARCH).reduced(**over)
    assert layer_groups(cfg) == jax_layer_groups(cfg) == want
    full = torch_get_config(ARCH)
    assert layer_groups(full) == jax_layer_groups(full) == \
        [(("attn",) * 4 + ("cross",), 20)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gates_start_closed_and_cross_the_bridge(dtype):
    """The port's own init makes each `gate` [count, 1] zeros, as the
    reference's; an opened gate crosses the bridge both ways with its
    bits (the rest of the tree's bridge, init shapes and decode caches:
    tests/test_torch_archs.py, whose FAMILIES hold vlm); the cross
    decode cache is [count, B, num_image_tokens, K, Dh]."""
    _, jp, tm, tp = _sides(dtype)
    own = tm.init(torch.Generator().manual_seed(0))
    gates = [t for k, t in flatten_with_path(own) if k.endswith("['gate']")]
    assert len(gates) == 1 and gates[0].shape == (1, 1)
    assert gates[0].dtype == tp["groups"][0][1]["gate"].dtype
    assert not gates[0].any()
    assert float(tp["groups"][0][1]["gate"][0, 0]) == GATE
    back = bridge.to_numpy(tp)["groups"][0][1]["gate"]
    want = np.asarray(jp["groups"][0][1]["gate"])
    if want.dtype.name == "bfloat16":
        want = want.view(np.uint16)
    assert back.dtype == want.dtype and np.array_equal(back, want)
    assert tm.init_decode_caches(3, 40)[0][1]["k"].shape == (1, 3, 16, 2, 64)


@pytest.mark.parametrize("S", [40, 8], ids=["Sq>Sk", "Sq<Sk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_train_matches_reference(dtype, S):
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(S)
    jx, tx = _both(rng.normal(size=(B, S, cfg.d_model)), dtype)
    jmem, tmem = _both(_embeds(cfg, S), dtype)
    want, _ = jlayers.cross_train(_layer(jp["groups"][0][1], 0), jx, cfg,
                                  {"image_embeds": jmem})
    with torch.no_grad():
        got, aux = tlayers.cross_train(_slice(tp["groups"][0][1], 0), tx,
                                       tm.cfg, {"image_embeds": tmem})
    assert got.dtype == tx.dtype
    _close(got, want, dtype, "cross_train output")
    assert float(aux["lb"]) == float(aux["z"]) == 0.0


@pytest.mark.parametrize("S", [24, 8], ids=["Sq>Sk", "Sq<Sk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_prefill_and_decode_match_reference(dtype, S):
    """One `cross` layer: prefill over S tokens (its output and the {"k",
    "v"} cache of the image embeddings), then three decode steps that
    read that cache and leave it as it was."""
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(S + 7)
    jmem, tmem = _both(_embeds(cfg, S + 7), dtype)
    jx, tx = _both(rng.normal(size=(B, S, cfg.d_model)), dtype)
    jlp, tlp = _layer(jp["groups"][0][1], 0), _slice(tp["groups"][0][1], 0)
    want, jc = jlayers.cross_prefill(jlp, jx, cfg, {"image_embeds": jmem})
    with torch.no_grad():
        got, tc = tlayers.cross_prefill(tlp, tx, tm.cfg,
                                        {"image_embeds": tmem})
    _close(got, want, dtype, "cross prefill output")
    _caches_close(tc, jc, dtype, "cross prefill cache")
    assert tc["k"].shape == (B, cfg.num_image_tokens, cfg.num_kv_heads,
                             cfg.resolved_head_dim)
    kept = {k: v.clone() for k, v in tc.items()}
    for step in range(3):
        jx1, tx1 = _both(rng.normal(size=(B, 1, cfg.d_model)), dtype)
        want, jc = jlayers.cross_decode(jlp, jx1, jc, cfg, {})
        with torch.no_grad():
            got, tc2 = tlayers.cross_decode(tlp, tx1, tc, tm.cfg, {})
        assert tc2 is tc and all(torch.equal(tc[k], kept[k]) for k in tc)
        _close(got, want, dtype, f"cross decode output, step {step}")


@pytest.mark.parametrize("emb", ["model dtype", "float32"])
@pytest.mark.parametrize("S", [24, 8], ids=["Sq>Sk", "Sq<Sk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_prefill_then_decode_match_reference(dtype, S, emb):
    """`Model.prefill` over a bucket-padded prompt (`true_len`) with the
    image embeddings, then four `decode_step`s: logits and every cache
    leaf after each. fp32 embeddings under bf16 weights give fp32 cross
    K/V on both sides (the reference's promotion), and decode reads
    them so."""
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(S + 1)
    toks = rng.integers(3, cfg.vocab_size, size=(B, S + 4)).astype(np.int32)
    n = S - 3
    prompt = toks[:, :S].copy()
    prompt[:, n:] = 0                           # bucket padding
    jim, tim = _both(_embeds(cfg, S),
                     dtype if emb == "model dtype" else "float32")
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt),
                             "image_embeds": jim}, cache_len=S + 8,
                        true_len=n)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt),
                                 "image_embeds": tim}, cache_len=S + 8,
                            true_len=n)
    assert tc[0][1]["k"].dtype == torch.promote_types(tim.dtype,
                                                      tp["groups"][0][1]
                                                      ["attn"]["wk"].dtype)
    _close(tl, jl, dtype, "prefill logits")
    _caches_close(tc, jc, dtype, "prefill caches")
    pos = np.full(B, n, np.int32)
    for step in range(4):
        tok = toks[:, n + step]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
        assert tc2 is tc                        # written in place
        _close(tl, jl, dtype, f"decode logits, step {step}")
        _caches_close(tc, jc, dtype, f"decode caches, step {step}")
        pos = pos + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_caches_from_init_take_the_prefill(dtype):
    """A prefill's caches copied into `init_decode_caches` decode as the
    prefill's own."""
    _, _, tm, tp = _sides(dtype)
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(3, cfg.vocab_size, size=(B, 17)).astype(np.int32)
    _, tim = _both(_embeds(cfg, 5), dtype)
    tc0 = tm.init_decode_caches(B, 20)
    with torch.no_grad():
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16]),
                                "image_embeds": tim}, cache_len=20)
        for g_dst, g_src in zip(tc0, tc):
            for d, s in zip(g_dst, g_src):
                for name in d:
                    d[name].copy_(s[name])
        pos = torch.full((B,), 16, dtype=torch.int32)
        tok = torch.from_numpy(toks[:, 16])
        a, _ = tm.decode_step(tp, tc, tok, pos)
        b, _ = tm.decode_step(tp, tc0, tok, pos)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_reference(dtype):
    """`Model.loss` and every gradient leaf on the reference's
    `RandomTokenPipeline` batch as drawn (fp32 image embeddings; under
    bf16 weights both sides promote the cross K/V to fp32), S = 40 text
    tokens over 16 image tokens."""
    from repro.training.data import RandomTokenPipeline
    jm, jp, tm, tp = _sides(dtype)
    b = next(RandomTokenPipeline(jm.cfg, 40, B, seed=4))
    assert b["image_embeds"].dtype == np.float32
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    flat = [v.detach().requires_grad_() for v in leaves(tp)]
    tl, _ = tm.loss(unflatten(tp, flat), tb)
    tg = torch.autograd.grad(tl, flat)
    tl = tl.detach()
    fp32 = dtype == "float32"
    assert float(tl) == pytest.approx(float(jl), rel=1e-5 if fp32 else 1e-4)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    names = [k for k, _ in flatten_with_path(tp)]
    assert len(jflat) == len(names) == len(tg)
    for (jk, jv), name, t in zip(jflat, names, tg):
        assert jax.tree_util.keystr(jk) == name
        want = np.asarray(jv, np.float32)
        top = max(np.abs(want).max(), 1e-30)
        tol = 1e-4 * top if fp32 else 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
        err = np.abs(t.float().numpy() - want).max()
        assert err <= tol, (name, err, top)
        if name.endswith("['gate']"):
            assert abs(want).max() > 0      # the gate is open: it learns


def test_logits_follow_the_image_embeddings():
    """With the gates open, other image embeddings give other logits, on
    both sides alike; with the gates at zero (as initialised) the cross
    layers add nothing and the logits do not move."""
    toks = np.random.default_rng(9).integers(3, 500, (B, 12)).astype(
        np.int32)
    for gate, moves in ((GATE, True), (0.0, False)):
        jm, jp, tm, tp = _sides("float32", gate)
        outs = []
        for seed in (1, 2):
            jim, tim = _both(_embeds(jm.cfg, seed), "float32")
            jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                    "image_embeds": jim})
            with torch.no_grad():
                tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                        "image_embeds": tim})
            _close(tl, jl, "float32", f"logits, gate {gate}")
            outs.append(tl)
        diff = (outs[0] - outs[1]).abs().max().item()
        assert (diff > 1e-2) if moves else diff == 0.0, (gate, diff)


def test_batch_without_image_embeds_fails_as_the_reference():
    """A grammar pipeline's batch has no image embeddings: both sides
    raise KeyError('image_embeds') rather than run on made-up ones."""
    jm, jp, tm, tp = _sides("float32")
    toks = np.zeros((B, 16), np.int32)
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": np.ones((B, 16), np.float32)}
    with pytest.raises(KeyError, match="image_embeds"):
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(KeyError, match="image_embeds"):
        tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
