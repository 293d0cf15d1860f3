"""The port's audio family (Whisper: the `enc` and `dec` layer kinds and
the encoder-decoder `Model`) against the reference's, on the reduced
whisper-base config (`cfg.reduced()`: 2 encoder and 2 decoder layers,
d_model 256, 4 query heads over 2 KV heads of 64, 32 frames) with the
reference's `Model.init(PRNGKey(0))` params bridged leaf by leaf.

Checked: `enc_train` and `_encode_frames`; `dec_prefill` (output and the
nested {"self", "cross"} cache) and `dec_decode` against it; the whole
`Model.prefill` then several `decode_step`s, logits and every cache
leaf; in fp32 and bf16. The text is longer than the 32 frames (S = 40,
plus S = 12 below them), so cross attention runs Sq > Sk and Sq < Sk.
Frames are given in the model's dtype on both sides, except where a test
feeds the random pipeline's fp32 frames under bf16 weights: then both
sides run the encoder in fp32 (JAX's promotion; the port's `matmul`
upcasts the weights) and the decoder's cross K/V in fp32. A batch
without frames fails on both sides alike.

Tolerances as in tests/test_torch_archs.py: fp32 within atol 1e-4 plus
rtol 2e-6 (the frameworks sum matrix products in other orders); bf16
four bf16 ulps at the compared tensor's largest magnitude, at least
2**-3 (both sides round at the same points: rms_norm's inverse, RoPE's
cast back, q's scale, P before P.V; only the order of the fp32 sums
feeding those roundings differs). `kv_pos` must be equal."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import layers as tlayers
from repro_torch.models.model import _slice
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.models.model import layer_groups
from repro_torch.training.tree import flatten_with_path, leaves, unflatten

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
B = 2


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


_SIDES = {}


def _sides(dtype):
    """-> (jax model, jax params, port model, port params), cached."""
    if dtype not in _SIDES:
        cfg = replace(get_config("whisper-base").reduced(), dtype=dtype)
        tcfg = replace(torch_get_config("whisper-base").reduced(),
                       dtype=dtype)
        jm = jax_build_model(cfg)
        np_params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
        _SIDES[dtype] = (jm, jax.tree.map(jnp.asarray, np_params),
                         torch_build_model(tcfg, device="cpu"),
                         bridge.to_torch(np_params))
    return _SIDES[dtype]


def _both(a, dtype):
    """numpy fp32 -> (jax array, torch tensor) rounded to `dtype` alike."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, bridge.leaf_to_torch(np.asarray(j))


def _layer(params, i):
    """Layer i of a stacked param tree."""
    return jax.tree.map(lambda a: a[i], params)


def _frames(cfg, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.audio_frames, cfg.d_model)).astype(np.float32)


def test_audio_layer_groups_match_reference():
    from repro.models.model import layer_groups as jax_layer_groups
    for cfg in (torch_get_config("whisper-base"),
                torch_get_config("whisper-base").reduced()):
        assert layer_groups(cfg) == jax_layer_groups(cfg) == \
            [(("dec",), cfg.num_layers)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_enc_train_matches_reference(dtype):
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    jx, tx = _both(_frames(cfg, 1), dtype)
    for i in range(cfg.encoder_layers):
        want, _ = jlayers.enc_train(_layer(jp["encoder"][0], i), jx, cfg, {})
        with torch.no_grad():
            got, aux = tlayers.enc_train(
                _slice(tp["encoder"][0], i), tx, tm.cfg, {})
        assert got.dtype == tx.dtype
        _close(got, want, dtype, f"enc layer {i}")
        assert float(aux["lb"]) == float(aux["z"]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_frames_matches_reference(dtype):
    jm, jp, tm, tp = _sides(dtype)
    jx, tx = _both(_frames(jm.cfg, 2), dtype)
    want = jm._encode_frames(jp, jx)
    with torch.no_grad():
        got = tm._encode_frames(tp, tx)
    _close(got, want, dtype, "encoder output")


def test_frames_are_cast_to_the_model_dtype():
    """bf16 model: frames in the model's dtype run the encoder in it;
    fp32 frames are no longer cast (the encoder promotes to fp32, as the
    reference's does): the output is fp32 and equals the reference's on
    the same frames within the fp32 tolerance, and differs from what the
    frames' bf16 rounding gives."""
    jm, jp, tm, tp = _sides("bfloat16")
    fr = _frames(tm.cfg, 3)
    with torch.no_grad():
        a = tm._encode_frames(tp, torch.from_numpy(fr))
        b = tm._encode_frames(tp, torch.from_numpy(fr).bfloat16())
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
    _close(a, jm._encode_frames(jp, jnp.asarray(fr)), "float32",
           "fp32 encoder output")
    assert not torch.equal(a, b.float())


def test_fp32_frames_under_bf16_weights_departure():
    """The training path as the random pipeline feeds it: a bf16 model and
    the `RandomTokenPipeline` batch as drawn (fp32 frames) on both sides,
    loss and gradients. Once a departure (the port cast the frames to
    bf16; loss 1.84e-4 relative, gradients up to 2.3e-2 of a leaf's
    largest magnitude), now a parity test: both sides run the encoder in
    fp32 and the decoder's cross attention over fp32 K/V. Held to: the
    loss within 1e-4 relative, each gradient leaf within four bf16 ulps
    of its largest magnitude (tests/test_torch_vlm.py's bf16 rule). What
    is left of the gap (8.1e-5 on the loss, at most 1.8e-2 of a leaf's
    largest magnitude, CPU): with 32 frames, within one KV chunk of the
    reduced config, the reference rounds P to q's dtype (bf16) before
    P.V, where the fp32 route keeps it in fp32 (as the reference does
    past one chunk: 1500 frames at full size)."""
    from repro.training.data import RandomTokenPipeline
    jm, jp, tm, tp = _sides("bfloat16")
    b = next(RandomTokenPipeline(jm.cfg, 40, B, seed=4))
    assert b["frames"].dtype == np.float32
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    flat = [v.detach().requires_grad_() for v in leaves(tp)]
    tl, _ = tm.loss(unflatten(tp, flat), tb)
    tg = torch.autograd.grad(tl, flat)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-4)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    names = [k for k, _ in flatten_with_path(tp)]
    assert len(jflat) == len(names) == len(tg)
    for (jk, jv), name, t in zip(jflat, names, tg):
        assert jax.tree_util.keystr(jk) == name
        want = np.asarray(jv, np.float32)
        top = max(np.abs(want).max(), 1e-30)
        err = np.abs(t.float().numpy() - want).max()
        assert err <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7), \
            (name, err, top)


def _caches_close(tc, jc, dtype, what):
    """Nested cache trees: kv_pos equal, every other leaf close."""
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


@pytest.mark.parametrize("S", [40, 12], ids=["Sq>Sk", "Sq<Sk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dec_prefill_and_decode_match_reference(dtype, S):
    """One `dec` layer: prefill over S tokens (its self cache and the
    cross K/V of the encoder's output), then three decode steps against
    that nested cache (the self cache written in place)."""
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(S)
    jmem, tmem = _both(rng.normal(size=(B, cfg.audio_frames, cfg.d_model)),
                       dtype)
    jx, tx = _both(rng.normal(size=(B, S, cfg.d_model)), dtype)
    jlp, tlp = _layer(jp["groups"][0][0], 1), _slice(tp["groups"][0][0], 1)
    ctx = {"cache_len": S + 3}
    want, jc = jlayers.dec_prefill(jlp, jx, cfg, dict(ctx, enc_out=jmem))
    with torch.no_grad():
        got, tc = tlayers.dec_prefill(tlp, tx, tm.cfg, dict(ctx, enc_out=tmem))
    _close(got, want, dtype, "dec prefill output")
    _caches_close(tc, jc, dtype, "dec prefill cache")
    assert tc["cross"]["k"].shape == (B, cfg.audio_frames, cfg.num_kv_heads,
                                      cfg.resolved_head_dim)
    for step in range(3):
        jx1, tx1 = _both(rng.normal(size=(B, 1, cfg.d_model)), dtype)
        pos = np.full(B, S + step, np.int32)
        want, jc = jlayers.dec_decode(jlp, jx1, jc, cfg,
                                      {"pos": jnp.asarray(pos)})
        with torch.no_grad():
            got, tc2 = tlayers.dec_decode(tlp, tx1, tc, tm.cfg,
                                          {"pos": torch.from_numpy(pos)})
        assert tc2 is tc
        _close(got, want, dtype, f"dec decode output, step {step}")
        _caches_close(tc, jc, dtype, f"dec decode cache, step {step}")


@pytest.mark.parametrize("S", [40, 12], ids=["Sq>Sk", "Sq<Sk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_prefill_then_decode_match_reference(dtype, S):
    """`Model.prefill` over a bucket-padded prompt (`true_len`) with the
    frames, then four `decode_step`s: logits and every cache leaf (the
    stacked nested `dec` caches) after each."""
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    rng = np.random.default_rng(S + 1)
    toks = rng.integers(3, cfg.vocab_size, size=(B, S + 4)).astype(np.int32)
    n = S - 3
    prompt = toks[:, :S].copy()
    prompt[:, n:] = 0                           # bucket padding
    jfr, tfr = _both(_frames(cfg, S), dtype)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt), "frames": jfr},
                        cache_len=S + 8, true_len=n)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt),
                                 "frames": tfr}, cache_len=S + 8, true_len=n)
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
    """`init_decode_caches` has the reference's tree, shapes and dtypes
    (its values differ as for every kind: the port marks empty slots
    kv_pos -1 where the reference zeroes them), and a prefill's caches
    copied into it decode as the prefill's own."""
    jm, jp, tm, tp = _sides(dtype)
    cfg = jm.cfg
    jc0 = jm.init_decode_caches(B, 20)
    tc0 = tm.init_decode_caches(B, 20)
    jflat = jax.tree_util.tree_leaves_with_path(jc0)
    tflat = jax.tree_util.tree_leaves_with_path(bridge.to_numpy(tc0))
    assert [(p, np.shape(a), str(a.dtype)) for p, a in jflat] == \
        [(p, np.shape(a), str(jnp.asarray(a).dtype) if a.dtype != np.uint16
          else "bfloat16") for p, a in tflat]
    rng = np.random.default_rng(5)
    toks = rng.integers(3, cfg.vocab_size, size=(B, 17)).astype(np.int32)
    _, tfr = _both(_frames(cfg, 5), dtype)
    with torch.no_grad():
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16]),
                                "frames": tfr}, cache_len=20)
        for g_dst, g_src in zip(tc0, tc):
            for d, s in zip(g_dst, g_src):
                for part in ("self", "cross"):
                    for name in d[part]:
                        d[part][name].copy_(s[part][name])
        pos = torch.full((B,), 16, dtype=torch.int32)
        tok = torch.from_numpy(toks[:, 16])
        a, _ = tm.decode_step(tp, tc, tok, pos)
        b, _ = tm.decode_step(tp, tc0, tok, pos)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_matches_reference(dtype):
    """`Model.loss` on a random-token batch with frames (the reference's
    `RandomTokenPipeline` batch): fp32 within 1e-5 relative, bf16 within
    1% (an fp32 mean over bf16 logits rounded at other points)."""
    from repro.training.data import RandomTokenPipeline
    jm, jp, tm, tp = _sides(dtype)
    b = next(RandomTokenPipeline(jm.cfg, 40, B, seed=4))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["frames"] = jb["frames"].astype(jnp.dtype(dtype))
    tb = {k: bridge.leaf_to_torch(np.asarray(v)) for k, v in jb.items()}
    jl = float(jm.loss(jp, jb)[0])
    with torch.no_grad():
        tl = float(tm.loss(tp, tb)[0])
    assert tl == pytest.approx(jl, rel=1e-5 if dtype == "float32" else 0.01)


def test_batch_without_frames_fails_as_the_reference():
    """A grammar pipeline's batch has no frames: both sides raise
    KeyError('frames') rather than run on made-up frames."""
    jm, jp, tm, tp = _sides("float32")
    toks = np.zeros((B, 16), np.int32)
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": np.ones((B, 16), np.float32)}
    with pytest.raises(KeyError, match="frames"):
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(KeyError, match="frames"):
        tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
