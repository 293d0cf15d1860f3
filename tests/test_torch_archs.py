"""The port's `Model` for the moe, ssm and hybrid archs and the four
remaining text configs (qwen1.5-0.5b's QKV bias, internlm2-1.8b,
deepseek-coder-33b, kimi-k2-1t-a32b's leading dense layer before its MoE
layers) against the reference's, on reduced configs (`cfg.reduced()`, as
tests/test_models_smoke.py) with the reference's `Model.init(PRNGKey(0))`
params bridged leaf by leaf.

Checked, per family: prefill logits and every cache leaf, then decode
steps (logits and caches after each); a hybrid whose depth leaves a
remainder group (num_layers 3 over the pattern ("rec", "attn")) and one
whose local window is shorter than the prompt (the attention ring
wraps); the bridge round trip of each param tree (fp32 router, A_log /
D / dt_bias, lam, the remainder group); `init_decode_caches` shapes and
dtypes; `prefill_padding_safe`, `supports_span_decode` and the paged
pool refusal equal to the reference's; vlm built from the reference's
config. The audio and vlm families' bridges (the "encoder" group, the
`gate` leaves), decode caches (the nested `dec` tree, the `cross` K/V)
and serving properties are held here too; their prefill and decode in
tests/test_torch_audio.py and tests/test_torch_vlm.py.

Tolerances as in tests/test_torch_model.py: fp32 within atol 1e-4 plus
rtol 2e-6; bf16 by that file's rule, four bf16 ulps at the compared
tensor's largest magnitude, which is its atol 2**-3 where that magnitude
is about 5 (the untied MoE's logits) and grows with it: the tied
embeddings of mamba2 and recurrentgemma (scale 1.0, d_model 256) give
logits up to about 200, where one bf16 ulp is 1.0, and the recurrent
state leaves grow likewise. The rule holds for every leaf of a bf16 run,
fp32 recurrent state included (its inputs are bf16 activations that the
two frameworks round at different points; XLA may keep a fused
elementwise chain in fp32). `kv_pos` must be equal.

Routing near a tie (bf16 moe only: qwen3-moe and kimi-k2): where the k-th and (k+1)-th router
probabilities of a token lie within 2**-8 of each other in some layer,
a bf16 rounding difference upstream (a few ulps of the layer's input,
about 6e-4 in probability at these widths) may choose another expert on
one side, which moves that token's output by O(1) and, through
attention, every later position of its row. Such a row is compared only
before its first near-tie (logits and caches), and at least half the
rows must have none. fp32 routing is compared everywhere."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model as jax_build_model
from repro.models.model import layer_groups as jax_layer_groups
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.models.model import layer_groups

torch.set_num_threads(1)

def _tol(dtype, want):
    if dtype == "float32":
        return dict(atol=1e-4, rtol=2e-6)
    top = float(np.abs(want).max()) if np.size(want) else 0.0
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    return dict(atol=max(2.0 ** -3, 4 * ulp), rtol=0)

FAMILIES = {"moe": "qwen3-moe-30b-a3b", "ssm": "mamba2-370m",
            "hybrid": "recurrentgemma-9b", "audio": "whisper-base",
            "vlm": "llama-3.2-vision-90b"}


def _pair(arch, dtype, **over):
    cfg = replace(get_config(arch).reduced(), dtype=dtype, **over)
    tcfg = replace(torch_get_config(arch).reduced(), dtype=dtype, **over)
    jm = jax_build_model(cfg)
    np_params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    return (jm, jax.tree.map(jnp.asarray, np_params),
            torch_build_model(tcfg, device="cpu"),
            bridge.to_torch(np_params), np_params)


def _close(got, want, dtype, what):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, err_msg=what,
                               **_tol(dtype, want))


def _assert_caches(tc, jc, dtype):
    assert len(tc) == len(jc)
    for tg, jg in zip(tc, jc):
        assert len(tg) == len(jg)
        for t, j in zip(tg, jg):
            assert sorted(t) == sorted(j)
            for name in t:
                if name == "kv_pos":
                    np.testing.assert_array_equal(np.asarray(t[name]),
                                                  np.asarray(j[name]))
                else:
                    _close(t[name], j[name], dtype, f"{name} cache")


# (arch, dtype, config overrides, prompt length, padded bucket)
CASES = [
    ("qwen3-moe-30b-a3b", "float32", {}, 11, 16),
    ("qwen3-moe-30b-a3b", "bfloat16", {}, 11, 16),
    ("mamba2-370m", "float32", {}, 13, 13),
    ("mamba2-370m", "bfloat16", {}, 13, 13),
    ("recurrentgemma-9b", "float32", {}, 13, 13),
    ("recurrentgemma-9b", "bfloat16", {}, 13, 13),
    ("recurrentgemma-9b", "float32", {"num_layers": 3}, 9, 9),
    ("recurrentgemma-9b", "float32", {"local_window": 8}, 12, 12),
    ("qwen1.5-0.5b", "float32", {}, 11, 16),
    ("qwen1.5-0.5b", "bfloat16", {}, 11, 16),
    ("internlm2-1.8b", "float32", {}, 11, 16),
    ("internlm2-1.8b", "bfloat16", {}, 11, 16),
    ("deepseek-coder-33b", "float32", {}, 11, 16),
    ("deepseek-coder-33b", "bfloat16", {}, 11, 16),
    ("kimi-k2-1t-a32b", "float32", {}, 11, 16),
    ("kimi-k2-1t-a32b", "bfloat16", {}, 11, 16),
]


class _Margins:
    """Records, per call of the port's MoE FFN, each token's gap between
    its k-th and (k+1)-th router probability ([B, S] per layer)."""

    def __init__(self, monkeypatch):
        import repro_torch.models.layers as layers
        self.calls = []
        orig = layers.moe_ffn

        def spy(p, x, cfg):
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            k = cfg.experts_per_token
            self.calls.append((top[..., k - 1] - top[..., k]).numpy())
            return orig(p, x, cfg)

        monkeypatch.setattr(layers, "moe_ffn", spy)

    def first_tie(self, B, S):
        """-> [B] first position of each row with a near-tie in any layer
        of the calls since the last read (S: none); resets the record."""
        first = np.full(B, S)
        for m in self.calls:
            hit = m.reshape(B, -1) < 2.0 ** -8
            for b in range(B):
                if hit[b].any():
                    first[b] = min(first[b], int(np.argmax(hit[b])))
        self.calls = []
        return first


def _rows(tree, rows):
    """The cache tree as numpy (fp32, kv_pos int) restricted to the batch
    rows `rows`."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.float().numpy() if v.is_floating_point() else v.numpy()
        a = np.asarray(v)
        return a if a.dtype.kind in "iu" else a.astype(np.float32)

    return [tuple({k: host(v)[:, rows] for k, v in c.items()} for c in g)
            for g in tree]


@pytest.mark.parametrize("arch,dtype,over,n,S", CASES, ids=str)
def test_prefill_then_decode_match_reference(arch, dtype, over, n, S,
                                             monkeypatch):
    jm, jp, tm, tp, _ = _pair(arch, dtype, **over)
    assert [g for g in layer_groups(tm.cfg)] == \
        [g for g in jax_layer_groups(jm.cfg)]
    ties = _Margins(monkeypatch) if jm.cfg.arch_type == "moe" and \
        dtype == "bfloat16" else None
    V = jm.cfg.vocab_size
    B = 4
    rng = np.random.default_rng(0)
    toks = rng.integers(3, V, size=(B, S + 4)).astype(np.int32)
    prompt = toks[:, :S].copy()
    prompt[:, n:] = 0                           # bucket padding
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=32,
                        true_len=n)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                        cache_len=32, true_len=n)
    first = ties.first_tie(B, S) if ties else np.full(B, S)
    for b in range(B):
        _close(tl[b, :first[b]], np.asarray(jl)[b, :first[b]], dtype,
               f"prefill logits, row {b}")
    live = [b for b in range(B) if first[b] == S]
    assert len(live) >= B // 2, first
    _assert_caches(_rows(tc, live), _rows(jc, live), dtype)
    pos = np.full(B, n, np.int32)
    for step in range(4):
        tok = toks[:, n + step]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert tc2 is tc                        # written in place
        if ties:
            live = [b for b, f in enumerate(ties.first_tie(B, 1))
                    if f and b in live]
        assert len(live) >= B // 2
        _close(tl[live], np.asarray(jl, np.float32)[live], dtype,
               f"decode logits, step {step}")
        _assert_caches(_rows(tc, live), _rows(jc, live), dtype)
        pos = pos + 1


def test_hybrid_remainder_group():
    cfg = torch_get_config("recurrentgemma-9b").reduced(num_layers=3)
    assert layer_groups(cfg) == [(("rec", "attn"), 1), (("rec",), 1)]
    full = torch_get_config("recurrentgemma-9b")
    assert layer_groups(full) == [(("rec", "rec", "attn"), 12),
                                  (("rec", "rec"), 1)]


@pytest.mark.parametrize("arch", list(FAMILIES.values()) +
                         ["recurrentgemma-9b+3"])
def test_bridge_round_trip_and_decode_caches(arch):
    over = {"num_layers": 3} if arch.endswith("+3") else {}
    arch = arch.split("+")[0]
    jm, _, tm, tp, np_params = _pair(arch, "bfloat16", **over)
    back = bridge.to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # a port tree from the port's own init has the reference's layout
    gen = torch.Generator().manual_seed(0)
    own = tm.init(gen)
    shapes = lambda t: [(p, tuple(np.shape(x))) for p, x in
                        jax.tree_util.tree_leaves_with_path(t)]
    assert shapes(bridge.to_numpy(own)) == shapes(np_params)
    jc = jm.init_decode_caches(3, 40)
    tc = tm.init_decode_caches(3, 40)
    assert shapes(bridge.to_numpy(tc)) == shapes(jax.tree.map(np.asarray,
                                                              jc))
    dtypes = lambda t: [str(x.dtype).removeprefix("torch.") for x in
                        jax.tree_util.tree_leaves(t)]
    assert dtypes(tc) == dtypes(jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_serving_properties_match_reference(arch):
    jm, _, tm, _, _ = _pair(arch, "float32")
    assert tm.prefill_padding_safe == jm.prefill_padding_safe
    assert tm.supports_span_decode == jm.supports_span_decode
    if jm.supports_span_decode:
        tm.init_paged_caches(4, 16)
        return
    with pytest.raises(ValueError) as want:
        jm.init_paged_caches(4, 16)
    with pytest.raises(ValueError) as got:
        tm.init_paged_caches(4, 16)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b"])
def test_vlm_builds(arch):
    """The vlm arch, refused until its `cross` kind was ported, builds
    from the reference's config: its groups are the reference's (one
    (attn, cross) period at the reduced size), and its params have the
    reference's tree and shapes."""
    from repro_torch.models.config import ModelConfig
    cfg = get_config(arch).reduced()
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    tm = torch_build_model(ModelConfig(**fields), device="cpu")
    assert layer_groups(tm.cfg) == jax_layer_groups(cfg) == \
        [(("attn", "cross"), 1)]
    own = bridge.to_numpy(tm.init(torch.Generator()))
    want = jax_build_model(cfg).abstract_params()
    shapes = lambda t: [(p, tuple(np.shape(x))) for p, x in
                        jax.tree_util.tree_leaves_with_path(t)]
    assert shapes(own) == shapes(want)
