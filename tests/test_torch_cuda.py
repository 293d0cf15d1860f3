"""The port's CUDA kernels on the card against their plain versions on the
same card (no JAX here: the card's machine need not have it).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs an NVIDIA Hopper card and the CUDA toolkit (`nvcc`,
sm_90a); without a card each one skips. The kernels are built from
`src/repro_torch/csrc` on first use.

Tolerances: fused_select's `masked`, `ok` and greedy ids bitwise; sampled
ids equal on every row kept 1e-5 away from the nucleus edge (the kernel
sums the softmax mass in another order than `torch.cumsum`). Attention
within atol 1e-5 in fp32 and 2**-6 in bf16 (two bf16 ulps at the values'
scale: the kernel and the plain version round q's scale and P to bf16 at
the same points; only fp32 sum orders differ)."""
import numpy as np
import pytest
import torch

from _torch_select_cases import B as B_CASE
from _torch_select_cases import (CASES, EXPECTED_ROUTES, case_inputs,
                                 mask_np, routes)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _off_edge(scaled, top_k, top_p, edge=1e-5):
    """top_p moved `edge` away from each row's cumulative softmax."""
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
        if np.abs(cum - p).min() > edge:
            continue
        i = int(np.searchsorted(cum, p))
        lo = cum[i - 1] if i > 0 else 0.0
        top_p[b] = np.float32((lo + cum[min(i, cum.size - 1)]) / 2)
    return top_p


@pytest.mark.parametrize("B,V,R,A", [(1, 512, 32, 4), (4, 2048, 300, 12),
                                     (3, 1024, 64, 48), (8, 49152, 200, 48),
                                     (4, 2048, 300, 96),
                                     (8, 50280, 200, 48),
                                     (8, 151936, 200, 48),
                                     (8, 256000, 200, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_select_kernel_matches_plain(dev, B, V, R, A, dtype):
    """Random store words (the tail word's bits past V too, which the
    kernel must not read), and the vocabularies of mamba2-370m (50280,
    not a multiple of 32), qwen3-moe (151936) and recurrentgemma
    (256000)."""
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import fused_select_ref
    from repro_torch.kernels.masked_logits.ref import masked_logits_ref
    rng = np.random.default_rng(B * V + A)
    W = -(-V // 32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    store = t(rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
              .view(np.int32))
    rows = t(rng.integers(-1, R, size=(B, A)).astype(np.int32))
    cdn = rng.integers(0, 2 ** 32, size=(B, W), dtype=np.uint32)
    cdn[rng.random(B) < 0.5] = 0
    cd = t(cdn.view(np.int32))
    logits = t((rng.normal(size=(B, V)) * 2).astype(np.float32)).to(dtype)
    eos, cons, greedy = (t(rng.random(B) < 0.5) for _ in range(3))
    temp = t(rng.uniform(0.4, 1.6, size=B).astype(np.float32))
    top_k = rng.integers(0, 50, size=B).astype(np.int32)
    top_k[0] = V + 5
    top_p = rng.uniform(0.5, 1.2, size=B).astype(np.float32)
    masked = masked_logits_ref(logits, store, rows, eos, constrained=cons,
                               cd=cd)
    scaled = (masked.float() / temp.clamp(min=1e-6)[:, None]).cpu().numpy()
    top_p = t(_off_edge(scaled, top_k, top_p))
    top_k = t(top_k)
    noise = -torch.log(-torch.log(torch.rand(
        (B, V), device=dev, generator=torch.Generator(dev).manual_seed(3))
        .clamp(min=torch.finfo(torch.float32).tiny)))
    args = (logits, store, rows, cd, eos, cons, greedy, temp, top_k, top_p)
    for nz in (None, noise):
        before = fused_mask_select.launches
        ik, mk, ok_k = fused_mask_select(*args, noise=nz)
        assert fused_mask_select.launches == before + 1
        ir, mr, ok_r = fused_select_ref(*args, noise=nz)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(mk.view(bits), mr.view(bits))
        assert torch.equal(ok_k, ok_r)
        assert torch.equal(ik, ir), (ik, ir)


@pytest.mark.parametrize("B,S,V,A", [(8, 8, 49152, 48), (2, 3, 1024, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_select_span_form_matches_batch_form(dev, B, S, V, A, dtype):
    """`fused_mask_select_span` on the card is the batch kernel on the
    flattened B*S rows (one launch): ids, masked and ok bitwise equal to
    the batch form's, greedy and sampled."""
    from repro_torch.kernels.fused_select.ops import (fused_mask_select,
                                                      fused_mask_select_span)
    rng = np.random.default_rng(B * S + A)
    W, R, N = V // 32, 300, B * S
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    store = t(rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
              .view(np.int32))
    rows = t(rng.integers(-1, R, size=(B, S, A)).astype(np.int32))
    cd = t(rng.integers(0, 2 ** 32, size=(B, S, W), dtype=np.uint32)
           .view(np.int32))
    logits = t((rng.normal(size=(B, S, V)) * 2).astype(np.float32)).to(dtype)
    eos, cons = (t(rng.random((B, S)) < 0.5) for _ in range(2))
    greedy = t(rng.random(B) < 0.5)
    temp = t(rng.uniform(0.4, 1.6, size=B).astype(np.float32))
    top_k = t(rng.integers(0, 50, size=B).astype(np.int32))
    top_p = t(rng.uniform(0.5, 1.2, size=B).astype(np.float32))
    noise = -torch.log(-torch.log(torch.rand(
        (B, S, V), device=dev, generator=torch.Generator(dev).manual_seed(5))
        .clamp(min=torch.finfo(torch.float32).tiny)))
    rep = lambda a: torch.repeat_interleave(a, S, dim=0)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for nz in (None, noise):
        before = fused_mask_select.launches
        ids, masked, ok = fused_mask_select_span(
            logits, store, rows, cd, eos, cons, greedy, temp, top_k, top_p,
            noise=nz)
        assert fused_mask_select.launches == before + 1
        fi, fm, fo = fused_mask_select(
            logits.reshape(N, V), store, rows.reshape(N, A),
            cd.reshape(N, W), eos.reshape(N), cons.reshape(N), rep(greedy),
            rep(temp), rep(top_k), rep(top_p),
            noise=None if nz is None else nz.reshape(N, V))
        torch.cuda.synchronize()
        assert torch.equal(ids.reshape(N), fi)
        assert torch.equal(masked.reshape(N, V).view(bits), fm.view(bits))
        assert torch.equal(ok.reshape(N), fo)


@pytest.mark.parametrize("V", [8192, 49152])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_select_edge_rows(dev, case, V, dtype):
    """Rows that reach both routes of the kernel and their edges: bf16
    ties at the k-th value, fewer allowed ids than top_k, an all-masked
    row (ok False, id 0), top_k 0 with top_p < 1, a candidate set over
    the plan's list capacity (and a top_k over it), the engine's resample
    form (rows -1, cd None, unconstrained, one id banned)."""
    from repro_torch.kernels.fused_select.ops import (fused_mask_select,
                                                      launch_plan)
    from repro_torch.kernels.fused_select.ref import fused_select_ref
    cap = launch_plan(V, V // 32, dtype).cap
    x = case_inputs(case, V, cap, seed=CASES.index(case),
                    bf16=dtype == torch.bfloat16)
    assert EXPECTED_ROUTES[case] <= set(routes(x, cap))
    x["top_p"] = _off_edge(mask_np(x) / np.maximum(x["temp"], 1e-6)[:, None],
                           x["top_k"], x["top_p"])
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32
                             else a)).to(dev)
    args = tuple(t(x[n]) for n in ("logits", "store", "rows", "cd", "eos",
                                   "cons", "greedy", "temp", "top_k",
                                   "top_p"))
    args = (args[0].to(dtype),) + args[1:]
    noise = -torch.log(-torch.log(torch.rand(
        (B_CASE, V), device=dev, generator=torch.Generator(dev)
        .manual_seed(5)).clamp(min=torch.finfo(torch.float32).tiny)))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for nz in (None, noise):
        before = fused_mask_select.launches
        ik, mk, ok_k = fused_mask_select(*args, noise=nz)
        assert fused_mask_select.launches == before + 1
        ir, mr, ok_r = fused_select_ref(*args, noise=nz)
        torch.cuda.synchronize()
        assert torch.equal(mk.view(bits), mr.view(bits))
        assert torch.equal(ok_k, ok_r)
        assert torch.equal(ik, ir), (x["top_k"], ik, ir)
    if case == "all_masked":
        assert not ok_k.any() and not ik.any()


def test_fused_select_plan_matches_the_kernel(dev):
    """The wrapper's launch plan asks for the shared memory that the
    kernel uses, for every union width up to the limit."""
    from repro_torch.kernels.fused_select.ops import (MAX_WORDS, _launcher,
                                                      launch_plan)
    lib, _ = _launcher()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for W in (1, 16, 1536, 4748, MAX_WORDS):
            assert lib.fused_select_smem_bytes(code, W) == \
                launch_plan(32 * W, W, dtype).smem
        assert lib.fused_select_smem_bytes(code, MAX_WORDS + 1) == -1


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window,causal", [
    (1, 7, 7, 15, 5, 64, 0, True),
    (2, 1, 1, 4, 2, 32, 0, True),
    (1, 5, 300, 15, 5, 64, 0, True),
    (2, 100, 100, 8, 2, 128, 33, True),
    (1, 77, 129, 6, 3, 32, 0, False),
    (1, 300, 300, 15, 5, 64, 0, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, Sq, Sk, H, K, Dh,
                                              window, causal, dtype):
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    g = torch.Generator(dev).manual_seed(Sq * 1000 + Sk)
    q = torch.randn((B, Sq, H, Dh), device=dev, generator=g).to(dtype)
    k = torch.randn((B, Sk, K, Dh), device=dev, generator=g).to(dtype)
    v = torch.randn((B, Sk, K, Dh), device=dev, generator=g).to(dtype)
    before = attention.launches
    out = attention(q, k, v, causal=causal, window=window)
    assert attention.launches == before + 1
    want = chunked_attention(q, k, v, causal=causal, q_offset=Sk - Sq,
                             window=window)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= atol, err


def _flash_check(dev, B, Sq, Sk, H, K, Dh, window, causal, dtype):
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    g = torch.Generator(dev).manual_seed(Sq * 1000 + Sk + Dh + H)
    q = torch.randn((B, Sq, H, Dh), device=dev, generator=g).to(dtype)
    k = torch.randn((B, Sk, K, Dh), device=dev, generator=g).to(dtype)
    v = torch.randn((B, Sk, K, Dh), device=dev, generator=g).to(dtype)
    before = attention.launches
    out = attention(q, k, v, causal=causal, window=window)
    assert attention.launches == before + 1
    want = chunked_attention(q, k, v, causal=causal, q_offset=Sk - Sq,
                             window=window)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.parametrize("Sq", [1, 15, 16, 17, 65])
@pytest.mark.parametrize("Sk", [0, 300, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_ragged_queries(dev, Sq, Sk, dtype):
    """Ragged q tiles right-aligned to up to 2048 keys (Sk = 0: Sk = Sq);
    the main path's S = 16 prompt bucket is a quarter of a 64-row tile."""
    _flash_check(dev, 1, Sq, Sk or Sq, 15, 5, 64, 0, True, dtype)


@pytest.mark.parametrize("Sq,window", [(2048, 700), (300, 700),
                                       (65, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_at_long_prompts(dev, Sq, window, dtype):
    """A 700-key window over 2048 keys: tiles left of the window are
    skipped and the window's edge falls inside a key tile."""
    _flash_check(dev, 1, Sq, 2048, 15, 5, 64, window, True, dtype)


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dims_and_groups(dev, Dh, G, dtype):
    """Every head_dim instantiation under GQA group sizes 1, 3 and 8
    (query head h reads KV head h // G), two sequences of 130 tokens."""
    _flash_check(dev, 2, 130, 130, 2 * G, 2, Dh, 0, True, dtype)


@pytest.mark.parametrize("Sq,Sk,H,K,Dh,window", [
    (32, 32, 16, 1, 256, 2048), (17, 300, 16, 1, 256, 2048),
    (2048, 2048, 16, 1, 256, 2048), (4096, 4096, 16, 1, 256, 2048),
    (300, 4096, 16, 1, 256, 2048), (130, 130, 4, 2, 256, 0),
    (32, 32, 32, 4, 128, 0), (2048, 2048, 32, 4, 128, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_new_arch_shapes(dev, Sq, Sk, H, K, Dh, window,
                                         dtype):
    """recurrentgemma-9b's local attention (head_dim 256, 16 query heads
    over one KV head, window 2048; at 4096 keys half of them fall out of
    the window) and qwen3-moe-30b-a3b's (head_dim 128, 32 over 4)."""
    _flash_check(dev, 1, Sq, Sk, H, K, Dh, window, True, dtype)


# non-causal attention (an encoder's self-attention, cross attention to
# its frames or image tokens) at Sq < Sk, Sq = Sk and Sq > Sk; Sk 32 and
# 1500 are not multiples of the key tiles (128 forward bf16, 32 fp32, 64
# backward), and the odd Sk 1601 (llama-3.2-vision's image tokens) and
# 17 end inside a pair of keys, which the bf16 backward packs into one
# `mma.sync` fragment register
NONCAUSAL = [(16, 32), (32, 32), (48, 32), (1, 1500), (1500, 1500),
             (2048, 1500), (1, 1601), (16, 1601), (1024, 1601),
             (2048, 1601), (24, 17)]
# query heads over KV heads: MHA, GQA 4 and llama-3.2-vision's 64 over 8
NONCAUSAL_HEADS = dict(argnames="H,K", argvalues=[(8, 8), (8, 2), (64, 8)],
                       ids=["mha", "gqa", "gqa8"])


@pytest.mark.parametrize("Sq,Sk", NONCAUSAL)
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize(**NONCAUSAL_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_non_causal_any_lengths(dev, Sq, Sk, Dh, H, K,
                                                dtype):
    _flash_check(dev, 2, Sq, Sk, H, K, Dh, 0, False, dtype)


@pytest.mark.parametrize("Sq,Sk", NONCAUSAL)
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize(**NONCAUSAL_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_non_causal_any_lengths(dev, Sq, Sk, Dh, H, K,
                                                   dtype):
    """The backward kernel without a mask against `ref.attention_bwd`,
    within the tolerances of `test_attention_backward_kernel_matches_
    plain`: every query tile sees every key tile, and the edges are keys
    past Sk and rows past Sq."""
    _bwd_check(dev, 2, Sq, Sk, H, K, Dh, 0, False, dtype,
               Sq * 3 + Sk + Dh + K)


@pytest.mark.parametrize("Sq,Sk,H,K,Dh", [(48, 32, 8, 2, 64),
                                          (2048, 1500, 8, 8, 64),
                                          (1, 1500, 8, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_non_causal_launches_are_repeatable(dev, Sq, Sk, H, K, Dh, dtype):
    """Two launches of the forward (with its LSE) and of the backward on
    the same non-causal inputs give the same bits."""
    from repro_torch.kernels.flash_attention.ops import (
        attention_backward, attention_with_lse)
    q, k, v, do = _bwd_inputs(dev, 2, Sq, Sk, H, K, Dh, dtype, Sq + Dh)
    first = attention_with_lse(q, k, v, causal=False)
    second = attention_with_lse(q, k, v, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    g1 = attention_backward(q, k, v, *first, do, causal=False)
    g2 = attention_backward(q, k, v, *first, do, causal=False)
    for name, a, b in zip(("dq", "dk", "dv"), g1, g2):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("S", [1, 16, 1024])
def test_cross_attention_bf16_queries_over_fp32_kv(dev, S):
    """The reference's promotion through the model code: bf16 queries of a
    bf16 layer over fp32 K/V of 1601 image tokens (fp32 image embeddings
    under bf16 weights) take the fp32 kernel route (one forward launch)
    and come back in bf16; on the card against the same call on the CPU
    (the plain version), within four bf16 ulps at the output's largest
    magnitude (the fp32 sums differ in order; the casts to bf16 and the
    bf16 output projection may then round apart)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.models.common import init_attention
    from repro_torch.models.layers import _cross_attention, _cross_kv
    cfg = replace(get_config("llama-3.2-vision-90b"), d_model=1024)
    g = torch.Generator().manual_seed(S)
    p = init_attention(g, cfg, torch.bfloat16)
    x = torch.randn((2, S, cfg.d_model), generator=g).bfloat16()
    mem = torch.randn((2, cfg.num_image_tokens, cfg.d_model), generator=g)
    k, v = _cross_kv(p, mem, cfg)
    assert k.dtype == torch.float32 and k.shape[1] == 1601
    want = _cross_attention(p, x, k, v, cfg)
    gp = {n: t.to(dev) for n, t in p.items()}
    before = attention.launches
    got = _cross_attention(gp, x.to(dev), k.to(dev), v.to(dev), cfg)
    assert attention.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    top = want.float().abs().max().item()
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7), (err, top)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 16),
                                           (True, 16)])
def test_positional_mask_at_sq_above_sk_raises(dev, causal, window):
    """Right-aligned, a causal or windowed query past the keys would see
    none: the kernels refuse Sq > Sk there, forward and backward."""
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    q, k, v, do = _bwd_inputs(dev, 1, 48, 32, 8, 2, 64, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="unsupported shapes"):
        attention(q, k, v, causal=causal, window=window)
    lse = torch.zeros((1, 8, 48), device=dev)
    with pytest.raises(ValueError, match="unsupported shapes"):
        attention_backward(q, k, v, q, lse, do, causal=causal, window=window)


def test_model_on_card_matches_cpu(dev):
    """syncode-demo in fp32: prefill (bucket-padded) and decode logits and
    the caches on the card against the same weights on the CPU."""
    from dataclasses import replace
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = replace(get_config("syncode-demo"), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=dev)
    gparams = bridge.to_device(params, dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, size=(2, 24)).astype(np.int64))
    n = 19
    lc, cc = cpu.prefill(params, {"tokens": toks}, cache_len=64, true_len=n)
    lg, cg = gpu.prefill(gparams, {"tokens": toks.to(dev)}, cache_len=64,
                         true_len=n)
    assert (lc - lg.cpu()).abs().max().item() <= 1e-4
    pos = torch.full((2,), n, dtype=torch.int32)
    dc, _ = cpu.decode_step(params, cc, toks[:, n], pos)
    dg, _ = gpu.decode_step(gparams, cg, toks[:, n].to(dev), pos.to(dev))
    assert (dc - dg.cpu()).abs().max().item() <= 1e-4
    assert torch.equal(cc[0][0]["kv_pos"], cg[0][0]["kv_pos"].cpu())


def _mask_inputs(rng, dev, N, V, R, A, W=None):
    W = W or -(-V // 32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    store = t(rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
              .view(np.int32))
    rows = rng.integers(-1, R, size=(N, A)).astype(np.int32)
    rows[0, :] = -1                                  # an empty union
    cdn = rng.integers(0, 2 ** 32, size=(N, W), dtype=np.uint32)
    cdn[rng.random(N) < 0.5] = 0
    eos = rng.random(N) < 0.5
    cons = rng.random(N) < 0.7
    return store, t(rows), t(cdn.view(np.int32)), t(eos), t(cons)


@pytest.mark.parametrize("N,V,R,A", [(1, 49152, 200, 48), (8, 49152, 300, 96),
                                     (3, 1000, 40, 5), (5, 2080, 64, 300),
                                     (2, 4096, 16, 1), (1, 50280, 200, 48),
                                     (8, 50280, 300, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_logits_kernel_matches_plain(dev, N, V, R, A, dtype):
    """[B, V] form, bitwise: cd, EOS, -1 pads, constrained pass-through,
    V not a multiple of the kernel's tile (or of 32), A past one staged
    chunk of row ids."""
    from repro_torch.kernels.masked_logits.ops import apply_grammar_mask
    from repro_torch.kernels.masked_logits.ref import masked_logits_ref
    rng = np.random.default_rng(N * V + A)
    store, rows, cd, eos, cons = _mask_inputs(rng, dev, N, V, R, A)
    logits = torch.from_numpy((rng.normal(size=(N, V)) * 3).astype(
        np.float32)).to(dev).to(dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for kw in ({"constrained": cons, "cd": cd}, {}):
        before = apply_grammar_mask.launches
        out = apply_grammar_mask(logits, store, rows, eos, **kw)
        assert apply_grammar_mask.launches == before + 1
        want = masked_logits_ref(logits, store, rows, eos, **kw)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == logits.shape
        assert torch.equal(out.view(bits), want.view(bits))


@pytest.mark.parametrize("V,M", [(50280, 2), (49152, 2), (49152, 4),
                                 (1000, 4), (2048, 2)])
@pytest.mark.parametrize("form", ["row", "span"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_logits_shards_join_to_the_unsharded_kernel(dev, V, M, form,
                                                           dtype):
    """The sharded engine's shard-local forms on word-aligned blocks
    (`vocab_shard`): every rank's block, concatenated, bitwise equal to
    the unsharded kernel, with EOS in each shard in turn (the other ranks
    get it out of range)."""
    from repro_torch.distributed.sharding import vocab_shard
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_shard,
        apply_grammar_mask_span, apply_grammar_mask_span_shard)
    rng = np.random.default_rng(V + M)
    K = 3 if form == "span" else 1
    store, rows, cd, eos, cons = _mask_inputs(rng, dev, 4 * K, V, 64, 48)
    eos = torch.ones_like(eos)
    lead = (4, K) if form == "span" else (4,)
    rows, cd = rows.reshape(*lead, -1), cd.reshape(*lead, -1)
    eos, cons = eos.reshape(lead), cons.reshape(lead)
    logits = torch.from_numpy((rng.normal(size=(*lead, V)) * 3).astype(
        np.float32)).to(dev).to(dtype)
    whole, part = ((apply_grammar_mask_span, apply_grammar_mask_span_shard)
                   if form == "span" else
                   (apply_grammar_mask, apply_grammar_mask_shard))
    shards = [vocab_shard(V, M, r) for r in range(M)]
    assert all(s.split for s in shards)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for owner in shards:
        eos_id = owner.v0 + owner.width // 2
        want = whole(logits, store, rows, eos, eos_id=eos_id,
                     constrained=cons, cd=cd)
        got = torch.cat([part(
            logits[..., s.v0:s.v1].contiguous(),
            store[:, s.w0:s.w1].contiguous(), rows, eos, s, eos_id=eos_id,
            constrained=cons, cd=cd[..., s.w0:s.w1].contiguous())
            for s in shards], dim=-1)
        torch.cuda.synchronize()
        assert torch.equal(got.view(bits), want.view(bits))
        # EOS is open on every constrained row (the others pass through)
        assert bool((got[..., eos_id] > -1e29)[cons].all())


@pytest.mark.parametrize("B,K,V,A", [(8, 8, 49152, 48), (2, 3, 1000, 7),
                                     (8, 8, 151936, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_logits_span_kernel_matches_plain(dev, B, K, V, A, dtype):
    from repro_torch.kernels.masked_logits.ops import apply_grammar_mask_span
    from repro_torch.kernels.masked_logits.ref import masked_logits_span_ref
    rng = np.random.default_rng(B * K * V)
    store, rows, cd, eos, cons = _mask_inputs(rng, dev, B * K, V, 100, A)
    rows, cd = rows.reshape(B, K, A), cd.reshape(B, K, -1)
    eos, cons = eos.reshape(B, K), cons.reshape(B, K)
    logits = torch.from_numpy((rng.normal(size=(B, K, V)) * 3).astype(
        np.float32)).to(dev).to(dtype)
    before = apply_grammar_mask_span.launches
    out = apply_grammar_mask_span(logits, store, rows, eos,
                                  constrained=cons, cd=cd)
    assert apply_grammar_mask_span.launches == before + 1
    want = masked_logits_span_ref(logits, store, rows, eos,
                                  constrained=cons, cd=cd)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits))


def _mask_case(case, dev, dtype):
    """The edge inputs of one card case for both forms: N = B*K rows
    (B = 4 slots of K = 4 positions), numpy-seeded. At V = 49152 the
    plan takes its largest tile (4096 entries), at V = 4096 a small one."""
    B, K, V, R, A, W = 4, 4, 4096, 64, 48, None
    if case == "A1":
        A = 1
    elif case == "A1000_few_ids":
        V, A = 49152, 1000
    elif case == "odd_offset":
        V = 49152
    elif case == "W_not_mult4":
        V, W = 49152, 49152 // 32 + 1        # store rows padded to 1537
    N = B * K
    rng = np.random.default_rng(sum(map(ord, case)))
    store, rows, cd, eos, cons = _mask_inputs(rng, dev, N, V, R, A, W)
    rows = rows.cpu().numpy()
    if case == "all_pad":
        rows[:] = -1
    elif case == "A1000_few_ids":
        rows[:] = -1
        for r in range(N):
            at = rng.choice(A, size=3, replace=False)
            rows[r, at] = rng.integers(0, R, 3)
    elif case == "span_rows_differ":
        rows[0] = -1
        rows[1] = rows[2]                   # equal neighbours in slot 0
        rows[5, : A // 2] = -1              # a sparse one in slot 1
    cons = cons.clone()
    cons[0] = True
    if case == "all_unconstrained":
        cons[:] = False
    logits = torch.from_numpy((rng.normal(size=(N, V)) * 3).astype(
        np.float32)).to(dev).to(dtype)
    if case == "odd_offset":
        buf = torch.empty(N * V + 1, dtype=dtype, device=dev)
        buf[1:].copy_(logits.reshape(-1))
        logits = buf[1:].view(N, V)
        assert logits.is_contiguous() and logits.data_ptr() % 16 != 0
    kw = {"constrained": cons, "cd": cd}
    if case == "cd_none":
        del kw["cd"]
    return B, K, logits, store, torch.from_numpy(rows).to(dev), eos, kw


@pytest.mark.parametrize("case", [
    "all_pad", "A1", "A1000_few_ids", "odd_offset", "W_not_mult4",
    "span_rows_differ", "all_unconstrained", "cd_none"])
@pytest.mark.parametrize("form", ["row", "span"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_logits_edge_cases(dev, case, form, dtype):
    """Bitwise, both entry points: every id a pad, A = 1 and A = 1000
    with three real ids a row, a contiguous logits view at an odd offset
    and store rows of 1537 words (both the scalar path), span positions
    of one slot with different row sets, every row unconstrained, no
    cd."""
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_span, launch_plan)
    from repro_torch.kernels.masked_logits.ref import (
        masked_logits_ref, masked_logits_span_ref)
    B, K, logits, store, rows, eos, kw = _mask_case(case, dev, dtype)
    N, V = logits.shape
    vec = launch_plan(N, V, store.shape[1], rows.shape[1], dtype,
                      case != "odd_offset").vec
    assert vec == (case not in ("odd_offset", "W_not_mult4"))
    if form == "span":
        sh = lambda t: t.reshape(B, K, *t.shape[1:])
        args = (sh(logits), store, sh(rows), sh(eos))
        kw = {k: sh(v) for k, v in kw.items()}
        fn, ref = apply_grammar_mask_span, masked_logits_span_ref
    else:
        args, fn, ref = (logits, store, rows, eos), apply_grammar_mask, \
            masked_logits_ref
    before = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == before + 1
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert out.shape == want.shape and out.dtype == dtype
    assert torch.equal(out.view(bits), want.view(bits))


def test_masked_logits_plan_matches_the_kernel(dev):
    """The kernel takes the tile, threads and path of the wrapper's plan
    (and asks for the plan's shared memory) at every shape the tests and
    the engine use; it refuses a tile past its limit and the vector path
    on an unaligned pointer."""
    from repro_torch.kernels.masked_logits.ops import (MAX_TILE, _launcher,
                                                       launch_plan)
    lib, _ = _launcher()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for N, V, W, A in ((1, 49152, 1536, 48), (8, 49152, 1536, 384),
                           (64, 49152, 1536, 48), (3, 1000, 32, 5),
                           (5, 2080, 65, 300), (2, 4096, 129, 1),
                           (8, 49152, 1536, 1000)):
            for aligned in (True, False):
                p = launch_plan(N, V, W, A, dtype, aligned)
                assert lib.masked_logits_plan_smem(
                    code, N, V, W, A, 64, p.tile, p.threads, int(p.vec),
                    int(aligned)) == p.smem == 4 * A
        assert lib.masked_logits_plan_smem(
            code, 1, 49152, 1536, 48, 64, 2 * MAX_TILE, 256, 1, 1) == -1
        assert lib.masked_logits_plan_smem(
            code, 1, 49152, 1536, 48, 64, 256, 256, 1, 0) == -1


@pytest.mark.parametrize("B,S,H,K,Dh,ps,nP,P", [
    (8, 1, 15, 5, 64, 16, 32, 256), (8, 8, 15, 5, 64, 16, 32, 256),
    (8, 32, 15, 5, 64, 16, 32, 256), (3, 5, 4, 2, 32, 8, 6, 20),
    (2, 3, 8, 8, 128, 4, 9, 30), (8, 1, 32, 4, 128, 16, 32, 256),
    (8, 8, 32, 4, 128, 16, 32, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(dev, B, S, H, K, Dh, ps, nP,
                                              P, dtype):
    """Page tables with -1 holes, pages shared between slots, a slot with
    no mapped page (its rows take the plain version's uniform weights)."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_decode)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rng = np.random.default_rng(B * S * nP + Dh)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    q = t(rng.normal(size=(B, S, H, Dh)).astype(np.float32)).to(dtype)
    kp = t(rng.normal(size=(P, ps, K, Dh)).astype(np.float32)).to(dtype)
    vp = t(rng.normal(size=(P, ps, K, Dh)).astype(np.float32)).to(dtype)
    pt = rng.integers(0, P, size=(B, nP)).astype(np.int32)
    pt[rng.random((B, nP)) < 0.2] = -1
    pt[-1] = -1
    if B > 1:
        pt[1, :2] = pt[0, :2]                        # shared prefix pages
    L = nP * ps
    pos = rng.integers(0, L - S + 1, size=B).astype(np.int32)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, t(pt), t(pos))
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(q, kp, vp, t(pt), t(pos))
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    err = (out.float() - want.float()).abs().max().item()
    assert err <= atol, err
    if S == 1:
        d = paged_attention_decode(q[:, 0], kp, vp, t(pt), t(pos))
        assert torch.equal(d, out[:, 0])


def _paged_check(dev, q, kp, vp, pt, pos, dtype):
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_decode)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (q, kp, vp, t(pt), t(pos))
    before = paged_attention.launches
    out = paged_attention(*args)
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*args)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    err = (out.float() - want.float()).abs().max().item()
    assert err <= atol, err
    if q.shape[1] == 1:
        d = paged_attention_decode(q[:, 0], *args[1:])
        assert torch.equal(d, out[:, 0])


def _paged_inputs(dev, seed, B, S, H, K, Dh, ps, nP, P, dtype):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    q = t(rng.normal(size=(B, S, H, Dh)).astype(np.float32)).to(dtype)
    kp = t(rng.normal(size=(P, ps, K, Dh)).astype(np.float32)).to(dtype)
    vp = t(rng.normal(size=(P, ps, K, Dh)).astype(np.float32)).to(dtype)
    pt = rng.permutation(P)[:B * nP].reshape(B, nP).astype(np.int32) \
        if B * nP <= P else rng.integers(0, P, size=(B, nP)).astype(np.int32)
    L = nP * ps
    pos = rng.integers(0, L - S + 1, size=B).astype(np.int32)
    return rng, q, kp, vp, pt, pos


@pytest.mark.parametrize("nP", [1, 3, 33])
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_page_counts_off_the_split(dev, nP, S, dtype):
    """Page counts that the cluster split does not divide evenly (33
    pages: six blocks of 5 and one of 3), with holes."""
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, nP * 10 + S, 4, S, 15, 5,
                                            64, 16, nP, 160, dtype)
    if nP > 1:
        pt[:, 1:][rng.random((4, nP - 1)) < 0.2] = -1
    _paged_check(dev, q, kp, vp, pt, pos, dtype)


@pytest.mark.parametrize("S", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_split_with_no_mapped_page(dev, S, dtype):
    """One block of a slot's cluster (pages 4-7 of 32) is all unmapped,
    another slot's pages past its queries are unmapped: those blocks
    still join every cluster barrier and add nothing."""
    from repro_torch.kernels.paged_attention.ops import launch_plan
    B, nP, ps = 4, 32, 16
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, 40 + S, B, S, 15, 5, 64,
                                            ps, nP, 256, dtype)
    plan = launch_plan(S, 15, 5, 64, ps, nP, q.element_size())
    assert plan.ppb == 4 and plan.C == 8
    pt[0, 4:8] = -1
    pos[0] = 20 * ps
    pt[1, 10:] = -1
    pos[1] = 9 * ps
    _paged_check(dev, q, kp, vp, pt, pos, dtype)


@pytest.mark.parametrize("S", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_slot_with_every_page_unmapped(dev, S, dtype):
    """A slot whose pages are all unmapped: its rows have no valid
    position and take uniform weights over all L positions, reading page
    0 in every block of the cluster."""
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, 50 + S, 3, S, 15, 5, 64,
                                            16, 32, 128, dtype)
    pt[1] = -1
    _paged_check(dev, q, kp, vp, pt, pos, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_span_at_the_end(dev, dtype):
    """S = 32 with pos at L - S: the span's last query sees every
    position of the slot."""
    B, S, nP, ps = 8, 32, 32, 16
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, 60, B, S, 15, 5, 64, ps,
                                            nP, 256, dtype)
    pos[:] = nP * ps - S
    pt[2, 5] = -1
    _paged_check(dev, q, kp, vp, pt, pos, dtype)


@pytest.mark.parametrize("ps", [8, 32])
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_page_sizes(dev, ps, S, dtype):
    """Pages of 8 and 32 positions over 512 positions per slot."""
    nP = 512 // ps
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, ps * 7 + S, 8, S, 15, 5,
                                            64, ps, nP, 8 * nP + 8, dtype)
    pt[:, 1:][rng.random((8, nP - 1)) < 0.15] = -1
    _paged_check(dev, q, kp, vp, pt, pos, dtype)


def test_flash_attention_plan_matches_the_kernel(dev):
    """The wrapper's launch plan asks for the shared memory that the
    kernel of each (dtype, head_dim) uses."""
    from repro_torch.kernels.flash_attention.ops import _launcher, launch_plan
    lib, _ = _launcher()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for Dh in (32, 64, 128, 256):
            assert lib.flash_attention_smem_bytes(code, Dh) == \
                launch_plan(dtype, 1, 16, 15, Dh).smem
        assert lib.flash_attention_smem_bytes(code, 96) == -1


@pytest.mark.parametrize("S", [1, 8])
def test_paged_attention_pages_in_chunks(dev, S):
    """fp32 with Dh = 128 and 120 pages of 32 positions: a block's 15
    pages do not fit its shared memory at once and go in chunks; a slot
    with no mapped page makes its clusters read every chunk's pages."""
    from repro_torch.kernels.paged_attention.ops import launch_plan
    B, nP, ps = 3, 120, 32
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, 70 + S, B, S, 15, 5, 128,
                                            ps, nP, B * nP, torch.float32)
    plan = launch_plan(S, 15, 5, 128, ps, nP, 4)
    assert plan.cpp < plan.ppb
    pt[0, 1:][rng.random(nP - 1) < 0.2] = -1
    pt[2] = -1
    _paged_check(dev, q, kp, vp, pt, pos, torch.float32)



@pytest.mark.parametrize("nP", [4, 32])
@pytest.mark.parametrize("psl", [2, 4, 8])
@pytest.mark.parametrize("S", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_partial_matches_plain(dev, nP, psl, S, dtype):
    """The partial form over each rank's in-page offsets of a pool of
    16-position pages split 16 / psl ways, nP pages a slot (smollm-360m's
    shapes; psl 8 with nP 4 is its rank-local pool at M = 2 and max_len
    64, as chip_smoke.py's phase 14 serves it), against the plain
    partial: o (fp32)
    within the paged tolerance, lse within 1e-5 in fp32 (1e-4 in bf16,
    whose scores are sums of bf16 products in another order), and rows
    with no valid position on a rank (a slot starting at 0, a slot with
    no mapped page) exactly 0 and -1e30."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_partial)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_partial_ref)
    B, ps = 8, 16
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, psl * 10 + S + nP, B, S,
                                            15, 5, 64, ps, nP, 256, dtype)
    pt[:, 1:][rng.random((B, nP - 1)) < 0.15] = -1
    pt[-1] = -1
    pos[0] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
    for r in range(ps // psl):
        kr = kp[:, r * psl:(r + 1) * psl].contiguous()
        vr = vp[:, r * psl:(r + 1) * psl].contiguous()
        args = (q, kr, vr, t(pt), t(pos), ps, r * psl)
        before = paged_attention_partial.launches
        o, lse = paged_attention_partial(*args)
        assert paged_attention_partial.launches == before + 1
        wo, wl = paged_attention_partial_ref(*args)
        torch.cuda.synchronize()
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == q.shape and lse.shape == q.shape[:3]
        err = (o - wo).abs().max().item()
        assert err <= atol, (r, err)
        err = (lse - wl).abs().max().item()
        assert err <= lse_tol, (r, err)
        dead = wl <= -1e30
        assert dead[-1].all() and (r == 0 or dead[0, 0].all())
        assert (lse[dead] == wl[dead]).all() and (o[dead] == 0).all()


@pytest.mark.parametrize("S,ps", [(1, 9), (8, 16), (16, 9), (1, 16)])
@pytest.mark.parametrize("H,K,Dh,M", [(15, 5, 64, 2), (16, 1, 256, 2),
                                      (6, 3, 32, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_head_dim_form_matches_plain(dev, S, ps, H, K, Dh, M, dtype):
    """The head_dim form over each rank's block of a pool split M ways
    on head_dim (smollm-360m's heads in 32-wide blocks, recurrentgemma's
    in 128-wide, the narrow CPU config's in 8-wide), 7 pages a slot with
    holes: each rank's `paged_attention_scores` and
    `paged_attention_values` within DH_TOL (1e-5) of the plain version's
    largest magnitude (both sum exact products in fp32 in another
    order), and the partial scores summed, softmaxed once and the blocks
    of P.V joined within the paged tolerance of the whole kernel."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_scores, paged_attention_values)
    from repro_torch.kernels.paged_attention.ref import (
        dh_probs, paged_scores_ref, paged_values_ref)
    B, nP = 8, 7
    rng, q, kp, vp, pt, pos = _paged_inputs(dev, S + ps + Dh, B, S, H, K,
                                            Dh, ps, nP, B * nP, dtype)
    pt[:, 1:][rng.random((B, nP - 1)) < 0.15] = -1
    pt[-1] = -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pt, pos = t(pt), t(pos)
    qpos = pos[:, None] + torch.arange(S, device=dev)[None, :]
    valid = (pt >= 0).repeat_interleave(ps, dim=1)[:, None, :] & \
        (torch.arange(nP * ps, device=dev)[None, None, :] <=
         qpos[:, :, None])
    rel = lambda a, b: ((a - b).abs().max() /
                        b.abs().max().clamp(min=1.0)).item()
    dw, total = Dh // M, 0
    for r in range(M):
        kr = kp[..., r * dw:(r + 1) * dw].contiguous()
        before = paged_attention_scores.launches
        s = paged_attention_scores(q, kr, pt, r * dw)
        assert paged_attention_scores.launches == before + 1
        assert s.dtype == torch.float32 and s.shape == (B, S, H, nP * ps)
        assert rel(s, paged_scores_ref(q, kr, pt, r * dw)) <= 1e-5
        total = total + s
    p = dh_probs(total, valid, dtype)
    blocks = []
    for r in range(M):
        vr = vp[..., r * dw:(r + 1) * dw].contiguous()
        before = paged_attention_values.launches
        o = paged_attention_values(p, vr, pt)
        assert paged_attention_values.launches == before + 1
        assert o.dtype == torch.float32 and o.shape == (B, S, H, dw)
        assert rel(o, paged_values_ref(p, vr, pt)) <= 1e-5
        blocks.append(o)
    got = torch.cat(blocks, -1).to(dtype)
    want = paged_attention(q, kp, vp, pt, pos)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    assert (got.float() - want.float()).abs().max().item() <= atol

# --------------------------------------------- attention backward (training)

def _bwd_inputs(dev, B, Sq, Sk, H, K, Dh, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, device=dev, generator=g).to(dtype)
    return mk(B, Sq, H, Dh), mk(B, Sk, K, Dh), mk(B, Sk, K, Dh), \
        mk(B, Sq, H, Dh)


@pytest.mark.parametrize("B,Sq,Sk,H,K,Dh,window", [
    (2, 128, 128, 8, 4, 32, 0), (1, 300, 300, 15, 5, 64, 0),
    (2, 200, 200, 32, 4, 128, 0), (1, 257, 257, 16, 1, 256, 64),
    (1, 130, 130, 8, 8, 64, 50), (1, 100, 300, 15, 5, 64, 0),
    (1, 1024, 1024, 15, 5, 64, 0), (1, 600, 600, 16, 1, 256, 256),
    (1, 77, 333, 8, 1, 128, 100), (1, 333, 333, 16, 1, 256, 2048),
    (2, 129, 129, 4, 4, 32, 31), (1, 20, 300, 16, 2, 64, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_matches_plain(dev, B, Sq, Sk, H, K, Dh,
                                                 window, dtype):
    """dq, dk, dv of the backward kernel against `ref.attention_bwd` on the
    same inputs (the forward kernel's output and LSE), causal, GQA, with
    and without a window, ragged tiles, right-aligned Sq < Sk. The bf16
    route's edges: Sk not a multiple of its 64-key tiles, Sq < Sk with a
    window edge inside a key tile (77 over 333, window 100, G = 8), head
    dim 256 over one KV head at B = 1 (6 key-tile blocks, far from a full
    wave), G = 1 with a window at head_dim 32, and key tiles that no
    query sees (20 queries over 300 keys, window 30: dK and dV zero
    there). Tolerance: 1e-4 (fp32) and 2**-5 (bf16) of the plain
    version's largest magnitude: fp32 sum orders differ, and the bf16
    route also rounds dS to bf16 before the dK and dQ products (a
    rounding of P or dq may also fall the other way)."""
    _bwd_check(dev, B, Sq, Sk, H, K, Dh, window, True, dtype,
               Sq * 7 + Dh + window)


def _bwd_check(dev, B, Sq, Sk, H, K, Dh, window, causal, dtype, seed):
    from repro_torch.kernels.flash_attention.ops import (
        attention_backward, attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd
    q, k, v, do = _bwd_inputs(dev, B, Sq, Sk, H, K, Dh, dtype, seed)
    out, lse = attention_with_lse(q, k, v, causal=causal, window=window)
    before = attention_backward.launches
    got = attention_backward(q, k, v, out, lse, do, causal=causal,
                             window=window)
    assert attention_backward.launches == before + 1
    want = attention_bwd(q, k, v, out, lse, do, causal=causal,
                         window=window)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("B,S,H,K,Dh,window", [
    (2, 300, 8, 2, 64, 0), (1, 333, 16, 1, 256, 100), (2, 200, 32, 4, 128, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_is_repeatable(dev, B, S, H, K, Dh, window,
                                          dtype):
    """Two launches of the backward kernel on the same inputs give the
    same bits: no pass sums with atomics (dQ is its own pass)."""
    from repro_torch.kernels.flash_attention.ops import (
        attention_backward, attention_with_lse)
    q, k, v, do = _bwd_inputs(dev, B, S, S, H, K, Dh, dtype, S + Dh)
    out, lse = attention_with_lse(q, k, v, causal=True, window=window)
    first = attention_backward(q, k, v, out, lse, do, causal=True,
                               window=window)
    second = attention_backward(q, k, v, out, lse, do, causal=True,
                                window=window)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("Dh,H,K,window", [(64, 15, 5, 0), (128, 32, 4, 0),
                                           (256, 16, 1, 100), (32, 8, 4, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_lse_and_forward_unchanged(dev, Dh, H, K, window, dtype):
    """The forward with the LSE requested writes the same output, bit for
    bit, as without it, and its LSE is the plain version's within 1e-4
    (fp32) or 1e-3 (bf16: exp2 against exp, other sum orders)."""
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    q, k, v, _ = _bwd_inputs(dev, 2, 333, 333, H, K, Dh, dtype, Dh + H)
    plain_out = attention(q, k, v, causal=True, window=window)
    out, lse = attention_with_lse(q, k, v, causal=True, window=window)
    assert torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == (2, H, 333)
    _, want = chunked_attention(q, k, v, causal=True, window=window,
                                return_lse=True)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert (lse - want).abs().max().item() <= tol


def test_attention_autograd_on_card(dev):
    """`attention` under autograd on the card (forward and backward
    kernels) against torch autograd through the plain version, fp32,
    within 1e-4 of each gradient's largest magnitude."""
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    q, k, v, do = _bwd_inputs(dev, 2, 200, 200, 8, 4, 64, torch.float32, 5)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = attention_backward.launches
    attention(*ins, causal=True, window=64).backward(do)
    assert attention_backward.launches == before + 1
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    chunked_attention(*ref_ins, causal=True, window=64).backward(do)
    for a, b in zip(ins, ref_ins):
        scale = b.grad.abs().max().item()
        assert (a.grad - b.grad).abs().max().item() <= 1e-4 * scale


def test_smollm_width_train_step_matches_cpu(dev):
    """One bf16 AdamW step of smollm-360m at full width (2 of its 32
    layers, B 2, S 128, remat on) on the card and on the CPU (plain
    versions) from the same weights: the step's loss and the loss after
    the update agree within 1% (bf16 matmuls accumulate in other orders
    on the two sides), and the card step ran the attention kernels."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import tree_map
    cfg = replace(get_config("smollm-360m"), num_layers=2)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, device="cpu").init(gen)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 129)).astype(np.int32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    losses = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where)
        model = build_model(cfg, device=d)
        p = tree_map(lambda t: t.to(d), params)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(d),
                 "labels": torch.from_numpy(toks[:, 1:]).to(d),
                 "loss_mask": torch.ones((2, 128), device=d)}
        step = make_train_step(model, opt)
        fwd, bwd = attention.launches, attention_backward.launches
        p, state, m = step(p, init_opt_state(p), batch)
        if where == "cuda":
            assert attention.launches - fwd == 2 * 2   # forward + remat
            assert attention_backward.launches - bwd == 2
        with torch.no_grad():
            after, _ = model.loss(p, batch)
        losses[where] = (float(m["loss"]), float(after))
    for a, b in zip(losses["cpu"], losses["cuda"]):
        assert abs(a - b) <= 0.01 * abs(a), losses


def test_trunk_shard_world_of_two_on_the_card(dev):
    """`Engine(mesh=..., trunk_shard=True)` over a 2-rank gloo world on
    the one card (NCCL refuses two ranks on one device), the narrow fp32
    dense and MoE configs of `tests/_torch_trunk_cases.py` and its
    6/3-head config, whose kv heads M = 2 does not divide (the sequence
    split at max_len 48: the partial paged kernel over 4 of each page's
    8 offsets; and, "dh", at max_len 47 with pages of 9, which M = 2
    does not divide either: the head_dim split, the paged kernel's
    head_dim form over 16 of the 32 channels), with the port's own
    seeded weights: every serving case of
    `_torch_sharded_cases` (greedy and sampled over six grammars,
    speculative, paged with a shared prefix, two-grammar store,
    sequential, opportunistic, and the sequence split's long run) gives
    the one-device engine's tokens on both ranks; so do the narrow ssm
    and hybrid configs of `tests/_torch_recurrent_cases.py` (w_in
    columns, conv channels and SSD heads; the RG-LRU width beside local
    attention on the sequence split) over greedy and sampled `generate()`,
    a long run and `generate_sequential`."""
    import _torch_recurrent_cases as R
    import _torch_trunk_cases as T
    from repro_torch.launch.mesh import spawn
    for mod, names in ((T, T.CARD_CONFIGS), (R, tuple(R.CONFIGS))):
        want = mod.card_world(0, None)
        ranks = spawn(2, mod.card_world, 2, backend="gloo", device="cuda")
        for rank, got in enumerate(ranks):
            for name in names:
                assert got[name].keys() <= want[name].keys()
                for case, toks in got[name].items():
                    assert toks == want[name][case], (rank, name, case)
