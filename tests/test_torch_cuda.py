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
                                     (4, 2048, 300, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_select_kernel_matches_plain(dev, B, V, R, A, dtype):
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import fused_select_ref
    from repro_torch.kernels.masked_logits.ref import masked_logits_ref
    rng = np.random.default_rng(B * V + A)
    W = V // 32
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
