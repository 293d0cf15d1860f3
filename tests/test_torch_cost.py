"""The port's static cost count (`repro_torch.distributed.cost`) against
the reference's and against torch's own count.

FLOPs, for syncode-demo and reduced configs of the moe, ssm, hybrid,
audio and vlm families:
  * equal to `hlo_cost.estimate_jit_cost` of the reference's function
    (its compiled HLO, abstract params: nothing runs) for the dense
    decode step, prefill and the train step (loss and gradients, remat
    on), and for the span decode and the paged feed;
  * equal to `torch.utils.flop_counter.FlopCounterMode` over the port's
    CPU path at the same shapes, plus the named contractions where the
    two executors differ by design: the reference's span decode writes
    its cache through one-hot products (`attn.cache_write`,
    `attn.cache_pos`), the port through indexing; torch's autograd runs
    `cost.torch_train_extra` beyond XLA's train step.
Every bar is exact equality. Groups hold at least two layers, so each of
the reference's layer scans is a loop (a one-trip scan is inlined and
XLA then merges a recomputed norm with its forward).

Ring factors: `cost.wire` against `hlo_stats.collective_stats` on the
reference's own fake HLO and on a grid of kinds, sizes and group sizes.

hbm_bytes and the per-device figures against hand-worked formulas:
syncode-demo's decode step and `mask_sample` at B 8, one dense layer
and one MoE layer on a 2x4 stand-in mesh.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_config
from repro.distributed.hlo_cost import estimate_jit_cost
from repro.distributed.hlo_stats import collective_stats
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.distributed import cost
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import build_model
from repro_torch.training.tree import leaves, unflatten

torch.set_num_threads(1)

# (arch, reduced-config overrides or None for the full config, B, S of
# prefill and training, cache length of decode). S = 64 runs the ssm's
# two chunks; the hybrid's 128 puts keys outside its 64-wide window;
# whisper's 48 text positions run over 32 frames, the vlm's 40 over 16
# image tokens. num_layers 4 gives the hybrid and the vlm two pattern
# bodies a group, qwen3-moe a three-layer scan.
CASES = [
    ("syncode-demo", None, 2, 64, 128),
    ("qwen3-moe-30b-a3b", dict(num_layers=3), 2, 64, 64),
    ("mamba2-370m", {}, 2, 64, 64),
    ("recurrentgemma-9b", dict(num_layers=4), 2, 128, 64),
    ("whisper-base", {}, 2, 48, 64),
    ("llama-3.2-vision-90b", dict(num_layers=4), 2, 40, 64),
]
KINDS = ("decode", "prefill", "train")


def configs(arch, over):
    """(reference config, port config), remat on for training."""
    rc, pc = ref_config(arch), get_config(arch)
    if over is not None:
        rc = rc.reduced(remat=True, **over)
        pc = pc.reduced(remat=True, **over)
    else:
        rc, pc = replace(rc, remat=True), replace(pc, remat=True)
    return rc, pc


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def ref_batch(cfg, B, S, labels):
    b = {"tokens": _sds((B, S), jnp.int32)}
    if labels:
        b["labels"] = _sds((B, S), jnp.int32)
        b["loss_mask"] = _sds((B, S), jnp.float32)
    if cfg.arch_type == "vlm":
        b["image_embeds"] = _sds((B, cfg.num_image_tokens, cfg.d_model),
                                 jnp.dtype(cfg.dtype))
    if cfg.arch_type == "audio":
        b["frames"] = _sds((B, cfg.audio_frames, cfg.d_model),
                           jnp.dtype(cfg.dtype))
    return b


def ref_flops(cfg, kind, B, S, L):
    m = ref_build(cfg)
    p = m.abstract_params()
    if kind == "decode":
        c = jax.eval_shape(lambda: m.init_decode_caches(B, L))
        i = _sds((B,), jnp.int32)
        return estimate_jit_cost(jax.jit(m.decode_step), p, c, i, i)["flops"]
    if kind == "prefill":
        return estimate_jit_cost(jax.jit(m.prefill), p,
                                 ref_batch(cfg, B, S, False))["flops"]
    f = jax.jit(jax.value_and_grad(m.loss, has_aux=True))
    return estimate_jit_cost(f, p, ref_batch(cfg, B, S, True))["flops"]


def port_batch(cfg, B, S, labels, rng):
    dt = getattr(torch, cfg.dtype)
    b = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if labels:
        b["labels"] = b["tokens"]
        b["loss_mask"] = torch.ones(B, S)
    if cfg.arch_type == "vlm":
        b["image_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model))).to(dt)
    if cfg.arch_type == "audio":
        b["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.audio_frames, cfg.d_model))).to(dt)
    return b


def port_flops(cfg, kind, B, S, L):
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    fc = FlopCounterMode(display=False)
    if kind == "decode":
        c = m.init_decode_caches(B, L)
        tok = torch.zeros(B, dtype=torch.int32)
        pos = torch.full((B,), L // 2, dtype=torch.int32)
        with torch.no_grad(), fc:
            m.decode_step(p, c, tok, pos)
    elif kind == "prefill":
        b = port_batch(cfg, B, S, False, rng)
        with torch.no_grad(), fc:
            m.prefill(p, b)
    else:
        b = port_batch(cfg, B, S, True, rng)
        flat = [v.detach().requires_grad_() for v in leaves(p)]
        with fc:
            loss, _ = m.loss(unflatten(p, flat), b)
            torch.autograd.grad(loss, flat)
    return fc.get_total_flops()


def analytic(cfg, kind, B, S, L):
    if kind == "decode":
        return cost.decode_step(cfg, B, L)
    if kind == "prefill":
        return cost.prefill(cfg, B, S)
    return cost.train_step(cfg, B, S)


IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch,over,B,S,L", CASES, ids=IDS)
def test_flops_equal_reference_hlo(arch, over, B, S, L, kind):
    rc, pc = configs(arch, over)
    assert analytic(pc, kind, B, S, L)["flops"] == \
        ref_flops(rc, kind, B, S, L)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch,over,B,S,L", CASES, ids=IDS)
def test_flops_equal_torch_flop_counter(arch, over, B, S, L, kind):
    _, pc = configs(arch, over)
    want = analytic(pc, kind, B, S, L)["flops"]
    if kind == "train":
        want += sum(cost.torch_train_extra(pc, B, S).values())
    assert port_flops(pc, kind, B, S, L) == want


def test_train_extra_names_the_differences():
    """What torch runs beyond XLA in syncode-demo's step, by name."""
    _, pc = configs("syncode-demo", None)
    ex = cost.torch_train_extra(pc, 2, 64)
    T, D, V = 128, 256, 2048
    assert ex["lm_head"] == 2 * T * D * V         # one-chunk recompute
    B, S, H, Dh = 2, 64, 8, 32
    assert ex["attn.scores"] == 4 * (2 * B * H * S * S * Dh)   # 4 layers
    assert ex["attn.ln1"] == 4 * 2 * (2 * T * D)  # 4 layers, 2 products
    assert ex["final_norm"] == 3 * (2 * T * D)    # 2 products, recompute
    assert set(ex) == {"attn.ln1", "attn.ln2", "attn.scores", "final_norm",
                       "lm_head"}


@pytest.mark.parametrize("arch", ["syncode-demo", "qwen3-moe-30b-a3b"])
def test_span_and_paged_flops(arch):
    """decode_span (K 4 over a 64-position cache) and the paged feed
    (4 pages of 16 a row) against the reference's HLO; the port's span
    writes its cache by indexing, so torch counts the reference's
    one-hot write products less."""
    rc, pc = configs(arch, None if arch == "syncode-demo" else {})
    B, K, L, P, ps, nP = 4, 4, 64, 32, 16, 4
    m = ref_build(rc)
    p = m.abstract_params()
    i32 = lambda *s: _sds(s, jnp.int32)
    c = jax.eval_shape(lambda: m.init_decode_caches(B, L))
    span = cost.span_decode(pc, B, K, L)
    assert span["flops"] == estimate_jit_cost(
        jax.jit(m.decode_span), p, c, i32(B, K), i32(B))["flops"]
    pools = jax.eval_shape(lambda: m.init_paged_caches(P, ps))
    f = jax.jit(lambda p, c, t, pos, pt: m.decode_span(
        p, c, t, pos, batch_ctx={"page_table": pt}))
    paged = cost.paged_feed(pc, B, K, nP, ps)
    assert paged["flops"] == estimate_jit_cost(
        f, p, pools, i32(B, K), i32(B), i32(B, nP))["flops"]

    tm = build_model(pc, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros(B, K, dtype=torch.int32)
    pos = torch.full((B,), 8, dtype=torch.int32)
    fc = FlopCounterMode(display=False)
    with torch.no_grad(), fc:
        tm.decode_span(tp, tm.init_decode_caches(B, L), toks, pos)
    onehot = span["by_contraction"]["attn.cache_write"] + \
        span["by_contraction"]["attn.cache_pos"]
    assert fc.get_total_flops() == span["flops"] - onehot
    fc = FlopCounterMode(display=False)
    table = torch.arange(B * nP, dtype=torch.int32).reshape(B, nP)
    with torch.no_grad(), fc:
        tm.decode_span(tp, tm.init_paged_caches(P, ps), toks, pos,
                       batch_ctx={"page_table": table})
    assert fc.get_total_flops() == paged["flops"]


# ------------------------------ ring factors ------------------------------

def test_ring_factors_on_the_reference_fake_hlo():
    fake = """
  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}
  %ag = f32[4096]{0} all-gather(%y), replica_groups={{0,1,2,3}}
"""
    st = collective_stats(fake)
    assert st["all-reduce"]["wire_bytes"] == int(cost.wire("all-reduce",
                                                           4096, 4))
    assert st["all-gather"]["wire_bytes"] == int(cost.wire("all-gather",
                                                           16384, 4))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 256])
@pytest.mark.parametrize("kind", sorted(cost.RING))
def test_ring_factors_grid(kind, n):
    for elems, dt, size in ((1, "f32", 4), (1000, "bf16", 2),
                            (65536, "s32", 4), (12345, "f16", 2)):
        groups = "{{" + ",".join(str(i) for i in range(n)) + "}}"
        line = (f"  %c = {dt}[{elems}]{{0}} {kind}(%x), "
                f"replica_groups={groups}")
        st = collective_stats(line)
        assert st[kind]["count"] == 1
        assert st[kind]["wire_bytes"] == int(cost.wire(kind, elems * size,
                                                       n))


# ------------------------------ hbm bytes ---------------------------------

def test_decode_bytes_syncode_demo_by_hand():
    """B 8, a 128-position cache, bf16: every param but the embedding
    (read at its 8 rows), the cache whole, 8 new positions a layer, the
    ids, positions and the logits."""
    cfg = get_config("syncode-demo")
    B, L, D, F, V, K, Dh, H, nl = 8, 128, 256, 1024, 2048, 4, 32, 8, 4
    layer = 2 * D + D * H * Dh + 2 * D * K * Dh + H * Dh * D + 3 * D * F
    params = (nl * layer + D + D * V) * 2 + B * D * 2
    cache = nl * (2 * B * L * K * Dh * 2 + B * L * 4)
    write = nl * B * (2 * K * Dh * 2 + 4)
    io = B * 4 * 2 + B * V * 2
    c = cost.decode_step(cfg, B, L)
    assert c["hbm_bytes"] == params + cache + write + io
    assert c["wire_bytes"] == 0 and c["collectives"] == {}


def test_mask_sample_bytes_by_hand():
    """B 8 rows of V 2048 fp32 logits, A 48 store rows of 64 words."""
    B, V, A, W = 8, 2048, 48, 64
    c = cost.mask_sample(B, V, A, itemsize=4)
    read = B * V * 4 + B * A * W * 4 + B * A * 4 + B * W * 4 + B * 15
    written = B * 4 + B + B * V * 4
    assert c["hbm_bytes"] == read + written and c["flops"] == 0
    assert cost.mask_sample(B, V, A, 4, sampled=True)["hbm_bytes"] == \
        read + written + B * V * 4


# --------------------------- per device, 2x4 mesh --------------------------

MESH = MeshShape({"data": 2, "model": 4}, ("data", "model"))


def test_dense_layer_on_a_2x4_mesh_by_hand():
    """One dense layer, prefill of B 4 x S 64: every weight and the heads
    split 4 ways over "model", the batch 2 ways over "data"; rms_norm
    over the data only. Three all-reduces of the [T/2, D] bf16
    activation over 4: after wo, after w_down, and the vocab-parallel
    lookup."""
    cfg = replace(get_config("syncode-demo"), num_layers=1)
    B, S, D, F, V, K, Dh, H = 4, 64, 256, 1024, 2048, 4, 32, 8
    T = B * S
    norms = 3 * 2 * T * D
    rest = (2 * T * D * (H + 2 * K) * Dh + 4 * B * H * S * S * Dh +
            2 * T * H * Dh * D + 3 * 2 * T * D * F + 2 * T * D * V)
    c = cost.prefill(cfg, B, S, mesh=MESH)
    assert c["flops_global"] == norms + rest
    assert c["flops"] == norms / 2 + rest / 8
    act = T / 2 * D * 2
    assert c["collectives"] == {"all-reduce": {
        "count": 3, "wire_bytes": 3 * 2 * 3 / 4 * act}}

    # the train step, remat on: all-reduces of both row-parallel
    # outputs in the forward, the recompute and the gradient, the
    # lookup, the cross-entropy's three [T/2] fp32 combines and the lm
    # head input's gradient; every leaf's moments split over "data"
    # (ZeRO-1, the 1-D norms included), so each gradient is
    # reduce-scattered into them and each updated param all-gathered
    t = cost.train_step(replace(cfg, remat=True), B, S, mesh=MESH)
    ar = t["collectives"]["all-reduce"]
    assert ar["count"] == 2 * 3 + 1 + 3 + 1
    assert ar["wire_bytes"] == pytest.approx(
        1.5 * (2 * 3 * act + act + 3 * T / 2 * 4 + act))
    mats = [D * H * Dh, D * K * Dh, D * K * Dh, H * Dh * D, D * F, D * F,
            F * D, V * D, D * V]
    blocks = [m * 2 / 4 for m in mats] + [D * 2] * 3    # + ln1, ln2, final
    rs, ag = t["collectives"]["reduce-scatter"], \
        t["collectives"]["all-gather"]
    assert rs["count"] == ag["count"] == len(blocks)
    assert rs["wire_bytes"] == pytest.approx(sum(b / 2 for b in blocks))
    assert ag["wire_bytes"] == pytest.approx(sum(b / 2 for b in blocks))


def test_moe_layer_on_a_2x4_mesh_by_hand():
    """One MoE layer (reduced qwen3-moe: E 4, top-2, F 128), prefill of
    B 4 x S 64: the experts split 4 ways over "model" (expert
    parallelism) and the batch 2 ways; the [B/2, E, C, D] dispatch
    buffer goes to the experts and back in two all-to-alls."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced(num_layers=1)
    B, S, D = 4, 64, cfg.d_model
    E, F, H, K, Dh, V = 4, 128, 4, 2, 64, cfg.vocab_size
    C = max(8, -(-int(np.ceil(2 * S / E * 1.25)) // 8) * 8)
    T = B * S
    c = cost.prefill(cfg, B, S, mesh=MESH)
    experts = 3 * 2 * B * E * C * D * F
    assert c["by_contraction"]["moe.w_up"] == 2 * B * E * C * D * F
    norms = 3 * 2 * T * D
    rest = (2 * T * D * (H + 2 * K) * Dh + 4 * B * H * S * S * Dh +
            2 * T * H * Dh * D + 2 * T * D * E + experts + 2 * T * D * V)
    assert c["flops_global"] == norms + rest
    assert c["flops"] == norms / 2 + rest / 8
    buf = B / 2 * E * C * D * 2
    assert c["collectives"]["all-to-all"] == {
        "count": 2, "wire_bytes": 2 * 3 / 4 * buf}
    act = T / 2 * D * 2
    assert c["collectives"]["all-reduce"] == {
        "count": 2, "wire_bytes": 2 * 1.5 * act}     # wo, the lookup
