"""The port's training path against the reference on the same inputs:
`Model.loss` and its gradients against `jax.value_and_grad(model.loss)`,
one whole train step (loss, grads, AdamW) against the reference's
`make_train_step`, and five steps in a row on the same batches, for
syncode-demo and the `reduced()` moe, ssm, hybrid, audio and vlm configs,
in fp32 copies (bf16 would add the known MoE routing near-tie flips,
ROADMAP queue 3). Params are the reference's `Model.init(PRNGKey(0))`,
bridged, with the vlm's `gate` leaves set to 0.5 on both sides (at their
init zero the cross layers add nothing and get no gradient through
their attention); batches are drawn with numpy (whisper's with `frames`,
the encoder's input; its S of 48 text positions over 32 frames runs
cross attention at Sq > Sk; the vlm's with `image_embeds`, 40 text
positions over 16 image tokens).

Tolerances (fp32; XLA and torch sum in other orders):
- loss and its parts: 1e-5 relative;
- each gradient leaf: 1e-4 of the leaf's largest magnitude (1.6e-6 to
  6.9e-6 seen);
- after one step: gnorm 1e-5 relative, lr 1e-7 relative, mu and nu 1e-4
  of each leaf's largest magnitude; each param's update within 2 lr
  everywhere (Adam's first update is g / (|g| + eps): where |g| is near
  eps = 1e-8 a sum-order difference can turn its sign), and within
  1e-6 + 1e-5 lr where |mu| is at least 1e-3 of the leaf's largest;
- five steps in a row: each step's loss within 1e-4 relative (the small
  differences of one step feed the next; 1e-6 to 1e-5 seen).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.train_loop import make_train_step as jax_make_step
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import flatten_with_path, leaves, unflatten

torch.set_num_threads(1)

# (arch, reduced, S): the hybrid's reduced local_window is 64, so S = 128
# puts half of each late row's keys out of the window; the ssm's reduced
# chunk is 32, so S = 64 runs two chunks and the inter-chunk recurrence
ARCHS = [("syncode-demo", False, 64), ("qwen3-moe-30b-a3b", True, 64),
         ("mamba2-370m", True, 64), ("recurrentgemma-9b", True, 128),
         ("whisper-base", True, 48), ("llama-3.2-vision-90b", True, 40)]
_SIDES = {}


def sides(arch, reduced, **over):
    key = (arch, reduced, tuple(sorted(over.items())))
    if key not in _SIDES:
        pick = lambda c: c.reduced() if reduced else c
        cfg = replace(pick(get_config(arch)), dtype="float32", **over)
        tcfg = replace(pick(torch_get_config(arch)), dtype="float32", **over)
        jm = build_model(cfg)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.full_like(a, 0.5)
            if getattr(path[-1], "key", None) == "gate" else a,
            jm.init(jax.random.PRNGKey(0)))
        _SIDES[key] = (jm, jp, torch_build_model(tcfg, device="cpu"),
                       bridge.to_torch(jax.tree.map(np.asarray, jp)))
    return _SIDES[key]


def batch(cfg, S, B=2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, :3] = 0.0                       # a masked prefix counts too
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}
    if cfg.arch_type == "audio":
        out["frames"] = rng.normal(
            size=(B, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        out["image_embeds"] = rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def port_loss_and_grads(tm, tp, b, **kw):
    flat = [v.detach().requires_grad_() for v in leaves(tp)]
    loss, metrics = tm.loss(unflatten(tp, flat), b, **kw)
    return loss, metrics, torch.autograd.grad(loss, flat)


def assert_grads(jg, tp, tg, rel=1e-4):
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    names = [k for k, _ in flatten_with_path(tp)]
    assert len(jflat) == len(names) == len(tg)
    for (jk, jv), name, t in zip(jflat, names, tg):
        assert jax.tree_util.keystr(jk) == name
        a = np.asarray(jv)
        scale = max(np.abs(a).max(), 1e-30)
        err = np.abs(a - t.numpy()).max()
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("arch,reduced,S", ARCHS,
                         ids=[a for a, _, _ in ARCHS])
def test_loss_and_grads_match_reference(arch, reduced, S):
    jm, jp, tm, tp = sides(arch, reduced)
    jb, tb = both(batch(jm.cfg, S))
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    tl, tmet, tg = port_loss_and_grads(tm, tp, tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for k in ("ce", "lb", "z"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                               abs=1e-7)
    if arch == "qwen3-moe-30b-a3b":
        assert float(tmet["lb"]) > 0 and float(tmet["z"]) > 0
    assert_grads(jg, tp, tg)


@pytest.mark.parametrize("seq_chunk", [32, 40], ids=["chunked", "unchunked"])
def test_loss_branches_match_reference(seq_chunk):
    """S = 96: seq_chunk 32 takes the checkpointed three-chunk branch,
    seq_chunk 40 (96 % 40 != 0) the unchunked one; both agree with the
    reference's same branch and with each other."""
    jm, jp, tm, tp = sides("syncode-demo", False)
    jb, tb = both(batch(jm.cfg, 96, seed=3))
    (jl, _), jg = jax.value_and_grad(
        lambda p, b: jm.loss(p, b, seq_chunk=seq_chunk), has_aux=True)(jp, jb)
    tl, _, tg = port_loss_and_grads(tm, tp, tb, seq_chunk=seq_chunk)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert_grads(jg, tp, tg)
    whole, _, _ = port_loss_and_grads(tm, tp, tb, seq_chunk=96)
    assert float(tl) == pytest.approx(float(whole), rel=1e-6)


@pytest.mark.parametrize("arch,reduced,S", ARCHS,
                         ids=[a for a, _, _ in ARCHS])
def test_remat_matches_no_remat(arch, reduced, S):
    """Checkpointed layers (recomputed in the backward) give the same
    loss and gradients as stored activations, bit for bit on the CPU."""
    _, _, tm, tp = sides(arch, reduced)
    tb = both(batch(tm.cfg, S, seed=1))[1]
    on = torch_build_model(replace(tm.cfg, remat=True), device="cpu")
    off = torch_build_model(replace(tm.cfg, remat=False), device="cpu")
    l1, _, g1 = port_loss_and_grads(on, tp, tb)
    l2, _, g2 = port_loss_and_grads(off, tp, tb)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("arch,reduced,S", ARCHS,
                         ids=[a for a, _, _ in ARCHS])
def test_train_step_matches_reference(arch, reduced, S):
    """One whole step (loss, grads, global-norm clip active, warmup lr,
    AdamW with weight decay) against the reference's jitted step."""
    jm, jp, tm, tp = sides(arch, reduced)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jb, tb = both(batch(jm.cfg, S, seed=2))
    jp2, js, jmet = jax.jit(jax_make_step(jm, JaxAdamWConfig(**kw)))(
        jp, jax_init_opt_state(jp), jb)
    tp2, ts, tmet = make_train_step(tm, AdamWConfig(**kw))(
        tp, init_opt_state(tp), tb)
    assert float(jmet["gnorm"]) > kw["clip_norm"]      # the clip is active
    assert float(tmet["gnorm"]) == pytest.approx(float(jmet["gnorm"]),
                                                 rel=1e-5)
    lr = float(jmet["lr"])
    assert float(tmet["lr"]) == pytest.approx(lr, rel=1e-7)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 1
    for name in ("mu", "nu"):
        for a, t in zip(jax.tree.leaves(js[name]), leaves(ts[name])):
            a = np.asarray(a)
            assert np.abs(a - t.numpy()).max() <= \
                1e-4 * max(np.abs(a).max(), 1e-30), name
    for p0, a, t, mu in zip(leaves(tp), jax.tree.leaves(jp2), leaves(tp2),
                            jax.tree.leaves(js["mu"])):
        assert t.dtype == p0.dtype and t.shape == p0.shape
        diff = np.abs(np.asarray(a) - t.numpy())
        assert diff.max() <= 2 * lr
        mu = np.abs(np.asarray(mu))
        sure = mu >= 1e-3 * max(mu.max(), 1e-30)
        assert (diff[sure] <= 1e-6 + 1e-5 * lr).all()


@pytest.mark.parametrize("arch,reduced,S", ARCHS[:2],
                         ids=[a for a, _, _ in ARCHS[:2]])
def test_bf16_loss_is_logged(arch, reduced, S):
    """bf16 loss on both sides from the same bf16 weights: XLA and torch
    round elementwise chains at other points, so identity is logged, not
    required; both must be finite and within 5% of each other."""
    pick = lambda c: c.reduced() if reduced else c
    cfg, tcfg = pick(get_config(arch)), pick(torch_get_config(arch))
    jm = build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build_model(tcfg, device="cpu")
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    jb, tb = both(batch(cfg, S))
    jl = float(jm.loss(jp, jb)[0])
    with torch.no_grad():
        tl = float(tm.loss(tp, tb)[0])
    print(f"bf16 loss {arch}: reference {jl!r}, port {tl!r}, identical "
          f"{jl == tl}")
    assert np.isfinite(jl) and np.isfinite(tl)
    assert tl == pytest.approx(jl, rel=0.05)


@pytest.mark.parametrize("arch,reduced,S", [ARCHS[1], ARCHS[4]],
                         ids=[ARCHS[1][0], ARCHS[4][0]])
def test_five_steps_match_reference(arch, reduced, S):
    """Five train steps in a row, each side stepping its own params and
    optimizer state on the same batches with the same AdamWConfig (lr
    1e-3, warmup 2, as the card's short runs): every step's loss within
    1e-4 relative of the reference's. The trajectories are printed: a
    rising loss here is the reference's as much as the port's."""
    jm, jp, tm, tp = sides(arch, reduced)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_make_step(jm, JaxAdamWConfig(**kw)))
    tstep = make_train_step(tm, AdamWConfig(**kw))
    js, ts = jax_init_opt_state(jp), init_opt_state(tp)
    jl, tl = [], []
    for i in range(5):
        jb, tb = both(batch(jm.cfg, S, seed=10 + i))
        jp, js, jmet = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    print(f"{arch} losses: reference {jl}, port {tl}")
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert b == pytest.approx(a, rel=1e-4), (i, jl, tl)
