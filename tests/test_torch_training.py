"""The port's training substrate against the reference: AdamW, its
schedule and clip; the data pipelines (bit for bit); the port's twin of
`tests/test_training.py::test_train_loss_decreases`; the training CLI;
the fresh-batch contract the loop's shipping relies on.

Tolerances: the optimizer runs in fp32 on both sides with the same
rounding points; params, moments and gnorm within 1e-6 relative of each
leaf's largest magnitude (torch and XLA may take `pow` and sums to a
different last bit), lr within 1e-7 relative; the schedule alone within
2.5e-7 relative or lr * 2**-22 absolute: XLA's and torch's fp32 `cos` may
differ in the last bit (2**-23 near |cos| = 1), which the schedule scales
by (1 - min_lr_ratio) / 2 and which cancels against 1 at the end of the
decay.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.grammars import load_grammar as jax_load_grammar
from repro.core.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.training import data as jax_data
from repro.training import optimizer as jax_opt
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.grammars import load_grammar
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.training import data, optimizer
from repro_torch.training.tree import flatten_with_path, leaves

torch.set_num_threads(1)


def _tree(rng):
    """A param-shaped tree: stacked norms [L, D] and matrices, a final
    norm [D], fp32 and bf16 leaves."""
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"embed_block": {"embed": n(16, 8), "final_norm": n(8)},
            "groups": [({"ln1": n(2, 8), "w": n(2, 8, 4),
                         "b16": n(2, 4, 8).astype(jnp.bfloat16)},)]}


def _grads(rng, tree, scale):
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                        .astype(a.dtype), tree)


@pytest.mark.parametrize("clip,scale", [(1.0, 0.01), (0.5, 3.0)],
                         ids=["unclipped", "clipped"])
def test_adamw_matches_reference(clip, scale):
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    kw = dict(lr=0.05, warmup_steps=2, total_steps=6, clip_norm=clip,
              weight_decay=0.1)
    jcfg, tcfg = jax_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)
    js, ts = jax_opt.init_opt_state(jp), optimizer.init_opt_state(tp)
    for _ in range(4):
        g = _grads(rng, jax.tree.map(np.asarray, jp), scale)
        jp, js, jm = jax_opt.apply_updates(
            jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = optimizer.apply_updates(tcfg, tp, bridge.to_torch(g),
                                             ts)
        assert (float(jm["gnorm"]) > clip) == (scale > 1.0)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                   rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        assert int(ts["step"]) == int(js["step"])
        for jt, tt in ((jp, tp), (js["mu"], ts["mu"]), (js["nu"], ts["nu"])):
            for (k, t), a in zip(flatten_with_path(tt), jax.tree.leaves(jt)):
                a = np.asarray(a, np.float32)
                got = bridge.to_numpy({"x": t})["x"]
                if t.dtype == torch.bfloat16:
                    got = got.view(jnp.bfloat16)
                    assert np.asarray(a).dtype == np.float32
                err = np.abs(np.asarray(got, np.float32) - a).max()
                assert err <= 1e-6 * max(np.abs(a).max(), 1e-30), k


def test_weight_decay_reaches_stacked_norms_not_final_norm():
    """With zero grads the update is decay alone: the reference decays
    every leaf of two or more dims, the stacked `ln1` [L, D] included,
    and leaves `final_norm` [D] as it is; the port keeps that rule."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    tp = bridge.to_torch(tree)
    zero = bridge.to_torch(jax.tree.map(np.zeros_like, tree))
    cfg = optimizer.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    new, _, _ = optimizer.apply_updates(cfg, tp, zero,
                                        optimizer.init_opt_state(tp))
    lr = float(optimizer.schedule(cfg, torch.tensor(1, dtype=torch.int32)))
    ln1 = tp["groups"][0][0]["ln1"]
    assert torch.allclose(new["groups"][0][0]["ln1"],
                          ln1 - lr * 0.5 * ln1, rtol=1e-6)
    assert torch.equal(new["embed_block"]["final_norm"],
                       tp["embed_block"]["final_norm"])
    jp = jax.tree.map(jnp.asarray, tree)
    jnew, _, _ = jax_opt.apply_updates(
        jax_opt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5), jp,
        jax.tree.map(jnp.zeros_like, jp), jax_opt.init_opt_state(jp))
    np.testing.assert_allclose(np.asarray(jnew["groups"][0][0]["ln1"]),
                               new["groups"][0][0]["ln1"].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(0, 1), (10, 20), (100, 10000),
                                          (5, 5)])
def test_schedule_matches_reference(warmup, total):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total)
    for step in range(0, total + 5):
        want = float(jax_opt.schedule(jax_opt.AdamWConfig(**kw),
                                      jnp.asarray(step, jnp.int32)))
        got = float(optimizer.schedule(optimizer.AdamWConfig(**kw),
                                       torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=2.5e-7,
                                    abs=kw["lr"] * 2.0 ** -22), step


@pytest.mark.parametrize("grammar,seed,S,B", [("json", 0, 64, 4),
                                              ("calc", 3, 48, 2),
                                              ("sql", 7, 128, 3)])
def test_grammar_pipeline_batches_equal_reference(grammar, seed, S, B):
    jg, _ = jax_load_grammar(grammar)
    tg, _ = load_grammar(grammar)
    ref = iter(jax_data.GrammarDataPipeline(jg, JaxByteTokenizer(1024), S, B,
                                            seed=seed))
    port = iter(data.GrammarDataPipeline(tg, ByteTokenizer(1024), S, B,
                                         seed=seed))
    for _ in range(3):
        a, b = next(ref), next(port)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("arch_type", ["dense", "vlm", "audio"])
def test_random_pipeline_batches_equal_reference(arch_type):
    """The vlm and audio side inputs too (the audio trainer reads
    `frames`)."""
    cfg = replace(torch_get_config("syncode-demo"), arch_type=arch_type,
                  num_image_tokens=5, audio_frames=7)
    jcfg = replace(get_config("syncode-demo"), arch_type=arch_type,
                   num_image_tokens=5, audio_frames=7)
    ref = iter(jax_data.RandomTokenPipeline(jcfg, 16, 2, seed=4))
    port = iter(data.RandomTokenPipeline(cfg, 16, 2, seed=4))
    for _ in range(2):
        a, b = next(ref), next(port)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_train_loss_decreases(tmp_path):
    """The port's twin of tests/test_training.py::test_train_loss_decreases
    (same config, data, optimizer and bar), on the CPU."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    tok = ByteTokenizer(1024)
    cfg = replace(torch_get_config("syncode-demo"), vocab_size=1024,
                  num_layers=2, d_model=128, d_ff=256, num_heads=4,
                  num_kv_heads=2, head_dim=32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    g, _ = load_grammar("calc")
    it = iter(data.GrammarDataPipeline(g, tok, seq_len=64, batch_size=4,
                                       seed=0))
    ck = tmp_path / "ck.msgpack"
    params, result = train(model, params, it, steps=30,
                           opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5,
                                               total_steps=30),
                           log_every=5, checkpoint_path=str(ck),
                           verbose=False, device="cpu")
    assert result.losses[-1] < result.losses[0] - 0.3, result.losses
    assert ck.exists() and result.steps_per_sec > 0
    assert len(result.metrics) == 7 and all(
        set(m) == {"loss", "ce", "lb", "z", "gnorm", "lr"}
        for m in result.metrics)


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    from repro_torch.training.checkpoint import load_checkpoint
    ck = tmp_path / "cli.msgpack"
    params, result = main(["--device", "cpu", "--arch", "syncode-demo",
                           "--reduced", "--steps", "3", "--batch", "2",
                           "--seq", "32", "--checkpoint", str(ck)])
    out = capsys.readouterr().out
    assert "arch=syncode-demo-smoke params=" in out
    assert "step     0 loss" in out and "final loss" in out
    assert len(result.losses) == 2 and all(np.isfinite(result.losses))
    loaded, step, _ = load_checkpoint(str(ck), params)
    assert step == 3
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                  leaves(loaded)))


def test_train_cli_trains_whisper_on_cpu(capsys):
    """The reference's whisper entry point, `--arch whisper-base --grammar
    random`: the random pipeline draws the frames the encoder reads."""
    from repro_torch.launch.train import main
    params, result = main(["--device", "cpu", "--arch", "whisper-base",
                           "--reduced", "--grammar", "random", "--steps",
                           "2", "--batch", "2", "--seq", "40"])
    assert "arch=whisper-base-smoke params=" in capsys.readouterr().out
    assert "encoder" in params and all(np.isfinite(result.losses))


def test_train_cli_whisper_needs_frames():
    """A grammar pipeline gives no frames: whisper's first step raises
    KeyError('frames'), as the reference's does, instead of training on
    made-up frames."""
    from repro_torch.launch.train import main
    with pytest.raises(KeyError, match="frames"):
        main(["--device", "cpu", "--arch", "whisper-base", "--reduced",
              "--grammar", "json", "--steps", "1", "--batch", "2",
              "--seq", "32"])


def test_train_cli_trains_vlm_on_cpu(capsys):
    """`--arch llama-3.2-vision-90b --grammar random`: the random
    pipeline draws the fp32 image embeddings the cross layers read."""
    from repro_torch.launch.train import main
    params, result = main(["--device", "cpu", "--arch",
                           "llama-3.2-vision-90b", "--reduced", "--grammar",
                           "random", "--steps", "2", "--batch", "2",
                           "--seq", "24"])
    assert "arch=llama-3.2-vision-90b-smoke params=" in \
        capsys.readouterr().out
    assert "gate" in params["groups"][0][1]
    assert all(np.isfinite(result.losses))


def test_train_cli_vlm_needs_image_embeds():
    """A grammar pipeline gives no image embeddings: the vlm's first step
    raises KeyError('image_embeds'), as the reference's does."""
    from repro_torch.launch.train import main
    with pytest.raises(KeyError, match="image_embeds"):
        main(["--device", "cpu", "--arch", "llama-3.2-vision-90b",
              "--reduced", "--grammar", "json", "--steps", "1", "--batch",
              "2", "--seq", "32"])


def test_train_refuses_a_missing_card():
    """Entry points run on the card unless asked for the CPU."""
    from repro_torch.training.train_loop import train
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train(None, {"w": torch.zeros(2)}, iter([]), steps=1)


@pytest.mark.parametrize("make", [
    lambda: data.GrammarDataPipeline(load_grammar("json")[0],
                                     ByteTokenizer(1024), 32, 2, seed=1),
    lambda: data.RandomTokenPipeline(torch_get_config("syncode-demo"), 32,
                                     2, seed=1)], ids=["grammar", "random"])
def test_pipelines_return_fresh_batches(make):
    """The contract `ship_batch` relies on: no array of a batch shares
    memory with any array of the next, so writing into a shipped batch's
    host arrays (or a non-blocking copy still reading them) can never
    touch a later batch."""
    from repro_torch.training.train_loop import ship_batch
    it = iter(make())
    prev = next(it)
    for _ in range(3):
        cur = next(it)
        for a in prev.values():
            for b in cur.values():
                assert not np.shares_memory(a, b)
        snap = {k: v.copy() for k, v in cur.items()}
        shipped = ship_batch(cur, torch.device("cpu"))
        for v in prev.values():
            v[...] = 0
        for k in cur:
            assert np.array_equal(cur[k], snap[k])
            assert np.array_equal(shipped[k].numpy(), snap[k])
        prev = cur


def test_optimizer_state_crosses_the_bridge():
    """An optimizer state ({"mu", "nu": fp32 trees, "step": 0-dim int32})
    carried from the reference to the port and back keeps every leaf's
    dtype and shape (the step stays 0-dim), and the port's next update
    from the carried state matches the reference's from its own."""
    rng = np.random.default_rng(3)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    cfg = dict(lr=0.05, warmup_steps=1, total_steps=5, clip_norm=1.0)
    g1 = _grads(rng, jax.tree.map(np.asarray, jp), 0.1)
    jp, js, _ = jax_opt.apply_updates(jax_opt.AdamWConfig(**cfg), jp,
                                      jax.tree.map(jnp.asarray, g1),
                                      jax_opt.init_opt_state(jp))
    ts = bridge.to_torch(jax.tree.map(np.asarray, js))
    assert ts["step"].shape == () and ts["step"].dtype == torch.int32
    back = bridge.to_numpy(ts)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert np.asarray(a).shape == b.shape
        assert np.array_equal(np.asarray(a), b)
    g2 = _grads(rng, jax.tree.map(np.asarray, jp), 0.1)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    jp2, js2, _ = jax_opt.apply_updates(jax_opt.AdamWConfig(**cfg), jp,
                                        jax.tree.map(jnp.asarray, g2), js)
    tp2, ts2, _ = optimizer.apply_updates(optimizer.AdamWConfig(**cfg), tp,
                                          bridge.to_torch(g2), ts)
    assert int(ts2["step"]) == int(js2["step"]) == 2
    for a, t in zip(jax.tree.leaves(js2["mu"]), leaves(ts2["mu"])):
        a = np.asarray(a)
        assert np.abs(a - t.numpy()).max() <= 1e-6 * np.abs(a).max()
    for a, t in zip(jax.tree.leaves(jp2), leaves(tp2)):
        a = np.asarray(a, np.float32)
        assert np.abs(a - t.float().numpy()).max() <= 1e-6 * np.abs(a).max()
