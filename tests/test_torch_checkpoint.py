"""Checkpoints cross between the packages: a file either side saves loads
on the other leaf for leaf, the port writes the reference's bytes for
the same tree, the port's pure-Python msgpack codec agrees with
`msgpack`, the checkpoint module imports without `msgpack`, and the
port's engine served from a JAX-trained checkpoint gives the JAX
engine's greedy tokens (fp32 weights: exact)."""
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import build_model
from repro.training.checkpoint import load_checkpoint as jax_load
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training import _msgpack
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"b": {"w": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
                  "s": jnp.asarray(7, jnp.int32)},
            "a": [jnp.asarray(rng.normal(size=(5,)), jnp.float32),
                  (jnp.asarray([True, False]), jnp.zeros((0, 2)))]}


def _trees():
    """(name, reference tree): a mixed tree and syncode-demo's bf16, and
    reduced moe, whisper (with its "encoder" group) and vlm (with its
    `gate` leaves) params."""
    out = [("mixed", _mixed_tree())]
    for arch, red in (("syncode-demo", False), ("qwen3-moe-30b-a3b", True),
                      ("whisper-base", True),
                      ("llama-3.2-vision-90b", True)):
        cfg = get_config(arch)
        cfg = cfg.reduced() if red else cfg
        out.append((arch, build_model(cfg).init(jax.random.PRNGKey(1))))
    return out


TREES = _trees()


def _assert_same(jtree, ttree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = flatten_with_path(ttree)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [k for k, _ in tflat]
    for (_, a), (k, t) in zip(jflat, tflat):
        a = np.asarray(a)
        got = bridge.leaf_to_numpy(t)
        if a.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16, k
            a = a.view(np.uint16)
        assert got.dtype == a.dtype and got.shape == a.shape, k
        assert np.array_equal(got, a), k


@pytest.mark.parametrize("name,tree", TREES, ids=[n for n, _ in TREES])
def test_checkpoints_cross_and_bytes_match(name, tree, tmp_path):
    like = bridge.to_torch(jax.tree.map(np.asarray, tree))
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jax_save(str(jpath), tree, step=11, extra={"note": name, "n": -3})
    save_checkpoint(str(tpath), like, step=11, extra={"note": name, "n": -3})
    assert tpath.read_bytes() == jpath.read_bytes()
    loaded, step, extra = load_checkpoint(str(jpath), like)
    assert step == 11 and extra == {"note": name, "n": -3}
    _assert_same(tree, loaded)
    jloaded, jstep, _ = jax_load(str(tpath), tree)
    assert jstep == 11
    _assert_same(jloaded, like)


def test_missing_leaf_and_wrong_shape_raise_as_the_reference(tmp_path):
    tree = {"a": jnp.zeros((2, 3)), "b": jnp.ones((4,))}
    path = str(tmp_path / "t.msgpack")
    jax_save(path, tree)
    like = bridge.to_torch(jax.tree.map(np.asarray, tree))
    for bad in ({**like, "c": torch.zeros(1)},
                {"a": torch.zeros(3, 2), "b": like["b"]}):
        jbad = jax.tree.map(lambda t: jnp.asarray(t.numpy()), bad)
        with pytest.raises((KeyError, ValueError)) as want:
            jax_load(path, jbad)
        with pytest.raises(want.type) as got:
            load_checkpoint(path, bad)
        assert str(got.value) == str(want.value)


CODEC_CASES = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
               2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
               -2 ** 31, -2 ** 31 - 1, -2 ** 63, None, True, False, 1.5,
               "", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536,
               "é中", b"", b"\x00" * 255, b"\x01" * 256,
               b"\x02" * 65536, [], list(range(15)), list(range(16)),
               list(range(65536)), {}, {str(i): i for i in range(15)},
               {str(i): [i, {"k": b"v"}] for i in range(16)},
               {"step": 3, "extra": {}, "leaves": [["['w']", {
                   "dt": "<f4", "sh": [2], "b": b"\x00" * 8}]]}]


@pytest.mark.parametrize("obj", CODEC_CASES,
                         ids=[f"case{i}" for i in range(len(CODEC_CASES))])
def test_codec_agrees_with_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    got = _msgpack.unpackb(want)
    ref = msgpack.unpackb(want, raw=False)
    assert got == ref and type(got) is type(ref)


def test_codec_rejects_truncated_and_trailing_data():
    data = msgpack.packb({"a": [1, 2, b"xyz"]}, use_bin_type=True)
    with pytest.raises(ValueError):
        _msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError):
        _msgpack.unpackb(data + b"\xc0")


def test_checkpoint_module_imports_without_msgpack(tmp_path):
    """The card's machine has no `msgpack`: the port's checkpoints work
    with it blocked."""
    code = ("import sys\n"
            "sys.modules['msgpack'] = None\n"
            "import torch\n"
            "from repro_torch.training.checkpoint import (load_checkpoint,\n"
            "                                             save_checkpoint)\n"
            f"p = {str(tmp_path / 'x.msgpack')!r}\n"
            "t = {'w': torch.arange(6.).reshape(2, 3).bfloat16()}\n"
            "save_checkpoint(p, t, step=2)\n"
            "back, step, _ = load_checkpoint(p, t)\n"
            "assert step == 2 and torch.equal(back['w'], t['w'])\n"
            "assert 'msgpack' not in [m for m, v in sys.modules.items()\n"
            "                         if v is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


NARROW = dict(vocab_size=1024, num_layers=2, d_model=128, d_ff=256,
              num_heads=4, num_kv_heads=2, head_dim=32, dtype="float32")


def test_port_engine_serves_a_jax_trained_checkpoint(tmp_path, monkeypatch):
    """Train the narrow fp32 syncode-demo in JAX, save, then build both
    engines with `checkpoint=` that file: greedy tokens are identical."""
    import repro.launch.serve as jax_serve
    import repro_torch.launch.serve as torch_serve
    from repro.core.decoding import DecodeConfig as JaxDecodeConfig
    from repro.core.grammars import load_grammar
    from repro.core.tokenizer import ByteTokenizer
    from repro.serving.engine import Request as JaxRequest
    from repro.training.data import GrammarDataPipeline
    from repro.training.optimizer import AdamWConfig
    from repro.training.train_loop import train
    from repro_torch.core.decoding import DecodeConfig
    from repro_torch.serving.engine import Request

    cfg = replace(get_config("syncode-demo"), **NARROW)
    model = build_model(cfg)
    g, _ = load_grammar("json")
    data = iter(GrammarDataPipeline(g, ByteTokenizer(1024), 64, 4, seed=0))
    ck = str(tmp_path / "trained.msgpack")
    train(model, model.init(jax.random.PRNGKey(0)), data, steps=8,
          opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8),
          checkpoint_path=ck, verbose=False)
    monkeypatch.setattr(jax_serve, "get_config",
                        lambda arch: replace(get_config(arch), **NARROW))
    monkeypatch.setattr(torch_serve, "get_config",
                        lambda arch: replace(torch_get_config(arch), **NARROW))
    jeng, _, _ = jax_serve.build_engine("syncode-demo", grammars=("json",),
                                        max_len=128, checkpoint=ck)
    teng, _, _ = torch_serve.build_engine("syncode-demo", grammars=("json",),
                                          max_len=128, checkpoint=ck,
                                          device="cpu")
    prompts = [b"Q: produce output. A:", b"{", b"data:"]
    jreqs = [JaxRequest(rid=i, prompt=p, grammar="json", max_new_tokens=24,
                        seed=i, decode=JaxDecodeConfig("greedy"))
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, grammar="json", max_new_tokens=24,
                     seed=i, decode=DecodeConfig("greedy"))
             for i, p in enumerate(prompts)]
    jstates, _ = jeng.generate(jreqs)
    tstates, _ = teng.generate(treqs)
    want = {s.req.rid: (s.token_ids, s.finish_reason) for s in jstates}
    got = {s.req.rid: (s.token_ids, s.finish_reason) for s in tstates}
    assert got == want
    assert sum(len(ids) for ids, _ in got.values()) >= 24
