"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's `repro.distributed.sharding`, spec for spec, for every
registered config's param, optimizer, batch and cache trees on the
serving meshes (1, 2) and (1, 4) and the production meshes 16x16 and
2x16x16 (shapes only: a stand-in mesh with `.shape` and `.axis_names`,
which is all the rules read). The reference's tree wrappers build
`NamedSharding`s, which need a real mesh: here they hand back the
spec's tuple instead. Also: the word-aligned vocabulary split, a rank's
block of a leaf, the serving mesh's validation and `trunk_shard`."""
import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as ref
from repro.configs import _MODULES, get_config
from repro.models.model import build_model
from repro.training.optimizer import init_opt_state
from repro_torch import bridge
from repro_torch.distributed import sharding as port
from repro_torch.launch.mesh import (MeshShape, make_local_mesh,
                                     make_production_mesh,
                                     make_serving_mesh)

CONFIGS = sorted(_MODULES)
MESHES = {
    "1x2": MeshShape({"data": 1, "model": 2}, ("data", "model")),
    "1x4": MeshShape({"data": 1, "model": 4}, ("data", "model")),
    "16x16": make_production_mesh(),
    "2x16x16": make_production_mesh(multi_pod=True),
}


@pytest.fixture(autouse=True)
def _spec_tuples(monkeypatch):
    monkeypatch.setattr(ref, "NamedSharding",
                        lambda mesh, spec: tuple(spec))


@lru_cache(maxsize=None)
def trees(arch):
    """-> (params, opt state, decode caches, paged pools or None) as
    abstract JAX trees of the reference's model (no memory behind)."""
    model = build_model(get_config(arch))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(init_opt_state, params)
    caches = jax.eval_shape(lambda: model.init_decode_caches(8, 64))
    pools = None
    if model.supports_span_decode and not model.cfg.sliding_window:
        pools = jax.eval_shape(lambda: model.init_paged_caches(32, 16))
    return params, opt, caches, pools


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", CONFIGS)
def test_param_rules_match_reference(arch, mesh):
    m = MESHES[mesh]
    params, opt, _, _ = trees(arch)
    cfg = get_config(arch)
    for fsdp in (False, True):
        assert port.param_specs(params, m, fsdp=fsdp) == \
            ref.params_shardings(params, m, fsdp=fsdp)
    for trunk in (False, True):
        assert port.serving_param_specs(params, m, cfg, trunk_shard=trunk) \
            == ref.serving_param_shardings(params, m, cfg,
                                           trunk_shard=trunk)
    for zero in (False, True):
        assert port.opt_state_specs(opt, m, zero=zero) == \
            ref.opt_state_shardings(opt, m, zero=zero)
    # one leaf at a time too, by the reference's own path strings
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        ps = jax.tree_util.keystr(path)
        assert port.param_spec(ps, leaf.shape, m) == \
            tuple(ref.param_spec(ps, leaf.shape, m))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", CONFIGS)
def test_cache_batch_and_serving_rules_match_reference(arch, mesh):
    m = MESHES[mesh]
    _, _, caches, pools = trees(arch)
    cfg = get_config(arch)
    for tree in (caches, pools):
        if tree is None:
            continue
        assert port.cache_specs(tree, m, cfg) == \
            ref.cache_shardings(tree, m, cfg)
        for trunk in (False, True):
            assert port.serving_cache_specs(tree, m, cfg,
                                            trunk_shard=trunk) == \
                ref.serving_cache_shardings(tree, m, cfg,
                                            trunk_shard=trunk)
    for B in (3, 8, 16, 32):
        batch = {"tokens": jax.ShapeDtypeStruct((B, 64), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((B, 64), jnp.int32),
                 "scale": jax.ShapeDtypeStruct((), jnp.float32)}
        assert port.batch_specs(batch, m) == ref.batch_shardings(batch, m)
        for sp in (False, True):
            assert port.activation_rules(m, cfg, B, seq_parallel=sp) == {
                k: tuple(v) for k, v in ref.activation_rules(
                    m, cfg, B, seq_parallel=sp).items()}
    for trunk in (False, True):
        assert port.serving_rules(m, cfg, trunk_shard=trunk) == {
            k: tuple(v) for k, v in ref.serving_rules(
                m, cfg, trunk_shard=trunk).items()}
    W = -(-cfg.vocab_size // 32)
    for words in (W, 32, 33, 1572):
        assert port.serving_store_spec(m, words) == \
            ref.serving_store_sharding(m, words)


@pytest.mark.parametrize("arch", CONFIGS)
def test_needs_fsdp_on_torch_dtypes_matches_reference(arch):
    """The port counts bytes from torch dtypes (meta tensors here)."""
    params = trees(arch)[0]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}
    meta = jax.tree.map(lambda a: torch.empty(a.shape, dtype=dt[str(
        a.dtype)], device="meta"), params)
    total = sum(math.prod(a.shape) * a.dtype.itemsize
                for a in jax.tree.leaves(params))
    for m in MESHES.values():
        for budget in (3.5e9, total / m.shape["model"] * 0.999,
                       total / m.shape["model"] * 1.001):
            assert port.needs_fsdp(meta, m, budget) == \
                ref.needs_fsdp(params, m, budget)


def test_leaf_paths_are_the_reference_keystr():
    params = trees("recurrentgemma-9b")[0]
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(params)[0]]
    got = [p for p, _ in port.leaves_with_path(params)]
    assert sorted(got) == sorted(want)


# ------------------------------ per-rank cuts ------------------------------

def test_shard_slice_cuts_each_rank_its_block():
    m = make_production_mesh(multi_pod=True)         # pod 2, data 16, model 16
    shape = (64, 96, 32)
    spec = (("pod", "data"), "model", None)
    seen = np.zeros(shape, int)
    for rank in range(m.size):
        c = port.mesh_coords(m, rank)
        assert rank == (c["pod"] * 16 + c["data"]) * 16 + c["model"]
        sl = port.shard_slice(spec, shape, m, rank)
        assert sl[0] == slice(2 * (c["pod"] * 16 + c["data"]),
                              2 * (c["pod"] * 16 + c["data"]) + 2)
        assert sl[1] == slice(6 * c["model"], 6 * c["model"] + 6)
        assert sl[2] == slice(0, 32)
        seen[sl] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError):
        port.shard_slice(("model",), (30,), m, 0)


@pytest.mark.parametrize("V,M,widths", [
    (2048, 1, (2048,)), (2048, 2, (1024, 1024)), (2048, 4, (512,) * 4),
    (1000, 2, (512, 488)), (1000, 4, (256, 256, 256, 232)),
    (50280, 2, (25152, 25128)), (49152, 2, (24576, 24576)),
    (100, 4, (32, 32, 32, 4)), (64, 4, None), (160, 4, None)])
def test_word_aligned_vocab_split(V, M, widths):
    """Rank s owns words [s*ceil(W/M), ...): vocab ids from 32*w0, the last
    rank the remainder; replicated when a rank would get no word."""
    W = -(-V // 32)
    shards = [port.vocab_shard(V, M, r) for r in range(M)]
    if widths is None:
        assert not any(s.split for s in shards)
        assert all((s.v0, s.v1, s.width) == (0, V, V) for s in shards)
        return
    assert all(s.split for s in shards)
    assert tuple(s.width for s in shards) == widths == shards[0].widths
    per = -(-W // M)
    for r, s in enumerate(shards):
        assert (s.w0, s.w1) == (r * per, min((r + 1) * per, W))
        assert s.v0 == 32 * s.w0 and s.v1 == min(32 * s.w1, V)
    assert shards[-1].v1 == V and sum(widths) == V
    owners = [r for r, s in enumerate(shards) if s.local_id(1) >= 0]
    assert owners == [0] and shards[0].local_id(1) == 1
    last = V - 1
    assert shards[-1].local_id(last) == last - shards[-1].v0
    assert all(s.local_id(last) == -1 for s in shards[:-1])


def test_shard_params_cuts_vocab_leaves_only():
    params = {"embed_block": {"embed": torch.arange(1000 * 4.).reshape(
                  1000, 4),
                  "lm_head": torch.arange(4 * 1000.).reshape(4, 1000),
                  "final_norm": torch.ones(4)},
              "groups": [({"wq": torch.zeros(2, 4, 8)},)]}
    s = port.vocab_shard(1000, 2, 1)
    cut = bridge.shard_params(params, s)
    assert torch.equal(cut["embed_block"]["embed"],
                       params["embed_block"]["embed"][512:])
    assert torch.equal(cut["embed_block"]["lm_head"],
                       params["embed_block"]["lm_head"][:, 512:])
    assert cut["embed_block"]["embed"].is_contiguous()
    assert cut["groups"][0][0]["wq"] is params["groups"][0][0]["wq"]
    assert cut["embed_block"]["final_norm"] is \
        params["embed_block"]["final_norm"]


# -------------------------- mesh and engine checks --------------------------

def test_serving_mesh_validation():
    """Without a process group the world is one rank."""
    for bad in (0, -1, 2):
        with pytest.raises(ValueError):
            make_serving_mesh(bad, device="cpu")
    with pytest.raises(ValueError):
        make_serving_mesh(1, backend="gloo", device="cpu")
    m = make_serving_mesh(1, device="cpu")
    assert (m.shape, m.axis_names, m.size, m.group) == \
        ({"data": 1, "model": 1}, ("data", "model"), 1, None)
    assert make_local_mesh().shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_serving_mesh(1)            # cuda by default: no card


def _control_route(rank):
    import torch.distributed as dist

    from repro_torch.distributed.api import broadcast_control
    m = make_serving_mesh(1, device="cpu")
    return (dist.get_backend(m.ctrl_group),
            broadcast_control({"admit": [3]}, m))


def test_control_broadcast_runs_over_a_gloo_group():
    """The loop's per-iteration control record travels in host memory
    over the mesh's gloo group, whatever backend the tensors use."""
    from repro_torch.launch.mesh import spawn
    assert spawn(1, _control_route, device="cpu") == \
        [("gloo", {"admit": [3]})]


def _tiny_engine(**kw):
    from dataclasses import replace

    from repro_torch.configs import get_config as tget
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.models.model import build_model as tbuild
    from repro_torch.serving.engine import Engine
    cfg = replace(tget("syncode-demo"), num_layers=1, d_model=32, d_ff=64,
                  num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=320,
                  dtype="float32")
    model = tbuild(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    kw.setdefault("max_len", 32)
    return Engine(model, model.init(gen), ByteTokenizer(320), {},
                  device="cpu", **kw)


def _one_rank_of(M):
    """Rank 0 of an M-rank mesh with no process group: enough for the
    engine's checks, which come before any collective."""
    from repro_torch.launch.mesh import ServingMesh
    return ServingMesh({"data": 1, "model": M}, ("data", "model"))


def test_engine_needs_a_model_axis_and_refuses_trunk_shard():
    """No 'model' axis: ValueError. trunk_shard at M = 1 (or without a
    mesh) splits nothing: the plain engine, the same tensors. Where M
    divides neither the kv heads nor max_len (here 1 kv head and a
    max_len of 31 at M = 2), which the engine refused until it served
    the reference's head_dim branch, the rank holds its block of
    head_dim: channels [0, 8) of the 16 in every cache."""
    with pytest.raises(ValueError, match="'model' axis"):
        _tiny_engine(mesh=MeshShape({"data": 2}, ("data",)))
    plain = _tiny_engine()
    for kw in ({"mesh": make_serving_mesh(1, device="cpu")}, {}):
        eng = _tiny_engine(trunk_shard=True, **kw)
        assert eng._trunk is None and eng.model.cfg == plain.model.cfg
        assert [tuple(t.shape) for _, t in port.leaves_with_path(
            eng.params)] == [tuple(t.shape) for _, t in
                             port.leaves_with_path(plain.params)]
    eng = _tiny_engine(mesh=_one_rank_of(2), trunk_shard=True, max_len=31)
    assert (eng._trunk.cache, eng._trunk.head_dims) == ("dh", (0, 8))
    k = eng._decode_caches(1)[0][0]["k"]
    assert k.shape[-3:] == (31, 1, 8)
    eng = _tiny_engine(mesh=make_serving_mesh(1, device="cpu"))
    assert eng._vs.split and eng._vs.width == 320
    assert eng._store_cat.shape == (1, 10)


def test_build_engine_passes_mesh_and_trunk_shard():
    """build_engine hands trunk_shard to the engine: at M = 1 the plain
    engine; at M = 2, smollm-360m's 5 kv heads and a max_len of 511
    (refused until the port served the reference's head_dim branch)
    give rank 0 channels [0, 32) of each head."""
    from repro_torch.launch.serve import build_engine
    eng, _, _ = build_engine("smollm-360m", grammars=(), device="cpu",
                             mesh=_one_rank_of(2), trunk_shard=True,
                             num_layers=1, max_len=511)
    assert (eng._trunk.cache, eng._trunk.head_dims) == ("dh", (0, 32))
    eng, _, _ = build_engine(grammars=("json",), device="cpu", mesh=1,
                             trunk_shard=True, num_layers=1)
    assert eng.mesh.size == 1 and eng._trunk is None
    eng, _, _ = build_engine(grammars=("json",), device="cpu", mesh=1,
                             num_layers=1)
    assert eng.mesh.size == 1 and eng._vs.width == eng._vocab


@pytest.mark.parametrize("V,M", [(1000, 4), (2048, 2), (50280, 2)])
@pytest.mark.parametrize("form", ["row", "span"])
def test_shard_local_masks_join_to_the_unsharded_mask(V, M, form):
    """The shard-local forms on the CPU (their plain version): every
    rank's block joined equals the unsharded mask bit for bit, with EOS
    in each shard in turn, and against the reference's plain mask."""
    import jax.numpy as jnp
    from repro.kernels.masked_logits.ref import (
        masked_logits_ref as jax_ref, masked_logits_span_ref as jax_span)
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_shard,
        apply_grammar_mask_span, apply_grammar_mask_span_shard)
    rng = np.random.default_rng(V * M)
    W, R, A = -(-V // 32), 40, 6
    lead = (3, 2) if form == "span" else (3,)
    store = rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
    rows = rng.integers(-1, R, size=(*lead, A)).astype(np.int32)
    cd = rng.integers(0, 2 ** 32, size=(*lead, W), dtype=np.uint32)
    cons = rng.random(lead) < 0.7
    eos = np.ones(lead, bool)
    logits = (rng.normal(size=(*lead, V)) * 3).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    whole, part, ref_fn = ((apply_grammar_mask_span,
                            apply_grammar_mask_span_shard, jax_span)
                           if form == "span" else
                           (apply_grammar_mask, apply_grammar_mask_shard,
                            jax_ref))
    shards = [port.vocab_shard(V, M, r) for r in range(M)]
    for owner in shards:
        eos_id = owner.v0 + 5
        kw = dict(eos_id=eos_id, constrained=t(cons),
                  cd=t(cd.view(np.int32)))
        want = whole(t(logits), t(store.view(np.int32)), t(rows), t(eos),
                     **kw)
        got = torch.cat([part(
            t(logits[..., s.v0:s.v1]), t(store[:, s.w0:s.w1].view(np.int32)),
            t(rows), t(eos), s, eos_id=eos_id, constrained=t(cons),
            cd=t(cd[..., s.w0:s.w1].view(np.int32))) for s in shards], -1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        jw = np.asarray(ref_fn(jnp.asarray(logits), jnp.asarray(store),
                               jnp.asarray(rows), jnp.asarray(eos),
                               eos_id=eos_id, constrained=jnp.asarray(cons),
                               cd=jnp.asarray(cd)))
        assert np.array_equal(got.numpy().view(np.int32), jw.view(np.int32))
