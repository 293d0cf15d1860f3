"""Trunk-sharded serving of the port (`Engine(mesh=..., trunk_shard=True)`:
Megatron column/row blocks with explicit all-reduces, kv-head-sharded
caches and pools, expert-parallel MoE) on the CPU: gloo ranks started by
`launch.mesh.spawn`, worlds of 1 (in this process), 2 and 4, on the two
fp32 configs of `tests/_torch_trunk_cases.py` (dense 8/4 heads; MoE with
E 8, top-2, a dense first layer and QKV biases drawn at random) with the
reference's `Model.init(PRNGKey(0))` weights bridged in.

What is held, per config and world:
  * each rank's blocks are `shard_slice` of the REFERENCE's
    `serving_param_spec(..., trunk_shard=True)` (embed and lm_head: the
    word-aligned vocabulary split), and its decode caches and page
    pools have the shapes of the reference's `cache_shardings` blocks;
  * the first prefill and decode logits equal the JAX single-device
    model's on the same inputs within the fp32 tolerance of
    `tests/test_torch_archs.py` (atol 1e-4, rtol 2e-6);
  * every serving case of `tests/_torch_sharded_cases.py` (greedy and
    sampled `generate()` over the six builtin grammars, speculative,
    paged with a shared prefix, a two-grammar store, sequential,
    opportunistic, and at M = 2 an AsyncEngine whose followers run
    `run_follower`) gives the unsharded port's tokens;
  * the decode step's collectives against `distributed/cost.py`'s count
    and the bytes a rank holds against the dry run's argument bytes
    under the trunk specs;
and the splits `trunk_plan` refuses raise ValueError. The sequence split
(M does not divide the kv heads) is held by tests/test_torch_seq_shard.py,
the recurrent families by tests/test_torch_recurrent_shard.py."""
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as ref
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.grammars import load_grammar
from repro_torch.core.mask_store import build_mask_store
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.distributed import cost
from repro_torch.distributed import sharding as port
from repro_torch.launch.dryrun import tree_shard_bytes
from repro_torch.launch.mesh import MeshShape, ServingMesh, spawn
from repro_torch.models.model import build_model, layer_groups
import _torch_sharded_cases as S
import _torch_trunk_cases as C

WORLDS = (1, 2, 4)
PER_GRAMMAR = ("greedy", "sampled")
WHOLE = ("speculative", "paged", "mixed", "sequential", "opportunistic")
FP32_TOL = dict(atol=1e-4, rtol=2e-6)


def _mesh(M):
    return MeshShape({"data": 1, "model": M}, ("data", "model"))


def _payload(name):
    """(reference weights as numpy leaves, QKV biases drawn at random;
    port tokenizer; port bundles; the model case's tokens)."""
    jp = jax_build_model(C.config(name, jax_get_config)).init(
        jax.random.PRNGKey(0))
    params = C.random_biases(jax.tree.map(np.asarray, jp))
    tok = ByteTokenizer(C.V)
    bundles = {}
    for g in S.GRAMMARS:
        gr, tab = load_grammar(g)
        bundles[g] = (gr, tab, build_mask_store(gr, tok))
    toks = np.random.default_rng(7).integers(
        3, C.V, size=(C.B, C.P + 1)).astype(np.int32)
    return params, tok, bundles, toks


def _checkpoint(path):
    """A checkpoint of syncode-demo's first 2 layers, seed 3 (bf16, as
    the config has it), for the launcher's trunk paths."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.training.checkpoint import save_checkpoint
    eng, _, _ = build_engine(grammars=(), device="cpu", num_layers=2,
                             seed=3)
    save_checkpoint(path, eng.params, step=1)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (payload {config: ...}, unsharded {config: run_config,
    "launcher": ...}, sharded {M: [rank results]})."""
    payload = {name: _payload(name) for name in C.CONFIGS}
    ck = _checkpoint(str(tmp_path_factory.mktemp("trunk") / "ck.msgpack"))
    sharded, errors = {}, []

    def world(n):
        try:
            sharded[n] = spawn(n, C.world, n, payload, ck, device="cpu")
        except BaseException as e:          # re-raised below
            errors.append(e)
    bg = [threading.Thread(target=world, args=(n,)) for n in WORLDS
          if n > 1]
    for t in bg:
        t.start()
    base = {name: C.run_config(None, name, payload[name])
            for name in C.CONFIGS}
    base["launcher"] = C.launcher_world(0, None, ck)
    world(1)
    for t in bg:
        t.join()
    if errors:
        raise errors[0]
    return payload, base, sharded


@pytest.fixture(autouse=True)
def _spec_tuples(monkeypatch):
    monkeypatch.setattr(ref, "NamedSharding",
                        lambda mesh, spec: tuple(spec))


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.CONFIGS)
def test_blocks_are_the_reference_trunk_specs(runs, name, M):
    """Each rank's blocks are the reference's trunk rule's, cut from the
    bridged leaves; embed and lm_head are the word-aligned vocab split."""
    payload, _, sharded = runs
    whole = dict(port.leaves_with_path(payload[name][0]))
    cfg = C.config(name, jax_get_config)
    mesh = _mesh(M)
    for rank, res in enumerate(sharded[M]):
        got = dict(port.leaves_with_path(res[name]["model"]["params"]))
        assert got.keys() == whole.keys()
        vs = port.vocab_shard(C.V, M, rank)
        for path, leaf in whole.items():
            if port._leaf_name(path) in ("embed", "lm_head"):
                sl = port.vocab_slice(path, leaf.shape, vs)
            else:
                spec = tuple(ref.serving_param_spec(
                    path, leaf.shape, mesh, cfg, trunk_shard=True))
                sl = port.shard_slice(spec, leaf.shape, mesh, rank)
            np.testing.assert_array_equal(got[path], leaf[sl], err_msg=path)


def _reference_blocks(tree, mesh, cfg, rank):
    specs = ref.serving_cache_shardings(tree, mesh, cfg, trunk_shard=True)
    out = []
    for g, gs in zip(tree, specs):
        out.append(tuple(
            {k: tuple(s.stop - s.start for s in port.shard_slice(
                sp[k], leaf[k].shape, mesh, rank)) for k in leaf}
            for leaf, sp in zip(g, gs)))
    return out


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.CONFIGS)
def test_cache_and_pool_shapes_are_the_reference_blocks(runs, name, M):
    _, _, sharded = runs
    cfg = C.config(name, jax_get_config)
    jm = jax_build_model(cfg)
    caches = jax.eval_shape(lambda: jm.init_decode_caches(C.B, S.MAX_LEN))
    pools = jax.eval_shape(lambda: jm.init_paged_caches(C.PAGES, C.PAGE))
    mesh = _mesh(M)
    for rank, res in enumerate(sharded[M]):
        got = res[name]["model"]
        assert got["caches"] == _reference_blocks(caches, mesh, cfg, rank)
        assert got["pools"] == _reference_blocks(pools, mesh, cfg, rank)
        heads = got["pools"][-1][0]["k"][3]
        assert heads == cfg.num_kv_heads // M


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.CONFIGS)
def test_logits_match_the_jax_single_device_model(runs, name, M):
    """The first prefill and decode logits of every rank against the
    reference's one-device Model on the same weights and tokens."""
    payload, _, sharded = runs
    params, _, _, toks = payload[name]
    jm = jax_build_model(C.config(name, jax_get_config))
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :C.P])},
                        cache_len=S.MAX_LEN, true_len=C.P)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, C.P]),
                           jnp.full((C.B,), C.P, jnp.int32))
    first = sharded[M][0][name]["model"]
    for rank, res in enumerate(sharded[M]):
        got = res[name]["model"]
        np.testing.assert_allclose(got["prefill"], np.asarray(jl),
                                   err_msg=f"prefill rank {rank}",
                                   **FP32_TOL)
        np.testing.assert_allclose(got["decode"], np.asarray(jd),
                                   err_msg=f"decode rank {rank}",
                                   **FP32_TOL)
        # the all-reduce hands every rank the same sums
        np.testing.assert_array_equal(got["decode"], first["decode"])


CASES = [(case, g) for case in PER_GRAMMAR
         for g in S.GRAMMARS + (None,)] + [(case, "-") for case in WHOLE]


@pytest.mark.parametrize("case,grammar", CASES)
@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.CONFIGS)
def test_trunk_tokens_equal_unsharded(runs, name, M, case, grammar):
    _, base, sharded = runs
    want = base[name]["cases"][case]
    rids = None
    if case in PER_GRAMMAR:
        reqs = {"greedy": S.greedy_requests,
                "sampled": S.sampled_requests}[case]()
        rids = {r.rid for r in reqs if r.grammar == grammar}
        assert rids
        want = {rid: v for rid, v in want.items() if rid in rids}
    for rank, res in enumerate(sharded[M]):
        got = res[name]["cases"][case]
        if rids is not None:
            got = {rid: v for rid, v in got.items() if rid in rids}
        assert got == want, f"rank {rank} of {M}"
    if case == "paged":
        assert all(res[name]["cases"]["paged_hit_rate"] ==
                   base[name]["cases"]["paged_hit_rate"] > 0
                   for res in sharded[M])


@pytest.mark.parametrize("name", C.CONFIGS)
def test_async_followers_serve_the_trunk(runs, name):
    """Rank 0's AsyncEngine hot-loads a grammar and cancels one request;
    the follower runs `run_follower` over its blocks, and both ranks'
    requests equal the unsharded engine's sync run (the cancelled one a
    prefix of it)."""
    _, base, sharded = runs
    sync = base[name]["cases"]["async_sync"]
    ranks = [res[name]["cases"]["async_cancel"]
             for res in sharded[C.ASYNC_WORLD]]
    assert all(r == ranks[0] for r in ranks[1:])
    for rid, (ids, reason) in ranks[0].items():
        if rid != S.CANCEL_RID:
            assert (ids, reason) == sync[rid]
            continue
        assert reason == "cancelled"
        full = sync[rid][0]
        assert len(full) > len(ids) >= S.CANCEL_AFTER + 1
        assert ids == full[:len(ids)]


@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("name", C.CONFIGS)
def test_decode_collectives_against_the_cost_count(runs, name, M):
    """The collectives one decode step issued, against
    `cost.decode_step(..., mesh)`. Dense: equal (the embedding's and
    two row-parallel all-reduces a layer). MoE: cost.py models the
    expert exchange as two all-to-alls of the [B, E, C, D] dispatch
    buffer a layer; the port gathers the [B, 1, E] fp32 router logits
    and all-reduces the [B, 1, D] combined output instead, so the wire
    differs by exactly that."""
    _, _, sharded = runs
    cfg = C.config(name)
    want = cost.decode_step(cfg, C.B, S.MAX_LEN, mesh=_mesh(M))
    n_moe = sum(c for pat, c in layer_groups(cfg) if "moe" in pat)
    gather = n_moe * C.B * cfg.num_experts * 4          # fp32 logits
    combine = n_moe * C.B * cfg.d_model * 4             # fp32 model
    for res in sharded[M]:
        tally = res[name]["model"]["tally"]
        ar = tally["all-reduce"]
        if name == "dense":
            assert set(tally) == {"all-reduce"}
            assert ar["wire_bytes"] == want["wire_bytes"]
            assert ar["count"] == want["collectives"]["all-reduce"]["count"]
            continue
        a2a = want["collectives"]["all-to-all"]["wire_bytes"]
        assert ar["count"] == want["collectives"]["all-reduce"]["count"] + \
            n_moe
        assert tally["all-gather"]["count"] == n_moe
        assert tally["all-gather"]["bytes"] == gather
        assert ar["wire_bytes"] + tally["all-gather"]["wire_bytes"] == \
            want["wire_bytes"] - a2a + cost.wire("all-reduce", combine, M) \
            + cost.wire("all-gather", gather, M)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.CONFIGS)
def test_resident_bytes_are_the_trunk_spec_argument_bytes(runs, name, M):
    """The params and decode caches a rank holds, byte for byte the dry
    run's argument bytes under the serving trunk specs."""
    _, _, sharded = runs
    cfg = C.config(name)
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    caches = model.init_decode_caches(C.B, S.MAX_LEN)
    mesh = _mesh(M)
    want = tree_shard_bytes(params, port.serving_param_specs(
        params, mesh, cfg, trunk_shard=True), mesh) + tree_shard_bytes(
        caches, port.serving_cache_specs(caches, mesh, cfg,
                                         trunk_shard=True), mesh)
    for res in sharded[M]:
        assert res[name]["model"]["resident"] == want


# ------------------------------- refusals -------------------------------

# (config, M, the engine's cache lengths, the dimension named): the
# layer kinds the port does not split (the vlm and audio families), and
# where M divides neither the kv heads nor a cache length, which the port
# refused until it served the reference's head_dim branch (recurrentgemma's
# one kv head included): these four now plan that branch
REFUSED = [("smollm-360m", 2, dict(cache_len=511), "max_len) 511"),
           ("syncode-demo", 8, dict(cache_len=100), "max_len) 100"),
           ("qwen3-moe-30b-a3b", 8, dict(page_size=4), "page_size 4"),
           ("recurrentgemma-9b", 2, dict(cache_len=511), "max_len) 511"),
           ("whisper-base", 2, {}, "['dec', 'enc']"),
           ("llama-3.2-vision-90b", 2, {}, "['cross']")]


@pytest.mark.parametrize("arch,M,lens,dim", REFUSED)
def test_refused_splits_raise_naming_config_m_and_dimension(arch, M, lens,
                                                            dim):
    """The vlm and audio kinds raise, naming the config, M and the kinds;
    a cache length M does not divide (beside kv heads it does not
    divide) takes the reference's head_dim block on every rank."""
    cfg = get_config(arch)
    assert port.trunk_plan(cfg, 1).split is False     # M = 1 splits nothing
    if cfg.arch_type in ("audio", "vlm"):
        with pytest.raises(ValueError) as e:
            port.trunk_plan(cfg, M, **lens)
        msg = str(e.value)
        assert cfg.name in msg and f"M = {M}" in msg and dim in msg
        return
    (what, n), = lens.items()
    mesh = _mesh(M)
    shape = (1, 1, n, cfg.num_kv_heads, cfg.resolved_head_dim)
    spec = tuple(ref.cache_shardings(
        {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16)}, mesh,
        jax_get_config(arch))["k"])
    assert spec[4] == "model", dim
    for rank in range(M):
        plan = port.trunk_plan(cfg, M, rank, **lens)
        assert getattr(plan, {"cache_len": "cache",
                              "page_size": "pool"}[what]) == "dh"
        sl = port.shard_slice(spec, shape, mesh, rank)[4]
        assert plan.head_dims == (sl.start, sl.stop)


COVERED = ("syncode-demo", "qwen1.5-0.5b", "internlm2-1.8b",
           "deepseek-coder-33b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("arch", COVERED)
def test_covered_configs_split_whole_heads(arch, M):
    """Every covered config splits q and kv heads M ways; d_ff and E
    split exactly where the reference's rules split their leaves."""
    cfg = get_config(arch)
    plan = port.trunk_plan(cfg, M, M - 1)
    mesh = _mesh(M)
    assert plan.heads * M == cfg.num_heads
    assert plan.kv_heads * M == cfg.num_kv_heads
    assert plan.ff_split == (port.param_spec(
        "['groups'][0][0]['ffn']['w_gate']", (1, cfg.d_model, cfg.d_ff),
        mesh)[-1] == "model")
    if cfg.num_experts:
        assert plan.experts_split == (port.param_spec(
            "['groups'][0][0]['moe']['w_gate']",
            (1, cfg.num_experts, cfg.d_model, cfg.expert_d_ff),
            mesh)[1] == "model")
    local = plan.local_config(cfg)
    assert local.resolved_head_dim == cfg.resolved_head_dim
    assert local.num_experts == cfg.num_experts
    if cfg.num_experts:
        assert local.expert_d_ff == cfg.expert_d_ff


def _stand_in_mesh(M):
    """A mesh of M ranks with no process group (collectives would be
    identities)."""
    return ServingMesh({"data": 1, "model": M}, ("data", "model"))


class _Planned(Exception):
    """Raised by `_plan_spy` once a plan is made: nothing is drawn."""


def _plan_spy(monkeypatch, module, seen):
    real = port.serving_trunk_plan

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        raise _Planned
    monkeypatch.setattr(module, "serving_trunk_plan", spy)


def test_engine_and_launcher_refuse_what_the_plan_refuses(monkeypatch):
    """The launcher and the engine pass the engine's max_len and, when
    paged, its page_size to the plan: smollm-360m's 5 kv heads at M = 2
    take the sequence split at max_len 512, the head_dim split at 511
    and, paged, at page_size 15; recurrentgemma-9b's one kv head (its
    first three layers: rec, rec, attn) at a ring of 511 positions. (The
    plan stops the build: nothing is drawn.)"""
    from repro_torch.launch import serve
    from repro_torch.serving import engine as engine_mod
    seen = []
    _plan_spy(monkeypatch, serve, seen)
    cases = (("smollm-360m", 1, dict(max_len=512), "cache", "seq"),
             ("smollm-360m", 1, dict(max_len=511), "cache", "dh"),
             ("smollm-360m", 1, dict(paged=True, page_size=15), "pool",
              "dh"),
             ("recurrentgemma-9b", 3, dict(max_len=511), "cache", "dh"))
    for arch, layers, kw, kind, want in cases:
        with pytest.raises(_Planned):
            serve.build_engine(arch, grammars=(), device="cpu",
                               mesh=_stand_in_mesh(2), trunk_shard=True,
                               num_layers=layers, **kw)
        assert getattr(seen.pop(), kind) == want, (arch, kw)
    _plan_spy(monkeypatch, engine_mod, seen)
    cfg = replace(get_config("smollm-360m"), num_layers=1)
    for kw, kind, want in ((dict(max_len=511), "cache", "dh"),
                           (dict(max_len=512, paged=True, page_size=15),
                            "pool", "dh"),
                           (dict(max_len=512, paged=True, page_size=16),
                            "pool", "seq")):
        with pytest.raises(_Planned):
            engine_mod.Engine(build_model(cfg, device="meta"), None,
                              None, {}, mesh=_stand_in_mesh(2),
                              trunk_shard=True, **kw)
        assert getattr(seen.pop(), kind) == want, kw


# --------------------------- the cut as drawn ---------------------------

@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("name", (*C.CONFIGS, *C.SEQ_CONFIGS))
def test_init_cut_as_drawn_is_the_whole_init_cut(name, M):
    """`Model.init(gen, cut=...)` draws each leaf's block bit for bit as
    the whole init's leaf cut after the fact (column blocks that cut
    inside a head too: SEQ_CONFIGS), and the engine keeps such blocks as
    they are."""
    cfg = C.config(name)
    model = build_model(cfg, device="cpu")
    whole = model.init(torch.Generator().manual_seed(11))
    mesh = _mesh(M)
    for rank in range(M):
        vs = port.vocab_shard(C.V, M, rank)
        cut = lambda p, shape: port.trunk_slice(p, shape, mesh, rank, vs)
        drawn = model.init(torch.Generator().manual_seed(11), cut=cut)
        got = dict(port.leaves_with_path(drawn))
        for path, leaf in port.leaves_with_path(whole):
            assert torch.equal(got[path], leaf[cut(path, leaf.shape)]), path
        kept = bridge.shard_params(drawn, cut,
                                   whole=model.abstract_params())
        assert all(a is b for (_, a), (_, b) in zip(
            port.leaves_with_path(kept), port.leaves_with_path(drawn)))
        recut = bridge.shard_params(whole, cut,
                                    whole=model.abstract_params())
        for (_, a), (_, b) in zip(port.leaves_with_path(recut),
                                  port.leaves_with_path(drawn)):
            assert torch.equal(a, b)


def test_shard_params_refuses_a_leaf_of_neither_shape():
    model = build_model(C.config("dense"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params["groups"][0][0]["attn"]["wq"] = torch.zeros(2, 128, 3)
    mesh = _mesh(2)
    vs = port.vocab_shard(C.V, 2, 0)
    with pytest.raises(ValueError, match="neither the whole leaf"):
        bridge.shard_params(
            params, lambda p, s: port.trunk_slice(p, s, mesh, 0, vs),
            whole=model.abstract_params())


@pytest.mark.parametrize("M", WORLDS)
def test_launcher_draws_blocks_and_cuts_checkpoints(runs, M):
    """build_engine's two trunk paths (syncode-demo, 2 layers, bf16 as
    the config has it): seeded weights drawn block by block, and a
    checkpoint read into host memory and cut, each serve the greedy
    tokens of the unsharded engine on the same weights."""
    _, base, sharded = runs
    for res in sharded[M]:
        assert res["launcher"] == base["launcher"]
