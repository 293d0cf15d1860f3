"""Trunk-sharded serving of the recurrent families (`Engine(mesh=...,
trunk_shard=True)` on mamba2's `ssm` kind and recurrentgemma's `rec` +
local `attn` kinds): each rank holds the blocks the reference's rules
give it (w_in columns, conv channels, SSD heads, the RG-LRU's width,
w_out rows) and exchanges what it needs by explicit collectives. On the
CPU: gloo ranks started by `launch.mesh.spawn`, worlds of 1 (in this
process), 2 and 4, on the two narrow fp32 configs of
`tests/_torch_recurrent_cases.py`, with the reference's
`Model.init(PRNGKey(0))` weights bridged in (their constant vectors
drawn at random).

What is held, per config and world:
  * each rank's blocks are `shard_slice` of the REFERENCE's
    `serving_param_spec(..., trunk_shard=True)`, and its prefill and
    decode caches have the shapes of the reference's `cache_shardings`
    blocks;
  * the first prefill and decode logits equal the JAX single-device
    model's within atol 1e-4, rtol 2e-6 (the SSM's prefill over two
    chunks, the hybrid's past its ring);
  * greedy and sampled `generate()` over six grammars, a long run and
    `generate_sequential` give the unsharded port's tokens, and so does
    `launch.serve.build_engine(..., trunk_shard=True)`;
  * the decode step's collectives against `distributed/cost.py`'s count
    and the bytes a rank holds against the dry run's argument bytes;
and, with no ranks: `Model.init(cut=...)` against the cut of the whole
init, the plans of mamba2-370m and recurrentgemma-9b at full width
against the reference's rules, and the hybrid's ring planned at its
local window."""
import threading

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
from repro_torch.distributed.api import use_sharding
from repro_torch.launch.dryrun import tree_shard_bytes
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.model import build_model, layer_groups
import _torch_recurrent_cases as R
import _torch_sharded_cases as S

WORLDS = (1, 2, 4)
FP32_TOL = dict(atol=1e-4, rtol=2e-6)
CASES = ("greedy", "sampled", "long", "sequential")


def _mesh(M):
    return MeshShape({"data": 1, "model": M}, ("data", "model"))


def _payload(name):
    """(reference weights as numpy leaves, the recurrent vectors drawn at
    random; port tokenizer; port bundles; the model case's tokens)."""
    jp = jax_build_model(R.config(name, jax_get_config)).init(
        jax.random.PRNGKey(0))
    params = R.random_vectors(jax.tree.map(np.asarray, jp))
    tok = ByteTokenizer(R.V)
    bundles = {}
    for g in S.GRAMMARS:
        gr, tab = load_grammar(g)
        bundles[g] = (gr, tab, build_mask_store(gr, tok))
    toks = np.random.default_rng(7).integers(
        3, R.V, size=(R.B, R.PROMPT[name] + 1)).astype(np.int32)
    return params, tok, bundles, toks


@pytest.fixture(scope="module")
def runs():
    """-> (payload {config: ...}, unsharded {config: {"cases",
    "launcher"}}, sharded {M: [rank results]})."""
    payload = {name: _payload(name) for name in R.CONFIGS}
    sharded, errors = {}, []

    def world(n):
        try:
            sharded[n] = spawn(n, R.world, n, payload, device="cpu")
        except BaseException as e:          # re-raised below
            errors.append(e)
    bg = [threading.Thread(target=world, args=(n,)) for n in WORLDS
          if n > 1]
    for t in bg:
        t.start()
    base = {name: {"cases": R.run_cases(None, name, payload[name]),
                   "launcher": R.launcher_case(None, name)}
            for name in R.CONFIGS}
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
@pytest.mark.parametrize("name", R.CONFIGS)
def test_blocks_are_the_reference_trunk_specs(runs, name, M):
    """Each rank's blocks are the reference's trunk rule's, cut from the
    bridged leaves; embed is the word-aligned vocab split."""
    payload, _, sharded = runs
    whole = dict(port.leaves_with_path(payload[name][0]))
    cfg = R.config(name, jax_get_config)
    mesh = _mesh(M)
    for rank, res in enumerate(sharded[M]):
        got = dict(port.leaves_with_path(res[name]["model"]["params"]))
        assert got.keys() == whole.keys()
        vs = port.vocab_shard(R.V, M, rank)
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
    return [tuple({k: tuple(s.stop - s.start for s in port.shard_slice(
        sp[k], leaf[k].shape, mesh, rank)) for k in leaf}
        for leaf, sp in zip(g, gs)) for g, gs in zip(tree, specs)]


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", R.CONFIGS)
def test_cache_shapes_are_the_reference_blocks(runs, name, M):
    """A rank's decode caches and the caches its prefill returns: the
    reference's blocks (its heads' or its width's state, its conv
    channels; the hybrid's ring of 16 positions on the sequence)."""
    _, _, sharded = runs
    cfg = R.config(name, jax_get_config)
    caches = jax.eval_shape(lambda: jax_build_model(cfg).init_decode_caches(
        R.B, R.MAX_LEN))
    mesh = _mesh(M)
    for rank, res in enumerate(sharded[M]):
        want = _reference_blocks(caches, mesh, cfg, rank)
        assert res[name]["model"]["caches"] == want
        assert res[name]["model"]["prefill_caches"] == want


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", R.CONFIGS)
def test_logits_match_the_jax_single_device_model(runs, name, M):
    """The first prefill and decode logits of every rank against the
    reference's one-device Model on the same weights and tokens."""
    payload, _, sharded = runs
    params, _, _, toks = payload[name]
    P = R.PROMPT[name]
    jm = jax_build_model(R.config(name, jax_get_config))
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P])},
                        cache_len=R.MAX_LEN, true_len=P)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, P]),
                           jnp.full((R.B,), P, jnp.int32))
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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", R.CONFIGS)
def test_trunk_tokens_equal_unsharded(runs, name, M, case):
    _, base, sharded = runs
    for rank, res in enumerate(sharded[M]):
        assert res[name]["cases"][case] == base[name]["cases"][case], \
            f"rank {rank} of {M}"


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", R.CONFIGS)
def test_launcher_serves_the_family(runs, name, M):
    """`build_engine(arch, mesh=..., trunk_shard=True)`: each rank draws
    its blocks of the seeded weights and serves the unsharded engine's
    tokens, dense and sequential."""
    _, base, sharded = runs
    for res in sharded[M]:
        assert res[name]["launcher"] == base[name]["launcher"]


@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("name", R.CONFIGS)
def test_decode_collectives_against_the_cost_count(runs, name, M):
    """The collectives one decode step issued, against
    `cost.decode_step(..., mesh)`, which counts the reference's GSPMD
    form: one all-reduce after every row-parallel product (w_out, the
    FFN's w_down, attention's wo), the embedding's, and under the
    sequence split one all-reduce of [B, H, Dh + 2] fp32 joining the
    partial attentions. The port differs by exactly:
      * ssm: the w_out all-reduce carries the gated norm's fp32 sum of
        squares beside the partial ([B, D + 1] fp32) where the heads
        split; it all-gathers the projection ([B, 2 Din + 2N + Hs]) where
        w_in splits and the conv output ([B, Din + 2N]) where the conv
        splits;
      * rec: one all-gather of the conv output ([B, R] fp32) where R
        splits;
      * attn (sequence split): all-gathers of the q/k/v column blocks and
        of the [B, 1, H, Dh + 1] partials in place of the join's
        all-reduce."""
    _, _, sharded = runs
    cfg = R.config(name)
    want = cost.decode_step(cfg, R.B, R.MAX_LEN, mesh=_mesh(M))
    ar_count = want["collectives"]["all-reduce"]["count"]
    ar_wire = want["collectives"]["all-reduce"]["wire_bytes"]
    plan = port.trunk_plan(cfg, M, 0, cache_len=port.ring_len(
        cfg, R.MAX_LEN))
    kinds = [k for pat, c in layer_groups(cfg) for k in pat * c]
    gathers = []                        # bytes of each all-gather
    extra_ar = 0
    if name == "ssm":
        Din, N, Hs = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
        for _ in kinds:
            if plan.ssm_in is not None:
                gathers.append(R.B * (2 * Din + 2 * N + Hs) * 4)
            if plan.ssm_conv is not None:
                gathers.append(R.B * (Din + 2 * N) * 4)
            if plan.ssm_heads is not None:
                extra_ar += R.B * 4
    else:
        H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        n_attn = kinds.count("attn")
        for kind in kinds:
            if kind == "rec" and plan.rec_width is not None:
                gathers.append(R.B * cfg.lru_dim * 4)
            if kind == "attn":
                gathers += [R.B * (H + 2 * K) * Dh * 4,
                            M * R.B * H * (Dh + 1) * 4]
        ar_count -= n_attn
        ar_wire -= n_attn * cost.wire("all-reduce", R.B * H * (Dh + 2) * 4,
                                      M)
    for res in sharded[M]:
        tally = res[name]["model"]["tally"]
        assert tally["all-reduce"]["count"] == ar_count
        assert tally["all-reduce"]["wire_bytes"] == \
            ar_wire + cost.wire("all-reduce", extra_ar, M)
        ag = tally.get("all-gather", {"count": 0, "bytes": 0})
        assert ag["count"] == len(gathers)
        assert ag["bytes"] == sum(gathers)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", R.CONFIGS)
def test_resident_bytes_are_the_trunk_spec_argument_bytes(runs, name, M):
    """The params and decode caches a rank holds, byte for byte the dry
    run's argument bytes under the serving trunk specs."""
    _, _, sharded = runs
    cfg = R.config(name)
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    caches = model.init_decode_caches(R.B, R.MAX_LEN)
    mesh = _mesh(M)
    want = tree_shard_bytes(params, port.serving_param_specs(
        params, mesh, cfg, trunk_shard=True), mesh) + tree_shard_bytes(
        caches, port.serving_cache_specs(caches, mesh, cfg,
                                         trunk_shard=True), mesh)
    for res in sharded[M]:
        assert res[name]["model"]["resident"] == want


# ------------------------------- no ranks -------------------------------

@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("name", R.CONFIGS)
def test_init_cut_as_drawn_is_the_whole_init_cut(name, M):
    """`Model.init(gen, cut=...)` draws each ssm and rec leaf's block bit
    for bit as the whole init's leaf cut after the fact, and the engine
    keeps such blocks as they are."""
    cfg = R.config(name)
    model = build_model(cfg, device="cpu")
    whole = model.init(torch.Generator().manual_seed(11))
    mesh = _mesh(M)
    for rank in range(M):
        vs = port.vocab_shard(R.V, M, rank)
        cut = lambda p, shape: port.trunk_slice(p, shape, mesh, rank, vs)
        drawn = model.init(torch.Generator().manual_seed(11), cut=cut)
        got = dict(port.leaves_with_path(drawn))
        for path, leaf in port.leaves_with_path(whole):
            assert torch.equal(got[path], leaf[cut(path, leaf.shape)]), path
        kept = bridge.shard_params(drawn, cut,
                                   whole=model.abstract_params())
        assert all(a is b for (_, a), (_, b) in zip(
            port.leaves_with_path(kept), port.leaves_with_path(drawn)))


FULL = ("mamba2-370m", "recurrentgemma-9b")


@pytest.mark.parametrize("M", (2, 4, 8))
@pytest.mark.parametrize("arch", FULL)
def test_full_width_plans_are_the_reference_blocks(arch, M):
    """At full width every block of the plan is the reference's rule's
    on its leaf (mamba2-370m at M = 2: w_in columns 2192 a rank, so rank
    0 holds z and the first 144 xBC channels; conv channels 1152; 16
    heads, w_out rows 1024; recurrentgemma-9b: R 2048 a rank, the ring's
    2048 positions on the sequence)."""
    cfg = get_config(arch)
    mesh = _mesh(M)

    def blk(name, shape, dim, cache=False):
        spec = tuple(ref.cache_shardings({name: jax.ShapeDtypeStruct(
            shape, jnp.float32)}, mesh, cfg)[name]) if cache else \
            tuple(ref.param_spec(f"['groups'][0][0]['{kind}']['{name}']",
                                 shape, mesh))
        sl = port.shard_slice(spec, shape, mesh, rank)[dim]
        return None if spec[dim] is None else (sl.start, sl.stop)
    D, Kc = cfg.d_model, cfg.conv_kernel
    for rank in range(M):
        plan = port.serving_trunk_plan(cfg, M, rank, 4096)
        if arch == "mamba2-370m":
            kind = "ssm"
            Din, N, Hs, P = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                             cfg.ssm_head_dim)
            assert plan.ssm_in == blk("w_in", (1, D, 2 * Din + 2 * N + Hs),
                                      2)
            assert plan.ssm_conv == blk("conv_w", (1, Kc, Din + 2 * N), 2) \
                == blk("conv", (1, 1, Kc - 1, Din + 2 * N), 3, cache=True)
            assert plan.ssm_heads == blk("h", (1, 1, Hs, N, P), 2,
                                         cache=True)
            assert plan.ssm_rows == blk("w_out", (1, Din, D), 1)
            assert plan.ssm_in[1] - plan.ssm_in[0] == 4384 // M
        else:
            kind = "rec"
            R_ = cfg.lru_dim
            for name, shape, dim in (("w_gelu", (1, D, R_), 2),
                                     ("w_rec", (1, D, R_), 2),
                                     ("conv_w", (1, Kc, R_), 2),
                                     ("w_a", (1, R_, R_), 2),
                                     ("w_i", (1, R_, R_), 2),
                                     ("w_out", (1, R_, D), 1)):
                assert plan.rec_width == blk(name, shape, dim), name
            assert plan.rec_width == blk("h", (1, 1, R_), 2, cache=True)
            assert plan.cache == "seq" and plan.positions == blk(
                "k", (1, 1, 2048, 1, 256), 2, cache=True)
            assert plan.d_ff * M == cfg.d_ff and plan.ff_split


def test_hybrid_ring_is_planned_at_its_local_window():
    """recurrentgemma-9b's attention layers are local (window 2048):
    `Model.init_decode_caches` sizes their ring at min(max_len, 2048).
    At max_len 4096 the plan's positions are each rank's share of those
    2048 (not of 4096), and a rank's caches hold exactly that share."""
    cfg = get_config("recurrentgemma-9b")
    model = build_model(cfg, device="meta")
    for rank in range(2):
        plan = port.serving_trunk_plan(cfg, 2, rank, 4096)
        assert plan.positions == (1024 * rank, 1024 * (rank + 1))
        with use_sharding(None, None, plan):
            caches = model.init_decode_caches(1, 4096)
        attn = caches[0][2]
        assert attn["kv_pos"].shape[-1] == 2048
        assert attn["k"].shape[2] == 1024
        assert caches[0][0]["h"].shape[-1] == 2048
