"""Trunk-sharded serving where M does not divide the kv heads (the
sequence split): the reference's rules then cut wq/wk/wv's columns
inside heads and put the dense cache's sequence dim, and a pool's
in-page offset, on "model". A rank gathers whole q/k/v heads, attends
over its own positions (`attend_partial`, `paged_attention_partial`)
and joins the ranks' partials by their log-sum-exp.

What is held, on the CPU (gloo ranks started by `launch.mesh.spawn`,
worlds of 1 in this process, 2 and 4), for the fp32 configs of
`tests/_torch_trunk_cases.py::SEQ_CONFIGS` (dense 6/3 heads; an 8/2-head
MoE, whose split at M = 4 is the sequence split beside the expert split)
with the reference's `Model.init(PRNGKey(0))` weights bridged in:
  * each rank's blocks are `shard_slice` of the reference's
    `serving_param_spec(..., trunk_shard=True)`, and its caches and
    pools have the shapes of the reference's `cache_shardings` blocks;
  * the first prefill and decode logits equal the JAX single-device
    model's within atol 1e-4, rtol 2e-6 (the decode step's position on
    the last rank, every rank's positions live);
  * every serving case of `tests/_torch_sharded_cases.py` (dense greedy
    and sampled over six grammars, a long run to position 47,
    speculative, paged with a shared prefix, a two-grammar store,
    sequential, opportunistic, and at M = 2 an AsyncEngine with
    followers) gives the unsharded port's tokens, and the last rank's
    share of the cache holds live positions;
  * the decode step's collectives against `distributed/cost.py`, and the
    bytes a rank holds against the dry run's argument bytes;
and, with no ranks: the plain partial forms and their combine against
whole attention, the plans of the configs this split serves against the
reference's rules, and the cache lengths that M does not divide refused.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as ref
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.grammars import load_grammar
from repro_torch.core.mask_store import build_mask_store
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.distributed import cost
from repro_torch.distributed import sharding as port
from repro_torch.kernels.paged_attention.ref import (
    attend, attend_partial, combine_partials, paged_attention_partial_ref,
    paged_attention_ref)
from repro_torch.launch.dryrun import tree_shard_bytes
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.model import build_model, layer_groups
import _torch_sharded_cases as S
import _torch_trunk_cases as C

WORLDS = (1, 2, 4)
FP32_TOL = dict(atol=1e-4, rtol=2e-6)
PARTIAL_ATOL = 1e-6


def _mesh(M):
    return MeshShape({"data": 1, "model": M}, ("data", "model"))


def _payload(name):
    """(reference weights as numpy leaves, QKV biases drawn at random;
    port tokenizer; port bundles; the model case's [B, SEQ_P + 1]
    tokens)."""
    jp = jax_build_model(C.config(name, jax_get_config)).init(
        jax.random.PRNGKey(0))
    params = C.random_biases(jax.tree.map(np.asarray, jp))
    tok = ByteTokenizer(C.V)
    bundles = {}
    for g in S.GRAMMARS:
        gr, tab = load_grammar(g)
        bundles[g] = (gr, tab, build_mask_store(gr, tok))
    toks = np.random.default_rng(7).integers(
        3, C.V, size=(C.B, C.SEQ_P + 1)).astype(np.int32)
    return params, tok, bundles, toks


@pytest.fixture(scope="module")
def runs():
    """-> (payload {config: ...}, unsharded {"seq": run_config},
    sharded {M: [rank results]})."""
    payload = {name: _payload(name) for name in C.SEQ_CONFIGS}
    sharded, errors = {}, []

    def world(n):
        try:
            sharded[n] = spawn(n, C.seq_world, n, payload, device="cpu")
        except BaseException as e:          # re-raised below
            errors.append(e)
    bg = [threading.Thread(target=world, args=(n,)) for n in WORLDS
          if n > 1]
    for t in bg:
        t.start()
    base = {"seq": C.run_config(None, "seq", payload["seq"])}
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


def _seq(name, M):
    return C.config(name).num_kv_heads % M != 0


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.SEQ_CONFIGS)
def test_blocks_are_the_reference_trunk_specs(runs, name, M):
    """Each rank's blocks are the reference's trunk rule's (wq/wk/wv's
    columns cut inside heads where M does not divide them whole)."""
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
    return [tuple({k: tuple(s.stop - s.start for s in port.shard_slice(
        sp[k], leaf[k].shape, mesh, rank)) for k in leaf}
        for leaf, sp in zip(g, gs)) for g, gs in zip(tree, specs)]


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.SEQ_CONFIGS)
def test_cache_and_pool_shapes_are_the_reference_blocks(runs, name, M):
    _, _, sharded = runs
    cfg = C.config(name, jax_get_config)
    jm = jax_build_model(cfg)
    caches = jax.eval_shape(lambda: jm.init_decode_caches(C.B, C.SEQ_LEN))
    pools = jax.eval_shape(lambda: jm.init_paged_caches(C.PAGES, C.PAGE))
    mesh = _mesh(M)
    for rank, res in enumerate(sharded[M]):
        got = res[name]["model"]
        assert got["caches"] == _reference_blocks(caches, mesh, cfg, rank)
        assert got["pools"] == _reference_blocks(pools, mesh, cfg, rank)
        if _seq(name, M):       # every kv head, 1/M of the positions
            k = got["pools"][-1][0]["k"]
            assert k[2:4] == (C.PAGE // M, cfg.num_kv_heads)
            assert got["caches"][-1][0]["k"][2] == C.SEQ_LEN // M


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.SEQ_CONFIGS)
def test_logits_match_the_jax_single_device_model(runs, name, M):
    """The first prefill and decode logits of every rank against the
    reference's one-device Model on the same weights and tokens; the
    decode step attends over every rank's positions."""
    payload, _, sharded = runs
    params, _, _, toks = payload[name]
    P = C.SEQ_P
    jm = jax_build_model(C.config(name, jax_get_config))
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P])},
                        cache_len=C.SEQ_LEN, true_len=P)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, P]),
                           jnp.full((C.B,), P, jnp.int32))
    first = sharded[M][0][name]["model"]
    for rank, res in enumerate(sharded[M]):
        got = res[name]["model"]
        np.testing.assert_allclose(got["prefill"], np.asarray(jl),
                                   err_msg=f"prefill rank {rank}",
                                   **FP32_TOL)
        np.testing.assert_allclose(got["decode"], np.asarray(jd),
                                   err_msg=f"decode rank {rank}",
                                   **FP32_TOL)
        # the joins hand every rank the same numbers
        np.testing.assert_array_equal(got["decode"], first["decode"])


CASES = [(case, g) for case in ("greedy", "sampled")
         for g in S.GRAMMARS + (None,)] + \
    [(case, "-") for case in ("long", "speculative", "paged", "mixed",
                              "sequential", "opportunistic")]


@pytest.mark.parametrize("case,grammar", CASES)
@pytest.mark.parametrize("M", WORLDS)
def test_seq_tokens_equal_unsharded(runs, M, case, grammar):
    _, base, sharded = runs
    want = base["seq"]["cases"][case]
    rids = None
    if grammar != "-":
        reqs = {"greedy": S.greedy_requests,
                "sampled": S.sampled_requests}[case]()
        rids = {r.rid for r in reqs if r.grammar == grammar}
        assert rids
        want = {rid: v for rid, v in want.items() if rid in rids}
    for rank, res in enumerate(sharded[M]):
        got = res["seq"]["cases"][case]
        if rids is not None:
            got = {rid: v for rid, v in got.items() if rid in rids}
        assert got == want, f"rank {rank} of {M}"
    if case == "paged":
        assert all(res["seq"]["cases"]["paged_hit_rate"] ==
                   base["seq"]["cases"]["paged_hit_rate"] > 0
                   for res in sharded[M])


def test_async_followers_serve_the_sequence_split(runs):
    """Rank 0's AsyncEngine hot-loads a grammar and cancels one request;
    the follower runs `run_follower` over its share of the cache."""
    _, base, sharded = runs
    sync = base["seq"]["cases"]["async_sync"]
    ranks = [res["seq"]["cases"]["async_cancel"]
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
@pytest.mark.parametrize("name", C.SEQ_CONFIGS)
def test_every_rank_holds_live_positions(runs, name, M):
    """The model case's cache has written positions on every rank (so
    each rank's partial attention sees live keys), and the long serving
    run's last position lies on the last rank's share."""
    _, _, sharded = runs
    for rank, res in enumerate(sharded[M]):
        assert res[name]["model"]["live"] > 0, f"rank {rank} of {M}"
        if name == "seq":
            ids = res["seq"]["cases"]["long"]
            last = max(len(v[0]) for v in ids.values()) - 1
            assert last >= (M - 1) * C.SEQ_MAX_LEN // M


@pytest.mark.parametrize("M", (2, 4))
def test_decode_collectives_against_the_cost_count(runs, M):
    """One decode step's collectives, against `cost.decode_step(...,
    mesh)`. The row-parallel all-reduces (wo, w_down) and the embedding's
    are cost.py's. cost.py joins the partial attentions with one
    all-reduce of [B, H, Dh + 2] fp32 a layer (the reference's
    flash-decode form) and counts no gather of q/k/v; the port instead
    all-gathers the q/k/v column blocks (fp32 [B, 1, (H + 2K) Dh / M] a
    rank) and the [B, 1, H, Dh + 1] partials, two all-gathers a layer."""
    _, _, sharded = runs
    cfg = C.config("seq")
    want = cost.decode_step(cfg, C.B, C.SEQ_LEN, mesh=_mesh(M))
    n = sum(c for _, c in layer_groups(cfg))
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    join_ar = C.B * H * (Dh + 2) * 4
    cols = C.B * (H + 2 * K) * Dh * 4           # all ranks' blocks
    parts = M * C.B * H * (Dh + 1) * 4
    for res in sharded[M]:
        tally = res["seq"]["model"]["tally"]
        ar, ag = tally["all-reduce"], tally["all-gather"]
        assert set(tally) == {"all-reduce", "all-gather"}
        assert ar["count"] == want["collectives"]["all-reduce"]["count"] - n
        assert ar["wire_bytes"] == \
            want["collectives"]["all-reduce"]["wire_bytes"] - \
            n * cost.wire("all-reduce", join_ar, M)
        assert ag["count"] == 2 * n
        assert ag["bytes"] == n * (cols + parts)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("name", C.SEQ_CONFIGS)
def test_resident_bytes_are_the_trunk_spec_argument_bytes(runs, name, M):
    """The params and decode caches a rank holds (k/v 1/M of the
    positions, kv_pos whole), byte for byte the dry run's argument bytes
    under the serving trunk specs."""
    _, _, sharded = runs
    cfg = C.config(name)
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    caches = model.init_decode_caches(C.B, C.SEQ_LEN)
    mesh = _mesh(M)
    want = tree_shard_bytes(params, port.serving_param_specs(
        params, mesh, cfg, trunk_shard=True), mesh) + tree_shard_bytes(
        caches, port.serving_cache_specs(caches, mesh, cfg,
                                         trunk_shard=True), mesh)
    for res in sharded[M]:
        assert res[name]["model"]["resident"] == want


# ------------------------ the plain partial forms ------------------------

def _attention_inputs(seed, B, S, H, K, Dh, L, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g).to(dtype)
    k = torch.randn(B, L, K, Dh, generator=g).to(dtype)
    v = torch.randn(B, L, K, Dh, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("M", (2, 3, 4))
@pytest.mark.parametrize("S", (1, 5))
def test_attend_partial_combine_is_attend(M, S):
    """M ranks' `attend_partial` over their positions, joined by
    `combine_partials`, against `attend` over the whole cache in fp32
    (1e-6 abs). The queries sit at positions 0, 1, .. and 2L/3, so many
    rows have no valid position on the later ranks (o 0, lse NEG_INF
    there), and one row's only key is its own."""
    B, H, K, Dh, L = 3, 6, 3, 32, 12 * M
    q, k, v = _attention_inputs(M * 10 + S, B, S, H, K, Dh, L)
    qpos = torch.tensor([[0], [1], [2 * L // 3]]) + torch.arange(S)
    valid = torch.arange(L)[None, None, :] <= qpos[:, :, None]
    valid[1, :, 0] = False          # row 1, query 0: its own key only
    want = attend(q, k, v, valid)
    n = L // M
    os, lses = zip(*(attend_partial(q, k[:, r * n:(r + 1) * n],
                                    v[:, r * n:(r + 1) * n],
                                    valid[..., r * n:(r + 1) * n])
                     for r in range(M)))
    dead = ~valid[..., (M - 1) * n:].any(-1)
    assert dead.any()
    assert (lses[-1][dead] == -1e30).all() and (os[-1][dead] == 0).all()
    got = combine_partials(torch.stack(os), torch.stack(lses), q.dtype)
    torch.testing.assert_close(got, want, atol=PARTIAL_ATOL, rtol=0)


@pytest.mark.parametrize("M,ps", [(2, 4), (2, 8), (4, 8), (4, 16)])
@pytest.mark.parametrize("S", (1, 8))
def test_paged_partial_combine_is_paged_attention(M, ps, S):
    """M ranks' `paged_attention_partial_ref` over their in-page offsets
    of a split pool, joined, against `paged_attention_ref` over the
    whole pool in fp32 (1e-6 abs); unmapped pages and spans that start
    inside a page included."""
    B, H, K, Dh, nP, P = 3, 6, 3, 32, 5, 16
    g = torch.Generator().manual_seed(M * 100 + ps + S)
    q = torch.randn(B, S, H, Dh, generator=g)
    kp = torch.randn(P, ps, K, Dh, generator=g)
    vp = torch.randn(P, ps, K, Dh, generator=g)
    pt = torch.randperm(P, generator=g)[:B * nP].reshape(B, nP).int()
    pt[2, 3:] = -1
    pos = torch.tensor([0, ps + 1, 2 * ps + ps // 2], dtype=torch.int32)
    want = paged_attention_ref(q, kp, vp, pt, pos)
    n = ps // M
    os, lses = zip(*(paged_attention_partial_ref(
        q, kp[:, r * n:(r + 1) * n], vp[:, r * n:(r + 1) * n], pt, pos,
        ps, r * n) for r in range(M)))
    assert (lses[-1][0, 0] == -1e30).all()       # position 0: rank 0 only
    got = combine_partials(torch.stack(os), torch.stack(lses), q.dtype)
    torch.testing.assert_close(got, want, atol=PARTIAL_ATOL, rtol=0)


# --------------------------- the plans it serves ---------------------------

SERVED = [("smollm-360m", 2), ("smollm-360m", 4), ("syncode-demo", 8),
          ("qwen3-moe-30b-a3b", 8)]


@pytest.mark.parametrize("arch,M", SERVED)
def test_seq_plans_are_the_reference_rules(arch, M):
    """The configs this split serves: each rank's wq/wk/wv columns, wo
    rows, dense cache positions and in-page offsets are the blocks the
    reference's `param_spec` and `cache_shardings` give; the local
    config keeps every head."""
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    mesh = _mesh(M)
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    L, ps = 512, 16

    caches = {"k": jax.ShapeDtypeStruct((1, 1, L, K, Dh), jnp.bfloat16)}
    pools = {"k": jax.ShapeDtypeStruct((1, 64, ps, K, Dh), jnp.bfloat16)}
    cspec = ref.cache_shardings(caches, mesh, jcfg)["k"]
    pspec = ref.cache_shardings(pools, mesh, jcfg)["k"]
    assert cspec[2] == pspec[2] == "model" and cspec[3] is None
    for rank in range(M):
        plan = port.trunk_plan(cfg, M, rank, cache_len=L, page_size=ps)
        assert plan.cache == plan.pool == "seq" and plan.split
        for got, name, shape, dim in (
                (plan.q_cols, "wq", (1, D, H * Dh), 2),
                (plan.kv_cols, "wk", (1, D, K * Dh), 2),
                (plan.kv_cols, "wv", (1, D, K * Dh), 2),
                (plan.wo_rows, "wo", (1, H * Dh, D), 1)):
            spec = tuple(ref.param_spec(
                f"['groups'][0][0]['attn']['{name}']", shape, mesh))
            sl = port.shard_slice(spec, shape, mesh, rank)[dim]
            assert got == ((sl.start, sl.stop) if spec[dim] else None), name
        sl = port.shard_slice(cspec, (1, 1, L, K, Dh), mesh, rank)[2]
        assert plan.positions == (sl.start, sl.stop)
        sl = port.shard_slice(pspec, (1, 64, ps, K, Dh), mesh, rank)[2]
        assert plan.offsets == (sl.start, sl.stop)
        local = plan.local_config(cfg)
        assert (local.num_heads, local.num_kv_heads) == (H, K)
    # the kv columns cut inside a head in every served case
    assert (K * Dh // M) % Dh != 0


CACHE_REFUSED = [("smollm-360m", 2, dict(cache_len=511), "max_len) 511"),
                 ("smollm-360m", 4, dict(page_size=6), "page_size 6"),
                 ("syncode-demo", 8, dict(cache_len=100), "max_len) 100"),
                 ("qwen3-moe-30b-a3b", 8, dict(page_size=4), "page_size 4")]


@pytest.mark.parametrize("arch,M,kw,dim", CACHE_REFUSED)
def test_cache_lengths_m_does_not_divide_are_refused(arch, M, kw, dim):
    """Where M divides neither the kv heads nor the cache length (or the
    page size) the reference's rule splits head_dim, and so does the
    plan (these four cases were refused until the port served that
    branch): every rank's head_dim block is the reference's
    `cache_shardings` block at that length, and the same config and M
    with lengths M divides take the sequence split."""
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    mesh = _mesh(M)
    (what, n), = kw.items()
    kind = {"cache_len": "cache", "page_size": "pool"}[what]
    K, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (1, 1, n, K, Dh)
    spec = tuple(ref.cache_shardings(
        {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16)}, mesh, jcfg)["k"])
    assert spec[3] is None and spec[2] is None and spec[4] == "model", dim
    for rank in range(M):
        plan = port.trunk_plan(cfg, M, rank, **kw)
        assert getattr(plan, kind) == "dh" and plan.gathers
        sl = port.shard_slice(spec, shape, mesh, rank)[4]
        assert plan.head_dims == (sl.start, sl.stop)
        assert plan.positions is None and plan.offsets is None
    served = port.trunk_plan(cfg, M, 0, cache_len=64, page_size=16)
    assert served.cache == served.pool == "seq"
