"""Trunk-sharded serving where M divides neither the kv heads nor a cache
length: the reference's rules then put a cache's head_dim on "model"
(the head_dim branch, "dh"), or, where M does not divide head_dim
either, keep the whole cache on every rank (the replicated branch,
"whole"), for the dense caches and the page pools alike, each by its own
length. A rank gathers whole q/k/v heads; under "dh" it holds its block
of every position's channels, all-reduces its fp32 partial scores,
masks and softmaxes once and gathers its block of P.V
(`models/layers.py::_dh_join`; paged, the kernel's head_dim form
`paged_attention_scores` / `paged_attention_values`); under "whole" it
attends as one device does.

The worlds (`tests/_torch_dh_cases.py`, gloo ranks started by
`launch.mesh.spawn`; the world of 1 in this process), fp32, the
reference's `Model.init(PRNGKey(0))` weights bridged in:
  * M = 2: a 6/3-head dense config at max_len 47, pages of 9: dense
    cache and pool on head_dim (16 channels a rank); the hybrid's ring of
    13 positions on head_dim;
  * M = 3: an 8/4-head dense config at max_len 47, pages of 8: dense
    cache and pool whole; an 8/2-head MoE whole; the hybrid's ring
    whole;
  * M = 4: the 6/3-head config at max_len 48, pages of 9: a
    sequence-split dense cache beside a pool on head_dim (8 channels);
    the MoE and the hybrid's ring on head_dim (8 channels).
What is held there:
  * each rank's blocks are `shard_slice` of the reference's
    `serving_param_spec(..., trunk_shard=True)`, and its caches and
    pools have the shapes of the reference's `cache_shardings` blocks,
    in the branch the table above names;
  * the first prefill and decode logits equal the JAX one-device
    model's within atol 1e-4, rtol 2e-6;
  * every serving case of `tests/_torch_sharded_cases.py` (and the
    hybrid's of `tests/_torch_recurrent_cases.py` at M = 2 and 3) gives
    the unsharded port's tokens;
  * the bytes a rank holds equal the dry run's argument bytes, and the
    decode step's collectives are `distributed/cost.py`'s but for the
    differences named in the test;
and, with no ranks: the plain head_dim forms, all-reduced and gathered,
against `attend` and `paged_attention_ref` at 2, 3 and 4 blocks, and the
plans of registry configs that take these branches against the
reference's rules.
"""
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
from repro_torch.configs import get_config
from repro_torch.core.grammars import load_grammar
from repro_torch.core.mask_store import build_mask_store
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.distributed import cost
from repro_torch.distributed import sharding as port
from repro_torch.kernels.paged_attention.ref import (
    attend, dh_probs, dh_scores, dh_values, paged_attention_ref,
    paged_scores_ref, paged_values_ref)
from repro_torch.launch.dryrun import tree_shard_bytes
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.model import build_model, layer_groups
import _torch_dh_cases as D
import _torch_recurrent_cases as R
import _torch_sharded_cases as S
import _torch_trunk_cases as C

WORLDS = (1, 2, 3, 4)
FP32_TOL = dict(atol=1e-4, rtol=2e-6)
# the joined head_dim forms against whole attention: the partial scores
# add in another order than the whole dot (fp32: a few ulps of scores of
# magnitude ~10); bf16: P and the output round to bf16 at the same points
# as `attend`, so a sum-order flip moves an output by a bf16 ulp at most
FORM_TOL = {torch.float32: 2e-6, torch.bfloat16: 2.0 ** -7}
MODELS = ("served", "moe", "hybrid")


def _mesh(M):
    return MeshShape({"data": 1, "model": M}, ("data", "model"))


def _bundles(tok):
    out = {}
    for g in S.GRAMMARS:
        gr, tab = load_grammar(g)
        out[g] = (gr, tab, build_mask_store(gr, tok))
    return out


def _payload():
    """{config: (reference weights as numpy leaves, QKV biases or the
    recurrent vectors drawn at random; port tokenizer; port bundles; the
    model case's [B, P + 1] tokens)}."""
    tok = ByteTokenizer(C.V)
    bundles = _bundles(tok)
    rng = np.random.default_rng(7)
    out = {}
    for name in ("seq", "dense", D.MOE):
        jp = jax_build_model(C.config(name, jax_get_config)).init(
            jax.random.PRNGKey(0))
        out[name] = (C.random_biases(jax.tree.map(np.asarray, jp)), tok,
                     bundles, rng.integers(3, C.V, size=(
                         C.B, C.SEQ_P + 1)).astype(np.int32))
    jp = jax_build_model(D.hybrid_config(jax_get_config)).init(
        jax.random.PRNGKey(0))
    out["hybrid"] = (R.random_vectors(jax.tree.map(np.asarray, jp)), tok,
                     bundles, rng.integers(3, R.V, size=(
                         R.B, R.PROMPT["hybrid"] + 1)).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def runs():
    """-> (payload, unsharded `D.unsharded`, sharded {M: [rank
    results]})."""
    payload = _payload()
    sharded, errors = {}, []

    def world(n):
        try:
            sharded[n] = spawn(n, D.world, n, payload, device="cpu")
        except BaseException as e:          # re-raised below
            errors.append(e)
    bg = [threading.Thread(target=world, args=(n,)) for n in WORLDS
          if n > 1]
    for t in bg:
        t.start()
    base = D.unsharded(payload)
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


def _model(what, M):
    """(port config, reference config, the model case's dense cache
    length, its page size or None, its prompt length) of `what` in the
    world of M ranks."""
    if what == "served":
        name, max_len, page = D.SERVED[M]
        return C.config(name), C.config(name, jax_get_config), max_len, \
            page, C.SEQ_P
    if what == "moe":
        return C.config(D.MOE), C.config(D.MOE, jax_get_config), \
            D.MOE_LEN, C.PAGE, C.SEQ_P
    return D.hybrid_config(), D.hybrid_config(jax_get_config), R.MAX_LEN, \
        None, R.PROMPT["hybrid"]


def _result(res, what):
    return res[what]["model"] if what != "moe" else res["moe"]


def _payload_of(payload, what, M):
    return payload[{"served": D.SERVED[M][0], "moe": D.MOE,
                    "hybrid": "hybrid"}[what]]


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("what", MODELS)
def test_blocks_are_the_reference_trunk_specs(runs, what, M):
    payload, _, sharded = runs
    _, jcfg, _, _, _ = _model(what, M)
    whole = dict(port.leaves_with_path(_payload_of(payload, what, M)[0]))
    mesh = _mesh(M)
    for rank, res in enumerate(sharded[M]):
        got = dict(port.leaves_with_path(_result(res, what)["params"]))
        assert got.keys() == whole.keys()
        vs = port.vocab_shard(C.V, M, rank)
        for path, leaf in whole.items():
            if port._leaf_name(path) in ("embed", "lm_head"):
                sl = port.vocab_slice(path, leaf.shape, vs)
            else:
                spec = tuple(ref.serving_param_spec(
                    path, leaf.shape, mesh, jcfg, trunk_shard=True))
                sl = port.shard_slice(spec, leaf.shape, mesh, rank)
            np.testing.assert_array_equal(got[path], leaf[sl], err_msg=path)


def _reference_blocks(tree, mesh, cfg, rank):
    specs = ref.serving_cache_shardings(tree, mesh, cfg, trunk_shard=True)
    return [tuple({k: tuple(s.stop - s.start for s in port.shard_slice(
        sp[k], leaf[k].shape, mesh, rank)) for k in leaf}
        for leaf, sp in zip(g, gs)) for g, gs in zip(tree, specs)]


# (world, model) -> the branches (dense cache, pool) of its plan
BRANCHES = {(M, "served"): D.BRANCHES[M] for M in WORLDS}
BRANCHES.update({(1, "moe"): (None, None), (2, "moe"): ("heads", "heads"),
                 (3, "moe"): ("whole", "whole"), (4, "moe"): ("dh", "seq"),
                 (1, "hybrid"): (None, None), (2, "hybrid"): ("dh", None),
                 (3, "hybrid"): ("whole", None),
                 (4, "hybrid"): ("dh", None)})


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("what", MODELS)
def test_cache_and_pool_shapes_are_the_reference_blocks(runs, what, M):
    """Each rank's decode caches (and, but for the hybrid, which pages
    nothing, its page pool) have the shapes of the reference's blocks,
    and its plan takes the branch BRANCHES names, with the reference's
    head_dim block where that is "dh"."""
    _, _, sharded = runs
    cfg, jcfg, max_len, page, _ = _model(what, M)
    jm = jax_build_model(jcfg)
    caches = jax.eval_shape(lambda: jm.init_decode_caches(C.B, max_len))
    mesh = _mesh(M)
    Dh = cfg.resolved_head_dim
    for rank, res in enumerate(sharded[M]):
        got = _result(res, what)
        assert got["caches"] == _reference_blocks(caches, mesh, jcfg, rank)
        if page is not None:
            pools = jax.eval_shape(lambda: jm.init_paged_caches(C.PAGES,
                                                                page))
            assert got["pools"] == _reference_blocks(pools, mesh, jcfg,
                                                     rank)
        plan = port.serving_trunk_plan(cfg, M, rank, max_len, page)
        assert (plan.cache, plan.pool) == BRANCHES[M, what]
        if "dh" in (plan.cache, plan.pool):
            assert plan.head_dims == (rank * Dh // M, (rank + 1) * Dh // M)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("what", MODELS)
def test_logits_match_the_jax_single_device_model(runs, what, M):
    payload, _, sharded = runs
    params, _, _, toks = _payload_of(payload, what, M)
    _, jcfg, max_len, _, P = _model(what, M)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P])},
                        cache_len=max_len, true_len=P)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, P]),
                           jnp.full((toks.shape[0],), P, jnp.int32))
    first = _result(sharded[M][0], what)
    for rank, res in enumerate(sharded[M]):
        got = _result(res, what)
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
@pytest.mark.parametrize("M", (2, 3, 4))
def test_tokens_equal_unsharded(runs, M, case, grammar):
    _, base, sharded = runs
    want = base[D.SERVED[M]][case]
    rids = None
    if grammar != "-":
        reqs = {"greedy": S.greedy_requests,
                "sampled": S.sampled_requests}[case]()
        rids = {r.rid for r in reqs if r.grammar == grammar}
        assert rids
        want = {rid: v for rid, v in want.items() if rid in rids}
    for rank, res in enumerate(sharded[M]):
        got = res["served"]["cases"][case]
        if rids is not None:
            got = {rid: v for rid, v in got.items() if rid in rids}
        assert got == want, f"rank {rank} of {M}"
    if case == "paged":
        assert all(res["served"]["cases"]["paged_hit_rate"] ==
                   base[D.SERVED[M]]["paged_hit_rate"] > 0
                   for res in sharded[M])


@pytest.mark.parametrize("case", ("greedy", "sampled", "long",
                                  "sequential"))
@pytest.mark.parametrize("M", D.HYBRID_CASES)
def test_hybrid_tokens_equal_unsharded(runs, M, case):
    """The hybrid's local attention on a ring of 13 (head_dim at M = 2,
    whole at 3) beside its RG-LRU split: the unsharded port's tokens; the
    long run wraps the ring."""
    _, base, sharded = runs
    for rank, res in enumerate(sharded[M]):
        assert res["hybrid"]["cases"][case] == base["hybrid"][case], \
            f"rank {rank} of {M}"


@pytest.mark.parametrize("M", (2, 3, 4))
def test_decode_collectives_against_the_cost_count(runs, M):
    """One decode step of the served config, against
    `cost.decode_step(..., mesh)` (the reference's GSPMD form): its
    row-parallel all-reduces (wo and w_down, where M divides them) and
    the embedding's (where M divides V) are the port's; under "dh" so is
    the all-reduce of the fp32 partial scores, [B, H, L] a layer, and
    under the sequence split cost.py's join of [B, H, Dh + 2] is the
    port's all-gather of [B, 1, H, Dh + 1] partials instead. The port
    adds: the all-gather of the q/k/v column blocks that cut inside
    heads, fp32 [B, 1, (H + 2K) Dh / M] a rank (none where no column
    block splits, M = 3), under "dh" the all-gather of o's head_dim
    blocks ([B, 1, H, Dh / M] a rank), and the embedding's all-reduce
    where the word-aligned vocabulary split splits what V % M leaves
    whole (V 1024 at M = 3)."""
    _, _, sharded = runs
    name, max_len, _ = D.SERVED[M]
    cfg = C.config(name)
    want = cost.decode_step(cfg, C.B, max_len, mesh=_mesh(M))
    n = sum(c for _, c in layer_groups(cfg))
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    plan = port.serving_trunk_plan(cfg, M, 0, max_len)
    ar = want["collectives"].get("all-reduce", {"count": 0,
                                                "wire_bytes": 0.0})
    ar_count, ar_wire = ar["count"], ar["wire_bytes"]
    gathers = 0
    if plan.q_cols is not None or plan.kv_cols is not None:
        gathers += n * C.B * ((H * Dh if plan.q_cols else 0) +
                              (2 * K * Dh if plan.kv_cols else 0)) * 4
    ag_count = n * (plan.q_cols is not None or plan.kv_cols is not None)
    if plan.cache == "seq":
        ar_count -= n
        ar_wire -= n * cost.wire("all-reduce", C.B * H * (Dh + 2) * 4, M)
        gathers += n * M * C.B * H * (Dh + 1) * 4
        ag_count += n
    elif plan.cache == "dh":
        gathers += n * C.B * H * Dh * 4
        ag_count += n
    if port.vocab_shard(C.V, M, 0).split and C.V % M:
        ar_count += 1
        ar_wire += cost.wire("all-reduce", C.B * cfg.d_model * 4, M)
    for res in sharded[M]:
        tally = res["served"]["model"]["tally"]
        got = tally.get("all-reduce", {"count": 0, "wire_bytes": 0.0})
        assert got["count"] == ar_count
        assert got["wire_bytes"] == pytest.approx(ar_wire, rel=1e-12)
        ag = tally.get("all-gather", {"count": 0, "bytes": 0})
        assert (ag["count"], ag["bytes"]) == (ag_count, gathers)
        assert set(tally) <= {"all-reduce", "all-gather"}


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("what", MODELS)
def test_resident_bytes_are_the_trunk_spec_argument_bytes(runs, what, M):
    """The params and decode caches a rank holds (k/v its head_dim block
    under "dh", whole under "whole"; kv_pos whole), byte for byte the dry
    run's argument bytes under the serving trunk specs, but for embed
    and lm_head: the engine splits the vocabulary at mask-store words
    (`vocab_slice`) where the specs keep a V that M does not divide
    whole (V 1024 at M = 3)."""
    _, _, sharded = runs
    cfg, _, max_len, _, _ = _model(what, M)
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    caches = model.init_decode_caches(C.B, max_len)
    mesh = _mesh(M)
    specs = port.serving_param_specs(params, mesh, cfg, trunk_shard=True)
    want = tree_shard_bytes(params, specs, mesh) + tree_shard_bytes(
        caches, port.serving_cache_specs(caches, mesh, cfg,
                                         trunk_shard=True), mesh)
    for rank, res in enumerate(sharded[M]):
        vs = port.vocab_shard(C.V, M, rank)
        words = 0
        for path, leaf in port.leaves_with_path(params):
            if port._leaf_name(path) in ("embed", "lm_head"):
                sl = port.vocab_slice(path, leaf.shape, vs)
                n = np.prod([x.stop - x.start for x in sl])
                words += (n - np.prod(leaf.shape) // (
                    M if C.V % M == 0 else 1)) * leaf.dtype.itemsize
        assert words == 0 or C.V % M
        assert _result(res, what)["resident"] == want + words


# ------------------------- the plain head_dim forms -------------------------

def _blocks(t, M):
    """t [..., Dh] -> M consecutive channel blocks [(d0, block)]."""
    n = t.shape[-1] // M
    return [(r * n, t[..., r * n:(r + 1) * n]) for r in range(M)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("M", (2, 3, 4))
@pytest.mark.parametrize("S", (1, 5))
def test_head_dim_forms_joined_are_attend(S, M, dtype):
    """M ranks' `dh_scores` over their channel blocks, summed in rank
    order (the all-reduce), `dh_probs` once, each rank's `dh_values` and
    the blocks joined in rank order, against `attend` over the whole
    cache (FORM_TOL); rows whose only key is their own included."""
    B, H, K, Dh, L = 3, 6, 3, 48, 20
    g = torch.Generator().manual_seed(M * 10 + S)
    q, k, v = (torch.randn(B, n, h, Dh, generator=g).to(dtype)
               for n, h in ((S, H), (L, K), (L, K)))
    qpos = torch.tensor([[0], [7], [L - S]]) + torch.arange(S)
    valid = torch.arange(L)[None, None, :] <= qpos[:, :, None]
    valid[1, :, :7] = False
    want = attend(q, k, v, valid)
    s = sum(dh_scores(q, kb, d0) for d0, kb in _blocks(k, M))
    p = dh_probs(s, valid, v.dtype)
    got = torch.cat([dh_values(p, vb) for _, vb in _blocks(v, M)],
                    -1).to(dtype)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FORM_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("M", (2, 3, 4))
@pytest.mark.parametrize("S,ps", [(1, 9), (1, 16), (8, 9), (8, 4)])
def test_paged_head_dim_forms_joined_are_paged_attention(S, ps, M, dtype):
    """The same through a page table: `paged_scores_ref` and
    `paged_values_ref` over each rank's channel block of the pools,
    joined, against `paged_attention_ref` over the whole pools; unmapped
    pages and spans that start inside a page included."""
    B, H, K, Dh, nP, P = 3, 6, 3, 48, 5, 16
    g = torch.Generator().manual_seed(M * 100 + ps + S)
    q = torch.randn(B, S, H, Dh, generator=g).to(dtype)
    kp = torch.randn(P, ps, K, Dh, generator=g).to(dtype)
    vp = torch.randn(P, ps, K, Dh, generator=g).to(dtype)
    pt = torch.randperm(P, generator=g)[:B * nP].reshape(B, nP).int()
    pt[2, 3:] = -1
    pos = torch.tensor([0, ps + 1, 2 * ps + ps // 2], dtype=torch.int32)
    want = paged_attention_ref(q, kp, vp, pt, pos)
    qpos = pos[:, None] + torch.arange(S, dtype=torch.int32)[None, :]
    idx = torch.arange(nP * ps, dtype=torch.int32)
    valid = (pt >= 0).repeat_interleave(ps, dim=1)[:, None, :] & \
        (idx[None, None, :] <= qpos[:, :, None])
    s = sum(paged_scores_ref(q, kb, pt, d0) for d0, kb in _blocks(kp, M))
    p = dh_probs(s, valid, vp.dtype)
    got = torch.cat([paged_values_ref(p, vb, pt) for _, vb in
                     _blocks(vp, M)], -1).to(dtype)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FORM_TOL[dtype], rtol=0)


# ------------------------- the registry's plans -------------------------

# (config, M, the engine's cache lengths, the branches (dense cache,
# pool)): the reference's 16-way model axis with 8-position pages
# (head_dim 64 or 128 divides 16 ways), smollm-360m on 2 ranks at odd
# lengths, and M = 3 and 6, which divide no head_dim of these configs
REGISTRY = [("syncode-demo", 8, dict(cache_len=100, page_size=16),
             ("dh", "seq")),
            ("qwen3-moe-30b-a3b", 8, dict(cache_len=512, page_size=4),
             ("seq", "dh")),
            ("internlm2-1.8b", 16, dict(cache_len=512, page_size=8),
             ("seq", "dh")),
            ("kimi-k2-1t-a32b", 16, dict(cache_len=4096, page_size=8),
             ("seq", "dh")),
            ("smollm-360m", 16, dict(cache_len=512, page_size=8),
             ("seq", "dh")),
            ("smollm-360m", 2, dict(cache_len=63, page_size=9),
             ("dh", "dh")),
            ("smollm-360m", 3, dict(cache_len=64, page_size=16),
             ("whole", "whole")),
            ("smollm-360m", 6, dict(cache_len=64, page_size=16),
             ("whole", "whole")),
            ("qwen3-moe-30b-a3b", 3, dict(cache_len=512, page_size=16),
             ("whole", "whole")),
            ("recurrentgemma-9b", 3, dict(cache_len=2048), ("whole", None))]


@pytest.mark.parametrize("arch,M,lens,branches", REGISTRY)
def test_registry_plans_take_the_reference_branch(arch, M, lens, branches):
    """Each rank's plan: the branch the reference's `cache_shardings`
    gives a [c, B, L, K, Dh] cache and a [c, P, ps, K, Dh] pool at these
    lengths, its head_dim block under "dh", its positions or offsets
    under "seq"; q/k/v gathered, every head kept by the local config."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh = _mesh(M)
    K, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    for rank in range(M):
        plan = port.trunk_plan(cfg, M, rank, **lens)
        assert (plan.cache, plan.pool) == branches and plan.gathers
        local = plan.local_config(cfg)
        assert (local.num_heads, local.num_kv_heads) == \
            (cfg.num_heads, K)
        for kind, key, n in (("cache", "cache_len", lens.get("cache_len")),
                             ("pool", "page_size", lens.get("page_size"))):
            if n is None:
                continue
            shape = (1, 1, n, K, Dh)
            spec = tuple(ref.cache_shardings(
                {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16)}, mesh,
                jcfg)["k"])
            sl = port.shard_slice(spec, shape, mesh, rank)
            split = getattr(plan, kind)
            assert spec[3] is None
            assert (spec[2] == "model") == (split == "seq")
            assert (spec[4] == "model") == (split == "dh")
            if split == "dh":
                assert plan.head_dims == (sl[4].start, sl[4].stop)
            if split == "seq":
                got = plan.positions if kind == "cache" else plan.offsets
                assert got == (sl[2].start, sl[2].stop)


def test_a_plan_without_a_length_refuses_that_cache():
    """A plan made without a page size (or a cache length) where the rank
    gathers cannot size that kind of cache: the model raises instead of
    guessing a split."""
    from repro_torch.distributed.api import use_sharding
    cfg = replace(C.config("seq"), num_layers=1)
    plan = port.trunk_plan(cfg, 2, 0, cache_len=47)
    model = build_model(cfg, device="meta")
    with use_sharding(None, None, plan):
        assert model.init_decode_caches(1, 47)[0][0]["k"].shape[-1] == 16
        with pytest.raises(ValueError, match="page size"):
            model.init_paged_caches(4, 9)
