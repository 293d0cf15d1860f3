"""The cases of tests/test_torch_trunk_shard.py, run by the unsharded port
(in the test process) and by every rank of a trunk-sharded one (gloo
ranks through `repro_torch.launch.mesh.spawn`). Imports nothing of JAX,
so the spawned ranks start quickly: the test hands them the reference's
weights as numpy leaves. Imported by its bare name (`tests/` is on the
path under pytest), as `test_torch_cuda.py` imports its helpers: the
card's machine has another package named `tests`.

Two fp32 configs, both head-aligned at M = 1, 2 and 4: a narrow dense
syncode-demo with 8/4 heads (`tests/_torch_sharded_cases.py`'s NARROW
has 4/2, which M = 4 would split on the sequence) and a narrow MoE
(qwen3-moe's layer kinds, E 8, top-2, one dense layer first, QKV bias;
d_ff and E both split). Two more take the sequence split
(`SEQ_CONFIGS`, tests/test_torch_seq_shard.py): a dense one with 6/3
heads (M = 2 and 4 divide neither K nor, at 4, H; the column blocks cut
inside heads) and an 8/2-head MoE (at M = 4 the sequence split beside
the expert split).

`world(rank, n, payload, checkpoint)` -> {config: {"model":
model_case(...), "cases": the serving cases of
`_torch_sharded_cases.run_cases` under trunk_shard}, "launcher":
`launcher_world`'s tokens}; `seq_world(rank, n, payload)` the same for
`SEQ_CONFIGS` (the MoE at the model level only).
"""
from dataclasses import replace

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.distributed.api import (collective_tally,
                                         reset_collective_tally,
                                         use_sharding)
from repro_torch.distributed.sharding import serving_trunk_plan
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
import _torch_sharded_cases as S

torch.set_num_threads(1)

V = 1024
B, P = 4, 8             # the model case: B prompts of P tokens, one step
PAGES, PAGE = 48, 8     # the pool whose leaf shapes are checked
# head_dim 32: the card's attention kernels take 32 to 256
DENSE = dict(num_layers=2, d_model=128, d_ff=256, num_heads=8,
             num_kv_heads=4, head_dim=32, vocab_size=V)
MOE = dict(DENSE, num_layers=3, first_dense_layers=1, num_experts=8,
           experts_per_token=2, moe_d_ff=64, qkv_bias=True)
CONFIGS = {"dense": ("syncode-demo", DENSE),
           "moe": ("qwen3-moe-30b-a3b", MOE)}
SEQ_CONFIGS = {"seq": ("syncode-demo", dict(DENSE, num_heads=6,
                                            num_kv_heads=3)),
               "seq_moe": ("qwen3-moe-30b-a3b", dict(MOE, num_kv_heads=2))}
# the sequence split's serving engines: a rank of 4 holds 12 positions,
# and `long_requests` run up to position 47
SEQ_MAX_LEN = 48
# its model case: 26 prompt tokens and one step in a cache of 32, so
# every rank of 2 or 4 holds live positions and the step's own position
# (26) lies on the last rank
SEQ_LEN, SEQ_P = 32, 26
ASYNC_WORLD = 2


def config(name, get=get_config):
    """The fp32 config `name` of CONFIGS or SEQ_CONFIGS from `get` (the
    port's registry, or the reference's)."""
    arch, over = {**CONFIGS, **SEQ_CONFIGS}[name]
    return replace(get(arch), dtype="float32", **over)


def _shapes(tree):
    return [tuple({k: tuple(v.shape) for k, v in c.items()} for c in g)
            for g in tree]


def _bytes(tree) -> int:
    from repro_torch.distributed.sharding import leaves_with_path
    return sum(t.numel() * t.element_size()
               for _, t in leaves_with_path(tree))


def model_case(mesh, cfg, params_np, toks, max_len=S.MAX_LEN, page=PAGE):
    """Prefill B x P tokens (toks [B, P + 1]) and one decode step at
    position P through a trunk-sharded engine's own device calls (dense
    caches of `max_len`) -> the gathered logits of both, the decode
    step's collective tally, the rank's params (numpy), the shapes of a
    fresh decode cache tree and page pool (pages of `page` positions),
    the bytes the rank holds (params + the decode caches of its slots)
    and `live`: the written positions of the first layer's cache among
    those the rank holds (all of them without a sequence split)."""
    P = toks.shape[1] - 1
    eng = Engine(build_model(cfg, device="cpu"), bridge.to_torch(params_np),
                 ByteTokenizer(V), {}, max_len=max_len, slots=B,
                 device="cpu", mesh=mesh, trunk_shard=True)
    logits, caches = eng._prefill(torch.from_numpy(toks[:, :P]), P)
    reset_collective_tally()
    step = eng._decode(caches, torch.from_numpy(toks[:, P]),
                       torch.full((B,), P, dtype=torch.int32))
    tally = collective_tally()
    tp = eng._trunk
    lo, hi = tp.positions if tp is not None and tp.cache == "seq" \
        else (0, max_len)
    dense = eng._decode_caches(B)
    # the pool a paged engine of `page`-position pages would hold, its
    # plan the same but for the pool's split
    paged = None if tp is None else serving_trunk_plan(
        cfg, tp.size, tp.rank, max_len, page)
    with use_sharding(mesh, eng._vs, paged):
        pools = eng.model.init_paged_caches(PAGES, page)
    return {"prefill": eng._gather(logits).numpy(),
            "decode": eng._gather(step).numpy(), "tally": tally,
            "params": bridge.to_numpy(eng.params),
            "caches": _shapes(dense), "pools": _shapes(pools),
            "resident": _bytes(eng.params) + _bytes(dense),
            "live": int((caches[0][0]["kv_pos"][0, :, lo:hi] >= 0).sum())}


# the card test's head_dim world: SEQ_CONFIGS' dense widths at a max_len
# and page size that M = 2 does not divide (cache and pool on head_dim)
DH_CARD = ("seq", 47, 9)


def _serving_kw(name):
    """`run_cases`' engine length, long case and page size for config
    `name` (or "dh": DH_CARD's)."""
    if name == "dh":
        return dict(max_len=DH_CARD[1], long=True, page_size=DH_CARD[2])
    seq = name in SEQ_CONFIGS
    return dict(max_len=SEQ_MAX_LEN if seq else S.MAX_LEN, long=seq)


def run_config(mesh, name, payload, async_cancel=False, cases=True):
    """The serving cases (unless `cases` is False) and, on a mesh, the
    model case of config `name`: those of SEQ_CONFIGS at SEQ_MAX_LEN
    with the long case, and their model case at SEQ_LEN."""
    params_np, tok, bundles, toks = payload
    cfg = config(name)
    out = {}
    if cases:
        out["cases"] = S.run_cases(
            mesh, V, params_np, tok, bundles, async_cancel=async_cancel,
            cfg=cfg, trunk_shard=True, **_serving_kw(name))
    if mesh is not None:
        out["model"] = model_case(mesh, cfg, params_np, toks,
                                  SEQ_LEN if name in SEQ_CONFIGS else
                                  S.MAX_LEN)
    return out


def world(rank, n, payload, checkpoint):
    """One gloo rank of a spawned world (n ranks): every config, then
    `launcher_world`'s cases."""
    mesh = make_serving_mesh(n, device="cpu")
    out = {name: run_config(mesh, name, payload[name],
                            async_cancel=n == ASYNC_WORLD)
           for name in CONFIGS}
    out["launcher"] = launcher_world(rank, mesh, checkpoint)
    return out


def seq_world(rank, n, payload):
    """One gloo rank of a spawned world of n ranks: `run_config` of the
    dense sequence-split config, the MoE's model case."""
    mesh = make_serving_mesh(n, device="cpu")
    return {"seq": run_config(mesh, "seq", payload["seq"],
                              async_cancel=n == ASYNC_WORLD),
            "seq_moe": run_config(mesh, "seq_moe", payload["seq_moe"],
                                  cases=False)}


def random_biases(params_np, seed=5):
    """The QKV bias leaves set to N(0, 0.5) draws (the reference inits
    them to zeros, which would hide a wrong column cut), in place."""
    rng = np.random.default_rng(seed)
    for group in params_np["groups"]:
        for layer in group:
            attn = layer.get("attn", {})
            for b in ("bq", "bk", "bv"):
                if b in attn:
                    attn[b] = rng.normal(scale=0.5, size=attn[b].shape) \
                        .astype(attn[b].dtype)
    return params_np


def launcher_world(rank, mesh, checkpoint):
    """`launch.serve.build_engine` under trunk_shard over `mesh` (None:
    one device): the seeded random weights drawn as blocks, and a
    checkpoint cut from host memory -> {"seeded", "checkpoint": greedy
    tokens}."""
    from repro_torch.launch.serve import build_engine
    out = {}
    for what, kw in (("seeded", {}), ("checkpoint",
                                      {"checkpoint": checkpoint})):
        eng, _, _ = build_engine(grammars=("json",), device="cpu",
                                 mesh=mesh, trunk_shard=True, num_layers=2,
                                 max_len=S.MAX_LEN, **kw)
        assert (eng._trunk is not None) == (mesh is not None and
                                            mesh.size > 1)
        reqs = [S._req(i, "json", b"", 10) for i in range(2)]
        out[what] = S.tokens(eng.generate(reqs)[0])
    return out


def card_payload(name):
    """(the port's own seeded weights as numpy leaves, QKV biases drawn
    at random; tokenizer; bundles of the six builtin grammars): the card
    test's inputs, built without JAX."""
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.mask_store import build_mask_store
    params = build_model(config(name), device="cpu").init(
        torch.Generator().manual_seed(0))
    tok = ByteTokenizer(V)
    bundles = {}
    for g in S.GRAMMARS:
        gr, tab = load_grammar(g)
        bundles[g] = (gr, tab, build_mask_store(gr, tok))
    return random_biases(bridge.to_numpy(params)), tok, bundles


CARD_CONFIGS = (*CONFIGS, "seq", "dh")


def card_world(rank, n, device="cuda"):
    """Every serving case of CARD_CONFIGS on the card (`device`; "dh":
    the "seq" widths at DH_CARD's lengths): one device (n None, in the
    calling process) or rank `rank` of an n-rank gloo world under
    trunk_shard -> {config: {case: tokens}}."""
    mesh = None if n is None else make_serving_mesh(n, backend="gloo",
                                                    device=device)
    out = {}
    for name in CARD_CONFIGS:
        widths = DH_CARD[0] if name == "dh" else name
        res = S.run_cases(mesh, V, *card_payload(widths),
                          cfg=config(widths), device=device,
                          trunk_shard=True, **_serving_kw(name))
        out[name] = {k: v for k, v in res.items()
                     if k not in ("stores", "mesh_devices")}
    return out
