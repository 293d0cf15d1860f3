"""The cases of tests/test_torch_recurrent_shard.py, run by the unsharded
port (in the test process) and by every rank of a trunk-sharded one (gloo
ranks through `repro_torch.launch.mesh.spawn`). Imports nothing of JAX,
so the spawned ranks start quickly: the test hands them the reference's
weights as numpy leaves. Imported by its bare name, as
`tests/_torch_trunk_cases.py` is.

Two narrow fp32 configs of the recurrent families:
  * ssm (mamba2-370m's layer kind): d_model 48, d_inner 96, 6 heads of
    16, state 16, chunk 32. w_in is 2 x 96 + 2 x 16 + 6 = 230 wide: at
    M = 2 rank 0's 115 columns hold z and the first 19 raw xBC channels,
    and the conv's 64-channel blocks leave B and C on rank 1 alone; at
    M = 4 w_in and the 6 heads stay whole while the conv channels and
    w_out's rows split;
  * hybrid (recurrentgemma-9b's): five layers, a (rec, rec, attn) group
    and a (rec, rec) tail, d_model 64, 4 heads over 1 kv head of 32 (the
    sequence split at every M > 1), local window 16 under a max_len of
    96, so that the ring wraps, R 90 (split at M = 2, whole at M = 4,
    beside a split d_ff of 128).

The reference inits the recurrent kinds' vectors (conv_b, norm_w, A_log,
D, dt_bias, b_a, b_i, lam) to constants, which would hide a wrong cut of
them: `random_vectors` draws them.

`world(rank, n, payload)` -> {config: {"model": model_case(...), "cases":
run_cases(...), "launcher": launcher_case(...)}}.
"""
from dataclasses import replace

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.distributed.api import (collective_tally,
                                         reset_collective_tally)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
import _torch_sharded_cases as S
import _torch_trunk_cases as C

torch.set_num_threads(1)

V = C.V
B = 4                   # the model case's rows
MAX_LEN = S.MAX_LEN     # every engine's (96)
SSM = dict(num_layers=2, d_model=48, ssm_state=16, ssm_expand=2,
           ssm_head_dim=16, ssm_chunk=32, vocab_size=V)
HYBRID = dict(num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
              head_dim=32, d_ff=128, lru_width=90, local_window=16,
              vocab_size=V)
CONFIGS = {"ssm": ("mamba2-370m", SSM),
           "hybrid": ("recurrentgemma-9b", HYBRID)}
# the model case's prompt length: two SSD chunks of 32 (the inter-chunk
# recurrence), and past the hybrid's 16-position ring
PROMPT = {"ssm": 64, "hybrid": 26}


def config(name, get=get_config):
    """The fp32 config `name` of CONFIGS from `get` (the port's registry,
    or the reference's)."""
    arch, over = CONFIGS[name]
    return replace(get(arch), dtype="float32", **over)


# (mean, scale) of each vector's draws
VECTORS = {"conv_b": (0.0, 0.5), "norm_w": (1.0, 0.3), "A_log": (0.0, 0.5),
           "D": (1.0, 0.5), "dt_bias": (0.0, 0.5), "b_a": (0.0, 0.5),
           "b_i": (0.0, 0.5), "lam": (0.7, 0.3)}


def random_vectors(params_np, seed=6):
    """The ssm and rec layers' vectors of VECTORS set to normal draws,
    in place."""
    rng = np.random.default_rng(seed)
    for group in params_np["groups"]:
        for layer in group:
            for kind in ("ssm", "rec"):
                for name, (mean, scale) in VECTORS.items():
                    leaf = layer.get(kind, {}).get(name)
                    if leaf is not None:
                        layer[kind][name] = rng.normal(
                            mean, scale, size=leaf.shape).astype(leaf.dtype)
    return params_np


def model_case(mesh, cfg, params_np, toks):
    """Prefill B x P tokens (toks [B, P + 1]) and one decode step at
    position P through a trunk-sharded engine's own device calls -> the
    gathered logits of both, the decode step's collective tally, the
    rank's params (numpy), the shapes of the prefill's caches and of a
    fresh decode cache tree, and the bytes the rank holds (params + the
    decode caches of its slots)."""
    P = toks.shape[1] - 1
    eng = Engine(build_model(cfg, device="cpu"), bridge.to_torch(params_np),
                 ByteTokenizer(V), {}, max_len=MAX_LEN, slots=B,
                 device="cpu", mesh=mesh, trunk_shard=True)
    logits, caches = eng._prefill(torch.from_numpy(toks[:, :P]), P)
    reset_collective_tally()
    step = eng._decode(caches, torch.from_numpy(toks[:, P]),
                       torch.full((B,), P, dtype=torch.int32))
    tally = collective_tally()
    dense = eng._decode_caches(B)
    return {"prefill": eng._gather(logits).numpy(),
            "decode": eng._gather(step).numpy(), "tally": tally,
            "params": bridge.to_numpy(eng.params),
            "prefill_caches": C._shapes(caches), "caches": C._shapes(dense),
            "resident": C._bytes(eng.params) + C._bytes(dense)}


def run_cases(mesh, name, payload, device="cpu", cfg=None):
    """The paths these families serve, on one engine: greedy and sampled
    `generate()` over the six builtin grammars, a long unconstrained run
    (the hybrid's ring wraps three times) and `generate_sequential` ->
    {case: {rid: (token ids, finish reason)}}. `mesh` None is the
    unsharded port on `device`; `cfg` replaces config `name`."""
    params_np, tok, bundles = payload[:3]
    dev = mesh.device if mesh is not None else torch.device(device)
    eng = Engine(build_model(cfg or config(name), device=dev),
                 bridge.to_torch(params_np, dev), tok, bundles,
                 max_len=MAX_LEN, slots=4, device=dev, mesh=mesh,
                 trunk_shard=True)
    return {"greedy": S.tokens(eng.generate(S.greedy_requests())[0]),
            "sampled": S.tokens(eng.generate(S.sampled_requests())[0]),
            "long": S.tokens(eng.generate(S.long_requests())[0]),
            "sequential": S.tokens(eng.generate_sequential(
                S.sequential_requests())[0])}


def launcher_case(mesh, name):
    """`launch.serve.build_engine(arch, mesh=..., trunk_shard=True)` with
    the narrow config in place of the registry's (each rank draws only
    its blocks of the seeded weights) -> greedy tokens of two json
    requests through `generate()` and `generate_sequential`."""
    from repro_torch.launch import serve
    arch = CONFIGS[name][0]
    orig = serve.get_config
    serve.get_config = lambda a: config(name) if a == arch else orig(a)
    try:
        eng, _, _ = serve.build_engine(arch, grammars=("json",),
                                       device="cpu", mesh=mesh,
                                       trunk_shard=True, max_len=MAX_LEN)
    finally:
        serve.get_config = orig
    assert (eng._trunk is not None) == (mesh is not None and mesh.size > 1)
    reqs = lambda: [S._req(i, "json", b"", 10) for i in range(2)]
    return {"dense": S.tokens(eng.generate(reqs())[0]),
            "sequential": S.tokens(eng.generate_sequential(reqs())[0])}


def world(rank, n, payload):
    """One gloo rank of a spawned world of n ranks (n 1: this process,
    no group): every case of both configs."""
    mesh = make_serving_mesh(n, device="cpu")
    out = {}
    for name in CONFIGS:
        params_np, _, _, toks = payload[name]
        out[name] = {"model": model_case(mesh, config(name), params_np,
                                         toks),
                     "cases": run_cases(mesh, name, payload[name]),
                     "launcher": launcher_case(mesh, name)}
    return out


def card_world(rank, n, device="cuda"):
    """Every serving case of both configs on the card (`device`), on the
    port's own seeded weights: one device (n None, in the calling
    process) or rank `rank` of an n-rank gloo world under trunk_shard ->
    {config: {case: tokens}}."""
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.mask_store import build_mask_store
    mesh = None if n is None else make_serving_mesh(n, backend="gloo",
                                                    device=device)
    tok = ByteTokenizer(V)
    bundles = {}
    for g in S.GRAMMARS:
        gr, tab = load_grammar(g)
        bundles[g] = (gr, tab, build_mask_store(gr, tok))
    out = {}
    for name in CONFIGS:
        params = build_model(config(name), device="cpu").init(
            torch.Generator().manual_seed(0))
        out[name] = run_cases(mesh, name, (random_vectors(
            bridge.to_numpy(params)), tok, bundles), device=device)
    return out
