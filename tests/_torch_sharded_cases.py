"""The serving cases of tests/test_torch_sharded_engine.py, run by the
unsharded port (in the test process) and by every rank of a sharded one
(gloo ranks through `repro_torch.launch.mesh.spawn`). Imports nothing of
JAX, so the spawned ranks start quickly: the test hands them the
reference's weights as numpy leaves.

`run_cases(mesh, V, params_np, tok, bundles)` -> {case: {rid: (token ids,
finish reason)}} plus each case engine's device store shape under
"stores". The cases: greedy and sampled `generate()` over all six
builtin grammars in one store, speculative greedy, paged with a shared
prefix, two grammars and an unconstrained request in a two-grammar store,
sequential, opportunistic, and (with `async_cancel`) an AsyncEngine over
dense serving with a hot grammar load and one request cancelled
mid-decode on rank 0.
"""
import asyncio
from dataclasses import replace

import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.decoding import DecodeConfig
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.serving.async_engine import AsyncEngine, run_follower
from repro_torch.serving.engine import Engine, Request
from repro_torch.spec import SpecConfig

torch.set_num_threads(1)

# the narrow syncode-demo of tests/_torch_parity.py, in fp32
NARROW = dict(num_layers=2, d_model=128, d_ff=256, num_heads=4,
              num_kv_heads=2, head_dim=32)
MAX_LEN = 96
GRAMMARS = ("json", "calc", "sql", "minilang", "jsonmsg", "python_mini")
PROMPTS = (b"x = ", b"1+", b"SELECT a", b"say:", b"{", b"def f():")
CANCEL_RID = 3          # the async case's request cancelled on rank 0
CANCEL_AFTER = 3        # ... after this many streamed tokens
HOT_GRAMMAR = "calc_hot"    # the async case's hot-loaded grammar


def config(vocab: int):
    return replace(get_config("syncode-demo"), dtype="float32",
                   vocab_size=vocab, **NARROW)


def _req(rid, grammar, prompt, n, method="greedy", temp=1.0, k=None,
         p=None):
    return Request(rid=rid, prompt=prompt, grammar=grammar,
                   max_new_tokens=n, seed=rid * 7 + 1,
                   decode=DecodeConfig(method, temp, k, p))


def greedy_requests():
    """Two greedy requests per builtin grammar and one unconstrained."""
    return [_req(2 * i + j, g, p if j == 0 else b"Q: generate. A:", 12)
            for i, (g, p) in enumerate(zip(GRAMMARS, PROMPTS))
            for j in range(2)] + [_req(12, None, b"free", 6)]


def sampled_requests():
    """Every grammar sampled, with assorted temperature, top-k, top-p."""
    return [_req(0, "json", b"", 14, "sample", 1.0, None, 0.95),
            _req(1, "calc", b"1+", 12, "sample", 0.7, 20, None),
            _req(2, "jsonmsg", b"", 14, "sample", 1.0, None, None),
            _req(3, "sql", b"SELECT", 12, "sample", 1.3, None, 1.0),
            _req(4, "minilang", b"", 12, "sample", 0.9, 40, 0.9),
            _req(5, "python_mini", b"", 12, "sample", 1.1, None, None),
            _req(6, None, b"free", 6, "sample", 1.0, None, None)]


def speculative_requests():
    return [_req(i, g, p, 12) for i, (g, p) in
            enumerate(zip(GRAMMARS[:4], PROMPTS[:4]))]


def prefix_requests():
    """Four requests whose prompts share a prefix of whole 8-token
    pages."""
    prefix = b"shared context: field_a 1; field_b 2; "
    return [_req(i, ("json", "calc")[i % 2], prefix + b"Q%d:" % i, 10,
                 ("greedy", "sample")[i % 2], 0.9, 30, 0.95)
            for i in range(4)]


def mixed_requests():
    return [_req(0, "json", b"{", 10), _req(1, "calc", b"1+", 10),
            _req(2, None, b"free", 6), _req(3, "json", b"", 10, "sample"),
            _req(4, "calc", b"", 10, "sample", 0.8, 10, 0.9)]


def sequential_requests():
    return [_req(0, "json", b"{", 8),
            _req(1, "calc", b"1+", 8, "sample", 0.9, 20, 0.9)]


def opportunistic_requests():
    return [_req(0, "json", b"", 8), _req(1, "sql", b"SELECT", 8, "sample"),
            _req(2, "calc", b"", 8, "sample", 1.0, None, 0.9)]


def long_requests():
    """Two unconstrained greedy requests that run up to a max_len of 48
    (a sequence-split cache's last rank then holds live positions)."""
    return [_req(i, None, p, 24) for i, p in
            enumerate((b"the quick brown fox jumps over", b"a b c d e f"))]


def async_requests(calc="calc"):
    """Three requests and a long one that rank 0 cancels mid-decode;
    `calc` names the grammar of request 1 (the async case hot-loads calc's
    bundle under another name)."""
    return [_req(0, "json", b"", 12), _req(1, calc, b"1+", 12, "sample"),
            _req(2, "sql", b"SELECT", 12, "sample", 0.8, 30, 0.9),
            _req(CANCEL_RID, "minilang", b"", 40, "sample")]


def tokens(states):
    return {s.req.rid: (list(s.token_ids), s.finish_reason) for s in states}


def _async_cancel(eng):
    """Rank 0 serves through an AsyncEngine: it hot-loads calc's bundle as
    HOT_GRAMMAR (the other ranks register it from rank 0's broadcast),
    serves request 1 under it, and cancels CANCEL_RID after CANCEL_AFTER
    streamed tokens; other ranks follow its loop."""
    if eng.mesh is not None and eng.mesh.rank != 0:
        states, _ = run_follower(eng, keep_states=True)
        assert HOT_GRAMMAR in eng.bundles
        return tokens(states)

    async def go():
        aeng = AsyncEngine(eng)
        await aeng.load_grammar(HOT_GRAMMAR, eng.bundles["calc"])
        handles = [aeng.submit(r) for r in async_requests(HOT_GRAMMAR)]
        try:
            seen = 0
            async for _ in handles[CANCEL_RID].tokens():
                seen += 1
                if seen == CANCEL_AFTER:
                    handles[CANCEL_RID].cancel()
            return [await h.result() for h in handles]
        finally:
            await aeng.drain()
    return tokens(asyncio.run(go()))


def run_cases(mesh, vocab, params_np, tok, grammars, async_cancel=False,
              cfg=None, device="cpu", max_len=MAX_LEN, long=False,
              page_size=8, **engine_kw):
    """Every case on one engine set-up: the reference's weights as numpy
    leaves, the port's tokenizer and {name: bundle} of the six builtin
    grammars. `mesh` None is the unsharded port. `cfg` replaces the
    narrow syncode-demo at `vocab`; `device` is the unsharded engine's
    (a mesh brings its own); `max_len` is every engine's; `long` adds the
    "long" case (`long_requests` through dense `generate()`);
    `page_size` is the paged case's; `engine_kw` go to every Engine
    (e.g. trunk_shard=True)."""
    dev = mesh.device if mesh is not None else torch.device(device)
    model = build_model(cfg or config(vocab), device=dev)
    params = bridge.to_torch(params_np, dev)

    def engine(bs=None, **kw):
        kw.setdefault("slots", 4)
        return Engine(model, params, tok, grammars if bs is None else
                      {k: grammars[k] for k in bs}, max_len=max_len,
                      device=dev, mesh=mesh, **engine_kw, **kw)

    out, stores = {}, {}
    eng = engine()
    stores["all"] = tuple(eng._store_cat.shape)
    out["greedy"] = tokens(eng.generate(greedy_requests())[0])
    out["sampled"] = tokens(eng.generate(sampled_requests())[0])
    if long:
        out["long"] = tokens(eng.generate(long_requests())[0])
    out["speculative"] = tokens(eng.generate_speculative(
        speculative_requests(), spec=SpecConfig(literal_jump=False))[0])
    out["sequential"] = tokens(eng.generate_sequential(
        sequential_requests())[0])
    paged = engine(paged=True, page_size=page_size)
    states, stats = paged.generate(prefix_requests())
    out["paged"] = tokens(states)
    out["paged_hit_rate"] = stats.prefix_hit_rate
    mixed = engine(("json", "calc"))
    stores["mixed"] = tuple(mixed._store_cat.shape)
    out["mixed"] = tokens(mixed.generate(mixed_requests())[0])
    out["opportunistic"] = tokens(engine(opportunistic=True).generate(
        opportunistic_requests())[0])
    if async_cancel:
        out["async_cancel"] = _async_cancel(engine())
    elif mesh is None:
        out["async_sync"] = tokens(engine().generate(async_requests())[0])
    out["stores"] = stores
    out["mesh_devices"] = stats.mesh_devices
    return out


def engine_rank(rank, n):
    """One rank of an n-rank gloo world: a one-layer syncode-demo engine
    over the mesh (`build_engine(mesh=n)`; its step loop's gauges and
    telemetry hold reference cycles, as every engine's do) serving two
    json requests -> their tokens."""
    from repro_torch.launch.serve import build_engine
    eng, _, _ = build_engine(grammars=("json",), device="cpu", mesh=n,
                             num_layers=1, max_len=32)
    return tokens(eng.generate([_req(i, "json", b"", 4)
                                for i in range(2)])[0])


def world(rank, sizes_vocabs, payload):
    """One gloo rank of a spawned world: the cases at each vocab with
    this world's serving mesh. -> {vocab: run_cases(...)}."""
    n, vocabs, async_at = sizes_vocabs
    mesh = make_serving_mesh(n, device="cpu")
    return {V: run_cases(mesh, V, *payload[V], async_cancel=V == async_at)
            for V in vocabs}
