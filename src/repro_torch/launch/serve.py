"""Serving launcher for the PyTorch port: grammar-constrained generation
with the continuous-batching Engine.

Usage (on the card; `--device cpu` runs the same path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --grammar json -n 8 --slots 8 [--max-new 80] [--temperature 0.8] \
      [--greedy] [--grammar-mode grammar_mask|grammar_strict] \
      [--paged [--page-size 16] [--num-pages N]] [--opportunistic] \
      [--speculative [--draft-k 4] [--max-jump 16] [--proposer sam|ngram]
       [--literal-jump]] [--sequential] [--no-overlap] [--devtime] \
      [--mesh N [--trunk-shard]]

  --serve [--host 127.0.0.1] [--port 8400] starts the streaming HTTP
  endpoint (serving/server.py) over one persistent AsyncEngine instead
  of a batch run, e.g.
    curl -N localhost:8400/generate \
        -d '{"prompt": "Q:", "grammar": "json", "max_new_tokens": 32}'

`--arch` takes every config of `repro_torch.configs`: the dense
smollm-360m and syncode-demo, the MoE qwen3-moe-30b-a3b (all 48 layers,
61 GB in bf16), the SSM mamba2-370m and the hybrid recurrentgemma-9b.
The recurrent archs (mamba2, recurrentgemma) prefill at exact length and
refuse `--paged` and `--speculative`, as the reference does.

`--mesh N` serves tensor-parallel over N ranks (vocab parallelism,
token for token the single-device engine's where the split lm_head
product is bitwise the whole one, as `serving/engine.py` states): N
processes on N devices (`launch/mesh.py::spawn`), NCCL on the card and
gloo with `--device cpu`; N = 1 runs in this process. Every rank serves
the same requests; rank 0 prints the summary and, with `--serve`, runs
the HTTP front end while the others follow its step loop.
`--trunk-shard` (with `--mesh N`) also splits the trunk, the KV caches
and the page pools (Megatron column/row blocks, kv heads, experts): each
rank draws only its blocks. It takes the dense and MoE configs: by kv
heads where N divides them (syncode-demo, qwen1.5-0.5b, internlm2-1.8b,
deepseek-coder-33b, qwen3-moe-30b-a3b and kimi-k2-1t-a32b at N = 2 and
4); else each cache by the reference's next branch for its own length
(`build_engine`'s max_len, 512 here, or the attention ring,
min(max_len, local_window), for recurrentgemma; paged, `--page-size`):
its positions or each page's offsets where N divides that length
(smollm-360m's 5 kv heads at N = 2 and 4; syncode-demo's and
qwen3-moe's 4 at N = 8), else its block of head_dim where N divides that
(smollm-360m at N = 2 and an odd length), else the whole cache on every
rank (N = 3). It takes the ssm and hybrid configs too (mamba2-370m,
recurrentgemma-9b: w_in columns, conv channels, SSD heads, the RG-LRU
width, with the gathers `models/ssm.py` and `models/rglru.py` name),
dense and `--sequential`. It refuses the vlm and audio families with a
ValueError.

Weights are random, drawn from `--seed` by a torch.Generator on the
device, or loaded with `--checkpoint` from a msgpack checkpoint that
either package's trainer wrote (`python -m repro_torch.launch.train
... --checkpoint PATH`, or the reference's). The summary line matches
the JAX launcher's, ending in "valid among complete: k/k".
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from ..bridge import shard_params, to_device
from ..configs import get_config
from ..core.decoding import DecodeConfig
from ..core.grammars import BUILTIN, load_grammar
from ..core.mask_store import build_mask_store
from ..core.parser import IncrementalParser
from ..core.tokenizer import ByteTokenizer
from ..device import resolve_device
from ..distributed.sharding import (map_with_path, serving_trunk_plan,
                                    trunk_slice, vocab_shard)
from ..models.model import build_model
from ..serving.engine import Engine, Request
from ..spec import SpecConfig
from .mesh import make_serving_mesh, spawn


def build_engine(arch="syncode-demo", grammars=BUILTIN, max_len=512,
                 seed=0, opportunistic=False, slots=4, paged=False,
                 page_size=16, num_pages=None, prefill_chunk=32, overlap=True,
                 grammar_mode="grammar_mask", telemetry=True, devtime=False,
                 noise_fn=None, device="cuda", params=None, num_layers=None,
                 checkpoint=None, mesh=None, trunk_shard=False):
    """-> (engine, bundles, tokenizer). `params` (a port param tree on
    `device`) replaces the seeded random init, e.g. bridged reference
    weights in the parity tests; `checkpoint` (a msgpack file of either
    package) then replaces every leaf, as the reference's flag does.
    `num_layers` keeps the config's first layers and every width
    (chip_smoke.py serves qwen3-moe at 4 of 48 to bound its run time).
    `mesh`: None, an int (the model-parallel degree over this process
    group's ranks, `make_serving_mesh`; 1 needs no group) or a
    `ServingMesh`; the engine then runs on the mesh's device, and each
    rank keeps its vocab block of the same seeded weights. With
    `trunk_shard` over more than one rank, each rank draws only its
    blocks of those weights, leaf by leaf on the device
    (`Model.init(gen, cut=...)`), or cuts them from a checkpoint read
    into host memory: the whole tree is never on the card. The other
    keywords are the Engine's."""
    if isinstance(mesh, int):
        mesh = make_serving_mesh(mesh, device=device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg = get_config(arch)
    if num_layers:
        cfg = replace(cfg, num_layers=num_layers)
    cut = None
    if trunk_shard and mesh is not None and serving_trunk_plan(
            cfg, mesh.shape["model"], mesh.rank, max_len,
            page_size if paged else None).split:
        vs = vocab_shard(cfg.vocab_size, mesh.shape["model"], mesh.rank)
        cut = lambda p, shape: trunk_slice(p, shape, mesh, mesh.rank, vs)
    tok = ByteTokenizer(cfg.vocab_size)
    bundles = {}
    for name in grammars:
        g, tab = load_grammar(name)
        bundles[name] = (g, tab, build_mask_store(g, tok))
    model = build_model(cfg, device=dev)
    if checkpoint and cut is not None:
        from ..training.checkpoint import load_checkpoint
        like = map_with_path(lambda _, t: torch.zeros(
            (), dtype=t.dtype).expand(t.shape), model.abstract_params())
        whole, step, _ = load_checkpoint(checkpoint, like)
        params = to_device(shard_params(whole, cut), dev)
        del whole
        print(f"loaded checkpoint at step {step}")
    else:
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = model.init(gen, cut=cut)
        if checkpoint:
            from ..training.checkpoint import load_checkpoint
            params, step, _ = load_checkpoint(checkpoint, params)
            print(f"loaded checkpoint at step {step}")
    return Engine(model, params, tok, bundles, max_len=max_len,
                  opportunistic=opportunistic, slots=slots, paged=paged,
                  page_size=page_size, num_pages=num_pages,
                  prefill_chunk=prefill_chunk,
                  overlap=overlap, grammar_mode=grammar_mode,
                  telemetry=telemetry, devtime=devtime, noise_fn=noise_fn,
                  device=dev, mesh=mesh, trunk_shard=trunk_shard), \
        bundles, tok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="syncode-demo")
    ap.add_argument("--grammar", default="json", choices=list(BUILTIN))
    ap.add_argument("--grammar-mode", default="grammar_mask",
                    choices=("grammar_mask", "grammar_strict"))
    ap.add_argument("-n", "--num-requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=80)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--opportunistic", action="store_true",
                    help="opportunistic masking: check the unconstrained "
                         "proposal first, mask only on a miss")
    ap.add_argument("--checkpoint", default=None,
                    help="msgpack checkpoint to serve (either package's)")
    ap.add_argument("--prompt", default="Q: produce output. A:")
    ap.add_argument("-B", "--slots", type=int, default=4,
                    help="continuous-batching decode pool width")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: page-table attention, prefix "
                         "sharing, chunked prefill")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool pages (default: the dense KV budget)")
    ap.add_argument("--sequential", action="store_true",
                    help="round-robin baseline (one request per call)")
    ap.add_argument("--speculative", action="store_true",
                    help="grammar-aware speculative decoding "
                         "(jump-forward + draft-verify)")
    ap.add_argument("--literal-jump", action="store_true",
                    help="jump grammar-forced byte literals, canonically "
                         "re-tokenized (longer jumps)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per slot per speculative step")
    ap.add_argument("--max-jump", type=int, default=16,
                    help="max forced tokens committed per jump")
    ap.add_argument("--proposer", default="sam", choices=("sam", "ngram"),
                    help="draft proposer (suffix automaton | n-gram)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--serve", action="store_true",
                    help="start the persistent streaming HTTP endpoint "
                         "(POST /generate NDJSON stream, GET /healthz) "
                         "instead of a batch run")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable host/device overlap in the decode loop")
    ap.add_argument("--no-telemetry", action="store_true")
    ap.add_argument("--devtime", action="store_true",
                    help="bench/profile mode: device spans synchronize so "
                         "stats carry device intervals (adds syncs)")
    ap.add_argument("--mesh", type=int, default=None,
                    help="tensor-parallel serving over N ranks on N "
                         "devices: embed/lm_head, logits, the packed mask "
                         "store and the mask path split by vocab, token "
                         "for token the single-device engine's")
    ap.add_argument("--trunk-shard", action="store_true",
                    help="with --mesh N: also split the trunk, KV caches "
                         "and page pools (Megatron column/row blocks with "
                         "all-reduces, kv heads, experts; where N does not "
                         "divide the kv heads, the caches' positions and "
                         "each page's offsets, N dividing --page-size; "
                         "the ssm's and RG-LRU's channel blocks); dense, "
                         "MoE, ssm and hybrid configs, others raise")
    args = ap.parse_args(argv)
    if args.mesh is None:
        _serve(None, args)
    else:
        spawn(args.mesh, _serve, args, device=args.device)


def _serve(rank, args):
    """One rank's run (rank None: no mesh). Rank 0, or the single
    process, prints; with --serve the other ranks follow its loop."""
    lead = not rank
    engine, bundles, tok = build_engine(
        args.arch, grammars=(args.grammar,),
        opportunistic=args.opportunistic, slots=args.slots,
        seed=args.seed, paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, overlap=not args.no_overlap,
        grammar_mode=args.grammar_mode, telemetry=not args.no_telemetry,
        devtime=args.devtime, device=args.device,
        checkpoint=args.checkpoint,
        mesh=None if rank is None else args.mesh,
        trunk_shard=args.trunk_shard)

    spec = None
    if args.speculative:
        spec = SpecConfig(literal_jump=args.literal_jump,
                          draft_k=args.draft_k, max_jump=args.max_jump,
                          proposer=args.proposer)
    if args.serve:
        import asyncio

        from ..serving.async_engine import AsyncEngine, run_follower
        from ..serving.server import run_server
        if not lead:
            run_follower(engine, spec=spec, speculative=args.speculative)
            return
        aeng = AsyncEngine(engine, spec=spec, speculative=args.speculative,
                           verbose=True)
        try:
            asyncio.run(run_server(aeng, host=args.host, port=args.port))
        except KeyboardInterrupt:
            pass
        return

    dc = DecodeConfig(method="greedy" if args.greedy else "sample",
                      temperature=args.temperature)
    reqs = [Request(rid=i, prompt=args.prompt.encode(),
                    grammar=args.grammar, max_new_tokens=args.max_new,
                    decode=dc, seed=i) for i in range(args.num_requests)]
    if args.speculative:
        states, stats = engine.generate_speculative(reqs, spec=spec,
                                                    verbose=lead)
    else:
        run = (engine.generate_sequential if args.sequential
               else engine.generate)
        states, stats = run(reqs, verbose=lead)
    if not lead:
        return

    g, tab, _ = bundles[args.grammar]
    p = IncrementalParser(g, tab)
    complete = [s for s in states if s.finish_reason == "eos"]
    valid = sum(p.recognize(s.generated) for s in complete)
    print(f"\n{stats.tokens} tokens @ {stats.tokens_per_sec:.1f} tok/s "
          f"({stats.decode_steps} decode steps x {stats.batch_slots} slots)"
          f" | mask {stats.mask_time:.2f}s/{stats.mask_computations} | "
          f"opportunistic hits {stats.opportunistic_hits}")
    if stats.mesh_devices > 1:
        print(f"tensor-parallel: {stats.mesh_devices}-device mesh "
              f"(vocab-sharded mask path"
              f"{'; trunk, caches and pools sharded' if engine._trunk else ''}"
              f")")
    if args.speculative:
        print(f"speculation: jump {stats.jump_tokens} tokens "
              f"({stats.jump_fraction:.0%} of output), drafts "
              f"{stats.draft_accepted}/{stats.draft_proposed} accepted "
              f"({stats.acceptance_rate:.0%}), plan {stats.plan_time:.2f}s")
    if args.paged:
        print(f"kv paging: {stats.kv_pages_in_use} pages in use, peak "
              f"util {stats.kv_peak_utilization:.0%}, prefix hit rate "
              f"{stats.prefix_hit_rate:.0%}, {stats.kv_evictions} "
              f"evictions, {stats.kv_cow_copies} COW copies")
    print(f"complete: {len(complete)}/{len(states)}, "
          f"valid among complete: {valid}/{len(complete)}")


if __name__ == "__main__":
    main()
