"""Serving launcher for the PyTorch port: grammar-constrained generation
with the dense continuous-batching Engine.

Usage (on the card; `--device cpu` runs the same path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --grammar json -n 8 --slots 8 [--max-new 80] [--temperature 0.8] \
      [--greedy] [--grammar-mode grammar_mask|grammar_strict] \
      [--no-overlap] [--devtime]

Weights are random, drawn from `--seed` by a torch.Generator on the
device: the repository ships no checkpoint. The summary line matches the
JAX launcher's, ending in "valid among complete: k/k".
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config
from ..core.decoding import DecodeConfig
from ..core.grammars import BUILTIN, load_grammar
from ..core.mask_store import build_mask_store
from ..core.parser import IncrementalParser
from ..core.tokenizer import ByteTokenizer
from ..device import resolve_device
from ..models.model import build_model
from ..serving.engine import Engine, Request


def build_engine(arch="syncode-demo", grammars=BUILTIN, max_len=512,
                 seed=0, slots=4, overlap=True, grammar_mode="grammar_mask",
                 telemetry=True, devtime=False, noise_fn=None,
                 device="cuda", params=None):
    """-> (engine, bundles, tokenizer). `params` (a port param tree on
    `device`) replaces the seeded random init, e.g. bridged reference
    weights in the parity tests."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    tok = ByteTokenizer(cfg.vocab_size)
    bundles = {}
    for name in grammars:
        g, tab = load_grammar(name)
        bundles[name] = (g, tab, build_mask_store(g, tok))
    model = build_model(cfg, device=dev)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen)
    return Engine(model, params, tok, bundles, max_len=max_len,
                  slots=slots, overlap=overlap, grammar_mode=grammar_mode,
                  telemetry=telemetry, devtime=devtime, noise_fn=noise_fn,
                  device=dev), bundles, tok


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
    ap.add_argument("--prompt", default="Q: produce output. A:")
    ap.add_argument("-B", "--slots", type=int, default=4,
                    help="continuous-batching decode pool width")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable host/device overlap in the decode loop")
    ap.add_argument("--no-telemetry", action="store_true")
    ap.add_argument("--devtime", action="store_true",
                    help="bench/profile mode: device spans synchronize so "
                         "stats carry device intervals (adds syncs)")
    args = ap.parse_args(argv)

    engine, bundles, tok = build_engine(
        args.arch, grammars=(args.grammar,), slots=args.slots,
        seed=args.seed, overlap=not args.no_overlap,
        grammar_mode=args.grammar_mode, telemetry=not args.no_telemetry,
        devtime=args.devtime, device=args.device)

    dc = DecodeConfig(method="greedy" if args.greedy else "sample",
                      temperature=args.temperature)
    reqs = [Request(rid=i, prompt=args.prompt.encode(),
                    grammar=args.grammar, max_new_tokens=args.max_new,
                    decode=dc, seed=i) for i in range(args.num_requests)]
    states, stats = engine.generate(reqs, verbose=True)

    g, tab, _ = bundles[args.grammar]
    p = IncrementalParser(g, tab)
    complete = [s for s in states if s.finish_reason == "eos"]
    valid = sum(p.recognize(s.generated) for s in complete)
    print(f"\n{stats.tokens} tokens @ {stats.tokens_per_sec:.1f} tok/s "
          f"({stats.decode_steps} decode steps x {stats.batch_slots} slots)"
          f" | mask {stats.mask_time:.2f}s/{stats.mask_computations}")
    print(f"complete: {len(complete)}/{len(states)}, "
          f"valid among complete: {valid}/{len(complete)}")


if __name__ == "__main__":
    main()
