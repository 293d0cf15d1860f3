"""Training launcher for the PyTorch port (the reference's
`repro.launch.train` CLI, on the card by default).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --grammar json --steps 20 --batch 8 --seq 1024 \
      [--checkpoint build/smollm.msgpack] [--num-layers N] [--device cpu]
      [--data N] [--model M]

`--data N --model M` trains on N x M ranks (`launch.mesh.spawn`; either
flag alone takes the other as 1): the reference's sharded train step on
a (data N, model M) mesh, with ZeRO-1 moments, FSDP weights where
`needs_fsdp` asks for them, and above model 1 the Megatron blocks, the
vocabulary-parallel loss and expert parallelism of the dense and MoE
families (`training/train_loop.py`). Every rank draws the whole global
batch from the same seeded pipeline and trains on its data coordinate's
rows; rank 0 prints the log lines and writes the checkpoint. The ranks
meet over NCCL when the host has a card a rank, else over gloo (NCCL
refuses two ranks on one card); with `--device cpu`, over gloo. The
backend is printed. Without either flag the launcher trains on one
device, as before.

`--arch` takes the port's configs (dense, moe, ssm, hybrid, vlm,
audio); `--reduced` trains the config's small variant, `--num-layers`
keeps the first layers at full width. whisper-base and
llama-3.2-vision-90b train on `--grammar random`, whose batches carry
the encoder's `frames` or the `image_embeds`; a grammar pipeline has
none, and the first step raises KeyError('frames') or
KeyError('image_embeds'), as the reference's does.
Weights start random from `--seed` (a torch.Generator on the device).
The checkpoint is the reference's msgpack format: both
packages' `--checkpoint` flags load it.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from ..configs import get_config
from ..core.grammars import load_grammar
from ..core.tokenizer import ByteTokenizer
from ..device import resolve_device
from .mesh import make_train_mesh, spawn
from ..models.model import build_model
from ..training.data import GrammarDataPipeline, RandomTokenPipeline
from ..training.optimizer import AdamWConfig
from ..training.train_loop import train
from ..training.tree import leaves


def main(argv=None):
    """-> (params, TrainResult); with `--data` or `--model`, (None, rank
    0's TrainResult)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="syncode-demo")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced variant")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="keep the first N layers at full width")
    ap.add_argument("--grammar", default="json",
                    help="grammar for the synthetic data pipeline, or "
                         "'random' for random tokens")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--data", type=int, default=None,
                    help="train on N data ranks (a data axis of N)")
    ap.add_argument("--model", type=int, default=None,
                    help="split the model over M ranks (a model axis of M)")
    args = ap.parse_args(argv)
    if args.data is None and args.model is None:
        return run(args)
    args.data, args.model = args.data or 1, args.model or 1
    n = args.data * args.model
    dev = resolve_device(args.device)
    backend = "gloo" if dev.type != "cuda" or \
        torch.cuda.device_count() < n else "nccl"
    what = "data-parallel" if args.model == 1 else \
        f"(data {args.data}, model {args.model})"
    print(f"{what} training on {n} ranks over {backend}")
    out = spawn(n, _rank, args, backend=backend, device=dev)
    return out[0]


def _rank(rank, args):
    """One rank of `--data N --model M`: the run on its mesh -> (None,
    its TrainResult); the trained params stay in the checkpoint."""
    return None, run(args, make_train_mesh(args.data, args.model,
                                           device=args.device))[1]


def run(args, mesh=None):
    """Build, train and report one run (on `mesh`'s rank, or alone)."""
    lead = mesh is None or mesh.lead
    dev = resolve_device(args.device) if mesh is None else mesh.device
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers:
        cfg = replace(cfg, num_layers=args.num_layers)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    init = [model.init(gen)]        # handed to train() without a reference
    n_params = sum(p.numel() for p in leaves(init[0]))
    if lead:
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
              f"vocab={cfg.vocab_size}")

    if args.grammar == "random":
        data = iter(RandomTokenPipeline(cfg, args.seq, args.batch,
                                        seed=args.seed))
    else:
        tok = ByteTokenizer(cfg.vocab_size)
        g, _ = load_grammar(args.grammar)
        data = iter(GrammarDataPipeline(g, tok, args.seq, args.batch,
                                        seed=args.seed))

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                      total_steps=args.steps)
    params, result = train(model, init.pop(), data, args.steps, opt_cfg=opt,
                           checkpoint_path=args.checkpoint, device=dev,
                           mesh=mesh)
    if lead:
        print(f"final loss {result.losses[-1]:.4f} "
              f"({result.steps_per_sec:.2f} steps/s)")
    return params, result


if __name__ == "__main__":
    main()
