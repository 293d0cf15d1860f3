"""How far a data-parallel train step strays from the one-device step in
bf16, measured on the CPU (gloo ranks): the bound `chip_smoke.py` phase
15 holds each step's loss and gnorm to (`DP_BF16_REL`).

    PYTHONPATH=src python scripts/train_shard_tolerance.py [--json out.json]
        [--depths 2,4] [--seq 128] [--device cpu|cuda]

Each case draws seeded bf16 weights (`Model.init`, a torch.Generator
seeded 0 on the device, as phase 15 draws them), takes the first 3
global batches of phase 15's json pipeline (B 8 x S; S cut to `--seq`
on the CPU) with phase 15's planted loss_mask (row r masks its first
(5 r + 1) S / 128 positions, so the ranks' and the microbatches' counts
differ), and trains 3 AdamW steps (phase 9's lr 1e-3, warmup 10)
through `train()` on one device and through `train(..., mesh=)` on a
(data 2, model 1) world of gloo ranks, as phase 15 does: plain DP +
ZeRO-1, FSDP forced, microbatch 2 (against the one-device step at
microbatch 2, the plain accumulation of `make_train_step(..., None,
2)`). It prints the largest relative difference over the steps of the
loss and of gnorm (and of lb and z where the config has MoE layers).
smollm-360m runs at full width and `--depths` layers; the MoE fault at
the reduced qwen3-moe-30b-a3b (the only MoE config the CPU trains in
seconds). `--device cuda --depths 32 --seq 1024` reads phase 15's own
configuration on a card (the two ranks share it over gloo).

The faults run on the same planted batches and replace one function
of the port in the ranks' processes (the one-device side stays sound):
`mean-of-means` averages the ranks' own CEs; `local-fractions` forms
the MoE router's fractions from each rank's own rows; `local-norm`
clips by the norm of the rank's own gradient blocks; `summed-replicated`
sums the ranks' gradients where every rank ran the same rows (B 3 over
data 2: `batch_specs` replicates the batch). Each line says whether the
bound catches the case: a sound case must not be caught, a faulty one
should be.
"""
import argparse
import json
import os
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

BOUND = 5e-3        # chip_smoke.DP_BF16_REL
STEPS, B = 3, 8
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=20)
# (label, microbatch, FSDP forced)
SPLITS = (("dp", 1, False), ("fsdp", 1, True), ("mb2", 2, False))


def planted_mask(mask):
    """Phase 15's planted loss_mask (chip_smoke.dp_batches): row r of
    [rows, S] masks its first (5 r + 1) S / 128 positions."""
    mask = mask.copy()
    S = mask.shape[1]
    for r in range(mask.shape[0]):
        mask[r, :(5 * r + 1) * S // 128] = 0.0
    return mask


def batches(vocab, S, rows=B):
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.training.data import GrammarDataPipeline
    g, _ = load_grammar("json")
    it = iter(GrammarDataPipeline(g, ByteTokenizer(vocab), S, B, seed=0))
    out = []
    for _ in range(STEPS):
        b = {k: v[:rows] for k, v in next(it).items()}
        b["loss_mask"] = planted_mask(b["loss_mask"])
        out.append(b)
    return out


def config(arch, depth):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "qwen3-moe-30b-a3b":
        return cfg.reduced(dtype="bfloat16")
    return replace(cfg, num_layers=depth)


def run(arch, depth, data, device, mesh=None, mb=1, fsdp=None):
    """3 steps through `train()` -> {"loss", "gnorm", "lb", "z"}: each a
    list over the steps."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    model = build_model(config(arch, depth), device=device)
    dev = model.device
    init = [model.init(torch.Generator(device=dev).manual_seed(0))]
    _, res = train(model, init.pop(), iter(data), STEPS,
                   opt_cfg=AdamWConfig(**OPT), log_every=1, verbose=False,
                   device=device, mesh=mesh, microbatch=mb, fsdp=fsdp)
    out = {k: [m[k] for m in res.metrics]
           for k in ("loss", "gnorm", "lb", "z")}
    del model, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ------------------------------- planted faults -------------------------------

def _mean_of_means(tot, cnt, mesh):
    from repro_torch.distributed import api
    local = tot / torch.clamp(cnt, min=1.0)
    g = api.data_all_reduce(local.detach()[None].clone(), mesh)
    return api.global_share(local, g[0]) / mesh.size


def _local_fractions(probs, counts, logits, k, mesh):
    from repro_torch.distributed import api
    E = probs.shape[-1]
    lb = E * torch.sum(probs.mean(dim=(0, 1)) * counts.sum(0).float()
                       / (probs.shape[0] * probs.shape[1] * k))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    g = api.data_all_reduce(torch.stack([lb.detach(), z.detach()]), mesh)
    return (api.global_share(lb, g[0]) / mesh.size,
            api.global_share(z, g[1]) / mesh.size)


def _local_norm(blocks, plan, mesh):
    return sum(torch.sum(torch.square(b)) for b in blocks)


def plant(fault):
    """Replace the fault's function in this process -> a function that
    puts the sound one back."""
    from repro_torch.models import model, moe
    from repro_torch.training import optimizer
    orig = optimizer.moment_grads
    mod, name, new = {
        "mean-of-means": (model, "global_ce", _mean_of_means),
        "local-fractions": (moe, "global_aux", _local_fractions),
        "local-norm": (optimizer, "_norm_sq", _local_norm),
        "summed-replicated": (optimizer, "moment_grads",
                              lambda g, p, m, replicated=False:
                              orig(g, p, m, False)),
    }[fault]
    sound = getattr(mod, name)
    setattr(mod, name, new)
    return lambda: setattr(mod, name, sound)


def rank_main(rank, n, jobs, device):
    """Every job of the world in turn -> {job key: `run`'s figures}."""
    from repro_torch.launch.mesh import make_train_mesh
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // n))
    mesh = make_train_mesh(n, device=device)
    out = {}
    for key, arch, depth, data, mb, fsdp, fault in jobs:
        restore = plant(fault) if fault else (lambda: None)
        try:
            out[key] = run(arch, depth, data, device, mesh, mb, fsdp)
        finally:
            restore()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--depths", default="2,4")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    S, dev = args.seq, args.device
    arch = "smollm-360m"
    V = get_config(arch).vocab_size
    jobs, twins = [], {}
    data = batches(V, S)
    for depth in map(int, args.depths.split(",")):
        for mb in (1, 2):
            twins[(arch, depth, mb)] = run(arch, depth, data, dev, mb=mb)
        for label, mb, fsdp in SPLITS:
            jobs.append(((arch, depth, label, None), arch, depth, data, mb,
                         fsdp, None))
    d0 = int(args.depths.split(",")[0])
    for fault in ("mean-of-means", "local-norm"):
        jobs.append(((arch, d0, "dp", fault), arch, d0, data, 1, False,
                     fault))
    rep = batches(V, S, rows=3)
    twins[(arch, d0, "B3")] = run(arch, d0, rep, dev)
    jobs.append(((arch, d0, "B3", None), arch, d0, rep, 1, False, None))
    jobs.append(((arch, d0, "B3", "summed-replicated"), arch, d0, rep, 1,
                 False, "summed-replicated"))
    moe = "qwen3-moe-30b-a3b"
    mdata = batches(config(moe, 0).vocab_size, S)
    twins[(moe, 0, 1)] = run(moe, 0, mdata, dev)
    for fault in (None, "local-fractions"):
        jobs.append(((moe, 0, "dp", fault), moe, 0, mdata, 1, False, fault))
    got = spawn(2, rank_main, 2, jobs, dev, backend="gloo", device=dev)[0]
    rows = []
    for key, figs in got.items():
        a, depth, label, fault = key
        twin = twins[(a, depth, label)] if label == "B3" else \
            twins[(a, depth, 2 if label == "mb2" else 1)]
        # loss and gnorm; a MoE config's lb and z too
        keys = [k for k in ("loss", "gnorm", "lb", "z") if any(twin[k])]
        worst = max(abs(x - y) / abs(y) for k in keys
                    for x, y in zip(figs[k], twin[k]))
        caught = worst > BOUND
        rows.append(dict(arch=a, depth=depth, seq=S, device=dev,
                         batch="json, B 3 (replicated)" if label == "B3"
                         else "json, planted mask", split=label,
                         fault=fault, worst_rel=worst, caught=caught,
                         port=figs, twin=twin))
        ok = caught == (fault is not None)
        print(f"{a} depth {depth} S {S} {rows[-1]['batch']} {label} fault "
              f"{fault}: worst relative difference {worst:.3e} "
              f"({', '.join(keys)} over {STEPS} steps; bound {BOUND}) -> "
              f"{'caught' if caught else 'within'}"
              f"{'' if ok else '  <-- NOT AS IT SHOULD BE'}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
