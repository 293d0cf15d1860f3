"""How far a sharded train step strays from the one-device step in bf16,
measured on the CPU (gloo ranks): the bounds `chip_smoke.py` phases 15
and 16 hold each step's loss and gnorm to (`DP_BF16_REL`, `MA_BF16_REL`).

    PYTHONPATH=src python scripts/train_shard_tolerance.py [--json out.json]
        [--depths 2,4] [--seq 128] [--device cpu|cuda]
        [--axis data|model] [--model-depths 4,4]
        [--dtype bfloat16|float32]

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

`--axis model` reads phase 16's splits instead, on the same planted
batches: qwen1.5-0.5b (16/16 heads, QKV bias, untied) on a (data 2,
model 2) world of 4 gloo ranks and smollm-360m (15/5 heads: wq/wk/wv
cut inside heads and gathered; tied) on a (data 1, model 2) world, at
full width and `--model-depths` A,B layers, each against the
one-device step; and the reduced qwen3-moe-30b-a3b at (data 1, model
2). Its faults: `no-col-grad` drops the gradient all-reduce before every
split column block (the norms, the embedding and each earlier layer
learn from the rank's part); `own-vocab-ce` takes each rank's
cross-entropy over its own vocabulary columns; `norm-m-times` counts a
leaf whole on the model axis (the norms, the biases) M times in the
norm; `router-slice` (the MoE) gives the router gather a plain slice
for its backward. The first three run at qwen1.5's (2, 2) world.
`--device cuda --model-depths 24,8 --seq 1024` reads phase 16's own
configuration on a card (the ranks share it over gloo).

`--dtype float32` runs either axis in fp32 and holds it to the bound of
the fp32 copies' free-running comparison (`DP_FREE_REL`: the sharded
run against the one-device run over the 3 steps, each side free from
the same seeded weights); `--depths 2 --model-depths 2,2` are those
copies' depths.
"""
import argparse
import json
import os
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

BOUND = 5e-3        # chip_smoke.DP_BF16_REL
MODEL_BOUND = 1e-3  # chip_smoke.MA_BF16_REL (--axis model)
FREE_BOUND = 1e-4   # chip_smoke.DP_FREE_REL (--dtype float32)
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


def config(arch, depth, dtype="bfloat16"):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "qwen3-moe-30b-a3b":
        return cfg.reduced(dtype=dtype)
    return replace(cfg, num_layers=depth, dtype=dtype)


def run(arch, depth, data, device, mesh=None, mb=1, fsdp=None,
        dtype="bfloat16"):
    """3 steps through `train()` -> {"loss", "gnorm", "lb", "z"}: each a
    list over the steps."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    model = build_model(config(arch, depth, dtype), device=device)
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


def _no_col_grad(x, mesh, call="col-grad"):
    return x


def _own_vocab_ce(logits, labels, v0, mesh):
    Vb = logits.shape[-1]
    local = labels.long() - v0
    own = (local >= 0) & (local < Vb)
    gold = torch.gather(logits, -1, local.clamp(0, Vb - 1)[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - torch.where(
        own, gold, torch.zeros_like(gold))


def _norm_m_times(blocks, plan, mesh):
    from repro_torch.distributed import api
    split = [b for b, lp in zip(blocks, plan.leaves) if lp.odim is not None]
    whole = [b for b, lp in zip(blocks, plan.leaves) if lp.odim is None]
    sq = lambda bs: sum(torch.sum(torch.square(b)) for b in bs)
    part = torch.zeros((), device=blocks[0].device) + sq(split)
    part = api.data_all_reduce(part, mesh, call="gnorm") + sq(whole)
    return api.model_all_reduce(part, mesh.model_mesh, "model-gnorm")


def _router_slice(x, mesh, call="router"):
    from repro_torch.distributed import api

    class Slice(api._GatherRouter):
        @staticmethod
        def backward(ctx, partial, same):
            w, r = ctx.w, ctx.mesh.rank
            return (partial + same)[..., r * w:(r + 1) * w], None, None
    return Slice.apply(x, mesh, call)


def plant(fault):
    """Replace the fault's function in this process -> a function that
    puts the sound one back."""
    from repro_torch.models import common, model, moe
    from repro_torch.training import optimizer
    orig = optimizer.moment_grads
    mod, name, new = {
        "mean-of-means": (model, "global_ce", _mean_of_means),
        "local-fractions": (moe, "global_aux", _local_fractions),
        "local-norm": (optimizer, "_norm_sq", _local_norm),
        "summed-replicated": (optimizer, "moment_grads",
                              lambda g, p, m, replicated=False:
                              orig(g, p, m, False)),
        "no-col-grad": (common, "model_copy", _no_col_grad),
        "own-vocab-ce": (model, "vocab_parallel_nll", _own_vocab_ce),
        "norm-m-times": (optimizer, "_norm_sq", _norm_m_times),
        "router-slice": (moe, "model_gather_router", _router_slice),
    }[fault]
    sound = getattr(mod, name)
    setattr(mod, name, new)
    return lambda: setattr(mod, name, sound)


def rank_main(rank, n, jobs, device, dtype):
    """Every job of the world in turn, each on its (data, model) mesh
    (made once, in the jobs' order on every rank) -> {job key: `run`'s
    figures}."""
    from repro_torch.launch.mesh import make_train_mesh
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // n))
    meshes, out = {}, {}
    for key, arch, depth, data, mb, fsdp, fault, dm in jobs:
        if dm not in meshes:
            meshes[dm] = make_train_mesh(*dm, device=device)
        restore = plant(fault) if fault else (lambda: None)
        try:
            out[key] = run(arch, depth, data, device, meshes[dm], mb, fsdp,
                           dtype)
        finally:
            restore()
    return out


def report(got, twins, S, dev, twin_of, bound, dtype):
    """One line a job (and its row for --json): the worst relative
    difference from its twin (`twins[twin_of(key)]`) over the steps,
    caught by `bound` or within."""
    rows = []
    for key, figs in got.items():
        a, depth, label, fault = key
        twin = twins[twin_of(key)]
        # loss and gnorm; a MoE config's lb and z too
        keys = [k for k in ("loss", "gnorm", "lb", "z") if any(twin[k])]
        worst = max(abs(x - y) / abs(y) for k in keys
                    for x, y in zip(figs[k], twin[k]))
        caught = worst > bound
        rows.append(dict(arch=a, depth=depth, seq=S, device=dev,
                         dtype=dtype,
                         batch="json, B 3 (replicated)" if label == "B3"
                         else "json, planted mask", split=label,
                         fault=fault, worst_rel=worst, caught=caught,
                         port=figs, twin=twin))
        ok = caught == (fault is not None)
        print(f"{a} {dtype} depth {depth} S {S} {rows[-1]['batch']} "
              f"{label} fault "
              f"{fault}: worst relative difference {worst:.3e} "
              f"({', '.join(keys)} over {STEPS} steps; bound {bound}) -> "
              f"{'caught' if caught else 'within'}"
              f"{'' if ok else '  <-- NOT AS IT SHOULD BE'}", flush=True)
    return rows


def model_axis(args):
    """Phase 16's splits and the model axis' faults (module docstring)
    -> the rows."""
    from repro_torch.launch.mesh import spawn
    S, dev, dt = args.seq, args.device, args.dtype
    da, db = map(int, args.model_depths.split(","))
    qwen, moe = "qwen1.5-0.5b", "qwen3-moe-30b-a3b"
    twins, worlds = {}, {4: [], 2: []}
    for arch, depth, dm in ((qwen, da, (2, 2)), ("smollm-360m", db, (1, 2)),
                            (moe, 0, (1, 2))):
        data = batches(config(arch, depth).vocab_size, S)
        twins[(arch, depth)] = run(arch, depth, data, dev, dtype=dt)
        faults = ("no-col-grad", "own-vocab-ce", "norm-m-times") \
            if arch == qwen else ("router-slice",) if arch == moe else ()
        for fault in (None, *faults):
            worlds[dm[0] * dm[1]].append((
                (arch, depth, f"data {dm[0]} model {dm[1]}", fault), arch,
                depth, data, 1, False, fault, dm))
    got = {}
    for n, jobs in worlds.items():
        got.update(spawn(n, rank_main, n, jobs, dev, dt, backend="gloo",
                         device=dev)[0])
    return report(got, twins, S, dev, lambda key: key[:2],
                  MODEL_BOUND if dt == "bfloat16" else FREE_BOUND, dt)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--depths", default="2,4")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--axis", default="data", choices=("data", "model"))
    ap.add_argument("--model-depths", default="4,4",
                    help="--axis model: qwen1.5's and smollm's layers")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    if args.axis == "model":
        rows = model_axis(args)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rows, f, indent=1)
        return
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    S, dev, dt = args.seq, args.device, args.dtype
    arch = "smollm-360m"
    V = get_config(arch).vocab_size
    jobs, twins = [], {}
    data = batches(V, S)
    for depth in map(int, args.depths.split(",")):
        for mb in (1, 2):
            twins[(arch, depth, mb)] = run(arch, depth, data, dev, mb=mb,
                                           dtype=dt)
        for label, mb, fsdp in SPLITS:
            jobs.append(((arch, depth, label, None), arch, depth, data, mb,
                         fsdp, None, (2, 1)))
    d0 = int(args.depths.split(",")[0])
    for fault in ("mean-of-means", "local-norm"):
        jobs.append(((arch, d0, "dp", fault), arch, d0, data, 1, False,
                     fault, (2, 1)))
    rep = batches(V, S, rows=3)
    twins[(arch, d0, "B3")] = run(arch, d0, rep, dev, dtype=dt)
    jobs.append(((arch, d0, "B3", None), arch, d0, rep, 1, False, None,
                 (2, 1)))
    jobs.append(((arch, d0, "B3", "summed-replicated"), arch, d0, rep, 1,
                 False, "summed-replicated", (2, 1)))
    moe = "qwen3-moe-30b-a3b"
    mdata = batches(config(moe, 0).vocab_size, S)
    twins[(moe, 0, 1)] = run(moe, 0, mdata, dev, dtype=dt)
    for fault in (None, "local-fractions"):
        jobs.append(((moe, 0, "dp", fault), moe, 0, mdata, 1, False, fault,
                     (2, 1)))
    got = spawn(2, rank_main, 2, jobs, dev, dt, backend="gloo",
                device=dev)[0]
    rows = report(got, twins, S, dev, lambda key: key[:3] if key[2] == "B3"
                  else (key[0], key[1], 2 if key[2] == "mb2" else 1),
                  BOUND if dt == "bfloat16" else FREE_BOUND, dt)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
