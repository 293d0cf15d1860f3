"""The cases of tests/test_torch_train_shard.py: the port's data-parallel
train step (`make_train_step(model, opt, mesh, microbatch, fsdp)`) run
on every rank of a gloo world (`repro_torch.launch.mesh.spawn`), and the
batches and configs that the reference's sharded step gets in its own
subprocess. Imports nothing of JAX, so the spawned ranks start quickly:
the test hands them the reference's weights as numpy leaves. Imported by
its bare name, as `tests/_torch_trunk_cases.py` is.

Two narrow fp32 configs: syncode-demo (4 layers, d_model 256, vocab
2048) and the reduced qwen3-moe-30b-a3b (2 MoE layers, 4 experts top-2,
vocab 512). Each step's global batch is B 8 x S 32 with a planted
`loss_mask`: row r masks its first (5 r + 3 t) % S positions at step t,
so the mask counts differ between the ranks and between the
microbatches of every split the cases run.

`world(rank, n, payload)` -> {case: result} for the cases of a world of
n ranks, then the planted faults of that world (`FAULTS`).
"""
from dataclasses import replace

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.distributed import api
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import build_model
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import leaves

torch.set_num_threads(1)

B, S, STEPS = 8, 32, 2
CONFIGS = {"demo": ("syncode-demo", False), "moe": ("qwen3-moe-30b-a3b", True)}
# (config, data ways, microbatch, FSDP forced): each run by the
# reference's `_jit_target` train step at the same mesh shape.
# syncode-demo at every data x microbatch; the MoE split over 2 and 4
# ranks, and microbatched at data 2 under FSDP (FSDP at data 4: the
# replicated case below, against the one-device step)
CASES = tuple(("demo", d, mb, False) for d in (1, 2, 4) for mb in (1, 2)) \
    + (("moe", 2, 1, False), ("moe", 4, 2, False), ("demo", 2, 1, True),
       ("moe", 2, 2, True))
# B = 2 at data 4: `batch_specs` replicates the batch; held to the
# one-device step (data 1) at the same B and microbatch
REPLICATED = (("demo", 4, 1, False), ("moe", 4, 2, False),
              ("demo", 4, 1, True))
REPLICATED_B = 2
# planted faults: (name, config, data ways, batch rows); each is held
# to the sound numbers of the same config and mesh
FAULTS = (("mean_of_means", "demo", 2, B), ("local_fractions", "moe", 2, B),
          ("local_norm", "demo", 2, B),
          ("summed_replicated", "demo", 4, REPLICATED_B))


def config(name, get=get_config):
    """The fp32 config `name` from `get` (the port's registry, or the
    reference's)."""
    arch, reduced = CONFIGS[name]
    cfg = get(arch)
    return replace(cfg.reduced() if reduced else cfg, dtype="float32")


def batches(cfg, rows=B, steps=STEPS, seed=0):
    """The global batches of a run: numpy tokens, labels and the planted
    loss_mask."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (rows, S + 1)).astype(
            np.int32)
        mask = np.ones((rows, S), np.float32)
        for r in range(rows):
            mask[r, :(5 * r + 3 * t) % S] = 0.0
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "loss_mask": mask})
    return out


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def run(mesh, name, params_np, mb, fsdp, rows=B):
    """STEPS steps of the port's step -> {"steps": [{"loss", "ce", "lb",
    "z", "gnorm", "params", "mu", "nu"} (whole trees as numpy, rank 0
    only)], "bytes": this rank's {"params", "moments", "acc"}, "calls":
    the first step's collectives by call, "tally": by kind}."""
    cfg = config(name)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, AdamWConfig(), mesh, mb, fsdp)
    one_device = not hasattr(step, "plan")
    params = bridge.to_torch(params_np)
    if one_device:
        state = optimizer.init_opt_state(params)
    else:
        params = step.shard(params)
        state = step.init_state(params)
    out = {"steps": [], "bytes": {
        "params": _bytes(leaves(params)),
        "moments": _bytes(leaves(state["mu"]) + leaves(state["nu"]))}}
    for t, b in enumerate(batches(cfg, rows)):
        api.reset_collective_tally()
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in
                                 b.items()})
        if t == 0:
            out["calls"] = api.collective_calls()
            out["tally"] = api.collective_tally()
        whole = params if one_device else step.gather(params)
        mom = state if one_device else step.gather_moments(state)
        rec = {k: float(m[k]) for k in ("loss", "ce", "lb", "z", "gnorm")}
        if mesh is None or mesh.rank == 0:
            rec.update(params=bridge.to_numpy(whole),
                       mu=bridge.to_numpy(mom["mu"]),
                       nu=bridge.to_numpy(mom["nu"]))
        out["steps"].append(rec)
    out["bytes"]["acc"] = 0 if one_device else step.acc_bytes
    return out


# ------------------------------ planted faults ------------------------------

def _mean_of_means(tot, cnt, mesh):
    """Each rank's own CE, averaged over the ranks."""
    local = tot / torch.clamp(cnt, min=1.0)
    g = api.data_all_reduce(local.detach()[None].clone(), mesh)
    return api.global_share(local, g[0]) / mesh.size


def _local_fractions(probs, counts, logits, k, mesh):
    """Each rank's lb and z from its own rows, averaged over the ranks."""
    E = probs.shape[-1]
    me = probs.mean(dim=(0, 1))
    ce = counts.sum(0).float() / (probs.shape[0] * probs.shape[1] * k)
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    g = api.data_all_reduce(torch.stack([lb.detach(), z.detach()]), mesh)
    return (api.global_share(lb, g[0]) / mesh.size,
            api.global_share(z, g[1]) / mesh.size)


def _local_norm(blocks, plan, mesh):
    """The sum of squares of this rank's blocks alone."""
    return sum(torch.sum(torch.square(b)) for b in blocks)


def _summed(orig):
    def moment_grads(grads, plan, mesh, replicated=False):
        return orig(grads, plan, mesh, False)
    return moment_grads


def planted(fault):
    """[(module, attribute, replacement)] of a fault."""
    return {"mean_of_means": [(model_mod, "global_ce", _mean_of_means)],
            "local_fractions": [(moe_mod, "global_aux", _local_fractions)],
            "local_norm": [(optimizer, "_norm_sq", _local_norm)],
            "summed_replicated": [(optimizer, "moment_grads",
                                   _summed(optimizer.moment_grads))],
            }[fault]


def run_fault(mesh, fault, name, params_np, rows):
    patches = planted(fault)
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, new in patches:
        setattr(mod, attr, new)
    try:
        return run(mesh, name, params_np, 1, False, rows)
    finally:
        for mod, attr, old in saved:
            setattr(mod, attr, old)


def reshard_case(mesh, steps=2):
    """`apply_updates`' ZeRO-1 form on a tree whose FSDP and moment dims
    differ (a stacked [8, 4, 2] wq: FSDP splits dim 1, the moments dim 0)
    beside a leaf whose FSDP core is 1-D, against the one-device form on
    the summed gradients -> (largest error over the leaf's largest
    magnitude, this step's collectives by call)."""
    from repro_torch.distributed.sharding import train_plan
    from repro_torch.training.tree import unflatten
    gen = torch.Generator().manual_seed(3)
    whole = {"final_norm": torch.randn(4, generator=gen),
             "groups": [[{"attn": {"wq": torch.randn(8, 4, 2,
                                                     generator=gen)}}]]}
    plan = train_plan(whole, mesh, fsdp=True, rank=mesh.rank)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    one, one_state = whole, optimizer.init_opt_state(whole)
    mine = unflatten(whole, [p[lp.param].clone() for p, lp in
                             zip(leaves(whole), plan.leaves)])
    state = optimizer.init_opt_state(mine, plan)
    for t in range(steps):
        per_rank = [[torch.randn(p.shape, generator=gen)
                     for p in leaves(whole)] for _ in range(mesh.size)]
        summed = [sum(gs) for gs in zip(*per_rank)]
        one, one_state, _ = optimizer.apply_updates(
            cfg, one, unflatten(whole, summed), one_state)
        grads = [s[lp.param] if lp.pdim is not None else g for s, g, lp in
                 zip(summed, per_rank[mesh.rank], plan.leaves)]
        api.reset_collective_tally()
        mine, state, _ = optimizer.apply_updates(
            cfg, mine, optimizer.moment_grads(grads, plan, mesh), state,
            plan=plan, mesh=mesh)
        calls = api.collective_calls()
    err = 0.0
    for a, b, lp in zip(leaves(mine), leaves(one), plan.leaves):
        err = max(err, float((a - b[lp.param]).abs().max()
                             / b.abs().max()))
    return err, calls


def world(rank, n, payload):
    """Every case and fault of a world of n gloo ranks on the CPU ->
    {("case", case) or ("replicated", case) or ("fault", fault): result}."""
    mesh = make_train_mesh(n, device="cpu")
    out = {}
    for case in CASES:
        name, d, mb, fsdp = case
        if d == n:
            out[("case", case)] = run(mesh, name, payload[name], mb, fsdp)
    for case in REPLICATED:
        name, d, mb, fsdp = case
        if d == n:
            out[("replicated", case)] = run(mesh, name, payload[name], mb,
                                            fsdp, REPLICATED_B)
    for fault, name, d, rows in FAULTS:
        if d == n:
            out[("fault", fault)] = run_fault(mesh, fault, name,
                                              payload[name], rows)
    if n > 1:
        out["reshard"] = reshard_case(mesh)
    return out
