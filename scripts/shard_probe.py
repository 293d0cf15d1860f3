#!/usr/bin/env python3
"""What the card's libraries do for vocab-parallel serving, measured once:

    python3 scripts/shard_probe.py

1. The lm_head product split by vocab columns (the sharded engine's
   logits) against the whole product, bitwise, at smollm-360m's shapes
   (d_model 960, V 49152 in 2 and 4 blocks; V 50280 in the word-aligned
   25152 + 25128), bf16 and fp32, for the decode, span and prefill row
   counts the engine runs.
2. Two NCCL ranks on one card (`launch.mesh.spawn`): what NCCL says.
3. Two gloo ranks on one card: whether all_reduce (bf16), all_gather and
   broadcast_object_list take CUDA tensors.
4. One NCCL rank: the all-gather of [8, 49152] fp32 and the all-reduce of
   [8, 960] bf16, CUDA-event ms per call (50 calls).
5. One NCCL rank, smollm-360m at full width, `chip_smoke.py` phase 12's
   dense run (8 requests x 32 new tokens): ms a step of the unsharded
   engine, the sharded engine (the loop's control broadcast over the
   mesh's gloo group, as served) and the sharded engine with that
   broadcast moved onto the NCCL group, 3 runs each, the order rotated
   every round; the tokens of all nine runs must agree.
6. The same engines' decode step alone, outside the step loop, in two
   parts: one [8] forward on dense caches, and the constrained selection
   of its ids on phase 4's json rows (`fused_mask_select`, or the
   sharded route: shard-local mask, all-gather, whole-row select). The
   four calls (each part, unsharded and sharded) run one after another,
   each synced and timed alone, for 80 rounds (the first 5 warm up), the
   order rotated every round: the median ms of each call, and the median of the per-round
   differences sharded - unsharded, which host drift between rounds
   does not enter.
7. One NCCL rank: the loop's control broadcast (`broadcast_control`,
   a one-admission record) over the mesh's gloo group and over the NCCL
   group, host ms of the call when it is made just after queuing about
   15 ms of card work (ten [8192, 8192] bf16 products), alternated for
   20 rounds: the NCCL route's blocking copy waits for that work.
Prints the card's name and power limit first.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def log(*a):
    print(*a, flush=True)


def nccl_pair(rank):
    import torch
    import torch.distributed as dist
    x = torch.ones(4, device="cuda") * (rank + 1)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return x.tolist()


def gloo_pair(rank):
    import torch
    import torch.distributed as dist
    out = {}
    x = torch.ones(4, device="cuda", dtype=torch.bfloat16) * (rank + 1)
    dist.all_reduce(x)
    out["all_reduce bf16"] = x.tolist()
    ys = [torch.empty(4, device="cuda") for _ in range(2)]
    dist.all_gather(ys, torch.full((4,), float(rank), device="cuda"))
    out["all_gather"] = [y.tolist() for y in ys]
    box = [{"from": rank}]
    dist.broadcast_object_list(box, src=0)
    out["broadcast_object_list"] = box[0]
    return out


def world1_collectives(rank):
    import torch
    import torch.distributed as dist
    x = torch.ones(8, 960, device="cuda", dtype=torch.bfloat16)
    outs = [torch.empty(8, 49152, device="cuda")]
    res = {}
    for name, fn in (("all_reduce [8,960] bf16", lambda: dist.all_reduce(x)),
                     ("all_gather [8,49152] fp32",
                      lambda: dist.all_gather(outs, outs[0]))):
        for _ in range(3):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(50):
            fn()
        b.record()
        b.synchronize()
        res[name] = a.elapsed_time(b) / 50
    return res


def control_routes(rank):
    import dataclasses
    import statistics

    import chip_smoke
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Engine
    eng, bundles, tok = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda", mesh=1)
    mk = lambda mesh: Engine(eng.model, eng.params, tok, bundles,
                             max_len=512, slots=8, device="cuda", mesh=mesh)
    engines = {"unsharded": mk(None), "sharded, control over gloo": eng,
               "sharded, control over NCCL": mk(dataclasses.replace(
                   eng.mesh, ctrl_group=eng.mesh.group))}
    names = list(engines)
    for e in engines.values():                          # warm-up
        e.generate(chip_smoke.sharded_requests()[:1])
    ms, first = {n: [] for n in names}, None
    for i in range(3):
        for n in names[i:] + names[:i]:
            states, stats = engines[n].generate(
                chip_smoke.sharded_requests())
            got = chip_smoke.tokens_of(states)
            first = first or got
            if got != first:
                raise AssertionError(f"{n}: tokens differ")
            ms[n].append(1e3 * stats.wall / stats.decode_steps)
    return {n: (statistics.median(v), [round(x, 2) for x in v])
            for n, v in ms.items()}


def step_costs(rank):
    import statistics
    import time

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.fused_select.ops import (
        fused_mask_select, fused_mask_select_sharded)
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Engine
    eng, bundles, tok = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda", mesh=1)
    plain = Engine(eng.model, eng.params, tok, bundles, max_len=512,
                   slots=8, device="cuda")
    _, rows, eos, cd, cons = chip_smoke.json_rows(torch, np, eng)
    B, dev = 8, eng.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(rows), t(cd.view(np.int32)), t(eos), t(cons),
            t(np.arange(B) % 2 == 0), t(np.full(B, 0.8, np.float32)),
            t(np.full(B, 40, np.int32)), t(np.full(B, 0.95, np.float32)))
    noise = plain._noise(np.arange(2 * B, dtype=np.uint32).reshape(B, 2))
    ids = torch.full((B,), 7, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 40, dtype=torch.int32, device=dev)

    def parts_of(name, e):
        caches = e.model.init_decode_caches(B, e.max_len)
        fwd = lambda: e._decode(caches, ids, pos)
        logits = fwd()
        if e.mesh is None:
            sel = lambda: fused_mask_select(logits, e._store_cat, *args,
                                            noise=noise)
        else:
            sel = lambda: fused_mask_select_sharded(
                logits, e._store_cat, *args, shard=e._vs, mesh=e.mesh,
                blank_store=e._select_store, noise=noise)
        return {f"{name} forward": fwd, f"{name} select": sel}

    calls = {**parts_of("unsharded", plain), **parts_of("sharded", eng)}
    names = list(calls)
    ms = {n: [] for n in names}
    for i in range(80):
        for n in names[i % 4:] + names[:i % 4]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[n]()
            torch.cuda.synchronize()
            ms[n].append(1e3 * (time.perf_counter() - t0))
    out = {n: (statistics.median(v[5:]), min(v[5:]), max(v[5:]))
           for n, v in ms.items()}
    for part in ("forward", "select"):
        d = [s - u for s, u in zip(ms[f"sharded {part}"][5:],
                                   ms[f"unsharded {part}"][5:])]
        out[f"sharded - unsharded {part}"] = (statistics.median(d),
                                              min(d), max(d))
    got = [calls[f"{k} select"]()[0] for k in ("unsharded", "sharded")]
    if not torch.equal(*got):
        raise AssertionError("sharded select ids differ")
    return out


def control_wait(rank):
    import dataclasses
    import statistics
    import time

    import torch

    from repro_torch.distributed.api import broadcast_control
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(1)
    routes = {"gloo": mesh,
              "NCCL": dataclasses.replace(mesh, ctrl_group=mesh.group)}
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    record = {"admit": [(3, b"Q3: produce output. A:")], "cancel": []}
    ms = {n: [] for n in routes}
    for i in range(22):
        for n in list(routes)[::1 - 2 * (i % 2)]:
            torch.cuda.synchronize()
            for _ in range(10):
                a @ a
            t0 = time.perf_counter()
            broadcast_control(record, routes[n])
            ms[n].append(1e3 * (time.perf_counter() - t0))
    return {n: (statistics.median(v[2:]), min(v[2:]), max(v[2:]))
            for n, v in ms.items()}


def main():
    import torch
    from repro_torch.launch.mesh import spawn
    if not torch.cuda.is_available():
        log("shard_probe: no CUDA device")
        return 2
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.manual_seed(0)
    for V, cuts in ((49152, (24576,)), (49152, (12288, 24576, 36864)),
                    (50280, (25152,))):
        for dt in (torch.bfloat16, torch.float32):
            w = torch.randn(V, 960, device="cuda").to(dt)
            for shp in ((8, 960), (8, 8, 960), (8, 32, 960), (1, 16, 960),
                        (1, 512, 960), (1, 960)):
                x = torch.randn(*shp, device="cuda").to(dt)
                full = x @ w.T
                edges = (0, *cuts, V)
                parts = torch.cat([x @ w[a:b].T for a, b in
                                   zip(edges[:-1], edges[1:])], dim=-1)
                diff = (parts.float() - full.float()).abs().max().item()
                log(f"lm_head split V={V} at {cuts} {str(dt)[6:]} "
                    f"x{tuple(shp)}: bitwise {torch.equal(parts, full)}, "
                    f"max diff {diff}")
    try:
        log(f"NCCL, two ranks on one card: {spawn(2, nccl_pair)}")
    except Exception as e:                  # what NCCL says is the result
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        log("NCCL, two ranks on one card refused: "
            + " | ".join(lines[-4:]))
    log(f"gloo, two ranks on one card: "
        f"{spawn(2, gloo_pair, backend='gloo')}")
    log(f"NCCL, one rank, ms per call: {spawn(1, world1_collectives)[0]}")
    sys.path.insert(0, ROOT)
    for n, (med, runs) in spawn(1, control_routes)[0].items():
        log(f"world 1 dense 8 x 32, {n}: median {med:.2f} ms a step "
            f"(runs {runs})")
    for n, (med, lo, hi) in spawn(1, step_costs)[0].items():
        log(f"world 1 decode step alone, {n}: median {med:.4f} ms "
            f"(range {lo:.4f} to {hi:.4f})")
    for n, (med, lo, hi) in spawn(1, control_wait)[0].items():
        log(f"world 1 control broadcast over {n} after queued card work: "
            f"median {med:.4f} ms (range {lo:.4f} to {hi:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
