"""How far trunk-sharded logits stray from the one-device engine's in
bf16, measured on the CPU (gloo ranks): the bound `chip_smoke.py` phase 14
holds the card's first decode step to.

    PYTHONPATH=src python scripts/trunk_tolerance.py [--json out.json]
        [--arch ARCH] [--split {any,default,dh,whole}] [--own-noise DEPTH]

For each case (a config, a depth, a width, a split) it draws seeded
weights, prefills 8 prompts of 16 tokens (32 where M does not divide the
kv heads, smollm-360m's 5: under the sequence split rank 1 then holds the
step's own position 32 of the 64) and runs one decode step through the
one-device engine and through each rank of a trunk-sharded engine of
SPLITS' ranks and max_len (2 and 64 by default; "dh": 2 ranks at max_len
63, which 2 does not divide, so smollm-360m's caches split head_dim;
"whole": 3 ranks, which divide neither its kv heads, 64 nor its head_dim
of 64, so every rank holds the whole cache)
(`Engine(mesh, trunk_shard=True)`, the engines' own `_prefill`/`_decode`,
the logits gathered), and prints the largest |difference| of the decode
logits in bf16 ulps at the largest |logit| (the unit of the phase 11
checks), over the rows whose last token every MoE layer routed to the
same experts in both runs. The widths are `cfg.reduced()`'s (the CPU may
not run a full-size config) and the full ones at a few layers (mamba2-370m
at all 48; recurrentgemma-9b at 3, 6 and 9, whose ranks draw only their
blocks, `Model.init(gen, cut=...)`, to bound the memory). The QKV
biases (zeros in `Model.init`) are drawn at random, so that their columns
matter.

The cases with a fault plant one broken split in the ranks only (the
one-device side stays sound), by replacing a function of the port in the
rank's process: `ffn-no-all-reduce` drops the FFN's all-reduce,
`bias-columns` adds the other rank's columns of the QKV biases,
`expert-offset` runs the other rank's share of the experts' pairs;
under the sequence split, `combine-no-lse` joins the ranks' partial
attentions with equal weights instead of their log-sum-exp weights, and
`other-rank-slots` has each rank's prefill write the positions of the
other rank's share into its cache; under the head_dim split,
`scores-no-all-reduce` softmaxes a rank's partial scores without the
other ranks', `o-blocks-out-of-order` joins the ranks' blocks of the
output channels in reverse rank order, and `mask-before-join` masks each
rank's partial scores before the all-reduce (and not after); in the
recurrent layers,
`norm-own-channels` takes the SSM's gated-norm statistic over the rank's
own channels only, and `gates-own-channels` contracts the RG-LRU's gates
over the rank's own conv channels only (the other ranks' as zeros).
`two-reduces` is no fault: the SSM's norm in the reference's rounding
order (its statistic all-reduced first, then the normalized w_out
partial), against the port's one all-reduce. Each
line says whether phase 14's rule catches the case at BOUND ulps
(FAMILY_BOUND for mamba2 and recurrentgemma; fewer than half the rows
routed alike, or more ulps than the bound): a sound case must not be
caught, a faulty one must.
"""
import argparse
import json
import math
import os
import sys
from dataclasses import replace

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

B, P = 8, 16
# (arch, width, depth, planted fault or None[, split of SPLITS])
CASES = (("qwen1.5-0.5b", "reduced", 2, None),
         ("qwen1.5-0.5b", "reduced", 8, None),
         ("qwen1.5-0.5b", "reduced", 24, None),
         ("qwen1.5-0.5b", "full", 2, None),
         ("qwen3-moe-30b-a3b", "reduced", 2, None),
         ("qwen3-moe-30b-a3b", "reduced", 4, None),
         ("qwen3-moe-30b-a3b", "reduced", 8, None),
         ("qwen1.5-0.5b", "reduced", 24, "ffn-no-all-reduce"),
         ("qwen1.5-0.5b", "full", 2, "ffn-no-all-reduce"),
         ("qwen1.5-0.5b", "reduced", 24, "bias-columns"),
         ("qwen1.5-0.5b", "full", 2, "bias-columns"),
         ("qwen3-moe-30b-a3b", "reduced", 4, "expert-offset"),
         ("qwen3-moe-30b-a3b", "reduced", 8, "expert-offset"),
         ("smollm-360m", "full", 2, None),
         ("smollm-360m", "full", 8, None),
         ("smollm-360m", "full", 32, None),
         ("smollm-360m", "full", 2, "combine-no-lse"),
         ("smollm-360m", "full", 32, "combine-no-lse"),
         ("smollm-360m", "full", 2, "other-rank-slots"),
         ("smollm-360m", "full", 32, "other-rank-slots"),
         ("mamba2-370m", "full", 2, None),
         ("mamba2-370m", "full", 8, None),
         ("mamba2-370m", "full", 48, None),
         ("mamba2-370m", "full", 48, "two-reduces"),
         ("mamba2-370m", "full", 2, "norm-own-channels"),
         ("mamba2-370m", "full", 48, "norm-own-channels"),
         ("recurrentgemma-9b", "full", 3, None),
         ("recurrentgemma-9b", "full", 6, None),
         ("recurrentgemma-9b", "full", 9, None),
         ("recurrentgemma-9b", "full", 3, "gates-own-channels"),
         ("recurrentgemma-9b", "full", 6, "gates-own-channels"),
         ("recurrentgemma-9b", "full", 9, "gates-own-channels"),
         ("smollm-360m", "full", 2, None, "dh"),
         ("smollm-360m", "full", 8, None, "dh"),
         ("smollm-360m", "full", 2, "scores-no-all-reduce", "dh"),
         ("smollm-360m", "full", 8, "scores-no-all-reduce", "dh"),
         ("smollm-360m", "full", 2, "o-blocks-out-of-order", "dh"),
         ("smollm-360m", "full", 8, "o-blocks-out-of-order", "dh"),
         ("smollm-360m", "full", 2, "mask-before-join", "dh"),
         ("smollm-360m", "full", 8, "mask-before-join", "dh"),
         ("smollm-360m", "full", 2, None, "whole"),
         ("smollm-360m", "full", 8, None, "whole"))
# split -> (ranks, the engines' max_len)
SPLITS = {None: (2, 64), "dh": (2, 63), "whole": (3, 64)}
BIAS_SCALE = 0.5
BOUND = 16              # chip_smoke.py's TRUNK_ULPS
FAMILY_BOUND = {"mamba2-370m": 64, "recurrentgemma-9b": 3}  # its own


def config(arch, width, depth):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if width == "reduced":
        # reduced() keeps 4 q heads over 2 kv heads and 4 experts: M = 2
        # splits both
        cfg = cfg.reduced()
    return replace(cfg, num_layers=depth, dtype="bfloat16")


def routes_of(calls):
    """The experts each MoE call routed its rows' last token to."""
    return [c.sort(-1).values for c in calls]


def plant(fault):
    """Break this process's trunk split as `fault` says."""
    from repro_torch.models import common, layers, moe, rglru, ssm
    if fault == "ffn-no-all-reduce":
        ffn, reduce = layers.ffn, common.model_sum

        def unreduced(p, x):
            common.model_sum = lambda y, mesh, call=None: y
            try:
                return ffn(p, x)
            finally:
                common.model_sum = reduce
        layers.ffn = unreduced
    elif fault == "bias-columns":
        def other_cols(b, span):
            if span is None:
                return b
            n, tp = span[1] - span[0], common.current_trunk()
            r = (tp.rank + 1) % tp.size
            return b[..., r * n:(r + 1) * n]
        common._cols = other_cols
    elif fault == "expert-offset":
        trunk = moe.current_trunk

        def shifted():
            tp = trunk()
            return tp and replace(tp, rank=(tp.rank + 1) % tp.size)
        moe.current_trunk = shifted
    elif fault == "combine-no-lse":
        layers.combine_partials = lambda o, lse, dtype: o.mean(0).to(dtype)
    elif fault == "other-rank-slots":
        prefill, split = layers._self_attention_prefill, layers._seq_split

        def other():
            tp = split()
            lo, hi = tp.positions
            r = (tp.rank + 1) % tp.size
            return replace(tp, positions=(r * (hi - lo), (r + 1) * (hi - lo)))

        def shifted(p, x, cfg, ctx):
            layers._seq_split = other
            try:
                return prefill(p, x, cfg, ctx)
            finally:
                layers._seq_split = split
        layers._self_attention_prefill = shifted
    elif fault == "scores-no-all-reduce":
        layers.trunk_all_reduce = lambda s, mesh: s
    elif fault == "o-blocks-out-of-order":
        gather = layers.all_gather_last

        def reversed_blocks(x, widths, mesh):
            got = gather(x, widths, mesh)
            return torch.cat(got.split(list(widths), -1)[::-1], -1)
        layers.all_gather_last = reversed_blocks
    elif fault == "mask-before-join":
        from repro_torch.kernels.paged_attention.ref import NEG_INF
        join = layers._dh_join

        def masked_first(s, valid, values, dtype, out_dtype):
            s = torch.where(valid[:, :, None, :], s, NEG_INF)
            return join(s, torch.ones_like(valid), values, dtype, out_dtype)
        layers._dh_join = masked_first
    elif fault == "two-reduces":        # not a fault: another order
        def two(params, y, z, dtype, tp):
            r0, r1 = tp.ssm_rows
            g = y * F.silu(z.float())
            ss = ssm.trunk_all_reduce(torch.sum(torch.square(g), -1,
                                                keepdim=True),
                                      ssm.current_mesh())
            var = ss / params["norm_w"].shape[-1]
            yn = g * torch.rsqrt(var + ssm._NORM_EPS) * \
                params["norm_w"][r0:r1].float()
            return ssm.trunk_all_reduce(yn.to(dtype) @ params["w_out"],
                                        ssm.current_mesh())
        ssm._out = two
    elif fault == "norm-own-channels":
        def own_norm(params, y, z, dtype, tp):
            r0, r1 = tp.ssm_rows
            y = ssm._gated_norm(y, z, params["norm_w"][r0:r1]).to(dtype)
            return ssm.trunk_all_reduce(y @ params["w_out"],
                                        ssm.current_mesh())
        ssm._out = own_norm
    elif fault == "gates-own-channels":
        def own_channels(x, widths, mesh):
            r = common.current_trunk().rank
            pad = [torch.zeros_like(x)] * len(widths)
            pad[r] = x
            return torch.cat(pad, -1)
        rglru.all_gather_last = own_channels
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def with_biases(params, cut=None, whole=None):
    """The tree with seeded random QKV biases in place of the zeros; a
    rank's blocks (`cut` of each leaf of the `whole` tree) get their cut
    of the whole tree's draws."""
    from repro_torch.distributed.sharding import (leaves_with_path,
                                                  map_with_path)
    g = torch.Generator().manual_seed(2)
    shapes = {p: tuple(t.shape) for p, t in leaves_with_path(whole)} \
        if whole is not None else None

    def draw(path, t):
        if path.endswith(("['bq']", "['bk']", "['bv']")):
            shape = tuple(t.shape) if shapes is None else shapes[path]
            b = (BIAS_SCALE * torch.randn(shape, generator=g)).to(t.dtype)
            return b if cut is None else b[cut(path, shape)]
        return t
    return map_with_path(draw, params)


def prompt_len(cfg):
    """16, or 32 where M = 2 does not divide the kv heads: under the
    sequence split the decode step's position then opens rank 1's share
    of the 64 positions."""
    return P if cfg.num_kv_heads % 2 == 0 else 32


def run(rank, n, arch, width, depth, fault=None, split=None):
    """-> (decode logits [B, V] fp32, per MoE call [B, k] routes)."""
    torch.set_num_threads(2)
    if n is not None:
        plant(fault)
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.distributed.api import (all_gather_last, current_mesh,
                                             current_trunk)
    from repro_torch.distributed.sharding import trunk_slice, vocab_shard
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = config(arch, width, depth)
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    mesh = None if n is None else make_serving_mesh(n, device="cpu")
    if mesh is None:
        params = with_biases(model.init(gen))
    else:               # the rank's blocks only
        vs = vocab_shard(cfg.vocab_size, n, mesh.rank)
        cut = lambda p, shape: trunk_slice(p, shape, mesh, mesh.rank, vs)
        params = with_biases(model.init(gen, cut=cut), cut,
                             model.abstract_params())
    eng = Engine(model, params, ByteTokenizer(cfg.vocab_size), {},
                 max_len=SPLITS[split][1], slots=B, device="cpu", mesh=mesh,
                 trunk_shard=True)
    if mesh is not None and split is not None:
        assert eng._trunk.cache == split, (eng._trunk.cache, split)
    calls, orig = [], layers.moe_ffn

    def spy(p, x, c):
        lg = x[:, -1].float() @ p["router"]
        tp = current_trunk()
        if tp is not None and tp.experts_split:
            lg = all_gather_last(lg, (tp.experts,) * tp.size, current_mesh())
        calls.append(lg.topk(c.experts_per_token, dim=-1).indices)
        return orig(p, x, c)
    layers.moe_ffn = spy
    g = torch.Generator().manual_seed(1)
    n_p = prompt_len(cfg)
    toks = torch.randint(3, cfg.vocab_size, (B, n_p + 1), generator=g,
                         dtype=torch.int32)
    _, caches = eng._prefill(toks[:, :n_p], n_p)
    calls.clear()
    logits = eng._gather(eng._decode(caches, toks[:, n_p],
                                     torch.full((B,), n_p,
                                                dtype=torch.int32)))
    layers.moe_ffn = orig
    return logits.float(), routes_of(calls)


def measure(arch, width, depth, fault, split=None):
    from repro_torch.launch.mesh import spawn
    want, want_routes = run(0, None, arch, width, depth)
    n = SPLITS[split][0]
    ranks = spawn(n, run, n, arch, width, depth, fault, split,
                  device="cpu")
    top = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    worst, held = 0.0, B
    for got, got_routes in ranks:
        same = torch.ones(B, dtype=torch.bool)
        for a, b in zip(got_routes, want_routes):
            same &= (a == b).all(-1)
        held = min(held, int(same.sum()))
        err = (got - want).abs().amax(-1)[same]
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return {"arch": arch, "width": width, "depth": depth, "fault": fault,
            "split": split, "ranks": n, "max_len": SPLITS[split][1],
            "max_abs_err": worst, "largest_logit": top,
            "ulps": worst / ulp, "rows_held": held, "rows": B,
            "caught": held < B // 2 or
            worst / ulp > FAMILY_BOUND.get(arch, BOUND)}


def own_noise(arch, depth):
    """The one-device bf16 model's own distance from its fp32 twin (the
    same weights upcast; no split), in the same unit: what bf16 alone
    does at this depth."""
    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.models.model import build_model
    torch.set_num_threads(4)
    cfg = config(arch, "full", depth)
    model = build_model(cfg, device="cpu")
    params = with_biases(model.init(torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    n_p = prompt_len(cfg)
    toks = torch.randint(3, cfg.vocab_size, (B, n_p + 1), generator=g,
                         dtype=torch.int32)
    out = []
    for m, p in ((model, params), (build_model(replace(
            cfg, dtype="float32"), device="cpu"),
            map_with_path(lambda _, t: t.float(), params))):
        with torch.no_grad():
            _, c = m.prefill(p, {"tokens": toks[:, :n_p]}, cache_len=64,
                             true_len=n_p)
            out.append(m.decode_step(p, c, toks[:, n_p], torch.full(
                (B,), n_p, dtype=torch.int32))[0].float())
    top = float(out[0].abs().max())
    err = float((out[0] - out[1]).abs().max())
    return {"arch": arch, "depth": depth, "own_noise_vs_fp32": err,
            "largest_logit": top,
            "ulps": err / 2.0 ** (math.floor(math.log2(top)) - 7)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--arch", default=None, help="only this config's cases")
    ap.add_argument("--split", default="any",
                    choices=("any", "default", "dh", "whole"),
                    help="only the cases of this split")
    ap.add_argument("--own-noise", type=int, default=None, metavar="DEPTH",
                    help="print --arch's one-device bf16 distance from its "
                         "fp32 twin at DEPTH layers and stop")
    args = ap.parse_args()
    if args.own_noise:
        print(json.dumps(own_noise(args.arch, args.own_noise)), flush=True)
        return
    out = []
    for arch, width, depth, fault, *split in CASES:
        split = split[0] if split else None
        if args.arch not in (None, arch) or \
                args.split not in ("any", split or "default"):
            continue
        r = measure(arch, width, depth, fault, split)
        print(json.dumps(r), flush=True)
        out.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
