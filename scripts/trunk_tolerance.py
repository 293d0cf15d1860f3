"""How far trunk-sharded logits stray from the one-device engine's in
bf16, measured on the CPU (gloo ranks): the bound `chip_smoke.py` phase 14
holds the card's first decode step to.

    PYTHONPATH=src python scripts/trunk_tolerance.py [--json out.json]
        [--arch ARCH]

For each case (a config, a depth, a width) it draws seeded weights,
prefills 8 prompts of 16 tokens (32 where M = 2 does not divide the kv
heads, smollm-360m's 5: the sequence split, whose rank 1 then holds the
step's own position 32 of the 64) and runs one decode step through the
one-device engine and through each rank of a 2-rank trunk-sharded engine
(`Engine(mesh, trunk_shard=True)`, the engines' own `_prefill`/`_decode`,
the logits gathered), and prints the largest |difference| of the decode
logits in bf16 ulps at the largest |logit| (the unit of the phase 11
checks), over the rows whose last token every MoE layer routed to the
same experts in both runs. The widths are `cfg.reduced()`'s (the CPU may
not run a full-size config) and the full ones at two layers. The QKV
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
other rank's share into its cache. Each
line says whether phase 14's rule catches the case at BOUND ulps (fewer
than half the rows routed alike, or more ulps than the bound): a sound
case must not be caught, a faulty one must.
"""
import argparse
import json
import math
import os
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

B, P = 8, 16
# (arch, width, depth, planted fault or None)
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
         ("smollm-360m", "full", 32, "other-rank-slots"))
BIAS_SCALE = 0.5
BOUND = 16              # chip_smoke.py's TRUNK_ULPS


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
    from repro_torch.models import common, layers, moe
    if fault == "ffn-no-all-reduce":
        ffn, reduce = layers.ffn, common.trunk_all_reduce

        def unreduced(p, x):
            common.trunk_all_reduce = lambda y, mesh: y
            try:
                return ffn(p, x)
            finally:
                common.trunk_all_reduce = reduce
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
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def with_biases(params):
    """The tree with seeded random QKV biases in place of the zeros."""
    from repro_torch.distributed.sharding import map_with_path
    g = torch.Generator().manual_seed(2)

    def draw(path, t):
        if path.endswith(("['bq']", "['bk']", "['bv']")):
            return (BIAS_SCALE * torch.randn(t.shape, generator=g)).to(
                t.dtype)
        return t
    return map_with_path(draw, params)


def prompt_len(cfg):
    """16, or 32 under the sequence split (M = 2 does not divide the kv
    heads): the decode step's position then opens rank 1's share of the
    64 positions."""
    return P if cfg.num_kv_heads % 2 == 0 else 32


def run(rank, n, arch, width, depth, fault=None):
    """-> (decode logits [B, V] fp32, per MoE call [B, k] routes)."""
    torch.set_num_threads(2)
    if n is not None:
        plant(fault)
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.distributed.api import (all_gather_last, current_mesh,
                                             current_trunk)
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = config(arch, width, depth)
    model = build_model(cfg, device="cpu")
    params = with_biases(model.init(torch.Generator().manual_seed(0)))
    mesh = None if n is None else make_serving_mesh(n, device="cpu")
    eng = Engine(model, params, ByteTokenizer(cfg.vocab_size), {},
                 max_len=64, slots=B, device="cpu", mesh=mesh,
                 trunk_shard=True)
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


def measure(arch, width, depth, fault):
    from repro_torch.launch.mesh import spawn
    want, want_routes = run(0, None, arch, width, depth)
    ranks = spawn(2, run, 2, arch, width, depth, fault, device="cpu")
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
            "max_abs_err": worst, "largest_logit": top,
            "ulps": worst / ulp, "rows_held": held, "rows": B,
            "caught": held < B // 2 or worst / ulp > BOUND}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--arch", default=None, help="only this config's cases")
    args = ap.parse_args()
    out = []
    for arch, width, depth, fault in CASES:
        if args.arch not in (None, arch):
            continue
        r = measure(arch, width, depth, fault)
        print(json.dumps(r), flush=True)
        out.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
