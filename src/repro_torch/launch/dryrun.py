"""Multi-pod dry run (port of `repro.launch.dryrun`): every (architecture x
input shape) on the production mesh, as a per-device record of memory,
FLOPs, bytes and collectives.

The reference lowers and compiles each combination for 256 or 512
placeholder devices and reads XLA's analyses of the program. The port
compiles nothing: it builds the inputs as meta tensors (shapes and
dtypes, no storage; `Model(cfg, device="meta")`, `launch/shapes.py`),
cuts them with the sharding rules of `distributed/sharding.py` on the
mesh's shape, and counts the step with `distributed/cost.py`. It
allocates no real tensor and touches no card: meta is its device, as
placeholder devices are the reference's.

Per record, per device:
  * argument bytes: the step's inputs under their specs (`shard_slice`
    sizes): params under `param_specs(fsdp=needs_fsdp(...))`, the AdamW
    moments under `opt_state_specs` (ZeRO-1), the batch under
    `batch_specs`; in decode the caches under `cache_specs`, token, pos,
    the mask rows and eos over the data axes, the mask store and the cd
    words over "model" at the word dim when it divides (the reference's
    `_jit_target`). Output bytes likewise (new params and moments; the
    new caches, which alias the donated ones; prefill's logits and
    caches; decode's ids and masked logits).
  * temp bytes, the estimate that replaces XLA's memory analysis, with
    T = B_dev x S tokens a device a microbatch (B_dev = B / data ways /
    microbatch), D the width, w the dtype's bytes, M the model ways that
    split the heads or the FFN:
      train: the gradients (fp32 and ZeRO-split like the moments when
        microbatched: the accumulator; else the params' specs and
        dtype), the checkpointed layer inputs (remat: L x T x D x w;
        without remat every layer's activations), one layer's
        activations while it is recomputed and differentiated
        (T x (6 D + 2 (H + 2 K) Dh / M + 3 F / M) x w, an MoE layer's
        dispatch buffers B_dev x E / M x C x (2 D + 3 F) x w beside it,
        an SSM layer's chunk states B_dev x nch x Hs / M x N x P x 4)
        and the attention scores of one query block, [B_dev, H / M, c,
        c] in fp32 twice (c = min(S, attn_chunk)); plus one loss chunk's
        fp32 logits (B_dev x min(S, 1024) x V / M x 4, twice: logits and
        their gradient).
        With seq_parallel the layer inputs split over "model" too.
      prefill: one layer's activations and attention block as above
        (no gradients, no checkpoint).
      decode: the fp32 logits and the masked logits of the step, and
        one layer's scores [B_dev, H / M, 1, L] in fp32.
    peak = temp + argument bytes, as the reference's record sums them.
  * FLOPs, HBM bytes and wire bytes from `cost.py` (`train_step`,
    `prefill`, `serve_step`), with `model_flops_global` = 6 x active
    params x tokens for training and 2 x active params x tokens
    otherwise, and `useful_flops_ratio` = that over the counted FLOPs of
    all chips (`hlo_flops_global`: the count follows the reference's HLO
    definition, hence the name);
  * roofline terms against one H100 SXM5 (`launch/mesh.py`): compute
    (bf16 peak), memory (HBM) and collective (one NVLink direction)
    seconds, and the largest of them as the bottleneck; `fits_hbm` and
    `hbm_utilization` against `HBM_BYTES`.

The records keep the reference's keys but the four that name XLA:
`lower_s`, `compile_s` (nothing is lowered or compiled),
`xla_cost_analysis` (no XLA) and `memory.cpu_bf16_widening_bytes_removed`
(an artifact of XLA's CPU backend); `memory.generated_code_size_in_bytes`
goes with them. `run_all` runs every combination in this process (a
record takes milliseconds and no memory to speak of), over the eleven
configs, syncode-demo included: 44 records a mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all            # every combo
  python -m repro_torch.launch.dryrun --all --multi-pod
Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback

from ..configs import all_configs, get_config
from ..distributed import cost
from ..distributed.sharding import (_div, _dp, batch_specs, cache_specs,
                                    leaves_with_path, needs_fsdp,
                                    opt_state_specs, param_specs, shard_slice)
from ..models.model import Model
from .mesh import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16,
                   make_production_mesh)
from .shapes import (MAX_ACCEPT, SHAPES, applicable, input_specs,
                     mask_words, variant_for_shape)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# gradient-accumulation factor per arch for train_4k (the reference's)
DEFAULT_MICROBATCH = {
    "internlm2-1.8b": 2,
    "qwen1.5-0.5b": 2,
    "smollm-360m": 2,
    "mamba2-370m": 2,
    "deepseek-coder-33b": 16,
    "recurrentgemma-9b": 4,
    "kimi-k2-1t-a32b": 16,
    "llama-3.2-vision-90b": 16,
    "qwen3-moe-30b-a3b": 16,
    "whisper-base": 2,
}


def count_params(abstract_params, cfg):
    """(total_params, active_params) -- active discounts expert weights
    by top-k/E (an MoE forward touches only the routed experts). Reads
    shapes only."""
    total = 0
    active = 0.0
    for ps, leaf in leaves_with_path(abstract_params):
        n = math.prod(leaf.shape)
        total += n
        if "['moe']" in ps and any(
                f"['{w}']" in ps for w in ("w_gate", "w_up", "w_down")):
            active += n * cfg.experts_per_token / max(cfg.num_experts, 1)
        else:
            active += n
    return total, int(active)


def _shard_bytes(leaf, spec, mesh) -> int:
    """Bytes of rank 0's block of `leaf` under `spec` (every rank's block
    is the same size: the rules split only dims that divide)."""
    sl = shard_slice(spec, tuple(leaf.shape), mesh, 0)
    return math.prod(s.stop - s.start for s in sl) * leaf.dtype.itemsize


def tree_shard_bytes(tree, specs, mesh) -> int:
    """Bytes of a tree's blocks on one device."""
    if isinstance(specs, tuple) and not isinstance(tree, (tuple, list)):
        return _shard_bytes(tree, specs, mesh)
    return sum(_shard_bytes(leaf, spec, mesh)
               for _, leaf, spec in cost.leaves_with_specs(tree, specs))


def argument_specs(cfg, mode, specs, mesh):
    """-> {input name: spec tree} as the reference's `_jit_target` shards
    the step's inputs."""
    fsdp = needs_fsdp(specs["params"], mesh)
    out = {"params": param_specs(specs["params"], mesh, fsdp=fsdp)}
    if mode == "train":
        out["opt_state"] = opt_state_specs(specs["opt_state"], mesh)
        out["batch"] = batch_specs(specs["batch"], mesh)
    elif mode == "prefill":
        out["batch"] = batch_specs(specs["batch"], mesh)
    else:
        out["caches"] = cache_specs(specs["caches"], mesh, cfg)
        B = specs["token"].shape[0]
        dp = _dp(mesh, B)
        W = specs["mask_store"].shape[1]
        mp_w = "model" if _div(W, mesh, "model") else None
        for k in ("token", "pos", "eos_allowed"):
            out[k] = (dp,)
        out["mask_rows"] = (dp, None)
        out["mask_store"] = (None, mp_w)
        out["mask_cd"] = (None, mp_w)
    return out


def argument_bytes(cfg, mode, specs, mesh) -> dict:
    """Per-device bytes of each input of the step -> {name: bytes}."""
    sp = argument_specs(cfg, mode, specs, mesh)
    return {k: tree_shard_bytes(specs[k], sp[k], mesh) for k in sp}


def temp_bytes(cfg, mode, B, S, mesh, microbatch=1,
               seq_parallel=False) -> float:
    """The per-device temp estimate (module docstring)."""
    t = cost._Tally(mesh)
    dw = t.data_ways(B)
    w = cost._itemsize(cfg)
    D = cfg.d_model
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    mh = t.split(H) if H else 1
    V = cfg.vocab_size
    mv = t.split(V)
    if mode == "decode":
        L = cost._ring_len(cfg, S)
        return B / dw * (2 * V / mv * 4 + (H / mh * L * 4 if H else 0))
    Bd = B / dw / max(1, microbatch)
    T = Bd * S
    F = cfg.d_ff or 0
    layer = T * (6 * D + (2 * (H + 2 * K) * Dh / mh if H else 0) +
                 3 * F / t.split(F or 1)) * w
    if cfg.num_experts:
        from ..models.moe import capacity
        E = cfg.num_experts
        layer += Bd * E / t.split(E) * capacity(cfg, S) * \
            (2 * D + 3 * cfg.expert_d_ff) * w
    if cfg.ssm_state:
        Q = min(cfg.ssm_chunk, S)
        layer += Bd * (S // Q) * cfg.ssm_heads / t.split(cfg.ssm_heads) * \
            cfg.ssm_state * cfg.ssm_head_dim * 4
    if H:
        q = min(S, cfg.attn_chunk)
        layer += 2 * Bd * H / mh * q * min(S, cfg.attn_chunk) * 4
    if mode == "prefill":
        return layer
    fsdp = needs_fsdp(cost.meta_params(cfg), mesh)
    state = cost.param_state_bytes(cfg, mesh, fsdp)
    grads = state["moments"] / 2 if microbatch > 1 else state["grads"]
    seq = t.model if seq_parallel else 1
    keep = cfg.num_layers * T * D * w / seq if cfg.remat else \
        cfg.num_layers * layer
    logits = 2 * Bd * min(S, 1024) * V / mv * 4
    return grads + keep + layer + logits


def train_estimate(cfg, B: int, S: int, mesh, microbatch: int = 1) -> dict:
    """A train step of B x S on `mesh` (any shape: a 1x1 mesh is one
    card): the per-device argument bytes (params, moments, batch), the
    temp estimate and their sum, the peak the record reports."""
    params = cost.meta_params(cfg)
    from ..training.optimizer import init_opt_state
    from .shapes import batch_specs as batch_shapes
    specs = {"params": params, "opt_state": init_opt_state(params),
             "batch": batch_shapes(cfg, S, B, with_labels=True)}
    arg = argument_bytes(cfg, "train", specs, mesh)
    temp = temp_bytes(cfg, "train", B, S, mesh, microbatch)
    return {"arguments": arg, "argument_bytes": sum(arg.values()),
            "temp_bytes": temp, "peak_bytes": sum(arg.values()) + temp}


def output_bytes(cfg, mode, arg, B, S, mesh) -> float:
    """Per-device bytes of the step's outputs."""
    t = cost._Tally(mesh)
    dw = t.data_ways(B)
    mv = t.split(cfg.vocab_size)
    if mode == "train":
        return arg["params"] + arg["opt_state"] + 4
    if mode == "prefill":
        caches = Model(cfg, device="meta").init_decode_caches(B, S)
        return B / dw * S * cfg.vocab_size / mv * cost._itemsize(cfg) + \
            tree_shard_bytes(caches, cache_specs(caches, mesh), mesh)
    return arg["caches"] + B / dw * (4 + cfg.vocab_size / mv * 4)


def run_one(arch: str, shape: str, multi_pod: bool = False,
            save: bool = True, verbose: bool = True,
            microbatch: int | None = None,
            seq_parallel: bool = False) -> dict:
    ok, why = applicable(get_config(arch), shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "skipped": why}
        if save:
            _save(rec)
        return rec

    cfg = variant_for_shape(get_config(arch), shape)
    model = Model(cfg, device="meta")
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    mode, specs = input_specs(model, shape)
    info = SHAPES[shape]
    B, S = info["global_batch"], info["seq_len"]
    if microbatch is None:
        microbatch = DEFAULT_MICROBATCH.get(arch, 1) if mode == "train" \
            else 1

    if mode == "train":
        c = cost.train_step(cfg, B, S, microbatch=microbatch, mesh=mesh)
    elif mode == "prefill":
        c = cost.prefill(cfg, B, S, mesh=mesh)
    else:
        c = cost.serve_step(cfg, B, S, MAX_ACCEPT, mask_words(cfg),
                            mesh=mesh)
    flops_dev = float(c["flops"])
    bytes_dev = float(c["hbm_bytes"])
    wire_dev = float(c["wire_bytes"])
    coll = c["collectives"]
    coll["total_wire_bytes"] = wire_dev

    total_p, active_p = count_params(specs["params"], cfg)
    tokens = B * S if mode in ("train", "prefill") else B
    model_flops = (6.0 if mode == "train" else 2.0) * active_p * tokens

    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    collective_s = wire_dev / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)

    arg = argument_bytes(cfg, mode, specs, mesh)
    arg_total = int(sum(arg.values()))
    temp = int(temp_bytes(cfg, mode, B, S, mesh, microbatch, seq_parallel))
    mem_fields = {
        "temp_size_in_bytes": temp,
        "argument_size_in_bytes": arg_total,
        "output_size_in_bytes": int(output_bytes(cfg, mode, arg, B, S,
                                                 mesh)),
        "alias_size_in_bytes": int(arg.get("caches", 0) if mode == "decode"
                                   else arg["params"] + arg.get(
                                       "opt_state", 0)
                                   if mode == "train" else 0),
        "arguments": {k: int(v) for k, v in arg.items()},
    }
    peak_bytes = temp + arg_total

    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "mode": mode,
        "chips": chips, "microbatch": microbatch,
        "seq_parallel": seq_parallel,
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire_dev,
        "collectives": coll,
        "memory": mem_fields,
        "fits_hbm": bool(peak_bytes <= HBM_BYTES),
        "hbm_utilization": peak_bytes / HBM_BYTES,
        "params_total": total_p,
        "params_active": active_p,
        "model_flops_global": model_flops,
        "hlo_flops_global": flops_dev * chips,
        "useful_flops_ratio":
            model_flops / max(flops_dev * chips, 1.0),
        "roofline": {**{k: float(v) for k, v in terms.items()},
                     "bottleneck": bottleneck},
    }
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "mode", "fits_hbm",
                           "hbm_utilization", "useful_flops_ratio")}))
        print("  roofline:", {k: f"{v:.3e}" for k, v in terms.items()},
              "->", bottleneck)
    if save:
        _save(rec)
    return rec


def _save(rec):
    os.makedirs(ART_DIR, exist_ok=True)
    fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(ART_DIR, fn), "w") as f:
        json.dump(rec, f, indent=1)


def run_all(multi_pod: bool, archs=None, shapes=None, save: bool = True,
            quiet: bool = False):
    """Every combination in this process -> (records, failures), a
    failure's traceback kept as the reference keeps its subprocess's
    stderr. A line a combination unless `quiet`."""
    archs = archs or list(all_configs())
    shapes = shapes or list(SHAPES)
    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            try:
                rec = run_one(arch, shape, multi_pod, save=save,
                              verbose=False)
            except Exception as e:      # reported, and the run fails
                failures.append((arch, shape, traceback.format_exc()))
                print(f"[FAIL] {arch} x {shape}: {e!r}")
                continue
            records.append(rec)
            if not quiet:
                print(f"[ok] {arch} x {shape}"
                      + (" (skipped)" if "skipped" in rec else
                         f" fits={rec['fits_hbm']} "
                         f"{rec['roofline']['bottleneck']}"))
    return records, failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    args = ap.parse_args()
    if args.all:
        archs = [args.arch] if args.arch else None
        shapes = [args.shape] if args.shape else None
        _, failures = run_all(args.multi_pod, archs, shapes)
        for arch, shape, err in failures:
            print(f"\n=== FAILURE {arch} x {shape} ===\n{err}")
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    run_one(args.arch, args.shape, args.multi_pod,
            microbatch=args.microbatch, seq_parallel=args.seq_parallel)


if __name__ == "__main__":
    main()
