"""Seconds of `chip_smoke.py` phases at settings other than the script's,
read in one process on one card: what each of the script's cuts for time
saves, measured on one host.

    python3 scripts/phase_seconds.py [--profile-steps 2,10]
        [--dp-depths 16,32] [--also 14,16]
        [--json out.json]

Builds the kernels as `chip_smoke.py` does, then runs phase 6 (the decode
step breakdowns of smollm-360m, dense and paged) once for each profiled
window of `--profile-steps` (`chip_smoke.PROFILE_STEPS`), and phase 15
(data-parallel training of smollm-360m, every run and check of the
phase) once for each depth of `--dp-depths`; `--also` runs phase 14
(trunk-sharded serving) and phase 16 (the model axis in training) once
each at the script's own settings, with all their checks. Each run
prints its seconds; the last line is a JSON object of them. Needs a CUDA
card.
"""
import argparse
import gc
import json
import os
import sys
import time
import traceback

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-steps", default="2,10")
    ap.add_argument("--dp-depths", default="16,32")
    ap.add_argument("--also", default="",
                    help="phases 14 and/or 16, once each")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("phase_seconds: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import build_engine
    chip_smoke.log(chip_smoke.smi_line())
    _build.load()
    chip_smoke.share_mask_stores()
    out = {"phase 6": {}, "phase 15": {}}
    also = {"14": chip_smoke.phase_trunk, "16": chip_smoke.phase_model_axis}
    engine, _, _ = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda")
    for window in map(int, args.profile_steps.split(",")):
        chip_smoke.PROFILE_STEPS = window
        t0 = time.perf_counter()
        chip_smoke.phase_forward_breakdown(torch, engine)
        out["phase 6"][window] = time.perf_counter() - t0
        chip_smoke.log(f"[phase 6, profiled window {window}: "
                       f"{out['phase 6'][window]:.1f} s]")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    for depth in map(int, args.dp_depths.split(",")):
        t0 = time.perf_counter()
        chip_smoke.phase_data_parallel(torch, np, depth=depth)
        out["phase 15"][depth] = time.perf_counter() - t0
        chip_smoke.log(f"[phase 15 at {depth} layers: "
                       f"{out['phase 15'][depth]:.1f} s]")
    failed = []
    for phase in filter(None, args.also.split(",")):
        t0 = time.perf_counter()
        try:        # one phase's failure leaves the next one's reading
            also[phase](torch, np)
        except Exception:
            traceback.print_exc()
            failed.append(phase)
        out[f"phase {phase}"] = time.perf_counter() - t0
        chip_smoke.log(f"[phase {phase}: {out[f'phase {phase}']:.1f} s"
                       f"{', FAILED' if phase in failed else ''}]")
        gc.collect()
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
