#!/usr/bin/env python3
"""Time one source tree's attention backward on the card, for parent/change
A/B.

    python3 scripts/attention_bwd_ab.py <tree>

`<tree>` is a checkout of this repository (for example a `git archive` of
the parent commit unpacked into the gitignored `build/`). The script
loads that tree's `repro_torch` (building its kernels into the tree's own
`build/kernels/`), makes `chip_smoke.py`'s phase-9 inputs for each of its
`BWD_CASES` (seeded q, k, v and dO at the training shapes; the forward
kernel's output and LSE), checks `attention_backward` once against the
plain version (`ref.attention_bwd`: the largest error of dq, dk and dv
as a share of the plain version's largest magnitude) and prints one line
`AB {json}` with the event and device ms per call (`cuda_ms`,
`device_ms` of this checkout's `chip_smoke.py`), each launch's device ms
per call by kernel (`split_ms`: dot, dK/dV, dQ, from torch.profiler over
20 calls) and the tree's `-Xptxas -v` report of its backward kernels
(registers, spill bytes). Run each tree in a fresh process and alternate
them in one call (parent, change, change, parent): two calls may land on
different cards.
"""
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split_ms(torch, run, reps=20):
    """Device ms per call of each kernel `run` launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            m = re.search(r"bwd_\w+?kernel", e.key)
            name = m.group(0) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total \
                / reps / 1e3
    return out


def main(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        attention_backward, attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd
    if not torch.cuda.is_available():
        print("attention_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"loaded {_build.__file__}, not {tree}'s")
    t0 = time.perf_counter()
    _build.load()
    out = {"tree": tree, "build_s": time.perf_counter() - t0,
           "device": cs.smi_line(), "cases": []}
    log = (_build.BUILD_DIR / f"build_{_build.source_hash()}.log")
    if hasattr(_build, "ptxas_report") and log.exists():
        out["ptxas"] = {cs.short_kernel(r["kernel"]): [
            r["registers"], r["spill_stores"], r["spill_loads"]]
            for r in _build.ptxas_report(log.read_text())
            if "bwd_" in r["kernel"]}
    for model, B, S, H, K, Dh, window, dt in cs.BWD_CASES:
        q, k, v, do = cs.bwd_case_inputs(torch, B, S, H, K, Dh, dt)
        o, lse = attention_with_lse(q, k, v, causal=True, window=window)
        run = lambda: attention_backward(q, k, v, o, lse, do, causal=True,
                                         window=window)
        rel = max((a.float() - b.float()).abs().max().item()
                  / b.float().abs().max().item()
                  for a, b in zip(run(), attention_bwd(
                      q, k, v, o, lse, do, causal=True, window=window)))
        out["cases"].append({
            "model": model, "shape": [B, S, H, K, Dh], "window": window,
            "dtype": dt, "max_rel_err": rel,
            "cuda_ms": cs.cuda_ms(torch, run),
            "device_ms": cs.device_ms(torch, run),
            "split_ms": split_ms(torch, run)})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
