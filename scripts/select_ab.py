#!/usr/bin/env python3
"""Time one source tree's fused_select on the card, for parent/change A/B.

    python3 scripts/select_ab.py <tree>

`<tree>` is a checkout of this repository (for example a `git archive`
of the parent commit unpacked into the gitignored `build/`). The script
loads that tree's `repro_torch` (building its kernels into the tree's own
`build/kernels/`), makes `chip_smoke.py`'s phase-4 inputs (B=8, V=49152,
real json mask-store rows, seeded bf16 logits and noise) and prints one
line `AB {json}` with the event and device ms per call (`cuda_ms`,
`device_ms` of this checkout's `chip_smoke.py`) for four input sets:

- `mix`: phase 4's rows (greedy flags, top_k 0/40, top_p 0.95/1.0);
- `k40_p095`: every row sampled with top_k 40, top_p 0.95;
- `k0_p095`: every row sampled with top_k 0, top_p 0.95;
- `greedy_mode`: phase 4's rows with no noise (the all-greedy variant).

Each set is also checked once against the plain version (masked and ok
bitwise, ids equal row by row). Run each tree in a fresh process and
alternate them in one call (parent, change, change, parent): two calls
may land on different cards.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, HERE)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import (fused_select_ref,
                                                       gumbel_noise)
    from repro_torch.core.constrain import GrammarConstraint, MAX_ACCEPT
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.mask_store import build_mask_store
    from repro_torch.core.tokenizer import ByteTokenizer
    if not torch.cuda.is_available():
        print("select_ab: no CUDA device", file=sys.stderr)
        return 2
    if not _build.__file__.startswith(tree):
        raise RuntimeError(f"loaded {_build.__file__}, not {tree}'s")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    B, V = 8, 49152
    tok = ByteTokenizer(V)
    g, tab = load_grammar("json")
    store_np = build_mask_store(g, tok)
    store = torch.from_numpy(store_np.packed.view(np.int32)).to(dev)
    W = store.shape[1]
    texts = [b"", b"{", b'{"a', b'{"key": ', b"[1, 2", b'"str', b"tru",
             b'{"a": [1, {"b": nu']
    cons_on = [True, True, True, False, True, True, False, True]
    cons = [GrammarConstraint(g, tab, store_np, tok) if c else None
            for c in cons_on]
    rows, eos, _, groups = GrammarConstraint.ci_rows_batch(
        cons, texts, max_accept=MAX_ACCEPT)
    cd = GrammarConstraint.cd_overlay_batch(cons, groups, W)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev).to(dt)
    every = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
    base = (t(rows, torch.int32), t(cd.view(np.int32), torch.int32),
            t(eos, torch.bool), t(np.array(cons_on), torch.bool))
    greedy = t(np.array([0, 1, 0, 0, 1, 0, 0, 0], bool), torch.bool)
    temp = t(np.array([0.8, 1.0, 0.7, 1.3, 0.8, 0.9, 1.0, 0.5],
                      np.float32), torch.float32)
    top_k = t(np.array([0, 40, 40, 0, 40, 0, 40, 0], np.int32),
              torch.int32)
    top_p = t(np.array([0.95, 1.0, 0.95, 1.0, 0.95, 0.95, 1.0, 0.95],
                       np.float32), torch.float32)
    rng = np.random.default_rng(1)
    logits = t(rng.normal(scale=3.0, size=(B, V)).astype(np.float32),
               torch.bfloat16)
    keys = rng.integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32)
    noise = gumbel_noise(keys, V, dev)
    sampled = every(False, torch.bool)
    sets = {"mix": (greedy, top_k, top_p, noise),
            "k40_p095": (sampled, every(40, torch.int32),
                         every(0.95, torch.float32), noise),
            "k0_p095": (sampled, every(0, torch.int32),
                        every(0.95, torch.float32), noise),
            "greedy_mode": (greedy, top_k, top_p, None)}
    out = {"tree": tree, "build_s": build_s, "device": cs.smi_line()}
    for name, (gr, k, p, nz) in sets.items():
        args = (logits, store, *base, gr, temp, k, p)
        run = lambda: fused_mask_select(*args, noise=nz)
        ik, mk, ok_k = run()
        ir, mr, ok_r = fused_select_ref(*args, noise=nz)
        torch.cuda.synchronize()
        out[name] = {
            "cuda_ms": cs.cuda_ms(torch, run),
            "device_ms": cs.device_ms(torch, run),
            "masked_ok_equal": bool(
                torch.equal(mk.view(torch.int16), mr.view(torch.int16))
                and torch.equal(ok_k, ok_r)),
            "ids_equal_rows": int((ik == ir).sum())}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
