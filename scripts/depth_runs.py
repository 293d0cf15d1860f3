#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase-11 model-level checks once at depths the
smoke run cuts for its time, on one card.

    python3 scripts/depth_runs.py

llama-3.2-vision-90b at 30 of its 100 layers (6 periods of 4 attn + 1
cross, 27.77 B params, 55.5 GB in bf16; the smoke run keeps 10) and
deepseek-coder-33b at all 62 layers (66.7 GB; the smoke run keeps 8),
through the same functions as the smoke run (`vlm_decode`,
`text_config_check`): prefill B 8 x 16, greedy decode steps, their logits
against a fresh prefill, flash launches counted, peak memory and one
decode step's breakdown (vlm). The decode logits are held against a
fresh prefill within ULPS bf16 ulps at the largest logit, twice the smoke
run's four: the decode path (plain attention over the cache) and the
prefill path (the flash kernel) round apart in bf16, and the gap grows
with depth (at 30 vlm layers it reached 0.1289 at step 31, above the four
ulps, 0.125, that 10 layers meet). Prints the card's name and power limit
first; fails without a card.
"""
import gc
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

VLM_LAYERS = 30
ULPS = 8


def main():
    import torch
    if not torch.cuda.is_available():
        print("depth_runs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    cs.log(f"device: {cs.smi_line()}; torch {torch.__version__}")
    _build.load()
    counters = (attention, attention_backward)
    cs.vlm_decode(torch, counters, [], depth=VLM_LAYERS, ulps=ULPS)
    gc.collect()
    torch.cuda.empty_cache()
    cs.text_config_check(torch, counters, "deepseek-coder-33b", None,
                         ulps=ULPS)
    cs.log(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
