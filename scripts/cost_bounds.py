#!/usr/bin/env python3
"""The bound of each kernel row of PERF.md §6, recomputed from the static
cost count (`repro_torch.distributed.cost`) at the row's shapes.

    PYTHONPATH=src python scripts/cost_bounds.py

No card: the figures are counts over the H100 SXM5's published rates
(`launch/mesh.py`: 989 TFLOP/s bf16, 3.35 TB/s). `cost.py` counts the
reference's fixed work: attention over every KV block `chunked_attention`
computes (the blocks above the causal diagonal included) and over every
page a table names, the backward as two products per forward product,
and for the fused select every one of a row's A store rows, the noise
and the masked logits. `chip_smoke.py` counts what each run's data needs
(visible pairs, distinct pages, the union of the rows), so a row whose
work depends on the data moves. Prints one line per row:
`row, shape, FLOPs, bytes, bound ms, by`.
"""
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import cost  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402

# smollm-360m, one layer: 15 / 5 heads of 64, bf16
CFG = replace(get_config("smollm-360m"), num_layers=1)
H, K, Dh, W = 15, 5, 64, 2


def attention_flops(by: dict) -> float:
    return by["attn.scores"] + by["attn.pv"]


def line(row, shape, flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16 * 1e3, nbytes / HBM_BW * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"{row} | {shape} | {flops:.0f} | {nbytes:.0f} | "
          f"{max(t_ops, t_bytes):.6f} | {by}")


def main():
    # 1: fused_select, phase 4: B 8, V 49152, bf16, the engine's A 48,
    # sampled rows (noise read)
    c = cost.mask_sample(8, 49152, 48, itemsize=W, sampled=True)
    line(1, "B 8, V 49152, A 48, bf16, sampled", c["flops"], c["hbm_bytes"])
    # 2: flash_attention, phase 4: [1,S,15,64] over [1,S,5,64]
    for S in (16, 2048):
        by = cost.prefill(CFG, 1, S)["by_contraction"]
        nbytes = (2 * S * H * Dh + 2 * S * K * Dh) * W      # q, o, k, v
        line(2, f"[1,{S},15,64] causal", attention_flops(by), nbytes)
    # 5: paged_attention_span, phase 4: B 8, 32 pages of 16 a row
    for S in (1, 8, 32):
        by = cost.paged_feed(CFG, 8, S, 32, 16)["by_contraction"]
        nbytes = (8 * (32 * 16 + S) * 2 * K * Dh * W      # pool, writes
                  + 2 * 8 * S * H * Dh * W + 8 * 32 * 4 + 8 * 4)
        line(5, f"B 8, S {S}, 32 pages of 16", attention_flops(by), nbytes)
    # 2b: the attention backward, phase 9: [8,1024,15,64] over 5 heads;
    # the train step counts the forward product once and its two
    # gradient products, so the backward is two thirds of it
    by = cost.train_step(replace(CFG, remat=False), 8, 1024)[
        "by_contraction"]
    B, S = 8, 1024
    nbytes = (4 * B * S * H * Dh + 4 * B * S * K * Dh) * W + B * H * S * 4
    line("2b", "[8,1024,15,64] causal backward",
         attention_flops(by) * 2 / 3, nbytes)


if __name__ == "__main__":
    main()
