#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from `src/repro_torch/csrc` (sm_90a) and print
   the build seconds;
3. model check: syncode-demo in fp32 on the card (kernels) against the
   same weights on the CPU (plain versions): prefill and decode logits;
4. kernel phase at the served shapes, each kernel against its plain
   version on the card and timed with CUDA events (median of 25) beside
   the plain version, its bound and, where one PyTorch call computes the
   same function, that call:
   `fused_select` (B=8, V=49152, real json mask-store rows; sample and
   greedy mode, and every row sampled at top_p 0.95 with top_k 40 or
   with top_k 0),
   `flash_attention` ([1,S,15,64] q, [1,S,5,64] k/v, bf16, S in
   7/32/300/2048, plus an fp32 mask-exactness check),
   `masked_logits` and `masked_logits_span` (B=8 and the sequential
   path's B=1, K=8 spans, V=49152, real json rows, constrained=False
   rows; at the engine's accept bucket A=48 and at A=384 with one row of
   384 ids; bitwise, bf16 and fp32; beside them one masked_fill over the
   unpacked mask as a floor for one elementwise pass),
   `paged_attention_span` (B=8, 15/5 heads, Dh 64, 16-token pages, 32
   pages per slot, a 256-page pool with holes and shared pages, S in
   1/8/32, bf16 and fp32; its decode form `paged_attention_decode` at
   S=1); every kernel and yardstick also gets its own device time per
   call (`device_ms`: torch.profiler's summed kernel time), which leaves
   out the wrapper's host work that the event window holds;
5. end-to-end at smollm-360m full width (random weights from a seed),
   json + jsonmsg, each run with the kernels' launch counters zeroed
   just before it and read just after, every eos-finished output
   parsed: dense `generate()` (16 requests, half greedy, half sampled,
   64 new tokens), then a devtime run of its first 8; `generate_speculative`
   over dense caches (the same 16); paged `generate()` (the same 16 plus
   8 sharing a >= 256-token prefix); `generate_speculative` over pages
   (8 requests x 32 new tokens); `generate_sequential` (4 x 32);
6. decode step breakdown at full width, forward + fused_select, for a
   dense decode step and a paged one (B=8, 32 pages per slot): host
   dispatch, synced wall and profiler-measured device busy time per step,
   the kernels that take most of it, fused_select's device ms per step
   and share in both, and paged_attention's in the paged step;
7. the live front end on the same engine: the port's `EngineServer` over
   an `AsyncEngine` on 127.0.0.1 streams phase 5's 16 requests (NDJSON,
   concurrent stdlib clients), each stream's chunks checked against its
   terminal line and every eos output parsed; a client that disconnects
   mid-stream frees its slot; an `AsyncEngine` over a paged engine serves
   the 8 shared-prefix requests with one cancelled mid-decode and gets
   its pages back; `POST /grammars` hot-loads a grammar that then serves
   a valid request; `/metrics`, `/stats` and `POST /profile` (whose dump
   must hold device events of `fused_select_kernel`); then opportunistic
   masking, `generate()` over 8 of the requests x 32 new tokens and
   `generate_sequential` over 4 x 32. Each run's launch counters are zeroed just before it and
   read just after;
8. architectures: mamba2-370m (ssm, 24 of 48 layers, V 50280),
   recurrentgemma-9b (hybrid RG-LRU + local attention, all 38 layers,
   head_dim 256, MQA, window 2048, V 256000) and qwen3-moe-30b-a3b (moe,
   full width: 128 experts top-8, 32/4 heads, head_dim 128, V 151936; 4
   of its 48 layers), each built in turn through `build_engine` with
   seeded random weights and freed before the next. Kernel checks at each
   model's shapes, as in phase 4 (event and device ms, plain version,
   bound, sdpa where it computes the same function): fused_select greedy
   and sampled at B=8 and the model's V (bitwise; 50280 is not a
   multiple of 32); flash_attention at the prompt bucket and 2048 keys
   ([1,S,16,256] q over one KV head with window 2048, plus 4096 keys
   where half fall out of the window; [1,S,32,128] over 4 KV heads), fp32
   masks exact and bf16 within 2**-5; paged_attention_span at qwen3-moe's
   heads (S = 1 and 8); masked_logits at V 50280 (B = 1, 8) and
   masked_logits_span at V 151936 (B = 8, K = 8), bitwise; the RG-LRU
   prefill scan's cost. Then, each run counted on its own, 8 requests x
   32 new tokens in 8 slots (phase 5's mix): dense `generate()` for all
   three; `generate_sequential` (4 x 16) for mamba2; paged `generate()`
   and `generate_speculative` for qwen3-moe; and one dense decode step's
   breakdown per model;
9. training: first the attention backward kernels' compiler report
   (`-Xptxas -v` in the build log: registers, spill bytes and stack of
   each of the dot, dK/dV and dQ kernels per head_dim and dtype, and each
   pass's dynamic shared memory from the library; a bf16 backward kernel
   that spills fails the phase); then the backward kernel (bf16:
   `mma.sync` tensor-core products over swizzled tiles that `cp.async`
   fills; fp32: FMA tiles) against its plain version at the training
   shapes (smollm-360m [8,1024,15,64] over 5 KV heads and fp32
   [2,1024,15,64]; qwen3-moe [4,1024,32,128] over 4; recurrentgemma
   [2,4096,16,256] over 1 with window 2048), fed the forward kernel's LSE
   (whose output must equal the plain forward launch's bit for bit),
   timed beside the plain version, its bound and one sdpa forward and
   backward; then smollm-360m trained at full width (all 32 layers,
   remat on) for 20 AdamW steps on `GrammarDataPipeline` json batches (B
   8, S 1024): every loss finite, the last at least 1.0 below the first,
   the forward and backward attention counters exactly 32 x 20 x 2 and
   32 x 20; a profiled train step; the checkpoint saved, served through
   `build_engine(..., checkpoint=)` (4 json requests x 32 new tokens,
   every eos output parsed) and loaded back equal leaf for leaf; then 5
   steps each of mamba2-370m (24 of 48 layers, B 4, S 1024), qwen3-moe
   (2 of 48 layers, B 4, S 1024) and recurrentgemma-9b (3 of 38 layers,
   one (rec, rec, attn) block, B 2, S 4096), each freed before the next;
10. the audio family, whisper-base (6 encoder + 6 decoder layers, d_model
   512, 8 heads of 64, V 51865, bf16, seeded random weights): first the
   reduced config in fp32 on the card against the CPU (40 tokens over 32
   frames: cross attention at Sq > Sk) and fp32 non-causal edges exact
   (keys past Sk contribute nothing); then the non-causal attention
   kernels, forward and backward, against their plain versions at the
   path's shapes (encoder [8,1500,8,64] over 1500; cross [8,16,8,64] and
   [8,1,8,64] over 1500, bf16; training [16,1500,8,64] and
   [16,448,8,64] over 1500 in fp32, the decoder's causal [16,448,8,64]
   in bf16) and at edges (Sq > Sk
   [2,2048,8,64] over 1500, GQA 8 over 2, fp32), each timed beside the
   plain version, its bound and sdpa (forward; forward + backward); then
   the model at full width: prefill B 8 with [8,1500,512] bf16 frames
   and a 16-token prompt, 32 greedy decode steps (counters zeroed just
   before, read just after: flash launches must be 6 encoder + 12 at
   prefill + 6 cross a step), the logits of steps 0, 15 and 31 against a
   fresh prefill of the extended prompt; then 10 training steps through
   `repro_torch.launch.train.main --arch whisper-base --grammar random`
   (B 16 x S 448, Whisper's text context; every loss finite; attention
   launches 18 a step, forward twice with remat, backward once), its
   checkpoint loaded back with the same logits, and the same model fitted
   to one batch for 10 steps (the loss must fall). fp32 frames run the
   encoder in fp32 (the reference's promotion), so the training encoder
   and cross attention take the fp32 kernel route;
11. the vlm family, llama-3.2-vision-90b (d_model 8192, 64/8 heads of
   128, d_ff 28672, V 128256, 1601 image tokens, a `cross` layer every
   fifth; bf16, seeded random weights, every tanh gate opened to 0.5,
   since at its init zero a cross layer adds nothing): the reduced config
   in fp32 on the card against the CPU; the attention kernels against
   their plain versions at the path's shapes (self and cross at prefill
   [8,16,64,128] over 16 and 1601 keys, cross at a decode step over
   1601, training [2,1024,64,128] causal and cross over 1601 on the fp32
   route) and at edges (Sq > Sk over 1601, an odd Sk of 17 in both
   dtypes); 10 of its 100 layers (2 periods) prefilled with [8, 1601,
   8192] bf16 image embeddings and decoded 32 greedy steps (counters
   zeroed just before, read just after: flash launches by shape, 8 self
   + 2 cross at prefill + 2 cross a step), the logits of steps 0, 15, 31
   against a fresh prefill, other image embeddings moving the logits,
   one step's breakdown; one period (5 layers) with one chip's share of
   an 8-way vocabulary split (16032 rows) trained 5 AdamW steps on the
   random pipeline's first batch (B 2 x S 1024, fp32 image embeddings),
   the loss falling, launches exact, peak memory beside the steady
   state; then qwen1.5-0.5b, internlm2-1.8b (all 24 layers each),
   deepseek-coder-33b (8 of 62) and kimi-k2-1t-a32b (its dense layer and
   one MoE layer of 384 experts) at full width: each prefill's attention
   kernel row, prefill B 8 x 16, 8 greedy steps, the logits of steps 0
   and 7 against a fresh prefill (kimi: rows whose token each run routed
   to the same experts);
12. tensor-parallel serving (`Engine(mesh=...)`, vocab parallelism over
   `torch.distributed`), smollm-360m at full width: a 1-rank world over
   NCCL in this process (`launch.mesh.spawn`) serves phase 5's first 8
   requests at 32 new tokens through the unsharded and the sharded
   engine on the same weights, two runs each in alternating order
   (identical tokens, each request a prefix of its phase 5 stream; the
   median and range of each side's ms a step), phase 5's speculative run
   and its paged run with the shared prefix (identical tokens), each run's
   launch counters zeroed just before it and read just after (sharded:
   masked_logits once a step); the all-gather and the embedding
   all-reduce timed alone; then a 2-rank world on the one card over gloo
   (NCCL refuses two ranks on one device), two spawned processes each
   holding half the vocabulary (24576 ids, 768 store words): the 8
   requests, tokens equal to the unsharded engine's, masked_logits
   launched once per constrained step on each rank, every eos output
   parsed; then the shard-local masked_logits row and span forms at V
   50280 split 25152 + 25128 (real json rows): both shards joined bitwise
   equal to the unsharded kernel with EOS in each shard in turn, rank 0's
   block timed beside its plain version and bound;
13. the static cost count (`distributed/cost.py`) and the dry run
   (`launch/dryrun.py`): smollm-360m at full width served dense and
   paged with devtime on (phase 12's 8 requests x 32 new tokens, each
   run's counters zeroed just before and read just after: fused_select
   and flash, fused_select and paged attention must launch); for
   `forward` and `mask_sample` the calls, seconds, FLOPs and bytes a
   call and the achieved TFLOP/s and TB/s beside the bf16 peak and HBM's
   rate; the decode step's FLOPs (B 8, 512 cache positions) equal to
   FlopCounterMode's count on the card; the dry run of every config x
   shape on both production meshes on the meta device (88 records, the
   card's memory untouched); the estimate at phase 9's smollm train
   shape on one card beside phase 9's measured peak, which must hold at
   least the params, moments and batch;
14. trunk-sharded serving (`Engine(mesh, trunk_shard=True)`: Megatron
   column/row blocks with explicit all-reduces, kv-head-sharded caches
   and pools, expert-parallel MoE; where M does not divide the kv heads,
   the sequence split: column blocks that cut inside heads gathered into
   whole heads, each rank holding its share of the cache's positions and
   of every page's offsets, a partial attention with its log-sum-exp per
   rank and the partials joined), a 2-rank gloo world on the one card,
   bf16 at full width: qwen1.5-0.5b (all 24 layers, 16/16 heads, QKV
   bias, d_ff 2816, V 151936), qwen3-moe-30b-a3b (phase 8's 4 layers,
   32/4 heads, 128 experts top-8), smollm-360m (all 32 layers, 15/5
   heads: the sequence split, max_len 64 so that
   both ranks' shares hold
   positions of the requests), mamba2-370m (all 48 layers: w_in columns,
   conv channels, SSD heads and w_out rows split, the projection and the
   conv output gathered, the gated norm's statistic carried in the w_out
   all-reduce) and recurrentgemma-9b (9 layers, three (rec, rec, attn)
   periods: the RG-LRU width split, the conv output gathered for the
   gates; its 16/1-head local attention on the sequence split of a
   48-position ring), each rank drawing only its blocks
   (`build_engine(..., trunk_shard=True)`); one spawned world serves the
   models in turn. First the partial paged kernel
   (`paged_attention_partial`) at smollm's rank-local pool (phase 4's
   pool cut to one rank's 8 offsets of each 16-position page, S = 1, 8
   and 32, both ranks, bf16 and fp32) against its plain version, timed
   beside it, its bound and sdpa. Against the one-device engine on the
   same seeded weights (run first in this process): the first decode
   step's logits over 8 seeded prompts (16 tokens; smollm 32, so the
   step's own position is rank 1's first) within TRUNK_ULPS bf16 ulps at
   the largest logit (TRUNK_FAMILY_ULPS for mamba2 and recurrentgemma;
   MoE: rows whose token every layer routed alike); phase 12's
   requests, TRUNK_CUT's count x new tokens (smollm 8 x 4, the others
   4 x 4), dense, paged and speculative on both sides (the recurrent
   families: dense, and sequential on the sharded side, TRUNK_SEQ),
   each run counted on its
   own (flash once per layer per admission at the local H/2 q and K/2 kv
   heads, or every head under the sequence split, paged attention once
   per layer per feed at them, the partial form under the sequence
   split, masked_logits once per constrained step, masked_logits_span
   once per span step, fused_select at least once a step; sequential:
   flash once per attention layer per request, masked_logits once per
   constrained step), every flash call's output (the last 16 of a run)
   against the plain version on the same inputs, every eos
   output parsed and every output
   walked by the oracle (`is_valid_extension`), ms a step beside the
   one-device engine's and the share of requests identical printed, not
   required; under the sequence split, the live positions in each
   rank's share of the first step's cache and the positions each run fed
   into it, each above 0; smollm's partial paged kernel on the paged
   run's own calls (each layer's of the last feed of each width) against
   its plain version, bf16 and fp32; one decode step's collective tally
   beside `distributed/cost.py`'s wire count; each rank's param bytes,
   dense cache bytes by leaf (k, v, kv_pos; the recurrent state h and
   the conv cache) and page pool bytes equal to the trunk specs'
   argument bytes, its peak while building below the whole tree's
   bytes, its peak beside the specs' params + caches + pools; then an
   fp32 copy at 2 layers (recurrentgemma 3): 16 greedy steps of 8 rows
   through both sides, identical up to each row's first near-tie.
   Then the head_dim and replicated cache branches (TRUNK_SPLITS):
   smollm-360m at 8 of 32 layers, served 4 x 4 by the 2-rank world at
   max_len 63 with pages of 9 (M divides neither them nor the 5 kv heads,
   but head_dim: each rank holds 32 of its 64 channels; dense, paged,
   speculative) and by a 3-rank world at max_len 64 with pages of 16
   (every rank holds the whole cache; dense, paged), held to the same
   checks against a one-device twin at 8 layers (fp32 at 2 layers, max_len
   33 and 32), each rank's plan holding the expected branch; the paged
   kernel's head_dim form (`paged_attention_scores`,
   `paged_attention_values`) timed first at the head_dim world's pool
   beside its bound, plain version and the einsums on the gathered view,
   then on the paged run's own calls against its plain version; the
   build-peak check is not applied to these 8-layer runs (the vocabulary
   draw outweighs 8 layers). The ranks reuse the parent's mask stores
   (`share_mask_stores`);
15. data-parallel training (`train(..., mesh=make_train_mesh(2))`: the
   reference's sharded train step on a (data 2, model 1) mesh) of
   smollm-360m at full width and 16 of 32 layers in bf16 over a 2-rank
   gloo world on the one card (NCCL takes one card a rank), on phase 9's
   json batches (B 8 x S 1024, the first 3) with a planted loss_mask
   whose counts differ between the ranks and the microbatches: plain DP
   + ZeRO-1, FSDP forced and microbatch 2, 3 steps each, against the
   one-device port step on the same seeded weights and batches
   (`train()` with no mesh; at microbatch 2 its plain accumulation):
   each step's loss and gnorm within DP_BF16_REL relative; fp32 copies
   at 2 layers stepped beside the one-device twin on rank 0, set to the
   run's own params and moments before each step with its own step
   counter (each step's loss and moments within DP_FP32_REL; the params
   by the one-device parity test's rule, its |mu|-sure elements where
   their clipped gradient is at least 100 eps; the last step's new params
   within DP_UPDATE_REL of the AdamW formula on the run's own gathered
   params and moments), and against the same twin run free from the
   seeded weights (loss, gnorm and moments of every step within
   DP_FREE_REL); each rank's param, moment and accumulator bytes
   equal to the specs' (`train_plan`); the attention launches (16 layers
   x steps x microbatches, the forward twice under remat); the
   collectives a step against `cost.train_step`'s count; the flash
   forward and backward kernels on the run's own calls against their
   plain versions; ms a step after the first beside the twin's, and the
   gloo calls' ms;
16. the model axis in training (`train(..., mesh=make_train_mesh(D,
   M))`: the reference's sharded train step on a (data, model) mesh,
   Megatron blocks with their backward collectives, the
   vocabulary-parallel loss): run A, qwen1.5-0.5b at full width and all
   24 layers (16/16 heads, QKV bias) on a (data 2, model 2) world of 4
   gloo ranks; run B, smollm-360m at 8 of 32 layers (15/5 heads: q/k/v
   cut inside heads and gathered; tied) on a (data 1, model 2) world;
   bf16, phase 15's batches, 3 steps, each against its one-device twin
   (loss and gnorm within MA_BF16_REL), fp32 copies at 2 layers by
   phase 15's rules, each rank's bytes against the specs', the
   collectives against `cost.train_step`'s (`ma_tally_check`), the
   flash kernels on the run's own calls, ms a step and gloo's ms.

The last lines are the card's name and power limit, the kernels JSON
line, and `{"ok": true, "device": {...}}`.
"""
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
REPS = 25


def log(*a):
    print(*a, flush=True)


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=REPS, warmup=3):
    """Median device milliseconds of one call (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps=REPS, warmup=3):
    """Device milliseconds per call of the kernels `fn` launches, from
    torch.profiler over `reps` calls: for each kernel name its mean time
    times its launches per call (its count over `reps`, rounded, at least
    one, so that an event the profiler drops does not read as a faster
    call), summed over the names. Unlike `cuda_ms` it leaves out the host
    work before each launch. If the profiler sees no device time in two
    tries, a burst of 100 back-to-back calls between two CUDA events
    stands in (and says so): that holds the host time wherever the host
    is slower than the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / reps))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count)
        if us > 0:
            return us / 1e3
    log("  device_ms: the profiler saw no device time; timing a burst of "
        "100 back-to-back calls between two CUDA events instead")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(100):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 100


# ------------------------------------------------------------------ phases

def phase_model_check(torch, np):
    """syncode-demo fp32: kernels on the card vs plain versions on CPU."""
    from dataclasses import replace
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = replace(get_config("syncode-demo"), dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(gen)
    gpu_model = build_model(cfg, device="cuda")
    gparams = bridge.to_device(params, "cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, size=(2, 24)).astype(np.int64)
    n = 19
    lc, cc = cpu_model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               cache_len=64, true_len=n)
    lg, cg = gpu_model.prefill(gparams,
                               {"tokens": torch.from_numpy(toks).cuda()},
                               cache_len=64, true_len=n)
    err_p = (lc - lg.cpu()).abs().max().item()
    tok = torch.from_numpy(toks[:, n])
    pos = torch.full((2,), n, dtype=torch.int32)
    dc, _ = cpu_model.decode_step(params, cc, tok, pos)
    dg, _ = gpu_model.decode_step(gparams, cg, tok.cuda(), pos.cuda())
    err_d = (dc - dg.cpu()).abs().max().item()
    kv_eq = bool((cc[0][0]["kv_pos"] == cg[0][0]["kv_pos"].cpu()).all())
    log(f"model check (syncode-demo fp32, card vs CPU plain): prefill max "
        f"abs err {err_p:.3e}, decode {err_d:.3e}, kv_pos equal {kv_eq} "
        f"(tolerance 1e-3)")
    if not (err_p <= 1e-3 and err_d <= 1e-3 and kv_eq):
        raise AssertionError("model on the card disagrees with the CPU")


def nucleus_edge_rows(torch, masked, temp, top_k, top_p, tol=1e-6):
    """Rows whose cumulative softmax mass comes within `tol` of top_p
    (there the sum order may decide the cutoff)."""
    from repro_torch.core.decoding import NEG_INF
    edge = set()
    scaled = masked.float() / torch.clamp(temp, min=1e-6)[:, None]
    V = scaled.shape[-1]
    for b in range(scaled.shape[0]):
        p = float(top_p[b])
        if p >= 1.0:
            continue
        k = int(top_k[b])
        row = scaled[b]
        srt = torch.sort(row, descending=True).values
        if 0 < k < V:
            row = torch.where(row < srt[k - 1], NEG_INF, row)
            srt = torch.sort(row, descending=True).values
        cum = torch.cumsum(torch.softmax(srt.double(), dim=-1), dim=-1)
        if float((cum - p).abs().min()) < tol:
            edge.add(b)
    return edge


def json_rows(torch, np, engine):
    """Eight decode rows of real json grammar state (two unconstrained),
    at the engine's accept bucket: -> (device store, rows [8, A], eos
    [8], residue words cd [8, W], constrained [8] bool)."""
    from repro_torch.core.constrain import GrammarConstraint, MAX_ACCEPT
    g, tab, store_np = engine.bundles["json"]
    store = torch.from_numpy(store_np.packed.view(np.int32)).to(
        torch.device("cuda"))
    texts = [b"", b"{", b'{"a', b'{"key": ', b"[1, 2", b'"str', b"tru",
             b'{"a": [1, {"b": nu']
    cons_on = np.array([True, True, True, False, True, True, False, True])
    cons = [GrammarConstraint(g, tab, store_np, engine.tok) if c else None
            for c in cons_on]
    rows, eos, _, groups = GrammarConstraint.ci_rows_batch(
        cons, texts, max_accept=MAX_ACCEPT)
    cd = GrammarConstraint.cd_overlay_batch(cons, groups, store.shape[1])
    return store, rows, eos, cd, cons_on


def phase_fused_select(torch, np, engine):
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import (fused_select_ref,
                                                       gumbel_noise)
    dev = torch.device("cuda")
    store, rows, eos, cd, cons_on = json_rows(torch, np, engine)
    B, V = 8, engine.model.cfg.vocab_size
    W = store.shape[1]
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev).to(dt)
    rows_t = t(rows, torch.int32)
    cd_t = t(cd.view(np.int32), torch.int32)
    eos_t = t(eos, torch.bool)
    cons_t = t(cons_on, torch.bool)
    greedy = t(np.array([0, 1, 0, 0, 1, 0, 0, 0], bool), torch.bool)
    temp = t(np.array([0.8, 1.0, 0.7, 1.3, 0.8, 0.9, 1.0, 0.5],
                      np.float32), torch.float32)
    top_k = t(np.array([0, 40, 40, 0, 40, 0, 40, 0], np.int32),
              torch.int32)
    top_p = t(np.array([0.95, 1.0, 0.95, 1.0, 0.95, 0.95, 1.0, 0.95],
                       np.float32), torch.float32)
    rng = np.random.default_rng(1)
    edge_total, mism_total, trials = 0, 0, 6
    max_err = 0.0       # masked logits, kernel vs plain
    for trial in range(trials):
        logits = t(rng.normal(scale=3.0, size=(B, V)).astype(np.float32),
                   torch.bfloat16)
        keys = rng.integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32)
        noise = gumbel_noise(keys, V, dev)
        args = (logits, store, rows_t, cd_t, eos_t, cons_t, greedy, temp,
                top_k, top_p)
        for nz in (None, noise):
            ik, mk, ok_k = fused_mask_select(*args, noise=nz)
            ir, mr, ok_r = fused_select_ref(*args, noise=nz)
            torch.cuda.synchronize()
            max_err = max(max_err,
                          (mk.float() - mr.float()).abs().max().item())
            if not torch.equal(mk.view(torch.int16), mr.view(torch.int16)):
                raise AssertionError("fused_select: masked differs")
            if not torch.equal(ok_k, ok_r):
                raise AssertionError("fused_select: ok differs")
            differ = set(np.nonzero((ik != ir).cpu().numpy())[0].tolist())
            if nz is None:
                if differ:
                    raise AssertionError(f"greedy ids differ on {differ}")
                continue
            edge = nucleus_edge_rows(torch, mk, temp, top_k, top_p)
            edge_total += len(edge)
            bad = differ - edge
            mism_total += len(differ)
            if bad:
                raise AssertionError(f"sampled ids differ on rows {bad} "
                                     f"away from the nucleus edge")
    log(f"fused_select: {trials} trials x B={B} V={V} W={W} A={rows.shape[1]}"
        f": masked/ok/greedy ids bitwise equal; sampled ids equal except "
        f"{mism_total} rows, all within 1e-6 of top_p; rows near the "
        f"nucleus edge: {edge_total}")
    logits = t(rng.normal(scale=3.0, size=(B, V)).astype(np.float32),
               torch.bfloat16)
    args = (logits, store, rows_t, cd_t, eos_t, cons_t, greedy, temp,
            top_k, top_p)
    ms = cuda_ms(torch, lambda: fused_mask_select(*args, noise=noise))
    dev_ms = device_ms(torch, lambda: fused_mask_select(*args, noise=noise))
    ms_greedy = cuda_ms(torch, lambda: fused_mask_select(*args))
    dev_greedy = device_ms(torch, lambda: fused_mask_select(*args))
    plain = cuda_ms(torch, lambda: fused_select_ref(*args, noise=noise))
    # the sampled path's two cases apart: every row sampled at top_p 0.95
    # with top_k 40 (list by rank) or top_k 0 (list by mass, or the radix
    # route where the nucleus overflows the list)
    every = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
    route_ms = {}
    for name, k in (("k40", 40), ("k0", 0)):
        rargs = (logits, store, rows_t, cd_t, eos_t, cons_t,
                 every(False, torch.bool), temp, every(k, torch.int32),
                 every(0.95, torch.float32))
        route_ms[name] = device_ms(
            torch, lambda: fused_mask_select(*rargs, noise=noise))
    # bytes the function must move: logits in, masked out, the union's
    # store rows and residue, and noise only where a sampled row's entry
    # survives the filter
    from repro_torch.core.decoding import NEG_INF, topk_topp_filter
    masked = fused_select_ref(*args)[1]
    scaled = topk_topp_filter(
        masked / torch.clamp(temp, min=1e-6)[:, None], top_k, top_p)
    survivors = int(((scaled > NEG_INF / 2) & ~greedy[:, None]).sum())
    n_rows = int((rows >= 0)[cons_on].sum())
    nbytes = (B * V * 2 * 2 + survivors * 4 + n_rows * W * 4 + B * W * 4
              + rows.size * 4 + B * (3 + 4 * 3 + 4 + 1))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"fused_select (sample mode) {ms:.4f} ms, device {dev_ms:.4f} "
        f"ms; greedy mode {ms_greedy:.4f} ms, device {dev_greedy:.4f} ms; "
        f"every row sampled, top_p 0.95: top_k 40 device "
        f"{route_ms['k40']:.4f} ms, top_k 0 device {route_ms['k0']:.4f} "
        f"ms; plain {plain:.4f} ms; bound "
        f"{bound:.6f} ms ({nbytes} bytes, {survivors} surviving entries)")
    return {"name": "fused_select", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_select.cu",
            "replaces": "src/repro/kernels/fused_select/kernel.py:96",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "device_ms": dev_ms, "greedy_ms": ms_greedy,
            "greedy_device_ms": dev_greedy,
            "sampled_k40_device_ms": route_ms["k40"],
            "sampled_k0_device_ms": route_ms["k0"], "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "library_device_ms": None}


def attention_rows(torch, np, model, H, K, Dh, cases, path_S):
    """flash_attention at one model's heads: fp32 masks exact (q = 0
    gives equal scores, so output channel c is the share of the visible
    keys whose position has bit c set), bf16 within 2**-5 of the plain
    version, timed beside the plain version and sdpa (`is_causal`, or
    the window as an explicit mask where it cuts). cases: (S, window).
    -> rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = []
    for S, window in cases:
        pos = np.arange(S)
        vis = pos[None, :] <= pos[:, None]
        if window:
            vis &= pos[None, :] > pos[:, None] - window
        nbits = max(1, (S - 1).bit_length())
        bits = ((pos[:, None] >> np.arange(nbits)[None, :]) & 1).astype(
            np.float32)
        vn = np.zeros((1, S, K, Dh), np.float32)
        vn[0, :, :, :nbits] = bits[:, None, :]
        out = attention(torch.zeros((1, S, H, Dh), device=dev),
                        t(rng.normal(size=(1, S, K, Dh)).astype(np.float32)),
                        t(vn), causal=True, window=window).cpu().numpy()
        want = (vis.astype(np.float64) @ bits) / vis.sum(1, keepdims=True)
        mask_err = np.abs(out[0, :, :, :nbits] - want[:, None, :]).max()
        if mask_err > 1e-5:
            raise AssertionError(f"flash_attention {model} S={S} window="
                                 f"{window}: fp32 mask differs ({mask_err})")
        q, k, v = (t(rng.normal(size=(1, S, n, Dh)).astype(np.float32))
                   .bfloat16() for n in (H, K, K))
        run = lambda: attention(q, k, v, causal=True, window=window)
        plain_fn = lambda: chunked_attention(q, k, v, causal=True,
                                             q_offset=0, window=window,
                                             chunk=1024)
        err = (run().float() - plain_fn().float()).abs().max().item()
        if not err <= 2.0 ** -5:
            raise AssertionError(f"flash_attention {model} S={S}: max abs "
                                 f"err {err} > 2**-5")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        amask = t(vis) if window and S > window else None   # else causal
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, is_causal=amask is None,
            enable_gqa=True)
        ms, dev_ms = cuda_ms(torch, run), device_ms(torch, run)
        plain = cuda_ms(torch, plain_fn)
        lib, lib_dev = cuda_ms(torch, sdpa), device_ms(torch, sdpa)
        flops = 4 * int(vis.sum()) * H * Dh      # QK^T and P.V, visible
        nbytes = (2 * S * H * Dh + 2 * S * K * Dh) * 2
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        shape = (f"q [1,{S},{H},{Dh}] k/v [1,{S},{K},{Dh}] bf16, window "
                 f"{window or 'none'}")
        log(f"flash_attention {model} {shape}: fp32 masks exact; bf16 max "
            f"abs err {err:.3e} (tol 2**-5); {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms; plain {plain:.4f} ms; sdpa {lib:.4f} ms, "
            f"device {lib_dev:.4f} ms; bound {bound:.6f} ms ({by})")
        rows.append({"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "kernel.py:71",
                     "model": model, "shape": shape,
                     "path_shape": S == path_S, "launches": 0,
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": lib, "library_device_ms": lib_dev})
    return rows


def phase_attention(torch, np, main_S):
    """flash_attention at smollm-360m's heads: fp32 masks exact on ragged
    and windowed shapes, then `attention_rows` at S in 7/32/300/2048 and
    the prompt bucket. -> the bucket's row, with the S = 2048 numbers as
    `long_prompt`."""
    from repro_torch.kernels.flash_attention.ops import attention
    dev = torch.device("cuda")
    H, K, Dh = 15, 5, 64

    # mask exactness in fp32: q = 0 gives equal scores, so each output
    # channel c is the share of VISIBLE keys whose position has bit c set
    for (Sq, Sk, window) in ((300, 300, 100), (2048, 2048, 700),
                             (5, 300, 0)):
        q = torch.zeros((1, Sq, H, Dh), device=dev)
        k = torch.randn((1, Sk, K, Dh), device=dev)
        pos = np.arange(Sk)
        bits = ((pos[:, None] >> np.arange(11)[None, :]) & 1).astype(
            np.float32)
        vn = np.zeros((1, Sk, K, Dh), np.float32)
        vn[0, :, :, :11] = bits[:, None, :]
        v = torch.from_numpy(vn).to(dev)
        out = attention(q, k, v, causal=True, window=window).cpu().numpy()
        qpos = np.arange(Sq) + (Sk - Sq)
        vis = (pos[None, :] <= qpos[:, None])
        if window:
            vis &= pos[None, :] > qpos[:, None] - window
        want = (vis.astype(np.float64) @ bits) / vis.sum(1, keepdims=True)
        err = np.abs(out[0, :, :, :11] - want[:, None, :]).max()
        if err > 1e-5:
            raise AssertionError(f"flash_attention mask differs: Sq={Sq} "
                                 f"Sk={Sk} window={window} err={err}")
    log("flash_attention: fp32 masks exact (window, right-aligned Sq < Sk)")
    sizes = sorted({7, 32, 300, 2048, main_S})
    rows = dict(zip(sizes, attention_rows(
        torch, np, "smollm-360m", H, K, Dh, [(S, 0) for S in sizes],
        main_S)))
    row = rows[main_S]
    row["long_prompt"] = {key: rows[2048][key] for key in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_device_ms")}
    row["long_prompt"]["S"] = 2048
    return row


def phase_masked_logits(torch, np, engine):
    """Both entry points, bitwise against the plain version, bf16 and
    fp32, on real json rows; timed at the sequential path's B=1, at B=8,
    and as the K=8 span, each at the accept bucket the engine launches
    (A = MAX_ACCEPT = 48) and at a wide one (A = 384, one row of 384 real
    ids). Beside them, one `masked_fill` over an already unpacked mask:
    an informational floor for one elementwise pass at this V (not the
    same function, so `library_ms` stays null)."""
    from repro_torch.core.constrain import MAX_ACCEPT
    from repro_torch.core.decoding import union_packed_rows, \
        unpack_mask_words
    from repro_torch.core.tokenizer import EOS_ID
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_span)
    from repro_torch.kernels.masked_logits.ref import (
        NEG_INF, masked_logits_ref, masked_logits_span_ref)
    dev = torch.device("cuda")
    store, rows, eos, cd, cons_on = json_rows(torch, np, engine)
    R, W = store.shape
    V = engine.model.cfg.vocab_size
    A = 8 * MAX_ACCEPT                    # a row at a wide accept bucket
    wide = np.full((8, A), -1, np.int32)
    wide[:, :rows.shape[1]] = rows
    wide[7] = np.random.default_rng(5).integers(0, R, A)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(6)
    out, floor, max_err = {}, {}, 0.0

    def check_and_time(key, fn, ref, args, kw, n_rows, rset, cset):
        nonlocal max_err
        bits = torch.int16 if key[2] == torch.bfloat16 else torch.int32
        mk, mr = fn(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(mk.view(bits), mr.view(bits)):
            raise AssertionError(f"masked_logits {key}: differs from the "
                                 f"plain version")
        max_err = max(max_err, (mk.float() - mr.float()).abs().max().item())
        out[key] = (cuda_ms(torch, lambda: fn(*args, **kw)),
                    device_ms(torch, lambda: fn(*args, **kw)),
                    cuda_ms(torch, lambda: ref(*args, **kw)),
                    _mask_bytes(np, args[0].numel() * args[0].element_size(),
                                rset.reshape(n_rows, -1), cset.reshape(-1),
                                W))
        if key[2] == torch.bfloat16 and key[3] == MAX_ACCEPT:
            x = args[0].reshape(n_rows, V)
            words = union_packed_rows(store, kw["cd"].new_tensor(
                rset.reshape(n_rows, -1))) | kw["cd"].reshape(n_rows, W)
            allow = unpack_mask_words(words, V)
            allow[:, EOS_ID] |= args[3].reshape(-1)
            allow |= ~kw["constrained"].reshape(-1, 1)
            floor[key[:2]] = (
                cuda_ms(torch, lambda: x.masked_fill(~allow, NEG_INF)),
                device_ms(torch, lambda: x.masked_fill(~allow, NEG_INF)))

    for dtype in (torch.bfloat16, torch.float32):
        for a, rset in ((A, wide), (MAX_ACCEPT, rows)):
            for B in (1, 8):
                logits = t(rng.normal(scale=3.0, size=(B, V)).astype(
                    np.float32)).to(dtype)
                args = (logits, store, t(rset[:B]), t(eos[:B]))
                kw = {"constrained": t(cons_on[:B]),
                      "cd": t(cd[:B].view(np.int32))}
                check_and_time(("row", B, dtype, a), apply_grammar_mask,
                               masked_logits_ref, args, kw, B, rset[:B],
                               cons_on[:B])
            K = 8
            logits = t(rng.normal(scale=3.0, size=(8, K, V)).astype(
                np.float32)).to(dtype)
            srows = np.repeat(rset[:, None], K, axis=1)
            scons = np.repeat(cons_on[:, None], K, axis=1)
            scons[:, K // 2:] &= rng.random((8, K - K // 2)) < 0.5
            sargs = (logits, store, t(srows),
                     t(np.repeat(eos[:, None], K, axis=1)))
            skw = {"constrained": t(scons),
                   "cd": t(np.repeat(cd[:, None], K, axis=1).view(
                       np.int32))}
            check_and_time(("span", 8, dtype, a), apply_grammar_mask_span,
                           masked_logits_span_ref, sargs, skw, 8 * K, srows,
                           scons)
    for (form, B, dtype, a), (ms, dev_ms, plain, nbytes) in out.items():
        log(f"masked_logits {form} B={B}{' K=8' if form == 'span' else ''} "
            f"{str(dtype)[6:]} A={a}: bitwise equal; {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms; plain {plain:.4f} ms; bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} bytes)")
    for (form, B), (ms, dev_ms) in floor.items():
        log(f"masked_logits {form} B={B} bf16: one masked_fill over the "
            f"unpacked mask (floor of one elementwise pass, not the same "
            f"function) {ms:.4f} ms, device {dev_ms:.4f} ms")
    row = lambda name, key, src_line: {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/masked_logits.cu",
        "replaces": f"src/repro/kernels/masked_logits/kernel.py:{src_line}",
        "launches": 0, "max_abs_err": max_err, "ms": out[key][0],
        "device_ms": out[key][1], "plain_ms": out[key][2],
        "bound_ms": out[key][3] / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "library_device_ms": None}
    return (row("masked_logits", ("row", 1, torch.bfloat16, A), 164),
            row("masked_logits_span", ("span", 8, torch.bfloat16, A), 112))


def _mask_bytes(np, logit_bytes, rows, cons, W):
    """Least bytes of one mask call: the logits read and written once,
    each distinct store row the constrained rows union read once, their
    residue words, and the row ids and flags."""
    need = rows[cons]
    distinct = np.unique(need[need >= 0]).size
    n = rows.shape[0]
    return (2 * logit_bytes + distinct * W * 4 + int(cons.sum()) * W * 4
            + rows.size * 4 + 2 * n)


def phase_paged_attention(torch, np, H=15, K=5, Dh=64, sizes=(1, 8, 32)):
    """paged_attention_span at one model's attention shapes (smollm-360m's
    by default) against the plain version, with sdpa on the gathered
    dense view as yardstick. -> {S: bf16 row}."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_decode)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    dev = torch.device("cuda")
    B, ps, nP, P = 8, 16, 32, 256
    L = nP * ps
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pt = rng.permutation(P)[:B * nP].reshape(B, nP).astype(np.int32)
    pt[:, 1:][rng.random((B, nP - 1)) < 0.15] = -1    # holes
    pt[1:4, :4] = pt[0, :4]                           # shared prefix pages
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-5
        kp = t(rng.normal(size=(P, ps, K, Dh)).astype(np.float32)).to(dtype)
        vp = t(rng.normal(size=(P, ps, K, Dh)).astype(np.float32)).to(dtype)
        for S in sizes:
            q = t(rng.normal(size=(B, S, H, Dh)).astype(np.float32)).to(
                dtype)
            pos = rng.integers(S, L - S, size=B).astype(np.int32)
            args = (q, kp, vp, t(pt), t(pos))
            ok = paged_attention(*args)
            orf = paged_attention_ref(*args)
            err = (ok.float() - orf.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"paged_attention S={S} {dtype}: max "
                                     f"abs err {err} > {tol}")
            ms = cuda_ms(torch, lambda: paged_attention(*args))
            dev_ms = device_ms(torch, lambda: paged_attention(*args))
            plain = cuda_ms(torch, lambda: paged_attention_ref(*args))
            safe = t(pt).clamp(min=0).long()
            kc = kp[safe].reshape(B, L, K, Dh).transpose(1, 2)
            vc = vp[safe].reshape(B, L, K, Dh).transpose(1, 2)
            qpos = t(pos)[:, None] + torch.arange(S, device=dev)[None, :]
            mapped = (t(pt) >= 0).repeat_interleave(ps, dim=1)
            mask = mapped[:, None, :] & (torch.arange(
                L, device=dev)[None, None, :] <= qpos[:, :, None])
            qt = q.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask[:, None], enable_gqa=True)
            lib = cuda_ms(torch, sdpa)
            lib_dev = device_ms(torch, sdpa)
            # this run's work: the mapped pages each slot reads up to its
            # last query, q and out once; 4 operations per (query head,
            # valid position, channel)
            m = mask.cpu().numpy()
            last = pos + S - 1
            pages = {int(pt[b, j]) for b in range(B) for j in range(nP)
                     if pt[b, j] >= 0 and j * ps <= last[b]}
            esz = q.element_size()
            nbytes = (2 * len(pages) * ps * K * Dh * esz
                      + 2 * B * S * H * Dh * esz + B * nP * 4 + B * 4)
            flops = 4 * int(m.sum()) * H * Dh
            peak = PEAK_FLOPS[str(dtype)[6:]]
            t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            log(f"paged_attention H={H} K={K} Dh={Dh} S={S} "
                f"{str(dtype)[6:]}: max abs err "
                f"{err:.3e} (tol {tol}); {ms:.4f} ms, device {dev_ms:.4f} "
                f"ms; plain {plain:.4f} ms; sdpa on the gathered view "
                f"{lib:.4f} ms, device {lib_dev:.4f} ms; bound "
                f"{bound:.6f} ms ({by})")
            if S == 1:
                # the [B, H, Dh] decode form launches the same kernel
                dargs = (q[:, 0], *args[1:])
                od = paged_attention_decode(*dargs)
                if not torch.equal(od, ok[:, 0]):
                    raise AssertionError(f"paged_attention_decode {dtype}: "
                                         f"differs from the span form")
                ms_d = cuda_ms(torch, lambda: paged_attention_decode(*dargs))
                dev_d = device_ms(torch,
                                  lambda: paged_attention_decode(*dargs))
                log(f"paged_attention_decode {str(dtype)[6:]}: equal to the "
                    f"span form at S=1; {ms_d:.4f} ms, device {dev_d:.4f} "
                    f"ms")
            if dtype == torch.bfloat16:
                rows[S] = {
                    "name": "paged_attention_span", "route": "cuda",
                    "source": "src/repro_torch/csrc/paged_attention.cu",
                    "replaces": "src/repro/kernels/paged_attention/"
                                "kernel.py:83",
                    "shape": f"B={B} S={S} H={H} K={K} Dh={Dh} bf16, "
                             f"{nP} pages of {ps}",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib,
                    "library_device_ms": lib_dev}
    log("  (sdpa's time leaves out the page gather: it reads the already "
        "gathered dense view)")
    return rows


def tokens_of(states):
    """{rid: (token ids, finish reason)} of a run."""
    return {s.req.rid: (list(s.token_ids), s.finish_reason) for s in states}


def e2e_requests():
    from repro_torch.core.decoding import DecodeConfig
    from repro_torch.serving.engine import Request
    reqs = []
    for i in range(16):
        dc = (DecodeConfig(method="greedy") if i % 2 == 0 else
              DecodeConfig(method="sample", temperature=0.8, top_k=40,
                           top_p=0.95))
        reqs.append(Request(rid=i, prompt=f"Q{i}: produce output. A:"
                            .encode(), grammar=("json", "jsonmsg")[
                                (i // 2) % 2],
                            max_new_tokens=64, decode=dc, seed=i))
    return reqs


def check_outputs(states, bundles):
    """Every eos-finished output parses, every other one is a prefix of
    the language. -> (complete, valid)."""
    from repro_torch.core.parser import IncrementalParser
    complete, valid = 0, 0
    for st in states:
        g, tab, _ = bundles[st.req.grammar]
        if st.finish_reason == "eos":
            complete += 1
            if not IncrementalParser(g, tab).recognize(st.generated):
                raise AssertionError(f"request {st.req.rid}: completed "
                                     f"output does not parse: "
                                     f"{st.generated!r}")
            valid += 1
        else:
            IncrementalParser(g, tab).partial_parse(st.generated)
    return complete, valid


def zero_counters(torch, counters):
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0


def read_counters(torch, counters):
    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in counters}


def run_counted(torch, counters, fn):
    """Zero every kernel's launch counter, run, read the counters."""
    zero_counters(torch, counters)
    states, stats = fn()
    return states, stats, read_counters(torch, counters)


def report(name, states, stats, bundles, launches, extra=""):
    complete, valid = check_outputs(states, bundles)
    reasons = {}
    for st in states:
        reasons[st.finish_reason] = reasons.get(st.finish_reason, 0) + 1
    log(f"e2e {name}: {stats.tokens} tokens in {stats.wall:.3f} s = "
        f"{stats.tokens_per_sec:.2f} tok/s; {stats.decode_steps} steps; "
        f"complete {complete}/{len(states)}, valid among complete "
        f"{valid}/{complete}; finish reasons {reasons}{extra}")
    log(f"  kernel launches: {launches}")


def greedy_agreement(a_states, b_states):
    """Greedy requests of two runs whose token streams agree."""
    b = {s.req.rid: s.token_ids for s in b_states}
    greedy = [s for s in a_states if s.req.decode.method == "greedy"]
    same = sum(s.token_ids == b.get(s.req.rid) for s in greedy)
    return f"{same}/{len(greedy)}"


def phase_e2e(torch, engine, bundles, counters):
    from repro_torch.serving.engine import Engine
    states, stats, launches = run_counted(
        torch, counters, lambda: engine.generate(e2e_requests()))
    n_layers = engine.model.cfg.num_layers
    report("dense generate (json+jsonmsg, 8 slots, 16 requests x 64 new "
           "tokens)", states, stats, bundles, launches,
           f"; overlap hits {stats.overlap_hits}/{stats.overlap_dispatched}")
    if launches["fused_mask_select"] < stats.decode_steps:
        raise AssertionError("fused_select launched fewer times than the "
                             "engine stepped")
    if launches["attention"] != stats.requests * n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['attention']} times, want "
                             f"{stats.requests} admissions x {n_layers}")
    # devtime run: the first 8 of the requests (not all 16: the script's
    # time) with device spans synchronized
    dev_engine = Engine(engine.model, engine.params, engine.tok, bundles,
                        max_len=engine.max_len, slots=engine.slots,
                        devtime=True, device="cuda")
    _, dstats = dev_engine.generate(e2e_requests()[:8])
    log(f"e2e devtime run: {dstats.tokens} tokens in {dstats.wall:.3f} s; "
        f"device_forward_s {dstats.device_forward_s:.4f}; "
        f"device_mask_sample_s {dstats.device_mask_sample_s:.4f}; decode "
        f"steps {dstats.decode_steps}; attribution seconds "
        f"{json.dumps(dstats.attribution['seconds'])}")
    return launches, states


def shared_prefix_requests(engine):
    """8 requests whose prompts share one >= 256-token prefix."""
    from repro_torch.core.decoding import DecodeConfig
    from repro_torch.serving.engine import Request
    prefix = "".join(f"field_{i:03d}: value {i * 7919 % 1000:03d}; "
                     for i in range(28)).encode()
    n = len(engine.tok.encode(prefix))
    if n < 256:
        raise AssertionError(f"shared prefix is {n} tokens, want >= 256")
    return [Request(rid=100 + i, prompt=prefix + f" Q{i}: emit. A:"
                    .encode(), grammar=("json", "jsonmsg")[i % 2],
                    max_new_tokens=64,
                    decode=(DecodeConfig(method="greedy") if i % 2 == 0
                            else DecodeConfig(method="sample",
                                              temperature=0.8, top_k=40,
                                              top_p=0.95)),
                    seed=100 + i) for i in range(8)], n


def phase_new_paths(torch, engine, bundles, counters, dense_states):
    """Speculation (dense and paged caches), paged serving and the
    sequential path, each with the counters zeroed just before it."""
    from repro_torch.serving.engine import Engine
    n_layers = engine.model.cfg.num_layers
    found = {}

    # ---- speculative, dense caches ----------------------------------
    states, stats, launches = run_counted(
        torch, counters, lambda: engine.generate_speculative(
            e2e_requests()))
    spec_states = states
    report("speculative, dense caches (16 requests x 64 new tokens)",
           states, stats, bundles, launches,
           f"; jump tokens {stats.jump_tokens}; drafts accepted "
           f"{stats.draft_accepted}/{stats.draft_proposed}; greedy "
           f"requests agreeing with dense generate() "
           f"{greedy_agreement(states, dense_states)}")
    if launches["apply_grammar_mask_span"] != stats.decode_steps or \
            stats.decode_steps == 0:
        raise AssertionError(
            f"masked_logits_span launched "
            f"{launches['apply_grammar_mask_span']} times in "
            f"{stats.decode_steps} span steps (want one per step)")
    found["masked_logits_span"] = launches["apply_grammar_mask_span"]

    # ---- paged, with prefix sharing and chunked prefill -------------
    paged = Engine(engine.model, engine.params, engine.tok, bundles,
                   max_len=engine.max_len, slots=engine.slots, paged=True,
                   page_size=16, device="cuda")
    shared, n_prefix = shared_prefix_requests(engine)
    states, stats, launches = run_counted(
        torch, counters, lambda: paged.generate(e2e_requests() + shared))
    paged_states = states
    report(f"paged (page_size 16, 16 requests + 8 sharing a {n_prefix}-"
           f"token prefix)", states, stats, bundles, launches,
           f"; prefix hit rate {stats.prefix_hit_rate:.4f}; peak pages "
           f"{stats.kv_peak_utilization * paged.num_pages:.0f}/"
           f"{paged.num_pages}; COW copies {stats.kv_cow_copies}; page "
           f"allocations {stats.kv_page_allocs}; greedy requests agreeing "
           f"with dense generate() "
           f"{greedy_agreement([s for s in states if s.req.rid < 100],
                               dense_states)}")
    if launches["paged_attention"] != stats.decode_steps * n_layers:
        raise AssertionError(
            f"paged_attention launched {launches['paged_attention']} "
            f"times, want {stats.decode_steps} steps x {n_layers} layers")
    if not stats.prefix_hit_rate > 0:
        raise AssertionError("paged run shared no prefix page")
    found["paged_attention_span"] = launches["paged_attention"]

    # ---- speculative over paged caches ------------------------------
    short = e2e_requests()[:8]
    for r in short:
        r.max_new_tokens = 32
    states, stats, launches = run_counted(
        torch, counters, lambda: paged.generate_speculative(short))
    report("speculative over paged caches (8 requests x 32 new tokens)",
           states, stats, bundles, launches,
           f"; jump tokens {stats.jump_tokens}; drafts accepted "
           f"{stats.draft_accepted}/{stats.draft_proposed}")
    if launches["paged_attention"] != stats.decode_steps * n_layers or \
            launches["apply_grammar_mask_span"] != stats.decode_steps:
        raise AssertionError("speculative paged run: launches do not "
                             "match its span steps")

    # ---- sequential -------------------------------------------------
    seq = e2e_requests()[:4]
    for r in seq:
        r.max_new_tokens = 32
    states, stats, launches = run_counted(
        torch, counters, lambda: engine.generate_sequential(seq))
    report("sequential (4 requests x 32 new tokens)", states, stats,
           bundles, launches,
           f"; constrained steps {stats.mask_computations}")
    if launches["apply_grammar_mask"] != stats.mask_computations or \
            stats.mask_computations == 0:
        raise AssertionError(
            f"masked_logits launched {launches['apply_grammar_mask']} "
            f"times for {stats.mask_computations} constrained steps")
    found["masked_logits"] = launches["apply_grammar_mask"]
    return found, {"spec": spec_states, "paged": paged_states}


# steps in a breakdown's profiled window (10 until phase 16 came: the
# profiler's own time over ~2600 kernels a step took most of phase 6's
# 56.5 s; the wall and dispatch times still take `steps` unprofiled steps)
PROFILE_STEPS = 2


def _step_breakdown(torch, label, step, steps=10, share_of=()):
    """Where one decode step's time goes: the host's dispatch time (no
    sync) and the synced wall time over `steps` steps, and the device
    busy time summed over the kernels the profiler saw in a window of
    min(steps, PROFILE_STEPS) steps; busy / wall is the card's busy
    share. `share_of` names kernels whose launches, device ms per step and
    share of the busy time are printed too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    dispatch = (time.perf_counter() - t0) / steps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    window = min(steps, PROFILE_STEPS)
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    t_prof = time.perf_counter() - t_prof
    busy_us = sum(e.self_device_time_total for e in kern) / window
    launches = sum(e.count for e in kern) / window
    busy = (f"device busy {busy_us / 1e3:.4f} ms/step, busy share "
            f"{busy_us / 1e3 / (wall * 1e3):.3f}" if busy_us > 0 else
            "device busy not measured (the profiler saw no device time)")
    log(f"{label} ({steps} steps, {window} profiled in {t_prof:.1f} s): "
        f"wall "
        f"{wall * 1e3:.4f} ms/step, host dispatch {dispatch * 1e3:.4f} "
        f"ms/step; {busy}; {launches:.0f} kernels/step")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log("  top kernels (ms/step): " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / window / 1e3:.4f}"
        for e in top))
    for name in share_of if busy_us > 0 else ():
        mine = [e for e in kern if name in e.key]
        us = sum(e.self_device_time_total for e in mine) / window
        n = sum(e.count for e in mine) / window
        log(f"  {name}: {n:.0f} launches/step, {us / 1e3:.4f} ms/step "
            f"device, {us / busy_us:.3f} of device busy")


def phase_forward_breakdown(torch, engine):
    """One decode step at full width, a [B, V] forward on dense caches and
    the selection of its ids, then the same step through page tables (32
    pages of 16 per slot, the paged run's shapes, each slot at position
    300). The selection is the e2e runs' mix: half the rows greedy, half
    sampled at temperature 0.8, top_k 40, top_p 0.95, unconstrained."""
    import numpy as np
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import gumbel_noise
    B = engine.slots
    cfg = engine.model.cfg
    dev = torch.device("cuda")
    full = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
    sel = (engine._store_cat,
           torch.full((B, 1), -1, dtype=torch.int32, device=dev), None,
           full(False, torch.bool), full(False, torch.bool),
           torch.arange(B, device=dev) % 2 == 0, full(0.8, torch.float32),
           full(40, torch.int32), full(0.95, torch.float32))
    keys = np.arange(2 * B, dtype=np.uint32).reshape(B, 2)
    noise = gumbel_noise(keys, cfg.vocab_size, dev)
    select = lambda logits: fused_mask_select(
        logits.reshape(B, -1), *sel, noise=noise)
    caches = engine.model.init_decode_caches(B, engine.max_len)
    tok = torch.full((B,), 7, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 40, dtype=torch.int32, device=dev)
    _step_breakdown(torch, f"decode step breakdown, forward + select (B={B}"
                    f", {cfg.name}, {cfg.num_layers} layers, dense caches)",
                    lambda: select(engine._decode(caches, tok, pos)),
                    share_of=("fused_select",))
    ps = 16
    nP = -(-engine.max_len // ps)
    pools = engine.model.init_paged_caches(B * nP, ps)
    table = torch.arange(B * nP, dtype=torch.int32, device=dev).reshape(
        B, nP)
    ppos = torch.full((B,), 300, dtype=torch.int32, device=dev)
    _step_breakdown(torch, f"paged decode step breakdown, forward + select "
                    f"(B={B}, "
                    f"{cfg.name}, {cfg.num_layers} layers, {nP} pages of "
                    f"{ps} per slot)",
                    lambda: select(engine._span_decode(
                        pools, tok[:, None], ppos, None, table)),
                    share_of=("paged_attention", "fused_select"))


# ------------------------------------------------------- phase 7: front end

async def _http(host, port, method, path, body=b""):
    """One request on its own connection -> (status, body bytes); a
    chunked body is joined."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    if b"chunked" not in head.lower():
        return status, rest
    out = b""
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        out, rest = out + rest[:n], rest[n + 2:]
    return status, out


async def _stream(host, port, body, stop_after=None):
    """POST /generate and read its NDJSON chunks as they come ->
    (status, lines). With `stop_after` the client walks away after that
    many lines."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    data = json.dumps(body).encode()
    writer.write((f"POST /generate HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    lines = []
    try:
        while stop_after is None or len(lines) < stop_after:
            n = int((await reader.readline()).strip() or b"0", 16)
            if n == 0:
                break
            lines.append(json.loads((await reader.readexactly(n + 2))[:-2]))
    finally:
        writer.close()
    return status, lines


def _request_json(r):
    d = r.decode
    return {"prompt": r.prompt.decode(), "grammar": r.grammar,
            "max_new_tokens": r.max_new_tokens, "method": d.method,
            "temperature": d.temperature, "top_k": d.top_k or 0,
            "top_p": d.top_p, "seed": r.seed, "stream": True}


def _utf8(b):
    try:
        b.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def _streamed_state(tok, req, status, lines):
    """Check one stream and turn it into a state for `check_outputs`:
    every chunk is its token's text, the terminal line counts the tokens
    and holds the whole output, and the chunks join to it exactly unless
    a token split a UTF-8 character (each chunk then replaced its half on
    its own). -> (state, joined exactly)."""
    from types import SimpleNamespace
    if status != 200 or not lines or not lines[-1].get("done"):
        raise AssertionError(f"request {req.rid}: stream broke (status "
                             f"{status}, {len(lines)} lines)")
    toks, final = lines[:-1], lines[-1]
    parts = [tok.id_to_bytes[ln["token"]] for ln in toks]
    raw = b"".join(parts)
    exact = "".join(ln["text"] for ln in toks) == final["text"]
    if final["tokens"] != len(toks) or \
            final["text"] != raw.decode("utf-8", "replace") or \
            any(ln["text"] != b.decode("utf-8", "replace")
                for ln, b in zip(toks, parts)) or \
            (not exact and all(_utf8(b) for b in parts)):
        raise AssertionError(f"request {req.rid}: streamed chunks do not "
                             f"join to the terminal line")
    return SimpleNamespace(req=req, finish_reason=final["finish_reason"],
                           generated=raw,
                           ids=[ln["token"] for ln in toks]), exact


async def _front_end_server(torch, engine, bundles, counters, dense_states):
    import asyncio
    from repro_torch.core.grammars import grammar_text
    from repro_torch.core.tokenizer import EOS_ID
    from repro_torch.serving.async_engine import AsyncEngine
    from repro_torch.serving.server import EngineServer
    tok = engine.tok
    n_layers = engine.model.cfg.num_layers
    aeng = AsyncEngine(engine)
    srv = EngineServer(aeng)
    host, port = await srv.start("127.0.0.1", 0)
    try:
        # ---- 16 concurrent streams --------------------------------
        reqs = e2e_requests()
        zero_counters(torch, counters)
        t0 = time.perf_counter()
        got = await asyncio.gather(*(_stream(host, port, _request_json(r))
                                     for r in reqs))
        wall = time.perf_counter() - t0
        stats = aeng.stats()
        launches = read_counters(torch, counters)
        states, exact = [], 0
        for r, (status, lines) in zip(reqs, got):
            st, ok = _streamed_state(tok, r, status, lines)
            states.append(st)
            exact += ok
        complete, valid = check_outputs(states, bundles)
        dense = {s.req.rid: [t for t in s.token_ids[len(
            engine._request_ids(s.req)):] if t != EOS_ID]
                 for s in dense_states}
        greedy = [s for s in states if s.req.decode.method == "greedy"]
        agree = sum(s.ids == dense[s.req.rid] for s in greedy)
        reasons = {}
        for st in states:
            reasons[st.finish_reason] = reasons.get(st.finish_reason, 0) + 1
        log(f"front end, server (16 concurrent NDJSON streams x 64 new "
            f"tokens, 8 slots): {stats.tokens} tokens in {wall:.3f} s = "
            f"{stats.tokens / wall:.2f} tok/s; {stats.decode_steps} steps; "
            f"complete {complete}/16, valid among complete {valid}/"
            f"{complete}; finish reasons {reasons}; chunks join the "
            f"terminal text exactly on {exact}/16 streams (the rest split "
            f"a UTF-8 character); greedy requests agreeing with dense "
            f"generate() {agree}/{len(greedy)}; overlap hits "
            f"{stats.overlap_hits}/{stats.overlap_dispatched}")
        log(f"  kernel launches: {launches}")
        if launches["fused_mask_select"] < stats.decode_steps or \
                stats.decode_steps == 0:
            raise AssertionError("server run: fused_select launched fewer "
                                 "times than the engine stepped")
        if launches["attention"] != stats.requests * n_layers:
            raise AssertionError(
                f"server run: flash_attention launched "
                f"{launches['attention']} times, want {stats.requests} "
                f"admissions x {n_layers}")
        status, body = await _http(host, port, "GET", "/stats")
        summ = json.loads(body)["requests"]
        log(f"  latency from /stats (seconds): ttft p50 "
            f"{summ['ttft']['p50']} p99 {summ['ttft']['p99']} mean "
            f"{summ['ttft']['mean']}; itl p50 {summ['itl']['p50']} p99 "
            f"{summ['itl']['p99']} mean {summ['itl']['mean']}; queue wait "
            f"p50 {summ['queue_wait']['p50']} p99 "
            f"{summ['queue_wait']['p99']}; card {smi_line()}")

        # ---- a client that walks away -----------------------------
        status, body = await _http(host, port, "GET", "/healthz")
        before = json.loads(body)["finish_reasons"].get("cancelled", 0)
        status, lines = await _stream(host, port, {
            "prompt": "Q: walk away.", "grammar": None,
            "max_new_tokens": 400, "method": "greedy"}, stop_after=3)
        gone_at = aeng.stats().decode_steps
        for _ in range(1000):
            health = json.loads((await _http(host, port, "GET",
                                             "/healthz"))[1])
            if health["active"] == 0 and \
                    health["finish_reasons"].get("cancelled", 0) > before:
                break
            await asyncio.sleep(0.01)
        else:
            raise AssertionError("disconnected stream was not cancelled")
        freed_after = aeng.stats().decode_steps - gone_at
        log(f"front end, disconnect after {len(lines)} lines: slot freed "
            f"after {freed_after} more steps; /healthz active "
            f"{health['active']}, finish reasons "
            f"{health['finish_reasons']}")
        if freed_after > 8:
            raise AssertionError(f"cancel took {freed_after} steps")

        # ---- hot load ---------------------------------------------
        t0 = time.perf_counter()
        status, body = await _http(host, port, "POST", "/grammars",
                                   json.dumps({"name": "json_hot",
                                               "text": grammar_text("json")
                                               }).encode())
        if status != 200:
            raise AssertionError(f"POST /grammars: {status} {body!r}")
        load_s = time.perf_counter() - t0
        from repro_torch.serving.engine import Request
        hot = Request(rid=-1, prompt=b"Q: hot. A:", grammar="json_hot",
                      max_new_tokens=32, seed=7)
        status, lines = await _stream(host, port, _request_json(hot))
        st, _ = _streamed_state(tok, hot, status, lines)
        check_outputs([st], engine.bundles)
        log(f"front end, hot load: POST /grammars json_hot "
            f"({json.loads(body)['rows']} rows) in {load_s:.3f} s; one "
            f"request on it: {st.finish_reason}, {len(st.ids)} tokens, "
            f"valid")

        # ---- observability ----------------------------------------
        status, body = await _http(host, port, "GET", "/metrics")
        text = body.decode()
        if status != 200 or "# TYPE repro_tokens_total counter" not in text:
            raise AssertionError("/metrics is not Prometheus text")
        status, body = await _http(host, port, "GET", "/stats")
        if status != 200 or "metrics" not in json.loads(body):
            raise AssertionError("/stats is not the JSON snapshot")
        status, body = await _http(host, port, "POST", "/profile",
                                   b'{"action": "start"}')
        started = json.loads(body)
        if status != 200 or started.get("backend_profiler") is not True:
            raise AssertionError(f"/profile start: {status} {started}")
        prof_req = Request(rid=-2, prompt=b"Q: profile. A:", grammar="json",
                           max_new_tokens=8, seed=8)
        status, lines = await _stream(host, port, _request_json(prof_req))
        _streamed_state(tok, prof_req, status, lines)
        t0 = time.perf_counter()
        status, body = await _http(host, port, "POST", "/profile",
                                   b'{"action": "stop"}')
        if status != 200:
            raise AssertionError(f"/profile stop: {status} {body!r}")
        stop_s = time.perf_counter() - t0
        status, body = await _http(host, port, "POST", "/profile",
                                   b'{"action": "dump"}')
        events = json.loads(body)["traceEvents"]
        device = [e for e in events if e.get("ph") == "X" and str(
            e.get("cat", "")).startswith("device:")]
        fused = [e for e in device
                 if "fused_select_kernel" in e.get("name", "")]
        log(f"front end, observability: /metrics {len(text)} bytes of "
            f"Prometheus text; /stats JSON; /profile: backend profiler "
            f"{started['backend_profiler']}, stop + export {stop_s:.3f} s, "
            f"dump {len(events)} events, {len(device)} on device tracks, "
            f"{len(fused)} of fused_select_kernel")
        if not fused:
            raise AssertionError("/profile dump holds no fused_select_kernel "
                                 "device event")
    finally:
        await srv.stop(drain=False)


async def _front_end_paged(torch, engine, bundles, counters):
    from repro_torch.serving.async_engine import AsyncEngine
    from repro_torch.serving.engine import Engine
    paged = Engine(engine.model, engine.params, engine.tok, bundles,
                   max_len=engine.max_len, slots=engine.slots, paged=True,
                   page_size=16, device="cuda")
    shared, n_prefix = shared_prefix_requests(engine)
    zero_counters(torch, counters)
    t0 = time.perf_counter()
    aeng = AsyncEngine(paged)
    handles = [aeng.submit(r) for r in shared]
    alloc = aeng._loop_obj.mode.alloc
    baseline = alloc.P          # a fresh pool: every page free
    victim, seen = handles[3], 0
    async for _ in victim.tokens():
        seen += 1
        if seen == 4:
            victim.cancel()
    states = [await h.result() for h in handles]
    await aeng.drain()
    wall = time.perf_counter() - t0
    stats = aeng.stats()
    launches = read_counters(torch, counters)
    if states[3].finish_reason != "cancelled":
        raise AssertionError(f"paged cancel: request ended "
                             f"{states[3].finish_reason}")
    alloc.check_invariants()
    if alloc.available() != baseline or any(len(t) for t in alloc.tables):
        raise AssertionError(f"paged cancel: {alloc.available()} pages "
                             f"available after drain, {baseline} before")
    complete, valid = check_outputs(states, bundles)
    n_layers = engine.model.cfg.num_layers
    log(f"front end, async paged (page_size 16, 8 requests sharing a "
        f"{n_prefix}-token prefix, request 3 cancelled after {seen} "
        f"tokens): {stats.tokens} tokens in {wall:.3f} s = "
        f"{stats.tokens / wall:.2f} tok/s; {stats.decode_steps} steps; "
        f"complete {complete}/8, valid among complete {valid}/{complete}; "
        f"pages available {alloc.available()}/{alloc.P} after drain "
        f"(baseline {baseline}; cold {alloc.cold_pages}); prefix hit rate "
        f"{stats.prefix_hit_rate:.4f}")
    log(f"  kernel launches: {launches}")
    if launches["paged_attention"] != stats.decode_steps * n_layers or \
            stats.decode_steps == 0:
        raise AssertionError(f"async paged run: paged_attention launched "
                             f"{launches['paged_attention']} times in "
                             f"{stats.decode_steps} steps x {n_layers}")
    return launches


def phase_front_end(torch, engine, bundles, counters, dense_states):
    """The live front end on the main engine, an async paged engine with a
    cancel, and opportunistic masking; each run counted on its own."""
    import asyncio
    from repro_torch.launch.serve import build_engine
    asyncio.run(_front_end_server(torch, engine, bundles, counters,
                                  dense_states))
    asyncio.run(_front_end_paged(torch, engine, bundles, counters))

    opp, _, _ = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=engine.max_len,
        slots=engine.slots, opportunistic=True, params=engine.params,
        device="cuda")
    reqs = e2e_requests()[:8]       # not 16 x 64: the script's time
    for r in reqs:
        r.max_new_tokens = 32
    states, stats, launches = run_counted(
        torch, counters, lambda: opp.generate(reqs))
    report("opportunistic generate (8 requests x 32 new tokens)", states,
           stats, opp.bundles, launches,
           f"; opportunistic hits {stats.opportunistic_hits}; mask "
           f"computations {stats.mask_computations}")
    if stats.opportunistic_hits + stats.mask_computations != stats.tokens:
        raise AssertionError("opportunistic: hits + masked steps != tokens")
    if stats.mask_computations and not launches["fused_mask_select"]:
        raise AssertionError("opportunistic: masked steps but no "
                             "fused_select launch")
    seq = e2e_requests()[:4]
    for r in seq:
        r.max_new_tokens = 32
    states, stats, launches = run_counted(
        torch, counters, lambda: opp.generate_sequential(seq))
    report("opportunistic sequential (4 requests x 32 new tokens)", states,
           stats, opp.bundles, launches,
           f"; opportunistic hits {stats.opportunistic_hits} of "
           f"{stats.tokens} steps; masked_logits launches "
           f"{launches['apply_grammar_mask']}")
    if launches["apply_grammar_mask"] != stats.mask_computations or \
            (stats.opportunistic_hits < stats.tokens
             and not launches["apply_grammar_mask"]):
        raise AssertionError(
            f"opportunistic sequential: masked_logits launched "
            f"{launches['apply_grammar_mask']} times for "
            f"{stats.mask_computations} masked steps")


# ---------------------------------------------------- phase 8: architectures

# (arch, depth or None for all layers): each built at full width with
# seeded random weights, served, checked and freed before the next.
# qwen3-moe at all 48 layers fits the card but takes the script past half
# its time limit; 8 layers until phase 14 came, 4 since (PERF.md §4).
# mamba2-370m at 24 of 48 layers since phase 15 came, for the script's
# time (all layers until then; phase 14 still serves mamba2's 48)
MOE_DEPTH = 4
ARCHS = (("mamba2-370m", 24), ("recurrentgemma-9b", None),
         ("qwen3-moe-30b-a3b", MOE_DEPTH))


def arch_requests():
    """Phase 5's first 8 requests (half greedy, half sampled at
    temperature 0.8, top_k 40, top_p 0.95; json and jsonmsg) x 32 new
    tokens."""
    reqs = e2e_requests()[:8]
    for r in reqs:
        r.max_new_tokens = 32
    return reqs


def arch_mask_rows(torch, np, engine, model, forms):
    """masked_logits ("row", B) and masked_logits_span ("span", B, K) at
    one model's vocab, bf16, real json rows at the engine's accept bucket
    (A = 48), bitwise against the plain version. -> rows."""
    from repro_torch.core.constrain import MAX_ACCEPT
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_span)
    from repro_torch.kernels.masked_logits.ref import (
        masked_logits_ref, masked_logits_span_ref)
    dev = torch.device("cuda")
    store, rows, eos, cd, cons_on = json_rows(torch, np, engine)
    W = store.shape[1]
    V = engine.model.cfg.vocab_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(13)
    out = []
    for form in forms:
        B = form[1]
        if form[0] == "row":
            fn, ref, K = apply_grammar_mask, masked_logits_ref, 1
            rset, cset = rows[:B], cons_on[:B]
            args = (t(rng.normal(scale=3.0, size=(B, V)).astype(
                np.float32)).bfloat16(), store, t(rset), t(eos[:B]))
            kw = {"constrained": t(cset), "cd": t(cd[:B].view(np.int32))}
            name, line, shape = "masked_logits", 164, f"B={B} V={V} bf16"
        else:
            fn, ref, K = apply_grammar_mask_span, masked_logits_span_ref, \
                form[2]
            rset = np.repeat(rows[:B, None], K, axis=1)
            cset = np.repeat(cons_on[:B, None], K, axis=1)
            args = (t(rng.normal(scale=3.0, size=(B, K, V)).astype(
                np.float32)).bfloat16(), store, t(rset),
                t(np.repeat(eos[:B, None], K, axis=1)))
            kw = {"constrained": t(cset), "cd": t(np.repeat(
                cd[:B, None], K, axis=1).view(np.int32))}
            name, line, shape = ("masked_logits_span", 112,
                                 f"B={B} K={K} V={V} bf16")
        mk, mr = fn(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(mk.view(torch.int16), mr.view(torch.int16)):
            raise AssertionError(f"{name} {model} {shape}: differs from the "
                                 f"plain version")
        ms = cuda_ms(torch, lambda: fn(*args, **kw))
        dev_ms = device_ms(torch, lambda: fn(*args, **kw))
        plain = cuda_ms(torch, lambda: ref(*args, **kw))
        nbytes = _mask_bytes(np, args[0].numel() * 2,
                             rset.reshape(B * K, -1), cset.reshape(-1), W)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"{name} {model} {shape} A={MAX_ACCEPT}: bitwise equal; "
            f"{ms:.4f} ms, device {dev_ms:.4f} ms; plain {plain:.4f} ms; "
            f"bound {bound:.6f} ms ({nbytes} bytes)")
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/masked_logits.cu",
                    "replaces": f"src/repro/kernels/masked_logits/"
                                f"kernel.py:{line}",
                    "model": model, "shape": f"{shape} A={MAX_ACCEPT}",
                    "launches": 0, "max_abs_err": float(
                        (mk.float() - mr.float()).abs().max()),
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": "bytes",
                    "library_ms": None, "library_device_ms": None})
    return out


def _scan_cost(torch, S, R):
    """The RG-LRU prefill scan (`models/rglru.py::linear_scan`, log depth)
    at [1, S, R] fp32, beside a sequential loop over the S positions."""
    from repro_torch.models.rglru import linear_scan
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(4)
    a = torch.rand((1, S, R), device=dev, generator=g)
    b = torch.randn((1, S, R), device=dev, generator=g)
    scan_ms = cuda_ms(torch, lambda: linear_scan(a, b))
    scan_dev = device_ms(torch, lambda: linear_scan(a, b))

    def loop():
        h, hs = torch.zeros_like(b[:, 0]), []
        for i in range(S):
            h = a[:, i] * h + b[:, i]
            hs.append(h)
        return torch.stack(hs, 1)

    err = (linear_scan(a, b) - loop()).abs().max().item()
    log(f"RG-LRU prefill scan [1,{S},{R}] fp32: log-depth "
        f"({(S - 1).bit_length()} rounds) {scan_ms:.4f} ms, device "
        f"{scan_dev:.4f} ms; sequential loop {cuda_ms(torch, loop):.4f} ms, "
        f"device {device_ms(torch, loop):.4f} ms; max abs difference "
        f"{err:.3e}")


def phase_arch(torch, np, counters, arch, depth):
    """One model of phase 8 at full width (and `depth` layers, or all):
    build it through `build_engine`, check its kernels at its shapes,
    serve its runs with the counters zeroed just before each and read
    just after, then free it. -> its kernel rows, launches filled from
    its runs."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.model import layer_groups
    from repro_torch.serving.engine import Engine
    t0 = time.perf_counter()
    engine, bundles, _ = build_engine(
        arch, grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda", num_layers=depth)
    torch.cuda.synchronize()
    cfg = engine.model.cfg
    numel = lambda t: (sum(map(numel, t.values())) if isinstance(t, dict)
                       else sum(map(numel, t)) if isinstance(t, (list, tuple))
                       else t.numel())
    n_params = numel(engine.params)
    log(f"phase 8, {arch}: {cfg.num_layers} of "
        f"{get_config(arch).num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, groups {layer_groups(cfg)}; "
        f"{n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"engine build (mask stores + random weights) "
        f"{time.perf_counter() - t0:.1f} s")
    n = len(engine._request_ids(arch_requests()[0])) - 1
    path_S = engine._bucketed_prompt(list(range(n)))[0].shape[1]
    n_attn = sum(count for pat, count in layer_groups(cfg) for kind in pat
                 if kind in ("attn", "moe"))
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    sel = phase_fused_select(torch, np, engine)
    sel.update(model=arch, shape=f"B=8 V={cfg.vocab_size} bf16")
    rows = [sel]
    flash, paged, masks = [], {}, []
    if arch == "recurrentgemma-9b":
        w = cfg.local_window
        flash = attention_rows(torch, np, arch, H, K, Dh, [
            (path_S, w), (2048, w), (4096, w)], path_S)
        _scan_cost(torch, path_S, cfg.lru_dim)
    if arch == "qwen3-moe-30b-a3b":
        flash = attention_rows(torch, np, arch, H, K, Dh, [
            (path_S, 0), (2048, 0)], path_S)
        paged = phase_paged_attention(torch, np, H, K, Dh, sizes=(1, 8))
        masks = arch_mask_rows(torch, np, engine, arch, [("span", 8, 8)])
    if arch == "mamba2-370m":
        masks = arch_mask_rows(torch, np, engine, arch, [("row", 1),
                                                         ("row", 8)])

    # ---- dense generate() -------------------------------------------
    states, stats, launches = run_counted(
        torch, counters, lambda: engine.generate(arch_requests()))
    report(f"{arch} dense generate (json+jsonmsg, 8 slots, 8 requests x 32 "
           f"new tokens)", states, stats, bundles, launches,
           f"; overlap hits {stats.overlap_hits}/{stats.overlap_dispatched}")
    if launches["fused_mask_select"] < stats.decode_steps or \
            stats.decode_steps == 0:
        raise AssertionError(f"{arch}: fused_select launched fewer times "
                             f"than the engine stepped")
    if launches["attention"] != stats.requests * n_attn:
        raise AssertionError(f"{arch}: flash_attention launched "
                             f"{launches['attention']} times, want "
                             f"{stats.requests} admissions x {n_attn}")
    sel["launches"] = launches["fused_mask_select"]
    for r in flash:
        r["launches"] = launches["attention"]
    # devtime twin: the first 4 of the requests (not all 8: the script's
    # time) with device spans synchronized
    _, dstats = Engine(engine.model, engine.params, engine.tok, bundles,
                       max_len=engine.max_len, slots=engine.slots,
                       devtime=True, device="cuda").generate(
                           arch_requests()[:4])
    log(f"{arch} devtime run: {dstats.tokens} tokens in {dstats.wall:.3f} "
        f"s; device_forward_s {dstats.device_forward_s:.4f}; "
        f"device_mask_sample_s {dstats.device_mask_sample_s:.4f}; decode "
        f"steps {dstats.decode_steps}; attribution seconds "
        f"{json.dumps(dstats.attribution['seconds'])}")

    if arch == "mamba2-370m":
        seq = arch_requests()[:4]
        for r in seq:
            r.max_new_tokens = 16
        states, stats, launches = run_counted(
            torch, counters, lambda: engine.generate_sequential(seq))
        report(f"{arch} sequential (4 requests x 16 new tokens)", states,
               stats, bundles, launches,
               f"; constrained steps {stats.mask_computations}")
        if launches["apply_grammar_mask"] != stats.mask_computations or \
                stats.mask_computations == 0:
            raise AssertionError(f"{arch} sequential: masked_logits launched "
                                 f"{launches['apply_grammar_mask']} times for "
                                 f"{stats.mask_computations} steps")
        for r in masks:
            r["launches"] = launches["apply_grammar_mask"]

    if arch == "qwen3-moe-30b-a3b":
        pg = Engine(engine.model, engine.params, engine.tok, bundles,
                    max_len=engine.max_len, slots=engine.slots, paged=True,
                    page_size=16, device="cuda")
        states, stats, launches = run_counted(
            torch, counters, lambda: pg.generate(arch_requests()))
        report(f"{arch} paged generate (page_size 16, 8 requests x 32 new "
               f"tokens)", states, stats, bundles, launches,
               f"; peak pages {stats.kv_peak_utilization * pg.num_pages:.0f}"
               f"/{pg.num_pages}; page allocations {stats.kv_page_allocs}; "
               f"prefix hit rate {stats.prefix_hit_rate:.4f}")
        if launches["paged_attention"] != stats.decode_steps * n_attn or \
                not launches["fused_mask_select"]:
            raise AssertionError(f"{arch} paged: paged_attention launched "
                                 f"{launches['paged_attention']} times in "
                                 f"{stats.decode_steps} steps x {n_attn}")
        for r in paged.values():
            r.update(model=arch, launches=launches["paged_attention"])
        del pg
        states, stats, launches = run_counted(
            torch, counters, lambda: engine.generate_speculative(
                arch_requests()))
        report(f"{arch} speculative, dense caches (8 requests x 32 new "
               f"tokens)", states, stats, bundles, launches,
               f"; jump tokens {stats.jump_tokens}; drafts accepted "
               f"{stats.draft_accepted}/{stats.draft_proposed}")
        if launches["apply_grammar_mask_span"] != stats.decode_steps or \
                stats.decode_steps == 0:
            raise AssertionError(f"{arch} speculative: masked_logits_span "
                                 f"launched "
                                 f"{launches['apply_grammar_mask_span']} "
                                 f"times in {stats.decode_steps} steps")
        for r in masks:
            r["launches"] = launches["apply_grammar_mask_span"]

    # ---- one dense decode step, forward + selection ------------------
    B = engine.slots
    dev = torch.device("cuda")
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import gumbel_noise
    full = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
    noise = gumbel_noise(np.arange(2 * B, dtype=np.uint32).reshape(B, 2),
                         cfg.vocab_size, dev)
    caches = engine.model.init_decode_caches(B, engine.max_len)
    tok = torch.full((B,), 7, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 40, dtype=torch.int32, device=dev)
    sel_args = (engine._store_cat,
                torch.full((B, 1), -1, dtype=torch.int32, device=dev), None,
                full(False, torch.bool), full(False, torch.bool),
                torch.arange(B, device=dev) % 2 == 0,
                full(0.8, torch.float32), full(40, torch.int32),
                full(0.95, torch.float32))
    _step_breakdown(torch, f"{arch} decode step breakdown, forward + select "
                    f"(B={B}, {cfg.num_layers} layers, dense caches)",
                    lambda: fused_mask_select(
                        engine._decode(caches, tok, pos), *sel_args,
                        noise=noise), share_of=("fused_select",))
    del engine, bundles, caches, states
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2 ** 30
    log(f"phase 8, {arch}: freed; {left:.2f} GiB still allocated")
    return rows + flash + list(paged.values()) + masks


# ------------------------------------------------------- phase 9: training

# (model, B, S, H, K, Dh, window, dtype) of the backward kernel check:
# the training shapes of phase 9's runs, plus one fp32 shape
BWD_CASES = (("smollm-360m", 8, 1024, 15, 5, 64, 0, "bfloat16"),
             ("qwen3-moe-30b-a3b", 4, 1024, 32, 4, 128, 0, "bfloat16"),
             ("recurrentgemma-9b", 2, 4096, 16, 1, 256, 2048, "bfloat16"),
             ("smollm-360m", 2, 1024, 15, 5, 64, 0, "float32"))
# the forward and backward kernels against their plain versions (phases 9
# and 10): within this share of the plain version's largest magnitude (the
# output; dq, dk and dv each)
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
# smollm-360m's run: 20 steps of 32 attention layers; with remat each
# layer's forward runs twice a step (the step's, and the recompute in the
# backward), its backward once
TRAIN_STEPS = 20
TRAIN_FWD_LAUNCHES = 32 * TRAIN_STEPS * 2
TRAIN_BWD_LAUNCHES = 32 * TRAIN_STEPS
# (arch, layers kept or None for all, B, S) of the other families' runs,
# 5 steps each; PERF.md §4 gives each cut's reason
TRAIN_ARCHS = (("mamba2-370m", 24, 4, 1024),     # of 48: the script's time
               ("qwen3-moe-30b-a3b", 2, 4, 1024),
               ("recurrentgemma-9b", 3, 2, 4096))
ARCH_TRAIN_STEPS = 5


def short_kernel(mangled):
    """`bwd_dkdv_bf16_kernel<64>` from a mangled backward kernel name
    (the kernels without `bf16` in the name are the fp32 route's)."""
    m = re.search(r"\d(bwd_(?:dot|dkdv|dq)(?:_bf16)?_kernel)(?:ILi(\d+)E)?",
                  mangled)
    name, dh = m.groups()
    return f"{name}<{dh}>" if dh else name


def backward_build_report():
    """Log the backward kernels' registers, spills and stack from the
    build log's `-Xptxas -v` report, with each pass's dynamic shared
    memory from the library; fails if a bf16 backward kernel spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import _launcher
    lib, _ = _launcher()
    text = (_build.BUILD_DIR / f"build_{_build.source_hash()}.log").read_text()
    found = [r for r in _build.ptxas_report(text) if "bwd_" in r["kernel"]]
    if not found:
        raise AssertionError("the build log reports no backward kernel")
    for r in found:
        r["kernel"] = short_kernel(r["kernel"])
    log("flash_attention_bwd build (ptxas -v): " + "; ".join(
        f"{r['kernel']} {r['registers']} registers, spill stores/loads "
        f"{r['spill_stores']}/{r['spill_loads']} B, stack {r['stack']} B"
        for r in found))
    smem = lib.flash_attention_bwd_smem_bytes
    log("flash_attention_bwd dynamic shared memory (bytes, dkdv / dq): " +
        "; ".join(f"{dt} Dh {dh}: {smem(c, dh, 0)} / {smem(c, dh, 1)}"
                  for c, dt in ((1, "bf16"), (0, "fp32"))
                  for dh in (32, 64, 128, 256)))
    spills = [r["kernel"] for r in found if "bf16" in r["kernel"] and
              (r["spill_stores"] or r["spill_loads"])]
    if spills:
        raise AssertionError(f"bf16 backward kernels spill: {spills}")


def bwd_case_inputs(torch, B, S, H, K, Dh, dt, Sk=None):
    """q [B,S,H,Dh], k and v [B,Sk,K,Dh] (Sk = S unless given) and dO
    [B,S,H,Dh] of an attention case on the card, from a seeded generator
    (`scripts/attention_bwd_ab.py` makes the same for BWD_CASES)."""
    Sk = S if Sk is None else Sk
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(S + H + Dh)
    mk = lambda *shape: torch.randn(shape, device=dev, generator=g).to(
        getattr(torch, dt))
    return mk(B, S, H, Dh), mk(B, Sk, K, Dh), mk(B, Sk, K, Dh), \
        mk(B, S, H, Dh)


def attention_case_rows(torch, model, label, B, Sq, Sk, H, K, Dh, dt, *,
                        causal, window=0, forward=True, backward=True,
                        path_shape=True):
    """One attention case on the card: the forward kernel (`forward`) and
    the backward kernel fed the forward's output and LSE (`backward`; that
    forward must give the serving launch's output bit for bit), each held
    against its plain version within ATTN_TOL of the plain version's
    largest magnitude and timed by CUDA events and torch.profiler beside
    the plain version, its bound and sdpa (forward; forward + backward).
    -> rows, launches 0 (the caller fills them from the path's runs) and
    "key" (q shape, k shape, causal, dtype) for `_ShapeTally`'s counts."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        attention, attention_backward, attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd,
                                                         chunked_attention)
    dev = torch.device("cuda")
    q, k, v, do = bwd_case_inputs(torch, B, Sq, H, K, Dh, dt, Sk)
    kw = dict(causal=causal, window=window)
    # the kernels' visibility: query i sits at key position Sk - Sq + i
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk)[None, :]
    seen = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window:
        seen &= kpos > qpos - window
    visible = int(seen.sum())
    # sdpa's own causal flag aligns q to the top left; other masks explicit
    amask = seen.to(dev) if window or (causal and Sq != Sk) else None
    sdpa_kw = dict(attn_mask=amask, is_causal=causal and amask is None,
                   enable_gqa=H != K)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    esz = 2 if dt == "bfloat16" else 4
    fwd_flops = 4 * B * H * Dh * visible      # QK^T and P.V, visible pairs
    fwd_bytes = (2 * B * Sq * H * Dh + 2 * B * Sk * K * Dh) * esz
    t_fwd = max(fwd_flops / PEAK_FLOPS[dt], fwd_bytes / HBM_BYTES_PER_S)
    shape = (f"q [{B},{Sq},{H},{Dh}] k/v [{B},{Sk},{K},{Dh}] {dt}, "
             f"{'causal' if causal else 'non-causal'}, window "
             f"{window or 'none'}")
    base = {"route": "cuda", "model": model, "case": label, "shape": shape,
            "key": ((B, Sq, H, Dh), (B, Sk, K, Dh), causal, dt),
            "path_shape": path_shape, "launches": 0}
    rows = []

    def measure(name, run, plain_fn, sdpa, flops, nbytes, formula, library,
                errs, extra):
        err, scale = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
        if not err <= ATTN_TOL[dt] * scale:
            raise AssertionError(f"{name} {label} {shape}: max abs err {err}"
                                 f" > {ATTN_TOL[dt]} x {scale}")
        t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
        bound, by = max(t_ops, t_bytes) * 1e3, (
            "operations" if t_ops >= t_bytes else "bytes")
        ms, dev_ms = cuda_ms(torch, run), device_ms(torch, run)
        plain = cuda_ms(torch, plain_fn, reps=5, warmup=1)
        lib, lib_dev = cuda_ms(torch, sdpa), device_ms(torch, sdpa)
        log(f"{name} {model} {label} {shape}: max abs err {err:.3e} "
            f"(largest magnitude {scale:.3e}, tol {ATTN_TOL[dt]:.3g} of it);"
            f" {ms:.4f} ms, device {dev_ms:.4f} ms; plain {plain:.4f} ms; "
            f"{library} {lib:.4f} ms, device {lib_dev:.4f} ms; bound "
            f"{bound:.6f} ms ({by}: {formula})"
            + "".join(f"; {k} {v:.6f}" for k, v in extra.items()))
        bwd = name.endswith("_bwd")
        rows.append({**base, "name": name,
                     "source": "src/repro_torch/csrc/" + (
                         "flash_attention_bwd.cu" if bwd else
                         "flash_attention.cu"),
                     "replaces": ("src/repro/models/common.py:95" if bwd else
                                  "src/repro/kernels/flash_attention/"
                                  "kernel.py:71"),
                     "max_abs_err": err,
                     "max_rel_err": err / max(scale, 1e-30),
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by,
                     "bound_formula": formula, "flops": flops,
                     "bytes": nbytes, "library_ms": lib,
                     "library_device_ms": lib_dev, "library": library,
                     **extra})

    if forward:
        plain_fn = lambda: chunked_attention(q, k, v, q_offset=Sk - Sq,
                                             chunk=1024, **kw)
        want, got = plain_fn().float(), attention(q, k, v, **kw).float()
        measure("flash_attention", lambda: attention(q, k, v, **kw),
                plain_fn, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, **sdpa_kw),
                fwd_flops, fwd_bytes,
                f"max({fwd_flops:.4e} FLOPs = 4 x B x H x Dh x {visible} "
                f"visible pairs / {PEAK_FLOPS[dt]:.3g}, {fwd_bytes} bytes "
                f"(q, k, v read, o written) / 3.35e12)", "sdpa forward",
                [((got - want).abs().max().item(), want.abs().max().item())],
                {})
        del want, got
    if backward:
        o, lse = attention_with_lse(q, k, v, **kw)
        if not torch.equal(o, attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention {label} {shape}: the "
                                 f"forward with LSE differs from the "
                                 f"serving launch")
        run = lambda: attention_backward(q, k, v, o, lse, do, **kw)
        plain_fn = lambda: attention_bwd(q, k, v, o, lse, do, **kw)
        errs = [((a.float() - b.float()).abs().max().item(),
                 b.float().abs().max().item())
                for a, b in zip(run(), plain_fn())]
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        dot = do.transpose(1, 2)

        def sdpa():
            F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw).backward(
                dot)

        both = lambda: attention_backward(
            q, k, v, *attention_with_lse(q, k, v, **kw), do, **kw)
        flops = 2.5 * fwd_flops
        # q, o, dO read and dQ written; k, v read and dK, dV written; the
        # fp32 LSE read
        nbytes = (4 * B * Sq * H * Dh + 4 * B * Sk * K * Dh) * esz \
            + 4 * B * H * Sq
        t_bwd = max(flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S)
        measure("flash_attention_bwd", run, plain_fn, sdpa, flops, nbytes,
                f"max({flops:.4e} FLOPs = 2.5 x the forward's "
                f"{fwd_flops:.4e} / {PEAK_FLOPS[dt]:.3g}, {nbytes} bytes "
                f"(q, o, dO, k, v, LSE read, dQ, dK, dV written) / 3.35e12)",
                "sdpa forward + backward", errs,
                {"fwd_bwd_device_ms": device_ms(torch, both),
                 "fwd_bwd_bound_ms": (t_fwd + t_bwd) * 1e3})
        del o, lse, qg, kg, vg, dot
    del q, k, v, do, qt, kt, vt, amask
    torch.cuda.empty_cache()
    return rows


def phase_attention_backward(torch):
    """The backward kernel at BWD_CASES (phase 9's training shapes)
    against the plain version on the card. -> rows."""
    backward_build_report()
    rows = []
    for model, B, S, H, K, Dh, window, dt in BWD_CASES:
        rows += attention_case_rows(
            torch, model, model, B, S, S, H, K, Dh, dt, causal=True,
            window=window, forward=False, path_shape=dt == "bfloat16")
    return rows


class _TimedIter:
    """An iterator that sums the host seconds spent in its source's
    __next__ (the data pipeline's share of a training run) and keeps the
    time each call began (`marks`: a step's start, where the loop syncs
    every step)."""

    def __init__(self, it):
        self.it, self.seconds, self.marks = it, 0.0, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        self.marks.append(t0)
        try:
            return next(self.it)
        finally:
            self.seconds += time.perf_counter() - t0

    def later_steps_ms(self, end):
        """Median ms of the steps after the first (its warm-up left out),
        each from its start to the next one's (the last to `end`)."""
        marks = self.marks + [end]
        return statistics.median(
            (b - a) * 1e3 for a, b in zip(marks[1:-1], marks[2:]))


def _train_run(torch, counters, arch, depth, B, S, steps, opt):
    """Build `arch` (first `depth` layers, every width) with seeded random
    weights and train it `steps` AdamW steps on json batches, the
    counters zeroed just before and read just after. -> (model, params,
    result, launches, seconds, peak bytes)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.models.model import build_model
    from repro_torch.training.data import GrammarDataPipeline
    from repro_torch.training.train_loop import train
    from repro_torch.training.tree import leaves
    cfg = get_config(arch)
    if depth:
        cfg = replace(cfg, num_layers=depth)
    model = build_model(cfg, device="cuda")
    init = [model.init(torch.Generator(device="cuda").manual_seed(0))]
    g, _ = load_grammar("json")
    data = _TimedIter(iter(GrammarDataPipeline(
        g, ByteTokenizer(cfg.vocab_size), S, B, seed=0)))
    n_params = sum(p.numel() for p in leaves(init[0]))
    log(f"phase 9, {arch}: {cfg.num_layers} of "
        f"{get_config(arch).num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, remat {cfg.remat}; {n_params / 1e9:.3f} "
        f"B params; B {B}, S {S}, {steps} steps (lr {opt.lr}, warmup "
        f"{opt.warmup_steps}, total {opt.total_steps})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(torch, counters)
    t0 = time.perf_counter()
    params, result = train(model, init.pop(), data, steps, opt_cfg=opt,
                           log_every=1, verbose=True, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"{arch}: a loss is not finite: "
                             f"{result.losses}")
    log(f"phase 9, {arch}: {steps} steps in {secs:.3f} s = "
        f"{secs / steps * 1e3:.1f} ms/step, {steps * B * S / secs:.0f} "
        f"tokens/s (the data pipeline's host time {data.seconds:.3f} s of "
        f"it, {data.seconds / steps * 1e3:.1f} ms/step); losses {result.losses[0]:.4f} -> "
        f"{result.losses[-1]:.4f}; peak memory {peak / 2 ** 30:.2f} GiB; "
        f"kernel launches {launches}")
    return model, params, result, launches, secs, peak


def phase_train(torch, counters, bwd_rows):
    """smollm-360m trained at full width, its checkpoint served and read
    back; then the other families. Fills the backward rows' launches.
    -> smollm-360m's peak memory in training (bytes)."""
    from repro_torch.core.decoding import DecodeConfig
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Request
    from repro_torch.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.tree import flatten_with_path

    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    model, params, result, launches, secs, peak = _train_run(
        torch, counters, "smollm-360m", None, 8, 1024, TRAIN_STEPS, opt)
    if not result.losses[-1] <= result.losses[0] - 1.0:
        raise AssertionError(f"smollm-360m: loss fell from "
                             f"{result.losses[0]} to {result.losses[-1]}, "
                             f"less than 1.0")
    if (launches["attention"], launches["attention_backward"]) != (
            TRAIN_FWD_LAUNCHES, TRAIN_BWD_LAUNCHES):
        raise AssertionError(f"smollm-360m training: attention launched "
                             f"{launches['attention']} forward and "
                             f"{launches['attention_backward']} backward, "
                             f"want {TRAIN_FWD_LAUNCHES} and "
                             f"{TRAIN_BWD_LAUNCHES}")
    for r in bwd_rows:
        if r["model"] == "smollm-360m":
            r["launches"] = launches["attention_backward"]
    smollm_peak = peak

    # one profiled step (the same batch shape; params are not kept)
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import make_train_step
    dev = torch.device("cuda")
    toks = torch.randint(0, 256, (8, 1025), device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((8, 1024), device=dev)}
    state = init_opt_state(params)
    step = make_train_step(model, opt)
    _step_breakdown(torch, "smollm-360m train step breakdown (B 8, S 1024, "
                    "32 layers, remat)", lambda: step(params, state, batch),
                    steps=2, share_of=("bwd_dkdv", "bwd_dq", "bwd_dot",
                                       "flash_fwd"))
    del state, step, batch, toks

    # ---- train -> serve ------------------------------------------------
    path = os.path.join(ROOT, "build", "phase9", "smollm-360m.msgpack")
    t0 = time.perf_counter()
    save_checkpoint(path, params, step=TRAIN_STEPS)
    log(f"phase 9: checkpoint saved ({os.path.getsize(path) / 2 ** 20:.1f} "
        f"MiB) in {time.perf_counter() - t0:.1f} s")
    engine, bundles, _ = build_engine(
        "smollm-360m", grammars=("json",), max_len=512, slots=4,
        device="cuda", checkpoint=path)
    for (k, a), (_, b) in zip(flatten_with_path(params),
                              flatten_with_path(engine.params)):
        if not torch.equal(a, b):
            raise AssertionError(f"served params differ from the trained "
                                 f"ones at {k}")
    reqs = [Request(rid=i, prompt=f"Q{i}: produce output. A:".encode(),
                    grammar="json", max_new_tokens=32, seed=i,
                    decode=(DecodeConfig(method="greedy") if i % 2 == 0 else
                            DecodeConfig(method="sample", temperature=0.8,
                                         top_k=40, top_p=0.95)))
             for i in range(4)]
    states, stats, served = run_counted(torch, counters,
                                        lambda: engine.generate(reqs))
    report("trained smollm-360m served from its checkpoint (json, 4 "
           "requests x 32 new tokens)", states, stats, bundles, served)
    for st in states:
        log(f"  request {st.req.rid} ({st.finish_reason}): "
            f"{st.generated[:80]!r}")
    if not served["fused_mask_select"] or not served["attention"]:
        raise AssertionError(f"serving the trained checkpoint launched "
                             f"{served}")
    t0 = time.perf_counter()
    back, step_n, _ = load_checkpoint(path, params)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_path(params), flatten_with_path(back)))
    if step_n != TRAIN_STEPS or not same:
        raise AssertionError(f"checkpoint read back: step {step_n}, leaves "
                             f"equal {same}")
    log(f"phase 9: checkpoint loaded back in {time.perf_counter() - t0:.1f}"
        f" s, step {step_n}, equal to the trained params leaf for leaf")
    os.remove(path)
    del model, params, engine, bundles, back, states
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the other families ----------------------------------------------
    from repro_torch.models.model import layer_groups
    for arch, depth, B, S in TRAIN_ARCHS:
        opt = AdamWConfig(lr=1e-3, warmup_steps=2,
                          total_steps=ARCH_TRAIN_STEPS)
        model, params, result, launches, secs, peak = _train_run(
            torch, counters, arch, depth, B, S, ARCH_TRAIN_STEPS, opt)
        n_attn = sum(count for pat, count in layer_groups(model.cfg)
                     for kind in pat if kind in ("attn", "moe"))
        want = (n_attn * ARCH_TRAIN_STEPS * 2, n_attn * ARCH_TRAIN_STEPS)
        got = (launches["attention"], launches["attention_backward"])
        if got != want:
            raise AssertionError(f"{arch} training: attention launched "
                                 f"{got} (forward, backward), want {want}")
        for r in bwd_rows:
            if r["model"] == arch:
                r["launches"] = launches["attention_backward"]
        del model, params, result
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 9, {arch}: freed; "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
            f"allocated")
    return smollm_peak


# --------------------------------------------------- phase 10: audio family

# whisper-base at full width: prefill B x prompt with the encoder's frames,
# then greedy decode steps; the steps whose logits are held against a
# fresh prefill of the extended prompt
AUDIO_B, AUDIO_PROMPT, AUDIO_STEPS = 8, 16, 32
AUDIO_CHECK_STEPS = (0, 15, 31)
# training through `repro_torch.launch.train.main`: B x S, S = 448 being
# Whisper's text context (arXiv:2212.04356); steps
AUDIO_TRAIN_B, AUDIO_TRAIN_S, AUDIO_TRAIN_STEPS = 16, 448, 10
# non-causal attention rows: (label, B, Sq, Sk, H, K, Dh, dtype, causal,
# backward). The path's own shapes and routes (prefill with frames in the
# model's dtype: the encoder, cross over the prompt, cross at each decode
# step, bf16; training on the random pipeline's fp32 frames: the encoder
# in fp32, the decoder's causal self-attention in bf16, cross over the
# fp32 encoder output on the fp32 route) and edges: Sq > Sk, GQA, fp32
AUDIO_CASES = (
    ("encoder", 8, 1500, 1500, 8, 8, 64, "bfloat16", False, False),
    ("cross, prefill", 8, AUDIO_PROMPT, 1500, 8, 8, 64, "bfloat16", False,
     False),
    ("cross, decode step", 8, 1, 1500, 8, 8, 64, "bfloat16", False, False),
    ("encoder, training (fp32 frames)", AUDIO_TRAIN_B, 1500, 1500, 8, 8, 64,
     "float32", False, True),
    ("cross, training (fp32 K/V)", AUDIO_TRAIN_B, AUDIO_TRAIN_S, 1500, 8, 8,
     64, "float32", False, True),
    ("decoder self, training", AUDIO_TRAIN_B, AUDIO_TRAIN_S, AUDIO_TRAIN_S,
     8, 8, 64, "bfloat16", True, True),
    ("edge Sq > Sk", 2, 2048, 1500, 8, 8, 64, "bfloat16", False, True),
    ("edge GQA 8 over 2", 2, AUDIO_TRAIN_S, 1500, 8, 2, 64, "bfloat16",
     False, True),
    ("edge fp32 Sq > Sk", 2, 2048, 1500, 8, 8, 64, "float32", False, True),
    ("edge fp32 encoder", 2, 1500, 1500, 8, 8, 64, "float32", False, True),
)


def _tally_key(q, k, causal):
    """(q shape, k shape, causal, dtype name): the route a call takes."""
    return (tuple(q.shape), tuple(k.shape), causal,
            str(q.dtype).removeprefix("torch."))


class _ShapeTally:
    """While active, counts the attention calls that the model's layers
    make, by (q shape, k shape, causal, dtype), forward and backward: it wraps
    `models.layers.attention` (the forward op by the name the layers call)
    and the autograd Function's forward (which tags its ctx) and backward
    (which counts the tag). Each call still launches once through the
    op, whose own counter the phase checks against these counts' sum."""

    def __init__(self):
        import collections
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.models import layers
        self.layers, self.fn = layers, ops._Attention
        self.fwd = collections.Counter()
        self.bwd = collections.Counter()

    def __enter__(self):
        self.orig = (self.layers.attention, self.fn.forward, self.fn.backward)
        attn, fwd, bwd = self.orig

        def counted(q, k, v, *, causal=True, **kw):
            self.fwd[_tally_key(q, k, causal)] += 1
            return attn(q, k, v, causal=causal, **kw)

        def tagged_forward(ctx, q, k, v, causal, *rest):
            ctx.tally_key = _tally_key(q, k, causal)
            return fwd(ctx, q, k, v, causal, *rest)

        def counted_backward(ctx, do):
            self.bwd[ctx.tally_key] += 1
            return bwd(ctx, do)

        self.layers.attention = counted
        self.fn.forward = staticmethod(tagged_forward)
        self.fn.backward = staticmethod(counted_backward)
        return self

    def __exit__(self, *exc):
        attn, fwd, bwd = self.orig
        self.layers.attention = attn
        self.fn.forward, self.fn.backward = staticmethod(fwd), \
            staticmethod(bwd)


def audio_model_check(torch, np):
    """Reduced whisper-base in fp32 (2 + 2 layers, 32 frames, a 40-token
    prompt: cross attention at Sq > Sk): prefill and decode logits on the
    card (kernels) against the same weights on the CPU (plain versions),
    within 1e-3 as phase 3."""
    from dataclasses import replace
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = replace(get_config("whisper-base").reduced(), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator(device="cpu").manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gparams = bridge.to_device(params, "cuda")
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 41)))
    frames = torch.from_numpy(rng.normal(
        size=(2, cfg.audio_frames, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        lc, cc = cpu.prefill(params, {"tokens": toks[:, :40],
                                      "frames": frames}, cache_len=48)
        lg, cg = gpu.prefill(gparams, {"tokens": toks[:, :40].cuda(),
                                       "frames": frames.cuda()},
                             cache_len=48)
        pos = torch.full((2,), 40, dtype=torch.int32)
        dc, _ = cpu.decode_step(params, cc, toks[:, 40], pos)
        dg, _ = gpu.decode_step(gparams, cg, toks[:, 40].cuda(), pos.cuda())
    err_p = (lc - lg.cpu()).abs().max().item()
    err_d = (dc - dg.cpu()).abs().max().item()
    log(f"phase 10 model check (reduced whisper fp32, 40 tokens over 32 "
        f"frames, card vs CPU plain): prefill max abs err {err_p:.3e}, "
        f"decode {err_d:.3e} (tolerance 1e-3)")
    if not (err_p <= 1e-3 and err_d <= 1e-3):
        raise AssertionError("reduced whisper on the card disagrees with "
                             "the CPU")


def audio_edge_exactness(torch, np):
    """fp32, q = 0: every score is equal, so output channel c is the share
    of the keys (all visible, none past Sk) whose position has bit c set;
    any key past Sk that leaked in shows as a whole fraction."""
    from repro_torch.kernels.flash_attention.ops import attention
    dev = torch.device("cuda")
    for Sq, Sk in ((1, 1500), (48, 32), (1500, 1500), (2048, 1500)):
        pos = np.arange(Sk)
        bits = ((pos[:, None] >> np.arange(11)[None, :]) & 1).astype(
            np.float32)
        vn = np.zeros((1, Sk, 2, 64), np.float32)
        vn[0, :, :, :11] = bits[:, None, :]
        out = attention(torch.zeros((1, Sq, 8, 64), device=dev),
                        torch.randn((1, Sk, 2, 64), device=dev),
                        torch.from_numpy(vn).to(dev),
                        causal=False).cpu().numpy()
        err = np.abs(out[0, :, :, :11] - bits.mean(0)).max()
        if err > 1e-5:
            raise AssertionError(f"non-causal flash_attention Sq={Sq} "
                                 f"Sk={Sk}: keys past Sk leak ({err})")
    log("phase 10: fp32 non-causal edges exact (Sk 32 and 1500, Sq 1, 48, "
        "1500, 2048)")


def greedy_run(torch, model, params, side, prompt, steps, keep,
               routes=None):
    """Prefill `prompt` [B, P] with the side inputs `side` (a dict), then
    `steps` greedy decode steps, each synced and timed on the host. ->
    (prefill ms, [step ms], the tokens fed, {step: fp32 logits} for the
    steps in `keep`, {step: MoE routes} when `routes` records them, the
    caches, the last token)."""
    dev = prompt.device
    B, P = prompt.shape
    fed, kept, kept_routes, step_ms = [], {}, {}, []
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, {"tokens": prompt, **side},
                                       cache_len=P + steps)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if routes:
            routes.take()
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        for s in range(steps):
            t0 = time.perf_counter()
            pos = torch.full((B,), P + s, device=dev, dtype=torch.int32)
            logits, _ = model.decode_step(params, caches, tok, pos)
            fed.append(tok)
            nxt = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if s in keep:
                kept[s] = logits.float()
            if routes:
                kept_routes[s] = routes.take()
            tok = nxt
    return prefill_ms, step_ms, fed, kept, kept_routes, caches, tok


def against_fresh_prefill(torch, model, params, side, prompt, fed, kept,
                          label, kept_routes=None, routes=None, ulps=4):
    """The logits of each kept decode step against a fresh prefill of the
    prompt extended by the tokens fed so far: within `ulps` bf16 ulps at
    the largest logit, at least 2**-3 (four: the rule of phase 10 and the
    CPU tests). With `routes` (a bf16 MoE) a row is held only where each MoE
    layer routed the step's token to the same experts in both runs (a
    routing near-tie may fall the other way, as the CPU tests allow), and
    at least half the rows must be. -> (max abs errs, rows held)."""
    errs, held = [], []
    with torch.no_grad():
        for s, got in kept.items():
            toks = torch.cat([prompt] + [t[:, None] for t in fed[:s + 1]],
                             dim=1)
            want, _ = model.prefill(params, {"tokens": toks, **side})
            want = want[:, -1].float()
            rows = torch.ones(got.shape[0], dtype=torch.bool,
                              device=got.device)
            if routes:
                for a, b in zip(kept_routes[s], routes.take()):
                    rows &= (a == b).all(-1)
            n = int(rows.sum())
            top = want[rows].abs().max().item() if n else 0.0
            tol = max(2.0 ** -3, ulps * 2.0 ** (math.floor(math.log2(top))
                                                - 7)) if top else 2.0 ** -3
            err = (got[rows] - want[rows]).abs().max().item() if n else 0.0
            errs.append(err)
            held.append(n)
            if not (torch.isfinite(got).all() and err <= tol and
                    2 * n >= got.shape[0]):
                raise AssertionError(f"{label} decode step {s}: logits "
                                     f"differ from a fresh prefill by {err}"
                                     f" > {tol} ({n} rows held)")
    return errs, held


def audio_decode(torch, counters, rows):
    """whisper-base at full width (6 + 6 layers, d_model 512, V 51865,
    bf16, seeded random weights): prefill AUDIO_B x AUDIO_PROMPT tokens
    with [B, 1500, 512] frames, then AUDIO_STEPS greedy decode steps, the
    counters zeroed just before and read just after; the logits of
    AUDIO_CHECK_STEPS against a fresh prefill of the extended prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import dtype_of
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves
    dev = torch.device("cuda")
    cfg = get_config("whisper-base")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((AUDIO_B, cfg.audio_frames, cfg.d_model),
                         device=dev, generator=g).to(dtype_of(cfg))
    prompt = torch.randint(3, cfg.vocab_size, (AUDIO_B, AUDIO_PROMPT),
                           device=dev, generator=g, dtype=torch.int32)
    log(f"phase 10, whisper-base: {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, V {cfg.vocab_size}, {cfg.dtype}; "
        f"{n_params / 1e6:.1f} M params; B {AUDIO_B}, frames "
        f"{cfg.audio_frames}, prompt {AUDIO_PROMPT}, {AUDIO_STEPS} greedy "
        f"steps")
    side = {"frames": frames}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(torch, counters)
    with _ShapeTally() as tally:
        prefill_ms, step_ms, fed, kept, _, caches, tok = greedy_run(
            torch, model, params, side, prompt, AUDIO_STEPS,
            AUDIO_CHECK_STEPS)
    launches = read_counters(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    want_fwd = cfg.encoder_layers + 2 * cfg.num_layers + \
        AUDIO_STEPS * cfg.num_layers
    if launches["attention"] != want_fwd or \
            sum(tally.fwd.values()) != want_fwd:
        raise AssertionError(f"whisper-base prefill + {AUDIO_STEPS} steps: "
                             f"attention launched {launches['attention']} "
                             f"times ({dict(tally.fwd)}), want {want_fwd}")
    for r in rows:
        if r["name"] == "flash_attention":
            r["launches"] += tally.fwd[r["key"]]
    errs, _ = against_fresh_prefill(torch, model, params, side, prompt, fed,
                                    kept, "whisper-base")
    log(f"phase 10, whisper-base: prefill (encoder included) {prefill_ms:.2f}"
        f" ms; decode {statistics.median(step_ms):.3f} ms/step median, "
        f"{sum(step_ms) / len(step_ms):.3f} mean (wall, synced each step); "
        f"flash_attention launches {launches['attention']} = "
        f"{cfg.encoder_layers} encoder + {cfg.num_layers} self + "
        f"{cfg.num_layers} cross at prefill + {AUDIO_STEPS} x "
        f"{cfg.num_layers} cross; by shape {dict(tally.fwd)}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; logits at steps {AUDIO_CHECK_STEPS} vs "
        f"a fresh prefill: max abs err {', '.join(f'{e:.3e}' for e in errs)}"
        f" (tolerance: 4 bf16 ulps at the largest logit, at least 2**-3)")
    pos = torch.full((AUDIO_B,), AUDIO_PROMPT + AUDIO_STEPS - 1, device=dev,
                     dtype=torch.int32)

    def step():
        with torch.no_grad():
            model.decode_step(params, caches, tok, pos)

    _step_breakdown(torch, f"whisper-base decode step breakdown (B {AUDIO_B}, "
                    f"{cfg.num_layers} decoder layers, cross over "
                    f"{cfg.audio_frames} frames)", step,
                    share_of=("flash_fwd",))
    del model, params, caches, frames
    gc.collect()
    torch.cuda.empty_cache()


def audio_train(torch, counters, rows):
    """whisper-base trained at full width through
    `repro_torch.launch.train.main` (`--grammar random`: the random
    pipeline draws the frames), its `train` logging every step; every
    loss finite, attention launches exactly 18 a step forward twice
    (remat) and once backward; the checkpoint saved, loaded back, and
    giving the same logits; then `audio_fit_one_batch`."""
    import repro_torch.launch.train as launch_train
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.training.tree import flatten_with_path
    cfg = get_config("whisper-base")
    path = os.path.join(ROOT, "build", "phase10", "whisper-base.msgpack")
    argv = ["--arch", "whisper-base", "--grammar", "random", "--steps",
            str(AUDIO_TRAIN_STEPS), "--batch", str(AUDIO_TRAIN_B), "--seq",
            str(AUDIO_TRAIN_S), "--lr", "1e-3", "--seed", "0",
            "--checkpoint", path]
    log(f"phase 10: python -m repro_torch.launch.train {' '.join(argv)} "
        f"(logging every step)")
    train = launch_train.train
    launch_train.train = lambda *a, **kw: train(*a, **dict(kw, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(torch, counters)
    try:
        with _ShapeTally() as tally:
            t0 = time.perf_counter()
            params, result = launch_train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        launch_train.train = train
    launches = read_counters(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    losses = result.losses
    if len(losses) != AUDIO_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"whisper-base training: losses {losses} (want "
                             f"{AUDIO_TRAIN_STEPS}, all finite)")
    per_step = cfg.encoder_layers + 2 * cfg.num_layers
    want = (per_step * AUDIO_TRAIN_STEPS * 2, per_step * AUDIO_TRAIN_STEPS)
    got = (launches["attention"], launches["attention_backward"])
    if got != want or (sum(tally.fwd.values()),
                       sum(tally.bwd.values())) != want:
        raise AssertionError(f"whisper-base training: attention launched "
                             f"{got} (forward, backward), want {want}; by "
                             f"shape {dict(tally.fwd)} / {dict(tally.bwd)}")
    for r in rows:
        r["launches"] += (tally.bwd if r["name"].endswith("_bwd") else
                          tally.fwd)[r["key"]]
    sps = result.steps_per_sec
    log(f"phase 10, whisper-base training: {AUDIO_TRAIN_STEPS} steps, "
        f"B {AUDIO_TRAIN_B} x S {AUDIO_TRAIN_S} (frames [{AUDIO_TRAIN_B}, "
        f"{cfg.audio_frames}, {cfg.d_model}]), remat {cfg.remat}: "
        f"{1e3 / sps:.1f} ms/step, {sps * AUDIO_TRAIN_B * AUDIO_TRAIN_S:.0f} "
        f"tokens/s (train(); main() {secs:.1f} s with the build and the "
        f"checkpoint); losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"attention launches {got[0]} forward / {got[1]} backward = "
        f"{per_step} x {AUDIO_TRAIN_STEPS} x (2, 1); by shape "
        f"{dict(tally.fwd)} / {dict(tally.bwd)}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    model = build_model(cfg, device="cuda")
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (AUDIO_TRAIN_B, AUDIO_TRAIN_S + 1),
                         device=dev, generator=g, dtype=torch.int32)
    ready = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((AUDIO_TRAIN_B, AUDIO_TRAIN_S),
                                     device=dev),
             "frames": torch.randn((AUDIO_TRAIN_B, cfg.audio_frames,
                                    cfg.d_model), device=dev, generator=g)}
    state = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=AUDIO_TRAIN_STEPS))
    _step_breakdown(torch, f"whisper-base train step breakdown on a ready "
                    f"batch (B {AUDIO_TRAIN_B}, S {AUDIO_TRAIN_S}, frames "
                    f"{cfg.audio_frames}, remat)",
                    lambda: step(params, state, ready), steps=2,
                    share_of=("bwd_dkdv", "bwd_dq", "bwd_dot", "flash_fwd"))
    del state, step, ready, toks
    back, step_n, _ = load_checkpoint(path, params)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_path(params), flatten_with_path(back)))
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                                     generator=g, dtype=torch.int32),
             "frames": torch.randn((2, cfg.audio_frames, cfg.d_model),
                                   device=dev, generator=g)}
    with torch.no_grad():
        a, _ = model.train_logits(params, batch)
        b, _ = model.train_logits(back, batch)
    if step_n != AUDIO_TRAIN_STEPS or not same or not torch.equal(a, b) \
            or not torch.isfinite(a).all():
        raise AssertionError(f"whisper-base checkpoint: step {step_n}, "
                             f"leaves equal {same}, logits equal "
                             f"{torch.equal(a, b)}")
    log(f"phase 10: checkpoint ({os.path.getsize(path) / 2 ** 20:.1f} MiB) "
        f"loaded back at step {step_n}, equal leaf for leaf, the same "
        f"logits [2, 24, {cfg.vocab_size}] bit for bit")
    os.remove(path)
    del model, params, back, a, b
    gc.collect()
    torch.cuda.empty_cache()
    audio_fit_one_batch(torch, cfg)


def audio_fit_one_batch(torch, cfg):
    """The same model, optimizer and shapes as `audio_train`, stepped on
    one random batch (the pipeline's first) AUDIO_TRAIN_STEPS times: the
    loss must fall (last below first). The random pipeline's labels are
    drawn apart from its inputs, so its fresh batches leave nothing to
    learn but the uniform marginal, and over 10 steps their losses stay
    within batch-to-batch noise (as `audio_train` prints them); a fixed
    batch can be fitted, so a broken gradient anywhere on the path (the
    encoder's and cross attention's backward kernels included) shows."""
    from repro_torch.models.model import build_model
    from repro_torch.training.data import RandomTokenPipeline
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    first = next(RandomTokenPipeline(cfg, AUDIO_TRAIN_S, AUDIO_TRAIN_B,
                                     seed=0))
    data = ({k: v.copy() for k, v in first.items()}
            for _ in range(AUDIO_TRAIN_STEPS))
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(10, AUDIO_TRAIN_STEPS // 20),
                      total_steps=AUDIO_TRAIN_STEPS)
    _, result = train(model, params, data, AUDIO_TRAIN_STEPS, opt_cfg=opt,
                      log_every=1, verbose=False, device="cuda")
    losses = result.losses
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"whisper-base on one batch: losses {losses} "
                             f"(want all finite, the last below the first)")
    log(f"phase 10, whisper-base fitted to one batch ({AUDIO_TRAIN_STEPS} "
        f"steps, the same optimizer): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_audio(torch, np, counters):
    """Phase 10: the audio family (whisper-base) on the card. -> rows."""
    audio_model_check(torch, np)
    audio_edge_exactness(torch, np)
    rows = []
    for label, B, Sq, Sk, H, K, Dh, dt, causal, bwd in AUDIO_CASES:
        rows += attention_case_rows(
            torch, "whisper-base", label, B, Sq, Sk, H, K, Dh, dt,
            causal=causal, backward=bwd,
            path_shape=not label.startswith("edge"))
    audio_decode(torch, counters, rows)
    audio_train(torch, counters, rows)
    return rows


# ------------------------------- phase 11: vlm family and the text configs

VLM = "llama-3.2-vision-90b"
# the model level: 2 periods of (4 attn + cross) of its 100 layers (the
# rest would lie on further chips as pipeline stages; PERF.md §4), B x
# prompt with [B, 1601, 8192] bf16 image embeddings, greedy steps, and the
# steps held against a fresh prefill
VLM_DEPTH, VLM_B, VLM_PROMPT, VLM_STEPS = 10, 8, 16, 32
VLM_CHECK_STEPS = (0, 15, 31)
# every gate starts at zero (tanh(0) = 0: a cross layer adds nothing and
# its attention gets no gradient); every vlm run here opens them
VLM_GATE = 0.5
# training: one period, with one chip's share of an 8-way split of the
# 128256-row vocabulary (the embedding and the head): 4.542 B params,
# 54.5 GB at 12 bytes a param (bf16 weights and grads, fp32 moments); the
# whole vocabulary (6.380 B, 76.6 GB) does not fit. B x S text tokens over
# the random pipeline's fp32 image embeddings, one batch fitted
VLM_TRAIN_DEPTH, VLM_TRAIN_VOCAB = 5, 128256 // 8
VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_STEPS = 2, 1024, 5
# attention rows: (label, B, Sq, Sk, H, K, Dh, dtype, causal, backward):
# the path's shapes (prefill: self over the prompt, cross over the 1601
# image tokens; decode: cross; training: causal self, cross on the fp32
# route that fp32 image embeddings take) and edges (Sq > Sk; a small odd
# Sk in both dtypes)
VLM_CASES = (
    ("self, prefill", VLM_B, VLM_PROMPT, VLM_PROMPT, 64, 8, 128, "bfloat16",
     True, False),
    ("cross, prefill", VLM_B, VLM_PROMPT, 1601, 64, 8, 128, "bfloat16",
     False, False),
    ("cross, decode step", VLM_B, 1, 1601, 64, 8, 128, "bfloat16", False,
     False),
    ("self, training", VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_S, 64, 8, 128,
     "bfloat16", True, True),
    ("cross, training (fp32 K/V)", VLM_TRAIN_B, VLM_TRAIN_S, 1601, 64, 8,
     128, "float32", False, True),
    ("edge Sq > Sk", 2, 2048, 1601, 64, 8, 128, "bfloat16", False, True),
    ("edge odd Sk", 2, 24, 17, 64, 8, 128, "bfloat16", False, True),
    ("edge fp32 odd Sk", 2, 24, 17, 64, 8, 128, "float32", False, True),
)
# the four remaining text configs at full width: (arch, layers kept or
# None for all); each cut in PERF.md §4. Prefill B x prompt, greedy steps,
# the steps held against a fresh prefill
TEXT_ARCHS = (("qwen1.5-0.5b", None), ("internlm2-1.8b", None),
              ("deepseek-coder-33b", 8), ("kimi-k2-1t-a32b", 2))
TEXT_B, TEXT_PROMPT, TEXT_STEPS = 8, 16, 8
TEXT_CHECK_STEPS = (0, 7)


def open_gates(params, value):
    """Every `gate` leaf of a vlm param tree set to `value`, in place."""
    for group in params["groups"]:
        for layer in group:
            if "gate" in layer:
                layer["gate"].fill_(value)


class _Routes:
    """While active, records the experts each MoE layer routes its last
    position to ([B, k] ids, sorted; -1 for a pair dropped past the
    expert's capacity), by wrapping `models.layers.moe_ffn` (the router's
    own arithmetic: fp32 softmax, a stable descending sort cut at k; a
    pair's place in its expert counts the row's earlier pairs). Under a
    trunk split of the experts (phase 14) the rank's router columns are
    gathered first, a collective every rank makes at the same call."""

    def __enter__(self):
        from repro_torch.distributed.api import (all_gather_last,
                                                 current_mesh, current_trunk)
        from repro_torch.models import layers
        from repro_torch.models.moe import capacity
        self.layers, self.orig, self.calls = layers, layers.moe_ffn, []

        def spy(p, x, cfg):
            B, S, _ = x.shape
            logits = x.float() @ p["router"]
            tp = current_trunk()
            if tp is not None and tp.experts_split:
                logits = all_gather_last(logits, (tp.experts,) * tp.size,
                                         current_mesh())
            probs = logits.softmax(-1)
            top = probs.sort(dim=-1, descending=True, stable=True).indices[
                ..., :cfg.experts_per_token]                  # [B, S, k]
            last, earlier = top[:, -1], top[:, :-1].reshape(B, 1, -1)
            ahead = (earlier == last[..., None]).sum(-1)      # [B, k]
            self.calls.append(last.masked_fill(
                ahead >= capacity(cfg, S), -1).sort(-1).values)
            return self.orig(p, x, cfg)

        layers.moe_ffn = spy
        return self

    def take(self):
        calls, self.calls = self.calls, []
        return calls

    def __exit__(self, *exc):
        self.layers.moe_ffn = self.orig


def vlm_model_check(torch, np):
    """Reduced llama-3.2-vision in fp32 (one (attn, cross) period, 16
    image tokens, gates open, a 24-token prompt: cross attention at Sq >
    Sk): prefill and decode logits on the card (kernels) against the same
    weights on the CPU (plain versions), within 1e-3 as phase 3."""
    from dataclasses import replace
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = replace(get_config(VLM).reduced(), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator(device="cpu").manual_seed(0))
    open_gates(params, VLM_GATE)
    gpu = build_model(cfg, device="cuda")
    gparams = bridge.to_device(params, "cuda")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 25)))
    emb = torch.from_numpy(rng.normal(
        size=(2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        lc, cc = cpu.prefill(params, {"tokens": toks[:, :24],
                                      "image_embeds": emb}, cache_len=32)
        lg, cg = gpu.prefill(gparams, {"tokens": toks[:, :24].cuda(),
                                       "image_embeds": emb.cuda()},
                             cache_len=32)
        pos = torch.full((2,), 24, dtype=torch.int32)
        dc, _ = cpu.decode_step(params, cc, toks[:, 24], pos)
        dg, _ = gpu.decode_step(gparams, cg, toks[:, 24].cuda(), pos.cuda())
    err_p = (lc - lg.cpu()).abs().max().item()
    err_d = (dc - dg.cpu()).abs().max().item()
    log(f"phase 11 model check (reduced llama-3.2-vision fp32, gates "
        f"{VLM_GATE}, 24 tokens over 16 image tokens, card vs CPU plain): "
        f"prefill max abs err {err_p:.3e}, decode {err_d:.3e} (tolerance "
        f"1e-3)")
    if not (err_p <= 1e-3 and err_d <= 1e-3):
        raise AssertionError("reduced llama-3.2-vision on the card "
                             "disagrees with the CPU")


def _attn_counts(model):
    """-> (self-attention layers, cross layers) of the model's stack."""
    from repro_torch.models.model import layer_groups
    kinds = [k for pat, count in layer_groups(model.cfg)
             for k in pat * count]
    return (sum(k in ("attn", "moe") for k in kinds),
            sum(k == "cross" for k in kinds))


def vlm_decode(torch, counters, rows, depth=None, ulps=4):
    """llama-3.2-vision at full width, the first `depth` layers (bf16,
    seeded random weights, gates open): prefill VLM_B x VLM_PROMPT tokens
    with [B, 1601, 8192] image embeddings, then VLM_STEPS greedy decode
    steps, the counters zeroed just before and read just after (flash
    launches by shape: a self call per attention layer and a cross call
    per cross layer at prefill, a cross call per cross layer a step); the
    logits of VLM_CHECK_STEPS against a fresh prefill; other image
    embeddings must move the logits; one step's breakdown."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves
    dev = torch.device("cuda")
    depth = depth or VLM_DEPTH
    cfg = replace(get_config(VLM), num_layers=depth)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    open_gates(params, VLM_GATE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    n_self, n_cross = _attn_counts(model)
    g = torch.Generator(device=dev).manual_seed(1)
    emb = torch.randn((VLM_B, cfg.num_image_tokens, cfg.d_model),
                      device=dev, generator=g).to(torch.bfloat16)
    prompt = torch.randint(3, cfg.vocab_size, (VLM_B, VLM_PROMPT),
                           device=dev, generator=g, dtype=torch.int32)
    log(f"phase 11, {VLM}: {depth} of {get_config(VLM).num_layers} layers "
        f"({n_self} attn + {n_cross} cross), d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, V {cfg.vocab_size}, "
        f"{cfg.dtype}, gates {VLM_GATE}; {n_params / 1e9:.3f} B params "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s); B {VLM_B}, "
        f"{cfg.num_image_tokens} image tokens, prompt {VLM_PROMPT}, "
        f"{VLM_STEPS} greedy steps")
    side = {"image_embeds": emb}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(torch, counters)
    with _ShapeTally() as tally:
        prefill_ms, step_ms, fed, kept, _, caches, tok = greedy_run(
            torch, model, params, side, prompt, VLM_STEPS, VLM_CHECK_STEPS)
    launches = read_counters(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    want_fwd = n_self + n_cross + VLM_STEPS * n_cross
    if launches["attention"] != want_fwd or \
            sum(tally.fwd.values()) != want_fwd:
        raise AssertionError(f"{VLM} prefill + {VLM_STEPS} steps: attention "
                             f"launched {launches['attention']} times "
                             f"({dict(tally.fwd)}), want {want_fwd}")
    for r in rows:
        if r["name"] == "flash_attention":
            r["launches"] += tally.fwd[r["key"]]
    errs, _ = against_fresh_prefill(torch, model, params, side, prompt, fed,
                                    kept, VLM, ulps=ulps)
    with torch.no_grad():
        a, _ = model.prefill(params, {"tokens": prompt, **side})
        other = torch.randn(emb.shape, device=dev, generator=g).to(emb.dtype)
        b, _ = model.prefill(params, {"tokens": prompt,
                                      "image_embeds": other})
    moved = (a.float() - b.float()).abs().max().item()
    if not moved > 1e-2:
        raise AssertionError(f"{VLM}: other image embeddings moved the "
                             f"logits by {moved} only")
    log(f"phase 11, {VLM}: prefill {prefill_ms:.2f} ms; decode "
        f"{statistics.median(step_ms):.3f} ms/step median, "
        f"{sum(step_ms) / len(step_ms):.3f} mean (wall, synced each step); "
        f"flash_attention launches {launches['attention']} = {n_self} self"
        f" + {n_cross} cross at prefill + {VLM_STEPS} x {n_cross} cross; by "
        f"shape {dict(tally.fwd)}; peak memory {peak / 2 ** 30:.2f} GiB; "
        f"logits at steps {VLM_CHECK_STEPS} vs a fresh prefill: max abs err "
        f"{', '.join(f'{e:.3e}' for e in errs)} (tolerance: {ulps} bf16 ulps "
        f"at the largest logit, at least 2**-3); other image embeddings move "
        f"the prompt's logits by up to {moved:.3e}")
    pos = torch.full((VLM_B,), VLM_PROMPT + VLM_STEPS - 1, device=dev,
                     dtype=torch.int32)

    def step():
        with torch.no_grad():
            model.decode_step(params, caches, tok, pos)

    _step_breakdown(torch, f"{VLM} decode step breakdown (B {VLM_B}, {depth} "
                    f"layers, cross over {cfg.num_image_tokens} image "
                    f"tokens; the weights alone are "
                    f"{n_params * 2 / 1e9:.1f} GB a step, "
                    f"{n_params * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms at "
                    f"3.35 TB/s)", step, share_of=("flash_fwd",))
    del model, params, caches, emb, other, a, b
    gc.collect()
    torch.cuda.empty_cache()


def vlm_train(torch, counters, rows):
    """llama-3.2-vision trained on one chip's share: VLM_TRAIN_DEPTH layers
    (one period) and VLM_TRAIN_VOCAB vocabulary rows (a config
    `dataclasses.replace`d here), gates open, remat on, AdamW; the
    `RandomTokenPipeline`'s first batch (fp32 image embeddings: every
    cross layer takes the fp32 route, forward and backward) fitted
    VLM_TRAIN_STEPS times: every loss finite, the last below the first;
    attention launches exact (each layer's forward twice a step with
    remat, its backward once), by shape; peak memory beside the 12 bytes
    a param of the steady state, split into the forward + backward's and
    the AdamW update's, with what the update starts from."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.data import RandomTokenPipeline
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    from repro_torch.training.tree import leaves
    cfg = replace(get_config(VLM), num_layers=VLM_TRAIN_DEPTH,
                  vocab_size=VLM_TRAIN_VOCAB)
    model = build_model(cfg, device="cuda")
    init = [model.init(torch.Generator(device="cuda").manual_seed(0))]
    open_gates(init[0], VLM_GATE)
    n_params = sum(p.numel() for p in leaves(init[0]))
    n_self, n_cross = _attn_counts(model)
    first = next(RandomTokenPipeline(cfg, VLM_TRAIN_S, VLM_TRAIN_B, seed=0))
    data = ({k: v.copy() for k, v in first.items()}
            for _ in range(VLM_TRAIN_STEPS))
    opt = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=VLM_TRAIN_STEPS)
    log(f"phase 11, {VLM} training: {VLM_TRAIN_DEPTH} of "
        f"{get_config(VLM).num_layers} layers ({n_self} attn + {n_cross} "
        f"cross), vocab {VLM_TRAIN_VOCAB} of 128256 (one chip's share of an"
        f" 8-way split), remat {cfg.remat}; {n_params / 1e9:.3f} B params, "
        f"steady state {n_params * 12 / 1e9:.1f} GB at 12 bytes a param; "
        f"B {VLM_TRAIN_B} x S {VLM_TRAIN_S}, image embeds "
        f"{first['image_embeds'].dtype} {list(first['image_embeds'].shape)};"
        f" {VLM_TRAIN_STEPS} AdamW steps on one batch (lr {opt.lr})")
    import repro_torch.training.train_loop as train_loop
    apply_updates = train_loop.apply_updates
    split = {"forward + backward": 0, "update": 0, "at the update": 0}

    def measured(*args):
        """The step's AdamW update, with the peak before it and its own
        peak read apart (each step's forward + backward peak is read at
        the update's entry, the peak counted from the last update's end)."""
        torch.cuda.synchronize()
        split["forward + backward"] = max(split["forward + backward"],
                                          torch.cuda.max_memory_allocated())
        split["at the update"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = apply_updates(*args)
        torch.cuda.synchronize()
        split["update"] = max(split["update"],
                              torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(torch, counters)
    train_loop.apply_updates = measured
    try:
        with _ShapeTally() as tally:
            t0 = time.perf_counter()
            params, result = train(model, init.pop(), data, VLM_TRAIN_STEPS,
                                   opt_cfg=opt, log_every=1, verbose=True,
                                   device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        train_loop.apply_updates = apply_updates
    launches = read_counters(torch, counters)
    peak = max(split["forward + backward"], split["update"])
    losses = result.losses
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{VLM} training: losses {losses} (want all "
                             f"finite, the last below the first)")
    per_step = n_self + n_cross
    want = (per_step * VLM_TRAIN_STEPS * 2, per_step * VLM_TRAIN_STEPS)
    got = (launches["attention"], launches["attention_backward"])
    if got != want or (sum(tally.fwd.values()),
                       sum(tally.bwd.values())) != want:
        raise AssertionError(f"{VLM} training: attention launched {got} "
                             f"(forward, backward), want {want}; by shape "
                             f"{dict(tally.fwd)} / {dict(tally.bwd)}")
    for r in rows:
        r["launches"] += (tally.bwd if r["name"].endswith("_bwd") else
                          tally.fwd)[r["key"]]
    sps = result.steps_per_sec
    log(f"phase 11, {VLM} training: {1e3 / sps:.1f} ms/step, "
        f"{sps * VLM_TRAIN_B * VLM_TRAIN_S:.0f} tokens/s (train(); "
        f"{secs:.1f} s in all); losses {', '.join(f'{x:.4f}' for x in losses)}"
        f"; attention launches {got[0]} forward / {got[1]} backward = "
        f"{per_step} x {VLM_TRAIN_STEPS} x (2, 1); by shape "
        f"{dict(tally.fwd)} / {dict(tally.bwd)}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB = {peak / 1e9:.1f} GB against the "
        f"{n_params * 12 / 1e9:.1f} GB steady state (GB: " + ", ".join(
            f"{k} {v / 1e9:.1f}" for k, v in split.items()) + ")")
    del model, params, result, data, first
    gc.collect()
    torch.cuda.empty_cache()


def text_config_check(torch, counters, arch, depth, ulps=4):
    """One text config at full width (its first `depth` layers, or all),
    bf16, seeded random weights: prefill TEXT_B x TEXT_PROMPT tokens, then
    TEXT_STEPS greedy decode steps (counters zeroed just before, read just
    after: one flash launch per attention layer at prefill), the logits
    of TEXT_CHECK_STEPS against a fresh prefill (rows routed alike, for
    the MoE). -> the prefill's flash launches by shape."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves
    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = replace(full, num_layers=depth) if depth else full
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    n_self, _ = _attn_counts(model)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(3, cfg.vocab_size, (TEXT_B, TEXT_PROMPT),
                           device=dev, generator=g, dtype=torch.int32)
    moe = cfg.arch_type == "moe"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(torch, counters)
    with _Routes() as routes:
        with _ShapeTally() as tally:
            prefill_ms, step_ms, fed, kept, kept_routes, _, _ = greedy_run(
                torch, model, params, {}, prompt, TEXT_STEPS,
                TEXT_CHECK_STEPS, routes=routes if moe else None)
        launches = read_counters(torch, counters)
        peak = torch.cuda.max_memory_allocated()
        errs, held = against_fresh_prefill(
            torch, model, params, {}, prompt, fed, kept, arch,
            kept_routes=kept_routes, routes=routes if moe else None,
            ulps=ulps)
    if launches["attention"] != n_self or \
            sum(tally.fwd.values()) != n_self:
        raise AssertionError(f"{arch}: attention launched "
                             f"{launches['attention']} times, want {n_self}"
                             f" ({dict(tally.fwd)})")
    log(f"phase 11, {arch} ({cfg.arch_type}): {cfg.num_layers} of "
        f"{full.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, V {cfg.vocab_size}"
        + (f", {cfg.num_experts} experts top-{cfg.experts_per_token}, "
           f"{cfg.first_dense_layers} dense first" if moe else "")
        + (", QKV bias" if cfg.qkv_bias else "")
        + f"; {n_params / 1e9:.3f} B params, built in {build_s:.1f} s; "
        f"prefill B {TEXT_B} x {TEXT_PROMPT} {prefill_ms:.2f} ms; decode "
        f"{statistics.median(step_ms):.3f} ms/step median ({TEXT_STEPS} "
        f"steps, synced); flash launches {launches['attention']} = "
        f"{n_self} layers; peak memory {peak / 2 ** 30:.2f} GiB; logits at "
        f"steps {TEXT_CHECK_STEPS} vs a fresh prefill: max abs err "
        f"{', '.join(f'{e:.3e}' for e in errs)} over {held} of {TEXT_B} "
        f"rows (tolerance: {ulps} bf16 ulps at the largest logit, at least "
        f"2**-3" + ("; rows routed alike in both runs" if moe else "") + ")")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return tally.fwd


def phase_vlm(torch, np, counters):
    """Phase 11: llama-3.2-vision on the card, then the four text
    configs. -> rows."""
    vlm_model_check(torch, np)
    rows = []
    for label, B, Sq, Sk, H, K, Dh, dt, causal, bwd in VLM_CASES:
        rows += attention_case_rows(
            torch, VLM, label, B, Sq, Sk, H, K, Dh, dt, causal=causal,
            backward=bwd, path_shape=not label.startswith("edge"))
    vlm_decode(torch, counters, rows)
    vlm_train(torch, counters, rows)
    for arch, depth in TEXT_ARCHS:
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        row = attention_case_rows(
            torch, arch, "self, prefill", TEXT_B, TEXT_PROMPT, TEXT_PROMPT,
            cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.dtype, causal=True, backward=False)
        row[0]["launches"] = text_config_check(torch, counters, arch,
                                               depth)[row[0]["key"]]
        rows += row
    return rows


# ------------------------------------------------------------ phase 12

SHARD_V = 50280         # the kernel check's vocab: W 1572, 2 shards
SHARD_NEW = 32          # new tokens of the 8 requests of the dense runs
# world 1 dense runs a side, in alternating order (one, for the script's
# time)
SHARD_PAIRS = 1
                        # (3 until phase 15 came, for the script's time)


def sharded_requests():
    """Phase 5's first 8 requests at 32 new tokens."""
    reqs = e2e_requests()[:8]
    for r in reqs:
        r.max_new_tokens = SHARD_NEW
    return reqs


def same_prefix(got, want):
    """A run cut at fewer new tokens agrees with a longer one: equal
    where both finished by eos, else a prefix of it."""
    bad = []
    for rid, (ids, reason) in got.items():
        full, full_reason = want[rid]
        if reason == "eos" or full_reason == "eos" and len(full) <= len(ids):
            ok = (ids, reason) == (full, full_reason)
        else:
            ok = ids == full[:len(ids)]
        if not ok:
            bad.append(rid)
    return bad


def sharded_world2_rank(rank, n):
    """One rank of the 2-rank gloo world on the one card: smollm-360m at
    full width, vocab split 24576 + 24576, phase 12's 8 requests. ->
    tokens, stats and this rank's kernel launches."""
    import torch
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.masked_logits.ops import apply_grammar_mask
    from repro_torch.launch.serve import build_engine
    engine, bundles, _ = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda", mesh=n)
    engine.generate(sharded_requests()[:1])          # warm-up
    counters = (apply_grammar_mask, fused_mask_select)
    states, stats, launches = run_counted(
        torch, counters, lambda: engine.generate(sharded_requests()))
    complete, valid = check_outputs(states, bundles)
    return {"tokens": tokens_of(states), "steps": stats.decode_steps,
            "wall": stats.wall, "launches": launches,
            "store": tuple(engine._store_cat.shape),
            "device": str(engine.device), "backend": engine.mesh.backend,
            "complete": complete, "valid": valid,
            "mesh_devices": stats.mesh_devices}


def sharded_world1(rank, torch, counters, unsharded, out):
    """The 1-rank NCCL world, in this process: smollm-360m at full width,
    the unsharded engine and the sharded one on the same weights."""
    from repro_torch.distributed.api import all_gather_last, vocab_all_reduce
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Engine
    eng, bundles, tok = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda", mesh=1)
    if eng.mesh.backend != "nccl" or eng.mesh.size != 1:
        raise AssertionError(f"world 1: {eng.mesh.backend} x "
                             f"{eng.mesh.size}, want nccl x 1")
    # at M = 1 the rank's block is the whole tree: the same tensors
    plain = Engine(eng.model, eng.params, tok, bundles, max_len=512,
                   slots=8, device="cuda")
    plain.generate(sharded_requests()[:1])           # warm-up
    eng.generate(sharded_requests()[:1])
    # alternating order (u s, s u, u s, ...) so that drift on the host
    # falls on both sides alike
    order = []
    for i in range(SHARD_PAIRS):
        order += [("unsharded", plain), ("sharded", eng)][::1 - 2 * (i % 2)]
    ms = {"unsharded": [], "sharded": []}
    launches, u_tok = {}, None
    for name, e in order:
        states, stats, lc = run_counted(
            torch, counters, lambda: e.generate(sharded_requests()))
        check_outputs(states, bundles)
        got = tokens_of(states)
        if u_tok is None:
            u_tok = got
            bad = same_prefix(got, unsharded["dense"])
            if bad:
                raise AssertionError(f"world 1: requests {bad} differ from "
                                     f"phase 5's dense run")
        if got != u_tok:
            raise AssertionError(f"world 1: {name} dense tokens differ from "
                                 f"the first run's")
        want = stats.decode_steps if name == "sharded" else 0
        if lc["apply_grammar_mask"] != want or \
                lc["fused_mask_select"] < stats.decode_steps:
            raise AssertionError(f"world 1 {name} dense launches {lc} in "
                                 f"{stats.decode_steps} steps")
        launches[name] = (lc, stats.decode_steps)
        ms[name].append(1e3 * stats.wall / stats.decode_steps)
    med = {k: statistics.median(v) for k, v in ms.items()}
    s_l, steps = launches["sharded"]
    log(f"phase 12 world 1 (NCCL, in process) dense, 8 requests x "
        f"{SHARD_NEW}: tokens identical to the unsharded engine's and to "
        f"phase 5's; ms a step over {SHARD_PAIRS} runs a side in "
        f"alternating order: sharded median {med['sharded']:.2f} (range "
        f"{min(ms['sharded']):.2f}-{max(ms['sharded']):.2f}; "
        f"{[round(x, 2) for x in ms['sharded']]}), unsharded median "
        f"{med['unsharded']:.2f} (range {min(ms['unsharded']):.2f}-"
        f"{max(ms['unsharded']):.2f}; "
        f"{[round(x, 2) for x in ms['unsharded']]}); {steps} steps; "
        f"launches sharded {s_l}, unsharded {launches['unsharded'][0]}")
    out["dense"] = (ms, s_l, steps)
    out["u_tokens"] = u_tok

    states, stats, sl = run_counted(
        torch, counters, lambda: eng.generate_speculative(e2e_requests()))
    check_outputs(states, bundles)
    if tokens_of(states) != unsharded["spec"]:
        raise AssertionError("world 1: sharded speculative tokens differ "
                             "from phase 5's")
    if sl["apply_grammar_mask_span"] != stats.decode_steps:
        raise AssertionError(f"world 1 speculative launches {sl} in "
                             f"{stats.decode_steps} span steps")
    log(f"phase 12 world 1 speculative, dense caches (16 x 64): tokens "
        f"identical to phase 5's; {stats.decode_steps} steps, "
        f"{1e3 * stats.wall / stats.decode_steps:.2f} ms a step; launches "
        f"{sl}")
    out["spec"] = sl

    paged = Engine(eng.model, eng.params, tok, bundles, max_len=512,
                   slots=8, paged=True, page_size=16, device="cuda",
                   mesh=eng.mesh)
    shared, _ = shared_prefix_requests(paged)
    states, stats, pl = run_counted(
        torch, counters, lambda: paged.generate(e2e_requests() + shared))
    check_outputs(states, bundles)
    if tokens_of(states) != unsharded["paged"]:
        raise AssertionError("world 1: sharded paged tokens differ from "
                             "phase 5's")
    if not stats.prefix_hit_rate > 0:
        raise AssertionError("world 1 paged run shared no prefix page")
    log(f"phase 12 world 1 paged (16 + 8 sharing a prefix): tokens "
        f"identical to phase 5's; prefix hit rate "
        f"{stats.prefix_hit_rate:.4f}; {stats.decode_steps} steps, "
        f"{1e3 * stats.wall / stats.decode_steps:.2f} ms a step; launches "
        f"{pl}")
    out["paged"] = pl

    # the collectives alone, at the dense step's shapes
    V = eng.model.cfg.vocab_size
    x = torch.randn(8, V, device="cuda").bfloat16()
    h = torch.randn(8, 1, eng.model.cfg.d_model, device="cuda").bfloat16()
    vs, mesh = eng._vs, eng.mesh
    out["gather_ms"] = (
        cuda_ms(torch, lambda: all_gather_last(x, vs.widths, mesh)),
        device_ms(torch, lambda: all_gather_last(x, vs.widths, mesh)))
    out["reduce_ms"] = (cuda_ms(torch, lambda: vocab_all_reduce(h, mesh)),
                        device_ms(torch, lambda: vocab_all_reduce(h, mesh)))
    log(f"phase 12 world 1 collectives (NCCL, 1 rank): all_gather_last "
        f"[8, {V}] bf16 {out['gather_ms'][0]:.4f} ms, device "
        f"{out['gather_ms'][1]:.4f} ms (a dense step calls it once); "
        f"vocab_all_reduce [8, 1, {h.shape[-1]}] bf16 "
        f"{out['reduce_ms'][0]:.4f} ms, device {out['reduce_ms'][1]:.4f} "
        f"ms")


def shard_mask_rows(torch, np, launches):
    """The shard-local masked_logits forms at V 50280 split over two ranks
    (words 0-785 and 786-1571: 25152 + 25128 ids), real json rows at the
    engine's accept bucket: each rank's block, concatenated, bitwise
    equal to the unsharded kernel's row, with EOS in each shard in turn;
    rank 0's block timed beside its plain version and bound. -> rows for
    the kernels line."""
    from types import SimpleNamespace

    from repro_torch.core.constrain import MAX_ACCEPT
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.mask_store import build_mask_store
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.distributed.sharding import vocab_shard
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_shard,
        apply_grammar_mask_span, apply_grammar_mask_span_shard)
    from repro_torch.kernels.masked_logits.ref import (
        masked_logits_ref, masked_logits_span_ref)
    dev = torch.device("cuda")
    tok = ByteTokenizer(SHARD_V)
    g, tab = load_grammar("json")
    fake = SimpleNamespace(bundles={"json": (g, tab, build_mask_store(
        g, tok))}, tok=tok)
    store, rows, eos, cd, cons_on = json_rows(torch, np, fake)
    shards = [vocab_shard(SHARD_V, 2, r) for r in range(2)]
    if tuple(s.width for s in shards) != (25152, 25128):
        raise AssertionError(f"V {SHARD_V} split {shards}")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(12)
    K = 8
    forms = {
        "row": (apply_grammar_mask, apply_grammar_mask_shard,
                masked_logits_ref, (8, SHARD_V), rows, cons_on, eos, cd),
        "span": (apply_grammar_mask_span, apply_grammar_mask_span_shard,
                 masked_logits_span_ref, (8, K, SHARD_V),
                 np.repeat(rows[:, None], K, axis=1),
                 np.repeat(cons_on[:, None], K, axis=1),
                 np.repeat(eos[:, None], K, axis=1),
                 np.repeat(cd[:, None], K, axis=1))}
    out = []
    for form, (whole, part, ref, shape, rset, cset, eset, cdw) in \
            forms.items():
        logits = t(rng.normal(scale=3.0, size=shape).astype(
            np.float32)).bfloat16()
        err = 0.0
        for eos_id in (1, shards[1].v0 + 77):       # in shard 0, then 1
            e = t(np.ones_like(eset))               # EOS open on every row
            want = whole(logits, store, t(rset), e, eos_id=eos_id,
                         constrained=t(cset), cd=t(cdw.view(np.int32)))
            blocks = []
            for s in shards:
                args = (logits[..., s.v0:s.v1].contiguous(),
                        store[:, s.w0:s.w1].contiguous(), t(rset), e, s)
                kw = {"eos_id": eos_id, "constrained": t(cset),
                      "cd": t(cdw[..., s.w0:s.w1].view(np.int32))}
                blocks.append(part(*args, **kw))
            got = torch.cat(blocks, dim=-1)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"masked_logits {form} shards at V "
                                     f"{SHARD_V}, eos {eos_id}: differ "
                                     f"from the unsharded kernel")
            err = max(err, float((got.float() - want.float()).abs().max()))
        s = shards[0]
        args = (logits[..., s.v0:s.v1].contiguous(),
                store[:, s.w0:s.w1].contiguous(), t(rset), t(eset), s)
        kw = {"constrained": t(cset),
              "cd": t(cdw[..., s.w0:s.w1].view(np.int32))}
        plain_args = args[:4]
        plain_kw = dict(kw, eos_id=s.local_id(1))
        mk, mr = part(*args, **kw), ref(*plain_args, **plain_kw)
        torch.cuda.synchronize()
        if not torch.equal(mk.view(torch.int16), mr.view(torch.int16)):
            raise AssertionError(f"masked_logits {form} shard: differs from "
                                 f"the plain version")
        ms = cuda_ms(torch, lambda: part(*args, **kw))
        dev_ms = device_ms(torch, lambda: part(*args, **kw))
        plain = cuda_ms(torch, lambda: ref(*plain_args, **plain_kw))
        n_rows = rset.reshape(-1, rset.shape[-1]).shape[0]
        nbytes = _mask_bytes(np, args[0].numel() * 2,
                             rset.reshape(n_rows, -1), cset.reshape(-1),
                             s.w1 - s.w0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        name = "masked_logits" if form == "row" else "masked_logits_span"
        shp = (f"B=8{' K=8' if form == 'span' else ''} V={SHARD_V} rank 0 "
               f"of 2 ({s.width} ids, {s.w1 - s.w0} words) bf16 "
               f"A={MAX_ACCEPT}")
        log(f"{name} shard {shp}: both shards joined bitwise equal to the "
            f"unsharded kernel (EOS in shard 0, then 1); {ms:.4f} ms, "
            f"device {dev_ms:.4f} ms; plain {plain:.4f} ms; bound "
            f"{bound:.6f} ms ({nbytes} bytes)")
        out.append({"name": f"{name} (vocab shard)", "route": "cuda",
                    "source": "src/repro_torch/csrc/masked_logits.cu",
                    "replaces": "src/repro/kernels/masked_logits/kernel.py:"
                                + ("164" if form == "row" else "112"),
                    "model": "smollm-360m sharded (phase 12)",
                    "shape": shp, "launches": launches[form],
                    "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain, "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": None,
                    "library_device_ms": None})
    return out


def phase_sharded(torch, np, counters, unsharded):
    """Phase 12: tensor-parallel serving (vocab parallelism). World 1
    over NCCL in this process: dense, speculative and paged runs, tokens
    identical to the unsharded engine's and phase 5's; world 2 on the one
    card over gloo (NCCL refuses two ranks on one device); then the
    shard-local masked_logits at V 50280. -> kernel rows."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    w1 = {}
    spawn(1, sharded_world1, torch, counters, unsharded, w1, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn(2, sharded_world2_rank, 2, backend="gloo", device="cuda")
    for r, res in enumerate(ranks):
        if res["tokens"] != w1["u_tokens"]:
            raise AssertionError(f"world 2 rank {r}: tokens differ from the "
                                 f"unsharded engine's")
        if res["launches"]["apply_grammar_mask"] != res["steps"] or \
                res["steps"] == 0:
            raise AssertionError(f"world 2 rank {r}: masked_logits launched "
                                 f"{res['launches']} in {res['steps']} "
                                 f"constrained steps")
        if res["store"][1] != 768 or res["mesh_devices"] != 2:
            raise AssertionError(f"world 2 rank {r}: store {res['store']}")
        log(f"phase 12 world 2 rank {r} ({res['backend']}, {res['device']}"
            f"): tokens identical to the unsharded engine's; "
            f"{res['steps']} steps, {1e3 * res['wall'] / res['steps']:.2f} "
            f"ms a step (host-relayed gloo, not representative); store "
            f"{res['store']}; launches {res['launches']}; complete "
            f"{res['complete']}, valid among complete "
            f"{res['valid']}/{res['complete']}")
    launches = {"row": w1["dense"][1]["apply_grammar_mask"]
                + w1["paged"]["apply_grammar_mask"]
                + ranks[0]["launches"]["apply_grammar_mask"],
                "span": w1["spec"]["apply_grammar_mask_span"]}
    rows = shard_mask_rows(torch, np, launches)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return rows



# ------------------------------------------- phase 13: the static cost

COST_B, COST_L = 8, 512     # the decode step held to FlopCounterMode


def cost_devtime_run(torch, counters, engine, bundles, label, needed):
    """Phase 12's 8 requests (32 new tokens) through a step loop with
    device timing on (the engine's devtime), the counters zeroed just
    before and read just after; every kernel in `needed` must have
    launched. -> the loop's devtime summary."""
    from repro_torch.serving.loop import ListSource, StepLoop, make_mode
    loop = StepLoop(engine, make_mode(engine),
                    ListSource(sharded_requests()))
    states, stats, launches = run_counted(torch, counters, loop.run)
    report(label, states, stats, bundles, launches)
    missing = [k for k in needed if not launches[k]]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: "
                             f"{launches}")
    return loop.tele.devtime.summary()


def cost_lines(label, summary):
    """Log forward's and mask_sample's device accounting and their
    achieved rates against the card's roofs."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    for fn in ("forward", "mask_sample"):
        d = summary.get(fn, {})
        if "hbm_bytes_per_call" not in d:
            raise AssertionError(f"{label}: no cost attached to {fn}: {d}")
        fl, by = d["achieved_flops_per_s"], d["achieved_bytes_per_s"]
        log(f"phase 13, {label} {fn}: {d['calls']} calls, "
            f"{d['seconds']:.6f} s ({d['seconds'] / d['calls'] * 1e3:.4f} "
            f"ms a call); {d['flops_per_call']:.0f} FLOP and "
            f"{d['hbm_bytes_per_call']:.0f} B a call; achieved "
            f"{fl / 1e12:.6f} TFLOP/s ({fl / PEAK_FLOPS_BF16:.6f} of the "
            f"bf16 peak) and {by / 1e12:.6f} TB/s ({by / HBM_BW:.6f} of "
            f"HBM)")


def cost_flop_check(torch, engine):
    """`cost.decode_step`'s FLOPs against torch's FlopCounterMode over
    the model's decode step on the card (B 8, 512 cache positions; the
    dense decode's attention is plain torch ops, so the counter sees
    every contraction)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import cost
    model = engine.model
    caches = model.init_decode_caches(COST_B, COST_L)
    dev = torch.device("cuda")
    tok = torch.zeros(COST_B, dtype=torch.int32, device=dev)
    pos = torch.full((COST_B,), COST_L // 2, dtype=torch.int32, device=dev)
    fc = FlopCounterMode(display=False)
    with torch.no_grad(), fc:
        model.decode_step(engine.params, caches, tok, pos)
    torch.cuda.synchronize()
    got = fc.get_total_flops()
    c = cost.decode_step(model.cfg, COST_B, COST_L)
    log(f"phase 13, smollm-360m decode step (B {COST_B}, {COST_L} cache "
        f"positions): cost.py {c['flops']:.0f} FLOP, {c['hbm_bytes']:.0f} "
        f"B; FlopCounterMode on the card {got} FLOP")
    if got != c["flops"]:
        raise AssertionError(f"decode-step FLOPs: cost.py {c['flops']}, "
                             f"FlopCounterMode {got}")
    del caches


def cost_dry_run(torch, smollm_peak):
    """Every config x shape on both production meshes, on the meta
    device; then the estimate at phase 9's smollm shape on one card
    beside phase 9's measured peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    recs = []
    for multi_pod in (False, True):
        got, failures = dryrun.run_all(multi_pod, save=False, quiet=True)
        if failures:
            raise AssertionError(f"dry run failures: {failures}")
        recs += got
    done = [r for r in recs if "skipped" not in r]
    fits = sum(r["fits_hbm"] for r in done)
    log(f"phase 13, dry run (meta device, no card): {len(recs)} records "
        f"({len(recs) - len(done)} skipped) in "
        f"{time.perf_counter() - t0:.1f} s; fits_hbm {fits} of "
        f"{len(done)}")
    if len(recs) != 88 or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"dry run: {len(recs)} records, card memory "
                             f"{before} -> {torch.cuda.memory_allocated()}")
    one = MeshShape({"data": 1, "model": 1}, ("data", "model"))
    est = dryrun.train_estimate(get_config("smollm-360m"), 8, 1024, one)
    log(f"phase 13, smollm-360m train step B 8 x S 1024 on one card: dry "
        f"run argument bytes {est['argument_bytes']} (params, moments, "
        f"batch: {est['arguments']}), temp estimate "
        f"{est['temp_bytes']:.0f}, peak estimate {est['peak_bytes']:.0f}; "
        f"phase 9 measured peak {smollm_peak} "
        f"({smollm_peak / est['peak_bytes']:.4f} of the estimate)")
    if smollm_peak < est["argument_bytes"]:
        raise AssertionError(f"phase 9's peak {smollm_peak} is below the "
                             f"resident arguments {est['argument_bytes']}")


def phase_cost(torch, counters, smollm_peak):
    """smollm-360m served dense and paged with devtime on: the engine's
    per-call costs (`distributed/cost.py`) and their achieved rates; the
    decode step's count against FlopCounterMode; the dry run."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Engine
    engine, bundles, _ = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda", devtime=True)
    paged = Engine(engine.model, engine.params, engine.tok, bundles,
                   max_len=512, slots=8, paged=True, devtime=True,
                   device="cuda")
    engine.generate(sharded_requests()[:1])         # warm-up
    cost_lines("dense", cost_devtime_run(
        torch, counters, engine, bundles, "phase 13 dense generate, "
        "devtime (8 x 32)", ("fused_mask_select", "attention")))
    cost_lines("paged", cost_devtime_run(
        torch, counters, paged, bundles, "phase 13 paged generate, "
        "devtime (8 x 32)", ("fused_mask_select", "paged_attention")))
    cost_flop_check(torch, engine)
    del engine, paged, bundles
    gc.collect()
    torch.cuda.empty_cache()
    cost_dry_run(torch, smollm_peak)


# (grammar name, vocabulary size) -> the mask store `launch.serve.
# build_engine` built for it in this process, or a rank's parent handed in
_STORES: dict = {}


def share_mask_stores(stores=None):
    """Make `launch.serve.build_engine` build each (grammar, vocabulary)
    mask store once in this process and reuse it for every later engine
    (a store is a pure function of the grammar and the tokenizer, and
    engines only read it); `stores` adds ones built elsewhere (a spawned
    rank gets its parent's). For the script's time: phase 14 builds the
    engines of phases 5 and 8 again, once per rank, and the stores at V
    151936-256000 took most of its time."""
    from repro_torch.launch import serve
    _STORES.update(stores or {})
    build = getattr(serve.build_mask_store, "__wrapped__",
                    serve.build_mask_store)

    def shared(g, tok, *a, **kw):
        key = (g.name, tok.vocab_size)
        if key not in _STORES:
            _STORES[key] = build(g, tok, *a, **kw)
        return _STORES[key]
    shared.__wrapped__ = build
    serve.build_mask_store = shared


# ------------------------------------------ phase 14: trunk-sharded serving

# (arch, depth or None for all layers, max_len, the first-step check's
# prompt length) served by a 2-rank gloo world on the one card under
# trunk_shard (NCCL refuses two ranks on one device). smollm-360m's 5 kv
# heads do not split 2 ways: the sequence split, rank r holding positions
# [32r, 32r + 32) of its 64 and offsets [8r, 8r + 8) of each 16-position
# page; the requests' prompts (TRUNK_REACH) cross position 32, and the
# first step's 32 prompt tokens put its own position 32 on rank 1
TRUNK_ARCHS = (("qwen1.5-0.5b", None, 512, 16),
               ("qwen3-moe-30b-a3b", MOE_DEPTH, 512, 16),
               ("smollm-360m", None, 64, 32),
               ("mamba2-370m", None, 512, 16),
               ("recurrentgemma-9b", 9, 48, 32))
# (requests, new tokens) of each model's runs, for the script's time: a
# dense, paged or speculative run takes about as many steps as it has new
# tokens, each step the host oracle's (V 151936, 256000) and 31-146
# gloo collectives; qwen1.5, qwen3-moe 4 x 4 (4 x 16 until PR 28, 8 x 32
# until PR 27), smollm 8 x 4 (8 x 32 until PR 28: its prompts now reach
# the last rank's share themselves, TRUNK_REACH), mamba2 and
# recurrentgemma 4 x 4; each warm-up is one request at TRUNK_WARM new
# tokens (4 until PR 28). (qwen1.5's depth stays whole: at 4 layers its vocabulary tables
# outweigh the layers, and the peak of drawing them passes the whole
# tree's bytes, which the memory check forbids)
TRUNK_CUT = {"qwen1.5-0.5b": (4, 4), "qwen3-moe-30b-a3b": (4, 4),
             "smollm-360m": (8, 4), "mamba2-370m": (4, 4),
             "recurrentgemma-9b": (4, 4), "smollm-360m/dh": (4, 4),
             "smollm-360m/whole": (4, 4)}
TRUNK_WARM = 2
# the recurrent families (mamba2-370m, recurrentgemma-9b) serve dense and
# sequential, as on one device; their sequential run serves this many
# requests x new tokens (one request a step: a step of the 2-rank world
# waits on 31-146 gloo collectives)
TRUNK_SEQ = (2, 2)
# under the sequence split (smollm-360m: a ring of 64 positions, rank r
# holding [32r, 32r + 32); recurrentgemma-9b's local attention, its one
# kv head: a ring of 48, [24r, 24r + 24)) each prompt is padded to this
# many ids, so that every request's prefill writes into the last rank's
# share whatever its output's length (the tokenizers at V 49152 and
# 256000 merge phase 12's 22-byte prompts into fewer ids); the first
# step's 32 prompt tokens reach it too
TRUNK_REACH = {"smollm-360m": 34, "recurrentgemma-9b": 26}
# recurrentgemma-9b runs 9 of its 38 layers, three (rec, rec, attn)
# periods: the fewest whole periods at which a rank's build peak (the
# fp32 draw of the 256000 x 4096 tied embedding, 4.19 GB, beside its
# 1.05 GB block) stays below the whole tree's bytes (6.04 GB at 9
# layers, 4.73 at 6), for the script's time, and the depth at which
# scripts/trunk_tolerance.py reads its bound on the CPU


# the head_dim and replicated cache branches (PR 29): smollm-360m at full
# width and TRUNK_SPLIT_DEPTH of its 32 layers (for the script's time)
# over worlds of M gloo ranks on the one card, M dividing neither its 5 kv
# heads nor the cache lengths: (key, M, max_len, page_size, the branch both
# kinds of cache take). At M = 2, 63 and 9 are odd and head_dim 64 splits
# (32 channels a rank); at M = 3 neither 64, 16 nor head_dim 64 splits, so
# every rank holds the whole cache and pool. Prompts of TRUNK_SPLIT_P for
# the first-step check; 4 requests x 4 new tokens a run (TRUNK_CUT)
TRUNK_SPLITS = (("smollm-360m/dh", 2, 63, 9, "dh"),
                ("smollm-360m/whole", 3, 64, 16, "whole"))
TRUNK_SPLIT_DEPTH, TRUNK_SPLIT_P = 8, 32
# the runs of the M = 3 world: dense and paged (the script's time)
TRUNK_SPLIT_PATHS = {"smollm-360m/whole": ("dense", "paged")}
# the fp32 copy's max_len under the head_dim split: odd, so that M = 2
# divides neither it nor the kv heads (TRUNK_FP32_LEN is even)
TRUNK_FP32_SPLIT_LEN = {"smollm-360m/dh": 33}


def trunk_requests(key, engine, warm=False, sequential=False):
    """The requests phase 14 serves run `key` (an arch, or a key of
    TRUNK_SPLITS) with on `engine` (its warm-up's, its sequential
    run's), prompts padded to TRUNK_REACH's ids."""
    n, new = (1, TRUNK_WARM) if warm else TRUNK_SEQ if sequential else \
        TRUNK_CUT.get(key, (8, SHARD_NEW))
    reqs = sharded_requests()[:n]
    for r in reqs:
        r.max_new_tokens = new
        while len(engine._request_ids(r)) < TRUNK_REACH.get(key, 0):
            r.prompt += b" ."
    return reqs


def trunk_paths(cfg, key=None):
    """The serving paths phase 14 runs `cfg` (run `key`) on through both
    engines: dense, paged and speculative where every layer kind is
    position-addressed (TRUNK_SPLIT_PATHS' where it names `key`), else
    (the recurrent families) dense and sequential."""
    from repro_torch.models.model import Model
    if key in TRUNK_SPLIT_PATHS:
        return TRUNK_SPLIT_PATHS[key]
    if Model(cfg, device="meta").supports_span_decode:
        return ("dense", "paged", "speculative")
    return ("dense", "sequential")


def n_attention(cfg):
    """Layers of `cfg` with self-attention (attn, moe)."""
    from repro_torch.models.model import layer_groups
    return sum(count for pat, count in layer_groups(cfg) for kind in pat
               if kind in ("attn", "moe"))
TRUNK_M = 2
TRUNK_B, TRUNK_P = 8, 16        # the checks' 8 prompts of 16 (fp32: 16)
# the first decode step's logits against the one-device engine's: 16 bf16
# ulps at the largest |logit|, between what scripts/trunk_tolerance.py
# reads for a sound split (CPU, 2-rank gloo, bf16, random QKV biases: at
# most 5.5, qwen3-moe at 8 layers; qwen1.5 at 24 layers 4.25) and for one
# with a planted fault (at least 63: no FFN all-reduce, qwen1.5 at full
# width and 2 layers; a wrong expert offset routes fewer than half the
# rows alike, which fails the check too); under the sequence split
# (smollm-360m at full width, 32 prompt tokens) sound at most 4.0 at 32
# layers, faults at least 22.95 (the partials joined with equal weights
# instead of their log-sum-exp's, 2 layers) and 59.0 (a rank's prefill
# writing the other rank's positions)
TRUNK_ULPS = 16
# the recurrent families' own bounds, where 16 does not separate the sets
# (scripts/trunk_tolerance.py, CPU, 2 gloo ranks, bf16, full width):
# mamba2-370m at its 48 layers reads 28.8 sound (0.28 at 2 layers, 11.4
# at 24; the one-device bf16 model itself is 34.9 from its fp32 twin at
# 48) and 157.5 with the gated norm's statistic over a rank's own
# channels (143.75 at 24); recurrentgemma-9b, whose tied-embedding
# logits reach ~2000 (an ulp of 8-16), at its 9 layers 0.69 sound (at
# most 1.0 at 3-9) and 11.03 with the gates contracted over a rank's
# own conv channels (3.31 at 3 layers, 4.58 at 6)
TRUNK_FAMILY_ULPS = {"mamba2-370m": 64, "recurrentgemma-9b": 3,
                     "smollm-360m/dh": 16, "smollm-360m/whole": 16}
TRUNK_FP32_LAYERS, TRUNK_FP32_STEPS = 2, 16
# recurrentgemma's fp32 copy takes its first (rec, rec, attn) period
TRUNK_FP32_DEPTH = {"recurrentgemma-9b": 3}
TRUNK_FP32_LEN = TRUNK_P + TRUNK_FP32_STEPS    # its max_len: smollm's
#                                                rank 1 holds 16-31
# an fp32 near-tie: a top-2 logit gap, or a gap between the k-th and
# (k+1)-th router probability, below which the split's fp32 sum order
# (about 1e-6 relative on the card) could flip the pick
TRUNK_GAP, TRUNK_MARGIN = 1e-3, 1e-6


def _trunk_counters():
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_span)
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_partial, paged_attention_scores,
        paged_attention_values)
    return (fused_mask_select, attention, apply_grammar_mask,
            apply_grammar_mask_span, paged_attention, paged_attention_partial,
            paged_attention_scores, paged_attention_values)


# the paged kernels, by the pool split that launches each
PAGED_KINDS = {"seq": ("paged_attention_partial",),
               "dh": ("paged_attention_scores", "paged_attention_values")}
PAGED_ALL = ("paged_attention", "paged_attention_partial",
             "paged_attention_scores", "paged_attention_values")


class _Heads:
    """While active, records the (q heads, kv heads) of every flash and
    paged attention call (whole, partial or the head_dim form) the
    model's layers make."""

    NAMES = ("attention",) + PAGED_ALL

    def __enter__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.orig = {n: getattr(layers, n) for n in self.NAMES}
        self.flash, self.paged = set(), set()

        def spy(name):
            fn = self.orig[name]
            seen = self.flash if name == "attention" else self.paged

            def call(q, kp, *a, **kw):
                seen.add((q.shape[2], kp.shape[2]))
                return fn(q, kp, *a, **kw)
            return call
        for n in self.NAMES:
            setattr(self.layers, n, spy(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.layers, n, fn)


class _PartialSpy:
    """While active, keeps what the partial paged kernel took and gave on
    the main path (`layers.paged_attention_partial`, one call a layer a
    feed): every layer's call of the last feed of each feed width S,
    copied as the call made it (the last, not the first: a run's first
    feeds sit at position 0, where rank 1 holds no key). `check()`,
    after the run, holds each kept output against the plain partial on
    the same inputs (bf16, the run's own launch), then the kernel against
    the plain partial on those inputs in fp32 -> {S: [calls, o err bf16,
    lse err bf16, o err fp32, lse err fp32, share of rows with a live
    key]}; raises beyond the paged tolerances, or where no row of a
    width had a live key on this rank."""

    def __init__(self, num_layers):
        self.L, self.n, self.feeds, self.cur = num_layers, 0, {}, None

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, orig = layers, layers.paged_attention_partial
        self.orig = orig

        def spy(q, kp, vp, pt, pos, ps, base):
            if self.n % self.L == 0:            # a feed's first layer
                self.cur = self.feeds[q.shape[1]] = []
            self.n += 1
            o, lse = orig(q, kp, vp, pt, pos, ps, base)
            self.cur.append(((q.clone(), kp.clone(), vp.clone(), pt.clone(),
                              pos.clone(), ps, base), o.clone(),
                             lse.clone()))
            return o, lse
        layers.paged_attention_partial = spy
        return self

    def __exit__(self, *exc):
        self.layers.paged_attention_partial = self.orig

    def check(self, who):
        from repro_torch.kernels.paged_attention.ops import (
            paged_attention_partial)
        from repro_torch.kernels.paged_attention.ref import (
            paged_attention_partial_ref)
        out = {}
        for S, calls in self.feeds.items():
            row = out[S] = [len(calls), 0.0, 0.0, 0.0, 0.0, 0.0]
            for args, o, lse in calls:
                wo, wl = paged_attention_partial_ref(*args)
                a32 = (args[0].float(), args[1].float(), args[2].float(),
                       *args[3:])
                o32, l32 = paged_attention_partial(*a32)
                w32, wl32 = paged_attention_partial_ref(*a32)
                errs = [(o.float() - wo.float()).abs().max().item(),
                        (lse - wl).abs().max().item(),
                        (o32 - w32).abs().max().item(),
                        (l32 - wl32).abs().max().item()]
                row[1:5] = [max(a, b) for a, b in zip(row[1:5], errs)]
                row[5] += (wl > -1e29).float().mean().item() / len(calls)
        for S, (n, eo, el, eo32, el32, live) in out.items():
            if not (eo <= 2.0 ** -5 and el <= 1e-4 and eo32 <= 1e-5
                    and el32 <= 1e-5 and live > 0):
                raise AssertionError(
                    f"{who}: paged_attention_partial on the main path, S={S} "
                    f"({n} calls, rows with a live key {live:.3f}): max abs "
                    f"err o {eo}, lse {el} (bf16; tol {2.0 ** -5}, 1e-4), o "
                    f"{eo32}, lse {el32} (fp32; tol 1e-5, 1e-5)")
        self.feeds.clear()
        return out


# the head_dim form against its plain version: max abs error within
# DH_TOL of max(1, the plain output's largest magnitude). Both sum fp32
# products (exact for bf16 operands) in another order over dw channels
# (scores) or nP * ps positions (values): a few fp32 ulps of the sum
DH_TOL = 1e-5


class _DhSpy:
    """While active, keeps what the head_dim form's two kernels took and
    gave on the main path (`layers.paged_attention_scores`,
    `layers.paged_attention_values`, one call each a layer a feed): every
    layer's calls of the last feed of each feed width S, copied as the
    calls made them. `check()`, after the run, holds each kept output
    against the plain version on the same inputs (bf16, the run's own
    launch), then the kernel against the plain version on those inputs
    in fp32 -> {S: [calls, scores err bf16, values err bf16, scores err
    fp32, values err fp32]} (each relative to max(1, the plain output's
    largest magnitude)); raises beyond DH_TOL."""

    def __init__(self, num_layers):
        self.L, self.n, self.feeds, self.cur = num_layers, 0, {}, None

    def __enter__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.orig = (layers.paged_attention_scores,
                     layers.paged_attention_values)
        scores, values = self.orig

        def scores_spy(q, kp, pt, d0):
            if self.n % self.L == 0:            # a feed's first layer
                self.cur = self.feeds[q.shape[1]] = []
            self.n += 1
            s = scores(q, kp, pt, d0)
            self.cur.append([(q.clone(), kp.clone(), pt.clone(), d0),
                             s.clone()])
            return s

        def values_spy(pr, vp, pt):
            o = values(pr, vp, pt)
            self.cur[-1] += [(pr.clone(), vp.clone(), pt.clone()), o.clone()]
            return o
        layers.paged_attention_scores = scores_spy
        layers.paged_attention_values = values_spy
        return self

    def __exit__(self, *exc):
        (self.layers.paged_attention_scores,
         self.layers.paged_attention_values) = self.orig

    def check(self, who):
        from repro_torch.kernels.paged_attention.ops import (
            paged_attention_scores, paged_attention_values)
        from repro_torch.kernels.paged_attention.ref import (
            paged_scores_ref, paged_values_ref)

        def err(got, want):
            return ((got.float() - want.float()).abs().max().item() /
                    max(1.0, want.float().abs().max().item()))
        out = {}
        for S, calls in self.feeds.items():
            row = out[S] = [len(calls), 0.0, 0.0, 0.0, 0.0]
            for sa, s, va, o in calls:
                q, kp, pt, d0 = sa
                pr, vp, _ = va
                q32, k32, p32, v32 = (t.float() for t in (q, kp, pr, vp))
                errs = [err(s, paged_scores_ref(*sa)),
                        err(o, paged_values_ref(*va)),
                        err(paged_attention_scores(q32, k32, pt, d0),
                            paged_scores_ref(q32, k32, pt, d0)),
                        err(paged_attention_values(p32, v32, pt),
                            paged_values_ref(p32, v32, pt))]
                row[1:] = [max(a, b) for a, b in zip(row[1:], errs)]
            if not max(row[1:]) <= DH_TOL:
                raise AssertionError(
                    f"{who}: the head_dim form on the main path, S={S} "
                    f"({len(calls)} calls): relative max abs err scores "
                    f"{row[1]}, values {row[2]} (bf16), {row[3]}, {row[4]} "
                    f"(fp32); tol {DH_TOL}")
        self.feeds.clear()
        return out


class _FlashSpy:
    """While active, keeps the flash_attention calls the model's layers
    make (`layers.attention`: the prefill of every admission; under the
    sequence split on q/k/v gathered into whole heads), the last
    `keep` of them with their outputs. `check()` holds each kept output
    against the plain version on the same inputs (bf16, the run's own
    launch) and the kernel against the plain version on those inputs in
    fp32 -> [calls, q shapes, max abs err bf16, fp32]; raises beyond
    ATTN_TOL."""

    def __init__(self, keep=16):
        self.keep, self.n, self.calls = keep, 0, []

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, orig = layers, layers.attention
        self.orig = orig

        def spy(q, k, v, **kw):
            o = orig(q, k, v, **kw)
            self.n += 1
            self.calls = (self.calls + [((q.clone(), k.clone(), v.clone()),
                                         kw, o.clone())])[-self.keep:]
            return o
        layers.attention = spy
        return self

    def __exit__(self, *exc):
        self.layers.attention = self.orig

    def check(self, who):
        from repro_torch.kernels.flash_attention.ops import attention
        from repro_torch.kernels.flash_attention.ref import chunked_attention
        err = err32 = 0.0
        for (q, k, v), kw, o in self.calls:
            plain = lambda *a: chunked_attention(
                *a, causal=kw.get("causal", True), q_offset=0,
                window=kw.get("window", 0), chunk=kw.get("chunk", 1024))
            err = max(err, (o.float() - plain(q, k, v).float()).abs()
                      .max().item())
            a32 = (q.float(), k.float(), v.float())
            err32 = max(err32, (attention(*a32, **kw) - plain(*a32)).abs()
                        .max().item())
        shapes = sorted({(tuple(q.shape), tuple(k.shape))
                         for (q, k, _), _, _ in self.calls})
        if not (err <= ATTN_TOL["bfloat16"] and
                err32 <= ATTN_TOL["float32"]):
            raise AssertionError(
                f"{who}: flash_attention on the main path ({self.n} calls, "
                f"kept {len(self.calls)} at {shapes}): max abs err {err} "
                f"(bf16; tol {ATTN_TOL['bfloat16']}), {err32} (fp32; tol "
                f"{ATTN_TOL['float32']})")
        return [self.n, shapes, err, err32]


def _tree_bytes(tree) -> int:
    from repro_torch.training.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def valid_prefixes(engine, states):
    """Every output walked token by token with the copied oracle
    (`GrammarConstraint.is_valid_extension`): each generated token must
    keep the output in the grammar's prefix language, eos only where the
    output is complete. -> outputs cut short of eos."""
    from repro_torch.core.tokenizer import EOS_ID
    cut = 0
    for st in states:
        gc = engine._make_constraint(st.req)
        ids = st.token_ids[len(engine._request_ids(st.req)):]
        out = b""
        for t in ids:
            if not gc.is_valid_extension(out, t):
                raise AssertionError(f"request {st.req.rid}: token {t} "
                                     f"leaves the grammar after {out!r}")
            if t == EOS_ID:
                break
            out += engine.tok.id_to_bytes[t]
        if out != st.generated:
            raise AssertionError(f"request {st.req.rid}: walked {out!r}, "
                                 f"generated {st.generated!r}")
        cut += st.finish_reason != "eos"
    return cut


def trunk_first_step(torch, engine, routes, P):
    """TRUNK_B seeded prompts of P tokens prefilled and one decode step,
    through the engine's own calls -> (the decode logits gathered, fp32
    on the host; each MoE layer's routes of the step, or None; the step's
    caches and inputs, for a rerun)."""
    V = engine._cfg.vocab_size
    g = torch.Generator(device="cpu").manual_seed(14)
    toks = torch.randint(3, V, (TRUNK_B, P + 1), generator=g,
                         dtype=torch.int32).to(engine.device)
    _, caches = engine._prefill(toks[:, :P], P)
    pos = torch.full((TRUNK_B,), P, dtype=torch.int32,
                     device=engine.device)
    if routes is not None:
        routes.take()
    logits = engine._gather(engine._decode(caches, toks[:, P], pos))
    got = logits.float().cpu()
    return got, None if routes is None else [
        r.cpu() for r in routes.take()], (caches, toks[:, P], pos)


def _leaf_bytes(tree, specs=None, mesh=None) -> dict:
    """Bytes of a cache tree by leaf name (k, v, kv_pos, h, conv), held
    or, given the specs and the mesh, a rank's block under them."""
    from repro_torch.distributed import cost
    from repro_torch.distributed.sharding import _leaf_name
    out = {}
    for path, n in cost._leaf_bytes(tree, specs, mesh):
        out[_leaf_name(path)] = out.get(_leaf_name(path), 0) + n
    return out


def trunk_runs(torch, counters, engine, bundles, tok, P, key, names=None,
               page=16):
    """The first-step check, then the runs of `names` (default
    `trunk_paths`): dense, paged (a twin on the engine's params, pages of
    `page` positions) and speculative runs of `trunk_requests(key)`
    (phase 12's 8 requests x 32 new tokens, cut to TRUNK_CUT's), or for
    the recurrent families dense and sequential (TRUNK_SEQ), each with
    the launch counters zeroed just before and read just after, every
    eos output parsed and every output walked by the oracle, the partial
    paged kernel's calls held by `_PartialSpy`, the head_dim form's by
    `_DhSpy` and the flash calls by `_FlashSpy` -> {"first", "routes",
    "runs": {run: tokens, steps, ms a step, launches, attention heads,
    ...}, "bytes": the dense caches' bytes by leaf name and the page
    pools' bytes, as the runs build them}."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    names = names or trunk_paths(engine._cfg, key)
    moe = engine._cfg.arch_type == "moe"
    with _Routes() as routes:
        first, first_routes, _ = trunk_first_step(
            torch, engine, routes if moe else None, P)
    engine.generate(trunk_requests(key, engine, warm=True))
    # the bytes a rank's dense caches and page pools hold, as the runs
    # build them
    held = {"caches": _leaf_bytes(engine._decode_caches(8))}
    paged = None
    if "paged" in names:
        paged = Engine(build_model(engine._cfg, device=engine.device),
                       engine.params, tok, bundles, max_len=engine.max_len,
                       slots=8, paged=True, page_size=page, device="cuda",
                       mesh=engine.mesh, trunk_shard=engine.mesh is not None)
        held.update(pools=_tree_bytes(paged._paged_setup(8)[1]),
                    pages=(paged.num_pages, paged.page_size))
    runs = {}
    for name, eng, fn in (
            ("dense", engine, lambda: engine.generate(
                trunk_requests(key, engine))),
            ("paged", paged, lambda: paged.generate(
                trunk_requests(key, engine))),
            ("speculative", engine, lambda: engine.generate_speculative(
                trunk_requests(key, engine))),
            ("sequential", engine, lambda: engine.generate_sequential(
                trunk_requests(key, engine, sequential=True)))):
        if name not in names:
            continue
        layers = max(1, n_attention(engine._cfg))
        spy, dh = _PartialSpy(layers), _DhSpy(layers)
        with _Heads() as heads, spy, dh, _FlashSpy() as flash:
            states, stats, lc = run_counted(torch, counters, fn)
        who = f"phase 14 {key} {name}"
        checked = spy.check(who) if spy.feeds else None
        dh_checked = dh.check(who) if dh.feeds else None
        flash_checked = flash.check(who) if flash.calls else None
        check_outputs(states, bundles)
        cut = valid_prefixes(engine, states)
        runs[name] = {"tokens": tokens_of(states),
                      "steps": stats.decode_steps,
                      "admitted": len(states),
                      "masked": stats.mask_computations,
                      "ms": 1e3 * stats.wall / max(stats.decode_steps, 1),
                      "launches": lc, "flash": sorted(heads.flash),
                      "paged_heads": sorted(heads.paged), "cut": cut,
                      "plan": eng._trunk, "partial_checked": checked,
                      "dh_checked": dh_checked,
                      "flash_checked": flash_checked,
                      "eos": sum(s.finish_reason == "eos" for s in states)}
    del paged
    return {"first": first, "routes": first_routes, "runs": runs,
            "bytes": held}


def trunk_launch_check(who, cfg, res, M):
    """The kernels' launches against each run's steps, at the local
    heads: flash once per attention layer per admission at (H/M, K/M),
    paged once per layer per feed at (H/M, K/M), masked_logits once per
    constrained step (vocab split) or none, fused_select at least once a
    dense step; masked_logits_span once per speculative step;
    sequential: flash once per attention layer per request, masked_logits
    once per constrained step. Where M does not divide K flash runs at
    every head (H, K) and the paged feeds launch, by the pool's split,
    the partial kernel (sequence), the head_dim form's two kernels
    (head_dim) or the whole kernel (whole), at (H, K), and no other
    paged kernel."""
    L = n_attention(cfg)
    gathers = cfg.num_kv_heads % M != 0
    heads = (cfg.num_heads, cfg.num_kv_heads) if gathers else \
        (cfg.num_heads // M, cfg.num_kv_heads // M)
    flash = [heads] if L else []
    runs, bad = res["runs"], []
    d = runs["dense"]
    lc = d["launches"]
    if lc["attention"] != d["admitted"] * L or d["flash"] != flash:
        bad.append(f"dense flash {lc['attention']} at {d['flash']}")
    if lc["fused_mask_select"] < d["steps"]:
        bad.append(f"dense fused_select {lc['fused_mask_select']}")
    if lc["apply_grammar_mask"] != (d["steps"] if M > 1 else 0):
        bad.append(f"dense masked_logits {lc['apply_grammar_mask']}")
    p = runs.get("paged")
    if p:
        pool = p["plan"].pool if p["plan"] is not None else None
        kinds = PAGED_KINDS.get(pool, ("paged_attention",))
        got = {k: p["launches"][k] for k in PAGED_ALL}
        if any(got[k] != (p["steps"] * L if k in kinds else 0)
               for k in PAGED_ALL) or p["paged_heads"] != [heads]:
            bad.append(f"paged {got} (the pool's split {pool}) at "
                       f"{p['paged_heads']} in {p['steps']} steps")
    s = runs.get("speculative")
    if s and s["launches"]["apply_grammar_mask_span"] != s["steps"]:
        bad.append(f"speculative masked_logits_span "
                   f"{s['launches']['apply_grammar_mask_span']} in "
                   f"{s['steps']} steps")
    q = runs.get("sequential")
    if q and (q["launches"]["attention"] != q["admitted"] * L or
              q["flash"] != flash or q["masked"] == 0 or
              q["launches"]["apply_grammar_mask"] != q["masked"]):
        bad.append(f"sequential flash {q['launches']['attention']} at "
                   f"{q['flash']}, masked_logits "
                   f"{q['launches']['apply_grammar_mask']} in "
                   f"{q['masked']} constrained steps")
    if bad:
        raise AssertionError(f"phase 14 {who}: launches {bad} (dense "
                             f"steps {d['steps']})")


def _share_reach(runs, max_len):
    """Positions each run fed into this rank's share of the cache under
    the sequence split (summed over the requests: a request fed
    positions 0 .. len(ids) - 2): the dense runs' [lo, hi), the paged
    run's in-page offsets [o0, o1). -> {run: count}, or None where a
    run's cache is not split on its sequence."""
    out = {}
    for name, run in runs.items():
        plan = run["plan"]
        split = None if plan is None else \
            plan.pool if name == "paged" else plan.cache
        if split != "seq":
            return None
        fed = [range(len(ids) - 1) for ids, _ in run["tokens"].values()]
        if name == "paged":
            (o0, o1), ps = plan.offsets, \
                (plan.offsets[1] - plan.offsets[0]) * plan.size
            out[name] = sum(o0 <= p % ps < o1 for f in fed for p in f)
        else:
            lo, hi = plan.positions
            out[name] = sum(lo <= p % max_len < hi for f in fed for p in f)
    return out


def trunk_rank(rank, n, arch, depth, max_len, P, key=None, page=16):
    """One rank of an n-rank gloo world on the card: `arch` built under
    trunk_shard (each rank draws only its blocks), the first-step check,
    the runs of `key` (default `arch`; paged: pages of `page`), the
    decode step's collective tally against cost.py, the positions its
    share of the caches held (sequence split), and the bytes of its
    params, dense caches and page pools against the trunk specs'
    argument bytes."""
    import torch
    from repro_torch.distributed import cost
    from repro_torch.distributed.api import (collective_tally,
                                             reset_collective_tally)
    from repro_torch.distributed.sharding import (leaves_with_path,
                                                  serving_cache_specs,
                                                  serving_param_specs,
                                                  trunk_slice)
    from repro_torch.launch.dryrun import tree_shard_bytes
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves
    counters = _trunk_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, bundles, tok = build_engine(
        arch, grammars=("json", "jsonmsg"), max_len=max_len, slots=8,
        device="cuda", mesh=n, trunk_shard=True, num_layers=depth)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    res = trunk_runs(torch, counters, engine, bundles, tok, P, key or arch,
                     page=page)
    # one decode step again (it rewrites the same positions) with the
    # tally on and no route spy
    _, _, (caches, t, pos) = trunk_first_step(torch, engine, None, P)
    torch.cuda.synchronize()
    reset_collective_tally()
    engine._decode(caches, t, pos)
    torch.cuda.synchronize()
    res["tally"] = collective_tally()
    plan = engine._trunk
    if plan is not None and plan.cache == "seq":
        kv = next(c for g in caches for c in g if "kv_pos" in c)
        lo, hi = plan.positions
        res["first_live"] = int((kv["kv_pos"][0, :, lo:hi] >= 0).sum())
        res["positions"] = plan.positions
        if "paged" in res["runs"]:
            res["offsets"] = res["runs"]["paged"]["plan"].offsets
    res["splits"] = None if plan is None else (
        plan.cache, res["runs"]["paged"]["plan"].pool
        if "paged" in res["runs"] else None, plan.head_dims)
    res["reach"] = _share_reach(res["runs"], max_len)
    cfg, mesh = engine._cfg, engine.mesh
    res["cost"] = cost.decode_step(cfg, TRUNK_B, engine.max_len, mesh=mesh)
    meta = build_model(cfg, device="meta")
    params = meta.abstract_params()
    caches = meta.init_decode_caches(8, engine.max_len)
    # the params at the engine's word-aligned vocabulary split (embed and
    # lm_head; `trunk_slice`), which V % M = 0 does not imply (V 50280:
    # 12 rows more on rank 0 than the specs' V / M); the specs' bytes beside
    blocks = sum(math.prod(sl.stop - sl.start for sl in trunk_slice(
        p, t.shape, mesh, mesh.rank, engine._vs)) * t.element_size()
        for p, t in leaves_with_path(params))
    res["est"] = {
        "params": blocks,
        "caches": _leaf_bytes(caches, serving_cache_specs(
            caches, mesh, cfg, trunk_shard=True), mesh)}
    if "pages" in res["bytes"]:
        pools = meta.init_paged_caches(*res["bytes"].pop("pages"))
        res["est"]["pools"] = tree_shard_bytes(pools, serving_cache_specs(
            pools, mesh, cfg, trunk_shard=True), mesh)
    res["spec_params"] = tree_shard_bytes(params, serving_param_specs(
        params, mesh, cfg, trunk_shard=True), mesh)
    res["whole_params"] = sum(t.numel() * t.element_size()
                              for t in leaves(params))
    res["block_params"] = sum(t.numel() * t.element_size()
                              for t in leaves(engine.params))
    res.update(build_s=build_s, built_peak=built_peak, held=held,
               peak=torch.cuda.max_memory_allocated(),
               device=str(engine.device), backend=mesh.backend,
               local=(engine.model.cfg.num_heads,
                      engine.model.cfg.num_kv_heads, engine.model.cfg.d_ff))
    return res


def trunk_one_device(torch, arch, depth, max_len, P, key=None):
    """The one-device engine on the same seeded weights, in this process:
    the same first-step check and the dense run of `key` (default
    `arch`; the script's time leaves out its paged and speculative
    twins)."""
    from repro_torch.launch.serve import build_engine
    counters = _trunk_counters()
    torch.cuda.reset_peak_memory_stats()
    engine, bundles, tok = build_engine(
        arch, grammars=("json", "jsonmsg"), max_len=max_len, slots=8,
        device="cuda", num_layers=depth)
    res = trunk_runs(torch, counters, engine, bundles, tok, P, key or arch,
                     names=("dense",))
    res["peak"] = torch.cuda.max_memory_allocated()
    res["cfg"] = engine._cfg
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def trunk_fp32_greedy(rank, n, arch, max_len=TRUNK_FP32_LEN):
    """fp32 copy at TRUNK_FP32_LAYERS layers (TRUNK_FP32_DEPTH's where it
    names `arch`), caches of `max_len`: TRUNK_B seeded prompts
    prefilled, then TRUNK_FP32_STEPS unconstrained greedy steps through
    the engine's own calls (one device when n is None, else rank `rank`
    of n under trunk_shard) -> (tokens [B, steps]; at each step the
    one-device side's top-2 logit gap and smallest router margin, [B,
    steps], or None under the mesh)."""
    import torch
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.distributed.sharding import trunk_slice, vocab_shard
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = replace(get_config(arch),
                  num_layers=TRUNK_FP32_DEPTH.get(arch, TRUNK_FP32_LAYERS),
                  dtype="float32")
    mesh = None if n is None else make_serving_mesh(n, device="cuda")
    model = build_model(cfg, device=mesh.device if mesh else "cuda")
    cut = None
    if mesh is not None:        # each rank draws only its blocks
        vs = vocab_shard(cfg.vocab_size, n, mesh.rank)
        cut = lambda p, shape: trunk_slice(p, shape, mesh, mesh.rank, vs)
    params = model.init(torch.Generator(device=model.device).manual_seed(0),
                        cut=cut)
    engine = Engine(model, params, ByteTokenizer(cfg.vocab_size), {},
                    max_len=max_len, slots=TRUNK_B, device="cuda",
                    mesh=mesh, trunk_shard=mesh is not None)
    margins, orig = [], layers.moe_ffn
    if n is None and cfg.arch_type == "moe":
        def spy(p, x, c):
            probs = (x[:, -1].float() @ p["router"]).softmax(-1)
            top = probs.sort(-1, descending=True).values
            k = c.experts_per_token
            margins.append(top[:, k - 1] - top[:, k])
            return orig(p, x, c)
        layers.moe_ffn = spy
    try:
        g = torch.Generator(device="cpu").manual_seed(15)
        toks = torch.randint(3, cfg.vocab_size, (TRUNK_B, TRUNK_P),
                             generator=g, dtype=torch.int32).to(
                                 engine.device)
        logits, caches = engine._prefill(toks, TRUNK_P)
        row = engine._gather(logits)[:, -1].float()
        out, gaps, mins = [], [], []
        for i in range(TRUNK_FP32_STEPS):
            top2 = row.topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu())
            t = row.argmax(-1).to(torch.int32)
            out.append(t.cpu())
            margins.clear()
            pos = torch.full((TRUNK_B,), TRUNK_P + i, dtype=torch.int32,
                             device=engine.device)
            row = engine._gather(engine._decode(caches, t, pos)).float()
            mins.append(torch.stack(margins).amin(0).cpu() if margins
                        else torch.full((TRUNK_B,), 1.0))
    finally:
        layers.moe_ffn = orig
    tok = torch.stack(out, 1)
    if n is not None:
        return tok, None
    # a near-tie at step i may flip the token chosen at step i (the
    # logits gap) or the next step's routing (that step's router margin)
    tie = (torch.stack(gaps, 1) < TRUNK_GAP) | \
        (torch.cat([torch.ones(TRUNK_B, 1), torch.stack(mins, 1)[:, :-1]],
                   1) < TRUNK_MARGIN)
    return tok, tie


def trunk_fp32_check(arch, one, ranks, key=None):
    """The fp32 2-layer copy: every rank's greedy tokens equal the
    one-device engine's (`one`: tokens, near-ties) on every row up to
    its first near-tie (`key` names the run in the log)."""
    import torch
    want, tie = one
    first = [int(tie[b].nonzero()[0]) if tie[b].any() else TRUNK_FP32_STEPS
             for b in range(TRUNK_B)]
    for r, got in enumerate(ranks):
        for b in range(TRUNK_B):
            if not torch.equal(got[b, :first[b]], want[b, :first[b]]):
                raise AssertionError(
                    f"phase 14 fp32 {key or arch}: rank {r} row {b} greedy "
                    f"tokens "
                    f"{got[b].tolist()} differ from the one-device "
                    f"{want[b].tolist()} before the first near-tie at "
                    f"step {first[b]}")
    held = sum(f == TRUNK_FP32_STEPS for f in first)
    same = sum(torch.equal(g, want) for g in ranks)
    depth = TRUNK_FP32_DEPTH.get(arch, TRUNK_FP32_LAYERS)
    log(f"phase 14 fp32 {key or arch} ({depth} layers, {TRUNK_B} rows "
        f"x {TRUNK_FP32_STEPS} greedy steps, world {len(ranks)} over gloo): "
        f"tokens identical to the one-device engine up to each row's first "
        f"near-tie (logit gap < {TRUNK_GAP} or router margin < "
        f"{TRUNK_MARGIN}); rows with no near-tie {held}/{TRUNK_B}; ranks "
        f"identical on every row {same}/{len(ranks)}")
    if held < TRUNK_B // 2:
        raise AssertionError(f"phase 14 fp32 {key or arch}: only {held} "
                             f"rows free of near-ties")


def trunk_jobs(n):
    """The runs of a phase-14 world of n ranks: (key, arch, depth,
    max_len, P, page_size, the fp32 copy's max_len) of every TRUNK_ARCHS
    arch at TRUNK_M, then the TRUNK_SPLITS of M = n."""
    jobs = [(arch, arch, depth, max_len, P, 16, TRUNK_FP32_LEN)
            for arch, depth, max_len, P in TRUNK_ARCHS] if n == TRUNK_M \
        else []
    return jobs + [(key, key.split("/")[0], TRUNK_SPLIT_DEPTH, max_len,
                    TRUNK_SPLIT_P, page,
                    TRUNK_FP32_SPLIT_LEN.get(key, TRUNK_FP32_LEN))
                   for key, M, max_len, page, _ in TRUNK_SPLITS if M == n]


def trunk_world(rank, n, stores):
    """One rank of a gloo world of n ranks, its jobs (`trunk_jobs`) in
    turn (one world for the phase's jobs of n: each spawn costs the
    ranks' start-up), reusing the parent's mask `stores`: the bf16 runs
    (`trunk_rank`), then the fp32 greedy tokens. -> {key: results}."""
    import torch
    share_mask_stores(stores)
    out = {}
    for key, arch, depth, max_len, P, page, fp32_len in trunk_jobs(n):
        t0 = time.perf_counter()
        out[key] = trunk_rank(rank, n, arch, depth, max_len, P, key, page)
        gc.collect()
        torch.cuda.empty_cache()
        out[key]["fp32"] = trunk_fp32_greedy(rank, n, arch, fp32_len)[0]
        gc.collect()
        torch.cuda.empty_cache()
        out[key]["seconds"] = time.perf_counter() - t0
    return out


def _share(a, b):
    """Requests of run a whose tokens equal run b's -> 'k/n'."""
    return f"{sum(a[r] == b[r] for r in a)}/{len(a)}"


def paged_partial_rows(torch, np, H=15, K=5, Dh=64, sizes=(1, 8, 32)):
    """The partial form of paged_attention_span at smollm-360m's heads
    under the sequence split over 2 ranks, timed: phase 4's pool (B 8,
    32 pages of 16 a slot, 256 pages, holes, shared pages) cut to one
    rank's 8 offsets of each page (the main path's own calls, 4 pages a
    slot, are held by `_PartialSpy`), ranks 0 and 1, bf16 and
    fp32, against the plain partial (o within the paged tolerance, lse
    within 1e-5 in fp32 and 1e-4 in bf16); rank 1's call timed beside its
    plain version, its bound and sdpa over the gathered view of the
    rank's positions (which returns no lse). -> {S: bf16 row}."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_partial)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_partial_ref)
    dev = torch.device("cuda")
    B, ps, nP, P, M = 8, 16, 32, 256, TRUNK_M
    psl = ps // M
    rng = np.random.default_rng(27)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pt = rng.permutation(P)[:B * nP].reshape(B, nP).astype(np.int32)
    pt[:, 1:][rng.random((B, nP - 1)) < 0.15] = -1
    pt[1:4, :4] = pt[0, :4]
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-5
        lse_tol = 1e-4 if dtype == torch.bfloat16 else 1e-5
        kp = rng.normal(size=(P, ps, K, Dh)).astype(np.float32)
        vp = rng.normal(size=(P, ps, K, Dh)).astype(np.float32)
        for S in sizes:
            q = t(rng.normal(size=(B, S, H, Dh)).astype(np.float32)).to(
                dtype)
            pos = rng.integers(S, nP * ps - S, size=B).astype(np.int32)
            err = lerr = 0.0
            for r in range(M):
                base = r * psl
                args = (q, t(kp[:, base:base + psl]).to(dtype),
                        t(vp[:, base:base + psl]).to(dtype), t(pt), t(pos),
                        ps, base)
                o, lse = paged_attention_partial(*args)
                wo, wl = paged_attention_partial_ref(*args)
                err = max(err, (o - wo).abs().max().item())
                lerr = max(lerr, (lse - wl).abs().max().item())
                if not (err <= tol and lerr <= lse_tol):
                    raise AssertionError(
                        f"paged_attention_partial S={S} {dtype} rank {r}: "
                        f"max abs err o {err}, lse {lerr} (tol {tol}, "
                        f"{lse_tol})")
            ms = cuda_ms(torch, lambda: paged_attention_partial(*args))
            dev_ms = device_ms(torch, lambda: paged_attention_partial(*args))
            plain = cuda_ms(torch, lambda: paged_attention_partial_ref(*args))
            # the rank's positions of each slot's pages, gathered
            safe = t(pt).clamp(min=0).long()
            kc = args[1][safe].reshape(B, nP * psl, K, Dh).transpose(1, 2)
            vc = args[2][safe].reshape(B, nP * psl, K, Dh).transpose(1, 2)
            loc = torch.arange(nP * psl, device=dev)
            idx = loc // psl * ps + base + loc % psl
            qpos = t(pos)[:, None] + torch.arange(S, device=dev)[None, :]
            mapped = (t(pt) >= 0).repeat_interleave(psl, dim=1)
            mask = mapped[:, None, :] & (idx[None, None, :] <=
                                         qpos[:, :, None])
            qt = q.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask[:, None], enable_gqa=True)
            lib = cuda_ms(torch, sdpa)
            lib_dev = device_ms(torch, sdpa)
            # this run's work: the rank's offsets of the mapped pages each
            # slot reads up to its last query, q once, o and lse (fp32)
            # written; 4 operations per (query head, valid position,
            # channel)
            last = pos + S - 1
            pages = {int(pt[b, j]) for b in range(B) for j in range(nP)
                     if pt[b, j] >= 0 and j * ps + base <= last[b]}
            esz = q.element_size()
            nbytes = (2 * len(pages) * psl * K * Dh * esz
                      + B * S * H * Dh * esz + B * S * H * (Dh + 1) * 4
                      + B * nP * 4 + B * 4)
            flops = 4 * int(mask.sum().item()) * H * Dh
            peak = PEAK_FLOPS[str(dtype)[6:]]
            t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            log(f"paged_attention_partial H={H} K={K} Dh={Dh} S={S} "
                f"{str(dtype)[6:]} (pool [{P},{psl},{K},{Dh}], offsets "
                f"{base}-{base + psl - 1} of {ps}; ranks 0-{M - 1} held): "
                f"max abs err o {err:.3e}, lse {lerr:.3e}; {ms:.4f} ms, "
                f"device {dev_ms:.4f} ms; plain {plain:.4f} ms; sdpa on the "
                f"gathered view {lib:.4f} ms, device {lib_dev:.4f} ms; "
                f"bound {bound:.6f} ms ({by})")
            if dtype == torch.bfloat16:
                rows[S] = {
                    "name": "paged_attention_partial", "route": "cuda",
                    "source": "src/repro_torch/csrc/paged_attention.cu",
                    "replaces": "src/repro/kernels/paged_attention/"
                                "kernel.py:83",
                    "shape": f"B={B} S={S} H={H} K={K} Dh={Dh} bf16, "
                             f"{nP} pages, offsets {base}-"
                             f"{base + psl - 1} of {ps}",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib,
                    "library_device_ms": lib_dev}
    log("  (sdpa reads the already gathered view of the rank's positions "
        "and returns no log-sum-exp)")
    return rows


def paged_dh_rows(torch, np, H=15, K=5, Dh=64, sizes=(1, 8)):
    """The head_dim form of paged_attention_span at the head_dim world's
    pool (smollm-360m's heads, 2 ranks: 32 of the 64 channels, pages of
    9, 7 pages a slot of the 56 a pool of 8 slots holds, holes), timed:
    `paged_attention_scores` and `paged_attention_values` of rank 1's
    channels against their plain versions (bf16 and fp32, within DH_TOL
    of the plain output's largest magnitude), each beside its bound and
    its einsum on the gathered view of the rank's pages (the
    scores' with the scaled q block formed beforehand), timed in bf16
    (fp32 is checked only). -> [scores row, values row] at S = 1 in
    bf16."""
    from repro_torch.kernels.flash_attention.ref import qscale_tensor
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_scores, paged_attention_values)
    from repro_torch.kernels.paged_attention.ref import (
        dh_probs, paged_scores_ref, paged_values_ref)
    dev = torch.device("cuda")
    B, ps, nP, M = 8, 9, 7, 2
    P, dw = B * nP, Dh // M
    d0 = dw                             # rank 1's channels
    L, G = nP * ps, H // K
    rng = np.random.default_rng(29)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pt = rng.permutation(P)[:B * nP].reshape(B, nP).astype(np.int32)
    pt[:, 1:][rng.random((B, nP - 1)) < 0.15] = -1
    pt[1:4, :2] = pt[0, :2]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        kp = t(rng.normal(size=(P, ps, K, dw)).astype(np.float32)).to(dtype)
        vp = t(rng.normal(size=(P, ps, K, dw)).astype(np.float32)).to(dtype)
        for S in sizes:
            q = t(rng.normal(size=(B, S, H, Dh)).astype(np.float32)).to(
                dtype)
            pos = rng.integers(S, L - S, size=B).astype(np.int32)
            qpos = t(pos)[:, None] + torch.arange(S, device=dev)[None, :]
            mapped = (t(pt) >= 0).repeat_interleave(ps, dim=1)
            valid = mapped[:, None, :] & (torch.arange(L, device=dev)[
                None, None, :] <= qpos[:, :, None])
            sargs = (q, kp, t(pt), d0)
            sc = paged_attention_scores(*sargs)
            want = paged_scores_ref(*sargs)
            pr = dh_probs(want, valid, dtype)
            vargs = (pr, vp, t(pt))
            o = paged_attention_values(*vargs)
            wo = paged_values_ref(*vargs)
            errs = [(sc - want).abs().max().item() /
                    max(1.0, want.abs().max().item()),
                    (o - wo).abs().max().item() /
                    max(1.0, wo.abs().max().item())]
            if not max(errs) <= DH_TOL:
                raise AssertionError(
                    f"the head_dim form S={S} {dtype}: relative max abs "
                    f"err scores {errs[0]}, values {errs[1]} (tol {DH_TOL})")
            # the rank's pages gathered (once, outside the timing)
            safe = t(pt).clamp(min=0).long()
            kc = kp[safe].reshape(B, L, K, dw)
            vc = vp[safe].reshape(B, L, K, dw)
            qs = (q * qscale_tensor(dtype, Dh))[..., d0:d0 + dw].reshape(
                B, S, K, G, dw)
            pg = pr.reshape(B, S, K, G, L)
            libs = (lambda: torch.einsum("bqkgd,blkd->bqkgl", qs, kc),
                    lambda: torch.einsum("bqkgl,blkd->bqkgd", pg, vc))
            # this run's work: the mapped pages a slot reads up to its
            # last query (each page's K or V block once), q's block or P
            # read, the fp32 output written; 2 operations per (query
            # head, valid position, channel)
            last = pos + S - 1
            pages = {int(pt[b, j]) for b in range(B) for j in range(nP)
                     if pt[b, j] >= 0 and j * ps <= last[b]}
            esz = q.element_size()
            page_bytes = len(pages) * ps * K * dw * esz + B * nP * 4
            flops = 2 * int(valid.sum().item()) * H * dw
            peak = PEAK_FLOPS[str(dtype)[6:]]
            if dtype != torch.bfloat16:
                log(f"the head_dim form H={H} K={K} Dh={Dh} S={S} fp32: "
                    f"relative max abs err scores {errs[0]:.3e}, values "
                    f"{errs[1]:.3e}")
                continue
            for name, fn, plain, lib, nbytes, err in (
                    ("paged_attention_scores",
                     lambda: paged_attention_scores(*sargs),
                     lambda: paged_scores_ref(*sargs), libs[0],
                     page_bytes + B * S * H * dw * esz + B * S * H * L * 4,
                     errs[0]),
                    ("paged_attention_values",
                     lambda: paged_attention_values(*vargs),
                     lambda: paged_values_ref(*vargs), libs[1],
                     page_bytes + B * S * H * L * esz + B * S * H * dw * 4,
                     errs[1])):
                ms = cuda_ms(torch, fn)
                dev_ms = device_ms(torch, fn)
                plain_ms = cuda_ms(torch, plain)
                lib_ms, lib_dev = cuda_ms(torch, lib), device_ms(torch, lib)
                t_ops = flops / peak * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound = max(t_ops, t_bytes)
                by = "operations" if t_ops >= t_bytes else "bytes"
                log(f"{name} H={H} K={K} Dh={Dh} channels {d0}-"
                    f"{d0 + dw - 1} S={S} {str(dtype)[6:]} (pool [{P},{ps},"
                    f"{K},{dw}], {nP} pages a slot): relative max abs err "
                    f"{err:.3e}; {ms:.4f} ms, device {dev_ms:.4f} ms; plain "
                    f"{plain_ms:.4f} ms; einsum on the gathered view "
                    f"{lib_ms:.4f} ms, device {lib_dev:.4f} ms; bound "
                    f"{bound:.6f} ms ({by})")
                if S == 1:
                    rows.append({
                        "name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/paged_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention/"
                                    "kernel.py:83",
                        "shape": f"B={B} S={S} H={H} K={K} Dh={Dh} bf16, "
                                 f"channels {d0}-{d0 + dw - 1}, {nP} pages "
                                 f"of {ps}",
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": lib_ms, "library_device_ms": lib_dev})
    log("  (the einsums read the already gathered view of the rank's "
        "channels; max_abs_err is relative to max(1, |plain|))")
    return rows


def phase_trunk(torch, np):
    """Phase 14: trunk-sharded serving (`Engine(mesh, trunk_shard=True)`)
    of qwen1.5-0.5b (all 24 layers), qwen3-moe-30b-a3b (MOE_DEPTH
    layers), smollm-360m (all 32 layers; the sequence split),
    mamba2-370m (all 48 layers: w_in columns, conv channels, SSD heads)
    and recurrentgemma-9b (the RG-LRU width; its local attention on the
    sequence split) at full width in bf16 over a 2-rank gloo world on
    the one card, and smollm-360m at TRUNK_SPLIT_DEPTH layers on the
    head_dim branch (the same world) and the replicated branch (a world
    of 3), each against the one-device engine on the same seeded
    weights; first the partial paged kernel at smollm's rank-local pool
    and the head_dim form at the head_dim world's. -> kernel rows."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    partial = paged_partial_rows(torch, np)
    dh_rows = paged_dh_rows(torch, np)
    split_one = TRUNK_SPLITS[0][0]      # the splits' one-device run
    ones = {}
    for key, arch, depth, max_len, P in (
            *((a, a, d, m, p) for a, d, m, p in TRUNK_ARCHS),
            (split_one, "smollm-360m", TRUNK_SPLIT_DEPTH, 64,
             TRUNK_SPLIT_P)):
        t1 = time.perf_counter()
        ones[key] = trunk_one_device(torch, arch, depth, max_len, P, key)
        trunk_launch_check(f"{key} one device", ones[key]["cfg"], ones[key],
                           1)
        if key == arch:
            ones[key]["fp32"] = trunk_fp32_greedy(0, None, arch)
        gc.collect()
        torch.cuda.empty_cache()
        ones[key]["seconds"] = time.perf_counter() - t1
    log(f"[phase 14 one-device runs done at {time.perf_counter() - t0:.1f} "
        f"s]")
    # the ranks reuse the one-device engines' mask stores
    vocabs = {ones[k]["cfg"].vocab_size for k in ones}
    stores = {k: v for k, v in _STORES.items() if k[1] in vocabs}
    results = {}
    for n in (TRUNK_M, *sorted({M for _, M, *_ in TRUNK_SPLITS} -
                               {TRUNK_M})):
        t1 = time.perf_counter()
        worlds = spawn(n, trunk_world, n, stores, backend="gloo",
                       device="cuda")
        log(f"[phase 14 world of {n}: {time.perf_counter() - t1:.1f} s]")
        for job in trunk_jobs(n):
            results[job[0]] = (job, [w[job[0]] for w in worlds])
    branch = {key: b for key, _, _, _, b in TRUNK_SPLITS}
    for key, ((_, arch, depth, max_len, P, page, _), ranks) in \
            results.items():
        one = ones[split_one if key in branch else key]
        M = len(ranks)
        cfg = one["cfg"]
        want = one["first"]
        top = float(want.abs().max())
        ulps = TRUNK_FAMILY_ULPS.get(key, TRUNK_ULPS)
        tol = ulps * 2.0 ** (math.floor(math.log2(top)) - 7)
        for r, res in enumerate(ranks):
            trunk_launch_check(f"{key} rank {r}", cfg, res, M)
            rows = torch.ones(TRUNK_B, dtype=torch.bool)
            if one["routes"] is not None:
                for a, b in zip(res["routes"], one["routes"]):
                    rows &= (a == b).all(-1)
            held = int(rows.sum())
            err = float((res["first"] - want).abs().amax(-1)[rows].max()) \
                if held else float("inf")
            if held < TRUNK_B // 2 or not err <= tol:
                raise AssertionError(
                    f"phase 14 {key} rank {r}: first decode step's logits "
                    f"max abs err {err:.4e} over {held} rows, tolerance "
                    f"{tol:.4e} ({ulps} bf16 ulps at {top:.4f})")
            base = one["runs"]["dense"]
            ar = res["tally"].get("all-reduce", {})
            ag = res["tally"].get("all-gather", {})
            est = res["est"]
            log(f"phase 14 {key} ({depth or cfg.num_layers} layers, max_len "
                f"{max_len}, pages of {page}) rank {r} of {M} "
                f"({res['backend']}, {res['device']}; local heads "
                f"{res['local'][0]}/{res['local'][1]}, d_ff "
                f"{res['local'][2]}; cache, pool, head_dims "
                f"{res['splits']}): {res['seconds']:.1f} s in the world "
                f"({one['seconds']:.1f} s one device), built in "
                f"{res['build_s']:.1f} s; "
                f"first decode step logits max abs err {err:.4e} over "
                f"{held}/{TRUNK_B} rows (tolerance {tol:.4e}: {ulps} "
                f"bf16 ulps at {top:.4f}"
                + ("; rows routed alike" if one["routes"] is not None
                   else "") + ")")
            if key in branch:
                Dh = cfg.resolved_head_dim
                blk = (r * Dh // M, (r + 1) * Dh // M) \
                    if branch[key] == "dh" else None
                if res["splits"] != (branch[key], branch[key], blk):
                    raise AssertionError(
                        f"phase 14 {key} rank {r}: cache, pool and "
                        f"head_dims {res['splits']}, not "
                        f"{(branch[key], branch[key], blk)}")
            for k, run in res["runs"].items():
                vs = "" if k != "dense" else (
                    f" (one device {base['ms']:.2f}; requests identical "
                    f"to its run {_share(run['tokens'], base['tokens'])})")
                log(f"  {k}: {run['steps']} steps, {run['ms']:.2f} ms a "
                    f"step{vs}; eos {run['eos']}, cut {run['cut']} (valid "
                    f"prefixes); launches {run['launches']}; flash heads "
                    f"{run['flash']}, paged heads {run['paged_heads']}")
            for k, run in res["runs"].items():
                if run["flash_checked"] is not None:
                    n, shapes, e, e32 = run["flash_checked"]
                    log(f"  flash_attention on the main path ({k}), held "
                        f"against its plain version on the same inputs (the "
                        f"last {len(shapes) and min(n, 16)} of {n} calls; "
                        f"q, k shapes {shapes}): max abs err {e:.3e} bf16, "
                        f"{e32:.3e} fp32")
                elif run["launches"]["attention"]:
                    raise AssertionError(f"phase 14 {key} rank {r}: no "
                                         f"flash_attention call kept in "
                                         f"the {k} run")
            paged = res["runs"].get("paged", {})
            got = paged.get("partial_checked")
            if got is not None:
                log(f"  paged_attention_partial on the main path, held "
                    f"against its plain version on the same inputs (one "
                    f"call a layer of the last feed of each width S): "
                    + "; ".join(
                        f"S={S} {n} calls, rows with a live key {lv:.3f}, "
                        f"max abs err o {eo:.3e} lse {el:.3e} bf16, o "
                        f"{eo32:.3e} lse {el32:.3e} fp32"
                        for S, (n, eo, el, eo32, el32, lv) in sorted(
                            got.items())))
            if paged and (got is not None) != (res["reach"] is not None):
                raise AssertionError(
                    f"phase 14 {key} rank {r}: the paged run's partial "
                    f"kernel calls checked {got} against the sequence "
                    f"split {res['reach']}")
            dh = paged.get("dh_checked")
            if dh is not None:
                log(f"  the head_dim form (paged_attention_scores, "
                    f"paged_attention_values) on the main path, held "
                    f"against its plain version on the same inputs (one "
                    f"call each a layer of the last feed of each width S; "
                    f"error relative to max(1, |plain|)): " + "; ".join(
                        f"S={S} {n} calls, scores {e0:.3e} values {e1:.3e} "
                        f"bf16, scores {e2:.3e} values {e3:.3e} fp32"
                        for S, (n, e0, e1, e2, e3) in sorted(dh.items())))
            if paged and (dh is not None) != (
                    paged["plan"].pool == "dh"):
                raise AssertionError(
                    f"phase 14 {key} rank {r}: the paged run's head_dim "
                    f"form calls checked {dh} under the pool split "
                    f"{paged['plan'].pool}")
            if res["reach"] is not None:
                log(f"  sequence split: positions {res['positions']} of "
                    f"{max_len}, in-page offsets {res.get('offsets')}; live "
                    f"positions of the first step's cache in the rank's "
                    f"share {res['first_live']} ({TRUNK_B} rows x {P + 1} "
                    f"positions fed); positions the runs fed into it "
                    f"{res['reach']}")
                if res["first_live"] <= 0 or min(res["reach"].values()) <= 0:
                    raise AssertionError(
                        f"phase 14 {key} rank {r}: no live position in the "
                        f"rank's share ({res['first_live']}, "
                        f"{res['reach']})")
            log(f"  collectives of one decode step (B {TRUNK_B}, {max_len} "
                f"positions): all-reduce {ar.get('count', 0)} x, "
                f"{ar.get('bytes', 0)} B, wire {ar.get('wire_bytes', 0):.0f}"
                f" B; all-gather {ag.get('count', 0)} x, "
                f"{ag.get('bytes', 0)} B, wire {ag.get('wire_bytes', 0):.0f}"
                f" B; cost.py decode_step wire {res['cost']['wire_bytes']:.0f}"
                f" B {dict(res['cost']['collectives'])}")
            log(f"  memory: params held {res['block_params']} B; held "
                f"after build {res['held']} B (peak "
                f"{res['built_peak']} B), run peak {res['peak']} B; its "
                f"blocks' params {est['params']} (the trunk specs' "
                f"{res['spec_params']}: V / M vocab rows), decode caches "
                f"by leaf {est['caches']}, page pools {est.get('pools')}; "
                f"whole params {res['whole_params']}; one-device run peak "
                f"{one['peak']} B")
            log(f"  the rank's dense caches of 8 slots hold "
                f"{res['bytes']['caches']} B by leaf (h: the recurrent "
                f"state, conv: the conv cache), its page pools "
                f"{res['bytes'].get('pools')} B (as the runs build them)")
            # the build peak is held below the whole tree's bytes where
            # the rank draws at most half of every layer at full depth; the
            # TRUNK_SPLITS runs cut smollm-360m to 8 layers, where the fp32
            # draw of a rank's vocabulary rows (94 MB) outweighs the layers,
            # and the replicated branch keeps wk/wv and the FFN whole
            peak_held = key in branch or \
                res["built_peak"] < res["whole_params"]
            if res["block_params"] != est["params"] or not peak_held:
                raise AssertionError(
                    f"phase 14 {key} rank {r}: holds {res['block_params']} "
                    f"B of params, not its blocks' {est['params']}, or its "
                    f"peak while building ({res['built_peak']} B) reaches "
                    f"the whole tree's {res['whole_params']} B")
            for k in ("caches", "pools"):
                if res["bytes"].get(k) != est.get(k):
                    raise AssertionError(
                        f"phase 14 {key} rank {r}: its {k} hold "
                        f"{res['bytes'][k]} B, not the trunk specs' "
                        f"{est[k]} B")
        trunk_fp32_check(arch, ones[arch]["fp32"],
                         [res["fp32"] for res in ranks], key)
    smollm = results["smollm-360m"][1]
    row = partial[1]
    row["launches"] = smollm[0]["runs"]["paged"]["launches"][
        "paged_attention_partial"]
    row["model"] = "smollm-360m"
    row["main_path_max_abs_err"] = max(
        e[1] for res in smollm
        for e in res["runs"]["paged"]["partial_checked"].values())
    dh_world = results[split_one][1]
    for r in dh_rows:
        r["launches"] = dh_world[0]["runs"]["paged"]["launches"][r["name"]]
        r["model"] = f"smollm-360m ({TRUNK_SPLIT_DEPTH} layers)"
        r["main_path_max_err"] = max(
            e[1 if r["name"] == "paged_attention_scores" else 2]
            for res in dh_world
            for e in res["runs"]["paged"]["dh_checked"].values())
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return [row, *dh_rows]


# ------------------------------------- phase 15: data-parallel training

# smollm-360m at full width in bf16 on phase 9's global batch (B 8 x S
# 1024 of json batches, with a planted loss_mask: row r masks its first
# (5 r + 1) S / 128 positions, so the ranks' and the microbatches'
# counts differ), trained by `train(..., mesh=)` on a (data 2, model 1)
# gloo world on the one card, 3 steps a run; the twin is the one-device
# port step on the same seeded weights and batches (at microbatch 2 its
# plain accumulation, no DataParallelStep). DP_DEPTH of its 32 layers
# since phase 16 came (all 32 before), for the script's time (the seconds
# this saves: `scripts/phase_seconds.py`)
DP_ARCH, DP_B, DP_S, DP_STEPS, DP_WORLD = "smollm-360m", 8, 1024, 3, 2
DP_DEPTH = 16
# (label, microbatch, FSDP forced)
DP_RUNS = (("dp", 1, False), ("fsdp", 1, True), ("mb2", 2, False))
DP_FP32_DEPTH = 2       # the fp32 copies' layers
# fp32: before each step the one-device twin is set to the run's own
# gathered params and moments and stepped on the same batch (so Adam's
# eps noise of an earlier step, which a free-running twin carries into
# the later steps' gradients, does not enter the comparison: phase 16's
# qwen1.5 read 1.021e-5 free-running at its third step's moments); after
# each step the loss relative and each moment leaf relative to its
# largest magnitude; the params by the one-device parity test's rule
# (tests/test_torch_train_parity.py) with lr the step's: within 2 lr
# everywhere (Adam's update is g / (|g| + eps): where the clipped |g| is
# near or below eps, sum-order noise decides its size and sign) and
# within 1e-6 + 1e-5 lr wherever |mu| is at least 1e-3 of its leaf's
# largest and the clipped gradient is at least 100 eps (a skipped, stale
# or sign-flipped update of a block moves such elements by about lr);
# the elements past 1e-5 of their leaf's largest are counted and logged
DP_FP32_REL = 1e-5
# and the last step's new params against the AdamW formula applied to the
# run's own gathered params and moments (fp32 rounding only)
DP_UPDATE_REL = 1e-6
# and each step's loss, gnorm and moments (each leaf relative to its
# largest) against the same twin run free from the seeded weights, so
# that what the run carries from step to step is held too; set before
# its first card run from `scripts/train_shard_tolerance.py --dtype
# float32` (PERF.md section 2) and the card's free-running reading of
# run A's moments, 1.021e-5
DP_FREE_REL = 1e-4
# bf16: each step's loss and gnorm against the twin's, relative; from
# `scripts/train_shard_tolerance.py` (PERF.md section 2: on the CPU at 8
# layers and S 512 the sound splits read at most 1.26e-3, the planted
# faults 1.98e-2 or more, but for the MoE fractions' 8.0e-4, which the
# CPU test catches; 5e-3 is the geometric middle)
DP_BF16_REL = 5e-3
DP_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=20)   # phase 9's


def dp_batches(vocab, steps=DP_STEPS, B=DP_B, S=DP_S):
    """The first `steps` global batches of phase 9's seeded json pipeline,
    with the planted loss_mask (`scripts/train_shard_tolerance.py`'s)."""
    from repro_torch.core.grammars import load_grammar
    from repro_torch.core.tokenizer import ByteTokenizer
    from repro_torch.training.data import GrammarDataPipeline
    g, _ = load_grammar("json")
    it = iter(GrammarDataPipeline(g, ByteTokenizer(vocab), S, B, seed=0))
    out = []
    for _ in range(steps):
        b = next(it)
        b["loss_mask"] = b["loss_mask"].copy()
        for r in range(B):
            b["loss_mask"][r, :(5 * r + 1) * S // 128] = 0.0
        out.append(b)
    return out


def dp_model(torch, dtype="bfloat16", depth=None, device="cuda",
             arch=DP_ARCH):
    """(model, seeded whole params) of `arch` (DP_ARCH)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = replace(get_config(arch), dtype=dtype)
    if depth:
        cfg = replace(cfg, num_layers=depth)
    model = build_model(cfg, device=device)
    dev = model.device
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


class _CollectiveClock:
    """While active, times every torch.distributed tensor collective this
    process issues (a device sync before and after each, so the time is
    the collective's own, gloo's copies through host memory included)."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")

    def __init__(self, torch):
        self.torch, self.ms, self.calls = torch, 0.0, 0

    def __enter__(self):
        import torch.distributed as dist
        self.dist, self.orig = dist, {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self.orig.items():
            def timed(*a, _fn=fn, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                self.torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.calls += 1
                return out
            setattr(dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)


class _TrainFlashSpy:
    """While active, keeps the last `keep` forward and backward calls of
    the flash attention autograd Function (`ops._Attention`: the
    training path's own launches) with their inputs and outputs.
    `check()` holds each kept forward output against `chunked_attention`
    and each kept backward's dq, dk, dv against `ref.attention_bwd` on
    the same inputs, within ATTN_TOL of the plain version's largest
    magnitude -> [forward calls, backward calls, max rel err forward,
    backward]; raises beyond the tolerance."""

    def __init__(self, keep=2):
        self.keep, self.fwd, self.bwd, self.n = keep, [], [], [0, 0]

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        self.fn = ops._Attention
        self.orig = (self.fn.forward, self.fn.backward)
        fwd = self.orig[0]

        def forward(ctx, q, k, v, causal, window, chunk):
            out = fwd(ctx, q, k, v, causal, window, chunk)
            self.n[0] += 1
            self.fwd = (self.fwd + [((q.detach().clone(), k.detach().clone(),
                                      v.detach().clone()), causal, window,
                                     out.detach().clone())])[-self.keep:]
            return out

        def backward(ctx, do):
            # the Function's own backward, reading its saved tensors once
            # (a checkpointed layer's may be unpacked only once)
            saved = ctx.saved_tensors
            grads = ops.attention_backward(*saved, do, causal=ctx.causal,
                                           window=ctx.window)
            self.n[1] += 1
            self.bwd = (self.bwd + [(tuple(t.clone() for t in saved)
                                     + (do.clone(),), ctx.causal,
                                     ctx.window,
                                     [g.clone() for g in grads])]
                        )[-self.keep:]
            return (*grads, None, None, None)
        self.fn.forward = staticmethod(forward)
        self.fn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        fwd, bwd = self.orig
        self.fn.forward, self.fn.backward = staticmethod(fwd), \
            staticmethod(bwd)

    def check(self, who):
        from repro_torch.kernels.flash_attention.ref import (
            attention_bwd, chunked_attention)
        rel = lambda a, b: ((a.float() - b.float()).abs().max()
                            / b.float().abs().max().clamp(min=1e-30)).item()
        ef = eb = 0.0
        for (q, k, v), causal, window, out in self.fwd:
            plain = chunked_attention(q, k, v, causal=causal, q_offset=0,
                                      window=window, chunk=1024)
            ef = max(ef, rel(out, plain))
        for args, causal, window, grads in self.bwd:
            plain = attention_bwd(*args, causal=causal, window=window)
            eb = max(eb, *(rel(g, p) for g, p in zip(grads, plain)))
        tol = ATTN_TOL[str(self.fwd[0][0][0].dtype).removeprefix("torch.")]
        if not (ef <= tol and eb <= tol) or not all(self.n):
            raise AssertionError(
                f"{who}: flash attention on the path ({self.n[0]} forward, "
                f"{self.n[1]} backward calls): max rel err forward {ef}, "
                f"backward {eb} (tol {tol})")
        return [self.n[0], self.n[1], ef, eb]


def dp_held_bytes(model, mesh, fsdp, mb):
    """The bytes a rank holds by the specs: {"params": the FSDP blocks or
    whole leaves, "moments": mu and nu's ZeRO-1 blocks, "acc": one more
    moment's blocks when microbatched}."""
    from repro_torch.distributed.sharding import train_plan
    from repro_torch.training.optimizer import block_shape
    from repro_torch.training.tree import leaves
    whole = model.abstract_params()
    plan = train_plan(whole, mesh, fsdp=fsdp, rank=mesh.mesh_rank,
                      cfg=model.cfg)
    p = sum(math.prod(block_shape(lp.param)) * t.element_size()
            for lp, t in zip(plan.leaves, leaves(whole)))
    m = sum(math.prod(block_shape(lp.moment)) * 4 for lp in plan.leaves)
    return {"params": p, "moments": 2 * m, "acc": m if mb > 1 else 0}


def dp_tally_check(who, calls, cfg, mb, fsdp, steps):
    """A run's collectives a step (the final gather left out) against
    `cost.train_step`'s count at the same mesh: the reduce-scatters are
    cost.py's a microbatch; the all-gathers cost.py's, less the recompute
    gathers under remat (the port gathers an FSDP leaf once a
    microbatch, before the layers, and keeps it through the backward),
    plus one a later microbatch. -> the comparison's line."""
    from repro_torch.distributed import cost
    from repro_torch.launch.mesh import MeshShape
    mesh = MeshShape({"data": DP_WORLD, "model": 1}, ("data", "model"))
    orig = cost.needs_fsdp
    cost.needs_fsdp = lambda *a, **k: fsdp
    try:
        want = cost.train_step(cfg, DP_B, DP_S, mb, mesh=mesh)["collectives"]
    finally:
        cost.needs_fsdp = orig
    kind = {"fsdp-gather": "all-gather", "fsdp-scatter": "reduce-scatter"}
    # ZeRO-1's reduce-scatter carries the gradient in fp32 (as the
    # reference's compiled step sums it, after the cast); cost.py counts
    # a gradient in its param's dtype: its bytes at that dtype
    it = 2 if cfg.dtype == "bfloat16" else 4
    got = {}
    for call, d in calls.items():
        if call in ("gather", "loss", "gnorm", "moe"):
            continue
        k = kind.get(call, call)
        g = got.setdefault(k, {"count": 0, "wire_bytes": 0.0})
        g["count"] += d["count"] / steps
        g["wire_bytes"] += d["wire_bytes"] / steps * (
            it / 4 if call == "reduce-scatter" else 1)
    n_fsdp = calls.get("fsdp-gather", {}).get("count", 0) / (steps * mb)
    gw = calls.get("fsdp-gather", {}).get("wire_bytes", 0.0) / (steps * mb)
    rem = int(cfg.remat)
    exp_ag = (want["all-gather"]["count"] - rem * n_fsdp + (mb - 1) * n_fsdp,
              want["all-gather"]["wire_bytes"] + (mb - 1 - rem) * gw)
    exp_rs = (mb * want["reduce-scatter"]["count"],
              mb * want["reduce-scatter"]["wire_bytes"])
    ok = set(got) == {"all-gather", "reduce-scatter"} and \
        abs(got["all-gather"]["count"] - exp_ag[0]) < 1e-9 and \
        abs(got["reduce-scatter"]["count"] - exp_rs[0]) < 1e-9 and \
        math.isclose(got["all-gather"]["wire_bytes"], exp_ag[1],
                     rel_tol=1e-9) and \
        math.isclose(got["reduce-scatter"]["wire_bytes"], exp_rs[1],
                     rel_tol=1e-9) and \
        calls["loss"]["count"] == mb * steps and \
        calls["gnorm"]["count"] == steps
    line = (f"{who}: a step's collectives {json.dumps(got)} (ZeRO-1's "
            f"fp32 reduce-scatter at {it}-byte gradients); cost.py "
            f"{json.dumps(want)} (reduce-scatters x{mb} microbatches, "
            f"all-gathers less {rem} recompute gather(s) of {n_fsdp:.0f} "
            f"FSDP leaves); extra all-reduces a step: loss "
            f"{calls['loss']['count'] / steps:.0f}, gnorm "
            f"{calls['gnorm']['count'] / steps:.0f}")
    if not ok:
        raise AssertionError(line)
    return line


def sharded_bf16_run(torch, mesh, who, batches, steps, mb=1, fsdp=False,
                     depth=DP_DEPTH, arch=DP_ARCH):
    """One bf16 run of `arch` (`depth` layers) through `train(...,
    mesh=)` on this rank -> its losses, gnorms, held and specs' bytes,
    collectives by call, attention launches, ms a step after the first,
    gloo ms a step and calls, flash on the run's own calls (`who` names
    it) and the config."""
    from repro_torch.distributed.api import (collective_calls,
                                             reset_collective_tally)
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    model, params = dp_model(torch, depth=depth, arch=arch)
    init = [params]
    del params
    want = dp_held_bytes(model, mesh, fsdp, mb)
    data = _TimedIter(iter(batches))
    reset_collective_tally()
    attention.launches = attention_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _CollectiveClock(torch) as clock, _TrainFlashSpy() as spy:
        _, result = train(model, init.pop(), data, steps,
                          opt_cfg=AdamWConfig(**DP_OPT), log_every=1,
                          verbose=False, device="cuda", mesh=mesh,
                          microbatch=mb, fsdp=fsdp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rec = {"losses": result.losses,
           "gnorms": [m["gnorm"] for m in result.metrics],
           "held": result.held, "want": want, "calls": collective_calls(),
           "launches": (attention.launches, attention_backward.launches),
           "step_ms": data.later_steps_ms(t0 + secs),
           "gloo_ms": clock.ms / steps, "gloo_calls": clock.calls,
           "flash": spy.check(who), "cfg": model.cfg}
    del model, result
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def dp_rank(rank, n, batches, depth):
    """One rank of phase 15's gloo world: each of DP_RUNS through
    `train(..., mesh=)` in bf16 at `depth` layers, then the fp32 copies
    at DP_FP32_DEPTH layers step by step (rank 0 steps the one-device
    twin beside them and compares after each step). -> {label: ...}."""
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    mesh = make_train_mesh(n, device="cuda")
    out = {label: sharded_bf16_run(torch, mesh, f"phase 15 {label} rank "
                                   f"{rank}", batches, DP_STEPS, mb, fsdp,
                                   depth)
           for label, mb, fsdp in DP_RUNS}
    for label, mb, fsdp in DP_RUNS:
        out[label]["fp32"] = dp_fp32(torch, mesh, batches, mb, fsdp)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_fp32(torch, mesh, batches, mb, fsdp, depth=DP_FP32_DEPTH,
            arch=DP_ARCH):
    """The fp32 copy of one run at `depth` layers, step by step; before
    each step the lead rank sets the plain one-device twin (no mesh) to
    the run's own gathered params and moments, steps it on the same
    batch and compares (so Adam's eps noise of an earlier step does not
    carry into a later step's comparison) -> the worst readings over the
    steps (the lead rank; zeros elsewhere): "loss" relative; "moments"
    of each leaf's largest ("moments_leaf" the worst leaf,
    "moments_top" the four worst of the last step); "params" of each
    leaf's largest and "params_lr" over the step's lr; "sure" over
    1e-6 + 1e-5 lr where |mu| is at least 1e-3 of its leaf's largest
    and the element's clipped gradient (the twin's, read from its mu) is
    at least 100 eps (DP_FP32 rule); the largest count in a step of
    "over" (elements past 1e-5 of their leaf's largest), "over_near" (of
    them, those whose gradient was below 100 eps), "past_sure" (|mu|-sure
    elements past 1e-6 + 1e-5 lr) and "near_eps" (of them, those whose
    gradient was below 100 eps); "update" the last step against the
    AdamW formula (`dp_update_err`)."""
    from repro_torch.distributed.sharding import train_plan
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import flatten_with_path, leaves, tree_map
    opt = AdamWConfig(**DP_OPT)
    model, whole = dp_model(torch, "float32", depth, device=mesh.device,
                            arch=arch)
    step = make_train_step(model, opt, mesh, mb, fsdp)
    params = step.shard(whole)
    state = step.init_state(params)
    lead = mesh.lead
    # every rank's plan, in global rank order (rank r is mesh place r)
    abstract = model.abstract_params()
    plans = [train_plan(abstract, mesh, fsdp=step.fsdp, rank=r,
                        cfg=model.cfg)
             for r in range(mesh.shape["data"] * mesh.shape["model"])]
    if lead:        # the plain one-device step, from the run's own state
        twin_step = make_train_step(model, opt, None, mb)
        free = dp_free_run(torch, twin_step, whole, batches, mesh.device)
        prev, prev_state = whole, init_opt_state(whole)
    del whole
    worst = {"loss": 0.0, "moments": 0.0, "moments_leaf": None,
             "moments_top": [],
             "params_lr": 0.0, "params": 0.0, "sure": 0.0, "over": 0,
             "over_near": 0, "past_sure": 0, "near_eps": 0, "update": 0.0,
             "free": 0.0, "free_of": None}
    rel = lambda a, w: ((a - w).abs().max()
                        / w.abs().max().clamp(min=1e-30)).item()
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v).to(mesh.device) for k, v in b.items()}
        params, state, m = step(params, state, tb)
        got = lead_whole(torch, params, plans, lambda lp: lp.param, lead)
        mom = {k: lead_whole(torch, state[k], plans, lambda lp: lp.moment,
                             lead) for k in ("mu", "nu")}
        # every rank's cached blocks back to the card before the lead
        # steps the twin (phase 16's four ranks share one card)
        torch.cuda.empty_cache()
        if not lead:
            continue
        # the free-running twin's step i against the run's
        f_loss, f_gnorm, f_mom = free[i]
        for e, what in [
                (abs(float(m["loss"]) - f_loss) / abs(f_loss), "loss"),
                (abs(float(m["gnorm"]) - f_gnorm) / abs(f_gnorm), "gnorm"),
                *((rel(a, w.to(a.device)), f"{k}{path}")
                  for k in ("mu", "nu")
                  for (path, a), w in zip(flatten_with_path(mom[k]),
                                          f_mom[k]))]:
            if e > worst["free"]:
                worst["free"], worst["free_of"] = e, f"{what} step {i + 1}"
        mu0 = [t.clone() for t in leaves(prev_state["mu"])]
        tp, ts, tm = twin_step(prev, prev_state, tb)   # moments in place
        lr = float(tm["lr"])
        worst["loss"] = max(worst["loss"], abs(
            float(m["loss"]) - float(tm["loss"])) / abs(float(tm["loss"])))
        top = []
        for k in ("mu", "nu"):
            for (path, a), w in zip(flatten_with_path(mom[k]),
                                    leaves(ts[k])):
                e = rel(a, w)
                top.append((e, f"{k}{path}", float(w.abs().max())))
                if e > worst["moments"]:
                    worst["moments"] = e
                    worst["moments_leaf"] = f"{k}{path}"
        worst["moments_top"] = sorted(top, reverse=True)[:4]
        # the twin's clipped gradient of this step, from its mu
        g = [(mu - opt.beta1 * m0).abs() / (1 - opt.beta1)
             for mu, m0 in zip(leaves(ts["mu"]), mu0)]
        bound = 1e-6 + 1e-5 * lr
        n = {"over": 0, "over_near": 0, "past_sure": 0, "near_eps": 0}
        for a, w, mu, gl in zip(leaves(got), leaves(tp), leaves(ts["mu"]),
                                g):
            sm = gl < 100 * opt.eps
            d = (a - w).abs()
            worst["params"] = max(worst["params"], rel(a, w))
            worst["params_lr"] = max(worst["params_lr"], d.max().item() / lr)
            mu = mu.abs()
            sure = mu >= 1e-3 * mu.max().clamp(min=1e-30)
            held = sure & ~sm
            if held.any():
                worst["sure"] = max(worst["sure"],
                                    d[held].max().item() / bound)
            past = sure & (d > bound)
            big = d > 1e-5 * w.abs().max()
            for k, x in (("over", big), ("over_near", big & sm),
                         ("past_sure", past), ("near_eps", past & sm)):
                n[k] += int(x.sum().item())
        for k, v in n.items():
            worst[k] = max(worst[k], v)
        if b is batches[-1]:    # the twin's own step counter and lr
            worst["update"] = dp_update_err(opt, prev, got, mom,
                                            ts["step"], tm["lr"])
        # copies: a gathered moment may be the rank's own tensor, which
        # the next step updates in place; the step counter the twin's own
        prev, prev_state = got, tree_map(torch.clone, {
            "mu": mom["mu"], "nu": mom["nu"], "step": ts["step"]})
        del tp, ts
    return worst


def dp_free_run(torch, twin_step, whole, batches, device):
    """The one-device fp32 twin run free from the seeded params `whole`
    (left as they are) over `batches` -> per step (loss, gnorm, {"mu",
    "nu": the moment leaves in host memory})."""
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.tree import leaves
    params, state, out = whole, init_opt_state(whole), []
    for b in batches:
        tb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        params, state, m = twin_step(params, state, tb)
        out.append((float(m["loss"]), float(m["gnorm"]),
                    {k: [t.to("cpu", copy=True) for t in leaves(state[k])]
                     for k in ("mu", "nu")}))
    del params, state
    torch.cuda.empty_cache()
    return out


def dp_fp32_check(who, fp, depth):
    """Log `dp_fp32`'s readings of one run and raise past a bound."""
    log(f"{who}: fp32 at {depth} layers against the twin set to the run's "
        f"own params and moments before each step (its own step counter): "
        f"loss {fp['loss']:.3e} relative, moments {fp['moments']:.3e} of "
        f"their leaf's largest ({fp['moments_leaf']}; bound {DP_FP32_REL} "
        f"each, every step); params {fp['params_lr']:.3e} x the step's lr "
        f"(bound 2), where |mu| >= 1e-3 of its leaf's largest and |g| at "
        f"least 100 eps {fp['sure']:.3e} x 1e-6 + 1e-5 lr (bound 1; "
        f"{fp['past_sure']} |mu|-sure elements past it in a step, "
        f"{fp['near_eps']} of them with |g| below 100 eps); "
        f"{fp['params']:.3e} of their leaf's largest, {fp['over']} "
        f"elements over 1e-5 of it in a step, {fp['over_near']} of them "
        f"with |g| below 100 eps; the last step's update "
        f"{fp['update']:.3e} from the AdamW formula (bound "
        f"{DP_UPDATE_REL}); against the free-running twin, loss, gnorm and "
        f"moments over the steps {fp['free']:.3e} ({fp['free_of']}; bound "
        f"{DP_FREE_REL})")
    log(f"{who}: fp32 moments, the worst leaves (error of the leaf's "
        f"largest, leaf, its largest): {fp['moments_top']}")
    if not (fp["loss"] <= DP_FP32_REL and fp["moments"] <= DP_FP32_REL
            and fp["params_lr"] <= 2.0 and fp["sure"] <= 1.0
            and fp["update"] <= DP_UPDATE_REL
            and fp["free"] <= DP_FREE_REL):
        raise AssertionError(f"{who}: fp32 beyond the bound")


def lead_whole(torch, tree, plans, block_of, lead):
    """The whole tree from every rank's blocks of `tree` (params or
    moments; `block_of(leaf plan)` the rank's slices), on the lead rank
    (global rank 0), else None: each split leaf's blocks gathered to the
    lead in host memory (an all-gather would hand every rank the whole
    tree), a leaf every rank holds whole taken as the lead's own."""
    import torch.distributed as dist
    from repro_torch.training.tree import leaves, unflatten
    out = []
    for i, t in enumerate(leaves(tree)):
        shape = plans[0].leaves[i].shape
        if tuple(t.shape) == tuple(shape):
            out.append(t)
            continue
        src = t.detach().cpu().contiguous()
        bufs = [torch.empty_like(src) for _ in plans] if lead else None
        dist.gather(src, bufs, dst=0)
        if lead:
            whole = torch.empty(shape, dtype=t.dtype)
            for p, b in zip(plans, bufs):
                whole[block_of(p.leaves[i])] = b
            out.append(whole.to(t.device))
    return unflatten(tree, out) if lead else None


def dp_update_err(opt, prev, got, mom, step, lr):
    """The last step's ZeRO-1 update held to the AdamW formula on the
    run's own gathered tensors: the params before the step (`prev`), the
    moments after it (`mom`, which hold the step's clipped gradient) ->
    the largest difference of the gathered new params (`got`) from
    prev - lr ((mu / b1c) / (sqrt(nu / b2c) + eps) + wd prev [matrices]),
    over each leaf's largest magnitude. A block updated from another
    block's moments, skipped, cast or gathered out of place differs by
    about lr."""
    from repro_torch.training.tree import leaves
    b1c = 1 - opt.beta1 ** step.float()
    b2c = 1 - opt.beta2 ** step.float()
    err = 0.0
    for p, new, mu, nu in zip(leaves(prev), leaves(got), leaves(mom["mu"]),
                              leaves(mom["nu"])):
        delta = (mu / b1c) / ((nu / b2c).sqrt() + opt.eps)
        if p.dim() >= 2:
            delta = delta + opt.weight_decay * p
        want = p - lr * delta
        err = max(err, ((new - want).abs().max()
                        / want.abs().max().clamp(min=1e-30)).item())
    return err


def dp_twin(torch, batches, mb, steps=DP_STEPS, depth=DP_DEPTH,
            arch=DP_ARCH):
    """The one-device bf16 run of the same weights and batches through
    `train()` with no mesh (at microbatch 2 the plain accumulation of
    `make_train_step`, no `DataParallelStep`) -> (losses, gnorms, ms a
    step)."""
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    model, params = dp_model(torch, depth=depth, arch=arch)
    init = [params]
    del params
    data = _TimedIter(iter(batches))
    torch.cuda.synchronize()
    _, result = train(model, init.pop(), data, steps,
                      opt_cfg=AdamWConfig(**DP_OPT), log_every=1,
                      verbose=False, device="cuda", microbatch=mb)
    torch.cuda.synchronize()
    ms = data.later_steps_ms(time.perf_counter())
    out = (result.losses, [m["gnorm"] for m in result.metrics], ms)
    del model, result
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_data_parallel(torch, np, depth=DP_DEPTH):
    """Phase 15: data-parallel training (`train(..., mesh=)`) of
    smollm-360m at full width (`depth` layers) in bf16 on a (data 2,
    model 1) gloo world on the one card: plain DP + ZeRO-1, FSDP forced and
    microbatch 2, each 3 steps of phase 9's json batches with the
    planted loss_mask, against the one-device port step on the same
    seeded weights (bf16 within DP_BF16_REL; fp32 copies at
    DP_FP32_DEPTH layers by `dp_fp32`'s rules);
    each rank's bytes against the specs', the collectives against
    cost.py's, the flash kernels on the run's own calls against their
    plain versions. -> the rank's launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    batches = dp_batches(get_config(DP_ARCH).vocab_size)
    twins = {mb: dp_twin(torch, batches, mb, depth=depth) for mb in (1, 2)}
    log(f"[phase 15 twins done at {time.perf_counter() - t0:.1f} s]")
    t1 = time.perf_counter()
    ranks = spawn(DP_WORLD, dp_rank, DP_WORLD, batches, depth,
                  backend="gloo", device="cuda")
    log(f"[phase 15 world of {DP_WORLD}: {time.perf_counter() - t1:.1f} s]")
    launches = {}
    for label, mb, fsdp in DP_RUNS:
        losses, gnorms, twin_ms = twins[mb]
        r0 = ranks[0][label]
        who = f"phase 15, {DP_ARCH} {label} (data {DP_WORLD}, microbatch " \
              f"{mb}, fsdp {fsdp})"
        worst = max(max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                            losses)),
                    max(abs(a - b) / abs(b) for a, b in zip(r0["gnorms"],
                                                            gnorms)))
        log(f"{who}: losses {r0['losses']} vs the twin's {losses}; gnorms "
            f"{r0['gnorms']} vs {gnorms}; worst relative difference "
            f"{worst:.3e} (bound {DP_BF16_REL})")
        if not worst <= DP_BF16_REL:
            raise AssertionError(f"{who}: bf16 beyond the bound")
        dp_fp32_check(who, r0["fp32"], DP_FP32_DEPTH)
        for rank, res in enumerate(ranks):
            r = res[label]
            log(f"{who} rank {rank}: holds {r['held']} bytes, the specs "
                f"{r['want']}; attention launches {r['launches'][0]} "
                f"forward, {r['launches'][1]} backward; flash on the run's "
                f"own calls {r['flash']}; {r['step_ms']:.1f} ms a step after "
                f"the first (twin {twin_ms:.1f}); {r['gloo_ms']:.1f} ms a "
                f"step in "
                f"{r['gloo_calls'] / DP_STEPS:.0f} gloo collectives")
            if r["held"] != r["want"]:
                raise AssertionError(f"{who} rank {rank}: held bytes differ "
                                     f"from the specs'")
            n_attn = r["cfg"].num_layers * DP_STEPS * mb
            fwd = n_attn * (1 + int(r["cfg"].remat))
            if tuple(r["launches"]) != (fwd, n_attn):
                raise AssertionError(f"{who} rank {rank}: attention "
                                     f"launched {r['launches']}, want "
                                     f"{(fwd, n_attn)}")
            log("  " + dp_tally_check(f"{who} rank {rank}", r["calls"],
                                      r["cfg"], mb, fsdp, DP_STEPS))
        launches[label] = r0["launches"]
    log(f"[phase 15 done in {time.perf_counter() - t0:.1f} s]")
    return launches


# ------------------------------------- phase 16: the model axis in training

# (label, arch, layers (None: all), data, model). Run A, the Megatron
# path with whole heads: qwen1.5-0.5b at full width and depth (24 layers,
# 16/16 heads of 64, QKV bias, d_ff 2816, V 151936, untied) on a (data 2,
# model 2) world of 4 gloo ranks. Run B, the gathers branch: smollm-360m
# (15/5 heads: wq/wk/wv cut inside heads and gathered into whole heads;
# tied) at 8 of 32 layers on a (data 1, model 2) world. bf16, remat, phase
# 15's json batches (B 8 x S 1024, its planted loss_mask), 3 steps
# through `train(..., mesh=)`; each run's twin is the one-device port
# step on the same seeded weights and batches; fp32 copies at 2 layers
# by phase 15's rules (`dp_fp32`)
MA_RUNS = (("A", "qwen1.5-0.5b", None, 2, 2), ("B", "smollm-360m", 8, 1, 2))
MA_STEPS, MA_FP32_DEPTH = 3, 2
# bf16: each step's loss and gnorm against the twin's, relative; from
# `scripts/train_shard_tolerance.py --axis model --device cuda
# --model-depths 24,8 --seq 1024` (PERF.md section 2), set before this
# phase first ran: the sound splits read 5.879e-4 (run A) and 1.002e-4
# (run B) on the card, the planted faults 1.797e-3 (`norm-m-times`, the
# weakest), 0.4632 and 0.7519; 1e-3 lies just under their geometric
# middle (1.028e-3)
MA_BF16_REL = 1e-3


def ma_rank(rank, label, arch, depth, D, M, batches, spawned):
    """One rank of a phase 16 world: the bf16 run through `train(...,
    mesh=)`, then the fp32 copy at MA_FP32_DEPTH layers (`dp_fp32`: the
    lead rank steps the one-device twin beside it). `spawned` is the
    parent's clock (time.time()) when it started the world."""
    import torch
    from repro_torch.launch.mesh import make_train_mesh
    started = time.time() - spawned
    mesh = make_train_mesh(D, M, device="cuda")
    meshed = time.time() - spawned
    t0 = time.perf_counter()
    rec = sharded_bf16_run(torch, mesh, f"phase 16 run {label} rank {rank}",
                           batches, MA_STEPS, depth=depth, arch=arch)
    t1 = time.perf_counter()
    rec["coords"] = (mesh.rank, mesh.model_rank)
    rec["fp32"] = dp_fp32(torch, mesh, batches, 1, False,
                          depth=MA_FP32_DEPTH, arch=arch)
    rec["secs"] = (t1 - t0, time.perf_counter() - t1)
    rec["clock"] = (started, meshed, time.time() - spawned)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ma_tally_check(who, calls, cfg, D, M, steps):
    """A run's collectives a step (the final gather left out) against
    `cost.train_step`'s count at the same (data, model) mesh. GSPMD's on
    the model axis (the row blocks', the lookup's and the column inputs'
    gradient all-reduces): cost.py's all-reduces less its three
    cross-entropy ones, less one a layer under remat (torch's recompute
    stops at the last tensor the backward needs, before the FFN's
    row-sum; cost.py counts it). The data axis' ZeRO-1 reduce-scatters
    (fp32, against cost.py's at the param's dtype) and all-gathers:
    cost.py's. The port's own, pinned: the cross-entropy's 6 (max, sum,
    gold, again in the chunk's recompute), the norm's, the q/k/v gathers
    and reduce-scatters where M does not divide the kv heads, the QKV
    biases' gradients, the loss's on the data axis. -> the line."""
    from repro_torch.distributed import cost
    from repro_torch.distributed.sharding import trunk_plan
    from repro_torch.launch.mesh import MeshShape
    mesh = MeshShape({"data": D, "model": M}, ("data", "model"))
    orig = cost.needs_fsdp
    cost.needs_fsdp = lambda *a, **k: False
    try:
        want = cost.train_step(cfg, DP_B, DP_S, 1, mesh=mesh)["collectives"]
    finally:
        cost.needs_fsdp = orig
    rem, L = int(cfg.remat), cfg.num_layers
    it = 2 if cfg.dtype == "bfloat16" else 4
    tp = trunk_plan(cfg, M)
    rows = DP_B * DP_S // D
    ce = 3 * cost.wire("all-reduce", rows * 4, M)
    drop = rem * L if tp.ff_split else 0
    data = cost._Tally(mesh)
    cost._grad_collectives(data, cfg, mesh, False, rem)
    zero = {"count": 0.0, "wire_bytes": 0.0}
    dar = data.coll.get("all-reduce", zero)
    per = lambda names, k: sum(calls.get(c, {}).get(k, 0)
                               for c in names) / steps
    got_ar = (per(("row-sum", "lookup", "col-grad"), "count"),
              per(("row-sum", "lookup", "col-grad"), "wire_bytes"))
    exp_ar = (want["all-reduce"]["count"] - 3 - dar["count"] - drop,
              want["all-reduce"]["wire_bytes"] - ce - dar["wire_bytes"]
              - drop * cost.wire("all-reduce", rows * cfg.d_model * it, M))
    ok = abs(got_ar[0] - exp_ar[0]) < 1e-9 and \
        math.isclose(got_ar[1], exp_ar[1], rel_tol=1e-9)
    data_got = {}
    for kind in ("reduce-scatter", "all-gather"):
        d = data.coll.get(kind, zero)
        g = (per((kind,), "count"), per((kind,), "wire_bytes")
             * (it / 4 if kind == "reduce-scatter" else 1))
        data_got[kind] = g
        ok = ok and abs(g[0] - d["count"]) < 1e-9 and \
            math.isclose(g[1], d["wire_bytes"], rel_tol=1e-9, abs_tol=1e-9)
    pinned = {"ce": 6, "model-gnorm": 1}
    if tp.gathers:
        pinned.update({"qkv-gather": (1 + rem) * L, "qkv-scatter": L})
    if cfg.qkv_bias:
        pinned["bias-grad"] = 3 * L
    if D > 1:
        pinned.update({"loss": 1, "gnorm": 1})
    own = {c: d["count"] / steps for c, d in calls.items()
           if c not in ("row-sum", "lookup", "col-grad", "reduce-scatter",
                        "all-gather", "gather")}
    ok = ok and own == pinned
    line = (f"{who}: a step's model-axis all-reduces (row-sum, lookup, "
            f"col-grad) {got_ar[0]:.0f} of {got_ar[1]:.6g} wire bytes, "
            f"cost.py's less its 3 CE and {drop} recompute ones "
            f"{exp_ar[0]:.0f} of {exp_ar[1]:.6g}; data axis "
            f"{json.dumps(data_got)} (ZeRO-1's fp32 reduce-scatter at "
            f"{it}-byte gradients), cost.py "
            f"{json.dumps({k: v for k, v in data.coll.items()})}; the port's "
            f"own a step {json.dumps(own)}, pinned {json.dumps(pinned)}; "
            f"cost.py's all-to-all {json.dumps(want.get('all-to-all'))}")
    if not ok:
        raise AssertionError(line)
    return line


def phase_model_axis(torch, np):
    """Phase 16: the model axis in training (`train(..., mesh=)` on
    (data, model) worlds of gloo ranks on the one card, MA_RUNS): each
    run's bf16 loss and gnorm against its one-device twin within
    MA_BF16_REL; fp32 copies at MA_FP32_DEPTH layers by phase 15's rules
    (`dp_fp32`); each rank's bytes against the specs'; the collectives
    against cost.py's (`ma_tally_check`); the flash kernels on the run's
    own calls against their plain versions. -> {run: the lead rank's
    attention launches}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    launches = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 16: this process holds {torch.cuda.memory_allocated()} B "
        f"on the card, {torch.cuda.memory_reserved()} B reserved]")
    for label, arch, depth, D, M in MA_RUNS:
        t1 = time.perf_counter()
        batches = dp_batches(get_config(arch).vocab_size, MA_STEPS, DP_B,
                             DP_S)
        losses, gnorms, twin_ms = dp_twin(torch, batches, 1, MA_STEPS,
                                          depth, arch)
        t2 = time.perf_counter()
        ranks = spawn(D * M, ma_rank, label, arch, depth, D, M, batches,
                      time.time(), backend="gloo", device="cuda")
        r0 = ranks[0]
        cfg = r0["cfg"]
        who = f"phase 16 run {label}, {arch} ({cfg.num_layers} layers, " \
              f"data {D}, model {M})"
        log(f"[{who}: twin {t2 - t1:.1f} s, world of {D * M} "
            f"{time.perf_counter() - t2:.1f} s]")
        worst = max(max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                            losses)),
                    max(abs(a - b) / abs(b) for a, b in zip(r0["gnorms"],
                                                            gnorms)))
        log(f"{who}: losses {r0['losses']} vs the twin's {losses}; gnorms "
            f"{r0['gnorms']} vs {gnorms}; worst relative difference "
            f"{worst:.3e} (bound {MA_BF16_REL})")
        if not worst <= MA_BF16_REL:
            raise AssertionError(f"{who}: bf16 beyond the bound")
        dp_fp32_check(who, r0["fp32"], MA_FP32_DEPTH)
        n_attn = cfg.num_layers * MA_STEPS
        for rank, r in enumerate(ranks):
            log(f"{who} rank {rank} at {r['coords']}: in its process "
                f"{r['clock'][0]:.1f} s after the spawn, its mesh at "
                f"{r['clock'][1]:.1f} s, done at {r['clock'][2]:.1f} s; bf16 "
                f"run {r['secs'][0]:.1f} s, fp32 copy {r['secs'][1]:.1f} s; "
                f"holds "
                f"{r['held']} bytes, the specs {r['want']}; attention launches "
                f"{r['launches'][0]} forward, {r['launches'][1]} backward; "
                f"flash on the run's own calls {r['flash']}; "
                f"{r['step_ms']:.1f} ms a step after the first (twin "
                f"{twin_ms:.1f}); {r['gloo_ms']:.1f} ms a step in "
                f"{r['gloo_calls'] / MA_STEPS:.0f} gloo collectives")
            if r["held"] != r["want"]:
                raise AssertionError(f"{who} rank {rank}: held bytes differ "
                                     f"from the specs'")
            want = (n_attn * (1 + int(cfg.remat)), n_attn)
            if tuple(r["launches"]) != want:
                raise AssertionError(f"{who} rank {rank}: attention "
                                     f"launched {r['launches']}, want {want}")
            log("  " + ma_tally_check(f"{who} rank {rank}", r["calls"], cfg,
                                      D, M, MA_STEPS))
        launches[label] = r0["launches"]
        del ranks
        gc.collect()
    log(f"[phase 16 done in {time.perf_counter() - t0:.1f} s]")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.masked_logits.ops import (
        apply_grammar_mask, apply_grammar_mask_span)
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.serve import build_engine
    counters = (fused_mask_select, attention, apply_grammar_mask,
                apply_grammar_mask_span, paged_attention, attention_backward)

    t_start = time.perf_counter()
    smi = smi_line()
    log(f"device: {smi}; torch {torch.__version__}; CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({len(_build.sources())} sources, sm_90a)")
    logfile = _build.BUILD_DIR / f"build_{_build.source_hash()}.log"
    if logfile.exists():
        for line in logfile.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    share_mask_stores()
    stamp = lambda what: log(f"[{what} done at "
                             f"{time.perf_counter() - t_start:.1f} s]")
    phase_model_check(torch, np)
    stamp("phases 1-3")

    t0 = time.perf_counter()
    engine, bundles, tok = build_engine(
        "smollm-360m", grammars=("json", "jsonmsg"), max_len=512, slots=8,
        device="cuda")
    log(f"engine build (mask stores + random weights): "
        f"{time.perf_counter() - t0:.1f} s")
    req0 = e2e_requests()[0]
    n = len(engine._request_ids(req0)) - 1
    main_S = engine._bucketed_prompt(list(range(n)))[0].shape[1]

    rows = [phase_fused_select(torch, np, engine),
            phase_attention(torch, np, main_S),
            *phase_masked_logits(torch, np, engine),
            phase_paged_attention(torch, np)[1]]
    for r in rows:
        r["model"] = "smollm-360m"
    stamp("phase 4")
    launches, dense_states = phase_e2e(torch, engine, bundles, counters)
    rows[0]["launches"] = launches["fused_mask_select"]
    rows[1]["launches"] = launches["attention"]
    found, path_states = phase_new_paths(torch, engine, bundles, counters,
                                         dense_states)
    # phase 12 holds the sharded engine to these token streams
    unsharded = {"dense": tokens_of(dense_states),
                 **{k: tokens_of(v) for k, v in path_states.items()}}
    for r in rows[2:]:
        r["launches"] = found[r["name"]]
    stamp("phase 5")
    phase_forward_breakdown(torch, engine)
    stamp("phase 6")
    phase_front_end(torch, engine, bundles, counters, dense_states)
    stamp("phase 7")
    del engine, bundles, dense_states
    gc.collect()
    torch.cuda.empty_cache()
    for arch, depth in ARCHS:
        rows += phase_arch(torch, np, counters, arch, depth)
        stamp(f"phase 8, {arch}")
    bwd_rows = phase_attention_backward(torch)
    stamp("phase 9, backward kernel")
    smollm_peak = phase_train(torch, counters, bwd_rows)
    rows += bwd_rows
    stamp("phase 9")
    rows += phase_audio(torch, np, counters)
    stamp("phase 10")
    rows += phase_vlm(torch, np, counters)
    stamp("phase 11")
    rows += phase_sharded(torch, np, counters, unsharded)
    stamp("phase 12")
    phase_cost(torch, counters, smollm_peak)
    stamp("phase 13")
    rows += phase_trunk(torch, np)
    stamp("phase 14")
    dp_launches = phase_data_parallel(torch, np)
    for r in rows:          # the smollm training rows of phase 9
        if r.get("model") == DP_ARCH and r.get("case") and \
                r["name"] in ("flash_attention", "flash_attention_bwd"):
            r["data_parallel_launches_a_rank"] = {
                k: v[r["name"] == "flash_attention_bwd"]
                for k, v in dp_launches.items()}
    stamp("phase 15")
    ma_launches = phase_model_axis(torch, np)
    for r in rows:          # the smollm training rows of phase 9
        if r.get("model") == DP_ARCH and r.get("case") and \
                r["name"] in ("flash_attention", "flash_attention_bwd"):
            r["model_axis_launches_a_rank"] = {
                f"{label} {arch} (data {D}, model {M})":
                    ma_launches[label][r["name"] == "flash_attention_bwd"]
                for label, arch, _, D, M in MA_RUNS}
    stamp("phase 16")

    for r in rows:
        r.pop("key", None)
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
