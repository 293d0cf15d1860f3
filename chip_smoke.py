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
4. kernel phase at the served shapes: `fused_select` (B=8, V=49152, real
   json mask-store rows) and `flash_attention` ([1,S,15,64] q, [1,S,5,64]
   k/v, bf16, S in 7/32/300/2048) against their plain versions on the
   card, plus an fp32 mask-exactness check of the attention kernel; each
   timed with CUDA events (median of 25) beside its plain version, its
   bound and, for attention, torch's scaled_dot_product_attention;
5. end-to-end: `build_engine("smollm-360m", ("json", "jsonmsg"))` at full
   width (random weights from a seed), 16 requests (half greedy, half
   sampled), 64 new tokens each; every eos-finished output must parse,
   and the kernels' launch counters, zeroed just before the run, must
   show the path went through both kernels; then a devtime run for the
   engine's device forward / mask+sample seconds;
6. decode forward breakdown at full width: host dispatch, synced wall
   and profiler-measured device busy time per step, and the kernels that
   take most of it.

The last lines are the card's name and power limit, the kernels JSON
line, and `{"ok": true, "device": {...}}`.
"""
import json
import os
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


def phase_fused_select(torch, np, engine):
    from repro_torch.core.constrain import GrammarConstraint, MAX_ACCEPT
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.kernels.fused_select.ref import (fused_select_ref,
                                                       gumbel_noise)
    dev = torch.device("cuda")
    g, tab, store_np = engine.bundles["json"]
    store = torch.from_numpy(store_np.packed.view(np.int32)).to(dev)
    B, V = 8, engine.model.cfg.vocab_size
    W = store.shape[1]
    texts = [b"", b"{", b'{"a', b'{"key": ', b"[1, 2", b'"str', b"tru",
             b'{"a": [1, {"b": nu']
    cons_on = [True, True, True, False, True, True, False, True]
    cons = [GrammarConstraint(g, tab, store_np, engine.tok) if c else None
            for c in cons_on]
    rows, eos, _, groups = GrammarConstraint.ci_rows_batch(
        cons, texts, max_accept=MAX_ACCEPT)
    cd = GrammarConstraint.cd_overlay_batch(cons, groups, W)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev).to(dt)
    rows_t = t(rows, torch.int32)
    cd_t = t(cd.view(np.int32), torch.int32)
    eos_t = t(eos, torch.bool)
    cons_t = t(np.array(cons_on), torch.bool)
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
    ms_greedy = cuda_ms(torch, lambda: fused_mask_select(*args))
    plain = cuda_ms(torch, lambda: fused_select_ref(*args, noise=noise))
    n_rows = int((rows >= 0)[np.array(cons_on)].sum())
    nbytes = (B * V * 2 * 2 + B * V * 4 + n_rows * W * 4 + B * W * 4
              + rows.size * 4 + B * (3 + 4 * 3 + 4 + 1))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"fused_select (sample mode) {ms:.4f} ms; greedy mode "
        f"{ms_greedy:.4f} ms; plain {plain:.4f} ms; bound {bound:.6f} ms "
        f"({nbytes} bytes)")
    return {"name": "fused_select", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_select.cu",
            "replaces": "src/repro/kernels/fused_select/kernel.py:96",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def phase_attention(torch, np, main_S):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    dev = torch.device("cuda")
    H, K, Dh = 15, 5, 64
    rng = np.random.default_rng(2)

    # mask exactness in fp32: q = 0 gives equal scores, so each output
    # channel c is the share of VISIBLE keys whose position has bit c set
    for (Sq, Sk, window) in ((7, 7, 0), (300, 300, 0), (300, 300, 100),
                             (2048, 2048, 0), (2048, 2048, 700),
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
    log("flash_attention: fp32 masks exact (causal, window, ragged, "
        "right-aligned Sq < Sk)")

    tol = 2.0 ** -5
    row = None
    for S in sorted({7, 32, 300, 2048, main_S}):
        q = torch.from_numpy(rng.normal(size=(1, S, H, Dh)).astype(
            np.float32)).to(dev).bfloat16()
        k = torch.from_numpy(rng.normal(size=(1, S, K, Dh)).astype(
            np.float32)).to(dev).bfloat16()
        v = torch.from_numpy(rng.normal(size=(1, S, K, Dh)).astype(
            np.float32)).to(dev).bfloat16()
        o_k = attention(q, k, v, causal=True)
        o_r = chunked_attention(q, k, v, causal=True, q_offset=0,
                                chunk=1024)
        err = (o_k.float() - o_r.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"flash_attention S={S}: max abs err "
                                 f"{err} > {tol}")
        ms = cuda_ms(torch, lambda: attention(q, k, v, causal=True))
        plain = cuda_ms(torch, lambda: chunked_attention(
            q, k, v, causal=True, q_offset=0, chunk=1024))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        flops = 2 * 2 * S * S * H * Dh / 2
        nbytes = (2 * S * H * Dh + 2 * S * K * Dh) * 2
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        log(f"flash_attention S={S}: max abs err {err:.3e} (tol {tol}); "
            f"{ms:.4f} ms; plain {plain:.4f} ms; sdpa {lib:.4f} ms; bound "
            f"{bound:.6f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})")
        if S == main_S:
            row = {"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention/"
                               "kernel.py:71",
                   "launches": 0, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "bound_ms": bound,
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes", "library_ms": lib}
    return row


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


def phase_e2e(torch, engine, bundles, counters):
    from repro_torch.core.parser import IncrementalParser
    from repro_torch.serving.engine import Engine
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    states, stats = engine.generate(e2e_requests())
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    n_layers = engine.model.cfg.num_layers
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
    log(f"e2e smollm-360m (json+jsonmsg, 8 slots, 16 requests x 64 new "
        f"tokens): {stats.tokens} tokens in {stats.wall:.3f} s = "
        f"{stats.tokens_per_sec:.2f} tok/s; {stats.decode_steps} decode "
        f"steps; overlap hits {stats.overlap_hits}/"
        f"{stats.overlap_dispatched}; complete {complete}/{len(states)}, "
        f"valid among complete {valid}/{complete}; finish reasons "
        f"{sorted({s.finish_reason for s in states})}")
    log(f"e2e kernel launches: {launches}")
    if launches["fused_mask_select"] < stats.decode_steps:
        raise AssertionError("fused_select launched fewer times than the "
                             "engine stepped")
    if launches["attention"] != stats.requests * n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['attention']} times, want "
                             f"{stats.requests} admissions x {n_layers}")
    # devtime run: the same requests with device spans synchronized
    dev_engine = Engine(engine.model, engine.params, engine.tok, bundles,
                        max_len=engine.max_len, slots=engine.slots,
                        devtime=True, device="cuda")
    _, dstats = dev_engine.generate(e2e_requests())
    log(f"e2e devtime run: {dstats.tokens} tokens in {dstats.wall:.3f} s; "
        f"device_forward_s {dstats.device_forward_s:.4f}; "
        f"device_mask_sample_s {dstats.device_mask_sample_s:.4f}; decode "
        f"steps {dstats.decode_steps}; attribution seconds "
        f"{json.dumps(dstats.attribution['seconds'])}")
    return launches


def phase_forward_breakdown(torch, engine, steps=20):
    """Where one [B, V] decode forward's time goes at full width: the
    host's dispatch time (no sync), the synced wall time, and the device
    busy time summed over the kernels the profiler saw in the window;
    busy / wall is the card's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = engine.slots
    dev = torch.device("cuda")
    caches = engine.model.init_decode_caches(B, engine.max_len)
    tok = torch.full((B,), 7, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 40, dtype=torch.int32, device=dev)
    for _ in range(3):
        engine._decode(caches, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine._decode(caches, tok, pos)
    dispatch = (time.perf_counter() - t0) / steps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine._decode(caches, tok, pos)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern) / steps
    launches = sum(e.count for e in kern) / steps
    busy = (f"device busy {busy_us / 1e3:.4f} ms/step, busy share "
            f"{busy_us / 1e3 / (wall * 1e3):.3f}" if busy_us > 0 else
            "device busy not measured (the profiler saw no device time)")
    log(f"decode forward breakdown (B={B}, {engine.model.cfg.name}, "
        f"{engine.model.cfg.num_layers} layers, {steps} steps): wall "
        f"{wall * 1e3:.4f} ms/step, host dispatch {dispatch * 1e3:.4f} "
        f"ms/step; {busy}; {launches:.0f} kernels/step")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log("  top kernels (ms/step): " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / steps / 1e3:.4f}"
        for e in top))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.fused_select.ops import fused_mask_select
    from repro_torch.launch.serve import build_engine

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

    phase_model_check(torch, np)

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
            phase_attention(torch, np, main_S)]
    launches = phase_e2e(torch, engine, bundles,
                         (fused_mask_select, attention))
    rows[0]["launches"] = launches["fused_mask_select"]
    rows[1]["launches"] = launches["attention"]
    phase_forward_breakdown(torch, engine)

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
