"""The one place the observability stack touches the device.

`repro_torch.obs` is import-pure (stdlib only), so it cannot hold the
device calls itself. This module binds the two device capabilities into
a Telemetry instance as injected callables:

  * `DeviceTimer.sync_fn` — blocks until the card has run everything
    queued so far (`torch.cuda.synchronize`), so a devtime bracket
    measures dispatch + execution. It is only ever invoked when device
    timing is explicitly enabled (bench / profile mode); in serving mode
    span() returns the shared no-op before the callable is reachable.
  * `ProfilerSession.{start,stop}` — a `torch.profiler` capture with CPU
    and CUDA activities for `POST /profile`. stop() writes its Chrome
    trace gzipped as `<log_dir>/plugins/profile/<run>/<host>.trace.json.gz`,
    the name `ProfilerSession.collect_chrome_events` globs, with each
    CUDA stream's thread renamed from Kineto's `stream <n>` to
    `GPU stream <n>` so the collector files its kernels on device tracks.

On the CPU nothing is bound: torch runs CPU ops synchronously, an
unbound DeviceTimer keeps every devtime span a no-op, and an unbound
ProfilerSession captures the host spans only.
"""
from __future__ import annotations

import gzip
import json
import os
import socket
import tempfile
import time

import torch


def attach(tele, device) -> None:
    """Bind the CUDA sync and profiler into *tele* (Telemetry) for a CUDA
    `device`; a no-op for the CPU. Safe to call repeatedly (first bind
    wins)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    tele.devtime.bind(lambda out: torch.cuda.synchronize(dev))
    prof = _CudaProfiler(dev)
    tele.profiler.bind(prof.start, prof.stop)


class _CudaProfiler:
    """One torch.profiler capture at a time, started and stopped from
    any thread: CUPTI records the card's activity process-wide, so the
    kernels the step-loop thread launches land in the capture."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.log_dir = None

    def start(self, log_dir: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.log_dir = log_dir
        self.prof.start()

    def stop(self) -> None:
        prof, self.prof = self.prof, None
        if prof is None:
            return
        torch.cuda.synchronize(self.device)     # kernels still queued
        prof.stop()
        fd, tmp = tempfile.mkstemp(suffix=".json", dir=self.log_dir)
        os.close(fd)
        try:
            prof.export_chrome_trace(tmp)
            with open(tmp) as f:
                doc = json.load(f)
        finally:
            os.remove(tmp)
        write_trace(doc, self.log_dir)


def write_trace(doc: dict, log_dir: str) -> str:
    """Write a Chrome trace document where `ProfilerSession` looks for
    it, `<log_dir>/plugins/profile/<run>/<host>.trace.json.gz`, with
    Kineto's CUDA stream threads (`stream <n>`) renamed `GPU stream <n>`
    in place, so the device-thread markers of `obs/devtime.py` match
    them. -> the file's path."""
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            args = e.setdefault("args", {})
            name = str(args.get("name", "")).strip()
            if name.lower().startswith("stream"):
                args["name"] = "GPU " + name
    run = time.strftime("%Y_%m_%d_%H_%M_%S")
    out_dir = os.path.join(log_dir, "plugins", "profile", run)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{socket.gethostname()}.trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)
    return path
