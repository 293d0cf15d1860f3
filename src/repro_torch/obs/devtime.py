"""Device-time attribution: span brackets around jitted calls + the
live-profiler session driven by `POST /profile`.

PR 7's host spans measure *dispatch* latency — on an async backend the
`forward` span closes microseconds after the kernel is queued, so the
numbers that decide SynCode's viability (is the fused mask+sample kernel
hiding the grammar work? how big is the forward really?) are invisible.
`DeviceTimer` closes that gap with an explicit, mode-gated exception to
the no-sync contract:

  * **serving mode (default)** — `span()` returns the shared no-op
    `NULL_DEV_SPAN`; nothing syncs, the PR 7 contract holds verbatim
    (tests/test_devtime.py proves the injected sync fn is never called).
  * **bench / profile mode** — `span(fn)` brackets the jitted call and
    `done(out)` hands the dispatched arrays to the *injected* `sync_fn`
    (`jax.block_until_ready`, bound by serving/devbridge.py — this
    package still never imports jax). The bracket then covers dispatch
    **plus device execution**, i.e. a true device interval on the host
    `perf_counter` clock, so device tracks align with host spans in one
    Perfetto timeline with no clock translation.

Each measured interval feeds three surfaces:

  * registry families `repro_device_seconds_total{fn=}`,
    `repro_device_calls_total{fn=}` and the
    `repro_device_duration_seconds{fn=}` histogram,
  * a `device:<fn>` trace track (only while the tracer is capturing),
  * `DeviceTimer.summary()` — per-fn seconds/calls plus, when a static
    cost estimate was attached via `set_cost()` (distributed/hlo_cost
    parsed from the compiled HLO), achieved FLOP/s and bytes/s for
    roofline positioning (benchmarks/roofline.position).

`ProfilerSession` is the `POST /profile start|stop|dump` state machine:
start flips the owning DeviceTimer into sync-on-exit mode, starts trace
capture, and (when devbridge bound one) starts a `jax.profiler` trace
into a temp dir; dump merges the profiler's own device-thread events
into the exported Chrome timeline (`collect_chrome_events`, parsed from
`*.trace.json.gz` with stdlib gzip+json and linearly rebased onto the
host clock window of the capture).

Pure stdlib — no jax/numpy anywhere in repro.obs; every device-touching
capability is injected by the caller that already owns jax.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
import time
from typing import Callable, Optional

from .registry import MetricsRegistry, PHASE_BUCKETS

# Track-name prefix for device intervals in the exported trace: host
# phases keep their PR 7 tracks, device intervals land beside them.
DEVICE_TRACK_PREFIX = "device:"


class _NullDevSpan:
    """Shared no-op span: serving mode. done() drops the arrays."""
    __slots__ = ()
    dur = 0.0
    t0 = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def done(self, out) -> None:
        pass


NULL_DEV_SPAN = _NullDevSpan()


class _DevSpan:
    __slots__ = ("timer", "fn", "t0", "dur", "_out")

    def __init__(self, timer: "DeviceTimer", fn: str):
        self.timer = timer
        self.fn = fn
        self.t0 = 0.0
        self.dur = 0.0
        self._out = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def done(self, out) -> None:
        """Hand the dispatched device arrays to the bracket; __exit__
        blocks on them, so the span covers dispatch + execution."""
        self._out = out

    def __exit__(self, *exc):
        timer = self.timer
        if self._out is not None and exc[0] is None:
            timer.sync_fn(self._out)
            self._out = None
        self.dur = dur = time.perf_counter() - self.t0
        timer._record(self.fn, self.t0, dur)
        return False


class DeviceTimer:
    """Mode-gated device-interval measurement over injected sync.

    `enabled` is False in serving (span() is free and never syncs) and
    True in bench/profile mode. `sync_fn` is injected exactly once by
    serving/devbridge.py; until it is bound, span() no-ops even when
    enabled, so obs stays import-pure and unbound timers are harmless.
    """

    def __init__(self, registry: MetricsRegistry, tracer):
        self.registry = registry
        self.tracer = tracer
        self.enabled = False
        self.sync_fn: Optional[Callable] = None
        self.sync_calls = 0             # asserted by the serving-mode
                                        # never-synced test
        self._fams: dict = {}
        self.last_dur: dict[str, float] = {}
        self.costs: dict[str, dict] = {}

    # ------------------------------ wiring -----------------------------

    def bind(self, sync_fn: Callable) -> None:
        """Inject the device-sync capability (idempotent)."""
        if self.sync_fn is None:
            base = sync_fn

            def counted(out):
                self.sync_calls += 1
                return base(out)
            self.sync_fn = counted

    def set_cost(self, fn: str, flops: float, hbm_bytes: float,
                 wire_bytes: float = 0.0) -> None:
        """Attach a static per-call FLOP/byte estimate for a jitted fn
        (distributed/hlo_cost over its compiled HLO). Exposed as
        scrape-time gauges so /metrics carries the roofline inputs."""
        self.costs[fn] = {"flops": float(flops),
                          "hbm_bytes": float(hbm_bytes),
                          "wire_bytes": float(wire_bytes)}
        g = self.registry.gauge
        g("repro_device_flops_per_call", "static FLOPs per jitted call "
          "(hlo_cost estimate)", {"fn": fn},
          fn=lambda f=fn: self.costs[f]["flops"])
        g("repro_device_hbm_bytes_per_call", "static HBM bytes per "
          "jitted call (hlo_cost estimate)", {"fn": fn},
          fn=lambda f=fn: self.costs[f]["hbm_bytes"])

    # ----------------------------- spanning ----------------------------

    def span(self, fn: str):
        if not self.enabled or self.sync_fn is None:
            return NULL_DEV_SPAN
        return _DevSpan(self, fn)

    def _family(self, fn: str):
        tup = self._fams.get(fn)
        if tup is None:
            reg = self.registry
            tup = self._fams[fn] = (
                reg.counter("repro_device_seconds_total",
                            "synced device interval seconds per jitted fn",
                            {"fn": fn}),
                reg.counter("repro_device_calls_total",
                            "device-timed calls per jitted fn",
                            {"fn": fn}),
                reg.histogram("repro_device_duration_seconds",
                              "per-call device interval by jitted fn",
                              PHASE_BUCKETS, {"fn": fn}),
            )
        return tup

    def _record(self, fn: str, t0: float, dur: float) -> None:
        sec, calls, hist = self._family(fn)
        sec.inc(dur)
        calls.inc()
        hist.observe(dur)
        self.last_dur[fn] = dur
        if self.tracer.active:
            self.tracer.add(DEVICE_TRACK_PREFIX + fn, fn, t0, dur)

    # ------------------------------ views ------------------------------

    def seconds(self, fn: str) -> float:
        tup = self._fams.get(fn)
        return tup[0].value if tup else 0.0

    def calls(self, fn: str) -> int:
        tup = self._fams.get(fn)
        return int(tup[1].value) if tup else 0

    def summary(self) -> dict:
        """Per-fn device accounting + achieved-rate roofline inputs."""
        out = {}
        for fn, (sec, calls, hist) in self._fams.items():
            d = {"calls": int(calls.value), "seconds": sec.value,
                 "p50": hist.quantile(0.5), "p99": hist.quantile(0.99)}
            cost = self.costs.get(fn)
            if cost and sec.value > 0 and calls.value > 0:
                per_call = sec.value / calls.value
                d["flops_per_call"] = cost["flops"]
                d["hbm_bytes_per_call"] = cost["hbm_bytes"]
                d["achieved_flops_per_s"] = cost["flops"] / per_call
                d["achieved_bytes_per_s"] = cost["hbm_bytes"] / per_call
            out[fn] = d
        return out


# --------------------------- profiler session ---------------------------

# Chrome-trace thread names that carry real device/kernel execution in a
# jax.profiler capture (TFRT CPU client executor threads, TPU/GPU device
# streams). Python host-callstack threads are dropped from the merge —
# the host side of the merged view comes from our own phase spans.
_DEVICE_THREAD_MARKERS = ("XLATfrtCpuClient", "/device:", "TPU", "GPU",
                          "Stream", "xla-cpu")
# Executor bookkeeping slices that would drown the kernels they schedule
_NOISE_EVENTS = ("ThreadpoolListener", "ThunkExecutor")


class ProfilerSession:
    """State machine behind `POST /profile start|stop|dump`.

    start():  remember the DeviceTimer's mode, flip it to sync-on-exit,
              start trace capture, and start the backend profiler (when
              devbridge bound one) into a fresh temp dir.
    stop():   stop the backend profiler, restore the DeviceTimer mode.
    dump():   chrome events collected from the backend profiler's
              `*.trace.json.gz`, rebased onto the host-clock window of
              the capture — merged by Tracer.export_chrome(extra=...).

    The host perf_counter timestamps taken at start/stop are the
    alignment anchors: profiler event timestamps are offsets on the
    profiler's own clock, so the earliest captured event is pinned to
    the session's host start time. Visual alignment, not ns-exact —
    the authoritative device intervals are the DeviceTimer spans, which
    are measured on the host clock directly.
    """

    def __init__(self, devtimer: DeviceTimer, tracer):
        self.devtimer = devtimer
        self.tracer = tracer
        self.profiler_start: Optional[Callable] = None  # (log_dir) -> None
        self.profiler_stop: Optional[Callable] = None   # () -> None
        self.active = False
        self.log_dir: Optional[str] = None
        self.host_t0 = 0.0
        self.host_t1 = 0.0
        self._was_enabled = False

    def bind(self, profiler_start: Callable, profiler_stop: Callable):
        if self.profiler_start is None:
            self.profiler_start = profiler_start
            self.profiler_stop = profiler_stop

    # ------------------------------ control ----------------------------

    def start(self, log_dir: Optional[str] = None) -> dict:
        if self.active:
            raise RuntimeError("profile capture already active")
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="repro_profile_")
        self.host_t0 = time.perf_counter()
        self.host_t1 = 0.0
        self._was_enabled = self.devtimer.enabled
        self.devtimer.enabled = True        # sync-on-exit device spans:
        # the documented profile-mode exception to the no-sync contract
        self.tracer.clear()
        self.tracer.start()
        backend = False
        if self.profiler_start is not None:
            try:
                self.profiler_start(self.log_dir)
                backend = True
            except Exception:
                pass        # devtime spans still capture device intervals
        self.active = True
        return {"log_dir": self.log_dir, "backend_profiler": backend}

    def stop(self) -> dict:
        if not self.active:
            raise RuntimeError("no profile capture active")
        self.host_t1 = time.perf_counter()
        if self.profiler_stop is not None:
            try:
                self.profiler_stop()
            except Exception:
                pass
        self.devtimer.enabled = self._was_enabled
        self.tracer.stop()
        self.active = False
        return {"log_dir": self.log_dir,
                "duration_s": self.host_t1 - self.host_t0,
                "buffered_events": len(self.tracer)}

    # ------------------------------- dump ------------------------------

    def collect_chrome_events(self) -> list:
        """Device-thread slices from the backend profiler's Chrome trace
        (`plugins/profile/*/ *.trace.json.gz`), rebased to the host
        clock. Best-effort: an absent or unreadable capture yields []."""
        if not self.log_dir:
            return []
        pats = os.path.join(self.log_dir, "**", "*.trace.json.gz")
        events: list = []
        for fn in sorted(glob.glob(pats, recursive=True)):
            try:
                with gzip.open(fn, "rt") as f:
                    doc = json.load(f)
            except Exception:
                continue
            evs = doc.get("traceEvents", [])
            threads = {}        # (pid, tid) -> thread name
            for e in evs:
                if e.get("ph") == "M" and e.get("name") == "thread_name":
                    threads[(e.get("pid"), e.get("tid"))] = \
                        e.get("args", {}).get("name", "")
            dev_tids = {k for k, v in threads.items()
                        if any(m in v for m in _DEVICE_THREAD_MARKERS)}
            picked = [e for e in evs
                      if e.get("ph") == "X"
                      and (e.get("pid"), e.get("tid")) in dev_tids
                      and not any(e.get("name", "").startswith(n)
                                  for n in _NOISE_EVENTS)]
            if not picked:
                continue
            ts0 = min(e["ts"] for e in picked)
            base_us = self.host_t0 * 1e6
            for e in picked:
                tname = threads[(e.get("pid"), e.get("tid"))]
                events.append({
                    "track": DEVICE_TRACK_PREFIX + "xla "
                             + tname.split("/")[0],
                    "name": e.get("name", "?"),
                    "ts_us": base_us + (e["ts"] - ts0),
                    "dur_us": float(e.get("dur", 0.0)),
                })
        return events

    def state(self) -> dict:
        return {"active": self.active, "log_dir": self.log_dir,
                "backend_bound": self.profiler_start is not None,
                "device_timing": self.devtimer.enabled}
