"""Telemetry facade: one object the serving stack threads everywhere.

`Telemetry` bundles the metrics registry, the trace ring buffer, and the
request-lifecycle tracker behind a single `span()` API:

    with tele.span("mask_dispatch") as sp:
        ... host-side work already bracketed by perf_counter ...
    st.mask_time += sp.dur

Each span, on exit, adds its duration to the per-phase counter pair
(`repro_step_phase_seconds_total{phase=...}` +
`repro_step_phase_calls_total{phase=...}`), observes the per-phase
histogram, and — only while a trace capture is active — records a
Chrome-trace complete event. The span's measured duration (`sp.dur`) is
what callers feed into the legacy per-slot accounting, so EngineStats
and the registry are two views of the SAME perf_counter bracket and can
never drift apart.

Disabled fast path: `Telemetry(enabled=False).span(...)` returns one
shared `_NullSpan` whose __enter__/__exit__ do nothing and whose `dur`
is 0.0 — no perf_counter call, no dict lookups, no allocation. The
overhead guard in tests/test_obs.py pins this below
`DISABLED_SPAN_BUDGET_S`. Count-style instruments (tokens, mask
computations, overlap outcomes) stay live even when disabled — they are
plain float adds and EngineStats' exact count invariants depend on
them.

Pure stdlib — no jax/numpy anywhere in repro.obs.
"""
from __future__ import annotations

import time
from typing import Optional

from .buildinfo import build_info
from .devtime import NULL_DEV_SPAN, DeviceTimer, ProfilerSession
from .lifecycle import LifecycleTracker, NullLifecycle
from .registry import PHASE_BUCKETS, MetricsRegistry
from .trace import Tracer

# Step-attribution components (XGrammar-style breakdown): how each
# decode step's wall time splits between host grammar work, the two
# kernel families, and device time hidden under host work by the
# overlap engine. Host-phase spans supply the grammar term; devtime
# brackets supply the kernel terms when device timing is on (bench /
# profile mode), falling back to dispatch-span lower bounds in serving.
ATTR_HOST_GRAMMAR_PHASES = ("ci_lookup", "cd_check", "host_oracle",
                            "plan", "feed_build")
# context-split sub-components of host_grammar: the precomputed-row
# lookup vs the context-dependent residue check (docs/observability.md)
ATTR_HOST_GRAMMAR_CI_PHASES = ("ci_lookup",)
ATTR_HOST_GRAMMAR_CD_PHASES = ("cd_check",)
ATTR_MASK_PHASES = ("mask_dispatch", "select_resolve")
ATTR_FORWARD_PHASES = ("forward", "overlap_forward")

# Named overhead budgets (seconds), asserted by tests/test_obs.py.
# DISABLED_SPAN_BUDGET_S: per span() call with telemetry off — must be
# cheap enough to leave in every hot path unconditionally.
# ENABLED_SPAN_BUDGET_S: per span with telemetry on but tracing off —
# two perf_counter calls + a few float adds.
DISABLED_SPAN_BUDGET_S = 2e-6
ENABLED_SPAN_BUDGET_S = 25e-6


class _NullSpan:
    """Shared no-op span: telemetry disabled. dur is always 0.0."""
    __slots__ = ()
    dur = 0.0
    t0 = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tele", "phase", "track", "args", "t0", "dur")

    def __init__(self, tele: "Telemetry", phase: str,
                 track: Optional[str], args: Optional[dict]):
        self.tele = tele
        self.phase = phase
        self.track = track
        self.args = args
        self.t0 = 0.0
        self.dur = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur = dur = time.perf_counter() - self.t0
        tele = self.tele
        sec, calls, hist = tele._phase(self.phase)
        sec.inc(dur)
        calls.inc()
        hist.observe(dur)
        if tele.tracer.active:
            tele.tracer.add(self.track or self.phase, self.phase,
                            self.t0, dur, self.args)
        return False


class Telemetry:
    """enabled=True: full spans/histograms/lifecycle/trace.
    enabled=False: span() is a shared no-op and lifecycle hooks vanish;
    the registry still exists so count-style instruments keep working."""

    def __init__(self, enabled: bool = True,
                 trace_capacity: Optional[int] = None):
        self.enabled = bool(enabled)
        self.registry = MetricsRegistry()
        self.tracer = Tracer(**({} if trace_capacity is None
                                else {"capacity": trace_capacity}))
        self.lifecycle = (LifecycleTracker(self.registry)
                          if self.enabled else NullLifecycle())
        self.t_start = time.perf_counter()
        self._phases: dict = {}
        self.devtime = DeviceTimer(self.registry, self.tracer)
        self.profiler = ProfilerSession(self.devtime, self.tracer)
        if self.enabled:
            self.registry.gauge(
                "repro_uptime_seconds", "seconds since telemetry start",
                fn=lambda: time.perf_counter() - self.t_start)
            self._wire_attribution()
        else:
            # real counter either way so loop.py can add to it blindly
            self.c_overlap_hidden = self.registry.counter(
                "repro_step_attribution_seconds_total",
                "step wall-time attribution by component",
                {"component": "overlap_hidden"})

    def _wire_attribution(self) -> None:
        """Scrape-time attribution counters: derived components read the
        phase/devtime sums live so they can never drift from the spans
        they summarize; overlap_hidden is a real counter fed by the step
        loop (only it knows the dispatch-to-consumption window)."""
        c = self.registry.counter
        help = "step wall-time attribution by component"

        def phase_sum(phases):
            return lambda: sum(self.phase_seconds(p) for p in phases)

        c("repro_step_attribution_seconds_total", help,
          {"component": "host_grammar"},
          fn=phase_sum(ATTR_HOST_GRAMMAR_PHASES))
        c("repro_step_attribution_seconds_total", help,
          {"component": "host_grammar_ci"},
          fn=phase_sum(ATTR_HOST_GRAMMAR_CI_PHASES))
        c("repro_step_attribution_seconds_total", help,
          {"component": "host_grammar_cd"},
          fn=phase_sum(ATTR_HOST_GRAMMAR_CD_PHASES))
        c("repro_step_attribution_seconds_total", help,
          {"component": "mask_sample_kernel"},
          fn=lambda: self._kernel_seconds(("mask_sample",),
                                          ATTR_MASK_PHASES))
        c("repro_step_attribution_seconds_total", help,
          {"component": "forward_kernel"},
          fn=lambda: self._kernel_seconds(ATTR_FORWARD_PHASES,
                                          ATTR_FORWARD_PHASES))
        self.c_overlap_hidden = c(
            "repro_step_attribution_seconds_total", help,
            {"component": "overlap_hidden"})

    def _kernel_seconds(self, dev_fns, host_phases) -> float:
        """Kernel component: synced device intervals when devtime has
        measured this family, else the host dispatch spans (a lower
        bound in serving mode — documented in docs/observability.md)."""
        dev = sum(self.devtime.seconds(f) for f in dev_fns)
        if dev > 0.0:
            return dev
        return sum(self.phase_seconds(p) for p in host_phases)

    # ------------------------------ spans ------------------------------

    def _phase(self, phase: str):
        tup = self._phases.get(phase)
        if tup is None:
            reg = self.registry
            tup = self._phases[phase] = (
                reg.counter("repro_step_phase_seconds_total",
                            "cumulative host seconds per step phase",
                            {"phase": phase}),
                reg.counter("repro_step_phase_calls_total",
                            "span count per step phase", {"phase": phase}),
                reg.histogram("repro_step_phase_duration_seconds",
                              "per-span duration by phase",
                              PHASE_BUCKETS, {"phase": phase}),
            )
        return tup

    def span(self, phase: str, track: Optional[str] = None,
             args: Optional[dict] = None):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, phase, track, args)

    def device_span(self, fn: str):
        """Device-interval bracket around a jitted call. No-op unless
        device timing is on AND a sync capability was injected
        (serving/devbridge.py) — serving mode never syncs."""
        if not self.enabled:
            return NULL_DEV_SPAN
        return self.devtime.span(fn)

    def add_overlap_hidden(self, seconds: float) -> None:
        """Credit device time hidden under host work by the overlap
        engine (called by the step loop on overlap-hit consumption)."""
        if seconds > 0.0:
            self.c_overlap_hidden.inc(seconds)

    def phase_seconds(self, phase: str) -> float:
        """Cumulative seconds recorded for a phase (0.0 if never hit)."""
        if not self.enabled or phase not in self._phases:
            return 0.0
        return self._phases[phase][0].value

    def phase_calls(self, phase: str) -> int:
        if not self.enabled or phase not in self._phases:
            return 0
        return int(self._phases[phase][1].value)

    # -------------------------- count helpers --------------------------
    # Always-on (cheap float adds): exact token/count stats must hold
    # with telemetry disabled, so these never go through the null path.

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None):
        return self.registry.counter(name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None, fn=None):
        return self.registry.gauge(name, help, labels, fn=fn)

    # --------------------------- integrations --------------------------

    def register_kv(self, alloc) -> None:
        """Callback gauges over a PagedAllocator — evaluated at scrape
        time, never pushed from the step loop."""
        reg = self.registry
        g = reg.gauge

        def metric(key):
            return lambda: float(alloc.metrics()[key])

        g("repro_kv_pages_total", "KV pool size in pages",
          fn=metric("pages_total"))
        g("repro_kv_pages_in_use", "KV pages currently referenced",
          fn=metric("pages_in_use"))
        g("repro_kv_pages_free", "KV pages on the free list",
          fn=metric("pages_free"))
        g("repro_kv_pages_cold", "evictable cached pages",
          fn=metric("pages_cold"))
        g("repro_kv_pages_peak", "high-water mark of pages in use",
          fn=metric("peak_in_use"))
        g("repro_kv_prefix_hit_rate", "prefix-cache token hit rate",
          fn=metric("prefix_hit_rate"))
        reg.counter("repro_kv_page_allocs_total", "pages ever allocated",
                    fn=metric("page_allocs"))
        reg.counter("repro_kv_evictions_total", "cold pages evicted",
                    fn=metric("evictions"))
        reg.counter("repro_kv_cow_copies_total", "copy-on-write page copies",
                    fn=metric("cow_copies"))

    # ------------------------------ views ------------------------------

    def uptime(self) -> float:
        return time.perf_counter() - self.t_start

    def attribution(self) -> dict:
        """Per-step wall-time split {host_grammar, mask_sample_kernel,
        forward_kernel, overlap_hidden} + fractions and the measurement
        source for each kernel term ("device" = synced devtime bracket,
        "host-dispatch" = span lower bound, serving mode)."""
        if not self.enabled:
            return {"enabled": False}
        host = sum(self.phase_seconds(p)
                   for p in ATTR_HOST_GRAMMAR_PHASES)
        host_ci = sum(self.phase_seconds(p)
                      for p in ATTR_HOST_GRAMMAR_CI_PHASES)
        host_cd = sum(self.phase_seconds(p)
                      for p in ATTR_HOST_GRAMMAR_CD_PHASES)
        mask = self._kernel_seconds(("mask_sample",), ATTR_MASK_PHASES)
        fwd = self._kernel_seconds(ATTR_FORWARD_PHASES,
                                   ATTR_FORWARD_PHASES)
        hidden = self.c_overlap_hidden.value
        total = host + mask + fwd
        # host_grammar_ci/_cd are SUB-components of host_grammar (they
        # overlap it, not the total): the context-split breakdown of
        # the per-step grammar work
        comp = {"host_grammar": host, "host_grammar_ci": host_ci,
                "host_grammar_cd": host_cd, "mask_sample_kernel": mask,
                "forward_kernel": fwd, "overlap_hidden": hidden}
        dev_mask = self.devtime.seconds("mask_sample") > 0.0
        dev_fwd = any(self.devtime.seconds(f) > 0.0
                      for f in ATTR_FORWARD_PHASES)
        return {
            "enabled": True,
            "seconds": comp,
            "fractions": {k: (v / total if total > 0 else 0.0)
                          for k, v in comp.items()
                          if k in ("host_grammar", "mask_sample_kernel",
                                   "forward_kernel")},
            "source": {
                "mask_sample_kernel": "device" if dev_mask
                                      else "host-dispatch",
                "forward_kernel": "device" if dev_fwd
                                  else "host-dispatch",
            },
            "device_timing": self.devtime.enabled,
        }

    def stats_json(self) -> dict:
        """Everything /stats serves: registry snapshot + lifecycle
        summary + trace state + build identity + attribution."""
        return {
            "enabled": self.enabled,
            "uptime_seconds": self.uptime(),
            "build": build_info(),
            "requests": self.lifecycle.summary(),
            "metrics": self.registry.snapshot(),
            "attribution": self.attribution(),
            "device": {"enabled": self.devtime.enabled,
                       "sync_calls": self.devtime.sync_calls,
                       "functions": self.devtime.summary()},
            "profiler": self.profiler.state(),
            "trace": {"active": self.tracer.active,
                      "buffered_events": len(self.tracer),
                      "dropped_events": self.tracer.dropped},
        }
