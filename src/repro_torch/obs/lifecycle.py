"""Per-request latency lifecycle: enqueue → admit → first token → finish.

One record per in-flight request, keyed by rid, updated from the step
loop thread (admit/token/finish) and the submitter's thread (enqueue).
A small lock guards the record dict only — the derived histograms live
in the shared `MetricsRegistry` and are scraped without ever touching
the step loop:

  * `repro_request_queue_wait_seconds` — enqueue → admission,
  * `repro_request_ttft_seconds`       — enqueue → first committed token
                                         (production TTFT: queue wait
                                         included; sync runs admit
                                         immediately so both ends align),
  * `repro_request_itl_seconds`        — gap between consecutive
                                         committed tokens (jump-forward
                                         commits count: they are real
                                         emitted tokens),
  * `repro_request_duration_seconds`, `repro_request_tokens`,
  * `repro_finished_requests_total{reason=...}`.

When the owning `Telemetry` is disabled every method is a no-op
(`NullLifecycle`). Pure stdlib — no jax/numpy.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .registry import LATENCY_BUCKETS, MetricsRegistry, log_buckets

TOKEN_BUCKETS = log_buckets(1.0, 10000.0, per_decade=3)


class _Life:
    __slots__ = ("enqueue_t", "admit_t", "first_token_t", "last_token_t",
                 "tokens")

    def __init__(self, enqueue_t: float):
        self.enqueue_t = enqueue_t
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.tokens = 0


class LifecycleTracker:
    def __init__(self, registry: MetricsRegistry):
        self.reg = registry
        self._lock = threading.Lock()
        self._inflight: dict[int, _Life] = {}
        self.h_queue = registry.histogram(
            "repro_request_queue_wait_seconds",
            "enqueue -> admission wait", LATENCY_BUCKETS)
        self.h_ttft = registry.histogram(
            "repro_request_ttft_seconds",
            "enqueue -> first committed token", LATENCY_BUCKETS)
        self.h_itl = registry.histogram(
            "repro_request_itl_seconds",
            "gap between consecutive committed tokens", LATENCY_BUCKETS)
        self.h_duration = registry.histogram(
            "repro_request_duration_seconds",
            "enqueue -> finish", LATENCY_BUCKETS)
        self.h_tokens = registry.histogram(
            "repro_request_tokens",
            "committed tokens per finished request", TOKEN_BUCKETS)
        self.c_enqueued = registry.counter(
            "repro_requests_enqueued_total", "requests submitted")
        # the per-reason finished counter children are created lazily in
        # on_finish; pre-register the family so /metrics always has it
        registry.counter("repro_finished_requests_total",
                         "finished requests by reason",
                         {"reason": "eos"})

    # ---- hooks (loop thread, except on_enqueue: submitter thread) ----

    def on_enqueue(self, rid: int) -> None:
        self.c_enqueued.inc()
        with self._lock:
            self._inflight[rid] = _Life(time.perf_counter())

    def on_admit(self, rid: int) -> Optional[_Life]:
        now = time.perf_counter()
        with self._lock:
            rec = self._inflight.get(rid)
            if rec is None:     # sync path: never enqueued — admit IS
                rec = self._inflight[rid] = _Life(now)      # the start
        rec.admit_t = now
        self.h_queue.observe(now - rec.enqueue_t)
        return rec

    def on_token(self, rid: int) -> None:
        now = time.perf_counter()
        with self._lock:
            rec = self._inflight.get(rid)
        if rec is None:
            return
        rec.tokens += 1
        if rec.first_token_t is None:
            rec.first_token_t = now
            self.h_ttft.observe(now - rec.enqueue_t)
        else:
            self.h_itl.observe(now - rec.last_token_t)
        rec.last_token_t = now

    def on_finish(self, rid: int, reason: str) -> Optional[_Life]:
        now = time.perf_counter()
        self.reg.counter("repro_finished_requests_total",
                         "finished requests by reason",
                         {"reason": reason or "unknown"}).inc()
        with self._lock:
            rec = self._inflight.pop(rid, None)
        if rec is None:         # failed before enqueue was recorded
            return None
        self.h_duration.observe(now - rec.enqueue_t)
        self.h_tokens.observe(rec.tokens)
        return rec

    # ------------------------------ views -----------------------------

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def summary(self) -> dict:
        """p50/p99 snapshot for /stats and the bench harness."""
        out = {}
        for key, h in (("queue_wait", self.h_queue), ("ttft", self.h_ttft),
                       ("itl", self.h_itl), ("duration", self.h_duration),
                       ("tokens", self.h_tokens)):
            out[key] = {"count": h.count,
                        "mean": h.sum / h.count if h.count else None,
                        "p50": h.quantile(0.5) if h.count else None,
                        "p99": h.quantile(0.99) if h.count else None}
        return out

    def finish_reasons(self) -> dict:
        """Cumulative finished-request counts by reason (for /healthz)."""
        out = {}
        fam = self.reg.snapshot().get("repro_finished_requests_total")
        for s in (fam or {}).get("series", []):
            if s["value"]:
                out[s["labels"].get("reason", "unknown")] = int(s["value"])
        return out


class NullLifecycle:
    """Telemetry-disabled stand-in: every hook is a no-op."""

    def on_enqueue(self, rid: int) -> None:
        pass

    def on_admit(self, rid: int) -> None:
        return None

    def on_token(self, rid: int) -> None:
        pass

    def on_finish(self, rid: int, reason: str) -> None:
        return None

    def inflight(self) -> int:
        return 0

    def summary(self) -> dict:
        return {}

    def finish_reasons(self) -> dict:
        return {}
