"""Low-overhead metrics registry: counters, gauges, log-spaced histograms.

Design constraints (docs/observability.md):

  * **hot-path cost is one float add** — instruments are plain Python
    objects updated by the step-loop thread; no locks on the update
    path (single-writer per instrument; scrape readers tolerate the
    torn-read window the GIL leaves, which for monotone counters means
    an at-most-one-update-stale value),
  * **scrapes never block the step loop** — `render_prometheus()` and
    `snapshot()` only read; the registry lock guards family *creation*
    (rare) and is never held by a step in flight,
  * **pure stdlib** — this package must not import jax or numpy, which
    is what structurally guarantees telemetry can never introduce a
    device synchronization (asserted by tests/test_obs.py).

Histograms use fixed log-spaced bucket boundaries (`log_buckets`): a
latency distribution spanning 10 µs .. 100 s lands in ~30 buckets with
constant relative resolution, and `quantile()` interpolates inside the
bucket the same way PromQL's `histogram_quantile` does.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Callable, Optional


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """Log-spaced histogram upper bounds: lo * 10^(i/per_decade) up to
    the first bound >= hi. Constant relative width (one bucket every
    10^(1/per_decade)x), so a single layout covers µs-scale phase spans
    and second-scale request latencies alike."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    out = []
    i = 0
    while True:
        b = lo * 10.0 ** (i / per_decade)
        out.append(b)
        if b >= hi:
            return tuple(out)
        i += 1


# default layouts (upper bounds in seconds)
LATENCY_BUCKETS = log_buckets(1e-4, 100.0, per_decade=4)   # 100µs..100s
PHASE_BUCKETS = log_buckets(1e-6, 10.0, per_decade=4)      # 1µs..10s


class Counter:
    """Monotone counter. `fn` (if set) makes it a *derived* counter read
    from a callback at scrape time instead of accumulating here."""
    __slots__ = ("labels", "_value", "fn")

    def __init__(self, labels: Optional[dict] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.labels = labels or {}
        self._value = 0.0
        self.fn = fn

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


class Gauge:
    """Point-in-time value: `set()` it, or give it a `fn` callback
    evaluated at scrape time (how pool/queue gauges observe live state
    without the step loop ever pushing updates)."""
    __slots__ = ("labels", "_value", "fn")

    def __init__(self, labels: Optional[dict] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.labels = labels or {}
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


class Histogram:
    """Fixed-boundary histogram. counts[i] is the number of observations
    <= bounds[i] and > bounds[i-1]; counts[-1] is the +Inf overflow."""
    __slots__ = ("labels", "bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple, labels: Optional[dict] = None):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram bounds must be strictly increasing")
        self.labels = labels or {}
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """PromQL-style histogram_quantile: find the bucket holding the
        q-th observation and interpolate linearly between its edges
        (lower edge 0 for the first bucket; the overflow bucket reports
        its lower edge — the largest bound). Returns nan when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                if i == len(self.bounds):       # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * max(target - cum, 0.0) / c
            cum += c
        return self.bounds[-1]


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: dict[tuple, object] = {}


def _label_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _esc_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc_label(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Get-or-create instrument families keyed by (name, labelset).

    Re-requesting an existing (name, labels) pair returns the SAME
    instrument, so modules can look up shared counters without plumbing
    handles around. A `fn` passed to an existing callback instrument
    rebinds it (fresh allocator after engine re-setup)."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str, labels, factory):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}")
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = factory()
            return child

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None,
                fn: Optional[Callable[[], float]] = None) -> Counter:
        c = self._get(name, "counter", help, labels,
                      lambda: Counter(labels, fn))
        if fn is not None:
            c.fn = fn
        return c

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, "gauge", help, labels,
                      lambda: Gauge(labels, fn))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = LATENCY_BUCKETS,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets, labels))

    # ----------------------------- export -----------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4). Histograms render
        cumulative `_bucket{le=...}` series plus `_sum`/`_count`."""
        out = []
        with self._lock:
            fams = [(f.name, f.kind, f.help, list(f.children.values()))
                    for f in self._families.values()]
        for name, kind, help, children in sorted(fams):
            if help:
                out.append(f"# HELP {name} {help}")
            out.append(f"# TYPE {name} {kind}")
            for ch in children:
                if kind == "histogram":
                    cum = 0
                    counts = list(ch.counts)    # one consistent copy
                    for b, c in zip(ch.bounds, counts):
                        cum += c
                        out.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(ch.labels, {'le': _fmt_num(b)})}"
                            f" {cum}")
                    cum += counts[-1]
                    out.append(f"{name}_bucket"
                               f"{_fmt_labels(ch.labels, {'le': '+Inf'})}"
                               f" {cum}")
                    out.append(f"{name}_sum{_fmt_labels(ch.labels)}"
                               f" {_fmt_num(ch.sum)}")
                    out.append(f"{name}_count{_fmt_labels(ch.labels)}"
                               f" {cum}")
                else:
                    out.append(f"{name}{_fmt_labels(ch.labels)}"
                               f" {_fmt_num(ch.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """Plain-data snapshot for the JSON /stats endpoint."""
        out: dict = {}
        with self._lock:
            fams = [(f.name, f.kind, list(f.children.values()))
                    for f in self._families.values()]
        for name, kind, children in fams:
            series = []
            for ch in children:
                if kind == "histogram":
                    series.append({
                        "labels": dict(ch.labels),
                        "count": ch.count, "sum": ch.sum,
                        "p50": ch.quantile(0.5), "p99": ch.quantile(0.99),
                    })
                else:
                    series.append({"labels": dict(ch.labels),
                                   "value": ch.value})
            out[name] = {"type": kind, "series": series}
        return out
