"""Serving telemetry: metrics registry, phase spans, request lifecycle,
Perfetto trace export. Pure stdlib — importing repro.obs must never pull
in jax or numpy (tests/test_obs.py asserts this), which is the
structural guarantee that telemetry cannot add device synchronization.
"""
from .registry import (Counter, Gauge, Histogram, LATENCY_BUCKETS,
                       MetricsRegistry, PHASE_BUCKETS, log_buckets)
from .lifecycle import LifecycleTracker, NullLifecycle
from .trace import Tracer, DEFAULT_CAPACITY
from .buildinfo import build_info, git_revision, run_meta_str
from .devtime import (DEVICE_TRACK_PREFIX, DeviceTimer, NULL_DEV_SPAN,
                      ProfilerSession)
from .telemetry import (ATTR_FORWARD_PHASES, ATTR_HOST_GRAMMAR_PHASES,
                        ATTR_MASK_PHASES, DISABLED_SPAN_BUDGET_S,
                        ENABLED_SPAN_BUDGET_S, NULL_SPAN, Telemetry)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS", "PHASE_BUCKETS", "log_buckets",
    "LifecycleTracker", "NullLifecycle",
    "Tracer", "DEFAULT_CAPACITY",
    "build_info", "git_revision", "run_meta_str",
    "DeviceTimer", "ProfilerSession", "NULL_DEV_SPAN",
    "DEVICE_TRACK_PREFIX",
    "Telemetry", "NULL_SPAN",
    "ATTR_HOST_GRAMMAR_PHASES", "ATTR_MASK_PHASES",
    "ATTR_FORWARD_PHASES",
    "DISABLED_SPAN_BUDGET_S", "ENABLED_SPAN_BUDGET_S",
]
