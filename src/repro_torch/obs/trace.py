"""Bounded span ring buffer + Perfetto/Chrome-trace JSON export.

The step loop records phase spans (`Tracer.add`) and per-token instants
(`Tracer.instant`) only while tracing is active (`start()`/`stop()`,
driven by POST /trace on the HTTP server). Spans land in a bounded
`deque` — steady-state tracing can run forever and the dump is always
the most recent `capacity` events, never an unbounded buffer.

`export_chrome()` emits the Chrome trace-event JSON flavour that
ui.perfetto.dev (and chrome://tracing) loads directly: complete events
(`"ph": "X"`) with microsecond timestamps, one *thread track per
span-track name* — loop phases each get their own track, every slot gets
a `slot N` track carrying its requests' lifetime spans and token
instants — named via `thread_name` metadata events.

Timestamps are raw `time.perf_counter()` values captured by the spans
themselves; the exporter rebases them to the earliest event so the trace
starts at t=0. Pure stdlib (no jax/numpy) — recording can never touch
the device.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 65536

# stable tid ordering: known tracks first, in pipeline order; device
# tracks (devtime brackets + merged jax.profiler kernel threads) group
# after the host phases; anything else (slot tracks, custom tracks)
# sorts after them by name
_TRACK_ORDER = ("step", "admit", "plan", "feed_build", "ci_lookup",
                "cd_check", "mask_dispatch", "forward",
                "overlap_forward",
                "select_resolve", "host_oracle", "opportunistic",
                "device:forward", "device:overlap_forward",
                "device:mask_sample")


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.active = False
        self.dropped = 0        # events pushed out of the ring (approx)
        self._seen = 0

    # ------------------------------ control ---------------------------

    def start(self) -> None:
        self.active = True

    def stop(self) -> None:
        self.active = False

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0
        self._seen = 0

    def __len__(self) -> int:
        return len(self._ring)

    # ----------------------------- recording --------------------------
    # Callers are expected to gate on `self.active` before building args
    # dicts; add()/instant() re-check so a stop() between the check and
    # the call just drops the event.

    def add(self, track: str, name: str, t0: float, dur: float,
            args: Optional[dict] = None) -> None:
        if not self.active:
            return
        self._seen += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(("X", track, name, t0, dur, args))

    def instant(self, track: str, name: str, t: float,
                args: Optional[dict] = None) -> None:
        if not self.active:
            return
        self._seen += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(("i", track, name, t, 0.0, args))

    # ------------------------------ export ----------------------------

    def export_chrome(self, extra_events: Optional[list] = None) -> dict:
        """Chrome trace-event JSON: {"traceEvents": [...]} with one
        process ("repro engine") and one named thread per track.

        *extra_events* merges externally captured intervals — the
        jax.profiler device-thread slices collected by
        ProfilerSession.collect_chrome_events() — into the same
        timeline. Each is {"track", "name", "ts_us", "dur_us"} with
        ts_us already on the host perf_counter clock (µs), so both
        sources rebase against one shared origin and the host spans
        line up with the kernel executions they dispatched.
        """
        events = list(self._ring)       # snapshot; recording continues
        extra = list(extra_events or [])
        tracks = sorted({e[1] for e in events} |
                        {e["track"] for e in extra},
                        key=lambda t: (_TRACK_ORDER.index(t)
                                       if t in _TRACK_ORDER
                                       else len(_TRACK_ORDER), t))
        tid = {t: i + 1 for i, t in enumerate(tracks)}
        t_base_s = min((e[3] for e in events), default=None)
        t_base_us = min((e["ts_us"] for e in extra),
                        default=None)
        if t_base_s is not None:
            t_base_us = (t_base_s * 1e6 if t_base_us is None
                         else min(t_base_us, t_base_s * 1e6))
        elif t_base_us is None:
            t_base_us = 0.0
        out = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                "args": {"name": "repro engine"}}]
        for t in tracks:
            out.append({"ph": "M", "pid": 1, "tid": tid[t],
                        "name": "thread_name", "args": {"name": t}})
        for ph, track, name, t0, dur, args in events:
            ev = {"ph": ph, "pid": 1, "tid": tid[track], "name": name,
                  "cat": track, "ts": t0 * 1e6 - t_base_us}
            if ph == "X":
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"           # instant scoped to its thread
            if args:
                ev["args"] = args
            out.append(ev)
        for e in extra:
            out.append({"ph": "X", "pid": 1, "tid": tid[e["track"]],
                        "name": e["name"], "cat": e["track"],
                        "ts": e["ts_us"] - t_base_us,
                        "dur": e["dur_us"]})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "captured_events": self._seen,
                              "merged_device_events": len(extra)}}
