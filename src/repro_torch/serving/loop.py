"""The step-loop core of every serving mode (port of
`repro.serving.loop`).

`StepLoop` owns admission, the cancellation and deadline sweep, finish
bookkeeping and stats; the mode objects plug in the per-step body:

  * `DenseMode` — one [B, V] decode + one fused mask/sample per step,
    with host/device OVERLAP: after the fused mask+sample of step k is
    queued, step k+1's unmasked forward is queued immediately with the
    on-device sampled ids (the token never leaves the device); the host
    then copies the ids back (`.cpu()`, the step's one sync), validates
    step k against the exact oracle and builds step k+1's mask rows
    while the card is already busy. When the host changes the outcome
    (oracle ban, exact fallback, a finished slot, an admission) the
    speculative forward is discarded and the corrected step
    re-dispatched — position-addressed KV caches make the rewrite
    idempotent (`kv_pos <= q_pos` masking hides the stale write), so the
    result is token-for-token identical to the non-overlapped engine.
  * `PagedMode` — the paged feed loop (chunked prefill through bucketed
    [B, S] spans, prefix-share waking, copy-on-write page prepare)
    feeding the same selection machinery.
  * `SpecMode` — grammar-aware speculation (jump-forward + draft spans)
    over dense or paged caches.

The loop is also where every request-lifecycle feature lives once for
all modes: per-token emit callbacks (streaming), per-request
cancellation (frees the slot and its KV pages at the next step),
deadlines (a distinct `deadline` finish reason) and graceful drain.
`AsyncEngine` (serving/async_engine.py) runs one persistent StepLoop on
a background thread against a live `QueueSource`; the synchronous
`Engine.generate*` entry points run the same loop to completion over a
`ListSource`, which keeps the two token-for-token identical by
construction.

Host arrays that are changed in place after a dispatch (`feed_pos`, the
token and mask buffers, page tables, the decode configs that `admit()`
rewrites) ship to the device as private copies at every dispatch site.

Sharded engines (`Engine(mesh=...)`): every rank runs this loop, and the
step bodies are deterministic given the selected ids, which every rank
shares. What other threads or the wall clock decide -- the requests
popped from the source, cancellations, deadline expiries, hot grammar
loads from the control queue, whether the source has closed -- rank 0
decides: each loop iteration it logs every such outcome (`_LiveIO`) and
broadcasts the log once; the other ranks replay it (`_ReplayIO`) and
never read their own source or clock for it. A follower whose replay
asks for something rank 0 did not log has diverged and raises. Device
work of the host decisions (an admission's prefill, whose embedding
lookup is a collective) waits until after the broadcast
(`StepLoop.deferred`), so every rank calls the collectives in one
order.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..core.constrain import MAX_ACCEPT
from ..core.decoding import DecodeConfig
from ..distributed import cost
from ..distributed.api import broadcast_control
from ..obs import Telemetry
from ..spec.scheduler import SlotPhase, SlotPlan, SpecConfig, SpecScheduler
from .devbridge import attach as _attach_devbridge
from .kvpool import PoolExhausted


# --------------------------- request sources ---------------------------

class ListSource:
    """Fixed batch of requests (the synchronous generate() path)."""

    def __init__(self, requests):
        self._q = deque(requests)

    def __len__(self):
        return len(self._q)

    def try_pop(self):
        return self._q.popleft() if self._q else None

    def push_front(self, req) -> None:
        """Return a popped request that the admission gate refused."""
        self._q.appendleft(req)

    @property
    def closed(self) -> bool:
        return True                     # nothing more is ever coming

    def wait_for_work(self, timeout: float) -> bool:
        return False


class QueueSource:
    """Thread-safe live admission queue for the persistent async loop.

    submit() may be called from any thread; the step-loop thread pops.
    close() stops admission (drain): the loop exits once the queue and
    the slot pool empty out.
    """

    def __init__(self):
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def __len__(self):
        with self._cv:
            return len(self._q)

    def submit(self, req) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("source closed (engine draining)")
            self._q.append(req)
            self._cv.notify_all()

    def try_pop(self):
        """Pop the head or None: the loop thread's only read primitive (a
        check-then-pop would race with `remove()` from the asyncio
        thread)."""
        with self._cv:
            return self._q.popleft() if self._q else None

    def push_front(self, req) -> None:
        """Return a popped request that the admission gate refused; it
        stays next in line."""
        with self._cv:
            self._q.appendleft(req)

    def remove(self, req) -> bool:
        """Withdraw a queued request (cancel before admission)."""
        with self._cv:
            try:
                self._q.remove(req)
                return True
            except ValueError:
                return False

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def wait_for_work(self, timeout: float) -> bool:
        """Block until work arrives or the source closes. True = work."""
        with self._cv:
            if self._q:
                return True
            if self._closed:
                return False
            self._cv.wait(timeout)
            return bool(self._q)


# ------------------- what rank 0 decides, and its replay -------------------

class _LiveIO:
    """The loop's outside inputs read for real: the source, thread-set
    flags, the clock. With `record`, every outcome is logged in order for
    the follower ranks."""
    replay = False

    def __init__(self, source, record: bool):
        self.source = source
        self.log = [] if record else None

    def take(self, kind: str, fn):
        v = fn()
        if self.log is not None:
            self.log.append((kind, v))
        return v

    def pop(self):
        return self.take("pop", self.source.try_pop)

    def push_front(self, req) -> None:
        self.source.push_front(req)

    def closed(self) -> bool:
        return self.take("closed", lambda: self.source.closed)


class _ReplayIO:
    """A follower rank's inputs: rank 0's log of this iteration, replayed
    in order."""
    replay = True
    log = None

    def __init__(self, log):
        self._log = deque(log)

    def take(self, kind: str, fn=None):
        if not self._log:
            raise RuntimeError(f"step loop diverged from rank 0: it logged "
                               f"no {kind!r} here")
        k, v = self._log.popleft()
        if k != kind:
            raise RuntimeError(f"step loop diverged from rank 0: it logged "
                               f"{k!r} where this rank reads {kind!r}")
        return v

    def pop(self):
        return self.take("pop")

    def push_front(self, req) -> None:
        pass

    def closed(self) -> bool:
        return self.take("closed")

    def finish(self) -> None:
        if self._log:
            raise RuntimeError(f"step loop diverged from rank 0: "
                               f"{len(self._log)} logged inputs unread")


# ------------------------------ the loop -------------------------------

class StepLoop:
    """Shared slot-pool loop: admission, cancellation/deadline sweep,
    per-mode step body, finish bookkeeping, stats. One instance per
    synchronous generate() call; ONE persistent instance per
    AsyncEngine."""

    def __init__(self, engine, mode, source, verbose: bool = False,
                 on_token: Optional[Callable] = None,
                 on_admit: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None,
                 keep_states: bool = True,
                 telemetry: Optional[Telemetry] = None):
        self.eng = engine
        self.mode = mode
        self.source = source
        self.verbose = verbose
        self.on_token = on_token
        self.on_admit = on_admit
        self.on_finish = on_finish
        self.keep_states = keep_states
        # one Telemetry per loop: a sync generate() gets a fresh per-run
        # instance; AsyncEngine passes its persistent one so /metrics is
        # cumulative
        self.tele = telemetry if telemetry is not None else \
            Telemetry(enabled=engine.telemetry_enabled)
        # bind the device sync (CUDA only); device timing itself stays
        # OFF unless the engine was built for bench/profile mode
        _attach_devbridge(self.tele, engine.device)
        if engine.devtime_enabled:
            self.tele.devtime.enabled = True

        B = engine.slots
        self.B = B
        self.slot_state = [None] * B
        self.feed_pos = np.zeros(B, np.int32)
        self.waiting = np.zeros(B, bool)
        self.seeds = np.zeros(B, np.uint32)
        self.greedy = np.ones(B, bool)
        self.temp = np.ones(B, np.float32)
        self.top_k = np.zeros(B, np.int32)
        self.top_p = np.ones(B, np.float32)
        self.ids_cache: dict[int, list] = {}
        self.stall = 0
        # device work of this iteration's admissions (dense prefills),
        # run once its host decisions are made and, sharded, broadcast
        self.deferred: list = []

        # control queue: closures posted from other threads, run on the
        # loop thread between steps (hot grammar registration: the
        # engine's device store must never change under a step that
        # reads it), each with the engine call the follower ranks replay
        self._controls: deque = deque()
        self._ctl_lock = threading.Lock()

        self.t0 = time.perf_counter()
        self.all_states: list = []
        reg = self.tele.registry
        self.c_requests = reg.counter(
            "repro_requests_total", "requests admitted (incl. failed)")
        self.c_tokens = reg.counter(
            "repro_tokens_total", "tokens committed")
        self.c_steps = reg.counter(
            "repro_slot_steps_total",
            "per-slot step increments (sum of st.steps)")
        self.c_decode_steps = reg.counter(
            "repro_decode_steps_total", "device decode/span calls")
        self.c_mask_comp = reg.counter(
            "repro_mask_computations_total", "grammar mask rows computed")
        self.c_opp_hits = reg.counter(
            "repro_opportunistic_hits_total",
            "unconstrained proposals accepted by the oracle")
        self.c_jump = reg.counter(
            "repro_jump_tokens_total",
            "grammar-forced tokens committed with no model call")
        self.c_draft_prop = reg.counter(
            "repro_draft_tokens_total", "speculative draft tokens",
            {"kind": "proposed"})
        self.c_draft_acc = reg.counter(
            "repro_draft_tokens_total", "speculative draft tokens",
            {"kind": "accepted"})
        self.c_overlap_disp = reg.counter(
            "repro_overlap_forwards_total", "overlap gate outcomes",
            {"outcome": "dispatched"})
        self.c_overlap_hit = reg.counter(
            "repro_overlap_forwards_total", "overlap gate outcomes",
            {"outcome": "hit"})
        self.c_overlap_probe = reg.counter(
            "repro_overlap_forwards_total", "overlap gate outcomes",
            {"outcome": "probe"})
        if self.tele.enabled:
            reg.gauge("repro_queue_depth", "requests waiting for a slot",
                      fn=lambda: float(len(self.source)))
            reg.gauge("repro_slots_active", "slots currently serving",
                      fn=lambda: float(len(self.active())))
            reg.gauge("repro_slots_total", "decode pool width",
                      fn=lambda: float(self.B))

        mode.setup(self)

    # ------------------------- slot lifecycle -------------------------

    def active(self) -> list[int]:
        return [b for b in range(self.B) if self.slot_state[b] is not None]

    def admit(self, b: int, req) -> None:
        with self.tele.span("admit") as sp:
            st = self.mode.admit(self, b, req)
            self.slot_state[b] = st
            self.seeds[b] = np.uint32(req.seed & 0xFFFFFFFF)
            g, t, k, p = DecodeConfig.batch_arrays([req.decode])
            self.greedy[b], self.temp[b] = g[0], t[0]
            self.top_k[b], self.top_p[b] = k[0], p[0]
            if req.deadline is not None:
                st.deadline_at = time.perf_counter() + req.deadline
        self.c_requests.inc()
        st.admit_t = sp.t0 if self.tele.enabled else time.perf_counter()
        self.tele.lifecycle.on_admit(req.rid)
        if self.keep_states:
            self.all_states.append(st)
        if self.on_admit:
            self.on_admit(st)

    def finish(self, b: int) -> None:
        st = self.slot_state[b]
        self.mode.release(self, b, st)
        self.slot_state[b] = None
        self.waiting[b] = False
        self.feed_pos[b] = 0
        if self.verbose:
            print(f"[req {st.req.rid}] {st.finish_reason}: "
                  f"{st.generated[:70]!r}")
        self.tele.lifecycle.on_finish(st.req.rid, st.finish_reason)
        tr = self.tele.tracer
        if tr.active:
            now = time.perf_counter()
            t0 = getattr(st, "admit_t", None) or now
            tr.add(f"slot {b}", f"req {st.req.rid}", t0, now - t0,
                   {"reason": st.finish_reason, "tokens": st.steps})
        if self.on_finish:
            self.on_finish(st)

    def commit(self, st, token: int) -> None:
        """THE commit point for every mode (jump-forward commits too):
        engine bookkeeping, telemetry and the streaming emit callback."""
        self.eng._commit(st, token)
        self.c_tokens.inc()
        self.tele.lifecycle.on_token(st.req.rid)
        tr = self.tele.tracer
        if tr.active:
            tr.instant(f"slot {st.slot}", "token", time.perf_counter(),
                       {"id": int(token)})
        if self.on_token:
            self.on_token(st, token)

    def note_steps(self, n: int) -> None:
        """Mirror per-slot st.steps increments into a loop-level total,
        so async stats (keep_states=False) count tokens as the sync
        path's sum(st.steps) does."""
        self.c_steps.inc(n)

    def fail_request(self, req, reason: str) -> None:
        """Finish a request that never got a slot (a prompt the KV pool
        can never fit, on the persistent path)."""
        from .engine import RequestState
        self.ids_cache.pop(req.rid, None)
        st = RequestState(req=req)
        st.done = True
        st.finish_reason = reason
        self.c_requests.inc()
        self.tele.lifecycle.on_finish(req.rid, reason)
        if self.keep_states:
            self.all_states.append(st)
        if self.on_admit:
            self.on_admit(st)
        if self.on_finish:
            self.on_finish(st)

    # --------------------------- control queue ------------------------

    def post_control(self, fn: Callable[[], None],
                     replicate: Optional[tuple] = None) -> None:
        """Run fn() on the loop thread before the next step (thread-safe,
        FIFO). fn does its own error handling: an exception escaping a
        control kills the loop like any other step error. `replicate`
        (method name, args) is the engine call the other ranks of a
        sharded engine make in its place; a multi-rank engine refuses a
        control without one."""
        mesh = self.eng.mesh
        if replicate is None and mesh is not None and mesh.size > 1:
            raise ValueError("a sharded engine's control needs the engine "
                             "call its other ranks replay (replicate=)")
        with self._ctl_lock:
            self._controls.append((fn, replicate))

    def _drain_controls(self, io) -> None:
        items = []
        if not io.replay:
            with self._ctl_lock:
                items = list(self._controls)
                self._controls.clear()
        calls = io.take("controls", lambda: [r for _, r in items])
        if io.replay:
            for name, args in calls:
                getattr(self.eng, name)(*args)
            return
        for fn, _ in items:
            fn()

    # --------------------- cancellation / deadlines -------------------

    def _sweep(self, io) -> None:
        now = None

        def expired(st):
            nonlocal now
            now = time.perf_counter() if now is None else now
            return now >= st.deadline_at

        for b in self.active():
            st = self.slot_state[b]
            if io.take("cancelled", lambda: st.cancelled):
                st.done = True
                st.finish_reason = "cancelled"
                self.finish(b)
                continue
            if st.deadline_at is not None and \
                    io.take("expired", lambda: expired(st)):
                st.done = True
                st.finish_reason = "deadline"
                self.finish(b)

    # ------------------------------ run -------------------------------

    def run(self, idle_wait: float = 0.1):
        """Drive the loop until the source is closed AND drained AND the
        pool is idle. For a ListSource this is the synchronous generate
        path; for a QueueSource it is the persistent serving loop (idles
        between requests, exits on close()). On a follower rank of a
        sharded engine the source is never read: rank 0's log is."""
        dev = self.eng.device
        if dev.type == "cuda" and dev.index is not None:
            # the thread's current device (an AsyncEngine loop thread's
            # is card 0): the kernels launch on the engine's card's streams
            torch.cuda.set_device(dev)
        while True:
            io = self._open_round()
            try:
                action = self._round(io)
            except BaseException:
                if io.log is not None:      # the followers replay up to
                    broadcast_control(io.log, self.eng.mesh)   # the error
                raise
            self._close_round(io)
            work, self.deferred = self.deferred, []
            for fn in work:
                fn()
            if action == "break":
                break
            if action == "idle":
                if not io.replay:
                    self.source.wait_for_work(idle_wait)
                continue
            if action == "step":
                self.mode.step(self, self.active())
        return (self.all_states, self.stats()) if self.keep_states \
            else (None, self.stats())

    def _open_round(self):
        mesh = self.eng.mesh
        if mesh is None or mesh.size == 1:
            return _LiveIO(self.source, record=False)
        if mesh.rank == 0:
            return _LiveIO(self.source, record=True)
        return _ReplayIO(broadcast_control(None, mesh))

    def _close_round(self, io) -> None:
        """Rank 0 broadcasts the iteration's log; a follower checks that
        it read all of it."""
        if io.log is not None:
            broadcast_control(io.log, self.eng.mesh)
        elif io.replay:
            io.finish()

    def _round(self, io) -> str:
        """One iteration's host decisions -> "step", "idle", "again" or
        "break"."""
        self._drain_controls(io)
        self._sweep(io)
        for b in range(self.B):
            if self.slot_state[b] is not None:
                continue
            # pop-then-gate: cancel withdrawal runs on another thread, so
            # the queue can empty between a check and a pop
            req = io.pop()
            if req is None:
                break
            if not self.mode.can_admit_req(self, req):
                io.push_front(req)
                break
            self.admit(b, req)
        if self.active():
            return "step"
        req = io.pop()
        if req is not None:
            if self.mode.can_admit_req(self, req):
                # admittable after all (submitted after the admission
                # sweep): the next iteration takes it
                io.push_front(req)
                return "again"
            # no slot can ever take this request (the paged pool is too
            # small for its prompt): a closed source raises, a live one
            # fails the request and serves on
            if io.closed():
                raise PoolExhausted(
                    "KV pool too small for the next request's prompt")
            self.fail_request(req, "kv_oom")
            return "again"
        if io.closed():
            return "break"
        # idle: the queue is empty, so memoized prompt ids belong to
        # withdrawn or failed requests (rids are never reused)
        self.ids_cache.clear()
        self.mode.on_idle(self)
        return "idle"

    # ------------------------------ stats ------------------------------

    def stats(self):
        """EngineStats as a view over the telemetry registry."""
        from .engine import EngineStats
        tele = self.tele
        s = EngineStats(
            requests=int(self.c_requests.value),
            tokens=sum(st.steps for st in self.all_states)
            if self.keep_states else int(self.c_steps.value),
            wall=time.perf_counter() - self.t0,
            mask_time=(tele.phase_seconds("ci_lookup")
                       + tele.phase_seconds("cd_check")
                       + tele.phase_seconds("mask_dispatch")
                       + tele.phase_seconds("select_resolve")),
            mask_computations=int(self.c_mask_comp.value),
            opportunistic_hits=int(self.c_opp_hits.value),
            decode_steps=int(self.c_decode_steps.value),
            batch_slots=self.B,
            jump_tokens=int(self.c_jump.value),
            draft_proposed=int(self.c_draft_prop.value),
            draft_accepted=int(self.c_draft_acc.value),
            plan_time=tele.phase_seconds("plan"),
            overlap_dispatched=int(self.c_overlap_disp.value),
            overlap_hits=int(self.c_overlap_hit.value),
            device_forward_s=(tele.devtime.seconds("forward")
                              + tele.devtime.seconds("overlap_forward")),
            device_mask_sample_s=tele.devtime.seconds("mask_sample"),
            overlap_hidden_s=tele.c_overlap_hidden.value,
            attribution=tele.attribution() if tele.enabled else None,
            mesh_devices=self.eng.mesh.size if self.eng.mesh else 1,
        )
        return self.mode.stats_extra(self, s)

    def add_select_ctr(self, ctr: dict) -> None:
        self.c_mask_comp.inc(ctr["mask_computations"])
        self.c_opp_hits.inc(ctr["opportunistic_hits"])


# ------------------------------- modes ---------------------------------

class _ModeBase:
    def can_admit_req(self, loop, req) -> bool:
        return True

    def on_idle(self, loop) -> None:
        pass

    def release(self, loop, b, st) -> None:
        pass

    def stats_extra(self, loop, stats):
        return stats


class DenseMode(_ModeBase):
    """Continuous batching over dense per-slot decode caches, with the
    adaptive host/device overlap gate (see module docstring): a
    speculative forward only pays off when the host usually validates
    the whole batch unchanged, so the mode tracks a windowed hit rate,
    stops speculating below `OVERLAP_MIN_RATE` and re-probes every
    `OVERLAP_PROBE` steps. Token streams are identical either way."""

    OVERLAP_MIN_RATE = 0.5      # windowed hits/dispatches to keep going
    OVERLAP_WINDOW = 64         # halve counters at this many dispatches
    OVERLAP_PROBE = 16          # gated-off steps between re-probes
    OVERLAP_WARMUP = 8          # unconditional dispatches before gating

    def __init__(self, engine, overlap: Optional[bool] = None):
        self.eng = engine
        # recurrent or side-input state cannot absorb a discarded
        # speculative forward (no position-addressed rewrite)
        self.overlap = (engine.overlap if overlap is None else overlap) \
            and engine.model.supports_span_decode
        self.caches = None
        self.cur_tok = None
        self.pending_logits = None      # speculative forward for the
                                        # NEXT step, still on the device
        self._spec_disp_t = None
        self._disp_w = 0
        self._hit_w = 0
        self._gated_steps = 0

    def setup(self, loop):
        eng = self.eng
        self.caches = eng.model.init_decode_caches(eng.slots, eng.max_len)
        self.cur_tok = np.zeros(eng.slots, np.int32)

    def admit(self, loop, b, req):
        st = self.eng._admit_common(req, b, self.caches, defer=loop.deferred)
        self.cur_tok[b] = st.token_ids[-1]
        loop.feed_pos[b] = st.pos - 1
        # the inserted prefill caches invalidate any in-flight
        # speculative forward for this slot
        self.pending_logits = None
        self._spec_disp_t = None
        return st

    def step(self, loop, active):
        eng = self.eng
        tele = loop.tele
        if self.pending_logits is not None:
            logits = self.pending_logits       # dispatched last step
            self.pending_logits = None
            loop.c_overlap_hit.inc()
            self._hit_w += 1
            if self._spec_disp_t is not None:
                window = time.perf_counter() - self._spec_disp_t
                dev = tele.devtime.last_dur.get("forward", 0.0)
                tele.add_overlap_hidden(min(window, dev) if dev > 0.0
                                        else window)
                self._spec_disp_t = None
        else:
            # cur_tok/feed_pos are mutated in place after the resolve
            # sync: they ship as private copies
            with tele.device_span("forward") as dv:
                with tele.span("forward"):
                    tok_dev = eng._h2d(self.cur_tok.copy())  # reprolint: dispatch
                    pos_dev = eng._h2d(loop.feed_pos.copy())  # reprolint: dispatch
                    logits = eng._decode(self.caches, tok_dev, pos_dev)
                dv.done(logits)
            eng._note_cost(tele, "forward", lambda: cost.decode_step(
                eng.model.cfg, len(self.cur_tok), eng.max_len,
                vocab=eng._vocab_width()))
        loop.c_decode_steps.inc()
        for b in active:
            loop.slot_state[b].steps += 1
        loop.note_steps(len(active))

        ctx = eng._select_dispatch(
            logits, loop.slot_state, set(active), loop.seeds,
            loop.greedy, loop.temp, loop.top_k, loop.top_p, obs=tele)

        # ---- overlap: queue step k+1's forward with the on-device
        # sampled ids BEFORE copying step k back to the host ----------
        spec_logits = None
        if self.overlap and not eng.opportunistic and \
                ctx.ids is not None and self._speculate_now(loop):
            with tele.span("overlap_forward"):
                spec_logits = eng._decode(
                    self.caches, ctx.ids,
                    eng._h2d(loop.feed_pos + 1))  # reprolint: dispatch
            self._spec_disp_t = time.perf_counter()
            loop.c_overlap_disp.inc()
            self._disp_w += 1
            if self._disp_w >= self.OVERLAP_WINDOW:
                self._disp_w //= 2
                self._hit_w //= 2

        committed, ctr = eng._select_resolve(
            ctx, loop.slot_state, loop.seeds, loop.greedy, loop.temp,
            loop.top_k, loop.top_p, obs=tele)
        loop.add_select_ctr(ctr)

        for b, t in committed.items():
            st = loop.slot_state[b]
            loop.commit(st, t)
            self.cur_tok[b] = t
            loop.feed_pos[b] = st.pos - 1
        for b in active:
            st = loop.slot_state[b]
            if st is not None and st.done:
                loop.finish(b)

        # speculation valid iff the host changed NOTHING the device
        # didn't already know: every active slot committed its first-
        # round device id
        if spec_logits is not None and ctx.clean and \
                set(committed) == set(active):
            self.pending_logits = spec_logits
        else:
            self._spec_disp_t = None

    def _speculate_now(self, loop) -> bool:
        if self._disp_w < self.OVERLAP_WARMUP:
            return True
        if self._hit_w / self._disp_w >= self.OVERLAP_MIN_RATE:
            return True
        self._gated_steps += 1
        if self._gated_steps >= self.OVERLAP_PROBE:
            self._gated_steps = 0
            loop.c_overlap_probe.inc()
            return True
        return False


class PagedMode(_ModeBase):
    """Paged-KV continuous batching: chunked prefill drained through
    bucketed [B, S] span feeds, prefix-share waking, copy-on-write page
    prepare — then the same selection machinery as DenseMode."""

    def __init__(self, engine):
        self.eng = engine
        self.alloc = None
        self.caches = None

    def setup(self, loop):
        self.alloc, self.caches = self.eng._paged_setup(self.eng.slots)
        if loop.tele.enabled:
            loop.tele.register_kv(self.alloc)

    def can_admit_req(self, loop, req) -> bool:
        return self.eng._paged_can_admit(self.alloc, req, loop.ids_cache)

    def admit(self, loop, b, req):
        st, plan = self.eng._admit_paged(
            req, b, self.alloc, loop.ids_cache.pop(req.rid, None))
        loop.feed_pos[b] = plan.feed_from
        loop.waiting[b] = True      # shared pages may still be filling
        if not self.eng._paged_wake(self.alloc, b, st, loop.feed_pos,
                                    loop.waiting):
            st.phase = SlotPhase.PREFILLING.value
        return st

    def release(self, loop, b, st) -> None:
        st.kv_pages = len(self.alloc.tables[b])
        self.alloc.release(b)

    def stats_extra(self, loop, stats):
        return self.eng._kv_stats(stats, self.alloc)

    def step(self, loop, active):
        eng = self.eng
        alloc, B = self.alloc, loop.B

        # ---- wake waiters whose shared prefix finished filling ------
        live = [b for b in active
                if eng._paged_wake(alloc, b, loop.slot_state[b],
                                   loop.feed_pos, loop.waiting)]
        if not live:
            loop.stall += 1
            if loop.stall > 4 * B + 16:
                raise RuntimeError("paged scheduler stalled")
            return
        loop.stall = 0

        # ---- ONE [B, S] paged span feed for the whole pool ----------
        with loop.tele.span("feed_build"):
            pend = {b: loop.slot_state[b].pos - int(loop.feed_pos[b])
                    for b in live}
            S = eng._feed_width(list(pend.values()))
            tokens = np.zeros((B, S), np.int32)
            fmask = np.zeros((B, S), bool)
            sel = np.full(B, -1, np.int32)
            feed_n: dict[int, int] = {}
            for b in live:
                st = loop.slot_state[b]
                fs = int(loop.feed_pos[b])
                k = min(pend[b], S)
                if eng._prepare_feed(alloc, self.caches, b, st, fs,
                                     k) is None:
                    continue                 # kv_oom: no feed
                if pend[b] <= S:
                    sel[b] = k - 1           # selection this step
                tokens[b, :k] = st.token_ids[fs:fs + k]
                for i in range(k):
                    fmask[b, i] = (fs + i) >= st.write_from
                feed_n[b] = k
        live = [b for b in live if b in feed_n]
        if live:
            # feed_pos is advanced in place right after this dispatch
            # (prefill-drain steps never sync): every host buffer ships
            # as a private copy
            with loop.tele.device_span("forward") as dv:
                with loop.tele.span("forward"):
                    table = alloc.table_rows(np)
                    # reprolint: dispatch
                    logits = eng.span_feed_paged(
                        self.caches, eng._h2d(tokens.copy()),
                        eng._h2d(loop.feed_pos.copy()),
                        eng._h2d(fmask.copy()), eng._h2d(table),
                        eng._h2d(sel.copy()))
                dv.done(logits)
            eng._note_cost(loop.tele, "forward", lambda: cost.paged_feed(
                eng.model.cfg, B, S, table.shape[1], eng.page_size,
                vocab=eng._vocab_width()))
            loop.c_decode_steps.inc()
            for b in live:
                st = loop.slot_state[b]
                alloc.note_fill(b, min(int(loop.feed_pos[b]) + feed_n[b],
                                       st.prompt_len))
                if sel[b] < 0:               # chunked prefill drain
                    loop.feed_pos[b] += feed_n[b]
                    st.phase = SlotPhase.PREFILLING.value
            selecting = [b for b in live if sel[b] >= 0]
            for b in selecting:
                loop.slot_state[b].steps += 1
                loop.slot_state[b].phase = SlotPhase.DECODING.value
            loop.note_steps(len(selecting))
            if selecting:
                committed, ctr = eng._select_tokens(
                    logits, loop.slot_state, set(selecting), loop.seeds,
                    loop.greedy, loop.temp, loop.top_k, loop.top_p,
                    obs=loop.tele)
                loop.add_select_ctr(ctr)
                for b, t in committed.items():
                    st = loop.slot_state[b]
                    loop.commit(st, t)
                    loop.feed_pos[b] = st.pos - 1
        for b in active:
            st = loop.slot_state[b]
            if st is not None and st.done:
                loop.finish(b)


class SpecMode(_ModeBase):
    """Grammar-aware speculation (jump-forward + draft-verify spans)
    over dense or paged caches — generate_speculative's step body."""

    def __init__(self, engine, spec: Optional[SpecConfig] = None):
        self.eng = engine
        self.spec = spec or SpecConfig()
        self.paged = engine.paged
        self.sched = None
        self.alloc = None
        self.caches = None

    def setup(self, loop):
        eng = self.eng
        if not eng.model.supports_span_decode:
            raise ValueError(
                "speculative decoding needs position-addressed decode "
                "caches (attn/moe layer kinds); this arch has recurrent "
                "or side-input state")
        self.sched = SpecScheduler(
            self.spec, eng.tok,
            telemetry=loop.tele if loop.tele.enabled else None)
        if self.paged:
            self.alloc, self.caches = eng._paged_setup(eng.slots)
            if loop.tele.enabled:
                loop.tele.register_kv(self.alloc)
        else:
            self.caches = eng.model.init_decode_caches(eng.slots,
                                                       eng.max_len)

    def can_admit_req(self, loop, req) -> bool:
        if not self.paged:
            return True
        return self.eng._paged_can_admit(self.alloc, req, loop.ids_cache)

    def admit(self, loop, b, req):
        eng = self.eng
        if self.paged:
            st, plan = eng._admit_paged(
                req, b, self.alloc, loop.ids_cache.pop(req.rid, None))
            loop.feed_pos[b] = plan.feed_from
            loop.waiting[b] = True
            if not eng._paged_wake(self.alloc, b, st, loop.feed_pos,
                                   loop.waiting):
                st.phase = SlotPhase.PREFILLING.value
        else:
            st = eng._admit_common(req, b, self.caches,
                                   defer=loop.deferred)
            loop.feed_pos[b] = st.pos - 1
        self.sched.on_admit(st)
        return st

    def release(self, loop, b, st) -> None:
        if self.paged:
            st.kv_pages = len(self.alloc.tables[b])
            self.alloc.release(b)
        self.sched.on_finish(st)

    def stats_extra(self, loop, stats):
        if self.paged:
            return self.eng._kv_stats(stats, self.alloc)
        return stats

    def step(self, loop, active):
        eng = self.eng
        B = loop.B
        slot_state = loop.slot_state
        feed_pos = loop.feed_pos
        # reprolint: mutated-inflight=loop.greedy,loop.temp,loop.top_k,loop.top_p admit() rewrites the decode configs while the span dispatch is in flight

        def commit_one(st, token):
            st.steps += 1
            loop.note_steps(1)
            loop.commit(st, token)

        # ---- wake waiters whose shared prefix finished filling ------
        if self.paged:
            for b in active:
                eng._paged_wake(self.alloc, b, slot_state[b], feed_pos,
                                loop.waiting)

        # ---- host planning: jump-forward commits + drafting ---------
        plans = {}
        with loop.tele.span("plan"):
            for b in active:
                st = slot_state[b]
                if loop.waiting[b]:
                    plans[b] = SlotPlan()
                    continue
                backlog = (st.pos - 1) - int(feed_pos[b])
                pre = st.jump_tokens
                plans[b] = self.sched.plan_slot(st, commit_one,
                                                eng.max_len,
                                                backlog=backlog)
                loop.c_jump.inc(st.jump_tokens - pre)
                st.phase = plans[b].phase.value
        for b in active:
            st = slot_state[b]
            if st.done:      # finished mid-jump: nothing left to feed
                self.sched.on_commit(st, plans[b].jumped)
                loop.finish(b)
        live = [b for b in active
                if slot_state[b] is not None and not loop.waiting[b]]
        if not live:
            loop.stall += 1
            if loop.stall > 4 * B + 16:
                raise RuntimeError("paged scheduler stalled")
            return
        loop.stall = 0

        # ---- span width: maximize commits per unit of compute -------
        pend_n = {b: slot_state[b].pos - int(feed_pos[b]) for b in live}
        S = eng._choose_span(
            [pend_n[b] + len(plans[b].drafts) for b in live])
        tokens = np.zeros((B, S), np.int32)
        fmask = np.zeros((B, S), bool)
        sel0 = {}        # b -> span index of first selection (-1 none)
        fed = {}         # b -> tokens fed this span
        for b in list(live):
            st = slot_state[b]
            fs = int(feed_pos[b])
            pend = st.token_ids[fs: st.pos]
            if len(pend) > S:          # backlog drain: feed only
                feed = pend[:S]
                sel0[b] = -1
                plans[b].drafts = []
            else:
                plans[b].drafts = plans[b].drafts[: S - len(pend)]
                feed = pend + plans[b].drafts
                sel0[b] = len(pend) - 1
            if self.paged:
                if eng._prepare_feed(self.alloc, self.caches, b, st, fs,
                                     len(feed)) is None:
                    loop.finish(b)     # kv_oom under true pressure
                    live.remove(b)
                    continue
                for i in range(len(feed)):
                    fmask[b, i] = (fs + i) >= st.write_from
            else:
                fmask[b, : len(feed)] = True
            tokens[b, : len(feed)] = feed
            fed[b] = len(feed)
            if plans[b].drafts:
                st.phase = SlotPhase.VERIFYING.value
        if not live:
            return
        # feed_pos is advanced in place after dispatch: ship copies
        with loop.tele.device_span("forward") as dv:
            with loop.tele.span("forward"):
                page_tab = (eng._h2d(self.alloc.table_rows(np))
                            if self.paged else None)
                # reprolint: dispatch
                logits = eng._span_decode(
                    self.caches, eng._h2d(tokens.copy()),
                    eng._h2d(feed_pos.copy()), eng._h2d(fmask.copy()),
                    page_tab)
            dv.done(logits)
        loop.c_decode_steps.inc()
        if self.paged:
            for b in live:
                st = slot_state[b]
                self.alloc.note_fill(b, min(int(feed_pos[b]) + fed[b],
                                            st.prompt_len))

        # ---- mask rows for every selection position -----------------
        with loop.tele.span("ci_lookup"):
            span_sms: dict[tuple, tuple] = {}  # (b, f) -> (StepMask, off)
            eosm = np.zeros((B, S), bool)
            consm = np.zeros((B, S), bool)
            for b in live:
                st = slot_state[b]
                pl = plans[b]
                if st.constraint is None or sel0[b] < 0:
                    continue
                off = eng._row_offset[st.req.grammar]
                text = st.generated
                for i in range(len(pl.drafts) + 1):
                    if i > 0:
                        text = text + eng.tok.id_to_bytes[pl.drafts[i - 1]]
                    if i == 0 and pl.stop_mask is not None:
                        sm = pl.stop_mask  # reuse jump analyzer's mask
                    else:
                        sm = st.constraint.step_rows(text)
                    f = sel0[b] + i
                    span_sms[(b, f)] = (sm, off)
                    eosm[b, f] = sm.eos_allowed
                    consm[b, f] = True
                    st.mask_computations += 1
                    loop.c_mask_comp.inc()
            # row width grows in accept_width buckets on overflow
            A = max([MAX_ACCEPT] + [sm.rows.shape[0]
                                    for sm, _ in span_sms.values()])
            rows = np.full((B, S, A), -1, np.int32)
            for (b, f), (sm, off) in span_sms.items():
                r = np.where(sm.rows >= 0, sm.rows + off, sm.rows)
                rows[b, f, :r.shape[0]] = r
        with loop.tele.span("cd_check"):
            W = eng._words
            cdm = np.zeros((B, S, W), np.uint32)
            for (b, f), (sm, _) in span_sms.items():
                if sm.cd_words is not None:
                    cdm[b, f] = sm.cd_words
        with loop.tele.device_span("mask_sample") as dv:
            with loop.tele.span("mask_dispatch"):
                salts = np.array([slot_state[b].steps if slot_state[b]
                                  else 0 for b in range(B)], np.uint32)
                keys = eng._span_keys(loop.seeds, salts, S)
                # span_mask_select ships every host array as a copy; the
                # admit()-mutated decode configs are copied here too
                masked, ids, ok = eng.span_mask_select(  # reprolint: dispatch
                    logits, rows, cdm, eosm, consm,
                    loop.greedy.copy(), loop.temp.copy(),
                    loop.top_k.copy(), loop.top_p.copy(), keys)
            dv.done((ids, ok))
        with loop.tele.span("select_resolve"):
            both = torch.stack((ids, ok.to(torch.int32))).cpu()
            ids_h, ok_h = both[0].numpy(), both[1].numpy().astype(bool)

        # ---- accept: longest valid draft prefix + bonus token -------
        with loop.tele.span("host_oracle"):
            for b in live:
                st = slot_state[b]
                pl = plans[b]
                if sel0[b] < 0:
                    # pure backlog drain (jump replay or chunked
                    # prefill): advance the feed cursor; the step's jump
                    # commits must still reach the proposer history
                    self.sched.on_commit(st, pl.jumped)
                    feed_pos[b] += fed[b]
                    if self.paged and feed_pos[b] < st.prompt_len:
                        st.phase = SlotPhase.PREFILLING.value
                    continue
                idx = sel0[b]
                committed = []
                for d in pl.drafts:
                    if st.done or int(ids_h[b, idx]) != d:
                        break
                    commit_one(st, d)
                    committed.append(d)
                    idx += 1
                st.draft_proposed += len(pl.drafts)
                st.draft_accepted += len(committed)
                loop.c_draft_prop.inc(len(pl.drafts))
                loop.c_draft_acc.inc(len(committed))
                self.sched.on_verify(st, len(pl.drafts), len(committed))
                if not st.done:
                    nxt = eng._resolve_span_selection(
                        st, masked, b, idx, int(ids_h[b, idx]),
                        bool(ok_h[b, idx]), st.steps)
                    if nxt is None:
                        st.done = True
                        st.finish_reason = "mask_exhausted"
                    else:
                        commit_one(st, nxt)
                        committed.append(nxt)
                self.sched.on_commit(st, pl.jumped + committed)
                if st.done:
                    loop.finish(b)
                else:
                    feed_pos[b] = st.pos - 1
                    st.phase = SlotPhase.DECODING.value


def make_mode(engine, spec: Optional[SpecConfig] = None,
              speculative: bool = False, overlap: Optional[bool] = None):
    """Mode factory mirroring the Engine entry points."""
    if speculative or spec is not None:
        return SpecMode(engine, spec)
    if engine.paged:
        return PagedMode(engine)
    return DenseMode(engine, overlap=overlap)
