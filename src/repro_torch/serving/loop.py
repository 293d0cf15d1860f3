"""The step-loop core of the dense serving mode (port of the dense subset
of `repro.serving.loop`).

`StepLoop` owns admission, the deadline sweep, finish
bookkeeping and stats; `DenseMode` plugs in the per-step body: one
[B, V] decode + one fused mask/sample per step, with host/device
OVERLAP: after the fused mask+sample of step k is queued, step k+1's
unmasked forward is queued immediately with the on-device sampled ids
(the token never leaves the device); the host then copies the ids back
(`.cpu()`, the step's one sync), validates step k against the exact
oracle and builds step k+1's mask rows while the card is already busy.
When the host changes the outcome (oracle ban, exact fallback, a
finished slot, an admission) the speculative forward is discarded and
the corrected step re-dispatched — position-addressed KV caches make the
rewrite idempotent (`kv_pos <= q_pos` masking hides the stale write), so
the result is token-for-token identical to the non-overlapped engine.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from ..core.decoding import DecodeConfig
from ..obs import Telemetry
from .devbridge import attach as _attach_devbridge


# --------------------------- request sources ---------------------------

class ListSource:
    """Fixed batch of requests (the synchronous generate() path)."""

    def __init__(self, requests):
        self._q = deque(requests)

    def __len__(self):
        return len(self._q)

    def try_pop(self):
        return self._q.popleft() if self._q else None


# ------------------------------ the loop -------------------------------

class StepLoop:
    """Shared slot-pool loop: admission, deadline sweep, per-mode step
    body, finish bookkeeping, stats."""

    def __init__(self, engine, mode, source, verbose: bool = False):
        self.eng = engine
        self.mode = mode
        self.source = source
        self.verbose = verbose
        self.tele = Telemetry(enabled=engine.telemetry_enabled)
        # bind the device sync (CUDA only); device timing itself stays
        # OFF unless the engine was built for bench/profile mode
        _attach_devbridge(self.tele, engine.device)
        if engine.devtime_enabled:
            self.tele.devtime.enabled = True

        B = engine.slots
        self.B = B
        self.slot_state = [None] * B
        self.feed_pos = np.zeros(B, np.int32)
        self.seeds = np.zeros(B, np.uint32)
        self.greedy = np.ones(B, bool)
        self.temp = np.ones(B, np.float32)
        self.top_k = np.zeros(B, np.int32)
        self.top_p = np.ones(B, np.float32)

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
        self.all_states.append(st)

    def finish(self, b: int) -> None:
        st = self.slot_state[b]
        self.mode.release(self, b, st)
        self.slot_state[b] = None
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

    def commit(self, st, token: int) -> None:
        """THE commit point: engine bookkeeping and telemetry."""
        self.eng._commit(st, token)
        self.c_tokens.inc()
        self.tele.lifecycle.on_token(st.req.rid)
        tr = self.tele.tracer
        if tr.active:
            tr.instant(f"slot {st.slot}", "token", time.perf_counter(),
                       {"id": int(token)})

    def note_steps(self, n: int) -> None:
        self.c_steps.inc(n)

    # ---------------------------- deadlines ---------------------------

    def _sweep(self) -> None:
        now = None
        for b in self.active():
            st = self.slot_state[b]
            if st.deadline_at is not None:
                now = time.perf_counter() if now is None else now
                if now >= st.deadline_at:
                    st.done = True
                    st.finish_reason = "deadline"
                    self.finish(b)

    # ------------------------------ run -------------------------------

    def run(self):
        """Drive the loop until the source is drained and the pool is
        idle."""
        while True:
            self._sweep()
            for b in range(self.B):
                if self.slot_state[b] is not None:
                    continue
                req = self.source.try_pop()
                if req is None:
                    break
                self.admit(b, req)
            active = self.active()
            if not active:
                break
            self.mode.step(self, active)
        return self.all_states, self.stats()

    # ------------------------------ stats ------------------------------

    def stats(self):
        """EngineStats as a view over the telemetry registry."""
        from .engine import EngineStats
        tele = self.tele
        s = EngineStats(
            requests=int(self.c_requests.value),
            tokens=sum(st.steps for st in self.all_states),
            wall=time.perf_counter() - self.t0,
            mask_time=(tele.phase_seconds("ci_lookup")
                       + tele.phase_seconds("cd_check")
                       + tele.phase_seconds("mask_dispatch")
                       + tele.phase_seconds("select_resolve")),
            mask_computations=int(self.c_mask_comp.value),
            decode_steps=int(self.c_decode_steps.value),
            batch_slots=self.B,
            overlap_dispatched=int(self.c_overlap_disp.value),
            overlap_hits=int(self.c_overlap_hit.value),
            device_forward_s=(tele.devtime.seconds("forward")
                              + tele.devtime.seconds("overlap_forward")),
            device_mask_sample_s=tele.devtime.seconds("mask_sample"),
            overlap_hidden_s=tele.c_overlap_hidden.value,
            attribution=tele.attribution() if tele.enabled else None,
        )
        return self.mode.stats_extra(self, s)

    def add_select_ctr(self, ctr: dict) -> None:
        self.c_mask_comp.inc(ctr["mask_computations"])


# ------------------------------- modes ---------------------------------

class _ModeBase:
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

    def __init__(self, engine):
        self.eng = engine
        self.overlap = engine.overlap and engine.model.supports_span_decode
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
        st = self.eng._admit_common(req, b, self.caches)
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
        if self.overlap and ctx.ids is not None and \
                self._speculate_now(loop):
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


def make_mode(engine):
    """Mode factory: the dense mode is the only one ported."""
    return DenseMode(engine)
