"""Speculation scheduler: per-slot state machine + ragged span planning.

Every engine step, each active slot is planned into one of four phases:

  JUMPING   — the grammar forced >= 1 token this step; they are committed
              host-side (zero model calls) and queued for cache replay.
  DRAFTING  — the proposer drafted tokens that survived the grammar
              oracle; they ride the span for verification.
  VERIFYING — the slot contributed drafts to the current span device call
              (set while the fused [B, S, V] decode+mask+select runs).
  DECODING  — nothing speculative this step: the slot advances one token
              exactly like the plain batched engine.

The scheduler never talks to the device: it owns the per-request draft
proposers, runs the jump analyzer, oracle-filters drafts, and hands the
serving engine a `SlotPlan` per slot. The engine packs plans into a
bucketed [B, S] span (padding gated off via the model's feed_mask) so
speculating and plain-decoding slots share one device call per step —
neither stalls the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from repro_torch.core.tokenizer import EOS_ID
from .jump import jump_forward
from .proposer import make_proposer

# span-width buckets the engine jits against: ragged per-slot feeds are
# padded up to the smallest bucket that fits the widest slot, so at most
# len(SPAN_BUCKETS) specializations of the span functions ever compile
SPAN_BUCKETS = (1, 2, 4, 8, 16)


class SlotPhase(str, Enum):
    DECODING = "decoding"
    JUMPING = "jumping"
    DRAFTING = "drafting"
    VERIFYING = "verifying"
    PREFILLING = "prefilling"   # paged engine: prompt backlog (chunked
                                # prefill) or waiting on shared pages
                                # another slot is still filling


@dataclass
class SpecConfig:
    """Knobs for grammar-aware speculative decoding."""
    jump: bool = True            # forced-continuation (jump-forward) engine
    literal_jump: bool = False   # byte-level forced literals, canonically
                                 # re-tokenized (longer jumps; trades exact
                                 # plain-engine token equivalence — output
                                 # bytes stay grammar-forced and valid)
    draft: bool = True           # draft-verify engine
    draft_k: int = 4             # max draft tokens per slot per step
    max_jump: int = 16           # max forced tokens committed per step
                                 # (jumped tokens drain through the span
                                 # as backlog, so this does not bound the
                                 # span width)
    proposer: str = "sam"        # "sam" (suffix automaton) | "ngram"
    ngram_n: int = 4             # context cap for the ngram proposer
    min_match: int = 2           # min history-suffix match before drafting
    draft_backoff: int = 8       # max steps to pause drafting after a
                                 # fully-rejected window (doubles per miss)

    def __post_init__(self):
        span_max = SPAN_BUCKETS[-1]
        if self.draft_k + 1 > span_max:
            raise ValueError(
                f"draft_k + 1 must fit the widest span bucket "
                f"({span_max}); got {self.draft_k} + 1")


@dataclass
class SlotPlan:
    """One slot's contribution to the current engine step."""
    jumped: list = field(default_factory=list)  # committed by jump-forward
    drafts: list = field(default_factory=list)  # uncommitted, oracle-vetted
    phase: SlotPhase = SlotPhase.DECODING
    stop_mask: object = None   # StepMask for the first selection position
                               # (reused from the jump analysis)


class SpecScheduler:
    """Owns proposers + planning; one instance per engine generate call."""

    def __init__(self, cfg: SpecConfig, tokenizer, telemetry=None):
        self.cfg = cfg
        self.tok = tokenizer
        self._proposers: dict = {}           # rid -> proposer
        self._backoff: dict = {}             # rid -> [skip_steps, misses]
        self._c_plans = None                 # phase -> Counter
        self._c_backoff = None
        if telemetry is not None:
            reg = telemetry.registry
            self._c_plans = {
                ph.value: reg.counter(
                    "repro_spec_plans_total",
                    "slot plans per step by resulting phase",
                    {"phase": ph.value})
                for ph in (SlotPhase.DECODING, SlotPhase.JUMPING,
                           SlotPhase.DRAFTING)}
            self._c_backoff = reg.counter(
                "repro_spec_backoff_entries_total",
                "fully-rejected draft windows that triggered backoff")

    # ------------------------- request lifecycle -------------------------

    def on_admit(self, st) -> None:
        """Seed the slot's proposer with its prompt tokens (drafts may
        copy continuations that started inside the prompt)."""
        p = make_proposer(self.cfg.proposer, self.cfg.ngram_n,
                          self.cfg.min_match)
        p.extend(int(t) for t in st.token_ids)
        self._proposers[st.req.rid] = p
        self._backoff[st.req.rid] = [0, 0]

    def on_commit(self, st, tokens) -> None:
        """Feed committed tokens (jump + accepted + bonus) to the
        proposer so future drafts can reference them."""
        p = self._proposers.get(st.req.rid)
        if p is not None:
            p.extend(int(t) for t in tokens if t != EOS_ID)

    def on_verify(self, st, proposed: int, accepted: int) -> None:
        """Adaptive drafting: a fully-rejected window pauses drafting for
        this slot (exponential backoff, capped), any acceptance resets —
        so low-acceptance regimes stop paying the oracle-filter tax."""
        bo = self._backoff.get(st.req.rid)
        if bo is None or proposed == 0:
            return
        if accepted > 0:
            bo[0] = bo[1] = 0
        else:
            bo[1] = min(bo[1] + 1, 30)
            bo[0] = min(1 << (bo[1] - 1), self.cfg.draft_backoff)
            if self._c_backoff is not None:
                self._c_backoff.inc()

    def on_finish(self, st) -> None:
        self._proposers.pop(st.req.rid, None)
        self._backoff.pop(st.req.rid, None)

    # ----------------------------- planning ------------------------------

    def _budget(self, st, max_len: int) -> int:
        """Tokens this slot may still commit (length + cache caps)."""
        return max(0, min(st.req.max_new_tokens - st.steps,
                          (max_len - 1) - st.pos))

    def plan_slot(self, st, commit, max_len: int,
                  backlog: int = 0) -> SlotPlan:
        plan = self._plan_slot(st, commit, max_len, backlog)
        if self._c_plans is not None:
            c = self._c_plans.get(plan.phase.value)
            if c is not None:
                c.inc()
        return plan

    def _plan_slot(self, st, commit, max_len: int,
                   backlog: int = 0) -> SlotPlan:
        """Plan one slot for this step. `commit(st, token)` is the
        engine's commit hook (updates steps/stats/text); jump-forward
        tokens are committed here, before any device work.

        backlog > 0 means earlier-committed tokens are still draining
        through the span (the slot cannot select this step): planning is
        skipped — the frontier text is unchanged, so a jump re-analysis
        would find exactly what the previous one already reported."""
        plan = SlotPlan()
        cfg = self.cfg
        if backlog > 0:
            return plan

        # ---- jump-forward: grammar-forced run, zero model calls ----
        if cfg.jump and st.constraint is not None and not st.done:
            budget = min(cfg.max_jump, self._budget(st, max_len))
            if budget > 0:
                jr = jump_forward(st.constraint, st.generated, budget,
                                  literal=cfg.literal_jump)
                for t in jr.tokens:
                    if st.done:
                        break
                    st.jump_tokens += 1
                    commit(st, t)
                    plan.jumped.append(t)
                plan.stop_mask = jr.stop_mask
                if jr.eos and not st.done:
                    st.jump_tokens += 1
                    commit(st, EOS_ID)
                if jr.dead_end and not st.done:
                    st.done = True
                    st.finish_reason = "mask_exhausted"
                if plan.jumped or jr.eos:
                    plan.phase = SlotPhase.JUMPING

        if st.done:
            return plan

        # ---- draft-verify: oracle-filtered proposer drafts ----
        if cfg.draft:
            bo = self._backoff.get(st.req.rid)
            if bo is not None and bo[0] > 0:
                bo[0] -= 1                     # backed off: skip drafting
                return plan
            k = min(cfg.draft_k,
                    self._budget(st, max_len) - 1)   # leave room for bonus
            plan.drafts = self._draft(st, k)
            if plan.drafts:
                plan.phase = SlotPhase.DRAFTING
        return plan

    def _draft(self, st, k: int) -> list:
        if k <= 0:
            return []
        prop = self._proposers.get(st.req.rid)
        if prop is None:
            return []
        out = []
        text = st.generated
        for t in prop.propose(k):
            t = int(t)
            tb = self.tok.id_to_bytes[t] if t < len(self.tok.id_to_bytes) \
                else b""
            if not tb:                         # specials never draft
                break
            if st.constraint is not None and \
                    not st.constraint.is_valid_extension(text, t):
                break
            out.append(t)
            text += tb
        return out
