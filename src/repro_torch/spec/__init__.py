"""Grammar-aware speculative decoding.

Two cooperating engines ride the continuous-batching serving pool:

  * **jump-forward** (`jump.py`) — when the DFA mask store says the
    grammar admits exactly one next token, that token is emitted with
    zero model calls (the model forward only replays it for cache
    consistency, batched into the next span step);
  * **draft-verify** (`proposer.py` + the engine's span path) — a cheap
    host-side proposer drafts K tokens from the slot's own history,
    the grammar filters them, and one fused [B, K+1, V] model + mask
    pass accepts the longest valid prefix.

`scheduler.py` assembles per-slot plans (JUMPING / DRAFTING / VERIFYING /
DECODING) into ragged span batches so speculating and plain-decoding
slots share one device call per step.
"""
from .jump import JumpResult, forced_literal, jump_forward, retokenize_aligned
from .proposer import NGramProposer, SuffixAutomatonProposer, make_proposer
from .scheduler import SlotPhase, SlotPlan, SpecConfig, SpecScheduler

__all__ = [
    "JumpResult", "jump_forward", "forced_literal", "retokenize_aligned",
    "NGramProposer", "SuffixAutomatonProposer", "make_proposer",
    "SlotPhase", "SlotPlan", "SpecConfig", "SpecScheduler",
]
