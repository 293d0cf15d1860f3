"""Grammar-constrained serving engine, dense path (port of
`repro.serving.engine`).

Continuous batching over a fixed pool of `B = slots` decode slots:

  * one `[B, V]` decode step advances every active request at once
    (decode caches are allocated `[.., B, ..]` up front; per-request
    prefill results are inserted into their slot on admission),
  * the host side of Algorithm 2 runs in two context-split stages
    (`GrammarConstraint.ci_rows_batch` + `cd_overlay_batch`): a `[B, A]`
    matrix of PRECOMPUTED store row ids and a `[B, W]` residue-word
    overlay,
  * ONE fused mask+filter+sample call (`kernels/fused_select`, the Hopper
    kernel on the card) draws every slot's next token; only the `[B]`
    ids and ok flags come back to the host,
  * the paper's opportunistic masking (`opportunistic=True`) first
    checks the whole batch's unconstrained proposals against the oracle
    and builds mask rows only for the slots whose proposal was rejected,
  * sampled ids are verified against the exact parser oracle; invalid
    picks are banned and their rows resampled through the same fused op
    (unconstrained, rows = -1), with an exact host filter as the last
    resort, so emitted text stays in L_p(G),
  * finished requests free their slot and the next queued request is
    admitted immediately.

The step bodies live in `serving/loop.py`: DenseMode (with host/device
overlap), PagedMode (page-table KV with prefix sharing and chunked
prefill; `paged=True`) and SpecMode (grammar-aware speculation over
dense or paged caches; `generate_speculative`). The `generate*` entry
points drive that loop to completion over a fixed request list;
`serving/async_engine.py` drives the same loop persistently with live
admission, streaming, cancellation and deadlines. `generate_sequential`
keeps the round-robin one-request-at-a-time path (paper Algorithm 3),
the baseline the batched engine is measured against.

Sampling draws standard-Gumbel noise through an injectable
`noise_fn(keys [N, 2] uint32, V) -> [N, V] f32 tensor`; the default
draws on the device from a torch.Generator per row seeded by the row's
key, so a slot's stream depends only on its own progress.

Tensor-parallel serving (`mesh=`, `launch/mesh.py::make_serving_mesh`):
every rank of the mesh runs this engine over the same requests, SPMD,
one process and one device a rank. The vocabulary family is split at the
mask store's word boundaries (`distributed/sharding.py::vocab_shard`):
each rank holds its rows of `embed`, its columns of `lm_head` (so its
logits are [.., V_s]) and its words of the packed store, and masks its
own block (`masked_logits`, shard-local); one all-gather of the masked
rows precedes the selection, which every rank runs on the same
replicated row with the same noise (`fused_mask_select` unconstrained,
`select_span`, the resample and the host fallbacks), so every rank
commits the same ids. The embedding lookup combines with one all-reduce;
the trunk, the caches, the page pools and the host-side page tables are
replicated. Output is token for token the single-device engine's where
the column-split lm_head product is bitwise the whole one: in the CPU
tests (fp32, 1, 2 and 4 ranks), and on the H100 in bf16 at every split and
row count measured there (`scripts/shard_probe.py`: V 49152 in 2 and 4
blocks, V 50280 in 2, 1 to 512 rows) and in fp32 at 2 blocks. In fp32 at
4 blocks of V 49152 cuBLAS's product differed (up to 2.7e-4 at 8 and 64
rows), so fp32 on the card at more than 2 ranks may change tokens: the
engine warns there, and that case is unverified. What
wall time or other threads decide (admissions, cancellations, deadlines,
hot grammar loads) rank 0 decides and broadcasts once per loop iteration
(serving/loop.py).

Trunk sharding (`mesh=` with `trunk_shard=True`), the reference's
megatron-style rules for weights past one device: each rank also holds
its block of every trunk leaf (`serving_param_spec(..., trunk_shard=
True)`: the q/kv heads of wq/wk/wv and the rows of wo, d_ff's columns of
w_gate/w_up and rows of w_down when M divides d_ff, its E/M experts and
their router columns when M divides E) and of every cache and page pool
(`serving_cache_specs`: its K/M kv heads), and runs its layers over the
rank-local config (`TrunkPlan.local_config`: H/M and K/M heads, so the
attention kernels run unchanged on the rank's heads). Two all-reduces a
layer join the row-parallel products (attention out, FFN down), and an
MoE layer gathers its router columns and all-reduces its experts'
combined outputs (`models/common.py`, `models/moe.py`). The vocabulary
split above is kept. This gives token identity up, as the reference
says: each all-reduce adds partial sums in another order than the
one-device product (in the CPU tests, fp32 at 1, 2 and 4 ranks: logits
within atol 1e-4 of the JAX one-device model, and every serving path
gives the unsharded engine's tokens). Where M does not divide the kv
heads (`TrunkPlan.gathers`) the rank gathers whole q/k/v heads from its
column blocks, and each kind of cache takes the reference's next branch
for its own length (`TrunkPlan.cache` for the attention ring of
`max_len` positions, or the hybrid's local window; `TrunkPlan.pool` for
pages of `page_size`): its share of each cache's positions and of each
page's offsets, whose partial attentions are joined by their
log-sum-exp; else its block of head_dim, whose partial scores are
all-reduced and whose blocks of the output are gathered; else the whole
cache on every rank (`models/layers.py`). The recurrent families
(mamba2's ssm, recurrentgemma's rec) split their channels by the same
rules (`TrunkPlan`'s ssm and rec blocks) and serve dense and
sequential, as on one device: each rank's recurrent caches hold its
heads' or its width's state and its conv channels (`models/ssm.py`,
`models/rglru.py` name the gathers). The vlm and audio families, which
the engine does not serve at all, are refused with a ValueError.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..core.constrain import GrammarConstraint, MAX_ACCEPT, accept_width
from ..core.decoding import (DecodeConfig, NEG_INF, select_batch,
                             select_span)
from ..core.tokenizer import BOS_ID, ByteTokenizer, EOS_ID
from ..bridge import shard_params
from ..device import resolve_device
from ..distributed import cost
from ..distributed.api import all_gather_last, use_sharding
from ..distributed.sharding import (serving_trunk_plan, trunk_slice,
                                    vocab_shard)
from ..kernels.fused_select.ops import (fused_mask_select,
                                        fused_mask_select_sharded,
                                        gumbel_noise)
from ..kernels.masked_logits.ops import (apply_grammar_mask_shard,
                                         apply_grammar_mask_span_shard)
from ..obs import Telemetry
from ..spec.scheduler import SPAN_BUCKETS, SlotPhase, SpecConfig
from .kvpool import PagedAllocator, PoolExhausted

# shared disabled telemetry: the `obs=None` default of the selection
# helpers — span() returns the no-op NULL_SPAN
_OBS_OFF = Telemetry(enabled=False)

# span widths of the paged feed (chunked prefill drains prompt backlog
# through these; decode-only steps ride width 1)
FEED_BUCKETS = (1, 2, 4, 8, 16, 32)


@dataclass
class Request:
    rid: int
    prompt: bytes = b""
    grammar: Optional[str] = None           # None = unconstrained
    grammar_mode: Optional[str] = None      # "grammar_mask" |
                                            # "grammar_strict"; None =
                                            # engine default
    max_new_tokens: int = 128
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    seed: int = 0
    deadline: Optional[float] = None        # seconds from admission


@dataclass
class RequestState:
    req: Request
    caches: object = None                   # sequential path only
    pos: int = 0
    generated: bytes = b""
    token_ids: list = field(default_factory=list)
    constraint: Optional[GrammarConstraint] = None
    done: bool = False
    finish_reason: str = ""
    pending_logits: object = None           # sequential path only
    mask_time: float = 0.0
    mask_computations: int = 0
    opportunistic_hits: int = 0
    steps: int = 0
    slot: int = -1
    # --- speculation (generate_speculative) ---
    phase: str = SlotPhase.DECODING.value
    jump_tokens: int = 0                    # grammar-forced, no model call
    draft_proposed: int = 0
    draft_accepted: int = 0
    # --- paged KV ---
    prompt_len: int = 0
    write_from: int = 0         # first position this slot may write into
                                # its pages (below = shared prefix pages)
    kv_pages: int = 0           # pages held when the request finished
    # --- async lifecycle (serving/loop.py) ---
    cancelled: bool = False     # set from any thread; the loop frees the
                                # slot (and its KV pages) next step
    deadline_at: Optional[float] = None     # perf_counter() expiry
    admit_t: Optional[float] = None         # perf_counter() at admission


@dataclass
class EngineStats:
    requests: int = 0
    tokens: int = 0
    wall: float = 0.0
    mask_time: float = 0.0
    mask_computations: int = 0
    opportunistic_hits: int = 0
    decode_steps: int = 0                   # CONSUMED batched [B,V] steps
    batch_slots: int = 0
    overlap_dispatched: int = 0             # speculative forwards launched
    overlap_hits: int = 0                   # ...that the next step consumed
    # --- speculation (generate_speculative) ---
    jump_tokens: int = 0                    # emitted with zero model calls
    draft_proposed: int = 0
    draft_accepted: int = 0
    plan_time: float = 0.0                  # host planning (jump + draft)
    # --- paged KV ---
    kv_pages_in_use: int = 0                # pages still referenced at end
    kv_peak_utilization: float = 0.0        # peak pages-in-use / pool size
    prefix_hit_rate: float = 0.0            # shared / total prompt tokens
    kv_page_allocs: int = 0                 # page allocations over the run
    kv_evictions: int = 0                   # cold pages evicted
    kv_cow_copies: int = 0                  # copy-on-write device copies
    device_forward_s: float = 0.0           # synced forward intervals
    device_mask_sample_s: float = 0.0       # synced mask+sample intervals
    overlap_hidden_s: float = 0.0
    attribution: Optional[dict] = None
    mesh_devices: int = 1                   # tensor-parallel mesh size

    @property
    def tokens_per_sec(self):
        return self.tokens / max(self.wall, 1e-9)

    @property
    def jump_fraction(self):
        return self.jump_tokens / max(self.tokens, 1)

    @property
    def acceptance_rate(self):
        return self.draft_accepted / max(self.draft_proposed, 1)

    @property
    def overlap_hit_rate(self):
        return self.overlap_hits / max(self.overlap_dispatched, 1)


@dataclass
class _SelectCtx:
    """In-flight state between `_select_dispatch` and `_select_resolve`.
    `ids` is the first-round sampled ids still on the device — the
    overlap path feeds it straight into the next forward. `clean` ends
    True iff every pending slot committed exactly its first-round id."""
    committed: dict
    pending: set
    ctr: dict
    salts: np.ndarray
    masked: object = None
    ids: object = None
    ok: object = None
    need_mask: object = None
    clean: bool = True
    mask_elapsed: float = 0.0


class Engine:
    def __init__(self, model, params, tokenizer: ByteTokenizer,
                 grammar_bundles: dict, max_len: int = 512,
                 opportunistic: bool = False, slots: int = 4,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 32,
                 overlap: bool = True, grammar_mode: str = "grammar_mask",
                 telemetry: bool = True, devtime: bool = False,
                 noise_fn: Optional[Callable] = None, device="cuda",
                 mesh=None, trunk_shard: bool = False):
        """grammar_bundles: name -> (grammar, table, store).
        slots: decode-pool width B. paged: serve KV through the shared
        page pool (page-table attention, refcounted prefix sharing,
        chunked prefill of up to `prefill_chunk` tokens per step);
        num_pages defaults to slots * ceil(max_len / page_size), the
        dense engine's KV budget. overlap: dispatch step k+1's forward
        with the on-device ids before the host validates step k
        (serving/loop.py, dense mode); token-for-token identical either
        way; off under opportunistic masking.
        opportunistic: the paper's opportunistic masking — validate the
        unconstrained proposals first, mask only the rejected slots.
        devtime: bench/profile mode — device spans synchronize on exit.
        noise_fn(keys [N,2] uint32 numpy, V) -> [N,V] f32 tensor on the
        engine's device (N = B per step, B*S per speculative span, 1 per
        sequential draw); default `gumbel_noise` on that device.
        device: where params live and the engine runs ("cuda" by
        default; raises without a card unless "cpu" is asked for).
        mesh: a `ServingMesh` with a "model" axis (launch/mesh.py) --
        serve tensor-parallel with the other ranks of its group, which run
        this engine on the same requests (module docstring); `params` are
        the whole tree, each rank keeps its block; the engine runs on the
        mesh's device. trunk_shard: with a mesh, also split the trunk,
        the caches and the page pools (module docstring); `params` may
        then be the whole tree or already this rank's blocks
        (`Model.init(gen, cut=...)`, as `launch.serve.build_engine`
        draws them), and `self.model` is the rank-local model. At M = 1,
        or without a mesh, nothing is split: the plain engine. A split
        `trunk_plan` refuses raises ValueError."""
        if grammar_mode not in GrammarConstraint.MODES:
            raise ValueError(f"unknown grammar_mode {grammar_mode!r}; "
                             f"expected one of {GrammarConstraint.MODES}")
        self.mesh = mesh
        self._cfg = model.cfg           # the whole config
        self._trunk = None              # this rank's TrunkPlan, if split
        # this rank's VocabShard; the whole vocabulary without a mesh
        self._vs = vocab_shard(model.cfg.vocab_size, 1, 0)
        if mesh is not None:
            if "model" not in mesh.axis_names:
                raise ValueError(
                    "serving mesh needs a 'model' axis "
                    "(launch/mesh.py::make_serving_mesh)")
            M = mesh.shape["model"]
            self._vs = vocab_shard(model.cfg.vocab_size, M, mesh.rank)
            self.device = mesh.device
            plan = serving_trunk_plan(
                model.cfg, M, mesh.rank, max_len,
                max(1, int(page_size)) if paged else None) \
                if trunk_shard else None
            if plan is not None and plan.split:
                self._trunk, vs = plan, self._vs
                params = shard_params(
                    params, lambda p, shape: trunk_slice(p, shape, mesh,
                                                         mesh.rank, vs),
                    whole=model.abstract_params())
                model = type(model)(plan.local_config(model.cfg),
                                    self.device)
            else:
                params = shard_params(params, self._vs)
        else:
            self.device = resolve_device(device)
        pdev = params["embed_block"]["embed"].device
        if self._split and self.device.type == "cuda" and \
                self._vs.size > 2 and \
                params["embed_block"]["embed"].dtype == torch.float32:
            warnings.warn(
                "fp32 vocab-parallel serving on the card over more than 2 "
                "ranks is not verified token for token: the column-split "
                "lm_head product is not bitwise the whole one there "
                "(scripts/shard_probe.py); bf16 is", stacklevel=2)
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.tok = tokenizer
        self.bundles = dict(grammar_bundles)
        self.grammar_mode = grammar_mode
        self.max_len = max_len
        self.opportunistic = bool(opportunistic)
        self.slots = max(1, int(slots))
        self.paged = bool(paged)
        self.page_size = max(1, int(page_size))
        self.max_pages = -(-max_len // self.page_size)
        self.num_pages = int(num_pages or self.slots * self.max_pages)
        self.prefill_chunk = max(1, int(prefill_chunk))
        if self.paged and not model.supports_span_decode:
            raise ValueError(
                "paged KV serving needs position-addressed decode caches "
                "(attn/moe layer kinds); this arch has recurrent or "
                "side-input state")
        if self.paged and model.cfg.sliding_window:
            raise ValueError(
                "paged KV serving does not support sliding-window "
                "attention")
        self.overlap = bool(overlap)
        self.telemetry_enabled = bool(telemetry)
        self.devtime_enabled = bool(devtime)
        vocab = model.cfg.vocab_size
        dev = self.device       # not `self`: no cycle through the engine
        self.noise_fn = noise_fn or (
            lambda keys, V: gumbel_noise(keys, V, dev))
        self._vocab = vocab
        self._noise_cache = None    # (keys bytes, [B, V] device noise)
        self._row_offset: dict[str, int] = {}
        self._rebuild_store_cat()

    @property
    def _split(self) -> bool:
        """True when this engine holds one rank's block of a vocabulary
        split across its mesh."""
        return self.mesh is not None and self._vs.split

    def _sharding(self):
        """The sharding context of this engine's device calls (none
        without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_sharding(self.mesh, self._vs, self._trunk)

    def _gather(self, x):
        """A rank's [.., V_s] block joined to the whole [.., V] row (the
        identity without a mesh or when the vocabulary is replicated)."""
        if not self._split:
            return x
        return all_gather_last(x, self._vs.widths, self.mesh)

    def _words_local(self, words: np.ndarray) -> np.ndarray:
        """[.., W] host words -> this rank's [.., W_s] (all of them
        without a mesh)."""
        return words[..., self._vs.w0:self._vs.w1]

    def _rebuild_store_cat(self):
        """Build the concatenated device store from self.bundles (the
        store lives on the device exactly once; a request's rows index
        its grammar's block via the per-grammar row offset). Under a
        split vocabulary the device keeps this rank's words [w0, w1);
        `_words` stays the whole width the host layer builds."""
        self._row_offset = {}
        parts, off = [], 0
        for name, b in self.bundles.items():
            self._row_offset[name] = off
            parts.append(b[2].packed)
            off += b[2].packed.shape[0]
        words = (self.tok.vocab_size + 31) // 32
        cat = (np.concatenate(parts, axis=0) if parts
               else np.zeros((1, words), np.uint32))
        self._words = int(cat.shape[1])
        self._store_cat = torch.from_numpy(np.ascontiguousarray(
            self._words_local(cat)).view(np.int32)).to(self.device)
        # the unconstrained selection over whole rows reads no store row
        # (rows = -1): a rank's word block would not cover V, so it gets
        # a blank whole-width one
        self._select_store = self._store_cat if not self._split else \
            torch.zeros((1, self._words), dtype=torch.int32,
                        device=self.device)

    def check_grammar(self, name: str, bundle) -> None:
        """Raise ValueError where `register_grammar` would refuse."""
        if name in self.bundles:
            raise ValueError(f"grammar {name!r} already registered")
        store = bundle[2]
        if store.packed.shape[1] * 32 < self.tok.vocab_size:
            raise ValueError(
                f"store for {name!r} built for a smaller vocab "
                f"({store.packed.shape[1] * 32} < {self.tok.vocab_size})")

    def register_grammar(self, name: str, bundle) -> None:
        """Hot-register a freshly compiled (grammar, table, store) bundle:
        its rows are appended to the concatenated device store (insertion
        order keeps every existing offset) and `name` is servable by the
        next request, with no restart. Not safe while a step runs:
        `AsyncEngine.load_grammar` posts it onto the step loop's control
        queue, which drains between steps."""
        self.check_grammar(name, bundle)
        self.bundles[name] = bundle
        self._rebuild_store_cat()

    def _h2d(self, x: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device. The array is
        copied first (pinned on the card, so the copy is asynchronous and
        never waits for queued device work); callers pass arrays nobody
        mutates afterwards, or `.copy()`s."""
        t = torch.from_numpy(np.ascontiguousarray(x).copy())
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _note_cost(self, tele, name: str, count: Callable) -> None:
        """Attach a call's static FLOP/byte count (`distributed/cost.py`,
        `count()` at the shapes the caller just dispatched) to the devtime
        registry: once per fn name, and only when device timing is on
        (the counterpart of the reference's `_note_jit_cost`). With
        devtime off nothing is counted."""
        devtime = tele.devtime
        if not devtime.enabled or name in devtime.costs:
            return
        c = count()
        devtime.set_cost(name, c["flops"], c["hbm_bytes"], c["wire_bytes"])

    def _vocab_width(self) -> int:
        """Vocab ids of this rank's lm head and logits."""
        return self._vs.width if self._split else self.model.cfg.vocab_size

    def _forward_cost(self, count: Callable, *shape) -> dict:
        """`count(cfg, *shape, ...)` of a `distributed/cost.py` forward
        call kind for this engine: per device over the mesh under a
        trunk split (the whole config, the specs' splits: the reference's
        V % M vocabulary rule there, not the word-aligned one), else
        this rank's model with its vocab width."""
        if self._trunk is not None:
            return count(self._cfg, *shape, mesh=self.mesh)
        return count(self.model.cfg, *shape, vocab=self._vocab_width())

    # ------------------------------ device steps ---------------------------

    def _decode(self, caches, token, pos):
        """One [B] decode step; writes `caches` in place -> logits [B,V]
        ([B,V_s], this rank's block, under a split vocabulary)."""
        with self._sharding():
            logits, _ = self.model.decode_step(self.params, caches, token,
                                               pos)
        return logits

    def _prefill(self, prompt, n):
        with self._sharding():
            return self.model.prefill(self.params, {"tokens": prompt},
                                      cache_len=self.max_len, true_len=n)

    def _resample(self, masked, ban, redo, greedy, temp, top_k, top_p,
                  keys):
        """Ban one id per `redo` row, then select again through the same
        fused op, unconstrained (rows = -1): the card runs no second
        selector. `masked` is the whole row on every rank.
        -> (masked, ids, ok)."""
        B, V = masked.shape
        dev = self.device
        hit = (torch.arange(V, device=dev)[None, :] == ban[:, None]) & \
            redo[:, None]
        masked = masked.masked_fill(hit, NEG_INF)
        noise = None if bool(np.all(greedy)) else self._noise(keys)
        ids, masked, ok = fused_mask_select(
            masked, self._select_store,
            torch.full((B, 1), -1, dtype=torch.int32, device=dev), None,
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev),
            self._h2d(greedy), self._h2d(temp), self._h2d(top_k),
            self._h2d(top_p), noise=noise)
        return masked, ids, ok

    def _noise(self, keys: np.ndarray) -> torch.Tensor:
        return self.noise_fn(keys, self._vocab)

    def _span_decode(self, caches, tokens, pos, fmask, page_table=None):
        """[B, S] span decode against dense caches, or through the page
        tables when given; writes `caches` in place -> logits [B,S,V]."""
        ctx = None if page_table is None else {"page_table": page_table}
        with self._sharding():
            logits, _ = self.model.decode_span(self.params, caches, tokens,
                                               pos, feed_mask=fmask,
                                               batch_ctx=ctx)
        return logits

    def span_feed_paged(self, caches, tokens, pos, fmask, page_table, sel):
        """Paged feed of the plain engine: decode a [B, S] span through
        the page tables and return each slot's logits at its selection
        index (clamped; rows that select nothing are ignored by the
        caller), the same [B, V] a dense decode step gives."""
        logits = self._span_decode(caches, tokens, pos, fmask, page_table)
        B, S = tokens.shape
        return logits[torch.arange(B, device=logits.device),
                      sel.clamp(0, S - 1).long()]

    @staticmethod
    def copy_page(caches, s: int, d: int):
        """Apply one allocator-directed copy-on-write to the page pools,
        in place (leaves are [count, P, ps, K, Dh])."""
        for group in caches:
            for leaves in group:
                for a in leaves.values():
                    a[:, d] = a[:, s]
        return caches

    def span_mask_select(self, logits, rows, cd, eos, constrained, greedy,
                         temp, top_k, top_p, keys):
        """Speculative verify: grammar-mask a [B, S, V] span (constrained
        positions through their store rows + residue words, the rest pass
        through) and select a token at every position. Host arrays ship
        as private copies. keys [B, S, 2] seed one noise row per (slot,
        position). -> (masked [B,S,V], ids [B,S] int32, ok [B,S] bool)."""
        B, S, _ = logits.shape
        V = self._vocab
        # the rank's block masked, then the one gather of the masked span
        masked = self._gather(apply_grammar_mask_span_shard(
            logits, self._store_cat, self._h2d(rows), self._h2d(eos),
            self._vs, constrained=self._h2d(constrained),
            cd=self._h2d(self._words_local(cd).view(np.int32))))
        noise = None
        if not bool(np.all(greedy)):
            noise = self._noise(keys.reshape(B * S, 2)).reshape(B, S, V)
        ids = select_span(masked, noise, self._h2d(greedy), self._h2d(temp),
                          self._h2d(top_k), self._h2d(top_p))
        ok = (masked > NEG_INF / 2).any(dim=-1)
        return masked, ids, ok

    # ------------------------------ lifecycle -----------------------------

    def _make_constraint(self, req: Request) -> Optional[GrammarConstraint]:
        if req.grammar is None:
            return None
        g, tab, store = self.bundles[req.grammar]
        return GrammarConstraint(g, tab, store, self.tok,
                                 mode=req.grammar_mode or self.grammar_mode)

    def _prompt_ids(self, req: Request) -> list[int]:
        ids = self.tok.encode(req.prompt) if req.prompt else []
        if not ids:
            ids = [BOS_ID]
        return ids

    def _request_ids(self, req: Request) -> list[int]:
        ids = self._prompt_ids(req)
        if len(ids) == 1:
            # prefill needs >= 1 token before the decode loop takes over
            ids = [BOS_ID] + ids
        return ids

    def _bucketed_prompt(self, ids: list[int]):
        """Zero-pad a prompt to its power-of-two bucket (capped at
        max_len) -> ([1, bucket] int32 tensor, n); `true_len = n` masks
        the padded tail's cache entries. Same buckets as the reference,
        so both prefill the same shapes."""
        n = len(ids)
        bucket = n
        if self.model.prefill_padding_safe:
            bucket = max(n, min(1 << max(0, n - 1).bit_length(),
                                self.max_len))
        prompt = np.zeros((1, bucket), np.int32)
        prompt[0, :n] = ids
        return self._h2d(prompt), n

    def _admit_common(self, req: Request, b: int, caches, defer=None):
        """Build request state, prefill the prompt and insert its caches
        into slot b of `caches` IN PLACE. -> state. With `defer` (a
        list) the prefill and insert are appended to it as one call
        instead: the step loop runs them after its host decisions, so a
        sharded engine's broadcast of those decisions precedes the
        prefill's collective on every rank."""
        st = RequestState(req=req, slot=b)
        st.constraint = self._make_constraint(req)
        ids = self._request_ids(req)

        def prefill():
            prompt, n = self._bucketed_prompt(ids[:-1])
            _, pc = self._prefill(prompt, n)
            for full_g, one_g in zip(caches, pc):
                for full, one in zip(full_g, one_g):
                    for name in full:
                        full[name][:, b] = one[name][:, 0]
        if defer is None:
            prefill()
        else:
            defer.append(prefill)
        st.token_ids = list(ids)
        st.pos = len(ids)
        st.prompt_len = len(ids)
        return st

    def _commit(self, st: RequestState, token: int):
        st.token_ids.append(token)
        st.pos += 1
        if token == EOS_ID:
            st.done = True
            st.finish_reason = "eos"
            return
        st.generated += self.tok.id_to_bytes[token]
        if st.steps >= st.req.max_new_tokens:
            st.done = True
            st.finish_reason = "length"
        if st.pos >= self.max_len - 1:
            st.done = True
            st.finish_reason = "max_len"

    # ============================ batched path ============================

    def _step_keys(self, seeds: np.ndarray, salts: np.ndarray,
                   attempt: int) -> np.ndarray:
        """[B, 2] uint32 key data: one counter-mode stream per slot,
        advanced by (salts[b], attempt). salts are PER-SLOT step counters
        (st.steps), so a slot's sample stream depends only on its own
        progress. Greedy rows ignore keys."""
        k = np.empty((seeds.shape[0], 2), np.uint32)
        k[:, 0] = seeds
        k[:, 1] = (salts.astype(np.uint32) << np.uint32(4)) | \
            np.uint32(attempt & 0xF)
        return k

    def _fallback_exact(self, st: RequestState, row: np.ndarray,
                        attempt_salt: int) -> Optional[int]:
        """Rare slow path: the sampled ids kept failing the oracle (or the
        mask emptied after bans). Exact-filter the remaining allowed set
        and draw host-side, so the step never dead-ends while a valid
        continuation exists."""
        gc = st.constraint
        allowed = np.where(row > NEG_INF / 2)[0]
        valid = [int(t) for t in allowed
                 if t == EOS_ID or gc.is_valid_extension(st.generated,
                                                         int(t))]
        if not valid:
            return None
        sub = row[valid].astype(np.float64)
        if st.req.decode.method == "greedy":
            return valid[int(np.argmax(sub))]
        temp = max(st.req.decode.temperature, 1e-6)
        p = np.exp((sub - sub.max()) / temp)
        p /= p.sum()
        rng = np.random.default_rng(
            (st.req.seed * 1000003 + st.steps * 31 + attempt_salt)
            & 0xFFFFFFFF)
        return int(rng.choice(valid, p=p))

    def _select_dispatch(self, logits, slot_state, pending: set,
                         seeds, greedy, temp, top_k, top_p, obs=None):
        """Phase A of token selection: the opportunistic fast path (one
        ids copy to the host), then host row building and the fused
        mask+sample DISPATCH, whose ids are not synced. Returns a
        `_SelectCtx` whose `.ids` device tensor the overlap path feeds
        into the next forward before the host ever sees it."""
        if obs is None:
            obs = _OBS_OFF
        # reprolint: mutated-inflight=greedy,temp,top_k,top_p admit() rewrites the decode configs while dispatches are in flight
        B = self.slots
        committed: dict[int, int] = {}
        pending = set(pending)
        ctr = {"mask_computations": 0, "opportunistic_hits": 0}
        salts = np.array([slot_state[b].steps if slot_state[b] else 0
                          for b in range(B)], np.uint32)
        ctx = _SelectCtx(committed=committed, pending=pending, ctr=ctr,
                         salts=salts)

        # ---- opportunistic fast path (whole batch at once) ----------
        if self.opportunistic and any(
                slot_state[b].constraint is not None for b in pending):
            with obs.span("opportunistic"):
                noise = None
                if not bool(np.all(greedy)):
                    noise = self._noise(self._step_keys(seeds, salts, 0))
                prop = select_batch(  # reprolint: dispatch
                    self._gather(logits), noise, self._h2d(greedy.copy()),
                    self._h2d(temp.copy()), self._h2d(top_k.copy()),
                    self._h2d(top_p.copy())).cpu().numpy()
                ctx.clean = False   # committed ids came from the
                                    # unmasked proposal stream
                for b in sorted(pending):
                    st = slot_state[b]
                    t = int(prop[b])
                    if st.constraint is None:
                        committed[b] = t
                        pending.discard(b)
                    elif st.constraint.is_valid_extension(st.generated, t):
                        st.opportunistic_hits += 1
                        ctr["opportunistic_hits"] += 1
                        committed[b] = t
                        pending.discard(b)

        if not pending:
            return ctx

        with obs.span("ci_lookup") as sp_ci:
            cons = [slot_state[b].constraint
                    if (b in pending and slot_state[b] is not None)
                    else None for b in range(B)]
            texts = [slot_state[b].generated if slot_state[b] else b""
                     for b in range(B)]
            offs = np.array(
                [self._row_offset.get(slot_state[b].req.grammar, 0)
                 if slot_state[b] is not None else 0
                 for b in range(B)], np.int64)
            rows, eos, _, groups = GrammarConstraint.ci_rows_batch(
                cons, texts, max_accept=MAX_ACCEPT, row_offsets=offs)
        with obs.span("cd_check") as sp_cd:
            cd = GrammarConstraint.cd_overlay_batch(cons, groups,
                                                    self._words)
        with obs.device_span("mask_sample") as dv:
            with obs.span("mask_dispatch") as sp_disp:
                need_mask = np.array([c is not None for c in cons], bool)
                # rows/cd/eos/need_mask may be memoized by the constraint
                # layer and the decode configs are rewritten by admit():
                # every host buffer ships as a private copy
                noise = None
                if not bool(np.all(greedy)):
                    noise = self._noise_take(
                        self._step_keys(seeds, salts, 1))
                sel = fused_mask_select
                kw = {"noise": noise}
                if self._split:
                    # the rank's block masked, gathered, then selected
                    # whole (kernels/fused_select/ops.py)
                    sel = fused_mask_select_sharded
                    kw.update(shard=self._vs, mesh=self.mesh,
                              blank_store=self._select_store)
                ctx.ids, ctx.masked, ctx.ok = sel(  # reprolint: dispatch
                    logits, self._store_cat, self._h2d(rows.copy()),
                    self._h2d(self._words_local(cd).view(np.int32).copy()),
                    self._h2d(eos.copy()), self._h2d(need_mask.copy()),
                    self._h2d(greedy.copy()), self._h2d(temp.copy()),
                    self._h2d(top_k.copy()), self._h2d(top_p.copy()), **kw)
            dv.done((ctx.ids, ctx.ok))
        self._note_cost(obs, "mask_sample", lambda: cost.mask_sample(
            *logits.shape, rows.shape[1], logits.element_size(),
            sampled=noise is not None))
        ctx.need_mask = need_mask
        ctr["mask_computations"] += int(need_mask.sum())
        ctx.mask_elapsed = sp_ci.dur + sp_cd.dur + sp_disp.dur
        return ctx

    # --------------------- Gumbel-noise speculation ---------------------

    def _noise_take(self, keys: np.ndarray):
        """[B, V] device noise for exactly these keys: the previous
        step's resolve usually queued it (`_noise_prefetch`); a miss —
        admission changed a seed, a slot finished — draws it inline."""
        kb = keys.tobytes()
        cached, self._noise_cache = self._noise_cache, None
        if cached is not None and cached[0] == kb:
            return cached[1]
        return self._noise(keys)

    def _noise_prefetch(self, slot_state, seeds: np.ndarray) -> None:
        """Queue next step's first-round noise with PREDICTED salts
        (every live slot advances one step); the device draws it while
        the host runs the oracle loop."""
        B = self.slots
        salts = np.array(
            [slot_state[b].steps + 1
             if slot_state[b] is not None and not slot_state[b].done
             else 0 for b in range(B)], np.uint32)
        keys = self._step_keys(seeds, salts, 1)
        self._noise_cache = (keys.tobytes(), self._noise(keys))

    def _select_resolve(self, ctx, slot_state,
                        seeds, greedy, temp, top_k, top_p, obs=None):
        """Phase B: copy the ids back (the one sync per step), verify
        against the exact oracle, ban + resample on the device, exact
        fallback. Returns (committed, counters)."""
        if obs is None:
            obs = _OBS_OFF
        B = self.slots
        committed, pending, ctr = ctx.committed, ctx.pending, ctx.ctr
        salts = ctx.salts
        if ctx.ids is None:
            return committed, ctr
        masked = ctx.masked
        with obs.span("select_resolve") as sp_sync:
            both = torch.stack((ctx.ids, ctx.ok.to(torch.int32))).cpu()
            ids_h, ok_h = both[0].numpy(), both[1].numpy().astype(bool)
        if not bool(np.all(greedy)):
            self._noise_prefetch(slot_state, seeds)
        n_masked = int(ctx.need_mask.sum())
        elapsed = sp_sync.dur + ctx.mask_elapsed
        for b in np.where(ctx.need_mask)[0]:
            slot_state[b].mask_computations += 1
            slot_state[b].mask_time += elapsed / max(n_masked, 1)

        with obs.span("host_oracle"):
            for attempt in range(2, 6):
                redo = np.zeros(B, bool)
                ban = np.zeros(B, np.int32)
                for b in sorted(pending):
                    st = slot_state[b]
                    if st.constraint is None:
                        committed[b] = int(ids_h[b])
                        pending.discard(b)
                        continue
                    if not ok_h[b]:
                        ctx.clean = False
                        continue    # mask exhausted -> fallback
                    t = int(ids_h[b])
                    if t == EOS_ID or st.constraint.is_valid_extension(
                            st.generated, t):
                        committed[b] = t
                        pending.discard(b)
                    else:
                        redo[b] = True
                        ban[b] = t
                if not redo.any():
                    break
                ctx.clean = False
                keys = self._step_keys(seeds, salts, attempt)
                masked, ids, ok = self._resample(
                    masked, self._h2d(ban), self._h2d(redo), greedy, temp,
                    top_k, top_p, keys)
                both = torch.stack((ids, ok.to(torch.int32))).cpu()
                ids_h, ok_h = both[0].numpy(), both[1].numpy().astype(bool)

            for b in sorted(pending):
                ctx.clean = False
                st = slot_state[b]
                row = masked[b].float().cpu().numpy()
                nxt = self._fallback_exact(st, row, st.steps)
                if nxt is None:
                    st.done = True
                    st.finish_reason = "mask_exhausted"
                else:
                    committed[b] = nxt
                pending.discard(b)
        return committed, ctr

    def _select_tokens(self, logits, slot_state, pending: set,
                       seeds, greedy, temp, top_k, top_p, obs=None):
        """Token selection without overlap (the paged feed loop): dispatch
        then resolve on a [B, V] logits matrix -> (committed, counters)."""
        ctx = self._select_dispatch(logits, slot_state, pending, seeds,
                                    greedy, temp, top_k, top_p, obs=obs)
        return self._select_resolve(ctx, slot_state, seeds, greedy, temp,
                                    top_k, top_p, obs=obs)

    def generate(self, requests: list[Request], verbose: bool = False):
        """Continuous batching over `self.slots` slots: per engine step
        ONE [B, V] decode, ONE fused mask+sample call and only [B]-sized
        transfers back to the host. With `overlap` the next step's
        forward is queued with the on-device ids before the host syncs.
        In paged mode the same selection runs behind the paged feed loop
        (chunked prefill, prefix sharing, page-table attention)."""
        from .loop import ListSource, StepLoop, make_mode
        loop = StepLoop(self, make_mode(self), ListSource(requests),
                        verbose=verbose)
        return loop.run()

    # ============================= paged path =============================
    # One global page pool per attention layer replaces the dense per-slot
    # caches; slots read and write through refcounted page tables.
    # Admission chain-hashes the prompt at page granularity and attaches
    # matching shared pages instead of prefilling them again; the rest
    # drains as chunked prefill through the per-step span feed that
    # decoding slots ride at width 1.

    def _paged_setup(self, B):
        """Fresh allocator + zeroed page pools for one run."""
        alloc = PagedAllocator(self.num_pages, self.page_size, B,
                               self.max_pages)
        with self._sharding():      # a rank's share of a split pool
            return alloc, self.model.init_paged_caches(self.num_pages,
                                                       self.page_size)

    def _decode_caches(self, B):
        """Zeroed dense decode caches for B slots (a rank's share under a
        trunk split)."""
        with self._sharding():
            return self.model.init_decode_caches(B, self.max_len)

    def _admit_paged(self, req: Request, b: int, alloc, ids=None):
        """Paged admission: no prefill call here. The prompt attaches
        shared pages where its page-aligned prefix chain-hash hits; the
        rest becomes feed backlog for the chunked-prefill span steps."""
        st = RequestState(req=req, slot=b)
        st.constraint = self._make_constraint(req)
        if ids is None:
            ids = self._request_ids(req)
        st.token_ids = list(ids)
        st.pos = len(ids)
        st.prompt_len = len(ids)
        plan = alloc.admit(b, ids)
        st.write_from = plan.write_from
        return st, plan

    def _paged_can_admit(self, alloc, req, ids_cache) -> bool:
        """Admit a request only when its whole prompt's pages can be
        reserved (prefix hits reduce the need). Token ids are cached by
        rid, so a request blocked for many steps is tokenized once."""
        ids = ids_cache.get(req.rid)
        if ids is None:
            ids = ids_cache[req.rid] = self._request_ids(req)
        return alloc.can_admit(len(ids))

    def _paged_wake(self, alloc, b, st, feed_pos, waiting) -> bool:
        """Re-check a slot waiting on shared prefix pages another slot is
        still filling; on wake adopt the (possibly lowered) feed and write
        cursors. True = slot live."""
        if not waiting[b]:
            return True
        r = alloc.ready(b)
        if r is None:
            return False
        waiting[b] = False
        feed_pos[b], st.write_from = r
        return True

    def _feed_width(self, pend: list) -> int:
        """Smallest feed bucket covering the widest per-slot backlog,
        capped at prefill_chunk (steady-state decode rides width 1)."""
        cands = [s for s in FEED_BUCKETS if s <= self.prefill_chunk] or [1]
        top = max(pend)
        for S in cands:
            if S >= top:
                return S
        return cands[-1]

    def _prepare_feed(self, alloc, caches, b, st, fs, k):
        """Reserve/COW pages for slot b's feed of positions [fs, fs+k)
        (only [max(fs, write_from), fs+k) is written) and apply the
        copy-on-write page copies in place. Returns the caches, or None
        when the pool is exhausted: the request then finishes 'kv_oom'."""
        ws = max(fs, st.write_from)
        if fs + k > ws:
            try:
                for s_, d_ in alloc.prepare_write(b, ws, fs + k):
                    self.copy_page(caches, s_, d_)
            except PoolExhausted:
                st.done = True
                st.finish_reason = "kv_oom"
                return None
        return caches

    def _kv_stats(self, stats: EngineStats, alloc) -> EngineStats:
        stats.kv_pages_in_use = alloc.pages_in_use
        stats.kv_peak_utilization = alloc.peak_in_use / max(alloc.P, 1)
        stats.prefix_hit_rate = alloc.prefix_hit_rate
        stats.kv_page_allocs = alloc.total_allocs
        stats.kv_evictions = alloc.evictions
        stats.kv_cow_copies = alloc.cow_copies
        return stats

    # ========================== speculative path ==========================
    # Jump-forward (grammar-forced tokens committed with no model call) +
    # draft-verify (host proposer drafts, one [B, S, V] span decode + mask
    # + select verifies the window). Greedy speculation gives generate()'s
    # tokens: forced tokens are the masked argmax's only support point,
    # accepted drafts equal the plain engine's selections, and the demote
    # path replays the same order.

    def _resolve_span_selection(self, st: RequestState, masked_dev, b: int,
                                idx: int, proposed: int, row_ok: bool,
                                salt: int) -> Optional[int]:
        """Validate one span selection against the exact oracle, demoting
        invalid picks in generate()'s order (4 demote rounds, then the
        exact-filter fallback). The [V] masked row comes to the host only
        when the first pick fails."""
        gc = st.constraint
        if gc is None:
            return proposed
        row = None
        t = proposed
        if row_ok:
            for attempt in range(4):
                if t == EOS_ID or gc.is_valid_extension(st.generated, t):
                    return t
                if row is None:
                    row = masked_dev[b, idx].float().cpu().numpy()
                row[t] = NEG_INF
                if not (row > NEG_INF / 2).any():
                    break
                if st.req.decode.method == "greedy":
                    t = int(np.argmax(row))
                else:
                    # host-side redraw over the demoted row (the
                    # reference's own numpy stream)
                    temp = max(st.req.decode.temperature, 1e-6)
                    r = row.astype(np.float64)
                    finite = r > NEG_INF / 2
                    p = np.where(finite, np.exp((r - r[finite].max())
                                                / temp), 0.0)
                    p /= p.sum()
                    rng = np.random.default_rng(
                        (st.req.seed * 1000003 + st.steps * 31
                         + salt * 7 + attempt) & 0xFFFFFFFF)
                    t = int(rng.choice(len(r), p=p))
        if row is None:
            row = masked_dev[b, idx].float().cpu().numpy()
        return self._fallback_exact(st, row, salt)

    @staticmethod
    def _choose_span(desired: list) -> int:
        """Span bucket maximizing committed tokens per unit of compute: a
        width-S span costs ~B*S model work and serves min(d, S) positions
        per slot; the +0.3 models the fixed per-step overhead."""
        top = max(desired)
        best, best_score = 1, -1.0
        for S in SPAN_BUCKETS:
            score = sum(min(d, S) for d in desired) / (S + 0.3)
            if score > best_score:
                best, best_score = S, score
            if S >= top:
                break
        return best

    def _span_keys(self, seeds: np.ndarray,
                   salts: np.ndarray, S: int) -> np.ndarray:
        """[B, S, 2] uint32 key data: one stream per (slot, span
        position), advanced by the slot's own step counter, so a slot's
        sample stream depends only on its own progress. Greedy rows
        ignore keys."""
        B = seeds.shape[0]
        k = np.empty((B, S, 2), np.uint32)
        k[:, :, 0] = seeds[:, None]
        k[:, :, 1] = ((salts.astype(np.uint32)[:, None] << np.uint32(6))
                      + np.arange(S, dtype=np.uint32)[None, :])
        return k

    def generate_speculative(self, requests: list[Request],
                             spec: Optional[SpecConfig] = None,
                             verbose: bool = False):
        """Continuous batching with grammar-aware speculation: per step
        each slot chases grammar-forced tokens, then drafts up to
        `spec.draft_k` oracle-vetted tokens; one span decode replays the
        forced tokens and scores the drafts of every slot at once, one
        span mask + select (`masked_logits_span`) picks at every
        position, and each slot accepts its longest matching draft prefix
        plus a bonus token. Over paged caches when `paged=True`."""
        from .loop import ListSource, SpecMode, StepLoop
        loop = StepLoop(self, SpecMode(self, spec), ListSource(requests),
                        verbose=verbose)
        return loop.run()

    # =========================== sequential path ==========================
    # The original one-request-at-a-time engine (paper Algorithm 3,
    # round-robin): the baseline the batched engine is measured against.

    def _start(self, req: Request) -> RequestState:
        st = RequestState(req=req)
        st.constraint = self._make_constraint(req)
        ids = self._prompt_ids(req)
        prompt, n = self._bucketed_prompt(ids)
        logits, st.caches = self._prefill(prompt, n)
        st.pos = n
        st.token_ids = list(ids)
        st.pending_logits = logits[:, n - 1]    # prediction for next token
        return st

    def _logits(self, st: RequestState):
        """-> [1, V] on the device ([1, V_s], this rank's block, under a
        split vocabulary)."""
        if st.pending_logits is not None:
            lg, st.pending_logits = st.pending_logits, None
            return lg
        tok = self._h2d(np.array([st.token_ids[-1]], np.int32))
        pos = self._h2d(np.array([st.pos - 1], np.int32))
        return self._decode(st.caches, tok, pos)

    def _select(self, st: RequestState, logits, attempt: int) -> int:
        """One draw of the request's decode config; sampled draws take the
        noise of key (seed, step, attempt), one key per request step and
        draw."""
        noise = None
        if st.req.decode.method != "greedy":
            noise = self._noise(self._step_keys(
                np.array([st.req.seed & 0xFFFFFFFF], np.uint32),
                np.array([st.steps], np.uint32), attempt))
        return int(st.req.decode.select(logits, noise)[0])

    def _step(self, st: RequestState, obs=None) -> None:
        if obs is None:
            obs = _OBS_OFF
        logits = self._logits(st)
        st.steps += 1
        req = st.req
        if st.constraint is None:
            self._commit(st, self._select(st, self._gather(logits), 0))
            return

        gc = st.constraint
        text = st.generated
        if self.opportunistic:
            with obs.span("opportunistic"):
                proposal = self._select(st, self._gather(logits), 0)
                hit = gc.is_valid_extension(text, proposal)
            if hit:
                st.opportunistic_hits += 1
                self._commit(st, proposal)
                return

        with obs.span("ci_lookup") as sp_rows:
            sg = gc.step_groups(text)
            rlist = gc.group_rows(sg.groups)
            off = self._row_offset[req.grammar]
            rows = np.full((1, accept_width(len(rlist), gc.max_accept)),
                           -1, np.int32)
            rows[0, :len(rlist)] = [r + off for r in rlist]
            eos = np.array([sg.eos_allowed])
        with obs.span("cd_check") as sp_cd:
            cdw = gc.cd_overlay(sg.groups)
            cd = None if cdw is None else self._h2d(
                self._words_local(cdw[None, :]).view(np.int32))
        with obs.span("mask_dispatch") as sp_disp:
            masked = self._gather(apply_grammar_mask_shard(
                logits, self._store_cat, self._h2d(rows),
                self._h2d(eos), self._vs, cd=cd))
        st.mask_time += sp_rows.dur + sp_cd.dur + sp_disp.dur
        st.mask_computations += 1

        # rejection wrapper (see _select_resolve for the batched variant);
        # `masked` is a host buffer demoted in place below, so each draw
        # ships a private copy
        masked = masked.float().cpu().numpy()
        for attempt in range(1, 5):
            # reprolint: dispatch
            nxt = self._select(st, self._h2d(masked.copy()), attempt)
            if masked[0, nxt] <= NEG_INF / 2:
                break
            if nxt == EOS_ID or gc.is_valid_extension(text, nxt):
                self._commit(st, nxt)
                return
            masked[0, nxt] = NEG_INF

        allowed = np.where(masked[0] > NEG_INF / 2)[0]
        for t in allowed:
            if not (t == EOS_ID or gc.is_valid_extension(text, int(t))):
                masked[0, t] = NEG_INF
        if (masked[0] > NEG_INF / 2).any():
            # reprolint: dispatch
            nxt = self._select(st, self._h2d(masked.copy()), 5)
            self._commit(st, nxt)
            return
        # nothing valid (should not happen for C_k in L_p(G)) — stop
        st.done = True
        st.finish_reason = "mask_exhausted"

    def generate_sequential(self, requests: list[Request],
                            verbose: bool = False):
        """Round-robin stepping, one request per device call."""
        obs = Telemetry(enabled=self.telemetry_enabled)
        t0 = time.perf_counter()
        states = [self._start(r) for r in requests]
        active = list(states)
        while active:
            for st in list(active):
                self._step(st, obs)
                if st.done:
                    active.remove(st)
                    if verbose:
                        print(f"[req {st.req.rid}] {st.finish_reason}: "
                              f"{st.generated[:70]!r}")
        stats = EngineStats(
            requests=len(states),
            tokens=sum(s.steps for s in states),
            wall=time.perf_counter() - t0,
            mask_time=sum(s.mask_time for s in states),
            mask_computations=sum(s.mask_computations for s in states),
            opportunistic_hits=sum(s.opportunistic_hits for s in states),
            decode_steps=sum(s.steps for s in states),
            batch_slots=1,
            mesh_devices=self.mesh.size if self.mesh is not None else 1,
        )
        return states, stats
