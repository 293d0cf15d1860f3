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
  * sampled ids are verified against the exact parser oracle; invalid
    picks are banned and their rows resampled through the same fused op
    (unconstrained, rows = -1), with an exact host filter as the last
    resort, so emitted text stays in L_p(G),
  * finished requests free their slot and the next queued request is
    admitted immediately.

The step body lives in `serving/loop.py` (DenseMode, with host/device
overlap). Sampling draws standard-Gumbel noise through an injectable
`noise_fn(keys [B, 2] uint32, V) -> [B, V] f32 tensor`; the default
draws on the device from a torch.Generator per slot seeded by the slot's
(seed, step, attempt) key, so a slot's stream depends only on its own
progress.

Not ported here: mesh/tensor-parallel serving, paged KV, speculation,
the sequential path and opportunistic masking.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..core.constrain import GrammarConstraint, MAX_ACCEPT
from ..core.decoding import DecodeConfig, NEG_INF
from ..core.tokenizer import BOS_ID, ByteTokenizer, EOS_ID
from ..device import resolve_device
from ..kernels.fused_select.ops import fused_mask_select, gumbel_noise
from ..obs import Telemetry

# shared disabled telemetry: the `obs=None` default of the selection
# helpers — span() returns the no-op NULL_SPAN
_OBS_OFF = Telemetry(enabled=False)


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
    pos: int = 0
    generated: bytes = b""
    token_ids: list = field(default_factory=list)
    constraint: Optional[GrammarConstraint] = None
    done: bool = False
    finish_reason: str = ""
    mask_time: float = 0.0
    mask_computations: int = 0
    steps: int = 0
    slot: int = -1
    prompt_len: int = 0
    deadline_at: Optional[float] = None     # perf_counter() expiry
    admit_t: Optional[float] = None         # perf_counter() at admission


@dataclass
class EngineStats:
    requests: int = 0
    tokens: int = 0
    wall: float = 0.0
    mask_time: float = 0.0
    mask_computations: int = 0
    decode_steps: int = 0                   # CONSUMED batched [B,V] steps
    batch_slots: int = 0
    overlap_dispatched: int = 0             # speculative forwards launched
    overlap_hits: int = 0                   # ...that the next step consumed
    device_forward_s: float = 0.0           # synced forward intervals
    device_mask_sample_s: float = 0.0       # synced mask+sample intervals
    overlap_hidden_s: float = 0.0
    attribution: Optional[dict] = None

    @property
    def tokens_per_sec(self):
        return self.tokens / max(self.wall, 1e-9)

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
                 slots: int = 4, overlap: bool = True,
                 grammar_mode: str = "grammar_mask",
                 telemetry: bool = True, devtime: bool = False,
                 noise_fn: Optional[Callable] = None, device="cuda"):
        """grammar_bundles: name -> (grammar, table, store).
        slots: decode-pool width B. overlap: dispatch step k+1's forward
        with the on-device ids before the host validates step k
        (serving/loop.py); token-for-token identical either way.
        devtime: bench/profile mode — device spans synchronize on exit.
        noise_fn(keys [B,2] uint32 numpy, V) -> [B,V] f32 tensor on the
        engine's device; default `gumbel_noise` on that device.
        device: where params live and the engine runs ("cuda" by
        default; raises without a card unless "cpu" is asked for)."""
        if grammar_mode not in GrammarConstraint.MODES:
            raise ValueError(f"unknown grammar_mode {grammar_mode!r}; "
                             f"expected one of {GrammarConstraint.MODES}")
        self.device = resolve_device(device)
        pdev = params["embed_block"]["embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.tok = tokenizer
        self.bundles = dict(grammar_bundles)
        self.grammar_mode = grammar_mode
        self.max_len = max_len
        self.slots = max(1, int(slots))
        self.overlap = bool(overlap)
        self.telemetry_enabled = bool(telemetry)
        self.devtime_enabled = bool(devtime)
        vocab = model.cfg.vocab_size
        self.noise_fn = noise_fn or (
            lambda keys, V: gumbel_noise(keys, V, self.device))
        self._vocab = vocab
        self._noise_cache = None    # (keys bytes, [B, V] device noise)
        self._row_offset: dict[str, int] = {}
        self._rebuild_store_cat()

    def _rebuild_store_cat(self):
        """Build the concatenated device store from self.bundles (the
        store lives on the device exactly once; a request's rows index
        its grammar's block via the per-grammar row offset)."""
        self._row_offset = {}
        parts, off = [], 0
        for name, b in self.bundles.items():
            self._row_offset[name] = off
            parts.append(b[2].packed)
            off += b[2].packed.shape[0]
        words = (self.tok.vocab_size + 31) // 32
        cat = (np.concatenate(parts, axis=0) if parts
               else np.zeros((1, words), np.uint32))
        self._store_cat = torch.from_numpy(
            np.ascontiguousarray(cat).view(np.int32)).to(self.device)

    def _h2d(self, x: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device. The array is
        copied first (pinned on the card, so the copy is asynchronous and
        never waits for queued device work); callers pass arrays nobody
        mutates afterwards, or `.copy()`s."""
        t = torch.from_numpy(np.ascontiguousarray(x).copy())
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------ device steps ---------------------------

    def _decode(self, caches, token, pos):
        """One [B] decode step; writes `caches` in place -> logits [B,V]."""
        logits, _ = self.model.decode_step(self.params, caches, token, pos)
        return logits

    def _prefill(self, prompt, n):
        return self.model.prefill(self.params, {"tokens": prompt},
                                  cache_len=self.max_len, true_len=n)

    def _resample(self, masked, ban, redo, greedy, temp, top_k, top_p,
                  keys):
        """Ban one id per `redo` row, then select again through the same
        fused op, unconstrained (rows = -1): the card runs no second
        selector. -> (masked, ids, ok)."""
        B, V = masked.shape
        dev = self.device
        hit = (torch.arange(V, device=dev)[None, :] == ban[:, None]) & \
            redo[:, None]
        masked = masked.masked_fill(hit, NEG_INF)
        noise = None if bool(np.all(greedy)) else self._noise(keys)
        ids, masked, ok = fused_mask_select(
            masked, self._store_cat,
            torch.full((B, 1), -1, dtype=torch.int32, device=dev), None,
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev),
            self._h2d(greedy), self._h2d(temp), self._h2d(top_k),
            self._h2d(top_p), noise=noise)
        return masked, ids, ok

    def _noise(self, keys: np.ndarray) -> torch.Tensor:
        return self.noise_fn(keys, self._vocab)

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

    def _admit_common(self, req: Request, b: int, caches):
        """Build request state, prefill the prompt and insert its caches
        into slot b of `caches` IN PLACE. -> state."""
        st = RequestState(req=req, slot=b)
        st.constraint = self._make_constraint(req)
        ids = self._request_ids(req)
        prompt, n = self._bucketed_prompt(ids[:-1])
        _, pc = self._prefill(prompt, n)
        for full_g, one_g in zip(caches, pc):
            for full, one in zip(full_g, one_g):
                for name in full:
                    full[name][:, b] = one[name][:, 0]
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
        """Phase A of token selection: host row building and the fused
        mask+sample DISPATCH — nothing is synced. Returns a `_SelectCtx`
        whose `.ids` device tensor the overlap path feeds into the next
        forward before the host ever sees it."""
        if obs is None:
            obs = _OBS_OFF
        # reprolint: mutated-inflight=greedy,temp,top_k,top_p admit() rewrites the decode configs while dispatches are in flight
        B = self.slots
        pending = set(pending)
        ctr = {"mask_computations": 0}
        salts = np.array([slot_state[b].steps if slot_state[b] else 0
                          for b in range(B)], np.uint32)
        ctx = _SelectCtx(committed={}, pending=pending, ctr=ctr,
                         salts=salts)
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
            cd = GrammarConstraint.cd_overlay_batch(
                cons, groups, int(self._store_cat.shape[1]))
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
                ctx.ids, ctx.masked, ctx.ok = fused_mask_select(  # reprolint: dispatch
                    logits, self._store_cat, self._h2d(rows.copy()),
                    self._h2d(cd.view(np.int32).copy()),
                    self._h2d(eos.copy()), self._h2d(need_mask.copy()),
                    self._h2d(greedy.copy()), self._h2d(temp.copy()),
                    self._h2d(top_k.copy()), self._h2d(top_p.copy()),
                    noise=noise)
            dv.done((ctx.ids, ctx.ok))
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

    def generate(self, requests: list[Request], verbose: bool = False):
        """Continuous batching over `self.slots` slots: per engine step
        ONE [B, V] decode, ONE fused mask+sample call and only [B]-sized
        transfers back to the host. With `overlap` the next step's
        forward is queued with the on-device ids before the host syncs."""
        from .loop import ListSource, StepLoop, make_mode
        loop = StepLoop(self, make_mode(self), ListSource(requests),
                        verbose=verbose)
        return loop.run()
