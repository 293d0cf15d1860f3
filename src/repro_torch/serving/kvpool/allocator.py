"""Host-side page allocator for the paged KV-cache subsystem.

The device holds ONE global page pool per attention layer
(`[num_pages, page_size, K, Dh]`, see `Model.init_paged_caches`); this
allocator owns every piece of host metadata that decides which slot may
touch which page:

  * **page tables** — per-slot ordered page lists; the token at logical
    position p of slot b lives at (tables[b][p // ps], p % ps),
  * **refcounts** — a page is shared by any number of slots plus
    (optionally) the prefix cache; it returns to the free list only when
    the last reference drops,
  * **prefix cache** — prompt token-id chunks are chain-hashed at page
    granularity (key_i = (key_{i-1}, chunk_i), so a hit at depth i
    guarantees the whole prefix matches); admission attaches every
    matching full page instead of re-prefilling it, and registers its
    own full prompt pages so later admissions can attach them — even
    while this slot is still filling them (readiness is gated by
    `ready()` until the writer's chunked prefill catches up),
  * **copy-on-write** — `prepare_write` never lets a slot write a page
    another reference can see: a shared page overlapping the write range
    is swapped for a fresh page (with a device copy only when the write
    starts mid-page, i.e. older content in the page must survive);
    `fork` clones a slot's table by just bumping refcounts,
  * **eviction** — cached pages whose only reference is the cache itself
    ("cold") are kept as a reuse pool and evicted LRU-first when the
    free list runs dry; truly exhausted allocation raises
    `PoolExhausted`, which the engine turns into a graceful per-request
    `kv_oom` finish.

The allocator never touches device memory: `prepare_write` returns the
(src, dst) page copies the engine must apply to the pools, and
everything else is pure bookkeeping — which is what makes it
shadow-testable (tests/test_kvpool.py fuzzes it against a dense shadow
cache).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field


class PoolExhausted(RuntimeError):
    """No free page and nothing cold to evict."""


@dataclass
class AdmitPlan:
    """What the engine must do to finish admitting a prompt.

    matched_len: positions [0, matched_len) are attached shared pages —
        already (or about to be) filled by an earlier admission.
    feed_from:   first position the engine must feed through the model
        (min(matched_len, plen - 1): at least the last prompt token is
        re-fed, read-only, to produce the first selection logits).
    write_from:  first position whose KV the engine may write
        (= matched_len; positions below are shared pages). May be
        lowered later by `ready()` if this slot claims orphaned pages.
    """
    matched_len: int
    feed_from: int
    write_from: int


@dataclass
class _SlotMeta:
    plen: int
    n_attached: int
    feed_from: int
    write_from: int


class PagedAllocator:
    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int):
        self.P = int(num_pages)
        self.ps = int(page_size)
        self.slots = int(slots)
        self.max_pages = int(max_pages_per_slot)
        self.refcount = [0] * self.P
        self.free: deque[int] = deque(range(self.P))
        self.tables: list[list[int]] = [[] for _ in range(self.slots)]
        self.meta: dict[int, _SlotMeta] = {}
        # prefix cache: chain key -> page, page -> chain key
        self._cached: dict = {}
        self._rev: dict[int, object] = {}
        self._cold: OrderedDict[int, None] = OrderedDict()  # LRU order
        self.full: list[bool] = [False] * self.P
        self.writer: dict[int, int] = {}     # page -> slot filling it
        # stats
        self.total_allocs = 0
        self.evictions = 0
        self.cow_copies = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.peak_in_use = 0

    # ------------------------------ stats --------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.P - len(self.free)

    @property
    def cold_pages(self) -> int:
        return len(self._cold)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(self.prompt_tokens, 1)

    def available(self) -> int:
        """Pages allocatable right now (free + evictable cold)."""
        return len(self.free) + len(self._cold)

    def can_admit(self, prompt_len: int) -> bool:
        """Conservative check (ignores prefix hits, which only reduce
        the need): enough pages for the whole prompt plus one."""
        return self.available() >= self._pages_for(prompt_len + 1)

    def metrics(self) -> dict:
        """Point-in-time pool state for telemetry scrape-time gauges
        (obs.Telemetry.register_kv). Plain ints/floats only."""
        return {
            "pages_total": self.P,
            "pages_in_use": self.pages_in_use,
            "pages_free": len(self.free),
            "pages_cold": len(self._cold),
            "peak_in_use": self.peak_in_use,
            "prefix_hit_rate": self.prefix_hit_rate,
            "page_allocs": self.total_allocs,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prompt_tokens,
        }

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.ps)

    # --------------------------- page lifecycle --------------------------

    def _alloc(self) -> int:
        if self.free:
            p = self.free.popleft()
        elif self._cold:
            victim, _ = self._cold.popitem(last=False)      # LRU first
            self._deregister(victim)
            self.refcount[victim] -= 1                      # cache's ref
            assert self.refcount[victim] == 0, "cold page was referenced"
            self.evictions += 1
            p = victim
        else:
            raise PoolExhausted(
                f"KV page pool exhausted ({self.P} pages of {self.ps})")
        self.refcount[p] = 1
        self.full[p] = False
        self.total_allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return p

    def _deregister(self, p: int) -> None:
        key = self._rev.pop(p, None)
        if key is not None:
            self._cached.pop(key, None)
        self.writer.pop(p, None)

    def _decref(self, p: int) -> None:
        self.refcount[p] -= 1
        assert self.refcount[p] >= 0, "double free"
        if self.refcount[p] == 0:
            self._deregister(p)
            self._cold.pop(p, None)
            self.full[p] = False
            self.free.append(p)
        elif self.refcount[p] == 1 and p in self._rev:
            # cache-only reference
            if self.full[p]:
                self._cold[p] = None        # evictable, most recent last
                self._cold.move_to_end(p)
            elif p not in self.writer:
                # registered but its writer died before filling and no
                # waiter is attached: nobody will ever fill it — purge
                self._deregister(p)
                self.refcount[p] = 0
                self.full[p] = False
                self.free.append(p)

    def _attach(self, b: int, p: int) -> None:
        self.refcount[p] += 1
        self._cold.pop(p, None)             # warm again
        self.tables[b].append(p)

    # ------------------------------ admission ----------------------------

    def admit(self, b: int, ids: list[int]) -> AdmitPlan:
        """Build slot b's page table for prompt `ids`: attach every
        chain-matching cached full page, allocate + register the rest of
        the prompt's full pages (so concurrent admissions can share them
        while this slot chunk-prefills), and allocate the partial tail.
        All prompt pages are reserved up front, so a prefill in flight
        can never hit PoolExhausted (only generation growth can)."""
        assert not self.tables[b], f"slot {b} already admitted"
        ps = self.ps
        plen = len(ids)
        if self._pages_for(plen + 1) > self.max_pages:
            raise ValueError(
                f"prompt of {plen} tokens exceeds max_pages_per_slot="
                f"{self.max_pages} (page_size={ps})")
        n_full = plen // ps
        try:
            key = ()
            n_att = 0
            matching = True
            for i in range(n_full):
                key = (key, tuple(ids[i * ps:(i + 1) * ps]))
                if matching and key in self._cached:
                    self._attach(b, self._cached[key])  # prefix hit
                    n_att += 1
                    continue
                matching = False
                p = self._alloc()
                self.tables[b].append(p)
                self.writer[p] = b
                if key not in self._cached:  # may exist as a stale child
                    self._cached[key] = p    # of an evicted chain: keep it
                    self._rev[p] = key
                    self.refcount[p] += 1    # the cache's own reference
            while len(self.tables[b]) < self._pages_for(plen):
                self.tables[b].append(self._alloc())    # partial tail
        except PoolExhausted:
            self.release(b)
            raise
        matched = n_att * ps
        self.prompt_tokens += plen
        self.prefix_hit_tokens += min(matched, plen - 1)
        self.meta[b] = _SlotMeta(plen=plen, n_attached=n_att,
                                 feed_from=min(matched, plen - 1),
                                 write_from=matched)
        return AdmitPlan(matched_len=matched,
                         feed_from=self.meta[b].feed_from,
                         write_from=matched)

    def ready(self, b: int):
        """None = the slot's attached shared pages are still being
        filled by another slot's chunked prefill — keep waiting.
        Otherwise (feed_from, write_from): go. write_from drops below
        the admit plan's only if an attached page was orphaned (its
        writer released before filling it); this slot then claims the
        remaining prefix pages and re-feeds them itself."""
        m = self.meta[b]
        for i in range(m.n_attached):
            p = self.tables[b][i]
            if self.full[p]:
                continue
            w = self.writer.get(p)
            if w is not None and w != b:
                return None                 # live writer: wait
            # claim the contiguous orphaned run only — a page further
            # on with a live writer keeps its writer (we wait on it,
            # or COW off it, when our refill frontier gets there)
            for j in range(i, m.n_attached):
                pj = self.tables[b][j]
                if self.full[pj]:
                    continue
                wj = self.writer.get(pj)
                if wj is not None and wj != b:
                    break
                self.writer[pj] = b
            m.write_from = min(m.write_from, i * self.ps)
            m.feed_from = min(m.feed_from, m.write_from)
            break
        return (m.feed_from, m.write_from)

    # ------------------------------- writes ------------------------------

    def prepare_write(self, b: int, start: int, end: int
                      ) -> list[tuple[int, int]]:
        """Make positions [start, end) of slot b writable: grow the page
        table to cover `end`, and copy-on-write any shared page in the
        write range. Returns (src, dst) device page copies the engine
        must apply BEFORE the write (non-empty only when the write
        starts mid-page inside a shared page, so older content in that
        page must survive; shared pages fully covered by the write are
        simply replaced). Raises PoolExhausted under true pressure.

        ATOMIC: every allocation this call needs (growth + COW
        replacements) is counted against `available()` up front, and the
        failure path acquires nothing. A mid-call failure used to leave
        the grown head of a multi-page feed referenced in the table and
        its completed COW swaps stripped of their pending device copies
        — harmless for a caller that immediately finishes the request
        (release() returns the pages), but a page-refcount leak plus a
        garbage-head page for any caller that keeps the slot alive
        after catching PoolExhausted."""
        t = self.tables[b]
        need = self._pages_for(end)
        if need > self.max_pages:
            raise ValueError(
                f"slot {b} needs {need} pages > max {self.max_pages}")
        ps = self.ps
        # clamp: a write range ending inside an already-longer table has
        # negative headroom, which must not offset the COW count below
        grow = max(0, need - len(t))
        cow = sum(1 for i in range(start // ps, min(len(t), need))
                  if self.refcount[t[i]] > 1 and self.writer.get(t[i]) != b)
        if grow + cow > self.available():
            raise PoolExhausted(
                f"KV page pool exhausted ({self.P} pages of {self.ps}; "
                f"feed needs {grow} new + {cow} COW, "
                f"{self.available()} allocatable)")
        while len(t) < need:
            t.append(self._alloc())
        copies = []
        for i in range(start // ps, need):
            p = t[i]
            if self.refcount[p] > 1 and self.writer.get(p) != b:
                new = self._alloc()
                if i * ps < start:           # partial overlap: keep head
                    copies.append((p, new))
                    self.cow_copies += 1
                self._decref(p)
                t[i] = new
        return copies

    def note_fill(self, b: int, frontier: int) -> None:
        """Slot b has written every position < frontier. Pages it is the
        designated writer of become full (and shareable) once the
        frontier crosses their end."""
        ps = self.ps
        for i, p in enumerate(self.tables[b]):
            if (i + 1) * ps > frontier:
                break
            if self.writer.get(p) == b:
                self.full[p] = True
                del self.writer[p]

    # ------------------------------ fork / free --------------------------

    def fork(self, src: int, dst: int) -> None:
        """Clone slot src's table into empty slot dst by reference:
        zero device copies now; later writes COW via prepare_write.
        The fork carries NO wait/claim semantics (n_attached = 0):
        ready(dst) must never claim writer rights over src's pages,
        or prepare_write would skip the COW and let dst clobber them."""
        assert not self.tables[dst], f"slot {dst} already in use"
        for p in self.tables[src]:
            self._attach(dst, p)
        m = self.meta.get(src)
        if m is not None:
            self.meta[dst] = _SlotMeta(
                plen=m.plen, n_attached=0,
                feed_from=m.feed_from, write_from=m.write_from)

    def release(self, b: int) -> None:
        for p in self.tables[b]:
            if self.writer.get(p) == b and not self.full[p]:
                del self.writer[p]          # orphan: waiters may claim
            self._decref(p)
        self.tables[b] = []
        self.meta.pop(b, None)

    # ------------------------------ views --------------------------------

    def table_rows(self, np_mod):
        """[slots, max_pages] int32 page-table matrix (-1 = unmapped),
        ready to ship to device next to the span call."""
        out = np_mod.full((self.slots, self.max_pages), -1, np_mod.int32)
        for b, t in enumerate(self.tables):
            if t:
                out[b, :len(t)] = t
        return out

    def check_invariants(self) -> None:
        """Debug/fuzz hook: refcounts must equal observed references,
        free pages must be unreferenced, cold pages cache-only."""
        refs = [0] * self.P
        for t in self.tables:
            for p in t:
                refs[p] += 1
        for p in self._rev:
            refs[p] += 1
        assert refs == self.refcount, (refs, self.refcount)
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "free list duplicates"
        for p in free_set:
            assert self.refcount[p] == 0
        for p in self._cold:
            assert self.refcount[p] == 1 and p in self._rev and self.full[p]
