"""The port's AsyncEngine (`repro_torch.serving.async_engine`, one
persistent StepLoop on a background thread over a live QueueSource)
against the reference's AsyncEngine, on the narrow syncode-demo of
tests/test_async_engine.py (2 layers, d_model 128, vocab 1024) in fp32,
with the reference's `Model.init(PRNGKey(0))` weights bridged into the
port (tests/_torch_parity.py).

Token ids and finish reasons are compared exactly, for dense, paged and
speculative serving: greedy on all six builtin grammars, and sampled
with the port's `noise_fn` handing it the reference's own Gumbel noise.
The lifecycle cases of tests/test_async_engine.py run against the port
itself: streamed chunks join to the batch output, live admission,
cancel (dense and paged: slot and pages freed), cancel while queued,
deadline, abort, the grammar-mode override, and hot grammar loading
with its refusals."""
import asyncio

import pytest

from repro.core.grammars import BUILTIN
from repro.serving.async_engine import AsyncEngine as JaxAsyncEngine
from repro.spec import SpecConfig as JaxSpecConfig
from repro_torch.core.decoding import DecodeConfig
from repro_torch.core.tokenizer import EOS_ID
from repro_torch.serving.async_engine import AsyncEngine
from repro_torch.serving.engine import Engine, Request
from repro_torch.spec import SpecConfig
from tests._torch_parity import (NARROW, assert_valid, build_sides, engines,
                                 requests, tokens)

MAX_LEN = 160


@pytest.fixture(scope="module")
def sides():
    return build_sides(**NARROW)


@pytest.fixture(scope="module")
def make(sides):
    """make(grammars=None, **kw) -> a port engine on the bridged
    weights (4 slots unless asked)."""
    _, _, _, _, tm, tp, ttok, tb = sides

    def make_engine(grammars=None, **kw):
        kw.setdefault("slots", 4)
        bs = tb if grammars is None else {k: tb[k] for k in grammars}
        return Engine(tm, tp, ttok, bs, max_len=MAX_LEN, device="cpu", **kw)
    return make_engine


def _specs(grammar, n=3, max_new=14, method="sample", seed0=0):
    return [(seed0 + i, grammar, b"Q: generate. A:", max_new, method, 1.0,
             None, None) for i in range(n)]


def _reqs(grammar, **kw):
    return requests(_specs(grammar, **kw))[1]


def _run_async(engine, reqs, cls=AsyncEngine, **kw):
    async def go():
        aeng = cls(engine, **kw)
        try:
            states, stats = await aeng.generate(reqs)
        finally:
            await aeng.drain()
        return states, stats
    return asyncio.run(go())


def _both(sides, specs, sampled=False, spec=None, **kw):
    """Run the reference's and the port's AsyncEngine on the same
    requests and assert identical tokens. -> (port states, port stats)."""
    jeng, teng = engines(sides, MAX_LEN, sampled=sampled, slots=4, **kw)
    jreqs, treqs = requests(specs)
    jspec = None if spec is None else JaxSpecConfig(**spec)
    tspec = None if spec is None else SpecConfig(**spec)
    jstates, jstats = _run_async(jeng, jreqs, JaxAsyncEngine, spec=jspec)
    tstates, tstats = _run_async(teng, treqs, spec=tspec)
    assert tokens(tstates) == tokens(jstates)
    assert tstats.tokens == jstats.tokens
    assert_valid(tstates, sides[7])
    return tstates, tstats


# ----------------------- parity with the reference ----------------------

# engine keywords and SpecConfig fields of each serving mode
MODES = {"dense": ({}, None),
         "paged": ({"paged": True, "page_size": 8}, None),
         "speculative": ({}, {"literal_jump": False}),
         "speculative_paged": ({"paged": True, "page_size": 8},
                               {"literal_jump": False})}
PROMPTS = (b"x = ", b"1+", b"SELECT a", b"say:", b"{", b"def f():")


@pytest.mark.parametrize("mode", MODES)
def test_async_greedy_all_grammars_matches_reference(sides, mode):
    """Two greedy requests per builtin grammar in one pool of 4 slots
    (admissions land mid-run on the live queue), plus one unconstrained
    request."""
    kw, spec = MODES[mode]
    specs = [(2 * i + j, g, p if j == 0 else b"Q: generate. A:", 12,
              "greedy", 1.0, None, None)
             for i, (g, p) in enumerate(zip(BUILTIN, PROMPTS))
             for j in range(2)] + [(12, None, b"free", 6, "greedy", 1.0,
                                    None, None)]
    _, stats = _both(sides, specs, spec=spec, **kw)
    assert stats.requests == len(specs)


@pytest.mark.parametrize("mode", MODES)
def test_async_sampled_matches_reference(sides, mode):
    """Sampled decoding with the reference's Gumbel noise handed to the
    port (`noise_fn`): every grammar, assorted temperature, top-k and
    top-p."""
    kw, spec = MODES[mode]
    specs = [(0, "json", b"", 14, "sample", 1.0, None, 0.95),
             (1, "calc", b"1+", 12, "sample", 0.7, 20, None),
             (2, "jsonmsg", b"", 14, "sample", 1.0, None, None),
             (3, "sql", b"SELECT", 12, "sample", 1.3, None, 1.0),
             (4, "minilang", b"", 12, "sample", 0.9, 40, 0.9),
             (5, "python_mini", b"", 12, "sample", 1.1, None, None),
             (6, None, b"free", 6, "sample", 1.0, None, None)]
    _both(sides, specs, sampled=True, spec=spec, **kw)


# --------------------- the port against itself ------------------------

def test_async_identical_to_sync(make):
    eng = make()
    ss, _ = eng.generate(_reqs("json", n=2 * eng.slots + 3, seed0=20))
    as_, stats = _run_async(eng, _reqs("json", n=2 * eng.slots + 3,
                                       seed0=20))
    assert tokens(as_) == tokens(ss)
    assert stats.requests == 2 * eng.slots + 3


def test_streamed_tokens_match_batch_output(make):
    eng = make()
    by_rid = {s.req.rid: s for s in eng.generate(
        _reqs("json", n=3, seed0=7))[0]}

    async def go():
        aeng = AsyncEngine(eng)
        handles = [aeng.submit(r) for r in _reqs("json", n=3, seed0=7)]
        try:
            for h in handles:
                ids, text = [], b""
                async for tid, tb in h.tokens():
                    ids.append(tid)
                    text += tb
                st = await h.result()
                ref = by_rid[h.req.rid]
                assert text == ref.generated == st.generated
                assert ids == [t for t in ref.token_ids[len(
                    eng._request_ids(h.req)):] if t != EOS_ID]
        finally:
            await aeng.drain()
    asyncio.run(go())


def test_live_admission_between_batches(make):
    """The persistent loop idles between submissions and serves later
    ones as a fresh sync run does."""
    eng = make()
    s1, _ = eng.generate(_reqs("calc", n=2, seed0=40))
    s2, _ = eng.generate(_reqs("json", n=2, seed0=50))

    async def go():
        aeng = AsyncEngine(eng)
        try:
            a1, _ = await aeng.generate(_reqs("calc", n=2, seed0=40))
            await asyncio.sleep(0.3)        # the loop goes idle
            a2, _ = await aeng.generate(_reqs("json", n=2, seed0=50))
            return a1, a2
        finally:
            await aeng.drain()
    a1, a2 = asyncio.run(go())
    assert tokens(a1) == tokens(s1)
    assert tokens(a2) == tokens(s2)


def _long(rid, seed, max_new=120):
    return Request(rid=rid, prompt=b"Q:", grammar="json",
                   max_new_tokens=max_new,
                   decode=DecodeConfig(method="sample", temperature=1.0),
                   seed=seed)


def test_cancel_mid_decode_frees_slot(make):
    eng = make()

    async def go():
        aeng = AsyncEngine(eng)
        try:
            h = aeng.submit(_long(0, 1))
            seen = 0
            async for _ in h.tokens():
                seen += 1
                if seen == 3:
                    h.cancel()
            st = await h.result()
            assert st.finish_reason == "cancelled"
            assert st.steps < 120
            assert not aeng._loop_obj.active()
            # the slot is free again: a fresh wave admits and runs
            ss, _ = await aeng.generate(_reqs("json", n=2, seed0=60))
            assert all(s.finish_reason in ("eos", "length", "max_len")
                       for s in ss)
        finally:
            await aeng.drain()
    asyncio.run(go())


def test_cancel_paged_frees_kv_pages(make):
    """Cancellation releases the slot's page table at the next step; a
    follow-up wave reuses the pool and matches the sync engine."""
    eng = make(paged=True, page_size=8)
    sync_states, _ = eng.generate(_reqs("json", n=3, seed0=70))

    async def go():
        aeng = AsyncEngine(eng)
        try:
            h = aeng.submit(_long(999, 5))
            async for _ in h.tokens():
                h.cancel()                   # cancel after the first token
            st = await h.result()
            assert st.finish_reason == "cancelled"
            alloc = aeng._loop_obj.mode.alloc
            assert all(len(t) == 0 for t in alloc.tables)
            assert all(rc >= 0 for rc in alloc.refcount)
            a, _ = await aeng.generate(_reqs("json", n=3, seed0=70))
            return a
        finally:
            await aeng.drain()
    assert tokens(asyncio.run(go())) == tokens(sync_states)


def test_cancel_queued_request_never_admits(make):
    eng = make()

    async def go():
        aeng = AsyncEngine(eng)
        try:
            longs = [aeng.submit(r) for r in _reqs(
                "json", n=eng.slots, max_new=60, seed0=80)]
            queued = aeng.submit(Request(
                rid=500, prompt=b"Q:", grammar="json", max_new_tokens=5,
                decode=DecodeConfig(method="greedy"), seed=0))
            queued.cancel()
            st = await queued.result()
            assert st.finish_reason == "cancelled"
            assert st.steps == 0 and st.generated == b""
            for h in longs:
                h.cancel()
        finally:
            await aeng.drain()
    asyncio.run(go())


def test_deadline_finishes_with_distinct_reason(make):
    eng = make()

    async def go():
        aeng = AsyncEngine(eng)
        try:
            h = aeng.submit(Request(
                rid=0, prompt=b"Q:", grammar="json", max_new_tokens=500,
                decode=DecodeConfig(method="sample", temperature=1.0),
                seed=3, deadline=0.05))
            st = await h.result()
            assert st.finish_reason == "deadline"
            assert st.steps < 500
            ok = aeng.submit(Request(
                rid=1, prompt=b"Q:", grammar="calc", max_new_tokens=4,
                decode=DecodeConfig(method="greedy"), seed=0,
                deadline=60.0))
            st2 = await ok.result()
            assert st2.finish_reason in ("eos", "length", "max_len")
        finally:
            await aeng.drain()
    asyncio.run(go())


def test_abort_cancels_everything(make):
    eng = make()

    async def go():
        aeng = AsyncEngine(eng)
        hs = [aeng.submit(Request(rid=i, prompt=b"Q%d:" % i, grammar=None,
                                  max_new_tokens=4000,
                                  decode=DecodeConfig(method="greedy"),
                                  seed=90 + i)) for i in range(6)]
        await asyncio.sleep(0.1)
        await aeng.abort()
        for h in hs:
            st = await h.result()
            assert st.finish_reason == "cancelled"
    asyncio.run(go())


def test_request_grammar_mode_overrides_engine_default(make):
    eng = make()
    req = _reqs("json", n=1)[0]
    assert eng._make_constraint(req).mode == "grammar_mask"
    req.grammar_mode = "grammar_strict"
    assert eng._make_constraint(req).mode == "grammar_strict"
    req.grammar_mode = None                 # falls back to engine default
    assert make(grammar_mode="grammar_strict")._make_constraint(
        req).mode == "grammar_strict"
    with pytest.raises(ValueError, match="grammar_mode"):
        make(grammar_mode="nope")


def test_hot_load_grammar_mid_serving(make, sides):
    """load_grammar() on a live AsyncEngine: a request already streaming
    keeps running, and requests submitted after the load use the new
    grammar, token for token as an engine born with it."""
    bundle = sides[7]["python_mini"]
    ref_states, _ = make(grammars=("json", "python_mini")).generate(
        _reqs("python_mini", n=2, max_new=12, seed0=5))
    eng = make(grammars=("json",))
    assert "python_mini" not in eng.bundles

    async def go():
        aeng = AsyncEngine(eng)
        try:
            busy = aeng.submit(_long(777, 9, max_new=40))
            await aeng.load_grammar("python_mini", bundle)
            assert "python_mini" in eng.bundles
            assert eng._store_cat.shape[0] == sum(
                b[2].packed.shape[0] for b in eng.bundles.values())
            after, _ = await aeng.generate(
                _reqs("python_mini", n=2, max_new=12, seed0=5))
            st_busy = await busy.result()
            assert st_busy.finish_reason in ("eos", "length", "max_len")
            return after
        finally:
            await aeng.drain()
    assert tokens(asyncio.run(go())) == tokens(ref_states)


def test_hot_load_rejects_duplicates_and_undersized_stores(make, sides):
    eng = make(grammars=("json", "calc"))
    g, tab, store = sides[7]["calc"]

    class Small:
        packed = store.packed[:, :store.packed.shape[1] // 2]

    async def go():
        aeng = AsyncEngine(eng)
        try:
            with pytest.raises(ValueError, match="already registered"):
                await aeng.load_grammar("calc", (g, tab, store))
            with pytest.raises(ValueError, match="smaller vocab"):
                await aeng.load_grammar("calc2", (g, tab, Small()))
            assert "calc2" not in eng.bundles
        finally:
            await aeng.drain()
    asyncio.run(go())
