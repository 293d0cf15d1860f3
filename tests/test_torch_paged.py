"""Paged KV serving in the port (`Engine(paged=True)`, `PagedMode`, the
copied `PagedAllocator`, `Model.init_paged_caches` and the paged
attention layer) against the port's dense engine and the reference's
paged engine, on an fp32 copy of syncode-demo with the reference's
weights bridged into the port (tests/_torch_parity.py).

Token ids and allocator counters are compared exactly. Paged gives the
dense engine's tokens (greedy on every builtin grammar, sampled with the
same noise) and the reference's paged tokens; prefix sharing, chunked
prefill, more requests than slots, pool exhaustion and speculation over
page tables behave as the reference's."""
import pytest

from repro.core.grammars import BUILTIN
from repro.serving.engine import Engine as JaxEngine
from repro_torch.serving.engine import Engine
from tests._torch_parity import (assert_valid, build_sides, engines,
                                 requests, tokens)

MAX_LEN = 96
PROMPT = b"Q: generate. A:"
SHARED = (b'{"type": "msg", "seq": 1, "body": "hello"} ' * 3)[:70]


@pytest.fixture(scope="module")
def sides():
    return build_sides()


@pytest.fixture(scope="module")
def paged_pair(sides):
    """(reference paged, port paged, port dense), greedy noise."""
    jeng, teng = engines(sides, MAX_LEN, slots=3, paged=True, page_size=8)
    _, dense = engines(sides, MAX_LEN, slots=3)
    return jeng, teng, dense


def _kv(stats):
    return (stats.kv_page_allocs, stats.kv_evictions, stats.kv_cow_copies,
            stats.kv_pages_in_use, round(stats.prefix_hit_rate, 12),
            round(stats.kv_peak_utilization, 12))


@pytest.mark.parametrize("grammar", BUILTIN)
def test_greedy_paged_matches_dense_and_reference(paged_pair, sides,
                                                  grammar):
    jeng, teng, dense = paged_pair
    specs = [(i, grammar, p, 10, "greedy", 1.0, None, None)
             for i, p in enumerate((PROMPT, b"", b"x=1;"))]
    jstates, jstats = jeng.generate(requests(specs)[0])
    tstates, tstats = teng.generate(requests(specs)[1])
    dstates, _ = dense.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(dstates) == tokens(jstates)
    assert _kv(tstats) == _kv(jstats)
    assert tstats.decode_steps == jstats.decode_steps
    assert tstats.kv_peak_utilization > 0
    assert_valid(tstates, sides[7])


def test_sampled_paged_matches_dense_and_reference(sides):
    jeng, teng = engines(sides, MAX_LEN, sampled=True, slots=3, paged=True,
                         page_size=8)
    _, dense = engines(sides, MAX_LEN, sampled=True, slots=3)
    specs = [(0, "json", PROMPT, 12, "sample", 0.9, None, None),
             (1, "json", PROMPT, 12, "sample", 1.2, 8, None),
             (2, "calc", b"1+", 12, "sample", 0.8, None, 0.9),
             (3, "jsonmsg", b"", 12, "greedy", 1.0, None, None)]
    jstates, _ = jeng.generate(requests(specs)[0])
    tstates, _ = teng.generate(requests(specs)[1])
    dstates, _ = dense.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(dstates) == tokens(jstates)


def test_prefix_sharing_and_chunked_prefill(paged_pair):
    """Four slots admitted with one long shared prompt attach its pages
    instead of prefilling them again; the prompt drains in chunks of at
    most prefill_chunk tokens; tokens and allocator counters are the
    dense engine's and the reference's."""
    jeng, teng, dense = paged_pair
    specs = [(i, "json", SHARED, 8, "greedy", 1.0, None, None)
             for i in range(4)]
    jstates, jstats = jeng.generate(requests(specs)[0])
    tstates, tstats = teng.generate(requests(specs)[1])
    dstates, _ = dense.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(dstates) == tokens(jstates)
    assert _kv(tstats) == _kv(jstats)
    assert tstats.prefix_hit_rate > 0.5
    pages_per_prompt = (len(SHARED) + 1) // teng.page_size
    assert tstats.kv_page_allocs < 4 * pages_per_prompt
    # a 71-token prompt drains through chunk spans before its first
    # selection: more forward steps than committed tokens per slot
    assert tstats.decode_steps > max(len(s.token_ids) - s.prompt_len
                                     for s in tstates)


def test_more_requests_than_slots(sides):
    jeng, teng = engines(sides, MAX_LEN, sampled=True, slots=2, paged=True,
                         page_size=8)
    specs = [(i, ("json", "sql", None)[i % 3], PROMPT, 8,
              ("sample", "greedy")[i % 2], 1.0, None, None)
             for i in range(5)]
    jstates, jstats = jeng.generate(requests(specs)[0])
    tstates, tstats = teng.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(jstates)
    assert _kv(tstats) == _kv(jstats)
    assert_valid(tstates, sides[7])


def _capture_alloc(eng):
    """Keep the run's allocator observable after generate() returns."""
    orig, box = eng._paged_setup, {}

    def patched(B):
        box["alloc"], caches = orig(B)
        return box["alloc"], caches
    eng._paged_setup = patched
    return box


def test_kv_oom_finishes_gracefully_and_pages_return(sides):
    """A pool too small for every slot's generation finishes the
    overflowing requests with 'kv_oom', as the reference does; the pool
    drains back to its baseline (only cold cached prompt pages left)."""
    jeng, teng = engines(sides, MAX_LEN, slots=2, paged=True, page_size=4,
                         num_pages=14)
    specs = [(i, "json", b"x" * 20, 60, "greedy", 1.0, None, None)
             for i in range(4)]
    box = _capture_alloc(teng)
    jstates, jstats = jeng.generate(requests(specs)[0])
    tstates, tstats = teng.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(jstates)
    assert any(s.finish_reason == "kv_oom" for s in tstates)
    assert _kv(tstats) == _kv(jstats)
    alloc = box["alloc"]
    alloc.check_invariants()
    assert all(not t for t in alloc.tables)
    assert alloc.pages_in_use == alloc.cold_pages
    assert_valid(tstates, sides[7])


@pytest.mark.parametrize("grammar", ["json", "jsonmsg"])
def test_speculative_over_pages_matches_reference_and_dense(paged_pair,
                                                            sides, grammar):
    jeng, teng, dense = paged_pair
    specs = [(i, grammar, p, 16, "greedy", 1.0, None, None)
             for i, p in enumerate((PROMPT, SHARED, b""))]
    jstates, jstats = jeng.generate_speculative(requests(specs)[0])
    tstates, tstats = teng.generate_speculative(requests(specs)[1])
    dstates, _ = dense.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(dstates) == tokens(jstates)
    assert _kv(tstats) == _kv(jstats)
    assert tstats.jump_tokens == jstats.jump_tokens


def test_paged_rejects_window_and_recurrent_configs(sides):
    from dataclasses import replace
    tm = sides[4]
    windowed = type(tm)(replace(tm.cfg, sliding_window=16), device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        Engine(windowed, sides[5], sides[6], {}, paged=True, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        windowed.init_paged_caches(4, 8)
    assert JaxEngine       # the reference raises the same (its tests)
