"""The port's opportunistic masking (`Engine(opportunistic=True)`, the
paper's fast path: check the unconstrained proposal against the exact
oracle first, build and apply the grammar mask only when it fails)
against the reference's, on the narrow syncode-demo of
tests/test_serving.py in fp32 with the reference's weights bridged into
the port (tests/_torch_parity.py).

Greedy: the same tokens, finish reasons and `opportunistic_hits` on all
six builtin grammars, for the batched `generate()` and the sequential
`generate_sequential()`. Sampled `generate()`: the same tokens when the
port's `noise_fn` hands it the reference's Gumbel noise, both for the
proposal keys (attempt 0) and for the masked draw's keys (attempt 1).
Exact comparison, no tolerance. The guarantee of
tests/test_serving.py::test_opportunistic_masking_same_guarantees holds
in the port."""
import numpy as np
import pytest

from repro.core.grammars import BUILTIN
from repro_torch.core.decoding import DecodeConfig
from repro_torch.core.parser import IncrementalParser
from repro_torch.serving.engine import Engine, Request
from tests._torch_parity import (NARROW, assert_valid, build_sides, engines,
                                 jax_noise_fn, requests, tokens,
                                 writable_sequential_mask)

MAX_LEN = 160
PROMPTS = (b"x = ", b"1+", b"SELECT a", b"say:", b"{", b"def f():")


@pytest.fixture(scope="module")
def sides():
    return build_sides(**NARROW)


def _greedy_specs(grammar, prompt):
    return [(0, grammar, prompt, 12, "greedy", 1.0, None, None),
            (1, grammar, b"out:", 10, "greedy", 1.0, None, None),
            (2, None, b"free text", 4, "greedy", 1.0, None, None)]


@pytest.mark.parametrize("grammar,prompt", list(zip(BUILTIN, PROMPTS)))
def test_greedy_generate_matches_reference(sides, grammar, prompt):
    jeng, teng = engines(sides, MAX_LEN, slots=2, opportunistic=True)
    jstates, jstats = jeng.generate(requests(_greedy_specs(grammar,
                                                           prompt))[0])
    tstates, tstats = teng.generate(requests(_greedy_specs(grammar,
                                                           prompt))[1])
    assert tokens(tstates) == tokens(jstates)
    assert [s.opportunistic_hits for s in tstates] == \
        [s.opportunistic_hits for s in jstates]
    assert (tstats.opportunistic_hits, tstats.mask_computations,
            tstats.tokens) == (jstats.opportunistic_hits,
                               jstats.mask_computations, jstats.tokens)
    # overlap is off under opportunistic masking, as in the reference
    assert tstats.overlap_dispatched == 0
    assert_valid(tstates, sides[7])


@pytest.mark.parametrize("grammar,prompt", list(zip(BUILTIN, PROMPTS)))
def test_greedy_sequential_matches_reference(sides, grammar, prompt,
                                             monkeypatch):
    writable_sequential_mask(monkeypatch)
    jeng, teng = engines(sides, MAX_LEN, opportunistic=True)
    jstates, jstats = jeng.generate_sequential(
        requests(_greedy_specs(grammar, prompt))[0])
    tstates, tstats = teng.generate_sequential(
        requests(_greedy_specs(grammar, prompt))[1])
    assert tokens(tstates) == tokens(jstates)
    assert (tstats.opportunistic_hits, tstats.mask_computations,
            tstats.tokens) == (jstats.opportunistic_hits,
                               jstats.mask_computations, jstats.tokens)
    assert_valid(tstates, sides[7])


def test_fast_path_fires_on_greedy_runs(sides):
    """Across the six grammars the greedy proposal passes the oracle on
    some steps and fails on others, so both branches ran above."""
    _, teng = engines(sides, MAX_LEN, slots=4, opportunistic=True)
    specs = [(i, g, p, 12, "greedy", 1.0, None, None)
             for i, (g, p) in enumerate(zip(BUILTIN, PROMPTS))]
    _, stats = teng.generate(requests(specs)[1])
    assert 0 < stats.opportunistic_hits < stats.tokens
    assert stats.mask_computations > 0


def test_sampled_generate_matches_reference_with_shared_noise(sides):
    attempts = set()

    def noise_fn(keys, V):
        attempts.update(int(a) for a in np.asarray(keys)[:, 1] & 0xF)
        return jax_noise_fn(keys, V)
    jeng, teng = engines(sides, MAX_LEN, slots=3, opportunistic=True)
    teng.noise_fn = noise_fn
    specs = [(0, "json", b"", 14, "sample", 1.0, None, 0.95),
             (1, "calc", b"1+", 12, "sample", 0.7, 20, None),
             (2, "jsonmsg", b"", 14, "greedy", 1.0, None, None),
             (3, "sql", b"SELECT", 12, "sample", 1.3, None, 1.0),
             (4, "minilang", b"", 12, "sample", 0.9, 40, 0.9),
             (5, "python_mini", b"", 12, "sample", 1.1, None, None),
             (6, None, b"free", 6, "sample", 1.0, None, None)]
    jstates, jstats = jeng.generate(requests(specs)[0])
    tstates, tstats = teng.generate(requests(specs)[1])
    assert tokens(tstates) == tokens(jstates)
    assert (tstats.opportunistic_hits, tstats.mask_computations) == \
        (jstats.opportunistic_hits, jstats.mask_computations)
    assert {0, 1} <= attempts          # proposal and masked-draw keys
    assert_valid(tstates, sides[7])


def test_opportunistic_masking_same_guarantees(sides):
    """tests/test_serving.py's guarantee in the port: completed outputs
    parse, and every constrained token was either an accepted proposal
    or a masked draw."""
    _, _, _, _, tm, tp, ttok, tb = sides
    engine = Engine(tm, tp, ttok, {"calc": tb["calc"]}, max_len=200,
                    opportunistic=True, device="cpu")
    reqs = [Request(rid=i, prompt=b"say:", grammar="calc",
                    max_new_tokens=30,
                    decode=DecodeConfig(method="sample", temperature=1.0),
                    seed=i) for i in range(3)]
    states, stats = engine.generate(reqs)
    g, tab, _ = tb["calc"]
    for st in states:
        if st.finish_reason == "eos":
            assert IncrementalParser(g, tab).recognize(st.generated)
        else:
            IncrementalParser(g, tab).partial_parse(st.generated)
    assert stats.opportunistic_hits + stats.mask_computations == \
        stats.tokens
