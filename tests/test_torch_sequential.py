"""The port's sequential path (`Engine.generate_sequential`, one request
per device call, paper Algorithm 3) against the reference's, on an fp32
copy of syncode-demo with the reference's weights bridged into the port
(tests/_torch_parity.py).

Greedy token ids are compared exactly with the reference's sequential
run and with the port's batched generate(). Sampled draws take noise
from the port's `noise_fn`, one key per (request, step, draw), while the
reference splits jax.random keys, so sampled runs carry no token
identity: their outputs must stay in the grammar's language. The mask
goes through `masked_logits` (the kernel on the card) once per
constrained step."""
import pytest

from repro.core.grammars import BUILTIN
from repro_torch.kernels.masked_logits.ops import apply_grammar_mask
from tests._torch_parity import (assert_valid, build_sides, engines,
                                 requests, tokens, writable_sequential_mask)

MAX_LEN = 96


@pytest.fixture(scope="module")
def sides():
    return build_sides()


@pytest.fixture(scope="module")
def pair(sides):
    return engines(sides, MAX_LEN, slots=3)


def test_greedy_sequential_matches_reference_and_generate(pair, sides,
                                                          monkeypatch):
    writable_sequential_mask(monkeypatch)
    jeng, teng = pair
    specs = [(i, g, p, 10, "greedy", 1.0, None, None)
             for i, (g, p) in enumerate(zip(
                 BUILTIN + (None,),
                 (b"x=", b"1+", b"SELECT a", b"say:", b"{", b"def f():",
                  b"free text")))]
    jstates, jstats = jeng.generate_sequential(requests(specs)[0])
    tstates, tstats = teng.generate_sequential(requests(specs)[1])
    assert tokens(tstates) == tokens(jstates)
    assert (tstats.tokens, tstats.mask_computations) == \
        (jstats.tokens, jstats.mask_computations)
    assert_valid(tstates, sides[7])
    # the batched engine prepends BOS to a prompt of one token (its
    # prefill needs one), so the two paths see the same context exactly
    # when the prompt encodes to two tokens or more
    same = {s.req.rid for s in tstates
            if len(teng.tok.encode(s.req.prompt)) >= 2}
    assert len(same) >= 4
    batched, _ = teng.generate(requests(specs)[1])
    assert {r: v for r, v in tokens(batched).items() if r in same} == \
        {r: v for r, v in tokens(tstates).items() if r in same}


def test_sampled_sequential_outputs_stay_valid(pair, sides):
    _, teng = pair
    specs = [(i, g, b"", 14, "sample", t, k, p) for i, (g, t, k, p) in
             enumerate((("json", 1.0, None, None), ("calc", 0.7, 20, None),
                        ("jsonmsg", 1.2, None, 0.9),
                        ("python_mini", 1.0, None, None)))]
    states, stats = teng.generate_sequential(requests(specs)[1])
    assert stats.tokens == sum(s.steps for s in states) > 0
    for st in states:
        assert st.finish_reason in ("eos", "length", "max_len")
    assert_valid(states, sides[7])
    again, _ = teng.generate_sequential(requests(specs)[1])
    assert tokens(again) == tokens(states)      # keyed noise: repeatable
    # on the CPU the mask is the plain version: no kernel launch counted
    assert apply_grammar_mask.launches == 0
