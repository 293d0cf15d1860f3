"""Grammar-aware speculation in the port (`Engine.generate_speculative`,
`SpecMode`, `Model.decode_span`, the span mask `masked_logits_span`)
against the reference's, on an fp32 copy of syncode-demo with the
reference's weights bridged into the port (tests/_torch_parity.py).

Token ids are compared exactly: greedy speculation gives the reference's
speculative tokens and the port's own generate() tokens on every builtin
grammar; sampled speculation gives the reference's tokens when the
port's noise_fn hands it the reference's Gumbel noise for the same
[B*S, 2] span keys. The span decode is held to sequential decode steps
within atol 1e-5 in fp32 (different matmul shapes sum in different
orders on the CPU); kv_pos and untouched cache lines exactly."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core.grammars import BUILTIN
from repro.spec import SpecConfig as JaxSpecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.model import build_model
from repro_torch.spec import SpecConfig
from tests._torch_parity import (assert_valid, build_sides, engines,
                                 requests, tokens)

MAX_LEN = 96


@pytest.fixture(scope="module")
def sides():
    return build_sides()


@pytest.fixture(scope="module")
def greedy_engines(sides):
    return engines(sides, MAX_LEN, slots=3)


@pytest.mark.parametrize("grammar", BUILTIN)
def test_greedy_spec_matches_reference_and_generate(greedy_engines, sides,
                                                    grammar):
    jeng, teng = greedy_engines
    specs = [(0, grammar, b"", 14, "greedy", 1.0, None, None),
             (1, grammar, b"out:", 10, "greedy", 1.0, None, None)]
    jreqs, treqs = requests(specs)
    jstates, jstats = jeng.generate_speculative(jreqs)
    tstates, tstats = teng.generate_speculative(treqs)
    assert tokens(tstates) == tokens(jstates)
    assert (tstats.jump_tokens, tstats.draft_proposed,
            tstats.draft_accepted, tstats.decode_steps) == \
        (jstats.jump_tokens, jstats.draft_proposed, jstats.draft_accepted,
         jstats.decode_steps)
    plain, _ = teng.generate(requests(specs)[1])
    assert tokens(plain) == tokens(tstates)
    assert_valid(tstates, sides[7])


def test_sampled_spec_matches_reference_with_shared_noise(sides):
    jeng, teng = engines(sides, MAX_LEN, sampled=True, slots=3)
    specs = [(0, "json", b"", 16, "sample", 1.0, None, 0.95),
             (1, "jsonmsg", b"", 16, "sample", 0.8, 20, None),
             (2, "calc", b"1+", 12, "sample", 1.2, None, None),
             (3, "sql", b"SELECT", 12, "greedy", 1.0, None, None)]
    jreqs, treqs = requests(specs)
    jstates, _ = jeng.generate_speculative(jreqs)
    tstates, _ = teng.generate_speculative(treqs)
    assert tokens(tstates) == tokens(jstates)
    assert_valid(tstates, sides[7])


def test_mixed_pool_more_requests_than_slots(sides):
    """Grammars, an unconstrained request, greedy and sampled slots in
    one pool of 2 slots with 7 requests (admissions mid-run)."""
    jeng, teng = engines(sides, MAX_LEN, sampled=True, slots=2)
    g = ["json", "calc", None, "jsonmsg", "minilang", "python_mini", "sql"]
    specs = [(i, g[i], b"say:", 10, ("greedy", "sample")[i % 2], 1.0,
              None, None) for i in range(7)]
    jreqs, treqs = requests(specs)
    jstates, _ = jeng.generate_speculative(jreqs)
    tstates, tstats = teng.generate_speculative(treqs)
    assert tokens(tstates) == tokens(jstates)
    assert tstats.requests == 7
    assert_valid(tstates, sides[7])


def test_literal_jump_matches_reference(greedy_engines, sides):
    """literal_jump chases byte-level forced literals: the port and the
    reference take the same jumps and emit the same tokens."""
    jeng, teng = greedy_engines
    specs = [(i, "jsonmsg", b"", 30, "greedy", 1.0, None, None)
             for i in range(3)]
    jreqs, treqs = requests(specs)
    jstates, jstats = jeng.generate_speculative(
        jreqs, spec=JaxSpecConfig(literal_jump=True))
    tstates, tstats = teng.generate_speculative(
        treqs, spec=SpecConfig(literal_jump=True))
    assert tokens(tstates) == tokens(jstates)
    assert tstats.jump_tokens == jstats.jump_tokens > 0
    assert tstats.decode_steps < tstats.tokens
    assert_valid(tstates, sides[7])


def _small_model():
    cfg = replace(torch_get_config("syncode-demo"), dtype="float32",
                  num_layers=2)
    m = build_model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(1)), cfg


def test_decode_span_matches_sequential_decode_steps():
    m, params, cfg = _small_model()
    B, L, S = 2, 32, 4
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, 5)))
    _, c_seq = m.prefill(params, {"tokens": prompt}, cache_len=L)
    _, c_span = m.prefill(params, {"tokens": prompt}, cache_len=L)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
    outs = []
    for i in range(S):
        o, _ = m.decode_step(params, c_seq, toks[:, i],
                             torch.full((B,), 5 + i, dtype=torch.int32))
        outs.append(o)
    o_span, _ = m.decode_span(params, c_span, toks,
                              torch.full((B,), 5, dtype=torch.int32))
    np.testing.assert_allclose(o_span.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=0, atol=1e-5)
    for a, b in zip(c_seq[0][0].values(), c_span[0][0].values()):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0, atol=1e-5)
    assert torch.equal(c_seq[0][0]["kv_pos"], c_span[0][0]["kv_pos"])


def test_decode_span_feed_mask_gates_cache_writes():
    m, params, cfg = _small_model()
    B, L, S = 2, 16, 4
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, 3)))
    _, c_masked = m.prefill(params, {"tokens": prompt}, cache_len=L)
    _, c_two = m.prefill(params, {"tokens": prompt}, cache_len=L)
    before = {n: t.clone() for n, t in c_masked[0][0].items()}
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
    fm = torch.tensor([[True, True, False, False]] * B)
    m.decode_span(params, c_masked, toks,
                  torch.full((B,), 3, dtype=torch.int32), feed_mask=fm)
    for i in range(2):
        m.decode_step(params, c_two, toks[:, i],
                      torch.full((B,), 3 + i, dtype=torch.int32))
    assert torch.equal(c_masked[0][0]["kv_pos"], c_two[0][0]["kv_pos"])
    for name in ("k", "v"):
        a, b = c_masked[0][0][name], c_two[0][0][name]
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
        # the gated positions 5 and 6 were never written
        assert torch.equal(a[:, :, 5:7], before[name][:, :, 5:7])
