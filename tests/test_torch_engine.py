"""The port's serving engine (`repro_torch.serving`, dense continuous
batching with host/device overlap) against the reference's
`repro.serving.engine.Engine`, on an fp32 copy of syncode-demo with the
reference's `Model.init(PRNGKey(0))` weights bridged into the port.

Greedy: the same tokens, the same finish reasons, on all six builtin
grammars in one mixed pool (admissions happen mid-run: more requests
than slots), with overlap on and off. Sampled: the same tokens when the
port's `noise_fn` hands it the reference's own Gumbel noise
(`jax.random.gumbel` of the same per-slot keys). No tolerance: token ids
are compared exactly. The entry points refuse to run without a card
unless the CPU is asked for."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.decoding import DecodeConfig as JaxDecodeConfig
from repro.core.grammars import BUILTIN, load_grammar
from repro.core.mask_store import build_mask_store
from repro.core.tokenizer import ByteTokenizer
from repro.kernels.fused_select.ref import gumbel_noise as jax_gumbel
from repro.models.model import build_model
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.decoding import DecodeConfig
from repro_torch.core.grammars import load_grammar as torch_load_grammar
from repro_torch.core.mask_store import build_mask_store as torch_build_store
from repro_torch.core.parser import IncrementalParser
from repro_torch.core.tokenizer import ByteTokenizer as TorchByteTokenizer
from repro_torch.launch import serve
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving.engine import Engine, Request

MAX_LEN = 96


@pytest.fixture(scope="module")
def sides():
    """Both systems on the same weights and grammars: (jax model, jax
    params, jax tokenizer, jax bundles, port model, port params, port
    tokenizer, port bundles). Each side builds its own mask stores with
    its own copy of the host layer."""
    cfg = replace(get_config("syncode-demo"), dtype="float32")
    jm = build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jtok = ByteTokenizer(cfg.vocab_size)
    jb = {}
    for name in BUILTIN:
        g, tab = load_grammar(name)
        jb[name] = (g, tab, build_mask_store(g, jtok))
    tcfg = replace(torch_get_config("syncode-demo"), dtype="float32")
    ttok = TorchByteTokenizer(tcfg.vocab_size)
    tb = {}
    for name in BUILTIN:
        g, tab = torch_load_grammar(name)
        tb[name] = (g, tab, torch_build_store(g, ttok))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jp))
    return (jm, jp, jtok, jb, torch_build_model(tcfg, device="cpu"),
            tparams, ttok, tb)


def _jax_noise_fn(keys, V):
    """The reference's noise for these keys, as the port's noise_fn."""
    return torch.from_numpy(np.array(jax_gumbel(jnp.asarray(keys), V)))


def _requests(specs):
    """specs: (rid, grammar, prompt, max_new, method, temp, top_k, top_p)
    -> (reference requests, port requests)."""
    jreqs, treqs = [], []
    for rid, grammar, prompt, n, method, temp, k, p in specs:
        for R, D, out in ((JaxRequest, JaxDecodeConfig, jreqs),
                          (Request, DecodeConfig, treqs)):
            out.append(R(rid=rid, prompt=prompt, grammar=grammar,
                         max_new_tokens=n, seed=rid * 7 + 1,
                         decode=D(method, temp, k, p)))
    return jreqs, treqs


def _run_both(sides, specs, slots, overlap, sampled):
    jm, jp, jtok, jb, tm, tp, ttok, tb = sides
    jreqs, treqs = _requests(specs)
    jeng = JaxEngine(jm, jp, jtok, jb, max_len=MAX_LEN, slots=slots,
                     overlap=overlap)
    teng = Engine(tm, tp, ttok, tb, max_len=MAX_LEN, slots=slots,
                  overlap=overlap, device="cpu",
                  noise_fn=_jax_noise_fn if sampled else None)
    jstates, jstats = jeng.generate(jreqs)
    tstates, tstats = teng.generate(treqs)
    want = {s.req.rid: (s.token_ids, s.finish_reason) for s in jstates}
    got = {s.req.rid: (s.token_ids, s.finish_reason) for s in tstates}
    assert got == want
    assert tstats.tokens == jstats.tokens
    assert tstats.decode_steps == jstats.decode_steps
    for st in tstates:                  # the paper's claim, port side
        if st.finish_reason == "eos" and st.req.grammar:
            g, tab, _ = tb[st.req.grammar]
            assert IncrementalParser(g, tab).recognize(st.generated)
    return tstates, tstats


PROMPTS = [b"Q: give a value. A:", b"", b"x = ", b"SELECT", b"{",
           b"def f():"]


@pytest.mark.parametrize("overlap", [True, False])
def test_greedy_mixed_pool_matches_reference(sides, overlap):
    specs = [(i, BUILTIN[i], PROMPTS[i], 14, "greedy", 1.0, None, None)
             for i in range(len(BUILTIN))]
    _, stats = _run_both(sides, specs, slots=4, overlap=overlap,
                         sampled=False)
    if overlap:
        assert stats.overlap_dispatched > 0
    else:
        assert stats.overlap_dispatched == 0


@pytest.mark.parametrize("grammar", BUILTIN)
def test_greedy_each_grammar_matches_reference(sides, grammar):
    specs = [(0, grammar, b"", 10, "greedy", 1.0, None, None),
             (1, grammar, b"out:", 8, "greedy", 1.0, None, None),
             (2, None, b"free text", 4, "greedy", 1.0, None, None)]
    _run_both(sides, specs, slots=2, overlap=True, sampled=False)


@pytest.mark.parametrize("overlap", [True, False])
def test_sampled_matches_reference_with_shared_noise(sides, overlap):
    specs = [
        (0, "json", b"", 14, "sample", 1.0, None, 0.95),
        (1, "calc", b"1+", 12, "sample", 0.7, 20, None),
        (2, "jsonmsg", b"", 14, "greedy", 1.0, None, None),
        (3, "sql", b"SELECT", 12, "sample", 1.3, None, 1.0),
        (4, "minilang", b"", 12, "sample", 0.9, 40, 0.9),
        (5, "python_mini", b"", 12, "sample", 1.1, None, None),
    ]
    _run_both(sides, specs, slots=3, overlap=overlap, sampled=True)


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    """build_engine, build_model and the CLI default to the card and
    raise without one; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_engine("syncode-demo", grammars=("json",))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_build_model(torch_get_config("syncode-demo"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--grammar", "json", "-n", "1"])


def test_cli_runs_on_the_cpu_when_asked(capsys):
    serve.main(["--device", "cpu", "--grammar", "calc", "-n", "2",
                "--max-new", "6", "--slots", "2", "--greedy"])
    out = capsys.readouterr().out
    assert "decode steps" in out
    complete, valid = out.rsplit("valid among complete: ", 1)[1].split()[0] \
        .split("/")
    assert complete == valid
