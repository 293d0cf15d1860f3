"""The port's serving engine on the moe, ssm and hybrid archs against the
reference's `repro.serving.engine.Engine`, on fp32 reduced configs
(qwen3-moe-30b-a3b, mamba2-370m, recurrentgemma-9b; `cfg.reduced()`)
with the reference's `Model.init(PRNGKey(0))` weights bridged into the
port (tests/_torch_parity.py).

Token ids and finish reasons are compared exactly: greedy `generate()`
on all six builtin grammars in one pool (more requests than slots, so
admissions happen mid-run), sampled `generate()` with the reference's
own Gumbel noise, `generate_sequential` for the ssm family, and for the
MoE family paged `generate()` and `generate_speculative`. The recurrent
families prefill at exact length and run without overlap, and refuse
paged KV and speculation with the reference's `ValueError`."""
import pytest

from repro.core.grammars import BUILTIN
from repro.serving.engine import Engine as JaxEngine
from repro_torch.serving.engine import Engine
from tests._torch_parity import (assert_valid, build_sides, engines,
                                 requests, tokens, writable_sequential_mask)

MAX_LEN = 96
ARCHS = {"moe": "qwen3-moe-30b-a3b", "ssm": "mamba2-370m",
         "hybrid": "recurrentgemma-9b"}
PROMPTS = [b"Q: give a value. A:", b"", b"x = ", b"SELECT", b"{",
           b"def f():"]


@pytest.fixture(scope="module", params=list(ARCHS))
def sides(request):
    return request.param, build_sides(ARCHS[request.param], reduced=True)


@pytest.fixture(scope="module")
def moe_sides():
    return build_sides(ARCHS["moe"], reduced=True)


def _run(sides, specs, method="generate", **kw):
    jeng, teng = engines(sides, MAX_LEN, **kw)
    jstates, jstats = getattr(jeng, method)(requests(specs)[0])
    tstates, tstats = getattr(teng, method)(requests(specs)[1])
    assert tokens(tstates) == tokens(jstates)
    assert (tstats.tokens, tstats.decode_steps) == \
        (jstats.tokens, jstats.decode_steps)
    assert_valid(tstates, sides[7])
    return teng, tstats


def test_greedy_all_grammars_match_reference(sides):
    family, s = sides
    specs = [(i, g, PROMPTS[i % len(PROMPTS)], 10, "greedy", 1.0, None,
              None) for i, g in enumerate(BUILTIN + (None,))]
    teng, stats = _run(s, specs, slots=3)
    recurrent = family != "moe"
    assert teng.model.prefill_padding_safe == (not recurrent)
    if recurrent:                   # no overlap without span rewrites
        assert stats.overlap_dispatched == 0


def test_sampled_matches_reference_with_shared_noise(sides):
    _, s = sides
    specs = [(0, "json", b"", 12, "sample", 1.0, None, 0.95),
             (1, "jsonmsg", b"A:", 12, "sample", 0.8, 20, None),
             (2, "calc", b"1+", 10, "sample", 1.2, None, None),
             (3, "sql", b"SELECT", 10, "greedy", 1.0, None, None),
             (4, None, b"free", 6, "sample", 0.7, 40, 0.9)]
    _run(s, specs, sampled=True, slots=3)


def test_ssm_sequential_matches_reference(monkeypatch):
    writable_sequential_mask(monkeypatch)
    s = build_sides(ARCHS["ssm"], reduced=True)
    specs = [(i, g, p, 8, ("greedy", "sample")[i % 2], 1.0, None, None)
             for i, (g, p) in enumerate(zip(
                 ("json", "calc", "sql", None), (b"{", b"1+", b"", b"hi")))]
    _, stats = _run(s, specs, method="generate_sequential", sampled=True)
    assert stats.mask_computations > 0


def test_moe_paged_matches_reference(moe_sides):
    specs = [(i, g, b"say:" * (i + 1), 10, ("greedy", "sample")[i % 2],
              0.9, None, None)
             for i, g in enumerate(("json", "jsonmsg", "calc", "sql",
                                    "minilang"))]
    _, stats = _run(moe_sides, specs, sampled=True, slots=3, paged=True,
                    page_size=8)
    assert stats.kv_page_allocs > 0


def test_moe_speculative_matches_reference(moe_sides):
    specs = [(0, "json", b"", 12, "greedy", 1.0, None, None),
             (1, "jsonmsg", b"", 12, "sample", 1.0, None, 0.95),
             (2, "calc", b"1+", 10, "greedy", 1.0, None, None),
             (3, "python_mini", b"def f():", 10, "sample", 0.8, 20, None)]
    _, stats = _run(moe_sides, specs, method="generate_speculative",
                    sampled=True, slots=3)
    assert stats.draft_proposed + stats.jump_tokens > 0


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_recurrent_paged_and_speculation_refused(family):
    jm, jp, jtok, jb, tm, tp, ttok, tb = s = build_sides(ARCHS[family],
                                                         reduced=True)
    msgs = []
    for build in (lambda: JaxEngine(jm, jp, jtok, jb, max_len=MAX_LEN,
                                    paged=True),
                  lambda: Engine(tm, tp, ttok, tb, max_len=MAX_LEN,
                                 paged=True, device="cpu")):
        with pytest.raises(ValueError) as e:
            build()
        msgs.append(str(e.value))
    spec = [(0, "json", b"", 4, "greedy", 1.0, None, None)]
    for eng, reqs in zip(engines(s, MAX_LEN), requests(spec)):
        with pytest.raises(ValueError) as e:
            eng.generate_speculative(reqs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]
    assert "recurrent" in msgs[0] and "recurrent" in msgs[2]
