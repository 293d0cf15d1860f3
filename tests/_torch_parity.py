"""Shared set-up of the engine-level parity tests of the PyTorch port:
both systems on one fp32 copy of a config (syncode-demo unless asked
otherwise; the reference's `Model.init(PRNGKey(0))` weights bridged
into the port), each with its own mask stores built by its own copy of
the host layer."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving.engine import Engine, Request

# One intra-op thread per process: pytest-xdist runs one worker per
# core, and each worker's default torch pool (a thread per core)
# oversubscribes the machine, which made these files several times
# slower.
torch.set_num_threads(1)


# the narrow syncode-demo of the reference's async-engine and serving
# tests (tests/test_async_engine.py, tests/test_serving.py)
NARROW = dict(vocab_size=1024, num_layers=2, d_model=128, d_ff=256,
              num_heads=4, num_kv_heads=2, head_dim=32)


def build_sides(arch="syncode-demo", reduced=False, **overrides):
    """-> (jax model, jax params, jax tokenizer, jax bundles, port model,
    port params, port tokenizer, port bundles). `reduced` takes the
    arch's `cfg.reduced()`; `overrides` replace fields of the config on
    both sides (e.g. NARROW)."""
    pick = lambda c: c.reduced() if reduced else c
    cfg = replace(pick(get_config(arch)), dtype="float32", **overrides)
    jm = build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jtok = ByteTokenizer(cfg.vocab_size)
    jb = {}
    for name in BUILTIN:
        g, tab = load_grammar(name)
        jb[name] = (g, tab, build_mask_store(g, jtok))
    tcfg = replace(pick(torch_get_config(arch)), dtype="float32",
                   **overrides)
    ttok = TorchByteTokenizer(tcfg.vocab_size)
    tb = {}
    for name in BUILTIN:
        g, tab = torch_load_grammar(name)
        tb[name] = (g, tab, torch_build_store(g, ttok))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jp))
    return (jm, jp, jtok, jb, torch_build_model(tcfg, device="cpu"),
            tparams, ttok, tb)


class _WritableRowEngine(JaxEngine):
    """The reference engine with one host-side repair: its
    `_resolve_span_selection` demotes ids in place in
    `np.asarray(masked[b, idx])`, which this JAX version hands out
    read-only (ValueError as soon as a first span pick fails the
    oracle). A writable numpy copy of the masked span goes in instead;
    the values, and so the tokens, are the same."""

    def _resolve_span_selection(self, st, masked_dev, *args):
        return super()._resolve_span_selection(st, np.array(masked_dev),
                                               *args)


def writable_sequential_mask(monkeypatch):
    """The same repair for the reference's sequential `_step`, which
    demotes ids in place in `np.asarray(masked)` of a JAX array: its mask
    op hands back a writable numpy copy of the same values."""
    import repro.serving.engine as jax_engine
    op = jax_engine.apply_grammar_mask
    monkeypatch.setattr(jax_engine, "apply_grammar_mask",
                        lambda *a, **kw: np.array(op(*a, **kw)))


def engines(sides, max_len, sampled=False, **kw):
    """-> (reference engine, port engine) with the same keywords; with
    `sampled` the port draws the reference's own Gumbel noise."""
    jm, jp, jtok, jb, tm, tp, ttok, tb = sides
    return (_WritableRowEngine(jm, jp, jtok, jb, max_len=max_len, **kw),
            Engine(tm, tp, ttok, tb, max_len=max_len, device="cpu",
                   noise_fn=jax_noise_fn if sampled else None, **kw))


def jax_noise_fn(keys, V):
    """The reference's noise for these keys, as the port's noise_fn."""
    return torch.from_numpy(np.array(jax_gumbel(jnp.asarray(keys), V)))


def requests(specs):
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


def tokens(states):
    return {s.req.rid: (s.token_ids, s.finish_reason) for s in states}


def assert_valid(states, bundles):
    """The paper's claim: completed outputs parse, partial ones are
    prefixes of the language."""
    for st in states:
        if not st.req.grammar:
            continue
        g, tab, _ = bundles[st.req.grammar]
        if st.finish_reason == "eos":
            assert IncrementalParser(g, tab).recognize(st.generated)
        else:
            IncrementalParser(g, tab).partial_parse(st.generated)
