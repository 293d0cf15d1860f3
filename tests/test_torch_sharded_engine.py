"""Tensor-parallel serving of the port (`Engine(mesh=...)`, vocab
parallelism over `torch.distributed`) against the unsharded port, token
for token, on the CPU: gloo ranks started by the port's own
`launch.mesh.spawn`, worlds of 1 (in this process), 2 and 4 ranks, at
vocab 2048 (word-aligned shards) and 1000 (W 32: shards of 512/488 ids at
M = 2 and 256/256/256/232 at M = 4), on the narrow fp32 syncode-demo
with the reference's `Model.init(PRNGKey(0))` weights bridged in.

Every case of `tests/_torch_sharded_cases.py` runs once per world from
one module fixture (the 2- and 4-rank worlds in the background while this
process runs the unsharded port and the 1-rank world); each comparison is
its own test: greedy and sampled `generate()` per builtin grammar, the
unconstrained request, speculative greedy, paged with a shared prefix,
mixed grammars in a two-grammar store, sequential, opportunistic, each
rank's store holding only its words, and at M = 2 an AsyncEngine with a
hot grammar load and one request cancelled mid-decode on rank 0 (the
others follow its loop).
One case is also held against the JAX single-device engine."""
import threading
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.decoding import DecodeConfig as JaxDecodeConfig
from repro.core.grammars import load_grammar as jax_load_grammar
from repro.core.mask_store import build_mask_store as jax_build_store
from repro.core.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models.model import build_model
from repro.serving.engine import Request as JaxRequest
from repro_torch.core.grammars import load_grammar
from repro_torch.core.mask_store import build_mask_store
from repro_torch.core.tokenizer import ByteTokenizer
from repro_torch.distributed.sharding import vocab_shard
from repro_torch.launch.mesh import spawn
from tests import _torch_sharded_cases as C
from tests._torch_parity import _WritableRowEngine

VOCABS = (2048, 1000)
WORLDS = (1, 2, 4)
ASYNC_WORLD, ASYNC_VOCAB = 2, 2048
PER_GRAMMAR = ("greedy", "sampled")
WHOLE = ("speculative", "paged", "mixed", "sequential", "opportunistic")


def _jax_config(V):
    return replace(get_config("syncode-demo"), dtype="float32",
                   vocab_size=V, **C.NARROW)


def _payload(V):
    """(reference weights as numpy leaves, port tokenizer, port bundles)."""
    jp = build_model(_jax_config(V)).init(jax.random.PRNGKey(0))
    tok = ByteTokenizer(V)
    bundles = {}
    for name in C.GRAMMARS:
        g, tab = load_grammar(name)
        bundles[name] = (g, tab, build_mask_store(g, tok))
    return jax.tree.map(np.asarray, jp), tok, bundles


@pytest.fixture(scope="module")
def runs():
    """-> (unsharded results {V: ...}, sharded {M: [rank results]})."""
    payload = {V: _payload(V) for V in VOCABS}
    sharded, errors = {}, []

    def world(n):
        try:
            sharded[n] = spawn(
                n, C.world, (n, VOCABS, ASYNC_VOCAB if n == ASYNC_WORLD
                             else None), payload, device="cpu")
        except BaseException as e:          # re-raised below
            errors.append(e)
    bg = [threading.Thread(target=world, args=(n,)) for n in WORLDS
          if n > 1]
    for t in bg:
        t.start()
    base = {V: C.run_cases(None, V, *payload[V]) for V in VOCABS}
    world(1)
    for t in bg:
        t.join()
    if errors:
        raise errors[0]
    return base, sharded


CASES = [(case, g) for case in PER_GRAMMAR
         for g in C.GRAMMARS + (None,)] + [(case, "-") for case in WHOLE]


@pytest.mark.parametrize("case,grammar", CASES)
@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("M", WORLDS)
def test_sharded_tokens_equal_unsharded(runs, M, V, case, grammar):
    base, sharded = runs
    want = base[V][case]
    if case in PER_GRAMMAR:
        reqs = {"greedy": C.greedy_requests,
                "sampled": C.sampled_requests}[case]()
        rids = {r.rid for r in reqs if r.grammar == grammar}
        assert rids
        want = {rid: v for rid, v in want.items() if rid in rids}
    for rank, res in enumerate(sharded[M]):
        got = res[V][case]
        if case in PER_GRAMMAR:
            got = {rid: v for rid, v in got.items() if rid in rids}
        assert got == want, f"rank {rank} of {M}"


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("M", WORLDS)
def test_each_rank_store_holds_its_words(runs, M, V):
    base, sharded = runs
    W = -(-V // 32)
    for rank, res in enumerate(sharded[M]):
        vs = vocab_shard(V, M, rank)
        assert vs.split
        for which, (R, W_full) in base[V]["stores"].items():
            assert W_full == W
            assert res[V]["stores"][which] == (R, vs.w1 - vs.w0)
        assert res[V]["mesh_devices"] == M
        assert res[V]["paged_hit_rate"] == base[V]["paged_hit_rate"] > 0


def test_async_cancel_on_rank_zero_reaches_every_rank(runs):
    """Rank 0's AsyncEngine hot-loads a grammar and cancels one request
    mid-decode; the follower registers the grammar and finishes the
    request at the same step. The other requests equal the unsharded
    engine's sync run (the hot-loaded grammar is calc's bundle under
    another name), and the cancelled one is a prefix of it."""
    base, sharded = runs
    sync = base[ASYNC_VOCAB]["async_sync"]
    ranks = [res[ASYNC_VOCAB]["async_cancel"] for res in sharded[ASYNC_WORLD]]
    assert all(r == ranks[0] for r in ranks[1:])
    for rid, (ids, reason) in ranks[0].items():
        if rid != C.CANCEL_RID:
            assert (ids, reason) == sync[rid]
            continue
        assert reason == "cancelled"
        full = sync[rid][0]
        assert len(full) > len(ids) >= C.CANCEL_AFTER + 1
        assert ids == full[:len(ids)]


def test_sharded_matches_the_jax_engine(runs):
    """Greedy over all six grammars at M = 2, vocab 2048, against the
    reference's single-device engine on the same weights."""
    _, sharded = runs
    V = 2048
    cfg = _jax_config(V)
    jtok = JaxTokenizer(V)
    jb = {}
    for name in C.GRAMMARS:
        g, tab = jax_load_grammar(name)
        jb[name] = (g, tab, jax_build_store(g, jtok))
    jm = build_model(cfg)
    jeng = _WritableRowEngine(jm, jm.init(jax.random.PRNGKey(0)), jtok, jb,
                              max_len=C.MAX_LEN, slots=4)
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, grammar=r.grammar,
                        max_new_tokens=r.max_new_tokens, seed=r.seed,
                        decode=JaxDecodeConfig(r.decode.method))
             for r in C.greedy_requests()]
    want = C.tokens(jeng.generate(jreqs)[0])
    for res in sharded[2]:
        assert res[V]["greedy"] == want
