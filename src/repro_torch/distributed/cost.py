"""Static per-call cost of the port's device calls: FLOPs, HBM bytes and
collective wire bytes, worked out from the config and the call's shapes
(the port's counterpart of `repro.distributed.hlo_cost` and
`repro.distributed.hlo_stats`).

The reference parses the optimized HLO that XLA compiles for a call. The
port has no HLO, so the count here is analytic: each function below
walks the layers a call runs and adds up their contractions. One
function per call kind the engine and the dry run time:
`decode_step` (B, cache_len), `paged_feed` (B, S, pages), `span_decode`
(B, K), `prefill` (B, S), `mask_sample` (B, V, A) and `train_step` (B,
S, microbatch, remat). Each returns the reference's keys: `flops`,
`hbm_bytes`, `wire_bytes`, `collectives`, plus `by_contraction` (the
FLOPs by named contraction, summed over layers). Given a mesh (a
`launch.mesh.MeshShape`, or anything with `.shape` and `.axis_names`)
the four figures are per device, as the reference's post-SPMD HLO gives
them; without one they are the call's on one device, with no wire.

flops -- the reference's definition (`hlo_cost.py`): 2 x |result| x
|contracting dims| for every contraction the reference's function runs,
at every layer. That includes attention against every cache position
(the dense decode reads all L), every KV block `chunked_attention`
computes (blocks above the causal diagonal and outside a window
included, padding of the last block too), the MoE capacity dispatch's
expert einsums over all E experts at C slots a row (`moe.capacity`; C
is at least 8 even for one token), the SSD chunk einsums, the RG-LRU
gate products and rms_norm's sum of squares. Where XLA emits no dot the
count has none either: a contraction over a dim of size 1 (the dense
decode's one-hot cache write at S = 1) and an outer product with
nothing contracted (SSD's `bn,bh,bhp->bhnp`) are elementwise products.
The span decode's one-hot position write (`bsl,bs->bl`) depends on the
positions only, so XLA hoists it out of the layer scan: it counts once
a layer group.
The port's kernels skip some of this work (flash attention skips the
tiles above the causal diagonal; the paged kernel reads only the pages
a slot holds); the count does not change with that: it is a fixed
yardstick of the reference's work, not of the kernel's.

A train step counts the loss's forward, its backward and, under remat,
the recomputed forward, as the reference's compiled HLO does: each
contraction's backward is two contractions of its own size (one per
operand), except rms_norm's sum of squares, whose gradient XLA emits as
elementwise products; the recompute of a checkpointed layer body skips
its last contraction when that only feeds the body's residual output
(the FFN's `w_down`, the SSM's `w_out`: XLA drops the dead product),
and the lm head's chunked loss is recomputed only when it runs more
than one chunk (one chunk is merged with the forward). PyTorch's
autograd does more of the same work (it recomputes the whole body and
differentiates the norm with products); `torch_train_extra` names
those contractions for a count of the port's own training run.

hbm_bytes -- the port's own traffic model: the bytes an ideal
implementation of the call must move, independent of fusion (XLA's
fusion-dependent count is not the yardstick):
  * every param leaf the call reads, once (the embedding only at its
    looked-up rows unless it is also the tied lm head; every expert, as
    the capacity dispatch runs all of them);
  * every cache leaf the call reads (the dense cache whole, k, v and
    kv_pos; the paged pool only at the pages the table names), the
    positions it writes, and a recurrent layer's state written whole;
    prefill writes its caches;
  * the call's own inputs and outputs: ids, positions, the page table,
    the logits it writes; for `mask_sample` the logits, the A packed
    store rows a row names, the cd words, the noise when it samples,
    the ids, and the masked logits the kernel writes.
  * a train step moves, beyond its batch: the params read in the
    forward, again in the recompute (remat) and in the backward, the
    gradients written and read once, the layer inputs the checkpoint
    keeps (written in the forward, read in the backward), and AdamW's
    params, gradients and fp32 moments read and params and moments
    written. A microbatched step reads the params once a microbatch
    and accumulates fp32 gradients (read and written once a microbatch).

wire_bytes / collectives -- the reference's ring factors
(`hlo_stats.py`), per device, for a result of b bytes over a group of
N: all-reduce 2(N-1)/N b, all-gather (N-1)/N b, reduce-scatter (N-1) b
(the operand is N results), all-to-all (N-1)/N b, collective-permute b.

Per-device figures under a mesh. The specs are `distributed/sharding.py`'s
(`param_specs` with `needs_fsdp`, `opt_state_specs` with ZeRO-1,
`batch_specs`, `cache_specs`). A contraction's FLOPs split as many ways
as its operands' specs split it: the batch over the data axes that
divide it (`_dp`), a weight's model-sharded dim over "model"; attention
splits over "model" when the heads divide it (q's heads follow wq's
column split). An FSDP-sharded weight is read whole (its model block)
after its all-gather. The collectives counted, each where it falls:
  * the row-parallel all-reduce of the activations after every
    row-parallel product whose contracted dim is on "model" (wo,
    w_down, w_out), and of their gradients after the backward of every
    column-parallel group (the input of wq/wk/wv, of w_gate/w_up, ...);
  * the FSDP all-gather of each data-sharded weight in the forward, and
    again in the recompute under remat, and the reduce-scatter of its
    gradient;
  * the data-parallel all-reduce of every gradient whose moments are not
    split over the data axes (1-D leaves), ZeRO-1's reduce-scatter of
    the other gradients into the moments' shards and the all-gather of
    the updated params out of them;
  * the vocab-parallel lookup's all-reduce of the embedded rows and the
    cross-entropy's combine (max, sum and gold logit over the vocab
    shards, and the lm head input's gradient);
  * the MoE expert-parallel exchange: an all-to-all of the [B, E, C, D]
    dispatch buffer into the experts and of their output back, in the
    forward, the recompute and the backward;
  * in decode against a cache (or a paged pool) whose sequence dim is on
    "model", the all-reduce that joins the partial attention outputs;
    against one whose head_dim is on "model", the all-reduce of the
    fp32 partial scores; and the argmax combine of the served token over
    the vocab shards.
The recurrent kinds split as their leaves do: the SSM's w_in columns,
conv channels, state heads and w_out rows, the RG-LRU's R (its
projections, conv, gates, state and w_out), each by its own rule; their
row-parallel w_out ends in the all-reduce above. The port's trunk-sharded
engine issues more than that count: it joins the column blocks a rank
needs from the others by all-gathers (`models/ssm.py`, `models/rglru.py`;
the tests pin the difference).
These per-device figures are estimates: nobody can compile the 256-device
program the reference counts (its own 8-device test fails for 4 archs).
The tests hold them to hand-worked cases.

Not ported: `hlo_cost.bf16_widening_correction`, which removes an
artifact of XLA's CPU backend (bf16 loop state widened to f32) from
XLA's memory analysis; no such artifact exists here.
"""
from __future__ import annotations

import functools
import math
from collections import defaultdict
from dataclasses import dataclass

from .sharding import (_div, _dp, cache_specs, data_axes, leaves_with_path,
                       needs_fsdp, opt_state_specs, param_specs, ring_len)

# ------------------------------- ring factors -------------------------------

RING = {
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: n - 1,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1,
}


def wire(kind: str, result_bytes: float, n: int) -> float:
    """Wire bytes a device sends for one collective of `kind` whose
    result is `result_bytes` on each of `n` devices (`hlo_stats.py`'s
    ring factors; the reference takes N = max(2, group size))."""
    return RING[kind](max(2, n)) * result_bytes


_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _itemsize(cfg) -> int:
    return _BYTES[cfg.dtype]


# ------------------------------- the tally ---------------------------------

@dataclass
class _Dot:
    name: str
    flops: float        # global, this contraction at every layer
    ways: int           # how many ways a mesh splits it
    remat: bool         # inside a checkpointed layer body
    dead: bool          # dropped from the recompute (see module doc)
    norm: bool          # rms_norm's sum of squares
    bwd: bool = False   # a backward-only contraction (see `ssm`)
    grads: int = 2      # backward products (1: one operand is an input)


class _Tally:
    """The contractions, bytes and collectives of one call."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.dots: list[_Dot] = []
        self.bytes = 0.0
        self.coll = defaultdict(lambda: {"count": 0.0, "wire_bytes": 0.0})
        self.remat = False      # set while a checkpointed body is walked

    @property
    def model(self) -> int:
        return self.mesh.shape["model"] if self.mesh is not None else 1

    def data_ways(self, batch: int) -> int:
        if self.mesh is None:
            return 1
        ax = _dp(self.mesh, batch)
        if ax is None:
            return 1
        ax = ax if isinstance(ax, tuple) else (ax,)
        return math.prod(self.mesh.shape[a] for a in ax)

    def split(self, n: int) -> int:
        """The model ways of a dim of n (1 when it does not divide)."""
        if self.mesh is None or not _div(n, self.mesh, "model"):
            return 1
        return self.model

    def dot(self, name, result, contract, ways=1, dead=False, norm=False,
            bwd=False, grads=2):
        if contract <= 1:       # an elementwise product: no dot in HLO
            return
        self.dots.append(_Dot(name, 2.0 * result * contract, ways,
                              self.remat, dead, norm, bwd, grads))

    def collective(self, kind, result_bytes, n, count=1):
        """`count` collectives of `kind` over n devices, each with a
        result of `result_bytes` (none when nothing is split: n 1 or 0
        bytes, e.g. the all-reduce after a product whose contraction no
        rule splits)."""
        if n <= 1 or count == 0 or result_bytes == 0:
            return
        d = self.coll[kind]
        d["count"] += count
        d["wire_bytes"] += count * wire(kind, result_bytes, n)

    def result(self, flops, flops_dev, by):
        coll = {k: dict(v) for k, v in self.coll.items()}
        w = sum(v["wire_bytes"] for v in coll.values())
        dev = self.mesh is not None
        return {"flops": flops_dev if dev else flops,
                "hbm_bytes": self.bytes, "wire_bytes": w,
                "collectives": coll, "flops_global": flops,
                "by_contraction": dict(by)}

    def forward(self):
        """-> result dict of the forward contractions as walked."""
        by = defaultdict(float)
        f = fd = 0.0
        for d in self.dots:
            if d.bwd:
                continue
            by[d.name] += d.flops
            f += d.flops
            fd += d.flops / d.ways
        return self.result(f, fd, by)


# ------------------------------- the layers --------------------------------

def _chunked_len(Sk: int, chunk: int) -> int:
    """Keys `chunked_attention` scores a query against: all of them in
    one block up to `chunk`, else every padded chunk."""
    return Sk if Sk <= chunk else -(-Sk // chunk) * chunk


class _Walk:
    """Walks a call's layers into a tally. `mode` is "train", "prefill"
    or "decode"; B rows of S tokens; `cache` the positions a decode
    attends to (None for train and prefill)."""

    def __init__(self, t: _Tally, cfg, mode, B, S, cache=None,
                 paged=False, vocab=None):
        self.t, self.cfg, self.mode = t, cfg, mode
        self.B, self.S, self.cache, self.paged = B, S, cache, paged
        self.V = vocab or cfg.vocab_size
        self.dw = t.data_ways(B)
        self.it = _itemsize(cfg)

    # ---- pieces ----
    @property
    def T(self):
        return self.B * self.S

    def norm(self, name, tokens=None):
        T = self.T if tokens is None else tokens
        self.t.dot(name, T, self.cfg.d_model, ways=self.dw, norm=True)

    def proj(self, name, din, dout, tokens=None, split=None, dead=False,
             grads=2):
        """x [T, din] @ w [din, dout]; `split` the dim of w a mesh puts
        on "model" (its size), None for a replicated w."""
        T = self.T if tokens is None else tokens
        ways = self.dw * (self.t.split(split) if split else 1)
        self.t.dot(name, T * dout, din, ways=ways, dead=dead, grads=grads)

    def row_reduce(self, n_split, tokens=None):
        """Bytes of the row-parallel all-reduce of the [T, D] activation
        after a product contracted over a dim of n_split (0 when "model"
        does not split it)."""
        if self.t.split(n_split) == 1:
            return 0
        T = self.T if tokens is None else tokens
        return T / self.dw * self.cfg.d_model * self.it

    def heads_ways(self):
        return self.dw * self.t.split(self.cfg.num_heads)

    def attention(self, name, Sq, Sk, chunked=True):
        """Scores and P.V of H heads of Dh: Sq queries against Sk keys
        (through `chunked_attention` when chunked)."""
        cfg = self.cfg
        keys = _chunked_len(Sk, cfg.attn_chunk) if chunked else Sk
        for part in ("scores", "pv"):
            self.t.dot(f"{name}.{part}",
                       self.B * cfg.num_heads * Sq * keys,
                       cfg.resolved_head_dim, ways=self.heads_ways())

    def qkv(self, pre, tokens=None, kv=True):
        cfg = self.cfg
        D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.resolved_head_dim
        self.proj(f"{pre}.wq", D, H * Dh, tokens, split=H * Dh)
        if kv:
            self.proj(f"{pre}.wk", D, K * Dh, tokens, split=K * Dh)
            self.proj(f"{pre}.wv", D, K * Dh, tokens, split=K * Dh)

    def wo(self, pre, tokens=None):
        cfg = self.cfg
        HD = cfg.num_heads * cfg.resolved_head_dim
        self.proj(f"{pre}.wo", HD, cfg.d_model, tokens, split=HD)
        return self.row_reduce(HD, tokens)

    def ffn(self, tokens=None, dead=False, pre="ffn"):
        D, F = self.cfg.d_model, self.cfg.d_ff
        self.proj(f"{pre}.w_gate", D, F, tokens, split=F)
        self.proj(f"{pre}.w_up", D, F, tokens, split=F)
        self.proj(f"{pre}.w_down", F, D, tokens, split=F, dead=dead)
        return self.row_reduce(F, tokens)

    def self_attention(self):
        """The attention sublayer of attn/moe/dec (norm excluded) ->
        activation all-reduce bytes."""
        cfg, B, S = self.cfg, self.B, self.S
        self.qkv("attn")
        if self.mode in ("train", "prefill"):
            self.attention("attn", S, S)
        else:
            L = self.cache
            self.attention("attn", S, L, chunked=False)
            if not self.paged:      # the dense one-hot cache write
                K, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
                self.t.dot("attn.cache_write", 2 * B * L * K * Dh, S,
                           ways=self.dw)
                if not self._pos_done:  # hoisted out of the layer scan
                    self.t.dot("attn.cache_pos", B * L, S, ways=self.dw)
                    self._pos_done = True
        return self.wo("attn")

    # ---- kinds: each -> the bytes of its row-parallel all-reduces ----
    def attn(self, last):
        ar = [self.self_attention()]
        self.norm("attn.ln1")
        self.norm("attn.ln2")
        return ar + [self.ffn(dead=last)]

    def moe(self, last):
        cfg, B, S = self.cfg, self.B, self.S
        from ..models.moe import capacity
        ar = [self.self_attention()]
        self.norm("attn.ln1")
        self.norm("attn.ln2")
        E, D, F = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
        C = capacity(cfg, S)
        self.proj("moe.router", D, E, split=E)
        ways = self.dw * self.t.split(E)
        for w in ("w_gate", "w_up"):
            self.t.dot(f"moe.{w}", B * E * C * F, D, ways=ways)
        self.t.dot("moe.w_down", B * E * C * D, F, ways=ways)
        if self.t.split(E) > 1:     # the expert-parallel exchange
            self.a2a += B / self.dw * E * C * D * self.it
        return ar

    def cross(self, last):
        cfg = self.cfg
        Sm = cfg.num_image_tokens
        self.norm("cross.ln1")
        self.norm("cross.ln2")
        self.qkv("cross", kv=False)
        if self.mode != "decode":
            # K/V of the batch's image embeddings, an input with no
            # gradient: their backward is the weights' product only
            K, Dh, D = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
            for n in ("cross.wk", "cross.wv"):
                self.proj(n, D, K * Dh, self.B * Sm, split=K * Dh, grads=1)
        self.attention("cross", self.S, Sm)
        return [self.wo("cross"), self.ffn(dead=last)]

    def dec(self, last):
        cfg = self.cfg
        Sa = cfg.audio_frames
        ar = [self.self_attention()]
        for n in ("dec.ln1", "dec.lnx", "dec.ln2"):
            self.norm(n)
        self.qkv("xattn", kv=False)
        if self.mode != "decode":
            K, Dh, D = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
            self.proj("xattn.wk", D, K * Dh, self.B * Sa, split=K * Dh)
            self.proj("xattn.wv", D, K * Dh, self.B * Sa, split=K * Dh)
        self.attention("xattn", self.S, Sa)
        return ar + [self.wo("xattn"), self.ffn(dead=last)]

    def rec(self, last):
        cfg = self.cfg
        D, R = cfg.d_model, cfg.lru_dim
        self.norm("rec.ln1")
        self.norm("rec.ln2")
        self.proj("rec.w_gelu", D, R, split=R)
        self.proj("rec.w_rec", D, R, split=R)
        if self.mode == "decode":
            self.t.dot("rec.conv", self.B * R, cfg.conv_kernel,
                       ways=self.dw * self.t.split(R))
        self.proj("rec.w_a", R, R, split=R)
        self.proj("rec.w_i", R, R, split=R)
        self.proj("rec.w_out", R, D, split=R)
        return [self.row_reduce(R), self.ffn(dead=last)]

    def ssm(self, last):
        cfg, B, S = self.cfg, self.B, self.S
        D, Din, N, Hs, P = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, \
            cfg.ssm_heads, cfg.ssm_head_dim
        self.norm("ssm.ln1")
        dproj = 2 * Din + 2 * N + Hs
        self.proj("ssm.w_in", D, dproj, split=dproj)
        hw = self.dw * self.t.split(Hs)
        if self.mode == "decode":
            self.t.dot("ssm.conv", B * (Din + 2 * N), cfg.conv_kernel,
                       ways=self.dw * self.t.split(Din + 2 * N))
            self.t.dot("ssm.y", B * Hs * P, N, ways=hw)
        else:
            Q = min(cfg.ssm_chunk, S)
            nch = S // Q
            self.t.dot("ssm.CB", B * nch * Q * Q, N, ways=self.dw)
            self.t.dot("ssm.y_intra", B * nch * Q * Hs * P, Q, ways=hw)
            self.t.dot("ssm.state", B * nch * Hs * N * P, Q, ways=hw)
            self.t.dot("ssm.y_inter", B * nch * Q * Hs * P, N, ways=hw)
            # three-operand einsums: the product with dt (state) and with
            # the decay (y_inter) contracts nothing going forward, but
            # their gradients contract over P
            for n in ("ssm.state.d_dt", "ssm.y_inter.d_decay"):
                self.t.dot(n, B * nch * Q * Hs, P, ways=hw, bwd=True)
        self.proj("ssm.w_out", Din, D, split=Din, dead=last)
        return [self.row_reduce(Din)]

    # ---- the model ----
    def encoder(self):
        """Whisper's encoder over audio_frames (not checkpointed in the
        reference: its scan body has no remat)."""
        cfg = self.cfg
        Sa, Te = cfg.audio_frames, self.B * cfg.audio_frames
        for i in range(cfg.encoder_layers):
            self.norm("enc.ln1" if i else "enc.ln1.first", Te)
            self.norm("enc.ln2", Te)
            self.qkv("enc", Te)
            self.attention("enc", Sa, Sa)
            self.wo("enc", Te)
            self.ffn(Te, dead=True, pre="enc.ffn")

    def trunk(self):
        """Every decoder layer, each group's pattern body checkpointed in
        training under remat -> (the bytes of every row-parallel
        all-reduce, the bytes of the MoE exchanges' buffers)."""
        from ..models.model import layer_groups
        ars = []
        self.a2a = 0.0
        for pat, count in layer_groups(self.cfg):
            self._pos_done = False
            for _ in range(count):
                self.t.remat = self.mode == "train" and self.cfg.remat
                for j, kind in enumerate(pat):
                    ars += getattr(self, kind)(last=j == len(pat) - 1)
                self.t.remat = False
        return ars, self.a2a

    def head(self):
        D = self.cfg.d_model
        self.norm("final_norm")
        self.proj("lm_head", D, self.V, split=self.V)


# ------------------------------- bytes --------------------------------------

@functools.lru_cache(maxsize=64)
def meta_params(cfg):
    """The param tree on the meta device (shapes and dtypes only)."""
    from ..models.model import Model
    return Model(cfg, device="meta").abstract_params()


def _param_leaves(cfg):
    """(path, shape, itemsize) of every param leaf."""
    return tuple((p, tuple(x.shape), x.dtype.itemsize)
                 for p, x in leaves_with_path(meta_params(cfg)))


def _spec_ways(spec, mesh, skip_data=False) -> int:
    """How many blocks `spec` cuts a leaf into (the data axes left out
    with skip_data: the block an FSDP gather makes whole)."""
    if mesh is None:
        return 1
    dax = set(data_axes(mesh))
    ways = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            if skip_data and a in dax:
                continue
            ways *= mesh.shape[a]
    return ways


def leaves_with_specs(tree, specs, path: str = ""):
    """Yield (path string, leaf, spec) over a tree and the spec tree a
    rule maps it to (`param_specs`, `cache_specs`, ...): a spec is a
    tuple, so the two trees are walked side by side."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_specs(v, specs[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_specs(v, specs[i], f"{path}[{i}]")
    elif tree is not None:
        yield path, tree, specs


def _flat_specs(tree, specs) -> dict:
    return {p: s for p, _, s in leaves_with_specs(tree, specs)}


def _leaf_specs(cfg, mesh, fsdp):
    """path -> param spec (keyed by the reference's path strings)."""
    from .sharding import param_spec
    return {p: param_spec(p, s, mesh, fsdp=fsdp)
            for p, s, _ in _param_leaves(cfg)}


def param_bytes(cfg, mesh=None, fsdp=False, tokens=0, vocab=None):
    """Bytes of the params a forward reads on one device: every leaf's
    model block (an FSDP weight is gathered whole before use), the
    embedding only at `tokens` looked-up rows unless it is the tied lm
    head. `vocab` narrows the vocabulary leaves to a rank's share."""
    specs = _leaf_specs(cfg, mesh, fsdp) if mesh is not None else {}
    total = 0.0
    for p, shape, it in _param_leaves(cfg):
        n = math.prod(shape)
        if vocab is not None and p.endswith(("['embed']", "['lm_head']")):
            n = n // cfg.vocab_size * vocab
        if p.endswith("['embed']") and not cfg.tie_embeddings:
            n = tokens * cfg.d_model
            total += n * it
            continue
        total += n * it / _spec_ways(specs.get(p, ()), mesh, skip_data=True)
    return total


def _leaf_bytes(tree, specs=None, mesh=None):
    """(path, bytes on one device under its spec) of every leaf."""
    flat = _flat_specs(tree, specs) if specs is not None else {}
    return [(p, math.prod(x.shape) * x.dtype.itemsize /
             _spec_ways(flat.get(p, ()), mesh))
            for p, x in leaves_with_path(tree)]


def _tree_bytes(tree, specs=None, mesh=None):
    """Bytes of a tree on one device under its spec tree."""
    return sum(b for _, b in _leaf_bytes(tree, specs, mesh))


# ------------------------------- the calls ---------------------------------

def _n_self_attn(cfg) -> int:
    """Layers with a self-attention KV cache (attn, moe, dec)."""
    from ..models.model import layer_groups
    return sum(count for pat, count in layer_groups(cfg)
               for k in pat if k in ("attn", "moe", "dec"))


def _side_bytes(cfg, rows) -> float:
    """The batch's side input: vlm image embeddings, audio frames."""
    n = {"vlm": cfg.num_image_tokens, "audio": cfg.audio_frames}.get(
        cfg.arch_type, 0)
    return rows * n * cfg.d_model * _itemsize(cfg)


def _forward(cfg, mode, B, S, mesh, vocab, cache=None, paged=False):
    """Walk a serving call's forward and count its collectives, its
    params and its ids, positions and logits -> (tally, walk)."""
    t = _Tally(mesh)
    w = _Walk(t, cfg, mode, B, S, cache, paged, vocab)
    if mode == "prefill" and cfg.arch_type == "audio":
        w.encoder()
    ars, a2a = w.trunk()
    w.head()
    rows = w.T / w.dw                   # tokens on one device
    for b in ars:
        t.collective("all-reduce", b, t.model)
    t.collective("all-to-all", a2a, t.model, 2 if a2a else 0)
    if t.split(cfg.vocab_size) > 1:     # the vocab-parallel lookup
        t.collective("all-reduce", rows * cfg.d_model * w.it, t.model)
    t.bytes += param_bytes(cfg, mesh, tokens=rows, vocab=vocab)
    t.bytes += rows * 4 * 2                             # ids, positions
    t.bytes += rows * w.V / t.split(w.V) * w.it         # logits written
    return t, w


def decode_step(cfg, B: int, cache_len: int, mesh=None, vocab=None):
    """One `Model.decode_step` of B rows against dense caches built for
    `cache_len` positions (ring caches hold min(cache_len, window)).
    `vocab` narrows the lm head and the logits to a rank's share of a
    split vocabulary."""
    return span_decode(cfg, B, 1, cache_len, mesh=mesh, vocab=vocab)


def _kv_exchange(t, cfg, spec, rows, S, L):
    """GSPMD's exchange for one device's attention over a k/v leaf split
    by `spec` ([c, B|P, L|ps, K, Dh]), at every self-attention layer: a
    cache split on its sequence joins the partial outputs and their max
    and sum in one all-reduce of [rows, H, S, Dh + 2] fp32; one split on
    head_dim all-reduces the fp32 partial scores, [rows, H, S, L]. Split
    by kv heads or whole: nothing."""
    if t.mesh is None:
        return
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    if spec[2] == "model":
        b = rows * H * S * (Dh + 2) * 4
    elif spec[4] == "model":
        b = rows * H * S * L * 4
    else:
        return
    t.collective("all-reduce", b, t.model, _n_self_attn(cfg))


def _kv_ways(cfg, n, mesh) -> int:
    """The model ways `cache_spec` splits a k/v leaf of length n into
    (its kv heads, its length or its head_dim; 1 when whole)."""
    if mesh is None:
        return 1
    return _spec_ways(_kv_spec(cfg, n, mesh), mesh, skip_data=True)


def _kv_spec(cfg, n, mesh):
    """`cache_spec` of a one-row k leaf [1, 1, n, K, Dh]."""
    from .sharding import cache_spec
    return cache_spec("['k']", (1, 1, n, cfg.num_kv_heads,
                                cfg.resolved_head_dim), mesh)


def span_decode(cfg, B: int, K: int, cache_len: int, mesh=None,
                vocab=None):
    """One `Model.decode_span` of K tokens a row against dense caches
    (the speculative verify and the dense prefill chunks)."""
    L = ring_len(cfg, cache_len)
    from ..models.model import Model
    caches = Model(cfg, device="meta").init_decode_caches(B, cache_len)
    t, w = _forward(cfg, "decode", B, K, mesh, vocab, cache=L)
    rows = B / w.dw
    specs = cache_specs(caches, mesh) if mesh is not None else None
    t.bytes += _tree_bytes(caches, specs, mesh)
    # written: K new positions a row at every attention layer (the
    # device's share of each under the cache's split), and the recurrent
    # layers' state whole
    kv = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * w.it
    t.bytes += _n_self_attn(cfg) * rows * K * (
        kv / _kv_ways(cfg, L, mesh) + 4)
    t.bytes += sum(b for p, b in _leaf_bytes(caches, specs, mesh)
                   if p.endswith(("['h']", "['conv']")))
    if mesh is not None and _n_self_attn(cfg):
        _kv_exchange(t, cfg, _kv_spec(cfg, L, mesh), rows, K, L)
    return t.forward()


def paged_feed(cfg, B: int, S: int, pages: int, page_size: int,
               mesh=None, vocab=None):
    """One paged span feed (`Engine.span_feed_paged`): B rows of S
    tokens through a [B, pages] page table of `page_size` pages. FLOPs:
    attention against every table entry's positions (the reference
    gathers them all); bytes: the pool at the pages the table names,
    the S positions written a row, the table and the feed mask, and the
    logits of every fed position. Under a mesh, per device: the pool's
    share that `cache_spec` gives a device (its kv heads, its in-page
    offsets or its head_dim; all of it when whole), and the exchange of
    a split pool (`_kv_exchange`)."""
    L = pages * page_size
    t, w = _forward(cfg, "decode", B, S, mesh, vocab, cache=L, paged=True)
    kv = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * w.it / \
        _kv_ways(cfg, page_size, mesh)
    t.bytes += _n_self_attn(cfg) * B * (L + S) * kv
    t.bytes += B * pages * 4 + B * S + B * 4
    if mesh is not None and _n_self_attn(cfg):
        _kv_exchange(t, cfg, _kv_spec(cfg, page_size, mesh), B / w.dw, S,
                     L)
    return t.forward()


def prefill(cfg, B: int, S: int, mesh=None, vocab=None):
    """One `Model.prefill` of B rows of S tokens: the logits of every
    position and the caches it writes (whisper's encoder included)."""
    from ..models.model import Model
    caches = Model(cfg, device="meta").init_decode_caches(B, S)
    t, w = _forward(cfg, "prefill", B, S, mesh, vocab)
    specs = cache_specs(caches, mesh) if mesh is not None else None
    t.bytes += _tree_bytes(caches, specs, mesh) + _side_bytes(cfg,
                                                             B / w.dw)
    return t.forward()


def mask_sample(B: int, V: int, A: int, itemsize: int = 4,
                sampled: bool = False):
    """The fused mask + sample (`fused_mask_select`): reads [B, V]
    logits of `itemsize` bytes, the A packed store rows a row names
    (W = ceil(V/32) uint32 words each) and their ids, the cd words, the
    per-row flags and configs (eos, constrained, greedy, temperature,
    top_k, top_p) and, when a row samples, [B, V] fp32 noise; writes the
    ids, the ok flags and the masked logits. No contraction: flops 0."""
    W = -(-V // 32)
    read = B * V * itemsize + B * A * (W + 1) * 4 + B * W * 4 + \
        B * (3 + 3 * 4)
    if sampled:
        read += B * V * 4
    written = B * 4 + B + B * V * itemsize
    return {"flops": 0.0, "hbm_bytes": float(read + written),
            "wire_bytes": 0.0, "collectives": {}, "flops_global": 0.0,
            "by_contraction": {}}


def serve_step(cfg, B: int, cache_len: int, A: int, W: int, mesh=None):
    """The dry run's decode target (the reference's `_jit_target`
    serve_step): `decode_step`, then the grammar mask of its logits
    (A store rows of W words a row, the cd words) and the argmax. Under
    a mesh the logits and the store's words split over "model" when they
    divide, and the argmax joins its (value, index) pairs over the
    shards."""
    out = decode_step(cfg, B, cache_len, mesh=mesh)
    t = _Tally(mesh)
    rows = B / t.data_ways(B)
    V = cfg.vocab_size
    vw = t.split(V)
    ww = t.split(W)
    it = _itemsize(cfg)
    out["hbm_bytes"] += rows * (V / vw * it * 2 + A * (W / ww + 1) * 4 +
                                W / ww * 4 + 1 + 4)
    if vw > 1:
        c = out["collectives"].setdefault("all-reduce",
                                          {"count": 0.0, "wire_bytes": 0.0})
        c["count"] += 1
        b = wire("all-reduce", rows * 8, t.model)
        c["wire_bytes"] += b
        out["wire_bytes"] += b
    return out


def _loss_chunks(S: int, seq_chunk: int = 1024) -> int:
    C = min(seq_chunk, S)
    return S // C if S % C == 0 else 1


def _train_walk(cfg, B, S, mesh=None):
    t = _Tally(mesh)
    w = _Walk(t, cfg, "train", B, S)
    if cfg.arch_type == "audio":
        w.encoder()
    ars, a2a = w.trunk()
    head_at = len(t.dots)
    w.head()
    return t, w, ars, a2a, head_at


def train_step(cfg, B: int, S: int, microbatch: int = 1, remat=None,
               mesh=None, seq_chunk: int = 1024):
    """One train step: `Model.loss`, its gradients (the reference's
    `value_and_grad`) and AdamW, over B rows of S tokens in `microbatch`
    slices (the FLOPs do not change with the slicing). `remat` defaults
    to `cfg.remat`."""
    from dataclasses import replace
    if remat is not None and remat != cfg.remat:
        cfg = replace(cfg, remat=remat)
    t, w, ars, a2a, head_at = _train_walk(cfg, B, S, mesh)
    # ---- FLOPs: forward, recompute, backward ----
    by = defaultdict(float)
    f = fd = 0.0
    recompute_head = _loss_chunks(S, seq_chunk) > 1
    for i, d in enumerate(t.dots):
        if d.bwd:
            n = 1.0
        else:
            n = 1.0 + (d.remat and not d.dead) + \
                (i >= head_at and recompute_head) + \
                (0 if d.norm else d.grads)
        by[d.name] += n * d.flops
        f += n * d.flops
        fd += n * d.flops / d.ways
    # ---- collectives ----
    M, rows, it = t.model, w.T / w.dw, w.it
    rem = int(cfg.remat)
    for b in ars:       # forward (and recompute), and the gradients'
        t.collective("all-reduce", b, M, 2 + rem)
    t.collective("all-to-all", a2a, M, 2 * (2 + rem) if a2a else 0)
    if t.split(cfg.vocab_size) > 1:
        t.collective("all-reduce", rows * cfg.d_model * it, M)  # lookup
        t.collective("all-reduce", rows * 4, M,                  # CE
                     3 * (1 + recompute_head))
        t.collective("all-reduce", rows * cfg.d_model * it, M)  # head dx
    fsdp = mesh is not None and needs_fsdp(meta_params(cfg), mesh)
    if mesh is not None:
        _grad_collectives(t, cfg, mesh, fsdp, rem)
    # ---- bytes ----
    mb = max(1, microbatch)
    state = param_state_bytes(cfg, mesh, fsdp)
    p_read = param_bytes(cfg, mesh, fsdp, tokens=rows / mb)
    t.bytes = mb * p_read * (2 + rem)       # forward, backward, recompute
    if cfg.remat:                           # the checkpointed layer inputs
        t.bytes += 2 * cfg.num_layers * rows * cfg.d_model * it
    if mb > 1:                              # fp32 accumulation
        t.bytes += mb * 2 * state["moments"] / 2
    t.bytes += 2 * state["grads"]           # written, read by AdamW
    t.bytes += 2 * state["params"] + 2 * state["moments"] * 2
    t.bytes += rows * (4 + 4 + 4) + _side_bytes(cfg, rows)
    return t.result(f, fd, by)


def param_state_bytes(cfg, mesh=None, fsdp=False) -> dict:
    """Bytes on one device of the params as stored (`param_specs`), of
    their gradients (same specs and dtype) and of the two fp32 AdamW
    moments (`opt_state_specs`, ZeRO-1)."""
    out = {"params": 0.0, "grads": 0.0, "moments": 0.0}
    pspec = ospec = {}
    if mesh is not None:
        tree = meta_params(cfg)
        pspec = _flat_specs(tree, param_specs(tree, mesh, fsdp=fsdp))
        ospec = _flat_specs({"mu": tree}, opt_state_specs({"mu": tree},
                                                          mesh))
    for p, shape, it in _param_leaves(cfg):
        n = math.prod(shape)
        pw = _spec_ways(pspec.get(p, ()), mesh)
        ow = _spec_ways(ospec.get("['mu']" + p, ()), mesh)
        out["params"] += n * it / pw
        out["grads"] += n * it / pw
        out["moments"] += 2 * n * 4 / ow
    return out


def _grad_collectives(t, cfg, mesh, fsdp, rem):
    """FSDP's gathers and reduce-scatters, the data-parallel gradient
    all-reduce, ZeRO-1's reduce-scatter in and all-gather out."""
    tree = meta_params(cfg)
    pspec = _flat_specs(tree, param_specs(tree, mesh, fsdp=fsdp))
    ospec = _flat_specs({"mu": tree}, opt_state_specs({"mu": tree}, mesh))
    n_data = math.prod(mesh.shape[a] for a in data_axes(mesh))
    for p, shape, it in _param_leaves(cfg):
        ps, os_ = pspec[p], ospec["['mu']" + p]
        block = math.prod(shape) * it / _spec_ways(ps, mesh, skip_data=True)
        d_p = round(_spec_ways(ps, mesh) /
                    _spec_ways(ps, mesh, skip_data=True))
        d_o = round(_spec_ways(os_, mesh) /
                    _spec_ways(os_, mesh, skip_data=True))
        if d_p > 1:                     # FSDP
            t.collective("all-gather", block, d_p, 1 + rem)
            t.collective("reduce-scatter", block / d_p, d_p)
        elif d_o > 1:                   # ZeRO-1
            t.collective("reduce-scatter", block / d_o, d_o)
            t.collective("all-gather", block, d_o)
        else:
            t.collective("all-reduce", block, n_data)


def torch_train_extra(cfg, B: int, S: int, remat=None,
                      seq_chunk: int = 1024) -> dict:
    """Contractions PyTorch's autograd runs in a train step beyond the
    reference's count (`train_step`), by name (negative where it runs
    fewer): rms_norm's sum of squares differentiated as two batched
    products of its own size (not the first encoder layer's: the frames
    take no gradient); the lm head's chunk recomputed even when the
    loss runs one chunk; the attention scores the backward recomputes
    (`attention_bwd` is FlashAttention-2's: it keeps the log-sum-exp,
    not the probabilities); whisper's encoder layers recomputed under
    remat (the port checkpoints them, the reference does not); and SSD's
    backward-only products, which autograd forms as elementwise
    products and sums. `torch.utils.checkpoint` stops its recompute at
    the last tensor the backward needs, so it drops the dead last
    product as XLA does."""
    from dataclasses import replace
    if remat is not None and remat != cfg.remat:
        cfg = replace(cfg, remat=remat)
    t, _, _, _, head_at = _train_walk(cfg, B, S)
    extra = defaultdict(float)
    one_chunk = _loss_chunks(S, seq_chunk) == 1
    for i, d in enumerate(t.dots):
        n = -1.0 if d.bwd else 0.0
        if cfg.remat and d.name.startswith("enc.") and not d.dead:
            n += 1.0
        if d.norm and d.name != "enc.ln1.first":
            n += 2.0
        if d.name.endswith(".scores"):
            n += 1.0
        if i >= head_at and one_chunk:
            n += 1.0
        if n:
            extra[d.name] += n * d.flops
    return dict(extra)
