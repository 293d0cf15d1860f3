"""Per-architecture sharding rules (port of `repro.distributed.sharding`).

A spec is a plain tuple with one entry per dim: None (replicated), a mesh
axis name, or a tuple of axis names (the dim split over their product,
major to minor) -- the entries of the reference's `PartitionSpec`. A
mesh here is anything with `.shape` (axis name -> size) and
`.axis_names`: the port's `launch.mesh.ServingMesh`, or a stand-in for
the production meshes, which no single host has.

Mesh axes: ("data", "model") single-pod 16x16, ("pod", "data", "model")
multi-pod 2x16x16. The pod axis is pure data parallelism (batch sharded
over ("pod","data")).

Parameter rules (megatron-style tensor parallelism on "model"):
  * column-parallel (wq/wk/wv/w_gate/w_up/w_in/...): last dim on model
  * row-parallel (wo/w_down/w_out): contracted dim on model
  * MoE expert weights [E,D,F]: expert dim on model (expert parallelism)
  * embed [V,D] / lm_head [D,V]: vocab dim on model
  * 1-D params replicate; any non-divisible dim falls back to replicated
    (e.g. smollm's 15 heads on a 16-way model axis).

KV caches: batch on data; kv-head dim on model when divisible, otherwise
the cache *sequence* dim goes on model, else head_dim, else the leaf is
replicated.

Where the reference wraps each rule in a `NamedSharding` tree
(`params_shardings`, ...), the port returns the tree of specs
(`param_specs`, ...) and cuts a rank's block with `shard_slice`. The
serving engine runs the vocabulary split (`vocab_shard`, word-aligned;
see its docstring for how it differs from `serving_store_spec`). The
training rules (FSDP `param_spec(fsdp=True)` when `needs_fsdp`, ZeRO-1
`opt_state_specs`, `batch_specs`) and `cache_specs` are what the dry run
(`launch/dryrun.py`) cuts each device's arguments with and what the
static cost count (`distributed/cost.py`) splits FLOPs, bytes and
collectives by, as the reference's dry run does, and what a sharded
train step cuts each rank's params, moments and batch rows with
(`train_plan`: the reference's `_jit_target` train step on a (data,
model) mesh). Under `trunk_shard=True` the
serving engine cuts each trunk leaf by `serving_param_spec(...,
trunk_shard=True)` and each cache and pool leaf by `serving_cache_specs`
(`trunk_plan` says what that splits: a cache by its kv heads, its
sequence, its head_dim or not at all, as the reference's rule picks;
`trunk_slice` is one leaf's cut). All are held to the
reference's specs by the tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes, with no processes behind them: what the
    rules read (`launch/mesh.py`'s meshes are these with ranks)."""
    shape: dict
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _div(n, mesh, axis) -> bool:
    if isinstance(axis, tuple):
        size = math.prod(mesh.shape[a] for a in axis)
    else:
        size = mesh.shape[axis]
    return n % size == 0


def _dp(mesh, n):
    """data axes if divisible, else fewer axes, else None."""
    axes = data_axes(mesh)
    if _div(n, mesh, tuple(axes)):
        return tuple(axes) if len(axes) > 1 else axes[0]
    if len(axes) > 1 and _div(n, mesh, axes[-1]):
        return axes[-1]
    return None


def _leaf_name(path_str: str) -> str:
    return path_str.rsplit("['", 1)[-1].rstrip("']")


_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_gelu", "w_rec",
        "w_a", "w_i", "router")
_ROW = ("wo", "w_down", "w_out")


def param_spec(path_str: str, shape, mesh, fsdp: bool = False) -> tuple:
    """Sharding rule for one parameter leaf. Leaves under ['groups'] /
    ['encoder'] carry one leading layer-stack dim (never sharded). With
    fsdp=True, the largest remaining divisible dim is also sharded over
    the data axes (FSDP: gathered at its use sites) -- for the >=33B archs
    whose weights exceed a device under tensor parallelism alone."""
    stacked = ("['groups']" in path_str) or ("['encoder']" in path_str)
    pre = (None,) if stacked else ()
    core = tuple(shape[1:]) if stacked else tuple(shape)
    name = _leaf_name(path_str)

    def mp(n):
        return "model" if _div(n, mesh, "model") else None

    is_moe = "['moe']" in path_str
    if len(core) <= 1:
        spec = [None] * len(core)
    elif is_moe and name in ("w_gate", "w_up", "w_down") and len(core) == 3:
        spec = [mp(core[0]), None, None]        # expert parallelism
    elif name == "embed":
        spec = [mp(core[0]), None]
    elif name == "lm_head":
        spec = [None, mp(core[1])]
    elif name in _COL:
        spec = [None] * (len(core) - 1) + [mp(core[-1])]
    elif name in _ROW:
        spec = [None] * len(core)
        spec[-2] = mp(core[-2])
    elif name == "conv_w":
        spec = [None, mp(core[-1])]
    else:
        spec = [None] * len(core)

    if fsdp and len(core) >= 2:
        dpa = data_axes(mesh)
        dax = tuple(dpa) if len(dpa) > 1 else dpa[0]
        best = None
        for i, s in enumerate(spec):
            if s is None and _div(core[i], mesh, tuple(dpa)):
                if best is None or core[i] > core[best]:
                    best = i
        if best is not None:
            spec[best] = dax
    return (*pre, *spec)


def needs_fsdp(params, mesh, budget_bytes: float = 3.5e9) -> bool:
    """True when the weights exceed `budget_bytes` a device under tensor
    parallelism alone. Leaves need `.shape` and a `.dtype` with
    `.itemsize` (torch tensors, meta tensors included, or numpy arrays)."""
    total = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                for _, leaf in leaves_with_path(params))
    return total / mesh.shape["model"] > budget_bytes


# ------------------------------ tree walking ------------------------------

def leaves_with_path(tree, path: str = ""):
    """Yield (path string, leaf) over a nested dict/list/tuple tree; the
    path string is the reference's `jax.tree_util.keystr` of the leaf
    (dict keys as ['k'], sequence positions as [i]), which the rules
    read."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def map_with_path(fn, tree, path: str = ""):
    """The tree with each leaf replaced by fn(path string, leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(map_with_path(fn, v, f"{path}[{i}]")
                     for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params, mesh, fsdp: bool = False):
    return map_with_path(
        lambda p, leaf: param_spec(p, leaf.shape, mesh, fsdp=fsdp), params)


def opt_state_spec(ps: str, shape, mesh, zero: bool = True) -> tuple:
    """Rule for one optimizer-state leaf at path `ps` (under ['mu'] or
    ['nu']). With zero=True (ZeRO-1), a moment also shards its largest
    divisible dim not yet sharded over the data axes; `step` and 0-dim
    leaves replicate."""
    shape = tuple(shape)
    if ps.startswith("['step']") or len(shape) == 0:
        return ()
    spec = list(param_spec(ps, shape, mesh))
    while len(spec) < len(shape):
        spec.append(None)
    if zero:
        dpa = data_axes(mesh)
        best = None
        for i, s in enumerate(spec):
            if s is None and _div(shape[i], mesh, tuple(dpa)):
                if best is None or shape[i] > shape[best]:
                    best = i
        if best is not None:
            spec[best] = tuple(dpa) if len(dpa) > 1 else dpa[0]
    return tuple(spec)


def opt_state_specs(opt, mesh, zero: bool = True):
    """Optimizer-moment specs (`opt_state_spec` for every leaf)."""
    return map_with_path(
        lambda ps, leaf: opt_state_spec(ps, leaf.shape, mesh, zero), opt, "")


def batch_specs(batch, mesh):
    def rule(_, leaf):
        nd = len(leaf.shape)
        dp = _dp(mesh, leaf.shape[0]) if nd else None
        return (dp, *([None] * (nd - 1))) if nd else (None,)
    return map_with_path(rule, batch)


def cache_spec(path_str: str, shape, mesh) -> tuple:
    """Rule for one cache leaf ([count, B, ...] stacked trees)."""
    name = _leaf_name(path_str)
    shape = tuple(shape)
    if len(shape) < 2:
        return ()
    dp = _dp(mesh, shape[1])
    if name in ("k", "v") and len(shape) == 5:
        _, _, L, K, Dh = shape
        if _div(K, mesh, "model"):
            return (None, dp, None, "model", None)
        if _div(L, mesh, "model"):
            return (None, dp, "model", None, None)   # sequence-sharded
        if _div(Dh, mesh, "model"):
            return (None, dp, None, None, "model")
        return (None, dp, None, None, None)
    if name == "kv_pos" and len(shape) == 3:
        return (None, dp, None)
    if name == "h" and len(shape) == 5:             # ssm state [c,B,Hs,N,P]
        mp = "model" if _div(shape[2], mesh, "model") else None
        return (None, dp, mp, None, None)
    if name == "h" and len(shape) == 3:             # rglru state [c,B,R]
        mp = "model" if _div(shape[2], mesh, "model") else None
        return (None, dp, mp)
    if name == "conv" and len(shape) == 4:
        mp = "model" if _div(shape[3], mesh, "model") else None
        return (None, dp, None, mp)
    return (None,) * len(shape)


def cache_specs(caches, mesh, cfg=None):
    if caches is None:
        return None
    return map_with_path(lambda p, leaf: cache_spec(p, leaf.shape, mesh),
                         caches)


# ======================= serving tensor parallelism ========================
# The sharded serving engine promises token-for-token identical output to
# the single-device engine, which constrains WHAT may be sharded: only dims
# that are never contracted, i.e. the vocabulary family -- embed [V, D]
# rows (the lookup's combine adds the true row to zeros), lm_head [D, V]
# columns (each shard computes its logit columns with the whole
# contraction over D), the packed mask store [R, W] words and the mask
# math on them. The trunk and every KV cache stay replicated; ONE gather
# of the masked logits precedes the selection. `trunk_shard=True` (the
# megatron-style `param_spec` / `cache_spec` rules) gives that identity
# up: the row-parallel products end in an all-reduce whose sum runs in
# another order than the one-device product's (`trunk_plan`).

def serving_param_spec(path_str: str, shape, mesh, cfg,
                       trunk_shard: bool = False) -> tuple:
    """Rule for one serving param (vocab-parallel; see above)."""
    stacked = ("['groups']" in path_str) or ("['encoder']" in path_str)
    pre = (None,) if stacked else ()
    core = tuple(shape[1:]) if stacked else tuple(shape)
    name = _leaf_name(path_str)

    def mp(n):
        return "model" if _div(n, mesh, "model") else None

    if name == "embed" and len(core) == 2:
        return (*pre, mp(core[0]), None)
    if name == "lm_head" and len(core) == 2:
        return (*pre, None, mp(core[1]))
    if trunk_shard:
        return param_spec(path_str, shape, mesh)
    return (*pre, *([None] * len(core)))


def serving_param_specs(params, mesh, cfg, trunk_shard: bool = False):
    return map_with_path(
        lambda p, leaf: serving_param_spec(p, leaf.shape, mesh, cfg,
                                           trunk_shard=trunk_shard), params)


def serving_cache_specs(caches, mesh, cfg, trunk_shard: bool = False):
    """KV caches and page pools of the sharded engine: replicated (the
    bit-exact default); trunk_shard=True defers to `cache_specs`, whose
    dense [c,B,L,K,Dh] rule covers the pools' [c,P,ps,K,Dh] leaves too."""
    if caches is None:
        return None
    if trunk_shard:
        return cache_specs(caches, mesh, cfg)
    return map_with_path(lambda _, leaf: (None,) * len(leaf.shape), caches)


def serving_store_spec(mesh, num_words: int) -> tuple:
    """The reference's rule for the packed store [R, W]: the word dim on
    "model" when divisible, else replicated. The port's engine splits at
    word boundaries instead (`vocab_shard`)."""
    return (None, "model" if _div(num_words, mesh, "model") else None)


def serving_rules(mesh, cfg, trunk_shard: bool = False) -> dict:
    """Logical-name rules of the sharded serving engine (see
    distributed/api.py): replication rules mark the hard gather points
    before math that must stay bit-exact."""
    mp_v = "model" if _div(cfg.vocab_size, mesh, "model") else None
    kv_mp = "model" if trunk_shard and cfg.num_kv_heads and \
        _div(cfg.num_kv_heads, mesh, "model") else None
    return {
        "act_bsd": (None, None, None),
        "attn_kv": (None, None, kv_mp, None),
        "logits_bsv": (None, None, mp_v),
        "logits_bv": (None, mp_v),
        "attn_out_in": (None, None, None),
        "ffn_hidden": (None, None, None),
        # the selector's single combine: the masked [B(*S), V] gathered
        # once before the sort/cumsum/draw (a cumsum over a sharded vocab
        # axis is not bit-exact)
        "sample_logits": (None, None),
    }


def activation_rules(mesh, cfg, batch_size: int,
                     seq_parallel: bool = False) -> dict:
    """Logical-name rules of training and prefill at scale.
    seq_parallel=True shards the activations' sequence dim over `model`
    (for heads that do not divide the model axis)."""
    dpa = _dp(mesh, batch_size)
    mp_v = "model" if _div(cfg.vocab_size, mesh, "model") else None
    kv_mp = "model" if cfg.num_kv_heads and _div(cfg.num_kv_heads, mesh,
                                                 "model") else None
    return {
        "act_bsd": (dpa, "model" if seq_parallel else None, None),
        "attn_kv": (dpa, None, kv_mp, None),
        "logits_bsv": (dpa, None, mp_v),
        "logits_bv": (dpa, mp_v),
        "moe_becd": (dpa, None, None,
                     "model" if _div(cfg.d_model, mesh, "model") else None),
    }


# ------------------------------ per-rank cuts ------------------------------

def mesh_coords(mesh, rank: int) -> dict:
    """Axis name -> this rank's coordinate (ranks row-major over the
    mesh axes, as a device grid is laid out)."""
    coords = {}
    for a in reversed(tuple(mesh.axis_names)):
        n = mesh.shape[a]
        coords[a] = rank % n
        rank //= n
    return coords


def shard_slice(spec, shape, mesh, rank: int) -> tuple:
    """The block of a `shape` leaf that rank `rank` of `mesh` holds under
    `spec`: one slice per dim. A dim over several axes splits over their
    product, the first axis major. Raises ValueError when a sharded dim
    does not divide (the rules never ask for that)."""
    coords = mesh_coords(mesh, rank)
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for n, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(0, n))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts, idx = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if n % parts:
            raise ValueError(f"dim of {n} does not split {parts} ways")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


# -------------------------- the vocabulary split --------------------------

def word_range(rank: int, size: int, words: int) -> tuple:
    """Words [w0, w1) of rank `rank` of `size`: ceil(W/size) each, the
    last rank the remainder (empty when the ranks outnumber the words)."""
    per = -(-words // size)
    return min(rank * per, words), min((rank + 1) * per, words)


@dataclass(frozen=True)
class VocabShard:
    """One rank's share of the vocabulary in the sharded engine.

    The split follows the packed mask store's uint32 words: rank s of M
    owns words [s*ceil(W/M), min((s+1)*ceil(W/M), W)), i.e. vocab ids
    [32*w0, min(32*w1, V)), so the mask kernel reads its own words from
    bit 0 with no shift. This differs from the reference's rule (split
    V and W only when M divides them; `serving_store_spec`): where V/M is
    not a multiple of 32 (V 50280 at M = 2) the reference reshards
    between the logits and the store, the port never does. The tokens
    are the same either way. When some rank would get no word (W < M, or
    the remainder runs out), the vocabulary stays replicated (`split`
    False), as the reference replicates a dim that does not divide."""
    vocab: int
    size: int
    rank: int
    split: bool
    w0: int
    w1: int
    widths: tuple       # every rank's number of vocab ids

    @property
    def words(self) -> int:
        return -(-self.vocab // 32)

    @property
    def v0(self) -> int:
        return 32 * self.w0

    @property
    def v1(self) -> int:
        return min(32 * self.w1, self.vocab)

    @property
    def width(self) -> int:
        return self.v1 - self.v0

    def local_id(self, token_id: int) -> int:
        """A global id as this rank's column, or -1 when another rank
        owns it (the mask kernel then never opens it)."""
        return token_id - self.v0 if self.v0 <= token_id < self.v1 else -1


def vocab_shard(vocab: int, size: int, rank: int) -> VocabShard:
    words = -(-vocab // 32)
    ranges = [word_range(s, size, words) for s in range(size)]
    if any(w1 <= w0 for w0, w1 in ranges):
        return VocabShard(vocab, size, rank, False, 0, words,
                          (vocab,) * size)
    widths = tuple(min(32 * w1, vocab) - 32 * w0 for w0, w1 in ranges)
    w0, w1 = ranges[rank]
    return VocabShard(vocab, size, rank, True, w0, w1, widths)


def vocab_slice(path_str: str, shape, shard: VocabShard) -> tuple:
    """The block of one serving param that a rank holds: embed's rows and
    lm_head's columns of its vocab ids (the leaves `serving_param_spec`
    puts on "model"), everything else whole."""
    full = tuple(slice(0, n) for n in shape)
    if not shard.split:
        return full
    name = _leaf_name(path_str)
    ids = slice(shard.v0, shard.v1)
    if name == "embed" and len(shape) == 2:
        return (ids, full[1])
    if name == "lm_head" and len(shape) == 2:
        return (full[0], ids)
    return full


# ------------------------------ the trunk split -----------------------------

# the layer kinds a rank runs over its block of the trunk; the others (the
# vlm's cross, the audio family's enc and dec) refuse trunk_shard
TRUNK_KINDS = ("attn", "moe", "ssm", "rec")


def ring_len(cfg, cache_len: int) -> int:
    """Positions an attention layer's dense cache holds in an engine of
    `cache_len` positions: min(cache_len, window), where the window is
    the hybrid's `local_window` (its attention layers are local) or else
    `sliding_window` (0: none)."""
    w = cfg.local_window if cfg.arch_type == "hybrid" else \
        cfg.sliding_window
    return min(cache_len, w) if w else cache_len


@dataclass(frozen=True)
class TrunkPlan:
    """What `trunk_shard=True` splits on a "model" axis of `size` ranks,
    seen from rank `rank`: the blocks `serving_param_spec(...,
    trunk_shard=True)` and `serving_cache_specs` give it, read leaf by
    leaf from those rules. `d_ff` splits when M divides it (`ff_split`,
    else every rank holds the whole FFN), the experts likewise
    (`experts_split`). `heads`, `kv_heads`, `d_ff` and `experts` are the
    counts one rank's layers run over.

    Where M divides the kv heads, q heads, kv heads (cache and pool
    leaves too) and the QKV columns split whole heads (`cache` and
    `pool` "heads"): rank r holds q heads [rH/M, (r+1)H/M) and kv heads
    [rK/M, (r+1)K/M), so q head h still reads kv head h // (H/K). Where
    it does not (`gathers`), wq/wk/wv keep their column blocks
    `q_cols`/`kv_cols` (None: the leaf whole), which may cut inside a
    head, so the rank gathers whole q/k/v heads (one all-gather) and
    runs every head; wo's rows `wo_rows` (None: whole) take the rank's
    columns of the whole attention output. Each kind of cache then takes
    the reference's next branch for its own length, read from
    `cache_spec`: the dense caches of `cache_len` positions (`cache`)
    and the pools of `page_size`-position pages (`pool`) may differ.
      * "seq": rank r holds positions `positions` = [rL/M, (r+1)L/M) of
        every dense cache, or in-page offsets `offsets` = [r ps/M, (r+1)
        ps/M) of every page, all kv heads of each; it attends over them
        (a partial attention with its log-sum-exp) and the partials are
        joined (one all-gather).
      * "dh": rank r holds head_dim block `head_dims` = [r Dh/M, (r+1)
        Dh/M) of every position; its fp32 partial scores are all-reduced,
        masked and softmaxed once, and its block of P.V gathered.
      * "whole": every rank holds the whole leaf and attends as one
        device does.
    A kind of cache the plan was not given a length for is None.

    The recurrent kinds keep their widths in `local_config` and run over
    blocks (start, stop), each None where the rule leaves its leaves
    whole. ssm (Mamba2): `ssm_in`, w_in's columns of [z | xBC | dt];
    `ssm_conv`, the xBC channels of conv_w and of the conv cache;
    `ssm_heads`, the state's heads; `ssm_rows`, w_out's rows (the heads'
    channels whenever the heads split). rec (RG-LRU): `rec_width`, the
    block of R that w_gelu, w_rec, conv_w, w_a and w_i (columns), the
    state and the conv cache (channels) and w_out (rows) all take."""
    size: int
    rank: int
    heads: int
    kv_heads: int
    d_ff: int
    experts: int
    ff_split: bool
    experts_split: bool
    cache: Optional[str] = None
    pool: Optional[str] = None
    q_cols: Optional[tuple] = None
    kv_cols: Optional[tuple] = None
    wo_rows: Optional[tuple] = None
    positions: Optional[tuple] = None
    offsets: Optional[tuple] = None
    head_dims: Optional[tuple] = None
    ssm_in: Optional[tuple] = None
    ssm_conv: Optional[tuple] = None
    ssm_heads: Optional[tuple] = None
    ssm_rows: Optional[tuple] = None
    rec_width: Optional[tuple] = None

    @property
    def split(self) -> bool:
        """False at M = 1: every block is the whole leaf."""
        return self.size > 1

    @property
    def gathers(self) -> bool:
        """True where M does not divide the kv heads: the rank gathers
        whole q/k/v and runs every head."""
        return self.split and self.cache != "heads"

    def local_config(self, cfg):
        """The rank-local view of `cfg` its layers run over: its q and kv
        heads (all of them where it gathers), its share of d_ff;
        head_dim, the expert count, the expert width, the vocabulary and
        the recurrent widths stay whole (routing and capacity read the
        global E; the recurrent layers read their blocks from the plan)."""
        kw = dict(num_heads=self.heads, num_kv_heads=self.kv_heads,
                  head_dim=cfg.resolved_head_dim, d_ff=self.d_ff)
        if cfg.num_experts:
            kw["moe_d_ff"] = cfg.expert_d_ff
        return replace(cfg, **kw)


def _trunk_kinds(cfg) -> set:
    from ..models.model import layer_groups
    kinds = {k for pat, _ in layer_groups(cfg) for k in pat}
    if cfg.arch_type == "audio":
        kinds.add("enc")
    return kinds


def _block(spec, shape, mesh, rank, dim):
    """(start, stop) of dim `dim` of rank's block under `spec`, or None
    when the spec leaves that dim whole."""
    if spec[dim] is None:
        return None
    sl = shard_slice(spec, shape, mesh, rank)[dim]
    return sl.start, sl.stop


def _recurrent_blocks(cfg, kinds, mesh, rank, where) -> dict:
    """The ssm and rec blocks of `TrunkPlan`, each read from its leaf's
    rule (a one-layer stacked param, a one-layer one-row cache)."""
    D, Kc = cfg.d_model, cfg.conv_kernel

    def param(kind, name, shape, dim):
        shape = (1, *shape)
        return _block(param_spec(f"['groups'][0][0]['{kind}']['{name}']",
                                 shape, mesh), shape, mesh, rank, dim + 1)

    def cache(name, shape, dim):
        shape = (1, 1, *shape)
        return _block(cache_spec(f"['{name}']", shape, mesh), shape, mesh,
                      rank, dim + 2)
    out = {}
    if "ssm" in kinds:
        Din, N, Hs, P = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_head_dim)
        C = Din + 2 * N
        conv = param("ssm", "conv_w", (Kc, C), 1)
        heads = cache("h", (Hs, N, P), 0)
        rows = param("ssm", "w_out", (Din, D), 0)
        if cache("conv", (Kc - 1, C), 1) != conv or heads is not None and \
                rows != (heads[0] * P, heads[1] * P):
            raise ValueError(f"{where}: the ssm's conv_w and conv cache, or "
                             f"its state heads and w_out rows, split "
                             f"unlike each other (not served)")
        out.update(ssm_in=param("ssm", "w_in", (D, 2 * Din + 2 * N + Hs),
                                1), ssm_conv=conv, ssm_heads=heads,
                   ssm_rows=rows)
    if "rec" in kinds:
        R = cfg.lru_dim
        blocks = {"w_gelu": param("rec", "w_gelu", (D, R), 1),
                  "w_rec": param("rec", "w_rec", (D, R), 1),
                  "conv_w": param("rec", "conv_w", (Kc, R), 1),
                  "w_a": param("rec", "w_a", (R, R), 1),
                  "w_i": param("rec", "w_i", (R, R), 1),
                  "w_out": param("rec", "w_out", (R, D), 0),
                  "h": cache("h", (R,), 0),
                  "conv": cache("conv", (Kc - 1, R), 1)}
        if len(set(blocks.values())) > 1:
            raise ValueError(f"{where}: the rec leaves split R unlike each "
                             f"other {blocks} (not served)")
        out["rec_width"] = blocks["w_out"]
    return out


def _kv_split(spec) -> str:
    """The branch a k/v spec [c, B, L, K, Dh] (a dense cache, or a pool
    [c, P, ps, K, Dh]) takes, in the reference's order of preference
    (`cache_spec`): its kv heads, its sequence, its head_dim, or the
    whole leaf on every rank."""
    for name, dim in (("heads", 3), ("seq", 2), ("dh", 4)):
        if spec[dim] == "model":
            return name
    return "whole"


def trunk_plan(cfg, M: int, rank: int = 0, cache_len=None,
               page_size=None) -> TrunkPlan:
    """The trunk split of `cfg` over M ranks. At M = 1 nothing is split.
    `cache_len` is the attention layers' dense caches' length (max_len,
    or a smaller window: `serving_trunk_plan`) and `page_size` the
    pools' page, each when the engine holds such caches: the branch each
    kind of cache takes is read from `cache_spec` at that length (see
    `TrunkPlan`). Above M = 1, raises ValueError (naming the config, M
    and the layer kinds) for a layer kind other than attn, moe, ssm and
    rec: the vlm and audio families, which the engine does not serve."""
    M = int(M)
    if M < 1:
        raise ValueError(f"trunk_shard: M must be >= 1, got {M}")
    H, K, F, E = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_experts
    if M == 1:
        return TrunkPlan(1, 0, H, K, F, E, False, False)
    where = f"trunk_shard: {cfg.name} at M = {M}"
    kinds = _trunk_kinds(cfg)
    other = sorted(kinds - set(TRUNK_KINDS))
    if other:
        raise ValueError(f"{where}: layer kinds {other} ({cfg.arch_type}) "
                         f"are not trunk-sharded; the port splits only "
                         f"{TRUNK_KINDS}")
    mesh = MeshShape({"data": 1, "model": M}, ("data", "model"))
    ff, ex = F % M == 0, bool(E) and E % M == 0
    own = dict(d_ff=F // M if ff else F, experts=E // M if ex else E,
               ff_split=ff, experts_split=ex,
               **_recurrent_blocks(cfg, kinds, mesh, rank, where))
    if not kinds & {"attn", "moe"}:
        return TrunkPlan(M, int(rank), H, K, **own)
    D, Dh = cfg.d_model, cfg.resolved_head_dim
    col = lambda name, n: _block(param_spec(
        f"['groups'][0][0]['attn']['{name}']", (1, D, n), mesh),
        (1, D, n), mesh, rank, 2)
    wo = (1, H * Dh, D)
    own.update(q_cols=col("wq", H * Dh), kv_cols=col("wk", K * Dh),
               wo_rows=_block(param_spec("['groups'][0][0]['attn']['wo']",
                                         wo, mesh), wo, mesh, rank, 1))
    cache = lambda n: (1, 1, n, K, Dh)
    if _kv_split(cache_spec("['k']", cache(1), mesh)) == "heads":
        return TrunkPlan(M, int(rank), H // M, K // M, cache="heads",
                         pool="heads", **own)
    for what, n, block in (("cache", cache_len, "positions"),
                           ("pool", page_size, "offsets")):
        if n is None:
            continue
        spec = cache_spec("['k']", cache(n), mesh)
        own[what] = _kv_split(spec)
        if own[what] == "seq":
            own[block] = _block(spec, cache(n), mesh, rank, 2)
        elif own[what] == "dh":
            own["head_dims"] = _block(spec, cache(n), mesh, rank, 4)
    return TrunkPlan(M, int(rank), H, K, **own)


def serving_trunk_plan(cfg, M: int, rank: int, max_len: int,
                       page_size=None) -> TrunkPlan:
    """`trunk_plan` for a serving engine of `max_len` positions: its
    dense attention caches hold `ring_len(cfg, max_len)` positions (the
    hybrid's local window, as `Model.init_decode_caches` sizes them),
    its pools pages of `page_size` (None: not paged)."""
    return trunk_plan(cfg, M, rank, cache_len=ring_len(cfg, max_len),
                      page_size=page_size)


def trunk_slice(path_str: str, shape, mesh, rank: int,
                shard: VocabShard) -> tuple:
    """The block of one serving param that rank `rank` holds under
    trunk_shard: `vocab_slice` for embed and lm_head (the word-aligned
    vocabulary split), `shard_slice` of `serving_param_spec(...,
    trunk_shard=True)` for every other leaf."""
    if _leaf_name(path_str) in ("embed", "lm_head"):
        return vocab_slice(path_str, shape, shard)
    spec = serving_param_spec(path_str, shape, mesh, None, trunk_shard=True)
    return shard_slice(spec, tuple(shape), mesh, rank)


# ======================== the sharded training plan ========================
# The reference's sharded train step (`launch/dryrun.py::_jit_target`,
# train mode) places params by `params_shardings(fsdp=...)`, AdamW's
# moments by `opt_state_shardings` (ZeRO-1) and the batch by
# `batch_shardings`, and GSPMD inserts the collectives. The port's rank
# holds the blocks those specs give it on a (data, model) mesh and calls
# the collectives itself (`training/optimizer.py`,
# `training/train_loop.py`, and under a model axis the model code through
# `distributed/api.py::use_model`).

# the layer kinds a train step splits over a model axis above 1
TRAIN_MODEL_KINDS = ("attn", "moe")


def _data_dim(spec):
    """The dim a spec splits over the data axes, or None (on a (data,
    model) mesh the rules put "data" in at most one entry)."""
    for i, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else (e,)
        if "data" in axes:
            return i
    return None


def _model_part(spec) -> tuple:
    """A spec with its data axes taken out (the model axis alone)."""
    return tuple(e if e == "model" else None for e in spec)


def _rel(sl, block) -> tuple:
    return tuple(slice(a.start - b.start, a.stop - b.start)
                 for a, b in zip(sl, block))


@dataclass(frozen=True)
class LeafPlan:
    """One param leaf in a sharded step: `shape` the whole leaf's;
    `block` the rank's block on the model axis (the whole leaf at model
    1), the tensor its forward runs over, and `mdim` the dim the model
    axis splits (None: whole); `pdim` the dim FSDP splits over data
    (None: every rank of the data group holds the model block); `odim`
    the dim ZeRO-1 splits its moments (and the gradient accumulator)
    over (None: whole on the data group); `param` and `moment` the
    rank's blocks as slices of the whole leaf. The FSDP and moment dims
    need not agree: the moments' rule looks at every dim of the leaf,
    FSDP's never at the stacked layer dim."""
    path: str
    shape: tuple
    pdim: Optional[int]
    odim: Optional[int]
    param: tuple
    moment: tuple
    block: tuple
    mdim: Optional[int] = None

    @property
    def param_in_block(self) -> tuple:
        """`param` as slices of the model block."""
        return _rel(self.param, self.block)

    @property
    def moment_in_block(self) -> tuple:
        """`moment` as slices of the model block (a gradient arrives as
        the model block)."""
        return _rel(self.moment, self.block)


@dataclass(frozen=True)
class TrainPlan:
    """What one rank of a (data, model) mesh holds in the reference's
    sharded train step: `rank` its data coordinate, `model_rank` its
    model coordinate, `leaves` in the params' flattening order. Under a
    model axis above 1, `trunk` is the rank's `TrunkPlan` (read from the
    leaves' own blocks) and `vocab` its rows (v0, v1) of embed and
    lm_head, or None where the vocabulary is whole."""
    data: int
    rank: int
    fsdp: bool
    leaves: tuple
    model: int = 1
    model_rank: int = 0
    trunk: Optional[TrunkPlan] = None
    vocab: Optional[tuple] = None

    def rows(self, B: int, microbatch: int = 1) -> tuple:
        """-> (replicated, [slice of global rows a microbatch]). The
        reference reshapes the batch [B, ...] to [microbatch, B/mb, ...]:
        microbatch i is global rows [i*B/mb, (i+1)*B/mb), and its rows
        split over the data ranks as `batch_specs` splits B (the model
        ranks of a data coordinate run the same rows). Where
        `batch_specs` replicates the batch (B does not divide over the
        data ways), every rank runs every row of each microbatch:
        `replicated` is True and the gradients must not be summed over
        the ranks. Raises ValueError where the microbatches do not cut
        evenly: B not a multiple of mb (replicated) or of mb*data."""
        mb = int(microbatch)
        mesh = MeshShape({"data": self.data, "model": 1},
                         ("data", "model"))
        replicated = self.data > 1 and _dp(mesh, B) is None
        ways = 1 if replicated else self.data
        if mb < 1 or B % (mb * ways):
            raise ValueError(
                f"batch of {B} rows does not split into microbatch {mb} x "
                f"data {ways} (B must be a multiple of {mb * ways})")
        per, mine = B // mb, B // (mb * ways)
        r = 0 if replicated else self.rank
        return replicated, [slice(i * per + r * mine, i * per + (r + 1) * mine)
                            for i in range(mb)]


def _trunk_blocks(cfg, M, m, tp: TrunkPlan) -> dict:
    """Leaf name -> (dim from the end, (start, stop)) of the model block
    `tp` runs each layer leaf over (None: whole)."""
    F, E = cfg.d_ff, cfg.num_experts
    ff = (m * F // M, (m + 1) * F // M) if tp.ff_split else None
    ex = (m * E // M, (m + 1) * E // M) if tp.experts_split else None
    q, kv, wo = tp.q_cols, tp.kv_cols, tp.wo_rows
    return {"attn": {"wq": (1, q), "wk": (1, kv), "wv": (1, kv),
                     "wo": (2, wo)},
            "ffn": {"w_gate": (1, ff), "w_up": (1, ff), "w_down": (2, ff)},
            "moe": {"router": (1, ex), "w_gate": (3, ex), "w_up": (3, ex),
                    "w_down": (3, ex)}}


def _check_trunk(path, shape, block, blocks, where):
    """Raise where a layer leaf's model block is not the one the trunk
    plan runs it over."""
    if "['groups']" not in path:
        return
    name = _leaf_name(path)
    sub = "moe" if "['moe']" in path else "ffn" if "['ffn']" in path \
        else "attn" if "['attn']" in path else None
    want = blocks.get(sub, {}).get(name)
    have = [(i, (sl.start, sl.stop)) for i, (sl, n) in
            enumerate(zip(block, shape)) if (sl.start, sl.stop) != (0, n)]
    if want is None or want[1] is None:
        ok = not have
    else:
        ok = have == [(len(shape) - want[0], want[1])]
    if not ok:
        raise ValueError(f"{where}: {path} has model block {have}, the "
                         f"trunk plan runs it over {want}")


def train_plan(params, mesh, fsdp: bool = False, rank: int = 0,
               cfg=None) -> TrainPlan:
    """The per-rank plan of a sharded train step for the WHOLE param tree
    `params` (tensors, meta tensors or anything with `.shape`) on a
    (data, model) mesh, for the rank at place `rank` of the mesh
    (row-major: data coordinate x model + model coordinate; at model 1,
    the data coordinate): each leaf's model block from `param_spec` (no
    FSDP: the model axis alone), its param block from
    `param_specs(fsdp=...)`, its moment block from
    `opt_state_specs(zero=True)`, all cut with `shard_slice`, in the
    reference's leaf order (dict keys sorted, as `training/tree.py`
    flattens). Above model 1 `cfg` is the params' config: the rank's
    `TrunkPlan` is `trunk_plan(cfg, M, m)` (no cache: training has none),
    checked leaf by leaf against the blocks the specs give; its
    vocabulary rows are embed's model block. Raises ValueError (naming
    the config, M and the kinds) for a layer kind other than attn and
    moe under a model axis above 1, or where a leaf's blocks and the
    trunk plan disagree."""
    from ..training.tree import flatten_with_path
    M = mesh.shape.get("model", 1)
    coords = mesh_coords(mesh, rank)
    m = coords.get("model", 0)
    tp = blocks = None
    where = f"training mesh {dict(mesh.shape)}"
    if M > 1:
        if cfg is None:
            raise ValueError(f"{where}: a model axis needs the config")
        where = f"{where}: {cfg.name} at M = {M}"
        other = sorted(_trunk_kinds(cfg) - set(TRAIN_MODEL_KINDS))
        if other:
            raise ValueError(f"{where}: layer kinds {other} "
                             f"({cfg.arch_type}) are not split over the "
                             f"model axis in training; the port splits "
                             f"only {TRAIN_MODEL_KINDS}")
        tp = trunk_plan(cfg, M, m)
        blocks = _trunk_blocks(cfg, M, m, tp)
    out, vocab = [], None
    for path, leaf in flatten_with_path(params):
        shape = tuple(leaf.shape)
        pspec = param_spec(path, shape, mesh, fsdp=fsdp)
        ospec = opt_state_spec("['mu']" + path, shape, mesh)
        mspec = param_spec(path, shape, mesh)
        if _model_part(pspec) != _model_part(mspec) or \
                _model_part(ospec) != _model_part(mspec):
            raise ValueError(f"{where}: {path}'s param, FSDP and moment "
                             f"specs {mspec}, {pspec}, {ospec} split the "
                             f"model axis unlike each other")
        block = shard_slice(mspec, shape, mesh, rank)
        mdim = next((i for i, e in enumerate(mspec) if e == "model"),
                    None) if M > 1 else None
        if blocks is not None:
            _check_trunk(path, shape, block, blocks, where)
            if _leaf_name(path) in ("embed", "lm_head") and mdim is not None:
                vocab = (block[mdim].start, block[mdim].stop)
        out.append(LeafPlan(
            path, shape, _data_dim(pspec), _data_dim(ospec),
            shard_slice(pspec, shape, mesh, rank),
            shard_slice(ospec, shape, mesh, rank), block, mdim))
    return TrainPlan(mesh.shape["data"], coords["data"], bool(fsdp),
                     tuple(out), M, m, tp, vocab)
