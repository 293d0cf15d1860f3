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
the cache *sequence* dim goes on model, then head_dim.

Where the reference wraps each rule in a `NamedSharding` tree
(`params_shardings`, ...), the port returns the tree of specs
(`param_specs`, ...) and cuts a rank's block with `shard_slice`. The
serving engine runs the vocabulary split (`vocab_shard`, word-aligned;
see its docstring for how it differs from `serving_store_spec`). The
training rules (FSDP `param_spec(fsdp=True)` when `needs_fsdp`, ZeRO-1
`opt_state_specs`, `batch_specs`) and `cache_specs` are what the dry run
(`launch/dryrun.py`) cuts each device's arguments with and what the
static cost count (`distributed/cost.py`) splits FLOPs, bytes and
collectives by, as the reference's dry run does; no live trainer shards
(the reference's has no mesh either). The trunk rules wait for
`trunk_shard`. All are held to the reference's specs by the tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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


def opt_state_specs(opt, mesh, zero: bool = True):
    """Optimizer-moment specs. With zero=True (ZeRO-1), each moment also
    shards its largest divisible dim not yet sharded over the data
    axes; `step` and 0-dim leaves replicate."""
    def rule(ps, leaf):
        if ps.startswith("['step']") or len(leaf.shape) == 0:
            return ()
        spec = list(param_spec(ps, leaf.shape, mesh))
        while len(spec) < len(leaf.shape):
            spec.append(None)
        if zero:
            dpa = data_axes(mesh)
            best = None
            for i, s in enumerate(spec):
                if s is None and _div(leaf.shape[i], mesh, tuple(dpa)):
                    if best is None or leaf.shape[i] > leaf.shape[best]:
                        best = i
            if best is not None:
                spec[best] = tuple(dpa) if len(dpa) > 1 else dpa[0]
        return tuple(spec)
    return map_with_path(rule, opt, "")


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
# up; the port does not serve it yet.

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
