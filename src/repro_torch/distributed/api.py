"""Sharding context and the sharded engine's collectives (port of
`repro.distributed.api`).

`use_sharding(mesh, vocab, trunk)` marks the model calls a sharded
engine makes: model code asks `current_vocab()` whether the vocabulary
is split (the embedding lookup's combine, `models/common.py::
embed_tokens`) and `current_trunk()` what of the trunk this rank holds
(`distributed/sharding.py::TrunkPlan`: the row-parallel all-reduces in
`common.attn_out`/`common.ffn`, the QKV bias columns, the expert block in
`models/moe.py`, the channel blocks in `models/ssm.py` and
`models/rglru.py`). The context is per thread, as the reference's is: an
engine enters it around each device call, on whatever thread runs the
step loop. The reference's context also carries the logical-name rules
that `shard_hint` reads; here `shard_hint(x, name)` is the identity, so
the context holds no rules: where the reference asks GSPMD to place an
activation and insert the collectives, the port's ranks each hold their
block and call the collectives below by hand (the engine gathers the
logits itself before it selects).

The collectives of sharded serving, over the mesh's process group
(identities when the mesh has no group, a single process):
  * `vocab_all_reduce`: the embedding lookup's SUM of one true row and
    zeros (exact);
  * `all_gather_last`: blocks joined on the last dim, each padded to the
    widest block for the collective and trimmed after: the masked
    logits before the selection, and under trunk_shard the SSM's
    in-projection and conv output channels and the RG-LRU's conv output
    (the gates contract over all of R);
  * `all_gather_stack` (trunk_shard, the sequence split): every rank's
    equal-shaped tensor, stacked in rank order: the partial attention
    outputs with their log-sum-exp before the combine;
  * `trunk_all_reduce` (trunk_shard): the SUM of the recurrent layers'
    partial w_out products (the SSM's carries its gated norm's sum of
    squares beside the partial), not exact: the sum runs in another
    order than the one-device product's;
  * the attention, FFN and MoE blocks of a trunk split call the model
    axis' Functions below, whose forwards are these same SUMs and
    gathers (under no_grad their backwards cost nothing);
  * `broadcast_control`: the step loop's per-iteration record of what
    rank 0 decided (admissions, cancellations, deadlines, hot loads),
    always in host memory over a gloo group.

The collectives of a data-parallel train step, over the training mesh's
data group (`launch/mesh.py::TrainMesh`; identities without a group):
  * `data_all_reduce`: a SUM over the data ranks, in place: the loss's
    (tot, cnt) and the MoE router's sums and counts, the gradient of a
    leaf whose moments are whole on every rank, the gradient norm's sum
    of squares;
  * `reduce_scatter_block`: the SUM of every rank's whole tensor, of
    which this rank keeps its block along one dim (ZeRO-1's gradients
    into the moments' blocks);
  * `all_gather_block`: the ranks' blocks along one dim joined into the
    whole tensor (ZeRO-1's new params, the gathered params and moments
    of a checkpoint, a reshard between a leaf's FSDP and moment dims);
  * `fsdp_gather`: an FSDP param block gathered at its use, as an
    autograd Function: all-gather forward, reduce-scatter of the
    gradient backward (a slice where every rank ran the same rows).
`use_data(mesh)` marks the model calls of a step whose rows are split
over the data ranks: `current_data()` is then the mesh, and
`Model.loss` and `moe_ffn` normalise over the global batch with it.

The collectives of a trunk split's attention, FFN and MoE blocks, in
serving (the engine's mesh) and in a train step's model axis (a (data,
model) mesh: `TrainMesh.model_mesh`, the ranks of this rank's data
coordinate), each an autograd Function whose backward is its forward's
dual, counted under its call:
  * `model_copy` (Megatron's f): the identity forward, the SUM of the
    ranks' gradients backward, before every split column block's
    product ("col-grad": wq/wk/wv, w_gate/w_up, the lm head; "experts-
    grad": the router and the expert dispatch; "bias-grad": the columns
    a rank takes of a whole QKV bias; "kv-grad": a whole k/v that
    attention under a partial output gradient feeds);
  * `model_sum` (Megatron's g): the SUM forward, the identity backward,
    after every row block ("row-sum": wo, w_down; "experts-sum": the
    experts' combine), after the vocabulary-parallel lookup ("lookup")
    and for the cross-entropy's sums ("ce", beside `model_max`, its row
    max, which takes no gradient); `model_all_reduce` is the same SUM
    outside autograd (the gradient norm's share, "model-gnorm"); the
    SUM runs in place (no product before it saves its output);
  * `model_gather_stack`: the q/k/v column blocks joined into whole heads
    ("qkv-gather"); the gradient that reaches them is a partial (the
    rank uses only its rows of the attention output before wo's rows),
    so the backward is a reduce-scatter ("qkv-scatter");
  * `model_gather_router`: the router's expert columns joined into the
    whole row ("router-gather"), as two outputs: one for the routing,
    whose gradient is a partial (the gates weight only the rank's own
    experts), and one for the aux losses, whose gradient is the same on
    every rank; the backward sums the first ("router-scatter") and adds
    the rank's columns of the second once.
`use_model(mesh, trunk, vocab)` marks the model calls of such a step:
`current_trunk()` and `current_mesh()` then answer as in a trunk-sharded
engine, and `train_model()` gives the model group and the rank's
vocabulary rows. `recompute_context` carries all three contexts into a
checkpointed layer's recompute, which runs in the backward, on the
autograd engine's device thread on the card.
The tensor collectives take tensors where they lie, on NCCL and gloo
alike (gloo took CUDA tensors in torch 2.11 on the H100, so no host
staging is written), and add their count, result bytes and ring wire
bytes (`distributed/cost.py::wire`) to a per-kind tally of the
collectives actually issued (`collective_tally`). Nothing here catches a
collective's error: a failed rank ends the run.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

import torch

from .cost import wire

_state = threading.local()
# kind -> {"count", "bytes" (results), "wire_bytes"}, this process
_tally = defaultdict(lambda: {"count": 0, "bytes": 0, "wire_bytes": 0.0})
# call -> the same, by the call that issued the collective
_calls = defaultdict(lambda: {"count": 0, "bytes": 0, "wire_bytes": 0.0})


def _ctx():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, vocab=None, trunk=None):
    """mesh: the engine's `ServingMesh`; vocab: this rank's
    `VocabShard`, or None; trunk: this rank's `TrunkPlan` under
    trunk_shard, or None (the trunk whole)."""
    prev = _ctx()
    _state.ctx = (mesh, vocab, trunk)
    try:
        yield
    finally:
        _state.ctx = prev


def shard_hint(x, name: str):
    """The identity: the port places nothing by annotation (each rank
    holds its own block; see the module docstring)."""
    return x


def sharding_active() -> bool:
    """True inside a `use_sharding` context."""
    return _ctx() is not None


def current_mesh():
    """The active `use_sharding` mesh, or None."""
    ctx = _ctx()
    return None if ctx is None else ctx[0]


def current_vocab():
    """The active context's `VocabShard`, or None."""
    ctx = _ctx()
    return None if ctx is None else ctx[1]


@contextlib.contextmanager
def use_data(mesh):
    """Mark the model calls of a train step whose batch rows are split
    over `mesh`'s data ranks (a `TrainMesh`; None marks nothing)."""
    prev = getattr(_state, "data", None)
    _state.data = mesh if mesh is not None and mesh.group is not None \
        else None
    try:
        yield
    finally:
        _state.data = prev


def current_data():
    """The active `use_data` mesh, or None (the batch is whole here)."""
    return getattr(_state, "data", None)


@contextlib.contextmanager
def use_model(mesh, trunk, vocab=None):
    """Mark the model calls of a train step whose trunk is split over
    `mesh` (a `TrainMesh.model_mesh`): `trunk` is this rank's
    `TrunkPlan`, `vocab` its rows (v0, v1) of embed and lm_head, or None
    where the vocabulary is whole."""
    prev = (_ctx(), getattr(_state, "model", None))
    _state.ctx = (mesh, None, trunk)
    _state.model = (mesh, vocab)
    try:
        yield
    finally:
        _state.ctx, _state.model = prev


def train_model():
    """(the model group's mesh, this rank's vocabulary rows or None)
    inside `use_model`, else None."""
    return getattr(_state, "model", None)


@contextlib.contextmanager
def _restored(snapshot):
    prev = (_ctx(), getattr(_state, "data", None),
            getattr(_state, "model", None))
    _state.ctx, _state.data, _state.model = snapshot
    try:
        yield
    finally:
        _state.ctx, _state.data, _state.model = prev


def recompute_context():
    """`torch.utils.checkpoint`'s context_fn: the contexts active at the
    forward, entered again around the recompute (the contexts are per
    thread, and the backward of card tensors runs on another thread)."""
    snap = (_ctx(), getattr(_state, "data", None),
            getattr(_state, "model", None))
    return contextlib.nullcontext(), _restored(snap)


def current_trunk():
    """The active context's `TrunkPlan` when it splits the trunk, else
    None."""
    ctx = _ctx()
    return ctx[2] if ctx is not None and ctx[2] is not None and \
        ctx[2].split else None


# ------------------------------ collectives ------------------------------

def collective_tally() -> dict:
    """{kind: {"count", "bytes", "wire_bytes"}} of the tensor collectives
    this process issued since `reset_collective_tally` ("bytes": each
    result's bytes; "wire_bytes": what the reference's ring factors say
    a rank sends for it)."""
    return {k: dict(v) for k, v in _tally.items()}


def collective_calls() -> dict:
    """The same figures keyed by the call that issued each collective
    (the `call` argument of the collectives below, else its kind)."""
    return {k: dict(v) for k, v in _calls.items()}


def reset_collective_tally() -> None:
    _tally.clear()
    _calls.clear()


def _note(kind: str, n: int, mesh, call=None) -> None:
    """One collective of `kind` whose result is n bytes a rank."""
    w = wire(kind, n, mesh.size)
    for d in (_tally[kind], _calls[call or kind]):
        d["count"] += 1
        d["bytes"] += n
        d["wire_bytes"] += w


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x
    _note("all-reduce", x.numel() * x.element_size(), mesh)
    dist.all_reduce(x, group=mesh.group)
    return x


def vocab_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """SUM of x over the mesh's ranks, in place; returns x. With one
    true row and zeros elsewhere the sum is exact in any dtype."""
    return _all_reduce(x, mesh)


def trunk_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """SUM of the ranks' partial products x (a row-parallel product whose
    contraction "model" splits), in place; returns x. Not exact: each
    rank rounds its partial sum, and the collective adds the partials in
    its own order, where the one-device product accumulates the whole
    contraction at once."""
    return _all_reduce(x, mesh)


def all_gather_last(x: torch.Tensor, widths, mesh) -> torch.Tensor:
    """Join every rank's [..., widths[r]] block on the last dim ->
    [..., sum(widths)]. Blocks are padded to the widest for the
    collective and trimmed after; values pass unchanged."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x
    pad = max(widths)
    if x.shape[-1] != pad:
        x = torch.nn.functional.pad(x, (0, pad - x.shape[-1]))
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in widths]
    dist.all_gather(outs, x, group=mesh.group)
    _note("all-gather", x.numel() * x.element_size() * len(widths), mesh)
    return torch.cat([o[..., :w] for o, w in zip(outs, widths)], dim=-1)


def all_gather_stack(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's x (one shape on all ranks), stacked in rank order ->
    [M, *x.shape]; values pass unchanged. Without a group: x[None]."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x[None]
    x = x.contiguous()
    out = x.new_empty((mesh.size, *x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=mesh.group)
    _note("all-gather", out.numel() * out.element_size(), mesh)
    return out


def broadcast_control(obj, mesh):
    """Rank 0's `obj` on every rank, pickled into a byte tensor in host
    memory over the mesh's gloo group (`ctrl_group`), whatever the
    tensors' backend. Over NCCL the bytes would be copied to the card,
    and that blocking copy waits for the step the loop has queued, which
    undoes the overlap of host and card work once an iteration
    (`scripts/shard_probe.py` times both routes). Followers pass None."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.global_rank(0),
                               group=mesh.ctrl_group)
    return box[0]


# ------------------------- data-parallel training -------------------------

def data_all_reduce(x: torch.Tensor, mesh, call="all-reduce"):
    """SUM of x over the mesh's data ranks, in place; returns x."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x
    _note("all-reduce", x.numel() * x.element_size(), mesh, call)
    dist.all_reduce(x, group=mesh.group)
    return x


def global_share(local: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """`total` (a sum over the data ranks) in value, `local` (this rank's
    term of it) in gradient: summing the ranks' gradients then gives the
    gradient of the total."""
    return total + (local - local.detach())


def reduce_scatter_block(x: torch.Tensor, dim: int, mesh,
                         call="reduce-scatter") -> torch.Tensor:
    """SUM of every rank's whole x, cut along `dim` into equal blocks in
    rank order: this rank's block (a new tensor)."""
    import torch.distributed as dist
    n = mesh.size if mesh is not None and mesh.group is not None else 1
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=mesh.group)
    _note("reduce-scatter", out.numel() * out.element_size(), mesh, call)
    return out.movedim(0, dim)


def all_gather_block(x: torch.Tensor, dim: int, mesh,
                     call="all-gather") -> torch.Tensor:
    """Every rank's block x, joined along `dim` in rank order (a new
    tensor); values pass unchanged."""
    import torch.distributed as dist
    n = mesh.size if mesh is not None and mesh.group is not None else 1
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] * n, *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    _note("all-gather", out.numel() * out.element_size(), mesh, call)
    return out.movedim(0, dim).contiguous()


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, dim, mesh, replicated):
        ctx.dim, ctx.mesh, ctx.replicated = dim, mesh, replicated
        ctx.width = block.shape[dim]
        return all_gather_block(block, dim, mesh, call="fsdp-gather")

    @staticmethod
    def backward(ctx, grad):
        if ctx.replicated:      # every rank's grad is already the whole
            w = ctx.width
            return grad.narrow(ctx.dim, ctx.mesh.rank * w, w), None, \
                None, None
        return reduce_scatter_block(grad, ctx.dim, ctx.mesh,
                                    call="fsdp-scatter"), None, None, None


def fsdp_gather(block: torch.Tensor, dim: int, mesh,
                replicated: bool = False) -> torch.Tensor:
    """The whole param from this rank's FSDP block along `dim`: an
    all-gather forward; backward, the SUM of the ranks' gradients
    reduce-scattered into the block, or, where every rank ran the same
    rows (`replicated`), this rank's block of its own gradient."""
    return _FsdpGather.apply(block, dim, mesh, replicated)


# ------------------------ the model axis in training ------------------------

def model_all_reduce(x: torch.Tensor, mesh, call, op=None) -> torch.Tensor:
    """The SUM (or `op`) over the model ranks of x, in place, outside
    autograd; returns x. Identity without a group."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x
    _note("all-reduce", x.numel() * x.element_size(), mesh, call)
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=mesh.group)
    return x


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, call):
        ctx.mesh, ctx.call = mesh, call
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad.contiguous().clone(), ctx.mesh,
                                ctx.call), None, None


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, call):
        # in place: no caller's product saves its output for its backward
        ctx.mark_dirty(x)
        return model_all_reduce(x, mesh, call)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def model_copy(x: torch.Tensor, mesh, call="col-grad") -> torch.Tensor:
    """x forward; backward, the SUM over the model ranks of the gradient
    (the input of a split column block: each rank's gradient is the part
    its columns give)."""
    return _ModelCopy.apply(x, mesh, call)


def model_sum(x: torch.Tensor, mesh, call="row-sum") -> torch.Tensor:
    """The SUM over the model ranks of x (contiguous), in place; returns
    x. Backward, the gradient as it is (the sum feeds work every rank
    runs alike). Not exact where x holds partial products: each rank
    rounds its partial sum, and the collective adds the partials in its
    own order."""
    return _ModelSum.apply(x, mesh, call)


def model_max(x: torch.Tensor, mesh, call="ce") -> torch.Tensor:
    """The elementwise MAX over the model ranks of x (a tensor that takes
    no gradient), in place; returns x."""
    import torch.distributed as dist
    return model_all_reduce(x, mesh, call, dist.ReduceOp.MAX)


def _reduce_scatter0(x, mesh, call):
    """x [M, *s] on every rank -> the SUM over the ranks of x[rank]."""
    import torch.distributed as dist
    out = x.new_empty(x.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), x.contiguous().view(-1),
                               group=mesh.group)
    _note("reduce-scatter", out.numel() * out.element_size(), mesh, call)
    return out


class _GatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, call):
        ctx.mesh, ctx.call = mesh, call
        import torch.distributed as dist
        x = x.contiguous()
        out = x.new_empty((mesh.size, *x.shape))
        dist.all_gather_into_tensor(out.view(-1), x.view(-1),
                                    group=mesh.group)
        _note("all-gather", out.numel() * out.element_size(), mesh,
              call + "-gather")
        return out

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter0(grad, ctx.mesh, ctx.call + "-scatter"), \
            None, None


def model_gather_stack(x: torch.Tensor, mesh, call="qkv") -> torch.Tensor:
    """Every model rank's x stacked in rank order -> [M, *x.shape];
    backward, the SUM over the ranks of each one's gradient of this
    rank's entry (a reduce-scatter: the gradient reaching the stack is a
    partial on each rank)."""
    return _GatherStack.apply(x, mesh, call)


class _GatherRouter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, call):
        ctx.mesh, ctx.call, ctx.w = mesh, call, x.shape[-1]
        got = _GatherStack.forward(ctx, x, mesh, call)   # [M, ..., w]
        whole = got.movedim(0, -2).reshape(*x.shape[:-1], -1)
        return whole, whole.view_as(whole)

    @staticmethod
    def backward(ctx, partial, same):
        w, r = ctx.w, ctx.mesh.rank
        g = partial.reshape(*partial.shape[:-1], ctx.mesh.size, w)
        own = _reduce_scatter0(g.movedim(-2, 0), ctx.mesh,
                               ctx.call + "-scatter")
        return own + same[..., r * w:(r + 1) * w], None, None


def model_gather_router(x: torch.Tensor, mesh, call="router"):
    """Every model rank's [..., w] block joined on the last dim ->
    (routed, aux), both [..., M w] with the same values. The gradient of
    `routed` is a partial on each rank (summed over the ranks into the
    block: a reduce-scatter), that of `aux` the same on every rank (the
    block's columns taken once)."""
    return _GatherRouter.apply(x, mesh, call)
