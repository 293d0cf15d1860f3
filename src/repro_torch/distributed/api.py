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
    logits before the selection, and under trunk_shard the MoE router's
    expert columns, the SSM's in-projection and conv output channels
    and the RG-LRU's conv output (the gates contract over all of R);
  * `all_gather_stack` (trunk_shard, the sequence split): every rank's
    equal-shaped tensor, stacked in rank order: the q/k/v column blocks
    joined into whole heads, and the partial attention outputs with
    their log-sum-exp before the combine;
  * `trunk_all_reduce` (trunk_shard): the SUM of the ranks' partial
    row-parallel products (attention out, FFN down, the experts'
    combine, the recurrent layers' w_out; the SSM's carries its gated
    norm's sum of squares beside the partial), not exact: the sum runs in another order than the
    one-device product's;
  * `broadcast_control`: the step loop's per-iteration record of what
    rank 0 decided (admissions, cancellations, deadlines, hot loads),
    always in host memory over a gloo group.
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


def reset_collective_tally() -> None:
    _tally.clear()


def _note(kind: str, n: int, mesh) -> None:
    """One collective of `kind` whose result is n bytes a rank."""
    d = _tally[kind]
    d["count"] += 1
    d["bytes"] += n
    d["wire_bytes"] += wire(kind, n, mesh.size)


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
