"""Sharding context and the sharded engine's collectives (port of
`repro.distributed.api`).

`use_sharding(mesh, vocab)` marks the model calls a sharded engine
makes: model code asks `current_vocab()` whether the vocabulary is split
(the embedding lookup's combine, `models/common.py::embed_tokens`). The
context is per thread, as the reference's is: an engine enters it around
each device call, on whatever thread runs the step loop. The reference's
context also carries the logical-name rules that `shard_hint` reads;
here `shard_hint(x, name)` is the identity, so the context holds no
rules: where the reference asks GSPMD to place an activation, the port's
ranks each hold their block and call the collectives below by hand (the
engine gathers the logits itself before it selects).

The three collectives of vocab-parallel serving, over the mesh's process
group (identities when the mesh has no group, a single process):
  * `vocab_all_reduce`: the embedding lookup's SUM of one true row and
    zeros (exact);
  * `all_gather_last`: the masked logits' blocks joined on the last dim,
    each padded to the widest block for the collective and trimmed after;
  * `broadcast_control`: the step loop's per-iteration record of what
    rank 0 decided (admissions, cancellations, deadlines, hot loads),
    always in host memory over a gloo group.
The first two take tensors where they lie, on NCCL and gloo alike (gloo
took CUDA tensors in torch 2.11 on the H100, so no host staging is
written). Nothing here catches a collective's error: a
failed rank ends the run.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def _ctx():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, vocab=None):
    """mesh: the engine's `ServingMesh`; vocab: this rank's
    `VocabShard`, or None."""
    prev = _ctx()
    _state.ctx = (mesh, vocab)
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


# ------------------------------ collectives ------------------------------

def vocab_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """SUM of x over the mesh's ranks, in place; returns x. With one
    true row and zeros elsewhere the sum is exact in any dtype."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x
    dist.all_reduce(x, group=mesh.group)
    return x


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
    return torch.cat([o[..., :w] for o, w in zip(outs, widths)], dim=-1)


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
