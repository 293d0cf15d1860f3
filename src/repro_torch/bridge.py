"""Weight and cache bridge between the JAX package and the port.

The port keeps the JAX pytree layout: a dict/list/tuple tree whose
layer groups are stacked on a leading layer axis (`wq [L, D, H*Dh]`,
...), so a JAX tree given as numpy leaves (`np.asarray` of each leaf)
maps to the port leaf by leaf as a plain copy, whatever its branches
(the audio family's "encoder" group, nested `dec` caches).

bfloat16 travels through its uint16 bit image, as
`repro.training.checkpoint._pack_leaf` stores it: numpy has no native
bfloat16, and the port must not need the JAX package's dtype
extension. `to_torch` accepts any numpy array whose dtype is named
"bfloat16" (the extension dtype JAX hands out); `to_numpy` returns bf16
leaves as their uint16 bit image, which a JAX caller views back with
`.view(jnp.bfloat16)`.

`shard_params` cuts one rank's block out of a (bridged) param tree for
the sharded serving engine: the rows of `embed` and the columns of
`lm_head` that hold its vocab ids (`distributed/sharding.py::
vocab_slice`), every other leaf whole; or, under trunk_shard, every
leaf's block (`trunk_slice`).

The same calls carry an optimizer state ({"mu", "nu", "step"}: fp32
moment trees and a 0-dim int32 step) between `repro.training.optimizer`
and `repro_torch.training.optimizer`; 0-dim leaves keep their shape.
"""
from __future__ import annotations

import numpy as np
import torch

from .distributed.sharding import leaves_with_path, map_with_path, vocab_slice


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def leaf_to_torch(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    c = np.ascontiguousarray(a).reshape(a.shape)   # ndim 0 stays 0
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(c.view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(c.copy()).to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def to_torch(tree, device="cpu"):
    """JAX tree with numpy leaves -> same tree of torch tensors."""
    return _map(tree, lambda a: leaf_to_torch(a, device))


def to_numpy(tree):
    """Port tree of tensors -> same tree of numpy arrays (bf16 as its
    uint16 bit image)."""
    return _map(tree, leaf_to_numpy)


def to_device(tree, device):
    """Same tree with every tensor moved to `device`."""
    return _map(tree, lambda t: t.to(device))


def shard_params(tree, shard, whole=None):
    """One rank's serving params: each leaf cut to `vocab_slice` of the
    rank's `VocabShard`, or to `shard(path, shape)` when `shard` is a
    function of the leaf's path and whole shape (`trunk_slice`): a
    contiguous copy where cut, the leaf itself where whole. `whole`, a
    tree of the leaves' whole shapes (`Model.abstract_params()`), admits
    leaves that are already the rank's blocks (`Model.init(gen,
    cut=...)`): one whose shape is not its whole shape must be its
    block's, and is kept."""
    rule = shard if callable(shard) else \
        (lambda path, shape: vocab_slice(path, shape, shard))
    shapes = {} if whole is None else {
        p: tuple(t.shape) for p, t in leaves_with_path(whole)}

    def cut(path, t):
        shape = shapes.get(path, tuple(t.shape))
        sl = rule(path, shape)
        if tuple(t.shape) != shape:
            if tuple(t.shape) != tuple(s.stop - s.start for s in sl):
                raise ValueError(f"{path}: shape {tuple(t.shape)} is neither "
                                 f"the whole leaf {shape} nor its block")
            return t
        if all(s.start == 0 and s.stop == n for s, n in zip(sl, shape)):
            return t
        return t[sl].contiguous()
    return map_with_path(cut, tree)
