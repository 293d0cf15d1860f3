"""Weight and cache bridge between the JAX package and the port.

The port keeps the JAX pytree layout: a dict/list/tuple tree whose
layer groups are stacked on a leading layer axis (`wq [L, D, H*Dh]`,
...), so a JAX tree given as numpy leaves (`np.asarray` of each leaf)
maps to the port leaf by leaf as a plain copy.

bfloat16 travels through its uint16 bit image, as
`repro.training.checkpoint._pack_leaf` stores it: numpy has no native
bfloat16, and the port must not need the JAX package's dtype
extension. `to_torch` accepts any numpy array whose dtype is named
"bfloat16" (the extension dtype JAX hands out); `to_numpy` returns bf16
leaves as their uint16 bit image, which a JAX caller views back with
`.view(jnp.bfloat16)`.
"""
from __future__ import annotations

import numpy as np
import torch


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
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


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
