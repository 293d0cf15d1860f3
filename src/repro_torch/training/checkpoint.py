"""Msgpack checkpoints of a param tree, in the reference's file format
(port of `repro.training.checkpoint`), so that each side loads the
other's files and the same tree gives the same bytes.

Payload: {"step": int, "extra": dict, "leaves": [[keystr, leaf], ...]}
with leaves in the reference's order and named by `jax.tree_util.keystr`
of their path (`tree.flatten_with_path`). A leaf is {"dt": numpy dtype
string, "sh": shape, "b": raw bytes}; bfloat16 is stored as its uint16
bit image under "dt": "bfloat16". The codec is the port's own
(`_msgpack`): the card's machine has no `msgpack` package.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import _msgpack
from .tree import flatten_with_path, unflatten


def _pack_leaf(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"dt": "bfloat16", "sh": list(t.shape),
                "b": t.view(torch.int16).numpy().tobytes()}
    arr = t.numpy()
    return {"dt": arr.dtype.str, "sh": list(arr.shape), "b": arr.tobytes()}


def _unpack_leaf(d: dict, device) -> torch.Tensor:
    if d["dt"] == "bfloat16":
        arr = np.frombuffer(d["b"], dtype=np.int16).reshape(d["sh"])
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(d["b"], dtype=np.dtype(d["dt"])).reshape(d["sh"])
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def save_checkpoint(path: str, tree, step: int = 0, extra: dict = None):
    payload = {
        "step": int(step),
        "extra": extra or {},
        "leaves": [[k, _pack_leaf(v)] for k, v in flatten_with_path(tree)],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(payload))
    os.replace(tmp, path)


def load_checkpoint(path: str, like_tree):
    """-> (tree, step, extra). Each leaf keeps the file's dtype and goes
    to the device of the matching leaf of `like_tree`; a leaf the file
    lacks raises KeyError, a shape that differs ValueError."""
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    by_key = {k: v for k, v in payload["leaves"]}
    leaves = []
    for k, old in flatten_with_path(like_tree):
        if k not in by_key:
            raise KeyError(f"checkpoint missing {k}")
        d = by_key[k]
        if tuple(d["sh"]) != tuple(old.shape):
            raise ValueError(f"{k}: shape {tuple(d['sh'])} != "
                             f"{tuple(old.shape)}")
        leaves.append(_unpack_leaf(d, old.device))
    return unflatten(like_tree, leaves), payload["step"], payload["extra"]
