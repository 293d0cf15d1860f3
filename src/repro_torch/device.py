"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda", *, abstract: bool = False) -> torch.device:
    """-> torch.device. Entry points default to "cuda" and raise when no
    card is present: the port never falls back to the CPU on its own.
    The CPU runs only when the caller asks for it (the tests do).
    "meta" (shapes and dtypes, no storage) passes only with
    abstract=True: `Model(cfg, device="meta")` and the dry run ask for
    it, no entry point that runs the model does."""
    dev = torch.device(device)
    if dev.type == "meta" and abstract:
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
