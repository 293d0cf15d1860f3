"""AdamW + cosine schedule + global-norm clipping over a param tree (port
of `repro.training.optimizer`).

Plain functions over the port's tree of tensors, with the reference's
numerics: fp32 moments, the global norm over fp32 casts of the grads,
the clip scale, bias corrections and update in fp32, and the new param
cast back to its dtype (round to nearest even). Decoupled weight decay
applies to every leaf with two or more dims, as in the reference; a
layer-stacked norm `ln1` [L, D] is such a leaf and is decayed, while
`final_norm` [D] is not. The schedule, the clip scale and the step
counter stay 0-dim tensors on the params' device, so a step never waits
on the host.

The reference's ZeRO-1 arguments (`update_shardings`, `param_shardings`)
belong to the distributed slice and are not taken here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to `min_lr_ratio` (fp32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step -> (params, state, {"gnorm", "lr"}). The params
    come back as new tensors, the input params left as they were; the
    moments `mu` and `nu` are updated IN PLACE (the returned state holds
    the same tensors), so the update never holds two copies of them: its
    peak is one leaf's fp32 temporaries above params, grads and moments
    (and the new params). The operations and their order are the
    out-of-place update's, so the numbers are the same bit for bit."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    # a tensor numerator: `float / tensor` would multiply by a reciprocal
    scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.beta1 ** step.float()
    b2c = 1 - cfg.beta2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        nu.mul_(cfg.beta2).add_((1 - cfg.beta2) * torch.square(g))
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        p32 = p.float()
        if p.dim() >= 2:    # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    new = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(state["mu"]), leaves(state["nu"]))]
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return unflatten(params, new), new_state, {"gnorm": gnorm, "lr": lr}
