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

ZeRO-1 (the reference's `update_shardings` / `param_shardings`, which
its sharded train step passes): given a data-parallel `TrainPlan`
(`distributed/sharding.py::train_plan`) a rank holds only its block of
each moment. `moment_grads` sums the rank's gradients over the data
ranks into the moments' blocks in fp32 (a reduce-scatter; an
all-reduce for a leaf whose moments are whole; a slice where every rank
ran the same rows); `apply_updates(..., plan=, mesh=)` takes those
blocks (or the microbatch accumulator's, laid out alike), takes
the global norm from the blocks' sums of squares (one all-reduce, each
whole leaf counted once), runs the fp32 AdamW math on the block (weight
decay by the WHOLE leaf's ndim, as the reference), casts the new block
to the param's dtype and all-gathers it back to the param's layout: the
whole leaf, or its FSDP block. Where a leaf's FSDP dim and moment dim
differ, its gradient and param are gathered along the one and cut along
the other. The reference's compiled step (jax 0.9 on host devices) sums
the gradients in fp32, after the cast, and so does this form.

On a (data, model) mesh a rank's gradient arrives as its model block
(`LeafPlan.block`): the data group reduces it as above, the moment block
taken relative to the model block, and the global norm takes each
element once: a block split over the data group, the model group or
both is all-reduced over the groups that split it, a leaf whole on both
(the norms; an FFN, the experts or the vocabulary a model axis does not
divide) is added once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed.api import (all_gather_block, data_all_reduce,
                               model_all_reduce, reduce_scatter_block)
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


def block_shape(slices) -> tuple:
    return tuple(s.stop - s.start for s in slices)


def init_opt_state(params, plan=None):
    """Zero fp32 moments like `params`; given a `TrainPlan`, `params` is
    the rank's tree and each moment is the rank's ZeRO-1 block."""
    dev = leaves(params)[0].device
    if plan is None:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        mu, nu = tree_map(zeros, params), tree_map(zeros, params)
    else:
        blocks = lambda: unflatten(params, [
            torch.zeros(block_shape(lp.moment), dtype=torch.float32,
                        device=dev) for lp in plan.leaves])
        mu, nu = blocks(), blocks()
    return {"mu": mu, "nu": nu,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@torch.no_grad()
def moment_grads(grads, plan, mesh, replicated: bool = False) -> list:
    """The rank's gradients -> fp32 blocks of the gradient summed over the
    data ranks, cut as the moments are (a list in leaf order). A leaf
    without FSDP arrives whole (this rank's rows' share): reduce-scattered
    along its moment dim, or all-reduced where its moments are whole. An
    FSDP leaf arrives as its summed block (`api.fsdp_gather`'s
    backward): it is the moment block where the two dims agree, else it
    is gathered along the FSDP dim and cut. Where every rank ran the
    same rows (`replicated`) the gradient is already the sum: no rank
    adds the others'."""
    out = []
    for g, lp in zip(leaves(grads), plan.leaves):
        g = g.float()
        if lp.pdim is not None:
            if lp.odim != lp.pdim:
                g = all_gather_block(g, lp.pdim, mesh, call="reshard")
                g = g[lp.moment_in_block]
        elif replicated:
            g = g[lp.moment_in_block]
        elif lp.odim is None:
            g = data_all_reduce(g, mesh, call="grad-all-reduce")
        else:
            g = reduce_scatter_block(g, lp.odim, mesh)
        out.append(g)
    return out


def _norm_sq(blocks, plan, mesh) -> torch.Tensor:
    """The gradient's global sum of squares from the rank's moment
    blocks: each block's sum all-reduced over the groups that split it
    (data, model or both: one all-reduce a group), each leaf whole on
    both (the same on every rank) added once."""
    def where(d, m):
        return [b for b, lp in zip(blocks, plan.leaves)
                if (lp.odim is not None) == d and (lp.mdim is not None) == m]
    sq = lambda bs: sum(torch.sum(torch.square(b)) for b in bs)
    zero = lambda: torch.zeros((), dtype=torch.float32,
                               device=blocks[0].device)
    if plan.model == 1:
        part = zero() + sq(where(True, False))
        return data_all_reduce(part, mesh, call="gnorm") + \
            sq(where(False, False))
    part = data_all_reduce(torch.stack([zero() + sq(where(True, False)),
                                        zero() + sq(where(True, True))]),
                           mesh, call="gnorm")
    split = model_all_reduce(part[1] + sq(where(False, True)),
                             mesh.model_mesh, call="model-gnorm")
    return part[0] + split + sq(where(False, False))


def _param_block(p, lp, mesh) -> torch.Tensor:
    """The rank's moment block of param leaf p (whole, or its FSDP block)
    in fp32."""
    if lp.pdim is None:
        return p[lp.moment_in_block].float()
    if lp.pdim == lp.odim:
        return p.float()
    return all_gather_block(p, lp.pdim, mesh, call="reshard")[
        lp.moment_in_block].float()


def _to_param_layout(new, lp, mesh) -> torch.Tensor:
    """The updated moment block -> the param's layout (whole, or the FSDP
    block)."""
    if lp.pdim is not None and lp.pdim == lp.odim:
        return new
    if lp.odim is not None:
        new = all_gather_block(new, lp.odim, mesh)
    return new if lp.pdim is None else new[lp.param_in_block].contiguous()


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, plan=None,
                  mesh=None):
    """One AdamW step -> (params, state, {"gnorm", "lr"}). The params
    come back as new tensors, the input params left as they were; the
    moments `mu` and `nu` are updated IN PLACE (the returned state holds
    the same tensors), so the update never holds two copies of them: its
    peak is one leaf's fp32 temporaries above params, grads and moments
    (and the new params). The operations and their order are the
    out-of-place update's, so the numbers are the same bit for bit.

    Given a `TrainPlan` (and its `mesh`), the ZeRO-1 form described in
    the module docstring: `params` and the moments are the rank's blocks,
    `grads` the fp32 moment blocks of the gradient summed over the data
    ranks (`moment_grads`' list, or the microbatch accumulator's)."""
    flat = leaves(grads)
    if plan is None:
        gnorm = _global_norm(flat)
    else:
        gnorm = torch.sqrt(_norm_sq(flat, plan, mesh))
    step = state["step"] + 1
    # a tensor numerator: `float / tensor` would multiply by a reciprocal
    scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.beta1 ** step.float()
    b2c = 1 - cfg.beta2 ** step.float()

    def upd(p32, g, mu, nu, ndim):
        g = g.float() * scale
        mu.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        nu.mul_(cfg.beta2).add_((1 - cfg.beta2) * torch.square(g))
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if ndim >= 2:       # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        return p32 - lr * delta

    new = []
    for i, (p, g, mu, nu) in enumerate(zip(
            leaves(params), flat, leaves(state["mu"]),
            leaves(state["nu"]))):
        if plan is None:
            new.append(upd(p.float(), g, mu, nu, p.dim()).to(p.dtype))
        else:           # the WHOLE leaf's ndim, as the reference
            lp = plan.leaves[i]
            new.append(_to_param_layout(upd(
                _param_block(p, lp, mesh), g, mu, nu, len(lp.shape)).to(
                    p.dtype), lp, mesh))
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return unflatten(params, new), new_state, {"gnorm": gnorm, "lr": lr}
