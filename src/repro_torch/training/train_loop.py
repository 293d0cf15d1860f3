"""Training loop (port of `repro.training.train_loop`): a train step
(loss, grads by torch autograd, AdamW update), metrics logging and
periodic checkpoints, printing the reference's log and summary lines.

Params are the port's tree of tensors. A step detaches every leaf into a
fresh leaf that requires grad, runs `model.loss`, takes
`torch.autograd.grad` and applies `apply_updates`; the step's metrics
stay tensors on the device until a logged step reads them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..device import resolve_device
from .checkpoint import save_checkpoint
from .optimizer import AdamWConfig, apply_updates, init_opt_state
from .tree import leaves, unflatten


def make_train_step(model, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss, metrics = model.loss(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, unflatten(params, grads), opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return params, opt_state, metrics
    return train_step


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    metrics: list = field(default_factory=list)
    steps_per_sec: float = 0.0


def ship_batch(batch, device):
    """numpy batch -> tensors on `device`. `torch.from_numpy` shares the
    array's memory and the copy to the card may still be reading it when
    this returns: safe ONLY because every pipeline's __next__ returns
    freshly allocated arrays, never a reused staging buffer
    (tests/test_torch_training.py holds the pipelines to it)."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def train(model, params, data_iter, steps: int,
          opt_cfg: AdamWConfig | None = None, log_every: int = 10,
          checkpoint_path: str | None = None, checkpoint_every: int = 0,
          verbose: bool = True, device="cuda") -> tuple:
    """-> (params, TrainResult). `device` is resolved as every entry
    point's: "cuda" unless the caller asks for the CPU. The first step
    replaces `params` with new tensors: a caller that keeps its own
    reference to them holds a second copy of the weights for the whole
    run (2 bytes a bf16 param), so hand them over without one."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, opt_cfg)
    result = TrainResult()
    t0 = time.time()
    for i in range(steps):
        # reprolint: fresh-batch tests/test_torch_training.py pipeline-freshness tests enforce the contract
        batch = next(data_iter)
        batch = ship_batch(batch, dev)  # reprolint: dispatch
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            result.losses.append(m["loss"])
            result.metrics.append(m)
            if verbose:
                print(f"step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                      f"lr {m['lr']:.2e} gnorm {m['gnorm']:.2f}")
        if checkpoint_path and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, step=i + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.steps_per_sec = steps / max(time.time() - t0, 1e-9)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, step=steps)
    return params, result
