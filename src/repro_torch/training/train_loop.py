"""Training loop (port of `repro.training.train_loop`): a train step
(loss, grads by torch autograd, AdamW update), metrics logging and
periodic checkpoints, printing the reference's log and summary lines.

Params are the port's tree of tensors. A step detaches every leaf into a
fresh leaf that requires grad, runs `model.loss`, takes
`torch.autograd.grad` and applies `apply_updates`; the step's metrics
stay tensors on the device until a logged step reads them.

The sharded step (`make_train_step(..., mesh=, microbatch=, fsdp=)`,
`train(..., mesh=)`) is the reference's sharded train step
(`launch/dryrun.py::_jit_target`, train mode) on a (data, model) mesh,
computing the same function of the GLOBAL batch: each rank holds the
blocks `distributed/sharding.py::train_plan` gives it (its model blocks,
cut further into its FSDP param blocks and ZeRO-1 moment blocks), runs
its rows of each microbatch (`TrainPlan.rows`; the model ranks of a data
coordinate run the same rows), gathers each FSDP param at its use
(`api.fsdp_gather`, over the data group), normalises the loss over the
global batch (`api.use_data`), runs the forward over its model blocks
(`api.use_model`: the Megatron blocks with their backward collectives,
the vocabulary-parallel lookup and loss, expert parallelism; the
rank-local config of `TrunkPlan.local_config`), accumulates fp32
gradients in the moments' blocks (divided by `microbatch`, as the
reference's scan) and updates with `apply_updates`' ZeRO-1 form. The
step takes the global batch.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from ..device import resolve_device
from ..distributed.api import (all_gather_block, fsdp_gather, use_data,
                               use_model)
from ..distributed.sharding import needs_fsdp, train_plan
from ..models.model import Model
from . import optimizer
from .checkpoint import save_checkpoint
from .optimizer import AdamWConfig, apply_updates, init_opt_state
from .tree import leaves, unflatten


class DataParallelStep:
    """The sharded train step of one rank (see the module docstring):
    `step(params, opt_state, batch)` -> (params, opt_state, metrics),
    with `params` and `opt_state` the rank's blocks (`shard`,
    `init_state`) and `batch` the global batch. `acc_bytes` is the
    fp32 gradient accumulator's size on this rank in the last
    microbatched step (0 with one microbatch). Under a model axis the
    loss runs on `local`, the model of the rank-local config."""

    def __init__(self, model, opt_cfg, mesh, microbatch=1, fsdp=None):
        whole = model.abstract_params()
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.microbatch = int(microbatch)
        self.fsdp = needs_fsdp(whole, mesh) if fsdp is None else bool(fsdp)
        self.plan = train_plan(whole, mesh, fsdp=self.fsdp,
                               rank=mesh.mesh_rank, cfg=model.cfg)
        tp = self.plan.trunk
        self.local = model if tp is None else \
            Model(tp.local_config(model.cfg), device=model.device)
        self.acc_bytes = 0

    def shard(self, params):
        """The whole param tree -> this rank's (its model and FSDP blocks,
        copied)."""
        return unflatten(params, [
            p[lp.param].contiguous()
            if lp.pdim is not None or lp.mdim is not None else p
            for p, lp in zip(leaves(params), self.plan.leaves)])

    def init_state(self, params):
        return init_opt_state(params, self.plan)

    def _join(self, tensors, dim_of):
        """The rank's blocks joined over the data group along dim_of(lp),
        then over the model group along `mdim` (a collective)."""
        out = []
        for t, lp in zip(tensors, self.plan.leaves):
            if dim_of(lp) is not None:
                t = all_gather_block(t, dim_of(lp), self.mesh, call="gather")
            if lp.mdim is not None:
                t = all_gather_block(t, lp.mdim, self.mesh.model_mesh,
                                     call="gather")
            out.append(t)
        return out

    def gather(self, params):
        """This rank's params -> the whole tree (a collective: every rank
        calls it)."""
        return unflatten(params, self._join(leaves(params),
                                            lambda lp: lp.pdim))

    def gather_moments(self, state):
        """This rank's moment blocks -> {"mu", "nu"} whole (a collective)."""
        return {k: unflatten(state[k], self._join(leaves(state[k]),
                                                  lambda lp: lp.odim))
                for k in ("mu", "nu")}

    def _loss_grads(self, params, batch, replicated):
        blocks = [p.detach().requires_grad_() for p in leaves(params)]
        whole = [fsdp_gather(b, lp.pdim, self.mesh, replicated)
                 if lp.pdim is not None else b
                 for b, lp in zip(blocks, self.plan.leaves)]
        tp = self.plan.trunk
        split = contextlib.nullcontext() if tp is None else use_model(
            self.mesh.model_mesh, tp, self.plan.vocab)
        with use_data(None if replicated else self.mesh), split:
            loss, metrics = self.local.loss(unflatten(params, whole), batch)
        grads = torch.autograd.grad(loss, blocks)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def __call__(self, params, opt_state, batch):
        B = next(iter(batch.values())).shape[0]
        replicated, rows = self.plan.rows(B, self.microbatch)
        mb = self.microbatch
        acc, loss, metrics = None, 0.0, {}
        for sl in rows:
            l, m, grads = self._loss_grads(
                params, {k: v[sl] for k, v in batch.items()}, replicated)
            grads = optimizer.moment_grads(grads, self.plan, self.mesh,
                                           replicated)
            acc = _accumulate(acc, grads, mb)
            loss, metrics = _mean_metrics(loss, metrics, l, m, mb)
        self.acc_bytes = sum(a.numel() * a.element_size() for a in acc) \
            if mb > 1 else 0
        params, opt_state, om = apply_updates(
            self.opt_cfg, params, acc, opt_state, plan=self.plan,
            mesh=self.mesh)
        return params, opt_state, dict(metrics, loss=loss, **om)


def _accumulate(acc, grads, mb):
    """The reference's scan carry: the sum over the microbatches of each
    gradient in fp32 divided by `microbatch` (with one microbatch, the
    gradients as they are)."""
    if mb > 1:
        grads = [g.float() / mb for g in grads]
    return list(grads) if acc is None else \
        [a.add_(g) for a, g in zip(acc, grads)]


def _mean_metrics(loss, metrics, l, m, mb):
    """The loss and metrics summed over the microbatches, each / mb."""
    return loss + l / mb, {k: metrics.get(k, 0.0) + v / mb
                           for k, v in m.items()}


def make_train_step(model, opt_cfg: AdamWConfig, mesh=None,
                    microbatch: int = 1, fsdp=None):
    """The train step. With a mesh (a `launch.mesh.TrainMesh`), a
    `DataParallelStep` over it: `fsdp` None decides by `needs_fsdp`, as
    the reference does, and B must divide by microbatch x data. Without
    one, the one-device step: with `microbatch` k > 1 it runs the
    reference's scan in plain form (rows [i B/k, (i+1) B/k) of the batch
    a microbatch, fp32 gradients each divided by k and summed, then one
    update); `fsdp` is ignored."""
    if mesh is not None:
        return DataParallelStep(model, opt_cfg, mesh, microbatch, fsdp)
    mb = int(microbatch)

    def train_step(params, opt_state, batch):
        B = next(iter(batch.values())).shape[0]
        if mb < 1 or B % mb:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"microbatch {mb}")
        n = B // mb
        acc, loss, metrics = None, 0.0, {}
        for i in range(mb):
            part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            flat = [p.detach().requires_grad_() for p in leaves(params)]
            l, m = model.loss(unflatten(params, flat), part)
            acc = _accumulate(acc, torch.autograd.grad(l, flat), mb)
            loss, metrics = _mean_metrics(
                loss, metrics, l.detach(),
                {k: v.detach() for k, v in m.items()}, mb)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, unflatten(params, acc), opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)
    return train_step


@dataclass
class TrainResult:
    """`held`: under a mesh, the bytes this rank held at the end of the
    run: its params ("params", FSDP blocks or whole leaves), its moment
    blocks ("moments", mu and nu) and its gradient accumulator ("acc",
    microbatched runs)."""
    losses: list = field(default_factory=list)
    metrics: list = field(default_factory=list)
    steps_per_sec: float = 0.0
    held: dict = field(default_factory=dict)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


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
          verbose: bool = True, device="cuda", mesh=None,
          microbatch: int = 1, fsdp=None) -> tuple:
    """-> (params, TrainResult). `device` is resolved as every entry
    point's: "cuda" unless the caller asks for the CPU. The first step
    replaces `params` with new tensors: a caller that keeps its own
    reference to them holds a second copy of the weights for the whole
    run (2 bytes a bf16 param), so hand them over without one.

    With a `mesh` (a `launch.mesh.TrainMesh`), every rank calls this with
    the same whole params and the same seeded pipeline: each draws the
    whole global batch, so the batches are bit for bit the one-device
    run's, in the same order, and the step takes its rows. Rank 0 prints
    the log lines and writes the checkpoint, after every rank gathered
    the params; every rank returns the whole params."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, mesh, microbatch, fsdp)
    sharded = isinstance(step_fn, DataParallelStep)
    if sharded:
        dev = step_fn.mesh.device
        params = step_fn.shard(params)
        opt_state = step_fn.init_state(params)
        verbose = verbose and step_fn.mesh.lead
    else:
        opt_state = init_opt_state(params)
    whole = step_fn.gather if sharded else (lambda p: p)
    lead = not sharded or step_fn.mesh.lead
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
            full = whole(params)
            if lead:
                save_checkpoint(checkpoint_path, full, step=i + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.steps_per_sec = steps / max(time.time() - t0, 1e-9)
    if sharded:
        result.held = {"params": _nbytes(params),
                       "moments": _nbytes([opt_state["mu"],
                                           opt_state["nu"]]),
                       "acc": step_fn.acc_bytes}
    params = whole(params)
    if checkpoint_path and lead:
        save_checkpoint(checkpoint_path, params, step=steps)
    return params, result
