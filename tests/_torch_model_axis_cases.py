"""The cases of tests/test_torch_model_axis.py: the port's sharded train
step on a (data, model) mesh (`make_train_step(model, opt,
make_train_mesh(D, M), microbatch, fsdp)`) run on every rank of a gloo
world (`repro_torch.launch.mesh.spawn`), and the configs that the
reference's sharded step gets in its own subprocess. Imports nothing of
JAX, so the spawned ranks start quickly: the test hands them the
reference's weights as numpy leaves. Imported by its bare name, as
`tests/_torch_train_shard_cases.py` is, whose batches it shares (B 8 x
S 32, row r masking its first (5 r + 3 t) % S positions at step t).

fp32 configs: syncode-demo (8/4 heads of 32, d_ff 1024, V 2048: whole
heads split at M 2 and 4); the reduced qwen3-moe-30b-a3b (4/2 heads of
64, 4 experts top-2, V 512: at M 4 its 2 kv heads do not divide, so
wk/wv's 128 columns are cut inside heads and gathered, and each rank
holds one expert), also with remat on, its backward run on another
thread (as the card's autograd runs it); the reduced smollm-360m (4/2
heads, tied: one `embed` leaf is the lookup and the head); the reduced
qwen1.5-0.5b (QKV bias: a whole bias whose columns a rank takes).

`world(rank, n, payload)` -> {("case", case) or ("fault", fault):
result} for the cases and planted faults of a world of n ranks.
"""
import contextlib
import threading
from dataclasses import replace

import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.distributed import api
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import common as common_mod
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import build_model
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import leaves
import _torch_train_shard_cases as TS

B, S, STEPS = TS.B, TS.S, TS.STEPS
batches = TS.batches
# name -> (arch, reduced() keywords, or None for the config as it is)
CONFIGS = {"demo": ("syncode-demo", None),
           "moe": ("qwen3-moe-30b-a3b", {}),
           "moe_remat": ("qwen3-moe-30b-a3b", {"remat": True}),
           "smollm": ("smollm-360m", {}),
           "qwen": ("qwen1.5-0.5b", {})}
# (config, data, model, microbatch, FSDP forced): each run by the
# reference's `_jit_target` train step at the same mesh shape
CASES = (("demo", 1, 2, 1, False), ("demo", 2, 2, 1, False),
         ("demo", 1, 4, 1, False), ("demo", 2, 2, 2, False),
         ("moe", 1, 2, 1, False), ("moe", 1, 4, 1, False),
         ("moe", 2, 2, 1, True), ("smollm", 1, 2, 1, False),
         ("qwen", 1, 2, 1, False), ("moe_remat", 1, 2, 1, False))
# the configs whose step runs its backward on another thread
THREADED = ("moe_remat",)
# planted faults: (name, config, data, model), each held to the
# reference's numbers of the same config and mesh
FAULTS = (("no_col_grad", "demo", 1, 2), ("own_vocab_ce", "demo", 1, 2),
          ("norm_m_times", "demo", 1, 2), ("router_slice", "moe", 1, 2))


def config(name, get=get_config):
    """The fp32 config `name` from `get` (the port's registry, or the
    reference's)."""
    arch, kw = CONFIGS[name]
    cfg = get(arch)
    return replace(cfg if kw is None else cfg.reduced(**kw),
                   dtype="float32")


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def grad_on_another_thread():
    """`torch.autograd.grad` run on a thread of its own (the backward of
    card tensors runs on the autograd engine's device thread)."""
    orig = torch.autograd.grad

    def grad(*a, **k):
        box = {}

        def go():
            try:
                box["out"] = orig(*a, **k)
            except BaseException as e:      # re-raised on the caller
                box["err"] = e
        t = threading.Thread(target=go)
        t.start()
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    torch.autograd.grad = grad
    try:
        yield
    finally:
        torch.autograd.grad = orig


def run(mesh, name, params_np, mb, fsdp):
    """STEPS steps of the port's step -> {"steps": [{"loss", "ce", "lb",
    "z", "gnorm", "params", "mu", "nu"} (whole trees as numpy, on the
    lead rank only)], "bytes": this rank's {"params", "moments", "acc"},
    "calls": the first step's collectives by call}."""
    cfg = config(name)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, AdamWConfig(), mesh, mb, fsdp)
    params = step.shard(bridge.to_torch(params_np))
    state = step.init_state(params)
    out = {"steps": [], "bytes": {
        "params": _bytes(leaves(params)),
        "moments": _bytes(leaves(state["mu"]) + leaves(state["nu"]))}}
    away = grad_on_another_thread if name in THREADED else \
        contextlib.nullcontext
    for t, b in enumerate(batches(cfg)):
        api.reset_collective_tally()
        with away():
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        if t == 0:
            out["calls"] = api.collective_calls()
        whole, mom = step.gather(params), step.gather_moments(state)
        rec = {k: float(m[k]) for k in ("loss", "ce", "lb", "z", "gnorm")}
        if mesh.lead:
            rec.update(params=bridge.to_numpy(whole),
                       mu=bridge.to_numpy(mom["mu"]),
                       nu=bridge.to_numpy(mom["nu"]))
        out["steps"].append(rec)
    out["bytes"]["acc"] = step.acc_bytes
    return out


# ------------------------------ planted faults ------------------------------

def _no_col_grad(x, mesh, call="col-grad"):
    """No all-reduce of the gradient before a split column block."""
    return x


def _own_vocab_ce(logits, labels, v0, mesh):
    """Each rank's cross-entropy over its own vocabulary columns."""
    Vb = logits.shape[-1]
    local = labels.long() - v0
    own = (local >= 0) & (local < Vb)
    gold = torch.gather(logits, -1, local.clamp(0, Vb - 1)[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - torch.where(
        own, gold, torch.zeros_like(gold))


def _norm_m_times(blocks, plan, mesh):
    """Every leaf's sum of squares summed over the model ranks: a leaf
    whole on the model axis counted M times."""
    split = [b for b, lp in zip(blocks, plan.leaves) if lp.odim is not None]
    whole = [b for b, lp in zip(blocks, plan.leaves) if lp.odim is None]
    sq = lambda bs: sum(torch.sum(torch.square(b)) for b in bs)
    part = torch.zeros((), device=blocks[0].device) + sq(split)
    part = api.data_all_reduce(part, mesh, call="gnorm") + sq(whole)
    return api.model_all_reduce(part, mesh.model_mesh, "model-gnorm")


class _RouterSlice(api._GatherRouter):
    """The router gather with a plain slice for its backward."""

    @staticmethod
    def backward(ctx, partial, same):
        w, r = ctx.w, ctx.mesh.rank
        return (partial + same)[..., r * w:(r + 1) * w], None, None


def planted(fault):
    """[(module, attribute, replacement)] of a fault."""
    return {"no_col_grad": [(common_mod, "model_copy", _no_col_grad)],
            "own_vocab_ce": [(model_mod, "vocab_parallel_nll",
                              _own_vocab_ce)],
            "norm_m_times": [(optimizer, "_norm_sq", _norm_m_times)],
            "router_slice": [(moe_mod, "model_gather_router",
                              lambda x, mesh, call="router":
                              _RouterSlice.apply(x, mesh, call))],
            }[fault]


def run_fault(mesh, fault, name, params_np):
    patches = planted(fault)
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, new in patches:
        setattr(mod, attr, new)
    try:
        return run(mesh, name, params_np, 1, False)
    finally:
        for mod, attr, old in saved:
            setattr(mod, attr, old)


def world(rank, n, payload):
    """Every case and fault of a world of n gloo ranks on the CPU, each
    (data, model) mesh made once, in the cases' order on every rank."""
    torch.set_num_threads(1)
    meshes, out = {}, {}

    def mesh(D, M):
        if (D, M) not in meshes:
            meshes[(D, M)] = make_train_mesh(D, M, device="cpu")
        return meshes[(D, M)]
    for case in CASES:
        name, D, M, mb, fsdp = case
        if D * M == n:
            out[("case", case)] = run(mesh(D, M), name, payload[name], mb,
                                      fsdp)
    for fault, name, D, M in FAULTS:
        if D * M == n:
            out[("fault", fault)] = run_fault(mesh(D, M), fault, name,
                                              payload[name])
    return out
