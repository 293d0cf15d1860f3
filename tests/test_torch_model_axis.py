"""The port's sharded train step on a (data, model) mesh against the
reference's own sharded step (`repro.launch.dryrun._jit_target(model,
"train", ...)`) at the same mesh shape, on the CPU.

The reference side runs in ONE subprocess for the module, as in
tests/test_torch_train_shard.py: 8 host devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=8` before jax is
imported), Auto-axis meshes `jax.sharding.Mesh(devices[:D*M].reshape(D,
M), ("data", "model"))`, copies of the arguments for each call (the step
donates them), ce/lb/z and gnorm read by `jax.debug.callback`, FSDP
forced by making `needs_fsdp` answer True. The port side runs the same
cases on gloo worlds of 2 and 4 ranks (`launch.mesh.spawn`, cases in
`tests/_torch_model_axis_cases.py`), with the reference's
`Model.init(PRNGKey(0))` weights bridged in.

Held over 2 AdamW steps (fp32, B 8 x S 32, the planted unequal
loss_mask), for syncode-demo at (1,2), (2,2), (1,4) and (2,2) with
microbatch 2; the reduced MoE at (1,2), (1,4) (q/k/v cut inside heads
and gathered; one expert a rank), (2,2) with FSDP, and (1,2) with remat
and the backward on another thread; the reduced smollm (tied) and qwen1.5
(QKV bias) at (1,2):
  * loss, ce, lb, z and gnorm within 1e-5 relative; every gathered param
    and moment within 1e-5 of the leaf's largest magnitude (qwen1.5's
    params by `chip_smoke.py` phase 15's rule: its zero-initialised k
    bias gets a gradient that cancels nearly to nothing in rope's slow
    channels, where a shift of every key barely moves the scores, and
    there the sum order decides Adam's g / (|g| + eps) in either step;
    its moments, which carry the gradient, are held at 1e-5);
  * each rank holds exactly the specs' blocks of params, moments and
    the accumulator;
  * a step's collectives are `cost.train_step`'s wherever the port
    issues GSPMD's; the port's own (the loss's and the MoE's) pinned;
  * the planted faults (no gradient all-reduce before a column block, a
    cross-entropy over a rank's own vocabulary, a norm that counts a
    leaf whole on the model axis M times, the router gather's backward
    as a plain slice) each break at least one of these checks.
"""
import math
import os
import pickle
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch.distributed import cost
from repro_torch.distributed import sharding as port
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.model import layer_groups
from repro_torch.training.optimizer import block_shape
import _torch_model_axis_cases as T

WORLDS = (2, 4)
REL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

REFERENCE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [__SRC__, __TESTS__]
from concurrent.futures import ThreadPoolExecutor
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
import repro.distributed.sharding as shd
import repro.launch.dryrun as dryrun
import repro.training.optimizer as opt
from repro.configs import get_config
from repro.models.model import build_model
import _torch_model_axis_cases as T

payload = pickle.load(open(__IN__, "rb"))
rec = {"aux": [], "gnorm": []}
apply_updates = opt.apply_updates


def traced_apply(*a, **k):
    out = apply_updates(*a, **k)
    jax.debug.callback(lambda g: rec["gnorm"].append(float(g)),
                       out[2]["gnorm"])
    return out


opt.apply_updates = traced_apply
needs_fsdp = shd.needs_fsdp
copy = lambda t: jax.tree.map(lambda x: jnp.array(x, copy=True), t)
targets = []
for case in T.CASES:
    name, D, M, mb, fsdp = case
    cfg = T.config(name, get_config)
    model = build_model(cfg)
    loss = model.loss

    def traced_loss(p, b, loss=loss):
        l, aux = loss(p, b)
        jax.debug.callback(
            lambda c, lb, z: rec["aux"].append((float(c), float(lb),
                                                float(z))),
            aux["ce"], aux["lb"], aux["z"])
        return l, aux

    model.loss = traced_loss
    shd.needs_fsdp = (lambda *a, **k: True) if fsdp else needs_fsdp
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    params = jax.tree.map(jnp.asarray, payload[name])
    state = opt.init_opt_state(params)
    bs = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in T.batches(cfg)]
    fn, _ = dryrun._jit_target(model, "train",
                               {"params": params, "opt_state": state,
                                "batch": bs[0]}, mesh, mb)
    targets.append((case, fn, params, state, bs))

# XLA compiles outside the GIL: the targets compile side by side
with ThreadPoolExecutor(4) as ex:
    compiled = list(ex.map(
        lambda t: t[1].lower(t[2], t[3], t[4][0]).compile(), targets))
out = {}
for (case, _, params, state, bs), fn in zip(targets, compiled):
    mb = case[3]
    steps = []
    for b in bs:
        rec["aux"].clear()
        rec["gnorm"].clear()
        params, state, loss_v = fn(copy(params), copy(state), b)
        jax.block_until_ready((params, state, loss_v))
        jax.effects_barrier()
        aux = np.mean(np.array(rec["aux"]), axis=0)
        assert len(rec["aux"]) == mb and len(rec["gnorm"]) == 1, rec
        tree = lambda t: jax.tree.map(np.asarray, t)
        steps.append({"loss": float(loss_v), "ce": float(aux[0]),
                      "lb": float(aux[1]), "z": float(aux[2]),
                      "gnorm": rec["gnorm"][0], "params": tree(params),
                      "mu": tree(state["mu"]), "nu": tree(state["nu"])})
    out[case] = steps
pickle.dump(out, open(__OUT__, "wb"))
print("REFERENCE_OK")
"""


def _reference(payload, tmp):
    src, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump(payload, f)
    code = REFERENCE
    for k, v in {"__SRC__": os.path.abspath(SRC), "__TESTS__": HERE,
                 "__IN__": src, "__OUT__": out}.items():
        code = code.replace(k, repr(v))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (payload, reference {case: steps}, port worlds {n: [rank
    results]})."""
    payload = {name: jax.tree.map(np.asarray, jax_build_model(
        T.config(name, jax_get_config)).init(jax.random.PRNGKey(0)))
        for name in T.CONFIGS}
    got, errors = {}, []

    def side(key, fn, *args, **kw):
        try:
            got[key] = fn(*args, **kw)
        except BaseException as e:          # re-raised below
            errors.append(e)

    tmp = str(tmp_path_factory.mktemp("model_axis"))
    # the reference beside the worlds, which run one after the other (all
    # three at once contend for the cores: 131 s against 86 s alone)
    bg = threading.Thread(target=side, args=("ref", _reference, payload,
                                             tmp))
    bg.start()
    for n in WORLDS:
        side(n, spawn, n, T.world, n, payload, device="cpu")
    bg.join()
    if errors:
        raise errors[0]
    return payload, got["ref"], {n: got[n] for n in WORLDS}


def _leaf_rel(a, b) -> float:
    """max |a - b| over the leaf's largest magnitude (b's)."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _lrs():
    """The default AdamWConfig's lr at each step."""
    import torch
    from repro_torch.training.optimizer import AdamWConfig, schedule
    return [float(schedule(AdamWConfig(), torch.tensor(t + 1)))
            for t in range(T.STEPS)]


def mismatches(port_steps, want_steps, rel=REL, mu_sure=False) -> list:
    """Every check of the module docstring that `port_steps` fails
    against `want_steps`, as strings (empty: all hold). `mu_sure`: the
    params by `chip_smoke.py` phase 15's rule instead, with lr the
    steps' summed lr: within 2 lr everywhere, and within 1e-6 + 1e-5 lr
    where the reference's |mu| is at least 1e-3 of its leaf's largest
    and the clipped gradient (read from the reference's mu, (mu_t - b1
    mu_t-1) / (1 - b1)) never fell below 100 eps (Adam's update is g /
    (|g| + eps): near eps the sum order decides it)."""
    bad, prev, small = [], {}, {}
    b1, eps, lr = 0.9, 1e-8, np.cumsum(_lrs())
    for t, (p, w) in enumerate(zip(port_steps, want_steps)):
        for k in ("loss", "ce", "lb", "z", "gnorm"):
            if abs(p[k] - w[k]) > rel * max(abs(w[k]), 1e-30):
                bad.append(f"step {t} {k}: {p[k]} vs {w[k]}")
        mu = dict(port.leaves_with_path(w["mu"]))
        for path, m in mu.items():
            g = np.abs(m - b1 * prev.get(path, 0.0)) / (1 - b1)
            small[path] = small.get(path, False) | (g < 100 * eps)
        prev = mu
        for k in ("params", "mu", "nu"):
            pw = dict(port.leaves_with_path(w[k]))
            for path, leaf in port.leaves_with_path(p[k]):
                if k == "params" and mu_sure:
                    m, d = np.abs(mu[path]), np.abs(leaf - pw[path])
                    sure = (m >= 1e-3 * m.max()) & ~small[path]
                    if not (d.max() <= 2 * lr[t] and d[sure].max(
                            initial=0.0) <= 1e-6 + 1e-5 * lr[t]):
                        bad.append(f"step {t} {k}{path}: {d.max():.3g}")
                    continue
                e = _leaf_rel(leaf, pw[path])
                if not e <= rel:
                    bad.append(f"step {t} {k}{path}: {e:.3g}")
    return bad


def _mesh(D, M):
    return MeshShape({"data": D, "model": M}, ("data", "model"))


def _ids(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("case", T.CASES, ids=_ids)
def test_step_matches_the_reference_sharded_step(runs, case):
    """loss, ce, lb, z, gnorm and every gathered param and moment after
    each of 2 steps within 1e-5 of the reference's sharded step at the
    same (data, model) mesh and microbatch."""
    _, ref, worlds = runs
    name, D, M = case[:3]
    res = worlds[D * M][0][("case", case)]
    assert mismatches(res["steps"], ref[case],
                      mu_sure=name == "qwen") == []


@pytest.mark.parametrize("case", T.CASES, ids=_ids)
def test_each_rank_holds_the_specs_blocks(runs, case):
    """Each rank's param, moment and accumulator bytes are the blocks of
    `param_specs(fsdp=...)` and `opt_state_specs(zero=True)` on the
    (data, model) mesh at its place; a rank holds less than the whole
    tree."""
    payload, _, worlds = runs
    name, D, M, mb, fsdp = case
    mesh = _mesh(D, M)
    whole = payload[name]
    total = sum(leaf.nbytes for _, leaf in port.leaves_with_path(whole))
    for rank, res in enumerate(worlds[D * M]):
        pb = ob = 0
        for path, leaf in port.leaves_with_path(whole):
            pspec = port.param_spec(path, leaf.shape, mesh, fsdp=fsdp)
            ospec = port.opt_state_spec("['mu']" + path, leaf.shape, mesh)
            pb += np.prod(block_shape(port.shard_slice(
                pspec, leaf.shape, mesh, rank))) * leaf.dtype.itemsize
            ob += np.prod(block_shape(port.shard_slice(
                ospec, leaf.shape, mesh, rank))) * 4
        got = res[("case", case)]["bytes"]
        assert got == {"params": pb, "moments": 2 * ob,
                       "acc": ob if mb > 1 else 0}
        assert pb < total


def _n(cfg, kinds):
    return sum(count for pat, count in layer_groups(cfg)
               for kind in pat if kind in kinds)


# the port's calls that issue GSPMD's collectives: the model axis' (all
# all-reduces) and the data axis' by kind
MODEL_GSPMD = ("row-sum", "lookup", "col-grad")
DATA_GSPMD = {"grad-all-reduce": "all-reduce",
              "reduce-scatter": "reduce-scatter",
              "fsdp-scatter": "reduce-scatter", "all-gather": "all-gather",
              "fsdp-gather": "all-gather"}


def _sum(calls, names):
    n = w = 0.0
    for c in names:
        n += calls.get(c, {}).get("count", 0)
        w += calls.get(c, {}).get("wire_bytes", 0.0)
    return n, w


@pytest.mark.parametrize("case", T.CASES, ids=_ids)
def test_collectives_against_the_cost_count(runs, case):
    """A step's collectives against `cost.train_step(..., mesh=)`'s count
    of the reference's. GSPMD's, each once a microbatch where cost.py
    counts one a step: the row blocks' and the lookup's all-reduces and
    the all-reduce of the input's gradient before each split column
    block and the head (the microbatches' bytes add up to cost.py's);
    the data axis' (FSDP, ZeRO-1, whole moments) as
    tests/test_torch_train_shard.py reads them. The port's own, pinned:
    the cross-entropy's max, sum and gold all-reduces (three a loss
    chunk, issued again by its checkpoint's recompute) where cost.py
    counts three of its own; the MoE's router gather and its
    reduce-scatter, the experts' input-gradient and combine all-reduces
    where cost.py counts its all-to-all exchanges; the q/k/v gather and
    reduce-scatter where M does not divide the kv heads; the QKV biases'
    gradient all-reduces; the loss's (tot, cnt), the router's sums and
    the norm's on the data axis; the norm's on the model axis."""
    name, D, M, mb, fsdp = case
    _, _, worlds = runs
    calls = worlds[D * M][0][("case", case)]["calls"]
    cfg = T.config(name)
    mesh = _mesh(D, M)
    with_fsdp = cost.needs_fsdp
    try:
        cost.needs_fsdp = lambda *a, **k: fsdp
        want = cost.train_step(cfg, T.B, T.S, mb, mesh=mesh)["collectives"]
    finally:
        cost.needs_fsdp = with_fsdp
    rem = int(cfg.remat)
    tp = port.trunk_plan(cfg, M)
    ce = 3 * cost.wire("all-reduce", T.B * T.S // D * 4, M)
    data = cost._Tally(mesh)
    cost._grad_collectives(data, cfg, mesh, fsdp, rem)
    dc = {k: dict(v) for k, v in data.coll.items()}
    zero = {"count": 0.0, "wire_bytes": 0.0}
    # the model axis: cost.py's all-reduces less its three CE ones and
    # the data axis' whole-moment gradients
    ar, dar = want["all-reduce"], dc.get("all-reduce", zero)
    n, w = _sum(calls, MODEL_GSPMD)
    assert n == mb * (ar["count"] - 3 - dar["count"])
    assert w == pytest.approx(ar["wire_bytes"] - ce - dar["wire_bytes"],
                              rel=1e-9)
    # the data axis
    assert {k: v for k, v in want.items() if k in ("reduce-scatter",
                                                   "all-gather")} == \
        {k: v for k, v in dc.items() if k != "all-reduce"}
    n_fsdp = calls.get("fsdp-gather", {}).get("count", 0) // mb
    gw = calls.get("fsdp-gather", {}).get("wire_bytes", 0.0) / mb
    for kind in ("all-reduce", "reduce-scatter", "all-gather"):
        n, w = _sum(calls, [c for c, k in DATA_GSPMD.items() if k == kind])
        d = dc.get(kind, zero)
        if kind == "all-gather":
            assert (n, w) == (d["count"] + (mb - 1) * n_fsdp,
                              pytest.approx(d["wire_bytes"] + (mb - 1) * gw,
                                            rel=1e-9))
        else:
            assert (n, w) == (mb * d["count"], pytest.approx(
                mb * d["wire_bytes"], rel=1e-9))
    # the model axis' own calls, pinned
    n_moe = _n(cfg, ("moe",))
    n_attn = _n(cfg, ("attn", "moe"))
    pinned = {"ce": 6 * mb, "model-gnorm": 1}
    if tp.experts_split:
        pinned.update({"router-gather": (1 + rem) * n_moe * mb,
                       "router-scatter": n_moe * mb,
                       "experts-grad": n_moe * mb,
                       "experts-sum": (1 + rem) * n_moe * mb})
        assert want["all-to-all"]["count"] == 2 * (2 + rem)
    if tp.gathers:
        pinned.update({"qkv-gather": (1 + rem) * n_attn * mb,
                       "qkv-scatter": n_attn * mb})
    if cfg.qkv_bias:
        pinned["bias-grad"] = 3 * n_attn * mb
    if D > 1:
        pinned.update({"loss": mb, "gnorm": 1})
        if n_moe:
            pinned["moe"] = n_moe * mb
    own = {k: v["count"] for k, v in calls.items()
           if k not in MODEL_GSPMD and k not in DATA_GSPMD}
    assert own == pinned
    assert calls["ce"]["wire_bytes"] == pytest.approx(2 * ce)


@pytest.mark.parametrize("fault", [f[0] for f in T.FAULTS])
def test_planted_faults_fail(runs, fault):
    """Each planted fault breaks at least one check against the
    reference's numbers of the same config and mesh."""
    _, ref, worlds = runs
    _, name, D, M = next(f for f in T.FAULTS if f[0] == fault)
    res = worlds[D * M][0][("fault", fault)]
    assert mismatches(res["steps"], ref[(name, D, M, 1, False)]) != []


@pytest.mark.parametrize("D,M", [(1, 2), (2, 2), (1, 4)])
def test_plan_reads_the_trunk_from_the_leaves(D, M):
    """`train_plan` on a (data, model) mesh: each leaf's model block is
    the block its trunk plan runs it over; the vocabulary rows are
    embed's V/M; the moment block lies inside the model block."""
    cfg = T.config("moe")
    from repro_torch.models.model import Model
    whole = Model(cfg, device="meta").abstract_params()
    for rank in range(D * M):
        plan = port.train_plan(whole, _mesh(D, M), rank=rank, cfg=cfg)
        m = rank % M
        assert (plan.rank, plan.model_rank) == (rank // M, m)
        V = cfg.vocab_size
        assert plan.vocab == (m * V // M, (m + 1) * V // M)
        for lp in plan.leaves:
            for s, b in zip(lp.moment, lp.block):
                assert b.start <= s.start <= s.stop <= b.stop
            if lp.path.endswith("['router']"):
                E = cfg.num_experts
                assert lp.block[-1] == slice(m * E // M, (m + 1) * E // M)


def test_plan_refuses_a_trunk_that_disagrees_with_the_leaves(monkeypatch):
    """A trunk plan whose blocks are not the leaves' raises, naming the
    leaf."""
    cfg = T.config("demo")
    from dataclasses import replace
    from repro_torch.models.model import Model
    whole = Model(cfg, device="meta").abstract_params()
    real = port.trunk_plan
    monkeypatch.setattr(port, "trunk_plan", lambda *a, **k: replace(
        real(*a, **k), ff_split=False))
    with pytest.raises(ValueError, match=r"syncode-demo at M = 2.*"
                                         r"\['ffn'\]\['w_down'\]"):
        port.train_plan(whole, _mesh(1, 2), rank=1, cfg=cfg)


def test_cli_model_axis_runs(tmp_path, capfd):
    """`launch.train --data 1 --model 2` on the CPU: the ranks train, rank
    0 alone prints and writes the checkpoint; the losses are the
    one-device CLI's within bf16's noise."""
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "syncode-demo", "--steps", "2",
            "--batch", "4", "--seq", "32"]
    _, one = main(argv)
    capfd.readouterr()
    none, res = main(argv + ["--checkpoint", str(tmp_path / "m.msgpack"),
                             "--model", "2"])
    out = capfd.readouterr().out
    assert none is None and out.count("final loss") == 1
    assert "(data 1, model 2) training on 2 ranks over gloo" in out
    assert (tmp_path / "m.msgpack").exists()
    for a, b in zip(res.losses, one.losses):
        assert math.isfinite(a) and abs(a - b) <= 5e-3 * abs(b)
