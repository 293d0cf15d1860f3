"""The port's data-parallel train step against the reference's own
sharded step (`repro.launch.dryrun._jit_target(model, "train", ...)`) at
the same mesh shape, on the CPU.

The reference side runs in ONE subprocess for the module: it forces 8
host devices (`XLA_FLAGS=--xla_force_host_platform_device_count=8`)
before jax is imported, builds Auto-axis meshes with
`jax.sharding.Mesh(devices.reshape(D, 1), ("data", "model"))` (the axes
of `jax.make_mesh` are Explicit on jax 0.9, and the reference's
sharding constraints refuse them), and passes copies of the arguments
to each call (the step donates them). It reads ce, lb and z through a
`jax.debug.callback` on the model's loss and gnorm through one on
`apply_updates`' metrics (the step returns the loss only); FSDP is
forced by making `needs_fsdp` answer True. The port side runs the
same cases on gloo worlds of 1, 2 and 4 ranks (`launch.mesh.spawn`,
cases in `tests/_torch_train_shard_cases.py`), with the reference's
`Model.init(PRNGKey(0))` weights bridged in.

Held, for syncode-demo and the narrow MoE, at data 1, 2 and 4 x
microbatch 1 and 2, over 2 AdamW steps with a planted unequal
loss_mask (fp32; XLA and torch sum in other orders):
  * loss, ce, lb, z and gnorm within 1e-5 relative;
  * every gathered param and moment within 1e-5 of the leaf's largest
    magnitude (1e-5 relative at the leaf's scale);
  * FSDP forced: the same, and each rank holds exactly the specs'
    blocks of params and moments (and of the accumulator, microbatched);
  * B = 2 at data 4 (the batch replicated by `batch_specs`): the
    one-device step's numbers;
  * the planted faults (a mean of per-rank means, local MoE fractions,
    a norm over the local block only, gradients summed where the batch
    is replicated) each break at least one of these checks;
  * the collectives of a step against `cost.train_step`'s count;
  * a model axis above 1 is refused for the layer kinds it does not
    split, and a mesh that is not the world's size is refused.
"""
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
from repro_torch.launch.mesh import MeshShape, make_train_mesh, spawn
from repro_torch.training.optimizer import block_shape
import _torch_train_shard_cases as T

WORLDS = (1, 2, 4)
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
import _torch_train_shard_cases as T

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
    name, D, mb, fsdp = case
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
    mesh = Mesh(np.array(jax.devices()[:D]).reshape(D, 1),
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
    mb = case[2]
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
    """-> (payload, reference {case: steps}, one-device port {(config,
    mb, fsdp): run at B = REPLICATED_B}, port worlds {n: [rank
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

    tmp = str(tmp_path_factory.mktemp("train_shard"))
    bg = [threading.Thread(target=side, args=("ref", _reference, payload,
                                              tmp))]
    bg += [threading.Thread(target=side, args=(n, spawn, n, T.world, n,
                                               payload),
                            kwargs={"device": "cpu"})
           for n in WORLDS if n > 1]
    for t in bg:
        t.start()
    side(1, spawn, 1, T.world, 1, payload, device="cpu")
    one = {(name, mb): T.run(None, name, payload[name], mb, False,
                             T.REPLICATED_B)
           for name, _, mb, _ in T.REPLICATED}
    for t in bg:
        t.join()
    if errors:
        raise errors[0]
    worlds = {n: got[n] for n in WORLDS}
    return payload, got["ref"], one, worlds


def _leaf_rel(a, b) -> float:
    """max |a - b| over the leaf's largest magnitude (b's)."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def mismatches(port_steps, want_steps, rel=REL) -> list:
    """Every check of the module docstring that `port_steps` fails
    against `want_steps`, as strings (empty: all hold)."""
    bad = []
    for t, (p, w) in enumerate(zip(port_steps, want_steps)):
        for k in ("loss", "ce", "lb", "z", "gnorm"):
            if abs(p[k] - w[k]) > rel * max(abs(w[k]), 1e-30):
                bad.append(f"step {t} {k}: {p[k]} vs {w[k]}")
        for k in ("params", "mu", "nu"):
            pw = dict(port.leaves_with_path(w[k]))
            for path, leaf in port.leaves_with_path(p[k]):
                e = _leaf_rel(leaf, pw[path])
                if not e <= rel:
                    bad.append(f"step {t} {k}{path}: {e:.3g}")
    return bad


def _data_mesh(D):
    return MeshShape({"data": D, "model": 1}, ("data", "model"))


@pytest.mark.parametrize("case", T.CASES, ids=lambda c: "-".join(map(str, c)))
def test_step_matches_the_reference_sharded_step(runs, case):
    """loss, ce, lb, z, gnorm and every gathered param and moment after
    each of 2 steps within 1e-5 of the reference's sharded step at the
    same (data, 1) mesh and microbatch."""
    _, ref, _, worlds = runs
    res = worlds[case[1]][0][("case", case)]
    assert mismatches(res["steps"], ref[case]) == []


@pytest.mark.parametrize("case", T.CASES, ids=lambda c: "-".join(map(str, c)))
def test_each_rank_holds_the_specs_blocks(runs, case):
    """Each rank's param, moment and accumulator bytes are the blocks of
    `param_specs(fsdp=...)` and `opt_state_specs(zero=True)`."""
    payload, _, _, worlds = runs
    name, D, mb, fsdp = case
    mesh = _data_mesh(D)
    whole = payload[name]
    for rank, res in enumerate(worlds[D]):
        plan = port.train_plan(whole, mesh, fsdp=fsdp, rank=rank)
        pb = ob = 0
        for path, leaf in port.leaves_with_path(whole):
            n = leaf.dtype.itemsize
            pspec = port.param_spec(path, leaf.shape, mesh, fsdp=fsdp)
            ospec = port.opt_state_spec("['mu']" + path, leaf.shape, mesh)
            pb += np.prod(block_shape(port.shard_slice(
                pspec, leaf.shape, mesh, rank))) * n
            ob += np.prod(block_shape(port.shard_slice(
                ospec, leaf.shape, mesh, rank))) * 4
        got = res[("case", case)]["bytes"]
        assert got == {"params": pb, "moments": 2 * ob,
                       "acc": ob if mb > 1 else 0}
        if fsdp and D > 1:
            assert pb < sum(leaf.nbytes for _, leaf in
                            port.leaves_with_path(whole))
        assert len(plan.leaves) == len(list(port.leaves_with_path(whole)))


@pytest.mark.parametrize("case", T.REPLICATED,
                         ids=lambda c: "-".join(map(str, c)))
def test_replicated_batch_gives_the_one_device_numbers(runs, case):
    """B = 2 at data 4: `batch_specs` replicates the batch, every rank
    runs both rows, and the step is the one-device step's."""
    _, _, one, worlds = runs
    name, D, mb, fsdp = case
    assert port.batch_specs({"t": np.zeros((T.REPLICATED_B, 4))},
                            _data_mesh(D))["t"][0] is None
    res = worlds[D][0][("replicated", case)]
    assert mismatches(res["steps"], one[(name, mb)]["steps"]) == []


@pytest.mark.parametrize("fault", [f[0] for f in T.FAULTS])
def test_planted_faults_fail(runs, fault):
    """Each planted fault breaks at least one check against the sound
    numbers of the same config and mesh (the reference's step, or the
    one-device step for the replicated batch)."""
    _, ref, one, worlds = runs
    _, name, D, rows = next(f for f in T.FAULTS if f[0] == fault)
    res = worlds[D][0][("fault", fault)]
    want = one[(name, 1)]["steps"] if rows == T.REPLICATED_B else \
        ref[(name, D, 1, False)]
    assert mismatches(res["steps"], want) != []


def _moe_layers(cfg):
    from repro_torch.models.model import layer_groups
    return sum(count for pat, count in layer_groups(cfg)
               for kind in pat if kind == "moe")


@pytest.mark.parametrize("case", T.CASES, ids=lambda c: "-".join(map(str, c)))
def test_collectives_against_the_cost_count(runs, case):
    """A step's gradient and param collectives are the count
    `cost.train_step(..., mesh=)` makes of the reference's: FSDP's
    gathers and reduce-scatters, ZeRO-1's reduce-scatter in and
    all-gather out (a reduce-scatter a microbatch into the
    accumulator), the all-reduce of a leaf whose moments are whole. The
    port's own extra calls are pinned: one all-reduce of the loss's
    (tot, cnt) a microbatch, one of the router's sums a MoE layer a
    microbatch, one of the gradient's sum of squares; no reshard."""
    name, D, mb, fsdp = case
    _, _, _, worlds = runs
    calls = worlds[D][0][("case", case)]["calls"]
    cfg = T.config(name)
    if D == 1:
        assert calls == {}
        return
    mesh = _data_mesh(D)
    with_fsdp = cost.needs_fsdp
    try:
        cost.needs_fsdp = lambda *a, **k: fsdp
        want = cost.train_step(cfg, T.B, T.S, mb, mesh=mesh)["collectives"]
    finally:
        cost.needs_fsdp = with_fsdp
    got = {}
    for call, d in calls.items():
        kind = {"fsdp-gather": "all-gather", "fsdp-scatter":
                "reduce-scatter", "grad-all-reduce": "all-reduce"}.get(call,
                                                                      call)
        if call in ("loss", "moe", "gnorm"):
            continue
        g = got.setdefault(kind, {"count": 0, "wire_bytes": 0.0})
        g["count"] += d["count"]
        g["wire_bytes"] += d["wire_bytes"]
    rs = want["reduce-scatter"]
    # the accumulator takes a reduce-scatter a microbatch where cost.py
    # counts one a step; FSDP's reduce-scatter runs once a microbatch too
    assert got["reduce-scatter"]["count"] == mb * rs["count"]
    assert got["reduce-scatter"]["wire_bytes"] == pytest.approx(
        mb * rs["wire_bytes"], rel=1e-12)
    ag = want["all-gather"]
    n_fsdp = calls.get("fsdp-gather", {}).get("count", 0) // mb
    assert got["all-gather"]["count"] == ag["count"] + (mb - 1) * n_fsdp
    assert "all-reduce" not in got and "reshard" not in calls
    assert calls["loss"] == {"count": mb, "bytes": 8 * mb,
                             "wire_bytes": pytest.approx(
                                 mb * 8 * 2 * (D - 1) / D)}
    assert calls["gnorm"]["count"] == 1
    assert got["all-gather"]["wire_bytes"] == pytest.approx(
        ag["wire_bytes"] + (mb - 1) / mb * calls.get("fsdp-gather", {}).get(
            "wire_bytes", 0.0), rel=1e-12)
    assert calls.get("moe", {}).get("count", 0) == _moe_layers(cfg) * mb
    assert not cfg.remat        # no recompute: one gather a microbatch


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "llama-3.2-vision-90b", "whisper-base"])
def test_model_axis_is_refused(arch):
    """Under a model axis above 1, a config with a layer kind other than
    attn and moe (ssm, rec, cross, enc, dec) raises, naming the config,
    M and the kinds; a mesh whose data x model is not the world's size
    raises, naming both."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch).reduced()
    whole = Model(cfg, device="meta").abstract_params()
    kinds = {"mamba2-370m": r"\['ssm'\]",
             "recurrentgemma-9b": r"\['rec'\]",
             "llama-3.2-vision-90b": r"\['cross'\]",
             "whisper-base": r"\['dec', 'enc'\]"}[arch]
    with pytest.raises(ValueError, match=rf"{cfg.name} at M = 2: layer "
                                         rf"kinds {kinds}"):
        port.train_plan(whole, MeshShape({"data": 1, "model": 2},
                                         ("data", "model")), cfg=cfg)
    with pytest.raises(ValueError, match=r"\(data 1, model 2\) needs a "
                                         r"process group of 2 ranks, got 1"):
        make_train_mesh(1, model=2, device="cpu")


def test_microbatch_rows_follow_the_reference_reshape():
    """Microbatch i is global rows [i B/mb, (i+1) B/mb), each rank its
    block of it; a replicated batch gives every rank every row; a split
    that does not cut evenly raises, naming both numbers."""
    assert port.TrainPlan(2, 1, False, ()).rows(8, 2) == (
        False, [slice(2, 4), slice(6, 8)])
    assert port.TrainPlan(4, 3, False, ()).rows(2, 1) == (
        True, [slice(0, 2)])
    assert port.TrainPlan(4, 3, False, ()).rows(2, 2) == (
        True, [slice(0, 1), slice(1, 2)])
    with pytest.raises(ValueError, match=r"batch of 4 rows.*microbatch 4 "
                                         r"x data 2"):
        port.TrainPlan(2, 1, False, ()).rows(4, 4)
    with pytest.raises(ValueError, match=r"batch of 3 rows.*microbatch 2 "
                                         r"x data 1"):
        port.TrainPlan(4, 0, False, ()).rows(3, 2)


def test_moment_dim_may_differ_from_the_fsdp_dim():
    """The moments' rule looks at the stacked layer dim, FSDP's never
    does: a [8, 4, 2] stacked leaf splits dim 0 for its moments and dim
    1 for FSDP, and the plan keeps both."""
    tree = {"groups": [[{"attn": {"wq": np.zeros((8, 4, 2), np.float32)}}]]}
    lp = port.train_plan(tree, _data_mesh(2), fsdp=True, rank=1).leaves[0]
    assert (lp.pdim, lp.odim) == (1, 0)
    assert lp.param == (slice(0, 8), slice(2, 4), slice(0, 2))
    assert lp.moment == (slice(4, 8), slice(0, 4), slice(0, 2))


@pytest.mark.parametrize("n", [n for n in WORLDS if n > 1])
def test_zero_update_reshards_between_fsdp_and_moment_dims(runs, n):
    """Where a leaf's FSDP dim is not its moments' dim, the ZeRO-1 update
    gathers along the one and cuts along the other, and its params equal
    the one-device update on the summed gradients."""
    _, _, _, worlds = runs
    for res in worlds[n]:
        err, calls = res["reshard"]
        assert err <= 1e-6
        assert calls["reshard"]["count"] == 2     # the gradient and param


def test_cli_data_parallel_matches_the_one_device_cli(tmp_path, capfd):
    """`launch.train --data 2` on the CPU: rank 0 alone prints the log
    and writes the checkpoint, after the ranks gathered the params; its
    losses and saved params are the one-device CLI's within bf16's noise
    (the bound phase 15 holds the card to, relative; the params within
    two bf16 ulps of each leaf's largest magnitude)."""
    from repro_torch.launch.train import main
    from repro_torch.training.checkpoint import load_checkpoint
    argv = ["--device", "cpu", "--arch", "syncode-demo", "--steps", "2",
            "--batch", "4", "--seq", "32"]
    one_path, dp_path = str(tmp_path / "one.msgpack"), str(
        tmp_path / "dp.msgpack")
    one, res1 = main(argv + ["--checkpoint", one_path])
    capfd.readouterr()
    none, res2 = main(argv + ["--checkpoint", dp_path, "--data", "2"])
    out = capfd.readouterr().out      # the ranks' output included
    assert none is None and out.count("final loss") == 1
    assert "data-parallel training on 2 ranks over gloo" in out
    for a, b in zip(res2.losses, res1.losses):
        assert abs(a - b) <= 5e-3 * abs(b)
    got, step, _ = load_checkpoint(dp_path, one)
    assert step == 2
    for (path, a), (_, b) in zip(port.leaves_with_path(got),
                                 port.leaves_with_path(one)):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= \
            2 * 2 ** -8 * scale, path
