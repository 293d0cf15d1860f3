"""The port's dry run (`repro_torch.launch.{shapes,dryrun}`) against the
reference's own functions, and the engine's per-call costs.

  * `count_params`, `applicable`, `variant_for_shape`,
    `DEFAULT_MICROBATCH` and `input_specs` equal the reference's for all
    eleven configs and four shapes: leaf paths, shapes and dtypes of the
    port's meta tensors against the reference's `eval_shape` structs;
  * the argument bytes a device holds equal the sum of the shard sizes
    of the reference's PartitionSpecs (its `NamedSharding` monkeypatched
    to hand back the spec, as `test_torch_sharding.py` does) on both
    production meshes, stand-in mesh objects;
  * `run_one` gives a record with the reference's keys (less the four
    that name XLA) for one config a family, and no op it runs makes a
    tensor off the meta device; `run_all` writes 44 records a mesh;
  * an engine with `devtime=True` reports `flops_per_call` and
    `hbm_bytes_per_call` for `forward` (dense and paged) and
    `mask_sample`, equal to `cost.py` at the dispatched shapes, and
    `/metrics` carries them; with devtime off `cost.py` never runs.
The reference's dry-run module forces 512 host devices when it is
imported into a process whose XLA_FLAGS name no device count: it is
imported here with the count pinned to the one device tests see.
"""
import dataclasses
import json
import math
import os
from functools import lru_cache

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.distributed.sharding as ref_sharding
from repro.configs import _MODULES
from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.distributed import cost
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.obs import Telemetry

CONFIGS = sorted(_MODULES)
SHAPES = list(shapes.SHAPES)
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def _ref_modules():
    """(repro.launch.dryrun, repro.launch.shapes), imported without
    changing the process's device count."""
    flags = os.environ.get("XLA_FLAGS")
    if flags is None or "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags or "") + \
            " --xla_force_host_platform_device_count=1"
    try:
        import repro.launch.dryrun as rd
        import repro.launch.shapes as rs
    finally:
        if flags is None:
            del os.environ["XLA_FLAGS"]
        else:
            os.environ["XLA_FLAGS"] = flags
    return rd, rs


RD, RS = _ref_modules()


@lru_cache(maxsize=None)
def ref_specs(arch, shape):
    cfg = RS.variant_for_shape(ref_config(arch), shape)
    return RS.input_specs(ref_build(cfg), shape)


@lru_cache(maxsize=None)
def port_specs(arch, shape):
    cfg = shapes.variant_for_shape(get_config(arch), shape)
    return shapes.input_specs(Model(cfg, device="meta"), shape)


def _leaves(tree):
    """[(path, shape, dtype name)] of a JAX or a meta-tensor tree."""
    out = []
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        dt = str(x.dtype).removeprefix("torch.")
        out.append((jax.tree_util.keystr(path), tuple(x.shape), dt))
    return out


@pytest.mark.parametrize("arch", CONFIGS)
def test_count_params_and_microbatch_match_reference(arch):
    _, rs = ref_specs(arch, "train_4k")
    _, ps = port_specs(arch, "train_4k")
    assert dryrun.count_params(ps["params"], get_config(arch)) == \
        RD.count_params(rs["params"], ref_config(arch))
    assert dryrun.DEFAULT_MICROBATCH == RD.DEFAULT_MICROBATCH


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", CONFIGS)
def test_shapes_match_reference(arch, shape):
    assert shapes.applicable(get_config(arch), shape) == \
        RS.applicable(ref_config(arch), shape)
    assert dataclasses.asdict(
        shapes.variant_for_shape(get_config(arch), shape)) == \
        dataclasses.asdict(RS.variant_for_shape(ref_config(arch), shape))
    rmode, rs = ref_specs(arch, shape)
    pmode, ps = port_specs(arch, shape)
    assert pmode == rmode and list(ps) == list(rs)
    for k in rs:
        assert _leaves(ps[k]) == _leaves(rs[k]), k
    assert all(x.is_meta for _, x in _flat(ps))


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _zip(tree, specs):
    """(leaf, spec) pairs of a tree and its spec tree, walked side by
    side (a spec is itself a tuple)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _zip(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, sp in zip(tree, specs, strict=True):
            yield from _zip(t, sp)
    else:
        yield tree, specs


def _ref_arg_bytes(arch, shape, mesh):
    """Per-device bytes of the step's inputs under the reference's specs,
    as its `_jit_target` shards them."""
    mode, sp = ref_specs(arch, shape)
    cfg = RS.variant_for_shape(ref_config(arch), shape)
    fsdp = ref_sharding.needs_fsdp(sp["params"], mesh)
    trees = {"params": ref_sharding.params_shardings(sp["params"], mesh,
                                                     fsdp=fsdp)}
    if mode == "train":
        trees["opt_state"] = ref_sharding.opt_state_shardings(
            sp["opt_state"], mesh)
        trees["batch"] = ref_sharding.batch_shardings(sp["batch"], mesh)
    elif mode == "prefill":
        trees["batch"] = ref_sharding.batch_shardings(sp["batch"], mesh)
    else:
        trees["caches"] = ref_sharding.cache_shardings(sp["caches"], mesh,
                                                       cfg)
        t = ref_sharding.batch_shardings({"t": sp["token"]}, mesh)["t"]
        W = sp["mask_store"].shape[1]
        s = (None, "model" if ref_sharding._div(W, mesh, "model") else None)
        for k in ("token", "pos", "mask_rows", "eos_allowed"):
            trees[k] = t
        trees["mask_store"] = trees["mask_cd"] = s
    out = {}
    for k, specs in trees.items():
        total = 0
        for x, spec in _zip(sp[k], specs):
            ways = 1
            for e in spec:
                for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                    ways *= mesh.shape[a]
            n = math.prod(x.shape)
            assert n % ways == 0
            total += n // ways * x.dtype.itemsize
        out[k] = total
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", CONFIGS)
def test_argument_bytes_match_reference_specs(arch, shape, mesh,
                                              monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding",
                        lambda m, spec: tuple(spec))
    m = MESHES[mesh]
    mode, ps = port_specs(arch, shape)
    cfg = shapes.variant_for_shape(get_config(arch), shape)
    assert dryrun.argument_bytes(cfg, mode, ps, m) == \
        _ref_arg_bytes(arch, shape, m)


class _OffMeta(TorchDispatchMode):
    """Records every op whose output is a tensor off the meta device."""

    def __init__(self):
        super().__init__()
        self.off = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.off.append(str(func))
        return out


REF_KEYS = {"arch", "shape", "mesh", "mode", "chips", "microbatch",
            "seq_parallel", "flops_per_device", "hbm_bytes_per_device",
            "wire_bytes_per_device", "collectives", "memory", "fits_hbm",
            "hbm_utilization", "params_total", "params_active",
            "model_flops_global", "hlo_flops_global", "useful_flops_ratio",
            "roofline"}


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b",
                                  "mamba2-370m", "recurrentgemma-9b",
                                  "whisper-base", "llama-3.2-vision-90b"])
def test_run_one_on_meta(arch):
    for shape in SHAPES:
        if not shapes.applicable(get_config(arch), shape)[0]:
            continue
        cost.meta_params.cache_clear()
        with _OffMeta() as mode:
            rec = dryrun.run_one(arch, shape, save=False, verbose=False)
        assert mode.off == [], (shape, mode.off[:5])
        assert set(rec) == REF_KEYS
        assert set(rec["memory"]) >= {"temp_size_in_bytes",
                                      "argument_size_in_bytes",
                                      "output_size_in_bytes",
                                      "alias_size_in_bytes"}
        assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                                 "collective_s")
        assert rec["flops_per_device"] > 0 and rec["chips"] == 256
        assert 0 < rec["useful_flops_ratio"]


def test_run_all_writes_every_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    for multi_pod in (False, True):
        recs, failures = dryrun.run_all(multi_pod)
        assert failures == [] and len(recs) == 44
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 88
    skipped = [f for f in files
               if "skipped" in json.loads((tmp_path / f).read_text())]
    assert skipped == ["whisper-base__long_500k__16x16.json",
                       "whisper-base__long_500k__2x16x16.json"]


def test_meta_is_only_the_abstract_path():
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import build_engine
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("meta", abstract=True).type == "meta"
    with pytest.raises(ValueError):
        build_engine("syncode-demo", device="meta")
    m = Model(get_config("syncode-demo"), device="meta")
    p = m.abstract_params()
    ref = Model(get_config("syncode-demo"), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert _leaves(p) == _leaves(ref)
    assert all(x.is_meta for _, x in _flat(p))
    from repro_torch.training.optimizer import init_opt_state
    assert all(x.is_meta for _, x in _flat(init_opt_state(p)))
    assert all(x.is_meta for _, x in _flat(m.init_decode_caches(2, 16)))


# ------------------------------ engine costs ------------------------------

def _serve(paged, devtime):
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Request
    from repro_torch.serving.loop import ListSource, StepLoop, make_mode
    eng, _, _ = build_engine("syncode-demo", grammars=("json",),
                             device="cpu", devtime=devtime, slots=4,
                             paged=paged, max_len=128)
    reqs = [Request(rid=i, prompt=b"{", grammar="json", max_new_tokens=6)
            for i in range(4)]
    tele = Telemetry(enabled=True)
    # CPU ops run synchronously: a no-op sync brackets them exactly
    # (the device bridge binds torch.cuda.synchronize on the card)
    tele.devtime.bind(lambda out: None)
    StepLoop(eng, make_mode(eng), ListSource(reqs), telemetry=tele).run()
    return eng, tele


_ORIG = {n: getattr(cost, n) for n in ("decode_step", "paged_feed",
                                       "mask_sample")}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_reports_costs_under_devtime(paged, monkeypatch):
    seen = []
    for name, fn in _ORIG.items():
        monkeypatch.setattr(cost, name, lambda *a, _f=fn, _n=name, **k:
                            seen.append((_n, a, k)) or _f(*a, **k))
    eng, tele = _serve(paged, devtime=True)
    s = tele.devtime.summary()
    cfg = eng.model.cfg
    # once per fn name, at the shapes the engine dispatched
    assert [n for n, _, _ in seen] == \
        ["paged_feed" if paged else "decode_step", "mask_sample"]
    (_, fa, fk), (_, ma, mk) = seen
    if paged:
        assert fa[:2] == (cfg, eng.slots) and fa[3:] == (
            eng.max_pages, eng.page_size) and 1 <= fa[2]
    else:
        assert fa == (cfg, eng.slots, eng.max_len)
    assert fk == {"vocab": cfg.vocab_size}
    assert ma[:3] == (eng.slots, cfg.vocab_size, ma[2]) and ma[2] >= 1
    fwd = _ORIG[seen[0][0]](*fa, **fk)
    msk = _ORIG["mask_sample"](*ma, **mk)
    assert s["forward"]["flops_per_call"] == fwd["flops"] > 0
    assert s["forward"]["hbm_bytes_per_call"] == fwd["hbm_bytes"]
    assert s["mask_sample"]["flops_per_call"] == 0.0
    assert s["mask_sample"]["hbm_bytes_per_call"] == msk["hbm_bytes"]
    for fn in ("forward", "mask_sample"):
        assert s[fn]["achieved_bytes_per_s"] > 0
    text = tele.registry.render_prometheus().splitlines()
    assert f'repro_device_flops_per_call{{fn="forward"}} ' \
        f'{fwd["flops"]:.0f}' in text
    assert f'repro_device_hbm_bytes_per_call{{fn="mask_sample"}} ' \
        f'{msk["hbm_bytes"]:.0f}' in text


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_no_cost_without_devtime(paged, monkeypatch):
    calls = []
    for name in ("decode_step", "paged_feed", "mask_sample", "span_decode",
                 "prefill", "train_step"):
        monkeypatch.setattr(cost, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    eng, tele = _serve(paged, devtime=False)
    assert calls == []
    assert tele.devtime.costs == {}
