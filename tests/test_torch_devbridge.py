"""The port's device bridge (`repro_torch.serving.devbridge`) on the CPU:
a Kineto-style Chrome trace (CUDA kernels on threads named `stream <n>`,
as torch.profiler exports them) goes through the bridge's writer and the
copied `ProfilerSession.collect_chrome_events`, and its kernel slices
come out on device tracks; the CPU binds no device capability. Also a
source check of the serving front end: `serving/async_engine.py` and
`serving/server.py` never synchronize the device."""
import ast
from pathlib import Path

from repro_torch.obs import Telemetry
from repro_torch.obs.devtime import DEVICE_TRACK_PREFIX
from repro_torch.serving import devbridge

ROOT = Path(__file__).resolve().parents[1]


def _kineto_trace():
    """What `torch.profiler.profile.export_chrome_trace` writes for two
    kernels on stream 7 and one on stream 13 of device 0, beside the
    host thread's op and launch slices."""
    meta = lambda pid, tid, name: {"name": "thread_name", "ph": "M",
                                   "pid": pid, "tid": tid,
                                   "args": {"name": name}}
    ev = lambda pid, tid, name, ts, dur, cat: {
        "ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
        "ts": ts, "dur": dur}
    return {"schemaVersion": 1, "traceEvents": [
        meta(4242, 4242, "thread 4242 (python3)"),
        meta(0, 7, "stream 7 "),
        meta(0, 13, "stream 13 "),
        ev(4242, 4242, "aten::mm", 1000.0, 30.0, "cpu_op"),
        ev(4242, 4242, "cudaLaunchKernel", 1010.0, 5.0, "cuda_runtime"),
        ev(0, 7, "fused_select_kernel(...)", 1020.5, 12.25, "kernel"),
        ev(0, 7, "ampere_bf16_s16816gemm", 1040.0, 8.0, "kernel"),
        ev(0, 13, "paged_attention_kernel", 1050.0, 3.0, "kernel"),
    ]}


def test_kineto_stream_threads_land_on_device_tracks(tmp_path):
    tele = Telemetry(enabled=True)
    prof = tele.profiler
    prof.start(str(tmp_path))
    prof.stop()
    path = devbridge.write_trace(_kineto_trace(), str(tmp_path))
    rel = Path(path).relative_to(tmp_path)
    assert rel.parts[:2] == ("plugins", "profile")
    assert rel.name.endswith(".trace.json.gz")
    events = prof.collect_chrome_events()
    names = sorted(e["name"] for e in events)
    assert names == ["ampere_bf16_s16816gemm", "fused_select_kernel(...)",
                     "paged_attention_kernel"]
    tracks = {e["name"]: e["track"] for e in events}
    assert all(t.startswith(DEVICE_TRACK_PREFIX) for t in tracks.values())
    assert tracks["fused_select_kernel(...)"] != \
        tracks["paged_attention_kernel"]      # one track per stream
    k = next(e for e in events if e["name"].startswith("fused_select"))
    assert k["dur_us"] == 12.25
    # rebased: the earliest kernel sits at the capture's host start
    assert min(e["ts_us"] for e in events) == prof.host_t0 * 1e6


def test_the_trace_without_the_rename_yields_no_device_events(tmp_path):
    """Why the bridge renames: the collector's device-thread markers do
    not match Kineto's own `stream <n>` names."""
    import gzip
    import json
    tele = Telemetry(enabled=True)
    tele.profiler.start(str(tmp_path))
    tele.profiler.stop()
    d = tmp_path / "plugins" / "profile" / "raw"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump(_kineto_trace(), f)
    assert tele.profiler.collect_chrome_events() == []


def test_cpu_binds_no_device_capability():
    tele = Telemetry(enabled=True)
    devbridge.attach(tele, "cpu")
    assert tele.devtime.sync_fn is None
    assert tele.profiler.profiler_start is None


def _calls(path):
    """(attribute or function name) of every call in a source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call):
            f = node.func
            yield f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")


def test_front_end_never_syncs_the_device():
    for rel in ("serving/async_engine.py", "serving/server.py"):
        src = ROOT / "src" / "repro_torch" / rel
        bad = {c for c in _calls(src)
               if c in ("item", "cpu", "synchronize")}
        assert not bad, (rel, bad)
        assert "synchronize" not in src.read_text()
