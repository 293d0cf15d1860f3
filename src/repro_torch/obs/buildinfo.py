"""Build identity: the probe that lets a scraped metric be correlated
with a bench artifact.

`build_info()` returns {git_sha, git_dirty, jax_version, device_kind,
device_count, python, platform, hostname} — the same run_meta fields
benchmarks/common.py stamps into every `BENCH_<sha>.json` row, so a
/stats snapshot and a bench artifact taken on the same checkout agree
byte-for-byte on identity. Served on `GET /healthz` and `GET /stats`.

Purity: repro.obs must never import jax or numpy (tests/test_obs.py
scans every file and the transitive import set). The jax fields are
therefore read from `sys.modules` — if the serving process already
imported jax (it always has by the time a server answers /healthz), we
report its version and device kind; in a process that never touched
jax, the fields read "absent" instead of dragging the device runtime
into an otherwise pure-obs import. The device probe is wrapped in a
broad except: identity reporting must never take down a health check.
"""
from __future__ import annotations

import functools
import os
import platform
import socket
import subprocess
import sys


def git_revision(cwd: str | None = None) -> tuple[str, bool]:
    """(short sha, dirty?) of the repo containing *cwd* — ("unknown",
    False) when git or the work tree is unavailable."""
    cwd = cwd or os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip())
        return sha, dirty
    except Exception:
        return "unknown", False


def _jax_fields() -> dict:
    """jax version + device identity from sys.modules — never imports."""
    mod = sys.modules.get("jax")
    if mod is None:
        return {"jax_version": "absent", "device_kind": "absent",
                "device_count": 0}
    out = {"jax_version": getattr(mod, "__version__", "unknown"),
           "device_kind": "unknown", "device_count": 0}
    try:
        devs = mod.devices()
        out["device_kind"] = getattr(devs[0], "device_kind",
                                     devs[0].platform)
        out["device_count"] = len(devs)
    except Exception:
        pass
    return out


@functools.lru_cache(maxsize=1)
def _static_fields() -> dict:
    sha, dirty = git_revision()
    return {
        "git_sha": sha,
        "git_dirty": dirty,
        "python": platform.python_version(),
        "platform": f"{platform.system()}-{platform.machine()}",
        "hostname": socket.gethostname(),
    }


def build_info() -> dict:
    """Full identity dict; git/platform fields cached, jax fields live
    (device kind can change between import and first device use)."""
    out = dict(_static_fields())
    out.update(_jax_fields())
    return out


def run_meta_str(extra: dict | None = None) -> str:
    """Legacy ';'-joined `k=v` form used in bench CSV rows."""
    info = build_info()
    if extra:
        info = {**info, **extra}
    return ";".join(f"{k}={info[k]}" for k in sorted(info))
