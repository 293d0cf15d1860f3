"""Build the port's CUDA kernels and load them with ctypes.

Every `.cu` under `repro_torch/csrc/` is compiled by its own `nvcc`
process (all started together) for Hopper, `sm_90a`, and the objects are
linked into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c <src>.cu ; nvcc -shared *.o

No `--use_fast_math`: the select math needs IEEE division and `expf`.
The library lands in `build/kernels/` at the repository root, named by
a hash of the sources and flags, so it is built at first use and rebuilt
whenever a source changes. Each C entry point launches on the stream it
is given and returns `cudaGetLastError()`; the wrappers in
`kernels/*/ops.py` raise when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}          # "lib" -> ctypes.CDLL once built and loaded


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def build() -> Path:
    """Compile (if needed) and return the path of the shared library.
    The compiler's register/shared-memory report (`-Xptxas -v`) is kept
    beside it as `build_<hash>.log`."""
    tag = source_hash()
    so = BUILD_DIR / f"libreprotorch_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, objs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / f"build_{tag}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f".libreprotorch_{tag}.{os.getpid()}.so"
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                        "-o", str(tmp)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)         # atomic publish: concurrent builds race
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
            _loaded["seconds"] = time.perf_counter() - t0
        return lib


def check(lib, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
