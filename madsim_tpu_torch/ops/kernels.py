"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C entry point, compiled
by `nvcc` for Hopper (`sm_90a`) into a shared library and loaded with
ctypes — seconds to build, where an extension that includes PyTorch's
headers takes minutes. Libraries go into `madsim_tpu_torch/_build/`
(ignored by git), named by a hash of their source, so an edited source
is rebuilt and an unchanged one is not. Nothing is built when this module
is imported: `load(name)` builds at first use, `build_all()` starts one
`nvcc` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source file under csrc/
SOURCES = {
    "sched_pick": "sched_pick.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME)")


def lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, force: bool):
    """Start nvcc for one kernel into a temporary file; returns
    (process, temporary path, final path), or None when already built."""
    out = lib_path(name)
    if os.path.exists(out) and not force:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=None, force: bool = False) -> dict:
    """Compile every kernel (or `names`) in parallel; `force` rebuilds
    libraries that already exist. Returns {name: {"seconds": s, "log":
    nvcc output}}; raises on a failed build."""
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    started = {n: _start(n, force) for n in names}
    report, failed = {}, []
    for n, job in started.items():
        if job is None:
            report[n] = {"seconds": 0.0, "log": "(cached)"}
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        _LIBS[name] = lib
    return lib
