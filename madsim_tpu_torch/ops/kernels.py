"""Build and load the port's hand-written CUDA kernels.

Each library is one `csrc/<name>.cu` with plain C entry points, compiled
by `nvcc` for Hopper (`sm_90a`) into a shared library and loaded with
ctypes — seconds to build, where an extension that includes PyTorch's
headers takes minutes. Sources include the shared device headers of
`csrc/` (`threefry.cuh`). Libraries go into `madsim_tpu_torch/_build/`
(ignored by git), named by a hash of their source and the headers, so
an edited source or header is rebuilt and an unchanged one is not.
Nothing is built when this module is imported: `load(name)` builds at
first use, `build_all()` starts one `nvcc` per source at once and waits
for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# library name -> source file under csrc/
SOURCES = {
    "sched_pick": "sched_pick.cu",
    "emit_write": "emit_write.cu",
    "mutate": "mutate.cu",
    "apply_knobs": "apply_knobs.cu",
    "coverage_digest": "coverage.cu",
    "raft_invariant": "raft_invariant.cu",
    "apply_super": "apply_super.cu",
    "fingerprint": "fingerprint.cu",
    "prng": "prng.cu",
    "node_rows": "node_rows.cu",
}

# kernel (wrapper) name -> its library, where the two names differ
LIBRARY = {"step_keys": "prng", "dup_draws": "prng",
           "split_randint": "prng", "threefry_keys": "prng",
           "threefry_draw": "prng", "node_gather": "node_rows",
           "put_rows_": "node_rows"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", CSRC]

_LIBS: dict[str, ctypes.CDLL] = {}

# the most dynamic shared memory a block of these kernels asks for: the
# H100's 227 KB a block less 1 KB for the kernels' static shared memory
SMEM_MAX = 231_424


def up16(x: int) -> int:
    """x rounded up to a multiple of 16 (a 16-byte aligned region)."""
    return (x + 15) // 16 * 16


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
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


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


def library(kernel: str) -> str:
    """The library (a key of SOURCES) that holds kernel `kernel`."""
    return LIBRARY.get(kernel, kernel)


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        _LIBS[name] = lib
    return lib


def on_cpu(t, what: str) -> bool:
    """True for a tensor on the CPU (a wrapper's plain version), False
    for CUDA (its kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


class CKernel:
    """One kernel of a csrc library behind ctypes: its C entry point
    `<symbol>_launch(const Params*, stream)` and its launch counts.
    `launches` counts kernel launches (and nothing else); `captured`
    counts launches recorded into a CUDA graph."""

    def __init__(self, lib: str, symbol: str, params):
        self.lib, self.symbol, self.params = lib, symbol, params
        self.launches = 0
        self.captured = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol + "_launch")
            fn.argtypes = [ctypes.POINTER(self.params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, p, dev: torch.device) -> None:
        """Launch on `dev`'s current stream; raise if the launch fails.
        A non-CUDA device reaches here only with a stand-in launcher in
        `_fn` (the CPU tests' host-memory emulation of the kernel)."""
        fn = self._kernel()
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev).cuda_stream
            with torch.cuda.device(dev):
                err = fn(ctypes.byref(p), stream)
        else:
            err = fn(ctypes.byref(p), None)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed "
                               f"(cudaError {err})")
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


def wrappers() -> dict:
    """{kernel name: its wrapper}; each wrapper counts its `launches` and
    the launches it recorded into a CUDA graph (`captured`)."""
    from ..utils.hashing import fingerprint
    from .apply_knobs import apply_knobs
    from .apply_super import apply_super
    from .coverage import coverage_digest
    from .emit_write import emit_write
    from .mutate import mutate_batch
    from .node_rows import node_gather, put_rows_
    from .raft_invariant import raft_invariant_check
    from .sched_pick import sched_pick
    from .threefry import (dup_draws_kernel, split_randint_kernel,
                           step_keys_kernel, threefry_draw, threefry_keys)
    return {"sched_pick": sched_pick, "emit_write": emit_write,
            "mutate": mutate_batch, "apply_knobs": apply_knobs,
            "coverage_digest": coverage_digest,
            "raft_invariant": raft_invariant_check,
            "apply_super": apply_super, "fingerprint": fingerprint,
            "step_keys": step_keys_kernel, "dup_draws": dup_draws_kernel,
            "split_randint": split_randint_kernel,
            "threefry_keys": threefry_keys,
            "threefry_draw": threefry_draw,
            "node_gather": node_gather, "put_rows_": put_rows_}
