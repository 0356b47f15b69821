"""Native host-side components: the linearizability checker and the
single-seed native baseline (the counterpart of `madsim_tpu.native`).

The card runs the vectorized simulation; history *checking* is sequential
search on the host, so it is C++ (`native/linearize.cpp`), compiled with
the machine's g++ at first use into `madsim_tpu_torch/_build/` (named by
a hash of its source, so an edited source is rebuilt) and bound with
ctypes. `native/simloop.cpp` is the single-seed discrete-event twin of
the flagship workload, the baseline denominator. Both sources are this
package's own copies.

A failed build raises: there is no silent fallback. `_check_register_py`
is the pure-Python mirror of the C++ search; it decides a key's history
above MAX_NATIVE_OPS operations (the C++ memo key's limit, as in the
reference), and `force_python=True` selects it for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
SOURCES = {"linearize": "linearize.cpp", "simloop": "simloop.cpp"}

# linearize.cpp packs the remaining-op set into a 64-bit memo key beside a
# 7-bit value index: it takes at most 57 operations (and returns -1 above)
MAX_NATIVE_OPS = 57

_LIBS: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> str:
    """Where library `name` is built: `_build/lib<name>-<source hash>.so`."""
    with open(os.path.join(SRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile library `name` with CXX unless it is built; returns its
    path. Raises RuntimeError when the compiler is missing or fails."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, "-O3", "-shared", "-fPIC", "-o", tmp,
           os.path.join(SRC_DIR, SOURCES[name])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native: cannot run {CXX} for {name}: {e}") \
            from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native: {CXX} failed for {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build(name))
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    if name == "linearize":
        lib.lin_check_register.restype = ctypes.c_int
        lib.lin_check_register.argtypes = [ctypes.c_int, i32, i32, i64, i64]
    else:
        lib.simloop_run.restype = None
        lib.simloop_run.argtypes = [ctypes.c_uint64, ctypes.c_int64, i64]
    _LIBS[name] = lib
    return lib


def native_baseline_run(seed: int, max_events: int) -> dict:
    """Run the native single-seed flagship workload for `max_events`
    events; returns {events, wall_s, events_per_sec, max_commit,
    elections}."""
    out = np.zeros(4, np.int64)
    _load("simloop").simloop_run(seed, max_events, out)
    ev, ns = int(out[0]), max(int(out[1]), 1)
    return dict(events=ev, wall_s=ns / 1e9,
                events_per_sec=ev / (ns / 1e9),
                max_commit=int(out[2]), elections=int(out[3]))


def _check_register_py(op, val, inv, resp) -> bool:
    """Pure-Python mirror of native/linearize.cpp (same algorithm)."""
    n = len(op)
    if n == 0:
        return True
    seen = set()

    def dfs(mask, value):
        if mask == 0:
            return True
        key = (mask, value)
        if key in seen:
            return False
        seen.add(key)
        minresp = min((resp[i] for i in range(n)
                       if (mask >> i) & 1 and resp[i] >= 0),
                      default=None)
        for i in range(n):
            if not (mask >> i) & 1:
                continue
            if minresp is not None and inv[i] > minresp:
                continue
            rest = mask & ~(1 << i)
            if op[i] == 1:
                if dfs(rest, val[i]):
                    return True
            else:
                if val[i] == value and dfs(rest, value):
                    return True
            if resp[i] < 0 and dfs(rest, value):
                return True
        return False

    return dfs((1 << n) - 1, 0)


def check_register(op, val, inv, resp, force_python=False) -> bool:
    """Is this single-register history linearizable (initial value 0)?

    op: 1=PUT, 2=GET; val: written/observed value; inv/resp: times,
    resp < 0 marks a pending op (may or may not have taken effect).
    Up to MAX_NATIVE_OPS operations the C++ search decides, above it the
    Python mirror (or always, with `force_python`).
    """
    op = np.ascontiguousarray(op, np.int32)
    val = np.ascontiguousarray(val, np.int32)
    inv = np.ascontiguousarray(inv, np.int64)
    resp = np.ascontiguousarray(resp, np.int64)
    if not force_python and len(op) <= MAX_NATIVE_OPS:
        return bool(_load("linearize").lin_check_register(
            len(op), op, val, inv, resp))
    return _check_register_py(op.tolist(), val.tolist(), inv.tolist(),
                              resp.tolist())


def check_kv_history(hist: dict, force_python=False) -> bool:
    """Linearizability of a multi-key KV history: registers compose, so
    each key's sub-history is checked independently (P-compositionality).

    hist: dict of numpy arrays op/key/val/inv/resp (see
    models/raft_kv.extract_histories).
    """
    for k in np.unique(hist["key"]):
        m = hist["key"] == k
        if not check_register(hist["op"][m], hist["val"][m], hist["inv"][m],
                              hist["resp"][m], force_python=force_python):
            return False
    return True
