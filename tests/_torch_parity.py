"""Shared helpers of the tests/test_torch_*.py parity tests.

The PyTorch port (madsim_tpu_torch) is held bit-exact to the JAX package:
both sides get the same numpy inputs, the JAX side runs on jax's
NON-partitionable threefry stream (the stream the frozen golden digests
were recorded under), and the results are compared with zero tolerance.
"""

from __future__ import annotations

import contextlib
import gc

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def one_cpu_thread():
    """torch on one intra-op thread for a module (restored after it): the
    port's CPU step is a long chain of small ops, faster on one thread,
    and test workers running side by side then do not oversubscribe the
    cores. Use as `pytestmark = pytest.mark.usefixtures("one_cpu_thread")`
    with the fixture imported."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def mapping_count() -> int | None:
    """This process's memory mappings (lines of /proc/self/maps), or None
    where the system has no such file."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return None


def mapping_limit() -> int:
    """The kernel's per-process mapping limit (vm.max_map_count)."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


def release_executables_past() -> bool:
    """Drop every compiled JAX executable that only the caches hold (the
    JAX package's PROGRAM_CACHE and jax's own) once this process maps more
    than half the kernel's mapping limit; True if it did.

    Each XLA CPU executable maps its code in many pieces (a compile of the
    chain reference at C=384 adds ~900 mappings), and a test worker keeps
    every executable its caches hold, so a long run reaches the limit and
    the next compile or persistent-cache read dies in native code with a
    segfault (ROADMAP F28). Dropped executables are compiled again (or
    read from the persistent cache) when next used; no value changes."""
    n = mapping_count()
    if n is None or 2 * n <= mapping_limit():
        return False
    from madsim_tpu.compile.cache import PROGRAM_CACHE
    PROGRAM_CACHE.clear()
    jax.clear_caches()
    gc.collect()
    return True


@contextlib.contextmanager
def reference_stream():
    """Run JAX reference code on the non-partitionable threefry stream,
    with the persistent compilation cache off for the duration: an
    executable deserialized from that cache can return wrong values on
    this jaxlib, a read of it can crash the process (ROADMAP F28), and a
    reference value must never come from one.

    jax decides once a process whether it uses the cache (the first
    compile reads the flag, `compilation_cache.is_cache_used`), so
    turning the flag off is not enough in a test worker that compiled
    before: that decision is reset on entry, and again on exit, after the
    flag is restored, so that later compiles decide afresh. A process
    near its mapping limit first drops its cached executables
    (`release_executables_past`)."""
    from jax._src import compilation_cache
    release_executables_past()
    cache_was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        with jax.threefry_partitionable(False):
            yield
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_was)
        compilation_cache.reset_cache()


def jax_leaves(state) -> dict:
    """{keystr path: owned numpy copy} of a JAX pytree (copies, because
    the runners donate their input buffers)."""
    return {jtu.keystr(p): np.array(x, copy=True)
            for p, x in jtu.tree_flatten_with_path(state)[0]}


def first_difference(ref: dict, got: dict, keys=None):
    """None when every leaf of `ref` (or of `keys`) equals `got`'s in
    shape, dtype and value; else a message naming the first differing
    leaf and lane."""
    for k in (keys if keys is not None else ref):
        if k not in got:
            return f"leaf {k} missing from the port's state"
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        if a.shape != b.shape or a.dtype != b.dtype:
            return (f"leaf {k}: reference {a.shape} {a.dtype}, "
                    f"port {b.shape} {b.dtype}")
        neq = a != b
        if neq.any():
            lanes = np.nonzero(neq.reshape(neq.shape[0], -1).any(1))[0] \
                if a.ndim else np.array([0])
            lane = int(lanes[0])
            return (f"leaf {k} differs in {len(lanes)} lane(s); first lane "
                    f"{lane}: reference {a[lane] if a.ndim else a}, "
                    f"port {b[lane] if b.ndim else b}")
    return None


def assert_same(ref: dict, got: dict, keys=None, what: str = ""):
    msg = first_difference(ref, got, keys)
    assert msg is None, f"{what}: {msg}" if what else msg


def equal_results(a, b, where=""):
    """Deep equality of two readers' results (dicts, lists, numpy arrays,
    scalars), type for type: a report equal to the JAX package's."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), \
            (where, sorted(a), sorted(b))
        for k in a:
            equal_results(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            equal_results(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def jax_state_like(like, leaves: dict):
    """A JAX SimState with `like`'s structure and the given {keystr path:
    numpy} leaves (a port state's `interop.state_to_numpy`)."""
    paths, treedef = jtu.tree_flatten_with_path(like)
    return jtu.tree_unflatten(treedef, [jax.numpy.asarray(
        leaves[jtu.keystr(p)]) for p, _ in paths])
