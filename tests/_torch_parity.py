"""Shared helpers of the tests/test_torch_*.py parity tests.

The PyTorch port (madsim_tpu_torch) is held bit-exact to the JAX package:
both sides get the same numpy inputs, the JAX side runs on jax's
NON-partitionable threefry stream (the stream the frozen golden digests
were recorded under), and the results are compared with zero tolerance.

A module whose reference runs cost more to compile than the port's runs
take (a model's whole step, ~30 s of XLA for each configuration) keeps
them as REFERENCES, {case: function returning {part: leaves}}, recorded
in tests/data/<module>_golden.npz (`golden`): its tier-1 tests hold the
port to the recording, and a `slow` test of the module recomputes each
case on the JAX package and holds it to the recording
(`assert_golden_is_reference`). Record them again with

    JAX_PLATFORMS=cpu python tests/_torch_golden.py [module ...]
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os

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


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def golden_path(module: str) -> str:
    """The recorded reference leaves of a test module (`__name__`)."""
    return os.path.join(DATA, f"{module}_golden.npz")


def write_golden(path: str, cases: dict):
    """Record {case: {part: {keystr path: numpy}}} (the reference functions'
    results) in one compressed file, every dtype and shape as it is."""
    names, arrays = [], {}
    for case, parts in sorted(cases.items()):
        for part, leaves in sorted(parts.items()):
            for k, v in leaves.items():
                arrays[f"a{len(names)}"] = np.asarray(v)
                names.append(f"{case}\t{part}\t{k}")
    np.savez_compressed(path, names=np.array(names), **arrays)


@functools.lru_cache(maxsize=None)
def _golden_file(path: str) -> dict:
    out = {}
    with np.load(path) as z:
        for i, name in enumerate(z["names"].tolist()):
            case, part, k = name.split("\t", 2)
            out.setdefault(case, {}).setdefault(part, {})[k] = z[f"a{i}"]
    return out


def golden(module: str, case: str) -> dict:
    """{part: {keystr path: numpy}} of one case as `write_golden` recorded
    it (fresh copies: the port's runners may take them over)."""
    rec = _golden_file(golden_path(module))[case]
    return {part: {k: v.copy() for k, v in leaves.items()}
            for part, leaves in rec.items()}


def assert_golden_is_reference(module: str, case: str, fresh: dict):
    """The JAX package's output `fresh` ({part: leaves}) equals what the
    module's golden file holds for the case, part for part, leaf for
    leaf, with no leaf missing on either side."""
    rec = golden(module, case)
    assert sorted(rec) == sorted(fresh), (case, sorted(rec), sorted(fresh))
    for part in fresh:
        assert sorted(rec[part]) == sorted(fresh[part]), (case, part)
        assert_same(fresh[part], rec[part], what=f"{case} {part}")


def jax_state_like(like, leaves: dict):
    """A JAX SimState with `like`'s structure and the given {keystr path:
    numpy} leaves (a port state's `interop.state_to_numpy`)."""
    paths, treedef = jtu.tree_flatten_with_path(like)
    return jtu.tree_unflatten(treedef, [jax.numpy.asarray(
        leaves[jtu.keystr(p)]) for p, _ in paths])


# --------------------------------------------------------------------------
# durable campaign stores (service/store.py) as recordable parts
# --------------------------------------------------------------------------
# the wall-clock fields of a store: a state's `wall_s`, a metrics row's `t`
# and `wall_s`, a bucket's `created_at` / `upgraded_at`. `freeze_clock`
# rewrites them from the campaign's own counters, so two runs' stores can
# be held to each other byte for byte, and a recording to a fresh run.
WALL_CLOCK_FIELDS = ("state wall_s", "metrics t", "metrics wall_s",
                     "bucket created_at", "bucket upgraded_at")


def _rewrite_json(path, obj):
    with open(path, "w") as f:
        f.write(json.dumps(obj, indent=1) + "\n")


def freeze_clock(corpus_dir: str) -> None:
    """Replace the store's wall-clock fields (WALL_CLOCK_FIELDS) by values
    made from its round counters, in the writer's own JSON layout."""
    sdir = os.path.join(corpus_dir, "state")
    for n in sorted(os.listdir(sdir)) if os.path.isdir(sdir) else ():
        p = os.path.join(sdir, n)
        with open(p) as f:
            st = json.load(f)
        st["wall_s"] = float(st.get("rounds_done", 0))
        _rewrite_json(p, st)
    mdir = os.path.join(corpus_dir, "metrics")
    for n in sorted(os.listdir(mdir)) if os.path.isdir(mdir) else ():
        p = os.path.join(mdir, n)
        with open(p) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        for r in rows:
            r["t"] = 1e9 + 10.0 * r["rounds_done"]
            r["wall_s"] = float(r["rounds_done"])
        with open(p, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    bdir = os.path.join(corpus_dir, "buckets")
    for n in sorted(os.listdir(bdir)) if os.path.isdir(bdir) else ():
        if not n.endswith(".json") or n.endswith(".trace.json"):
            continue
        p = os.path.join(bdir, n)
        with open(p) as f:
            rec = json.load(f)
        t = 1e9 + 10.0 * rec["repro"]["round"]
        for k in ("created_at", "upgraded_at"):
            if k in rec:
                rec[k] = t
        _rewrite_json(p, rec)


def store_tree(corpus_dir: str, skip=()) -> dict:
    """{path relative to the dir: uint8 bytes} of every file under it
    (a recordable part), less the top-level subdirs named in `skip`."""
    out = {}
    for root, dirs, files in os.walk(corpus_dir):
        rel = os.path.relpath(root, corpus_dir)
        if rel.split(os.sep)[0] in skip:
            continue
        for n in files:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, corpus_dir)] = np.frombuffer(
                    f.read(), np.uint8).copy()
    return out


def write_tree(corpus_dir: str, tree: dict) -> str:
    """Materialize a `store_tree` part under `corpus_dir` (over what is
    there)."""
    for rel, data in tree.items():
        p = os.path.join(corpus_dir, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(np.asarray(data, np.uint8).tobytes())
    return corpus_dir


def assert_same_tree(ref: dict, got: dict, what: str = ""):
    """Two `store_tree` parts hold the same files with the same bytes."""
    assert sorted(ref) == sorted(got), (what, sorted(set(ref) ^ set(got)))
    for rel in ref:
        a, b = bytes(ref[rel]), bytes(got[rel])
        assert a == b, f"{what} {rel}: {a[:400]!r} != {b[:400]!r}"


def _plain(x):
    """JSON-able form of a reader's result: numpy values as [dtype,
    values], dict keys as strings."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ["ndarray", str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return [type(x).__name__, x.item()]
    return x


def json_part(obj) -> dict:
    """A recordable part holding one result as canonical JSON bytes."""
    return {"json": np.frombuffer(json.dumps(_plain(obj), sort_keys=True)
                                  .encode(), np.uint8).copy()}


def part_json(part: dict):
    return json.loads(bytes(part["json"]).decode())
