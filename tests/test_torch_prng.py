"""The port's threefry PRNG against jax's, bit for bit (tolerance: zero).

madsim_tpu_torch.core.prng re-implements jax's non-partitionable threefry
stream in int32 tensors; every draw the engine makes (seed keys, splits,
fold_in, randint, uniform, bernoulli, per-node hash keys) must give the
very bits jax gives for the same keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_stream
from madsim_tpu.core import prng as jprng
from madsim_tpu_torch.core import prng as tprng

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _keys(n=2000, seed=0):
    """n uint32 seeds (with the wrap edges) -> (jax keys, port keys)."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    seeds[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    with reference_stream():
        jk = np.asarray(jax.vmap(jprng.seed_key)(jnp.asarray(seeds)))
    tk = tprng.seed_key(torch.as_tensor(seeds.astype(np.int64)))
    return jk, tk


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_seed_key_matches():
    jk, tk = _keys()
    np.testing.assert_array_equal(_u32(tk), jk)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_split_tree_matches(n):
    """Three levels of splits: every key of the tree equal."""
    jk, tk = _keys(500, seed=n)
    with reference_stream():
        split = jax.jit(jax.vmap(lambda k: jprng.split(k, n)))
        j1 = np.asarray(split(jk))
        j2 = np.asarray(split(j1.reshape(-1, 2)))
        j3 = np.asarray(split(j2.reshape(-1, 2)))
    t1 = tprng.split(tk, n)
    t2 = tprng.split(t1.reshape(-1, 2), n)
    t3 = tprng.split(t2.reshape(-1, 2), n)
    for j, t in ((j1, t1), (j2, t2), (j3, t3)):
        np.testing.assert_array_equal(_u32(t), j)


def test_fold_in_matches():
    jk, tk = _keys(seed=11)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2 ** 32, len(jk), dtype=np.uint64).astype(
        np.uint32)
    data[:3] = [0, 2 ** 31, 2 ** 32 - 1]
    with reference_stream():
        jf = np.asarray(jax.vmap(jax.random.fold_in)(jk, data))
    tf = tprng.fold_in(tk, torch.as_tensor(data.view(np.int32)))
    np.testing.assert_array_equal(_u32(tf), jf)
    # a Python-int datum (the step's constant fold_in domains)
    with reference_stream():
        jc = np.asarray(jax.vmap(
            lambda k: jax.random.fold_in(k, 0x44555031))(jk))
    np.testing.assert_array_equal(_u32(tprng.fold_in(tk, 0x44555031)), jc)


RANGES = [
    (0, 0),                      # span 1
    (-7, -7),                    # span 1, negative
    (-5, 5),
    (-1000, -1),                 # negative lo and hi
    (0, 1),
    (0, 95),
    (0, 2 ** 20),
    (I32_MIN, -1),               # span 2^31
    (0, I32_MAX - 1),            # span 2^31 - 1 ... +1
    (I32_MAX - 1000, I32_MAX),   # hi + 1 wraps to INT32_MIN
    (I32_MIN, I32_MAX),          # the whole range: hi + 1 wraps
    (1, 2 ** 31 - 2),
]


@pytest.mark.parametrize("lo,hi", RANGES)
def test_randint_ranges_match(lo, hi):
    jk, tk = _keys(seed=abs(lo) % 97 + 5)
    with reference_stream():
        jr = np.asarray(jax.vmap(lambda k: jprng.randint(k, lo, hi))(jk))
    tr = tprng.randint(tk, lo, hi).numpy()
    np.testing.assert_array_equal(tr, jr)


def test_randint_per_lane_bounds_match():
    """Per-lane tensor bounds, as the engine draws latencies."""
    jk, tk = _keys(seed=21)
    rng = np.random.default_rng(4)
    lo = rng.integers(I32_MIN, I32_MAX, len(jk)).astype(np.int32)
    hi = np.maximum(lo, (lo.astype(np.int64)
                         + rng.integers(0, 2 ** 31, len(jk))).clip(
                             I32_MIN, I32_MAX).astype(np.int32))
    with reference_stream():
        jr = np.asarray(jax.vmap(jprng.randint)(jk, lo, hi))
    tr = tprng.randint(tk, torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(tr.numpy(), jr)


def test_randint_raw_exclusive_and_vector_shape():
    """jax.random.randint itself: exclusive maxval (the tie-break draw,
    maxval = max(count, 1)) and a vector draw (the torn-write shape)."""
    jk, tk = _keys(seed=8)
    cnt = np.random.default_rng(5).integers(0, 97, len(jk)).astype(np.int32)
    with reference_stream():
        jm = np.asarray(jax.vmap(lambda k, c: jax.random.randint(
            k, (), 0, jnp.maximum(c, 1)))(jk, cnt))
        jv = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (5,), 0, 2 ** 30, dtype=jnp.int32))(jk))
    tm = tprng.randint_raw(tk, 0, torch.clamp(torch.as_tensor(cnt), min=1))
    tv = tprng.randint_raw(tk, 0, 2 ** 30, (5,))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_uniform_matches():
    jk, tk = _keys(seed=13)
    with reference_stream():
        ju = np.asarray(jax.vmap(jprng.uniform)(jk))
    tu = tprng.uniform(tk).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu, ju)


@pytest.mark.parametrize("p", [0.0, 1e-6, 0.05, 0.5, 0.999, 1.0])
def test_bernoulli_matches(p):
    jk, tk = _keys(seed=17)
    p32 = np.float32(p)
    with reference_stream():
        jb = np.asarray(jax.vmap(lambda k: jprng.bernoulli(k, p32))(jk))
    tb = tprng.bernoulli(tk, torch.tensor(p32)).numpy()
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("stream", [0, 3, 2 ** 32 - 1])
def test_node_hash_key_matches(stream):
    jk, tk = _keys(300, seed=19)
    nodes = np.arange(len(jk), dtype=np.int32) % 7 - 1
    with reference_stream():
        jh = np.asarray(jax.vmap(
            lambda k, n: jprng.node_hash_key(k, n, stream))(jk, nodes))
        js = np.asarray(jprng.node_hash_key(12345, 2, stream))
    th = tprng.node_hash_key(tk, torch.as_tensor(nodes), stream)
    np.testing.assert_array_equal(_u32(th), jh)
    np.testing.assert_array_equal(
        _u32(tprng.node_hash_key(12345, 2, stream)), js)


def test_threefry_block_wrap_boundary():
    """The raw block function at the uint32 edges: every add, rotate and
    xor must wrap at 2^32 exactly as uint32 arithmetic does."""
    from jax._src import prng as jax_prng_impl
    edge = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                    np.uint32)
    k0, k1, x0, x1 = (a.ravel() for a in np.meshgrid(edge, edge, edge,
                                                     edge[::-1]))
    j0, j1 = jax_prng_impl.threefry2x32_p.bind(
        jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = tprng.threefry2x32(*(torch.as_tensor(a.view(np.int32))
                                  for a in (k0, k1, x0, x1)))
    np.testing.assert_array_equal(_u32(t0), np.asarray(j0))
    np.testing.assert_array_equal(_u32(t1), np.asarray(j1))
