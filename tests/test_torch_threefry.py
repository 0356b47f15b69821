"""K1 on the CPU: the threefry wrappers of madsim_tpu_torch/ops/threefry.py
against the JAX package's draws, and the kernels' launch logic against a
stand-in launcher (tolerance: zero).

On CPU tensors the wrappers are `core/prng.py`'s plain functions; they
are held here to jax's `split`, `fold_in`, `randint`, `uniform`,
`bernoulli` and `node_hash_key` across the broadcast shapes the step and
`Ctx` draw with, on the non-partitionable stream (`reference_stream`).

The CUDA kernels (csrc/prng.cu) run only on the card, where chip_smoke.py
holds them exactly equal to the plain version. What surrounds them — the
broadcasting of keys, words, bounds and p to the output batch as strided
[M, W] views, the parameter block, the reshape of the result — runs here:
each case goes through the kernel's path with a stand-in launcher that
reads the operands from host memory through the parameter block's
pointers and strides, as the kernel does, and draws each element with the
plain function.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import reference_stream
from madsim_tpu.core import prng as jprng
from madsim_tpu_torch.core import prng
from madsim_tpu_torch.ops import threefry as tf

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
B = 257


def _keys(n=B, seed=0, shape=None):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    k[:2] = [[0, 0], [2 ** 32 - 1, 2 ** 32 - 1]][:n]  # the edge keys
    if shape is not None:
        k = k.reshape(shape + (2,))
    return k, torch.as_tensor(k.view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


# --------------------------------------------------------------------------
# The wrappers against jax, in the shapes the step and Ctx draw with
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_split_matches_jax(n):
    """[B, 2] keys and a strided key slice (the step's keys[:, 3])."""
    jk, tk = _keys(seed=n)
    with reference_stream():
        want = np.asarray(jax.vmap(lambda k: jprng.split(k, n))(jk))
    np.testing.assert_array_equal(_u32(tf.split(tk, n)), want)
    five = tf.split(tk, 5)
    with reference_stream():
        jfive = np.asarray(jax.vmap(lambda k: jprng.split(k, 5))(jk))
        want = np.asarray(jax.vmap(lambda k: jprng.split(k, n))(jfive[:, 3]))
    np.testing.assert_array_equal(_u32(tf.split(five[:, 3], n)), want)


def test_fold_in_matches_jax_in_the_step_and_hash_shapes():
    """A constant word, the dup section's [B, 1, 2] keys against two
    words, and a per-key word (node_hash_key's node)."""
    jk, tk = _keys(seed=3)
    words = np.array([0x44555031, 0x44555032], np.uint32)
    per_key = np.arange(B, dtype=np.uint32) * np.uint32(2654435761)
    with reference_stream():
        one = np.asarray(jax.vmap(lambda k: jax.random.fold_in(
            k, 0x44555031))(jk))
        two = np.asarray(jax.vmap(lambda k: jax.vmap(
            lambda w: jax.random.fold_in(k, w))(words))(jk))
        each = np.asarray(jax.vmap(jax.random.fold_in)(jk, per_key))
    np.testing.assert_array_equal(_u32(tf.fold_in(tk, 0x44555031)), one)
    got = tf.fold_in(tk[:, None, :], torch.as_tensor(words.view(np.int32)))
    assert got.shape == (B, 2, 2)
    np.testing.assert_array_equal(_u32(got), two)
    np.testing.assert_array_equal(
        _u32(tf.fold_in(tk, torch.as_tensor(per_key.view(np.int32)))), each)


@pytest.mark.parametrize("lo,hi", [(0, 0), (-7, -7), (0, 95), (5, 4),
                                   (I32_MIN, I32_MAX),
                                   (I32_MAX - 1000, I32_MAX),
                                   (I32_MIN, -1)])
def test_randint_with_constant_bounds_matches_jax(lo, hi):
    """`Ctx.randint`'s constant inclusive bounds (hi < lo included: jax
    draws lo there; hi = INT32_MAX wraps hi + 1)."""
    jk, tk = _keys(seed=abs(lo) % 89 + 1)
    with reference_stream():
        want = np.asarray(jax.vmap(lambda k: jprng.randint(k, lo, hi))(jk))
    np.testing.assert_array_equal(tf.randint(tk, lo, hi).numpy(), want)


def test_randint_with_per_key_bounds_matches_jax():
    """The dup section's latency draw: per-lane tensor bounds, also on a
    strided key slice."""
    jk, tk = _keys(seed=9)
    rng = np.random.default_rng(9)
    lo = rng.integers(I32_MIN, I32_MAX, B).astype(np.int32)
    hi = rng.integers(I32_MIN, I32_MAX, B).astype(np.int32)
    hi[:20] = I32_MAX
    pair = tf.fold_in(tk[:, None, :], torch.tensor([1, 2], dtype=torch.int32))
    with reference_stream():
        jpair = np.asarray(jax.vmap(lambda k: jax.vmap(
            lambda w: jax.random.fold_in(k, w))(jnp.arange(1, 3, dtype=
                                                  jnp.uint32)))(jk))
        want = np.asarray(jax.vmap(jprng.randint)(jpair[:, 1], lo, hi))
    got = tf.randint(pair[:, 1], torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_raw_matches_jax_in_every_shape():
    """Exclusive bounds: maxval <= minval (minval is drawn), the whole
    int32 range, a per-key bound, and a vector draw (the torn flush)."""
    jk, tk = _keys(seed=11)
    cnt = np.random.default_rng(2).integers(-3, 97, B).astype(np.int32)
    with reference_stream():
        eq = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (), 7, 7))(jk))
        below = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (), 9, -4))(jk))
        whole = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (), I32_MIN, I32_MAX, dtype=jnp.int32))(jk))
        per = np.asarray(jax.vmap(lambda k, c: jax.random.randint(
            k, (), 0, c))(jk, cnt))
        vec = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (5,), 0, 2 ** 30, dtype=jnp.int32))(jk))
    np.testing.assert_array_equal(tf.randint_raw(tk, 7, 7).numpy(), eq)
    np.testing.assert_array_equal(tf.randint_raw(tk, 9, -4).numpy(), below)
    np.testing.assert_array_equal(
        tf.randint_raw(tk, I32_MIN, I32_MAX).numpy(), whole)
    np.testing.assert_array_equal(
        tf.randint_raw(tk, 0, torch.as_tensor(cnt)).numpy(), per)
    np.testing.assert_array_equal(
        tf.randint_raw(tk, 0, 2 ** 30, (5,)).numpy(), vec)


def test_uniform_and_bernoulli_match_jax():
    """uniform; bernoulli with p 0, 1, subnormal, a Python float and a
    per-key float32 p (the dup section's dup_rate * 1e-6)."""
    jk, tk = _keys(seed=13)
    sub = np.float32(1e-40)
    per = np.random.default_rng(1).random(B).astype(np.float32)
    per[:3] = [0.0, 1.0, sub]
    with reference_stream():
        ju = np.asarray(jax.vmap(jprng.uniform)(jk))
        jb = {p: np.asarray(jax.vmap(lambda k: jprng.bernoulli(
            k, np.float32(p)))(jk)) for p in (0.0, 1.0, sub, 0.05)}
        jper = np.asarray(jax.vmap(jprng.bernoulli)(jk, per))
    tu = tf.uniform(tk)
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), ju)
    for p, want in jb.items():
        np.testing.assert_array_equal(tf.bernoulli(tk, float(p)).numpy(),
                                      want)
    np.testing.assert_array_equal(
        tf.bernoulli(tk, torch.as_tensor(per)).numpy(), jper)


def test_node_hash_key_matches_jax():
    jk, tk = _keys(seed=19)
    nodes = (np.arange(B, dtype=np.int32) % 7) - 1
    with reference_stream():
        want = np.asarray(jax.vmap(lambda k, n: jprng.node_hash_key(
            k, n, 3))(jk, nodes))
    np.testing.assert_array_equal(
        _u32(tf.node_hash_key(tk, torch.as_tensor(nodes), 3)), want)


DUP_WORDS = (0x44555031, 0x44555032)


def _jax_step_keys(key, halted, n_ext, n_write, words=DUP_WORDS):
    """The JAX step's own keys for one lane, as madsim_tpu/core/step.py
    composes them: :138 the 5-way split and the halted lane's key kept,
    :246 and :315 the dup fold_ins of k_sched, :338 the extension split
    of k_super."""
    key_next, k_sched, k_super, k_handler, k_net = jprng.split(key, 5)
    key_next = jnp.where(~halted, key_next, key)
    ext = jprng.split(k_super, n_ext)
    return ([key_next, k_sched, k_handler, k_net,
             jax.random.fold_in(k_sched, words[0]),
             jax.random.fold_in(k_sched, words[1])]
            + [ext[i] for i in range(n_write)])


@pytest.mark.parametrize("n_ext,n_write", [(2, 1), (2, 2), (3, 3), (5, 5),
                                           (9, 1), (9, 9)])
def test_step_keys_plain_is_the_jax_steps_composition(n_ext, n_write):
    """[the next key, k_sched, k_handler, k_net, the two dup keys, the
    first n_write extension keys], halted lanes keeping their key; each a
    contiguous [B, 2] tensor."""
    jk, tk = _keys(seed=40 + n_ext)
    halted = np.random.default_rng(n_ext).random(B) < 0.3
    halted[:3] = [True, False, True]
    with reference_stream():
        want = jax.vmap(lambda k, h: _jax_step_keys(k, h, n_ext, n_write))(
            jk, halted)
    got = tf.step_keys(tk, torch.as_tensor(halted), DUP_WORDS, n_ext,
                       n_write)
    assert len(got) == tf.STEP_KEYS + n_write == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, 2) and g.is_contiguous(), i
        np.testing.assert_array_equal(_u32(g), np.asarray(w), err_msg=i)
    np.testing.assert_array_equal(_u32(got[0])[halted], jk[halted])


def test_step_keys_matches_the_steps_former_composition():
    """The fused keys equal the launches they replace in the port's step
    (`split(key, 5)`, `fold_in(k_sched[:, None], words)`,
    `split(k_super, n_ext)`), dup words at the extremes."""
    _, tk = _keys(seed=44)
    halted = torch.as_tensor(np.arange(B) % 3 == 0)
    words = (0, 2 ** 32 - 1)
    keys = tf.split(tk, 5)
    dup = tf.fold_in(keys[:, 1][:, None, :],
                     torch.tensor([0, -1], dtype=torch.int32))
    ext = tf.split(keys[:, 2], 4)
    want = [torch.where(halted[:, None], tk, keys[:, 0]), keys[:, 1],
            keys[:, 3], keys[:, 4], dup[:, 0], dup[:, 1],
            *ext.unbind(1)]
    got = tf.step_keys(tk, halted, words, 4, 4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


def _jax_dup(k_sched, valid, kind, node, rate, now, dmin, lo, hi, tlimit):
    """The JAX step's dup composition for one lane (madsim_tpu/core/
    step.py:244-317): (now, time_over, dup_fire, the popped row's
    deadline, its free mask)."""
    from madsim_tpu.core import types as JT
    from madsim_tpu.ops import select as jsel
    dup_p = (jsel.take1(rate, node).astype(jnp.float32)
             * jnp.float32(1e-6))
    k_dupf = jax.random.fold_in(k_sched, chip_smoke.DUP_WORDS[0])
    fire = valid & (kind == JT.EV_MSG) & jprng.bernoulli(k_dupf, dup_p)
    now = jnp.where(valid, jnp.maximum(now, dmin), now)
    time_over = now > tlimit
    k_dupd = jax.random.fold_in(k_sched, chip_smoke.DUP_WORDS[1])
    redeliver = now + jnp.maximum(jprng.randint(k_dupd, lo, hi), 1)
    deadline = jnp.where(fire, redeliver, jnp.asarray(JT.T_INF, jnp.int32))
    return now, time_over, fire, deadline, valid & ~fire


def _dup_operands(case, n=B):
    """chip_smoke's dup operands for `case`: (numpy arrays for the JAX
    side, the port's dup_draws operands on the CPU)."""
    ops = chip_smoke.dup_edge_operands(case, n)
    return ops, chip_smoke.dup_draws_args(ops, "cpu")


@pytest.mark.parametrize("case", chip_smoke.DUP_CASES)
def test_dup_draws_plain_is_the_jax_steps_dup_composition(case):
    """`dup_draws_plain` (the dup_draws kernel's plain version, what the
    step's dup section takes on the CPU) against the JAX step's
    composition: rates 0 and at the 900000 cap, lat_lo == lat_hi and
    lat_hi < lat_lo, invalid lanes, non-message kinds, now past tlimit."""
    ops, args = _dup_operands(case)
    with reference_stream():
        want = jax.vmap(_jax_dup)(*ops)
    got = tf.dup_draws(*args)
    names = ("now", "time_over", "dup_fire", "deadline", "free")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    fire = got[2].numpy()
    if case in ("rate_zero", "invalid_lanes", "non_message_kinds",
                "mixed", "rate_cap"):
        # the operands reach what the case names
        assert fire.any() != (case == "rate_zero")
    if case == "past_time_limit":     # strict >: a tie is not late
        assert 0.5 < float(got[1].float().mean()) < 1


def test_wrappers_take_the_plain_version_on_the_cpu_and_refuse_meta():
    _, tk = _keys(seed=23)
    before = (tf.threefry_keys.launches, tf.threefry_draw.launches)
    assert torch.equal(tf.split(tk, 3), prng.split(tk, 3))
    assert torch.equal(tf.randint(tk, 0, 9), prng.randint(tk, 0, 9))
    assert (tf.threefry_keys.launches, tf.threefry_draw.launches) == before
    meta = tk.to("meta")
    for call in (lambda: tf.split(meta, 2), lambda: tf.fold_in(meta, 1),
                 lambda: tf.randint(meta, 0, 3), lambda: tf.uniform(meta),
                 lambda: tf.bernoulli(meta, 0.5),
                 lambda: tf.randint_raw(meta, 0, 3)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# --------------------------------------------------------------------------
# The kernels' launch logic, with a stand-in launcher on host memory
# --------------------------------------------------------------------------
def _grid(op, M, W, dtype, pair=False):
    """An operand of the parameter block read from host memory: element
    (m, w) at ptr + m * sm + w * sw, as the kernel reads it."""
    size = np.dtype(dtype).itemsize
    tail = 2 if pair else 1
    span = (M - 1) * op.sm + (W - 1) * op.sw + tail
    raw = np.frombuffer((ctypes.c_char * (span * size)).from_address(
        op.ptr), dtype=dtype, count=span)
    shape, strides = (M, W), (op.sm * size, op.sw * size)
    if pair:
        shape, strides = shape + (2,), strides + (size,)
    return torch.as_tensor(np.lib.stride_tricks.as_strided(
        raw, shape, strides).copy())


def _store(ptr, t):
    data = t.contiguous().numpy().tobytes()
    ctypes.memmove(ptr, data, len(data))


def _blocks(k0, k1, n):
    """The n blocks of split((k0, k1), n) as the kernels unroll them:
    block j hashes (j, j + n); returns (x0, x1), each [..., n]."""
    j = torch.arange(n, dtype=torch.int32)
    return prng.threefry2x32(k0[..., None], k1[..., None], j, j + n)


def _split_out(x0, x1, n, i):
    """csrc/prng.cu `split_out`: key i of split(key, n) from its blocks,
    word w being x0[w] for w < n, else x1[w - n]."""
    def word(w):
        return x0[..., w] if w < n else x1[..., w - n]
    return torch.stack([word(2 * i), word(2 * i + 1)], -1)


def _keys_standin(ref, stream):
    """csrc/prng.cu `threefry_keys` on host memory, as its kernels compute
    and store: a split of n <= 8 unrolled block by block, its keys in
    output order; a wider one word by word (block j's first word at j,
    its second at j + n); a fold_in one block (0, word) a key. Refuses
    (cudaErrorInvalidValue) what the launcher refuses."""
    p = ref._obj
    if p.M < 0 or p.W < 0 or p.n < 0 or not p.key.ptr or not p.out:
        return 1
    if 2 * p.M * p.W * max(p.n, 1) >= 2 ** 31:
        return 1
    key = _grid(p.key, p.M, p.W, np.int32, pair=True)
    k0, k1 = key[..., 0], key[..., 1]
    if p.n == 0:
        data = (_grid(p.data, p.M, p.W, np.int32) if p.data.ptr
                else torch.full((p.M, p.W), p.word, dtype=torch.int32))
        x0, x1 = prng.threefry2x32(k0, k1, torch.zeros_like(data), data)
        _store(p.out, torch.stack([x0, x1], -1))
    elif p.n <= 8:
        x0, x1 = _blocks(k0, k1, p.n)
        _store(p.out, torch.stack([_split_out(x0, x1, p.n, i)
                                   for i in range(p.n)], -2))
    else:
        x0, x1 = _blocks(k0, k1, p.n)
        _store(p.out, torch.cat([x0, x1], -1))
    return 0


def _step_keys_standin(ref, stream):
    """csrc/prng.cu `step_keys` on host memory, as its kernel computes:
    split(key, 5)'s five blocks, the next key (the lane's own where it
    has halted), k_sched, k_handler, k_net, the two dup fold_ins of
    k_sched, and n_write keys of split(k_super, n_ext) into
    [6 + n_write, B, 2]. Refuses what the launcher refuses."""
    p = ref._obj
    if p.B < 0 or not 1 <= p.n_write <= p.n_ext or not p.key \
            or not p.halted or not p.out or p.key % 8 or p.out % 8:
        return 1
    if p.B == 0:
        return 0
    op = tf._Operand(p.key, 2, 0)
    key = _grid(op, p.B, 1, np.int32, pair=True)[:, 0]
    halted = torch.as_tensor(np.frombuffer(
        (ctypes.c_char * p.B).from_address(p.halted), np.uint8) != 0)
    x0, x1 = _blocks(key[:, 0], key[:, 1], 5)
    sched, ksuper = _split_out(x0, x1, 5, 1), _split_out(x0, x1, 5, 2)
    out = [torch.where(halted[:, None], key, _split_out(x0, x1, 5, 0)),
           sched, _split_out(x0, x1, 5, 3), _split_out(x0, x1, 5, 4)]
    for word in (p.dup_word0, p.dup_word1):
        d0, d1 = prng.threefry2x32(sched[:, 0], sched[:, 1],
                                   torch.zeros_like(sched[:, 0]),
                                   torch.full_like(sched[:, 0], word))
        out.append(torch.stack([d0, d1], -1))
    y0, y1 = _blocks(ksuper[:, 0], ksuper[:, 1], p.n_ext)
    out += [_split_out(y0, y1, p.n_ext, i) for i in range(p.n_write)]
    _store(p.out, torch.stack(out))
    return 0


def _draw_standin(ref, stream):
    """csrc/prng.cu `threefry_draw`, element by element from the plain
    functions."""
    p = ref._obj
    key = _grid(p.key, p.M, p.W, np.int32, pair=True)
    if p.mode == tf.MODE_RANDINT:
        lo, hi = ((_grid(o, p.M, p.W, np.int32) if o.ptr
                   else torch.full((p.M, p.W), v, dtype=torch.int32))
                  for o, v in ((p.lo, p.lo_val), (p.hi, p.hi_val)))
        if p.inclusive:
            hi = hi + 1
        out = prng.randint_raw(key, lo, hi, (p.F,))
    elif p.mode == tf.MODE_UNIFORM:
        out = prng.uniform(key)
    else:
        prob = (_grid(p.lo, p.M, p.W, np.float32) if p.lo.ptr
                else torch.tensor(p.p_val, dtype=torch.float32))
        out = prng.bernoulli(key, prob)
    _store(p.out, out)
    return 0


def _lane_vec(ptr, n, dtype=np.int32):
    size = np.dtype(dtype).itemsize
    return torch.as_tensor(np.frombuffer(
        (ctypes.c_char * (n * size)).from_address(ptr), dtype=dtype,
        count=n).copy())


def _dup_standin(ref, stream):
    """csrc/prng.cu `dup_draws` on host memory, as its kernel computes a
    lane: the clock and time_over; the Bernoulli drawn only where the
    lane may fire (valid, a message, p = float32(rate) * 1e-6 > 0), the
    latency only where it fired. Refuses what the launcher refuses."""
    p = ref._obj
    if p.B < 0 or p.N < 1 or not p.k_dupf or not p.k_dupd \
            or p.k_dupf % 8 or p.k_dupd % 8:
        return 1
    B, N = p.B, p.N
    keys = [_grid(tf._Operand(ptr, 2, 0), B, 1, np.int32, pair=True)[:, 0]
            for ptr in (p.k_dupf, p.k_dupd)]
    valid = _lane_vec(p.valid, B, np.bool_)
    kind, node = _lane_vec(p.ev_kind, B), _lane_vec(p.ev_node, B)
    now0, dmin = _lane_vec(p.now, B), _lane_vec(p.dmin, B)
    lo, hi = _lane_vec(p.lat_lo, B), _lane_vec(p.lat_hi, B)
    tlimit = _lane_vec(p.tlimit, B)
    rate = _lane_vec(p.dup_rate, B * N).reshape(B, N)
    now = torch.where(valid, torch.maximum(now0, dmin), now0)
    r = rate[torch.arange(B), node.clamp(0, N - 1).long()]
    prob = torch.as_tensor(r.numpy().astype(np.float32) * np.float32(1e-6))
    may = valid & (kind == 1) & (prob > 0)
    fire = torch.zeros(B, dtype=torch.bool)
    fire[may] = prng.bernoulli(keys[0][may], prob[may])
    deadline = torch.full((B,), 2 ** 31 - 1, dtype=torch.int32)
    lat = prng.randint(keys[1][fire], lo[fire], hi[fire])
    deadline[fire] = now[fire] + torch.clamp(lat, min=1)
    for ptr, t in ((p.now_out, now), (p.time_over, now > tlimit),
                   (p.dup_fire, fire), (p.deadline, deadline),
                   (p.free_row, valid & ~fire)):
        _store(ptr, t)
    return 0


def _split_randint_standin(ref, stream):
    """csrc/prng.cu `split_randint` on host memory: split(key, 2)'s two
    blocks unrolled, the next key and the drawn key stored [2, M * W, 2],
    and randint(drawn key, lo, hi) inclusive. Refuses what the launcher
    refuses."""
    p = ref._obj
    if p.M < 0 or p.W < 0 or not p.key.ptr or not p.out or not p.value \
            or p.out % 8 or 4 * p.M * p.W >= 2 ** 31:
        return 1
    key = _grid(p.key, p.M, p.W, np.int32, pair=True).reshape(-1, 2)
    x0, x1 = _blocks(key[:, 0], key[:, 1], 2)
    nxt, drawn = _split_out(x0, x1, 2, 0), _split_out(x0, x1, 2, 1)
    _store(p.out, torch.stack([nxt, drawn]))
    _store(p.value, prng.randint(drawn, p.lo, p.hi))
    return 0


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(tf.step_keys_kernel, "_fn", _step_keys_standin)
    monkeypatch.setattr(tf.threefry_keys, "_fn", _keys_standin)
    monkeypatch.setattr(tf.threefry_draw, "_fn", _draw_standin)
    monkeypatch.setattr(tf.dup_draws_kernel, "_fn", _dup_standin)
    monkeypatch.setattr(tf.split_randint_kernel, "_fn",
                        _split_randint_standin)


def _batch_keys(shape, seed):
    return _keys(int(np.prod(shape)), seed, shape)[1]


SPLIT_CASES = {
    "lanes": lambda: _batch_keys((B,), 1),
    "strided_slice": lambda: prng.split(_batch_keys((B,), 2), 5)[:, 3],
    "one_key": lambda: _batch_keys((1,), 3)[0],
    "grid_3d": lambda: _batch_keys((3, 4, 5), 4),
    "transposed": lambda: _batch_keys((6, 7), 5).transpose(0, 1),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("n", [1, 2, 5, 8, 16])
def test_split_through_the_kernel_path(standin, case, n):
    key = SPLIT_CASES[case]()
    before = tf.threefry_keys.launches
    got = tf.threefry_keys.split(key, n)
    assert tf.threefry_keys.launches == before + 1
    assert torch.equal(got, prng.split(key, n))


FOLD_CASES = {
    "constant_word": lambda: (_batch_keys((B,), 6), 0x44555031),
    "top_bit_word": lambda: (_batch_keys((B,), 6), 2 ** 32 - 1),
    "dup_two_words": lambda: (_batch_keys((B,), 7)[:, None, :],
                              torch.tensor([0x44555031, 0x44555032],
                                           dtype=torch.int32)),
    "per_key_word": lambda: (_batch_keys((B,), 8),
                             torch.arange(B, dtype=torch.int32) - 3),
    "one_key_many_words": lambda: (_batch_keys((1,), 9)[0],
                                   torch.arange(B, dtype=torch.int32)),
    "int64_words": lambda: (_batch_keys((B,), 10),
                            torch.arange(B, dtype=torch.int64) % 7),
    "unmergeable_broadcast": lambda: (
        _batch_keys((3, 1, 5), 11),
        torch.arange(3 * 4 * 5, dtype=torch.int32).reshape(3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_in_through_the_kernel_path(standin, case):
    key, data = FOLD_CASES[case]()
    got = tf.threefry_keys.fold_in(key, data)
    want = prng.fold_in(key, data.to(torch.int32)
                        if isinstance(data, torch.Tensor) else data)
    assert torch.equal(got, want)


def _step_key_operands(lanes, layout, seed):
    """[lanes, 2] keys laid out as `layout` says: contiguous, a strided
    slice of a split, or one int32 off an 8-byte boundary."""
    k = _batch_keys((lanes,), seed)
    if layout == "strided":
        return prng.split(k, 5)[:, 3]
    if layout == "one_word_in":
        flat = torch.zeros(2 * lanes + 1, dtype=torch.int32)
        flat[1:] = k.flatten()
        return flat[1:].view(lanes, 2)
    return k


STEP_KEY_CASES = {
    # case: (lanes, key layout, halted, n_ext, n_write, dup words)
    "flagship_shape": (B, "contiguous", "mixed", 2, 1, DUP_WORDS),
    "both_ext_keys": (B, "contiguous", "mixed", 2, 2, DUP_WORDS),
    "three_extensions": (B, "contiguous", "mixed", 4, 4, DUP_WORDS),
    "five_ext_keys_one_read": (B, "contiguous", "mixed", 5, 1, DUP_WORDS),
    "runtime_width_9": (B, "contiguous", "mixed", 9, 9, DUP_WORDS),
    "runtime_width_17_one_read": (37, "contiguous", "none", 17, 1,
                                  DUP_WORDS),
    "all_halted": (B, "contiguous", "all", 2, 1, DUP_WORDS),
    "strided_keys": (B, "strided", "mixed", 2, 1, DUP_WORDS),
    "keys_one_word_in": (129, "one_word_in", "mixed", 3, 3, DUP_WORDS),
    "extreme_words": (B, "contiguous", "mixed", 2, 1, (0, 2 ** 32 - 1)),
    "one_lane": (1, "contiguous", "none", 2, 1, DUP_WORDS),
}


@pytest.mark.parametrize("case", sorted(STEP_KEY_CASES))
def test_step_keys_through_the_kernel_path(standin, case):
    """The fused launch against its plain version: widths the kernel
    unrolls and ones it takes key by key, halted lanes, strided keys and
    keys off an 8-byte boundary (copied before the launch), extreme dup
    words, one lane."""
    lanes, layout, halt, n_ext, n_write, words = STEP_KEY_CASES[case]
    key = _step_key_operands(lanes, layout, len(case))
    halted = {"none": torch.zeros(lanes, dtype=torch.bool),
              "all": torch.ones(lanes, dtype=torch.bool),
              "mixed": torch.as_tensor(np.arange(lanes) % 3 == 1)}[halt]
    before = tf.step_keys_kernel.launches
    got = tf.step_keys_kernel.run(key, halted, words, n_ext, n_write)
    assert tf.step_keys_kernel.launches == before + 1
    want = tf.step_keys_plain(key, halted, words, n_ext, n_write)
    assert len(got) == len(want) == tf.STEP_KEYS + n_write
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (lanes, 2) and g.is_contiguous()
        assert torch.equal(g, w), i


def test_step_keys_refuses_a_bad_table_and_launches_nothing_for_no_lanes(
        standin):
    """The stand-in refuses what the launcher refuses (more keys written
    than split, a key off an 8-byte boundary); zero lanes launch no
    kernel; the wrapper refuses mismatched operands."""
    key = _batch_keys((8,), 50)
    halted = torch.zeros(8, dtype=torch.bool)
    out = torch.empty((7, 8, 2), dtype=torch.int32)
    p = tf._StepKeysParams(key=key.data_ptr(), halted=halted.data_ptr(),
                           out=out.data_ptr(), B=8, n_ext=2, n_write=1)
    assert _step_keys_standin(ctypes.byref(p), None) == 0
    p.n_write = 3
    assert _step_keys_standin(ctypes.byref(p), None) == 1
    p.n_write, p.key = 1, key.data_ptr() + 4
    assert _step_keys_standin(ctypes.byref(p), None) == 1
    before = tf.step_keys_kernel.launches
    none = tf.step_keys_kernel.run(key[:0], halted[:0], DUP_WORDS, 2, 1)
    assert [t.shape for t in none] == [(0, 2)] * 7
    assert tf.step_keys_kernel.launches == before
    with pytest.raises(ValueError, match="halted"):
        tf.step_keys_kernel.run(key, halted[:4], DUP_WORDS, 2, 1)
    with pytest.raises(ValueError, match="extension keys"):
        tf.step_keys_kernel.run(key, halted, DUP_WORDS, 2, 3)


@pytest.mark.parametrize("layout", ["contiguous", "keys_one_word_in",
                                    "strided_lanes"])
@pytest.mark.parametrize("case", chip_smoke.DUP_CASES)
def test_dup_draws_through_the_kernel_path(standin, case, layout):
    """The dup section's launch against its plain version, one launch:
    every case of the JAX parity test; keys one int32 off an 8-byte
    boundary and lane operands strided (both copied before the launch)."""
    args = _dup_operands(case, n=131)[1]
    if layout == "keys_one_word_in":
        flat = [torch.zeros(2 * 131 + 1, dtype=torch.int32) for _ in "ab"]
        for f, k in zip(flat, args[:2]):
            f[1:] = k.flatten()
        args[:2] = [f[1:].view(131, 2) for f in flat]
    elif layout == "strided_lanes":
        args[2:] = [torch.stack([a, a], -1)[..., 0] if a.ndim == 1
                    else a for a in args[2:]]
        assert not args[3].is_contiguous()
    before = tf.dup_draws_kernel.launches
    got = tf.dup_draws_kernel.run(*args)
    assert tf.dup_draws_kernel.launches == before + 1
    want = tf.dup_draws_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_dup_draws_refuses_bad_operands_and_launches_nothing_for_no_lanes(
        standin):
    args = _dup_operands("mixed", n=8)[1]
    before = tf.dup_draws_kernel.launches
    none = tf.dup_draws_kernel.run(*[a[:0] for a in args])
    assert [t.shape for t in none] == [(0,)] * 5
    assert tf.dup_draws_kernel.launches == before
    with pytest.raises(ValueError, match="valid"):
        tf.dup_draws_kernel.run(*args[:2], args[2].to(torch.int32),
                                *args[3:])
    with pytest.raises(ValueError, match="lat_lo"):
        tf.dup_draws_kernel.run(*args[:8], args[8][:4], *args[9:])


SPLIT_RANDINT_CASES = {
    # case: (keys, lo, hi)
    "raft_election": (lambda: _batch_keys((B,), 70), 150_000, 300_000),
    "from_zero": (lambda: _batch_keys((B,), 71), 0, 999),
    "equal_bounds": (lambda: _batch_keys((B,), 72), 7, 7),
    "hi_below_lo": (lambda: _batch_keys((B,), 73), 9, -4),
    "inclusive_int32_max": (lambda: _batch_keys((B,), 74), 0, I32_MAX),
    "whole_range": (lambda: _batch_keys((B,), 75), I32_MIN, I32_MAX),
    "strided_keys": (lambda: prng.split(_batch_keys((B,), 76), 2)[:, 0],
                     0, 20_000),
    "one_key": (lambda: _batch_keys((1,), 77)[0], 3, 40),
    "grid_3d": (lambda: _batch_keys((3, 4, 5), 78), -50, 50),
}


@pytest.mark.parametrize("case", sorted(SPLIT_RANDINT_CASES))
def test_split_randint_through_the_kernel_path(standin, case):
    """One launch against the two plain calls it replaces (`split(key,
    2)`, then `randint(its second key, lo, hi)`): the next key, the drawn
    key and the value, each contiguous, for int bounds at the int32
    extremes, equal and inverted bounds, strided keys, one key, a 3-d
    batch."""
    keys, lo, hi = SPLIT_RANDINT_CASES[case]
    key = keys()
    before = tf.split_randint_kernel.launches
    got = tf.split_randint_kernel.run(key, lo, hi)
    assert tf.split_randint_kernel.launches == before + 1
    ks = prng.split(key, 2)
    want = (ks[..., 0, :], ks[..., 1, :], prng.randint(ks[..., 1, :], lo, hi))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)
    for g, w in zip(got, tf.split_randint_plain(key, lo, hi)):
        assert torch.equal(g, w)


def test_split_randint_matches_jax():
    """`Ctx.randint`'s draw, the split and the inclusive randint of the
    second key, against jax on the handlers' [B, 2] keys."""
    jk, tk = _keys(seed=79)
    with reference_stream():
        ks = jax.vmap(lambda k: jprng.split(k, 2))(jk)
        val = jax.vmap(lambda k: jprng.randint(k, 150, 300))(ks[:, 1])
    nxt, k, v = tf.split_randint(tk, 150, 300)
    np.testing.assert_array_equal(_u32(nxt), np.asarray(ks[:, 0]))
    np.testing.assert_array_equal(_u32(k), np.asarray(ks[:, 1]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(val))


@pytest.fixture
def ctx_kernel_paths(standin, monkeypatch):
    """Ctx's draws on the kernels' paths for CPU tensors (stand-ins)."""
    monkeypatch.setattr(tf, "on_cpu", lambda t, what: False)


def _ctx(key, draws):
    import madsim_tpu_torch as P
    from madsim_tpu_torch.core.api import Ctx
    n = key.shape[0]
    z = torch.zeros(n, dtype=torch.int32)
    return Ctx(P.SimConfig(n_nodes=3), z, z, key, {}, draws=draws)


def _launches():
    return (tf.split_randint_kernel.launches, tf.threefry_keys.launches,
            tf.threefry_draw.launches)


def test_ctx_randint_fills_both_memo_entries_as_the_two_calls_did(
        ctx_kernel_paths):
    """Contexts sharing one key and one draw memo, as the step's handler
    contexts do: the first `randint(3, 40)` is one split_randint launch
    and fills the split and randint memo entries, so a later `rand_key`,
    `uniform`, `bernoulli` or repeated `randint` on any context sees the
    keys and draws of the two-call path (`split`, then `randint`, both
    from core/prng.py); a draw the memo lacks launches its own kernel."""
    _, key = _keys(seed=80)
    ks1 = prng.split(key, 2)
    ks2 = prng.split(ks1[:, 0], 2)
    ks3 = prng.split(ks2[:, 0], 2)
    draws = {}
    c1 = _ctx(key, draws)
    l0 = _launches()
    v1 = c1.randint(3, 40)
    assert _launches() == (l0[0] + 1, l0[1], l0[2])
    assert torch.equal(v1, prng.randint(ks1[:, 1], 3, 40))
    assert torch.equal(c1.rand_key(), ks2[:, 1])        # a threefry split
    assert torch.equal(c1.randint(3, 40), prng.randint(ks3[:, 1], 3, 40))
    assert _launches() == (l0[0] + 2, l0[1] + 1, l0[2])
    # another context on the same key: every draw from the memo
    c2 = _ctx(key, draws)
    l1 = _launches()
    assert torch.equal(c2.randint(3, 40), v1)
    assert torch.equal(c2.rand_key(), ks2[:, 1])
    assert torch.equal(c2.randint(3, 40), prng.randint(ks3[:, 1], 3, 40))
    assert _launches() == l1
    # other bounds on a memoised key: its own draw launch
    assert torch.equal(c2.randint(0, 5), prng.randint(
        prng.split(ks3[:, 0], 2)[:, 1], 0, 5))
    c3 = _ctx(key, draws)
    assert torch.equal(c3.rand_key(), ks1[:, 1])
    assert torch.equal(c3.randint(0, 9), prng.randint(ks2[:, 1], 0, 9))
    assert torch.equal(c3.uniform(), prng.uniform(ks3[:, 1]))
    c4 = _ctx(key, draws)
    c4.randint(3, 40)
    assert torch.equal(c4.bernoulli(0.5), prng.bernoulli(ks2[:, 1], 0.5))
    # a fresh memo: the same values through the kernel paths
    c5 = _ctx(key, {})
    assert torch.equal(c5.randint(3, 40), v1)
    assert torch.equal(c5.randint(0, 9), prng.randint(ks2[:, 1], 0, 9))


def _bounds(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "ints":
        return -5, 17
    if kind == "empty_span":
        return 9, -4
    if kind == "whole_range":
        return I32_MIN, I32_MAX
    lo = torch.as_tensor(rng.integers(-100, 100, B).astype(np.int32))
    hi = torch.as_tensor(rng.integers(-100, 100, B).astype(np.int32))
    if kind == "per_key":
        return lo, hi
    return lo[:1].reshape(()), hi     # a 0-d bound against per-key hi


@pytest.mark.parametrize("kind", ["ints", "empty_span", "whole_range",
                                  "per_key", "zero_d_and_per_key"])
@pytest.mark.parametrize("inclusive", [False, True])
def test_randint_through_the_kernel_path(standin, kind, inclusive):
    key = prng.split(_batch_keys((B,), 12), 2)[:, 1]       # strided
    lo, hi = _bounds(kind)
    if inclusive:     # the high bound + 1 is taken in the kernel
        got = tf.threefry_draw.randint(key, lo, hi, inclusive=True)
        want = prng.randint(key, lo, hi)
    else:
        got = tf.threefry_draw.randint(key, lo, hi)
        want = prng.randint_raw(key, lo, hi)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_randint_vector_and_broadcast_shapes_through_the_kernel_path(
        standin):
    """A vector draw per key (the torn flush's (F,)), and keys [B, 1, 2]
    against bounds [3] (a batch wider than the keys')."""
    key = _batch_keys((B,), 13)
    got = tf.threefry_draw.randint(key, 0, 2 ** 30, (5,))
    assert torch.equal(got, prng.randint_raw(key, 0, 2 ** 30, (5,)))
    hi = torch.tensor([1, 50, 2 ** 20], dtype=torch.int32)
    got = tf.threefry_draw.randint(key[:, None, :], 0, hi)
    assert got.shape == (B, 3)
    assert torch.equal(got, prng.randint_raw(key[:, None, :], 0, hi))


@pytest.mark.parametrize("p", ["zero", "one", "subnormal", "half",
                               "per_key", "zero_d_float64"])
def test_uniform_and_bernoulli_through_the_kernel_path(standin, p):
    key = prng.split(_batch_keys((B,), 14), 3)[:, 2]
    assert torch.equal(tf.threefry_draw.uniform(key), prng.uniform(key))
    prob = dict(zero=0.0, one=1.0, subnormal=float(np.float32(1e-40)),
                half=0.5,
                per_key=torch.rand(B, generator=torch.Generator()
                                   .manual_seed(3)),
                zero_d_float64=torch.tensor(0.3, dtype=torch.float64))[p]
    got = tf.threefry_draw.bernoulli(key, prob)
    assert got.dtype == torch.bool
    assert torch.equal(got, prng.bernoulli(key, prob))


def test_bernoulli_refuses_a_wider_p_tensor():
    key = _batch_keys((4,), 15)
    with pytest.raises(TypeError, match="float32"):
        tf.threefry_draw.bernoulli(key, torch.full((4,), 0.5,
                                                   dtype=torch.float64))


# --------------------------------------------------------------------------
# The entry points' device
# --------------------------------------------------------------------------
def test_make_step_and_init_state_need_a_device_without_a_gpu():
    """With no GPU and no device named, the step and the initial state
    raise instead of moving to the CPU (core/device.py); named, they run
    where they are told."""
    from madsim_tpu_torch.core.state import init_state
    from madsim_tpu_torch.core.step import make_step
    from madsim_tpu_torch.models import pingpong as tpp
    import madsim_tpu_torch as P
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is CUDA")
    cfg = P.SimConfig(n_nodes=2)
    args = (cfg, [tpp.PingPong(2)], np.zeros(2, np.int32),
            tpp.state_spec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_step(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, {})
    assert callable(make_step(*args, device="cpu"))
    assert init_state(cfg, {}, device="cpu").now.device.type == "cpu"
