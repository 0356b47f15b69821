"""Counter-based per-trajectory PRNG: jax's threefry2x32, bit for bit.

Every random decision of a trajectory is drawn from a threefry key the
lane carries in its state, split in a fixed static order each step, so a
seed reproduces its trajectory exactly whatever the batch around it. The
port must draw the very bits the JAX package draws, so this module
re-implements jax's NON-partitionable threefry stream
(`jax_threefry_partitionable=False`, the stream the frozen golden digests
were recorded under) instead of using `torch.Generator`:

  threefry2x32     jax/_src/prng.py `_threefry2x32_lowering` (20 rounds)
  seed_key         `threefry_seed`: uint32 seed s -> key (0, s)
  split            `_threefry_split_original`: counts iota(2n), halves
  fold_in          `_threefry_fold_in`: threefry(key, threefry_seed(d))
  random_bits      `_threefry_random_bits_original` (odd counts padded)
  randint          jax/_src/random.py `_randint` (two draws, span and
                   multiplier reduction, uint32 wrap throughout)
  uniform          `_uniform`: (bits >> 9) | 0x3f800000, minus 1.0

Representation: a 32-bit word is an int32 tensor holding the uint32 BIT
PATTERN. Add, multiply and xor are sign-agnostic in two's complement, so
int32 arithmetic wraps exactly like uint32; the sign-sensitive steps
(right shift, remainder, unsigned compare) are written out explicitly.
Keys are int32 tensors of shape [..., 2]; every function broadcasts over
the leading axes, so one call draws for a whole batch of lanes.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def u32(value: int) -> int:
    """A uint32 constant as the int32 value with the same bits."""
    value &= MASK32
    return value - (1 << 32) if value >= (1 << 31) else value


_CONSTS: dict = {}


def _const(value: int, device) -> torch.Tensor:
    """A cached 0-d int32 tensor on `device`: tensor-tensor integer ops
    dispatch about twice as fast as ops with a Python scalar operand."""
    k = (value, str(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.tensor(value, dtype=torch.int32,
                                      device=device)
    return t


def _i32(x, device) -> torch.Tensor:
    """An int32 operand on `device`: Python ints come from the constant
    cache (creating a device tensor from a host value would copy, and
    that copy waits for the device)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int32 else x.to(torch.int32)
    return _const(int(x), device)


def shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical (uint32) right shift of int32 bit patterns."""
    return torch.bitwise_and(
        torch.bitwise_right_shift(x, _const(r, x.device)),
        _const((1 << (32 - r)) - 1, x.device))


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, in int64."""
    return x.to(torch.int64) & MASK32


def from_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 holding their low 32 bits."""
    return (x & MASK32).to(torch.int32)


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function (20 rounds, key schedule with the
    0x1BD11BDA parity word), elementwise over broadcast int32 tensors.
    Returns the pair (y0, y1)."""
    dev = x0.device if isinstance(x0, torch.Tensor) else k0.device
    k2 = k0 ^ k1 ^ _const(0x1BD11BDA, dev)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            # rotate left by r; the arithmetic right shift's sign bits
            # are masked off, making it a logical one
            hi = torch.bitwise_left_shift(x1, _const(r, dev))
            lo = torch.bitwise_and(
                torch.bitwise_right_shift(x1, _const(32 - r, dev)),
                _const((1 << r) - 1, dev))
            x1 = x0 ^ (hi | lo)
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + _const(i + 1, dev))
    return x0, x1


def _counts(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`threefry_2x32`'s split of iota(n) into two halves (an odd count
    is padded with one zero word). Cached per (n, device)."""
    k = (("counts", n), str(device))
    halves = _CONSTS.get(k)
    if halves is None:
        c = torch.arange(n + (n % 2), dtype=torch.int32, device=device)
        if n % 2:
            c[-1] = 0
        h = c.shape[0] // 2
        halves = _CONSTS[k] = (c[:h], c[h:])
    return halves


def _hash_counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """threefry_2x32(key, iota(n)) -> [..., n] for keys [..., 2]."""
    x0, x1 = _counts(n, key.device)
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, x0, x1)
    out = torch.cat([y0, y1], dim=-1)
    return out[..., :n]


def seed_key(seed) -> torch.Tensor:
    """Key(s) from uint32 seed(s): jax's `PRNGKey(uint32 s)` = (0, s).
    `seed` is an int, a numpy array or an integer tensor; values are
    taken modulo 2^32, as `jnp.asarray(seed, uint32)` takes them."""
    s = torch.as_tensor(seed)
    s = from_u64(s.to(torch.int64))
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """[..., 2] -> [..., n, 2] (`_threefry_split_original`)."""
    out = _hash_counts(key, 2 * n)
    return out.reshape(key.shape[:-1] + (n, 2))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold uint32 `data` (int or int32 bit-pattern tensor broadcastable
    against the key batch) into `key`."""
    if not isinstance(data, torch.Tensor):
        data = u32(int(data))
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(key[..., 0]), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32 random bits per element: [..., 2] keys -> [..., *shape] int32."""
    bits = _hash_counts(key, math.prod(shape))
    return bits.reshape(key.shape[:-1] + tuple(shape))


def randint_raw(key: torch.Tensor, minval, maxval,
                shape: tuple = ()) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, int32)`: uniform
    int32 in [minval, maxval) (minval when maxval <= minval). minval and
    maxval are int32 tensors (or ints) broadcastable against the key batch;
    with a non-empty `shape` they broadcast against `[..., *shape]`."""
    minval = _i32(minval, key.device)
    maxval = _i32(maxval, key.device)
    if shape:
        minval = minval.reshape(minval.shape + (1,) * len(shape))
        maxval = maxval.reshape(maxval.shape + (1,) * len(shape))
    # both halves of the split draw in one threefry call
    bits = to_u64(random_bits(split(key, 2), shape))
    hi_bits, lo_bits = bits.unbind(key.ndim - 1)
    span = to_u64(maxval - minval)
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = torch.remainder(torch.full_like(span, 1 << 16), span)
    mult = torch.remainder((mult * mult) & MASK32, span)
    # (hi % span) * mult wraps mod 2^32 (a uint32 multiply in jax): take
    # it in int32, whose low 32 bits are the uint32 product's
    prod = to_u64(from_u64(torch.remainder(hi_bits, span))
                  * from_u64(mult))
    off = torch.remainder((prod + torch.remainder(lo_bits, span)) & MASK32,
                          span)
    return minval + from_u64(off)


def randint(key: torch.Tensor, lo, hi) -> torch.Tensor:
    """Uniform int32 in [lo, hi] INCLUSIVE (hi >= lo), one per key."""
    # hi + 1 wraps in int32, as the reference's int32 `hi + 1` does
    hi = u32(hi + 1) if isinstance(hi, int) else hi + 1
    return randint_raw(key, lo, hi)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1), one per key (jax's mantissa construction)."""
    bits = random_bits(key, ())
    fbits = shr(bits, 9) | 0x3F800000
    return fbits.view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p) -> torch.Tensor:
    """uniform(key) < p, in float32 (exact: both sides are float32)."""
    return uniform(key) < p


# Domain separator for the per-node HASH-SEED streams: keeps the
# (seed, node)-derived keys out of the trajectory key's split lineage.
HASH_STREAM_DOMAIN = 0x48534853  # "HSHS"


def node_hash_key(seed_or_key, node, stream: int = 0) -> torch.Tensor:
    """Node `node`'s deterministic hash-seed key, a pure function of
    (seed, node, stream): fold_in(fold_in(fold_in(key, DOMAIN), node),
    stream). Accepts a raw seed (an int or a 0-d tensor, as the JAX
    package's scalar rule has it) or an already-derived [..., 2] key."""
    key = seed_or_key
    if not isinstance(key, torch.Tensor) or key.ndim == 0:
        key = seed_key(key)
    k = fold_in(key, HASH_STREAM_DOMAIN)
    k = fold_in(k, torch.as_tensor(node, dtype=torch.int32,
                                   device=k.device))
    return fold_in(k, u32(int(stream)))
