"""The threefry draws of the step and the handlers (K1): `step_keys`,
`dup_draws`, `split_randint`, `threefry_keys` and `threefry_draw`,
hand-written CUDA kernels (csrc/prng.cu), behind the functions of
`core/prng.py`'s signatures and broadcasting.

They replace the JAX package's threefry draws (madsim_tpu/core/prng.py
:24 `split`, :28 `randint`, :35 `uniform`, :39 `bernoulli`, :49
`node_hash_key`, and `jax.random.fold_in`) where the step draws outside
a kernel: the step's own keys (the select's 5-way split, the
duplicate-delivery `fold_in`s and the supervisor section's extension
split, madsim_tpu/core/step.py:138, :246, :315, :338), the dup section's
`bernoulli` and `randint`, and every `Ctx` draw of the handlers
(core/api.py).

    step_keys(key, halted, words, n_ext, n_write)
                                   the step's keys in one launch: [the
                                   next key, k_sched, k_handler, k_net,
                                   fold_in(k_sched, words[0]),
                                   fold_in(k_sched, words[1]), the first
                                   n_write keys of split(k_super, n_ext)],
                                   each a contiguous [B, 2] tensor
    dup_draws(k_dupf, k_dupd, valid, ev_kind, ev_node, dup_rate, now,
              dmin, lat_lo, lat_hi, tlimit)
                                   the step's dup section in one launch:
                                   (now, time_over, dup_fire, the popped
                                   row's deadline, its free mask)
    split_randint(key, lo, hi)     `Ctx.randint` with int bounds in one
                                   launch: (the next key, the drawn key,
                                   randint(drawn key, lo, hi) inclusive)
    split(key, n)                  [..., 2] -> [..., n, 2]
    fold_in(key, data)             one word (an int, or a tensor
                                   broadcastable against the key batch)
    randint_raw(key, lo, hi, shape)  int32 in [lo, hi), shape () or more
    randint(key, lo, hi)           int32 in [lo, hi] inclusive
    uniform(key)                   float32 in [0, 1)
    bernoulli(key, p)              uniform(key) < p, in float32
    node_hash_key(seed_or_key, node, stream)

On CPU tensors each function is `core/prng.py`'s own (`step_keys`,
`dup_draws`, `split_randint`: `step_keys_plain`, `dup_draws_plain`,
`split_randint_plain`, which compose them as the step and `Ctx` did),
and that stays the plain version: the kernels' plain references (the
plain supervisor op, emission write, mutator and `masked_choice`) call
it directly and never come here. On CUDA tensors they launch the kernels; on any other
device, and on a kernel that fails to build or launch, they raise.
Nothing falls back to the plain version.

A kernel sees each operand as a [M, W] grid over strided memory, W the
output batch's last axis and M the rest: the wrapper broadcasts the key,
the fold words, the bounds and p to the output batch as views (a stride
of 0 where an operand is broadcast) and hands the kernel their pointers
and strides, so the step's strided key slices and broadcast bounds cost
no copy. Python ints and floats go by value in the parameter block, so a
draw inside a CUDA-graph capture builds no host tensor (ROADMAP F4, F7).

`step_keys_kernel.launches`, `dup_draws_kernel.launches`,
`split_randint_kernel.launches`, `threefry_keys.launches` and
`threefry_draw.launches` count kernel launches (and nothing else); a
launch recorded into a CUDA graph counts in `captured` instead.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import prng
from ..core import types as T
from . import select as sel
from .kernels import CKernel, on_cpu

_I32 = torch.int32
MODE_RANDINT, MODE_UNIFORM, MODE_BERNOULLI = 0, 1, 2


def _word(value: int) -> int:
    """A uint32 constant as the int32 value with the same bits."""
    value = int(value) & 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


class _Operand(ctypes.Structure):
    """csrc/prng.cu `Operand`, field for field."""
    _fields_ = [("ptr", ctypes.c_void_p), ("sm", ctypes.c_int64),
                ("sw", ctypes.c_int64)]


class _KeysParams(ctypes.Structure):
    """csrc/prng.cu `KeysParams`, field for field."""
    _fields_ = [("key", _Operand), ("data", _Operand),
                ("out", ctypes.c_void_p), ("word", ctypes.c_int32),
                ("M", ctypes.c_int32), ("W", ctypes.c_int32),
                ("n", ctypes.c_int32)]


class _DrawParams(ctypes.Structure):
    """csrc/prng.cu `DrawParams`, field for field."""
    _fields_ = [("key", _Operand), ("lo", _Operand), ("hi", _Operand),
                ("out", ctypes.c_void_p), ("lo_val", ctypes.c_int32),
                ("hi_val", ctypes.c_int32), ("p_val", ctypes.c_float),
                ("M", ctypes.c_int32), ("W", ctypes.c_int32),
                ("F", ctypes.c_int32), ("mode", ctypes.c_int32),
                ("inclusive", ctypes.c_int32)]


class _StepKeysParams(ctypes.Structure):
    """csrc/prng.cu `StepKeysParams`, field for field."""
    _fields_ = [("key", ctypes.c_void_p), ("halted", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("dup_word0", ctypes.c_int32),
                ("dup_word1", ctypes.c_int32), ("B", ctypes.c_int32),
                ("n_ext", ctypes.c_int32), ("n_write", ctypes.c_int32)]


class _DupParams(ctypes.Structure):
    """csrc/prng.cu `DupParams`, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "k_dupf", "k_dupd", "valid", "ev_kind", "ev_node", "dup_rate", "now",
        "dmin", "lat_lo", "lat_hi", "tlimit", "now_out", "time_over",
        "dup_fire", "deadline", "free_row")]
        + [("B", ctypes.c_int32), ("N", ctypes.c_int32)])


class _SplitRandintParams(ctypes.Structure):
    """csrc/prng.cu `SplitRandintParams`, field for field."""
    _fields_ = [("key", _Operand), ("out", ctypes.c_void_p),
                ("value", ctypes.c_void_p), ("lo", ctypes.c_int32),
                ("hi", ctypes.c_int32), ("M", ctypes.c_int32),
                ("W", ctypes.c_int32)]


STEP_KEYS = 6      # step_keys' keys before the extension keys


def _grid(shape: tuple) -> tuple[int, int]:
    """(M, W) of an output batch: W its last axis, M the others."""
    if not shape:
        return 1, 1
    return math.prod(shape[:-1]), shape[-1]


def _grid_view(t: torch.Tensor, shape: tuple, pair: bool) -> torch.Tensor:
    """`t` broadcast to the batch `shape` (and its key pair axis) as a
    [M, W(, 2)] view: stride 0 along a broadcast axis; a copy only where
    the batch axes cannot merge or a pair is not adjacent words."""
    tail = (2,) if pair else ()
    full = t.expand(tuple(shape) + tail).reshape(_grid(shape) + tail)
    if pair and full.stride(-1) != 1:
        full = full.contiguous()
    return full


def _operand(view: torch.Tensor | None) -> _Operand:
    if view is None:
        return _Operand(None, 0, 0)
    return _Operand(view.data_ptr(), view.stride(0), view.stride(1))


def _check_key(key: torch.Tensor, what: str) -> None:
    if key.dtype != _I32:
        raise TypeError(f"threefry.{what}: keys are int32 bit patterns, "
                        f"got {key.dtype}")
    if key.ndim < 1 or key.shape[-1] != 2:
        raise ValueError(f"threefry.{what}: keys are [..., 2], got "
                         f"{tuple(key.shape)}")


class _ThreefryKeys(CKernel):
    """`split` and `fold_in` on the kernel (any device the caller hands
    it; the module's functions send only CUDA tensors here)."""

    def __init__(self):
        super().__init__("prng", "threefry_keys", _KeysParams)

    def split(self, key: torch.Tensor, n: int = 2) -> torch.Tensor:
        _check_key(key, "split")
        shape = tuple(key.shape[:-1])
        M, W = _grid(shape)
        out = torch.empty((M, W, n, 2), dtype=_I32, device=key.device)
        if M * W and n:
            kview = _grid_view(key, shape, True)    # alive until launched
            p = _KeysParams(key=_operand(kview), data=_operand(None),
                            out=out.data_ptr(), word=0, M=M, W=W, n=n)
            self._launch(p, key.device)
        return out.reshape(shape + (n, 2))

    def fold_in(self, key: torch.Tensor, data) -> torch.Tensor:
        _check_key(key, "fold_in")
        word, dview = 0, None
        shape = tuple(key.shape[:-1])
        if isinstance(data, torch.Tensor):
            data = data if data.dtype == _I32 else data.to(_I32)
            shape = tuple(torch.broadcast_shapes(shape, data.shape))
            dview = _grid_view(data, shape, False)
        else:
            word = _word(data)
        M, W = _grid(shape)
        out = torch.empty((M, W, 2), dtype=_I32, device=key.device)
        if M * W:
            kview = _grid_view(key, shape, True)    # alive until launched
            p = _KeysParams(key=_operand(kview), data=_operand(dview),
                            out=out.data_ptr(), word=word, M=M, W=W, n=0)
            self._launch(p, key.device)
        return out.reshape(shape + (2,))


def step_keys_plain(key: torch.Tensor, halted: torch.Tensor, words,
                    n_ext: int, n_write: int) -> list:
    """The step's keys from `core/prng.py`, composed as the JAX step
    composes them (madsim_tpu/core/step.py:138 `split(s.key, 5)` and
    `where(live, key, s.key)`, :246 and :315 `fold_in(k_sched, word)`,
    :338 `split(k_super, n_ext)`): [the next key, k_sched, k_handler,
    k_net, the two dup keys, the first n_write extension keys], each a
    contiguous [B, 2] tensor."""
    keys = prng.split(key, 5)
    k_sched = keys[:, 1]
    ext = prng.split(keys[:, 2], n_ext)
    out = [torch.where(~halted[:, None], keys[:, 0], key), k_sched,
           keys[:, 3], keys[:, 4], prng.fold_in(k_sched, words[0]),
           prng.fold_in(k_sched, words[1])]
    out += [ext[:, i] for i in range(n_write)]
    return [t.contiguous() for t in out]


class _StepKeys(CKernel):
    """`step_keys` on the kernel (any device the caller hands it; the
    module's function sends only CUDA tensors here)."""

    def __init__(self):
        super().__init__("prng", "step_keys", _StepKeysParams)

    def run(self, key: torch.Tensor, halted: torch.Tensor, words,
            n_ext: int, n_write: int) -> list:
        _check_key(key, "step_keys")
        dev = key.device
        B = key.shape[0]
        if key.shape != (B, 2) or halted.shape != (B,) \
                or halted.dtype != torch.bool or halted.device != dev:
            raise ValueError("threefry.step_keys: keys are [B, 2] and "
                             f"halted a [B] bool tensor on {dev}")
        if not 1 <= n_write <= n_ext:
            raise ValueError(f"threefry.step_keys: {n_write} of {n_ext} "
                             "extension keys")
        # the kernel reads a key as one 8-byte word: a copy where the keys
        # are strided or start off an 8-byte boundary (alive until the
        # launch)
        k = key if key.is_contiguous() and key.data_ptr() % 8 == 0 \
            else key.clone(memory_format=torch.contiguous_format)
        h = halted.contiguous()
        out = torch.empty((STEP_KEYS + n_write, B, 2), dtype=_I32,
                          device=dev)
        if B:
            p = _StepKeysParams(key=k.data_ptr(), halted=h.data_ptr(),
                                out=out.data_ptr(),
                                dup_word0=_word(words[0]),
                                dup_word1=_word(words[1]), B=B,
                                n_ext=n_ext, n_write=n_write)
            self._launch(p, dev)
        return list(out.unbind(0))


_PER_MILLION: dict = {}


def _per_million(dev) -> torch.Tensor:
    """A cached float32 1e-6 on `dev`: the step's dup rate is a float32
    product with it, as the JAX step's `astype(float32) * float32(1e-6)`
    (a tensor, so no host value is copied while a graph is captured)."""
    t = _PER_MILLION.get(str(dev))
    if t is None:
        t = _PER_MILLION[str(dev)] = torch.tensor(1e-6, dtype=torch.float32,
                                                  device=dev)
    return t


def dup_draws_plain(k_dupf, k_dupd, valid, ev_kind, ev_node, dup_rate, now,
                    dmin, lat_lo, lat_hi, tlimit) -> tuple:
    """The step's dup section from `core/prng.py`, composed as the JAX
    step composes it (madsim_tpu/core/step.py:244-317): (now, time_over,
    dup_fire, the popped row's deadline where(dup_fire, redeliver, T_INF),
    its free mask valid & ~dup_fire)."""
    dup_p = (sel.take1(dup_rate, ev_node).to(torch.float32)
             * _per_million(now.device))
    dup_fire = (valid & (ev_kind == T.EV_MSG)
                & prng.bernoulli(k_dupf, dup_p))
    # pop the slot; the clock never runs backward
    now = torch.where(valid, torch.maximum(now, dmin), now)
    time_over = now > tlimit
    redeliver = now + torch.clamp(prng.randint(k_dupd, lat_lo, lat_hi),
                                  min=1)
    deadline = torch.where(dup_fire, redeliver,
                           torch.full_like(now, int(T.T_INF)))
    return now, time_over, dup_fire, deadline, valid & ~dup_fire


class _DupDraws(CKernel):
    """`dup_draws` on the kernel (any device the caller hands it; the
    module's function sends only CUDA tensors here)."""

    def __init__(self):
        super().__init__("prng", "dup_draws", _DupParams)

    def run(self, k_dupf, k_dupd, valid, ev_kind, ev_node, dup_rate, now,
            dmin, lat_lo, lat_hi, tlimit) -> tuple:
        dev = now.device
        B = now.shape[0]
        lanes = dict(ev_kind=ev_kind, ev_node=ev_node, now=now, dmin=dmin,
                     lat_lo=lat_lo, lat_hi=lat_hi, tlimit=tlimit)
        for name, t in dict(lanes, k_dupf=k_dupf, k_dupd=k_dupd,
                            valid=valid, dup_rate=dup_rate).items():
            want = torch.bool if name == "valid" else _I32
            shape = {"k_dupf": (B, 2), "k_dupd": (B, 2),
                     "dup_rate": (B, dup_rate.shape[-1])}.get(name, (B,))
            if t.device != dev or t.dtype != want or t.shape != shape:
                raise ValueError(
                    f"threefry.dup_draws: {name} is {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}, expected {want} "
                    f"{shape} on {dev}")
        # the kernel reads a key as one 8-byte word and every other operand
        # a lane at a time: copies where an operand is strided or a key off
        # an 8-byte boundary (alive until the launch)
        keys = [k if k.is_contiguous() and k.data_ptr() % 8 == 0
                else k.clone(memory_format=torch.contiguous_format)
                for k in (k_dupf, k_dupd)]
        ops = {n: t.contiguous() for n, t in dict(
            lanes, valid=valid, dup_rate=dup_rate).items()}
        out = dict(now_out=torch.empty((B,), dtype=_I32, device=dev),
                   time_over=torch.empty((B,), dtype=torch.bool, device=dev),
                   dup_fire=torch.empty((B,), dtype=torch.bool, device=dev),
                   deadline=torch.empty((B,), dtype=_I32, device=dev),
                   free_row=torch.empty((B,), dtype=torch.bool, device=dev))
        if B:
            p = _DupParams(k_dupf=keys[0].data_ptr(),
                           k_dupd=keys[1].data_ptr(), B=B,
                           N=dup_rate.shape[-1])
            for n, t in list(ops.items()) + list(out.items()):
                setattr(p, n, t.data_ptr())
            self._launch(p, dev)
        return tuple(out.values())


def split_randint_plain(key: torch.Tensor, lo: int, hi: int) -> tuple:
    """`Ctx.randint`'s two draws from `core/prng.py`: split(key, 2), then
    randint(its second key, lo, hi) inclusive. Returns (the next key, the
    drawn key, the value)."""
    ks = prng.split(key, 2)
    nxt, k = ks[..., 0, :], ks[..., 1, :]
    return nxt, k, prng.randint(k, lo, hi)


class _SplitRandint(CKernel):
    """`split_randint` on the kernel (any device the caller hands it; the
    module's function sends only CUDA tensors here)."""

    def __init__(self):
        super().__init__("prng", "split_randint", _SplitRandintParams)

    def run(self, key: torch.Tensor, lo: int, hi: int) -> tuple:
        _check_key(key, "split_randint")
        shape = tuple(key.shape[:-1])
        M, W = _grid(shape)
        buf = torch.empty(5 * M * W, dtype=_I32, device=key.device)
        keys = buf[:4 * M * W].view(2, M * W, 2)
        value = buf[4 * M * W:]
        if M * W:
            kview = _grid_view(key, shape, True)    # alive until launched
            p = _SplitRandintParams(
                key=_operand(kview), out=keys.data_ptr(),
                value=value.data_ptr(), lo=_word(lo), hi=_word(hi), M=M, W=W)
            self._launch(p, key.device)
        return (keys[0].view(shape + (2,)), keys[1].view(shape + (2,)),
                value.view(shape))


def _bound(x, dev, what):
    """(int32 view source, value): a tensor bound, or an int by value."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"threefry.{what}: bound on {x.device}, keys "
                             f"on {dev}")
        return (x if x.dtype == _I32 else x.to(_I32)), 0
    return None, _word(x)


class _ThreefryDraw(CKernel):
    """`randint_raw`, `uniform` and `bernoulli` on the kernel."""

    def __init__(self):
        super().__init__("prng", "threefry_draw", _DrawParams)

    def _run(self, key, mode, shape, F, out_dtype, lo=None, hi=None,
             lo_val=0, hi_val=0, p_val=0.0, inclusive=False):
        M, W = _grid(shape)
        out = torch.empty((M, W, F), dtype=out_dtype, device=key.device)
        if M * W * F:
            # the views (copies where strides cannot merge) stay alive
            # until the launch
            views = [None if t is None else _grid_view(t, shape, pair)
                     for t, pair in ((key, True), (lo, False), (hi, False))]
            p = _DrawParams(
                key=_operand(views[0]), lo=_operand(views[1]),
                hi=_operand(views[2]),
                out=out.data_ptr(), lo_val=lo_val, hi_val=hi_val,
                p_val=p_val, M=M, W=W, F=F, mode=mode,
                inclusive=int(inclusive))
            self._launch(p, key.device)
        return out

    def randint(self, key, minval, maxval, shape: tuple = (),
                inclusive: bool = False) -> torch.Tensor:
        _check_key(key, "randint")
        lo, lo_val = _bound(minval, key.device, "randint")
        hi, hi_val = _bound(maxval, key.device, "randint")
        batch = torch.broadcast_shapes(
            key.shape[:-1], *(t.shape for t in (lo, hi) if t is not None))
        shape = tuple(shape)
        out = self._run(key, MODE_RANDINT, tuple(batch), math.prod(shape),
                        _I32, lo, hi, lo_val, hi_val, inclusive=inclusive)
        return out.reshape(tuple(batch) + shape)

    def uniform(self, key) -> torch.Tensor:
        _check_key(key, "uniform")
        batch = tuple(key.shape[:-1])
        return self._run(key, MODE_UNIFORM, batch, 1,
                         torch.float32).reshape(batch)

    def bernoulli(self, key, p) -> torch.Tensor:
        _check_key(key, "bernoulli")
        batch = tuple(key.shape[:-1])
        if isinstance(p, torch.Tensor):
            if p.device != key.device:
                raise ValueError(f"threefry.bernoulli: p on {p.device}, "
                                 f"keys on {key.device}")
            if p.dtype != torch.float32:
                # a 0-d p of another float type is compared in float32
                # (torch's promotion); a wider p tensor would promote the
                # compare, which the kernel does not do
                if p.ndim or not p.is_floating_point():
                    raise TypeError("threefry.bernoulli: p must be a "
                                    "float32 tensor or a Python number, "
                                    f"got {p.dtype}")
                p = p.to(torch.float32)
            batch = tuple(torch.broadcast_shapes(batch, p.shape))
            out = self._run(key, MODE_BERNOULLI, batch, 1, torch.bool, lo=p)
        else:
            out = self._run(key, MODE_BERNOULLI, batch, 1, torch.bool,
                            p_val=float(np.float32(p)))
        return out.reshape(batch)


step_keys_kernel = _StepKeys()
dup_draws_kernel = _DupDraws()
split_randint_kernel = _SplitRandint()
threefry_keys = _ThreefryKeys()
threefry_draw = _ThreefryDraw()


def step_keys(key: torch.Tensor, halted: torch.Tensor, words, n_ext: int,
              n_write: int) -> list:
    """The step's keys in one launch (`step_keys_plain`'s)."""
    if on_cpu(key, "threefry.step_keys"):
        return step_keys_plain(key, halted, words, n_ext, n_write)
    return step_keys_kernel.run(key, halted, words, n_ext, n_write)


def dup_draws(k_dupf, k_dupd, valid, ev_kind, ev_node, dup_rate, now,
              dmin, lat_lo, lat_hi, tlimit) -> tuple:
    """The step's dup section in one launch (`dup_draws_plain`'s): (now,
    time_over, dup_fire, the popped row's deadline, its free mask)."""
    if on_cpu(now, "threefry.dup_draws"):
        return dup_draws_plain(k_dupf, k_dupd, valid, ev_kind, ev_node,
                               dup_rate, now, dmin, lat_lo, lat_hi, tlimit)
    return dup_draws_kernel.run(k_dupf, k_dupd, valid, ev_kind, ev_node,
                                dup_rate, now, dmin, lat_lo, lat_hi, tlimit)


def split_randint(key: torch.Tensor, lo: int, hi: int) -> tuple:
    """(the next key, the drawn key, randint(drawn key, lo, hi) inclusive)
    of split(key, 2), in one launch (`split_randint_plain`'s)."""
    if on_cpu(key, "threefry.split_randint"):
        return split_randint_plain(key, lo, hi)
    return split_randint_kernel.run(key, lo, hi)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """[..., 2] -> [..., n, 2] (`prng.split`)."""
    if on_cpu(key, "threefry.split"):
        return prng.split(key, n)
    return threefry_keys.split(key, n)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold uint32 `data` (an int, or an int32 tensor broadcastable
    against the key batch) into `key` (`prng.fold_in`)."""
    if on_cpu(key, "threefry.fold_in"):
        return prng.fold_in(key, data)
    return threefry_keys.fold_in(key, data)


def randint_raw(key: torch.Tensor, minval, maxval,
                shape: tuple = ()) -> torch.Tensor:
    """Uniform int32 in [minval, maxval), minval where maxval <= minval
    (`prng.randint_raw`)."""
    if on_cpu(key, "threefry.randint_raw"):
        return prng.randint_raw(key, minval, maxval, shape)
    return threefry_draw.randint(key, minval, maxval, shape)


def randint(key: torch.Tensor, lo, hi) -> torch.Tensor:
    """Uniform int32 in [lo, hi] INCLUSIVE, one per key (`prng.randint`;
    hi + 1 wraps in int32)."""
    if on_cpu(key, "threefry.randint"):
        return prng.randint(key, lo, hi)
    return threefry_draw.randint(key, lo, hi, inclusive=True)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1), one per key (`prng.uniform`)."""
    if on_cpu(key, "threefry.uniform"):
        return prng.uniform(key)
    return threefry_draw.uniform(key)


def bernoulli(key: torch.Tensor, p) -> torch.Tensor:
    """uniform(key) < p in float32 (`prng.bernoulli`)."""
    if on_cpu(key, "threefry.bernoulli"):
        return prng.bernoulli(key, p)
    return threefry_draw.bernoulli(key, p)


def node_hash_key(seed_or_key, node, stream: int = 0) -> torch.Tensor:
    """Node `node`'s hash-seed key: fold_in(fold_in(fold_in(key, DOMAIN),
    node), stream) (`prng.node_hash_key`), three launches on CUDA. A raw
    seed (an int or a 0-d tensor) becomes the key (0, seed) first."""
    key = seed_or_key
    raw = not isinstance(key, torch.Tensor) or key.ndim == 0
    if not raw:
        where = key
    elif isinstance(node, torch.Tensor):
        where = node
    else:
        where = key if isinstance(key, torch.Tensor) else None
    if where is None or on_cpu(where, "threefry.node_hash_key"):
        return prng.node_hash_key(seed_or_key, node, stream)
    dev = where.device
    if raw:
        if isinstance(key, torch.Tensor):
            s = (key.to(dev).to(torch.int64) & 0xFFFFFFFF).to(_I32)
            key = torch.stack([torch.zeros_like(s), s])
        else:
            key = torch.tensor([0, _word(key)], dtype=_I32, device=dev)
    k = fold_in(key, prng.HASH_STREAM_DOMAIN)
    k = fold_in(k, torch.as_tensor(node, dtype=_I32, device=dev))
    return fold_in(k, _word(stream))
