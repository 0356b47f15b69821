"""Per-trajectory state fingerprints (the counterpart of
`madsim_tpu.utils.hashing`).

Every replay-domain leaf of a lane is folded into one uint32 with the
JAX package's FNV rule, so fingerprints computed by the two packages for
the same state are equal:

    for leaf i (in jax tree order), words w[0..n) as uint32:
        lh = sum_k w[k] * (k * 2654435761 + 2i + 1)      (mod 2^32)
        h  = (h ^ lh) * 16777619                         (mod 2^32)

starting from h = 2166136261. Leaves are ordered as `jax.tree.leaves`
orders a dict: sorted by field name, nested dicts (node_state, ext)
sorted by key. float32 leaves contribute their bit patterns, everything
else its value cast to int32. The flight-recorder and other
observation-plane fields (TRACE_FIELDS) are left out.

`fingerprint` is a hand-written CUDA kernel (csrc/fingerprint.cu) for
states on the card and `fingerprint_plain`, the same function in plain
PyTorch, for states on the CPU; on any other device it raises.
`fingerprint.launches` counts kernel launches (a launch recorded into a
CUDA graph under capture counts in `captured` instead).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.prng import MASK32, to_u64
from ..core.state import TRACE_FIELDS, SimState

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_GOLDEN = 2654435761

_OBSERVATION_FIELDS = frozenset(TRACE_FIELDS)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


def _words(leaf: torch.Tensor) -> torch.Tensor:
    """[B, ...] leaf -> [B, n] uint32 words (as int64 in [0, 2^32))."""
    if leaf.dtype == torch.float32:
        w = leaf.contiguous().view(torch.int32)
    else:
        w = leaf.to(torch.int32)
    return to_u64(w.reshape(w.shape[0], -1))


def _leaves(state: SimState) -> list:
    """Every fingerprinted leaf of a state, in the fold's order."""
    fields = sorted(f for f in SimState.field_names()
                    if f not in _OBSERVATION_FIELDS)
    return [x for f in fields for x in _sorted_leaves(getattr(state, f))]


def fingerprint_plain(state: SimState) -> torch.Tensor:
    """uint32 fingerprint of every lane of a batched state, as int64 [B]
    in [0, 2^32) (the JAX package's `vmap(fingerprint)`)."""
    leaves = _leaves(state)
    B = state.now.shape[0]
    h = torch.full((B,), FNV_OFFSET, dtype=torch.int64,
                   device=state.now.device)
    for i, leaf in enumerate(leaves):
        w = _words(leaf)
        n = w.shape[1]
        if n:
            mix = (torch.arange(n, dtype=torch.int64, device=w.device)
                   * _GOLDEN + (2 * i + 1)) & MASK32
            # w * mix < 2^64 can leave int64; split w in 16-bit halves so
            # every partial product and the sums stay exact
            lo = ((w & 0xFFFF) * mix) & MASK32
            hi = ((((w >> 16) * mix) & 0xFFFF) << 16)
            lh = ((lo + hi) & MASK32).sum(-1) & MASK32
        else:
            lh = torch.zeros_like(h)
        h = ((h ^ lh) * FNV_PRIME) & MASK32
    return h


MAX_LEAVES = 192   # leaves of one launch (the kernel's parameter block)

# how the kernel reads a leaf's elements as 32-bit words
_KIND = {torch.int32: 0, torch.float32: 0, torch.bool: 1, torch.uint8: 1,
         torch.int8: 2, torch.int16: 3}


class _Leaf(ctypes.Structure):
    """csrc/fingerprint.cu `FpLeaf`, field for field."""
    _fields_ = [("ptr", ctypes.c_void_p), ("n", ctypes.c_int),
                ("kind", ctypes.c_int)]


class _Params(ctypes.Structure):
    """csrc/fingerprint.cu `FpParams`, field for field."""
    _fields_ = [("leaves", _Leaf * MAX_LEAVES), ("out", ctypes.c_void_p),
                ("B", ctypes.c_int), ("n_leaves", ctypes.c_int)]


class _Fingerprint:
    """Callable wrapper: a state on the CPU -> `fingerprint_plain`; on
    CUDA -> the kernel. `launches` counts kernel launches (and nothing
    else); `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            from ..ops.kernels import load
            fn = load("fingerprint").fingerprint_launch
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, state: SimState) -> torch.Tensor:
        dev = state.now.device
        if dev.type == "cpu":
            return fingerprint_plain(state)
        if dev.type != "cuda":
            raise ValueError(f"fingerprint: unsupported device {dev}")
        B = state.now.shape[0]
        leaves = []
        for t in _leaves(state):
            if t.device != dev or t.shape[:1] != (B,):
                raise ValueError(
                    f"fingerprint: a leaf of shape {tuple(t.shape)} on "
                    f"{t.device}; every leaf must be [B={B}, ...] on {dev}")
            if t.dtype not in _KIND:
                raise TypeError(f"fingerprint: leaf dtype {t.dtype} is not "
                                f"one the kernel reads")
            leaves.append(t.contiguous())
        if len(leaves) > MAX_LEAVES:
            raise NotImplementedError(
                f"fingerprint: {len(leaves)} leaves; the kernel takes at "
                f"most {MAX_LEAVES}")
        out = torch.empty((B,), dtype=torch.int64, device=dev)
        p = _Params()
        for i, t in enumerate(leaves):
            p.leaves[i].ptr = t.data_ptr()
            p.leaves[i].n = t.numel() // B if B else 0
            p.leaves[i].kind = _KIND[t.dtype]
        p.out, p.B, p.n_leaves = out.data_ptr(), B, len(leaves)
        fn = self._kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(p), stream)
        if err != 0:
            raise RuntimeError(f"fingerprint: kernel launch failed "
                               f"(cudaError {err})")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return out


fingerprint = _Fingerprint()

# the JAX package's name for the batched form; every function here is
# batched already
batch_fingerprints = fingerprint
