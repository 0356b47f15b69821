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
PyTorch, for states on the CPU; on any other device it raises. The kernel
takes a tile of T lanes a block (`fp_tile`), each leaf's tile in its
region of shared memory (`fp_layout`), copied 16, 8 or 4 bytes an access
as the leaf's address allows (`fp_chunk`).
`fingerprint.launches` counts kernel launches (a launch recorded into a
CUDA graph under capture counts in `captured` instead).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.prng import MASK32, to_u64
from ..core.state import TRACE_FIELDS, SimState
from ..ops.kernels import SMEM_MAX, CKernel, on_cpu, up16

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

# how the kernel reads a leaf's elements as 32-bit words, and their bytes
_KIND = {torch.int32: 0, torch.float32: 0, torch.bool: 1, torch.uint8: 1,
         torch.int8: 2, torch.int16: 3}
_ESIZE = (4, 1, 1, 2)

# The kernel's tile (csrc/fingerprint.cu): T <= 32 lanes a block, the lh
# table and every leaf's elements of the tile in shared memory.
TILES = (32, 16, 8, 4, 2, 1)    # largest first
SMEM_TARGET = 60 * 1024         # the largest tile within this is taken

def fp_layout(leaves, T: int) -> tuple:
    """(byte offset of each leaf's region, total bytes) of a T-lane tile's
    shared memory (csrc/fingerprint.cu `layout_ok` checks the same): the
    lh table (4 bytes a leaf and lane), then each leaf's T * n elements,
    every region 16-byte aligned. `leaves`: (n, kind) pairs."""
    off = up16(4 * T * len(leaves))
    offs = []
    for n, kind in leaves:
        offs.append(off)
        off += up16(T * n * _ESIZE[kind])
    return offs, off


def fp_tile(leaves) -> int:
    """The kernel's tile for these (n, kind) leaves: the largest of TILES
    whose layout fits SMEM_TARGET, else the largest that fits the card; a
    state no one-lane tile fits is refused."""
    fits = [T for T in TILES if fp_layout(leaves, T)[1] <= SMEM_MAX]
    if not fits:
        raise NotImplementedError(
            f"fingerprint: one lane takes {fp_layout(leaves, 1)[1]} bytes "
            f"of shared memory; the card gives a block {SMEM_MAX}")
    within = [T for T in fits if fp_layout(leaves, T)[1] <= SMEM_TARGET]
    return (within or fits)[0]


def fp_chunk(ptr: int, tile_bytes: int) -> int:
    """The kernel's copy width for a leaf at `ptr` whose tile holds
    `tile_bytes`: the widest of 16, 8 and 4 bytes dividing both (so every
    tile's range starts aligned), 0 (an element at a time) if none does."""
    for c in (16, 8, 4):
        if ptr % c == 0 and tile_bytes % c == 0:
            return c
    return 0


class _Leaf(ctypes.Structure):
    """csrc/fingerprint.cu `FpLeaf`, field for field."""
    _fields_ = [("ptr", ctypes.c_void_p), ("n", ctypes.c_int),
                ("kind", ctypes.c_uint8), ("chunk", ctypes.c_uint8),
                ("pad", ctypes.c_uint16)]


class _Params(ctypes.Structure):
    """csrc/fingerprint.cu `FpParams`, field for field."""
    _fields_ = [("leaves", _Leaf * MAX_LEAVES),
                ("off", ctypes.c_int * MAX_LEAVES), ("out", ctypes.c_void_p),
                ("B", ctypes.c_int), ("n_leaves", ctypes.c_int),
                ("tile", ctypes.c_int), ("smem", ctypes.c_int)]


class _Fingerprint(CKernel):
    """Callable wrapper: a state on the CPU -> `fingerprint_plain`; on
    CUDA -> the kernel. `launches` counts kernel launches (and nothing
    else); `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        super().__init__("fingerprint", "fingerprint", _Params)

    def __call__(self, state: SimState) -> torch.Tensor:
        if on_cpu(state.now, "fingerprint"):
            return fingerprint_plain(state)
        return self.run(state)

    def run(self, state: SimState) -> torch.Tensor:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        dev = state.now.device
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
        if B == 0:
            return out
        meta = [(t.numel() // B, _KIND[t.dtype]) for t in leaves]
        tile = fp_tile(meta)
        offs, smem = fp_layout(meta, tile)
        p = _Params(B=B, n_leaves=len(leaves), tile=tile, smem=smem)
        for i, (t, (n, kind)) in enumerate(zip(leaves, meta)):
            p.leaves[i].ptr = t.data_ptr()
            p.leaves[i].n = n
            p.leaves[i].kind = kind
            p.leaves[i].chunk = fp_chunk(t.data_ptr(),
                                         tile * n * _ESIZE[kind])
            p.off[i] = offs[i]
        p.out = out.data_ptr()
        self._launch(p, dev)
        return out


fingerprint = _Fingerprint()

# the JAX package's name for the batched form; every function here is
# batched already
batch_fingerprints = fingerprint
