"""The distinct-schedule reduction of a batch: `coverage_digest`, a
hand-written CUDA kernel (csrc/coverage.cu), and `coverage_digest_plain`,
the same function in plain PyTorch.

It replaces the JAX package's `_coverage_digest`
(`madsim_tpu/parallel/stats.py:23`): sort the lanes' two-word schedule
hashes lexicographically as UNSIGNED words, mark each pair's first
occurrence, and pack the distinct pairs first (in sorted order), then the
remaining rows (in sorted order). Returns (pairs int32 [B, 2] holding the
uint32 bit patterns, n int32 0-d tensor: the distinct count). Equal keys
are equal values, so the output is determined element for element and
kernel and plain version agree exactly.

The engine carries uint32 words as int32 bit patterns (core/prng.py), so
a word at or above 2^31 reads as negative: both versions order the words
as unsigned, the plain one through a 64-bit key whose signed order is the
unsigned order of (h0, h1).

`coverage_digest` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. One call enqueues a
memset of its scratch and ten kernels (csrc/coverage.cu: a histogram,
eight radix passes, a compaction); `launches` counts calls that launched
them (and nothing else), `issued` holds the last call's kernel launches
and memsets. A call recorded into a CUDA graph under capture counts in
`captured` instead of `launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.prng import to_u64

TILE = 512         # keys per tile of the kernel's sort and compaction


def sort_key(sched_hash: torch.Tensor) -> torch.Tensor:
    """int64 [B] whose signed order is the unsigned order of (h0, h1):
    h0's top bit flipped, times 2^32, plus h1 as an unsigned word."""
    h0 = sched_hash[:, 0] ^ torch.iinfo(torch.int32).min
    return h0.to(torch.int64) * (1 << 32) + to_u64(sched_hash[:, 1])


def coverage_digest_plain(sched_hash: torch.Tensor):
    """Plain PyTorch form: sched_hash int32 [B, 2] -> (pairs, n)."""
    key = sort_key(sched_hash)
    order = torch.sort(key, stable=True).indices
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    pack = torch.sort((~first).to(torch.int8), stable=True).indices
    pairs = sched_hash[order][pack].contiguous()
    return pairs, first.sum(dtype=torch.int32)


class _CoverageDigest:
    """Callable wrapper: CPU tensors -> `coverage_digest_plain`; CUDA
    tensors -> the kernel. `launches` counts the calls that launched the
    kernels (and nothing else), `captured` those recorded into a CUDA
    graph; `issued` is the last call's count of kernel launches and
    memsets."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self.issued = dict(kernels=0, memsets=0)
        self._lib = None

    def _kernel(self):
        if self._lib is None:
            from .kernels import load
            lib = load("coverage_digest")
            lib.coverage_digest_launch.argtypes = (
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
            lib.coverage_digest_launch.restype = ctypes.c_int
            lib.coverage_digest_scratch_words.argtypes = [ctypes.c_int]
            lib.coverage_digest_scratch_words.restype = ctypes.c_int64
            self._lib = lib
        return self._lib

    def __call__(self, sched_hash: torch.Tensor):
        dev = sched_hash.device
        if sched_hash.ndim != 2 or sched_hash.shape[1] != 2:
            raise ValueError(f"coverage_digest: sched_hash has shape "
                             f"{tuple(sched_hash.shape)}, expected (B, 2)")
        if sched_hash.dtype != torch.int32:
            raise TypeError(f"coverage_digest: sched_hash has dtype "
                            f"{sched_hash.dtype}, expected torch.int32")
        if dev.type == "cpu":
            return coverage_digest_plain(sched_hash)
        if dev.type != "cuda":
            raise ValueError(f"coverage_digest: unsupported device {dev}")
        if not sched_hash.is_contiguous():
            raise ValueError("coverage_digest: sched_hash must be "
                             "contiguous")
        B = sched_hash.shape[0]
        lib = self._kernel()
        pairs = torch.empty((B, 2), dtype=torch.int32, device=dev)
        n = torch.zeros((), dtype=torch.int32, device=dev)
        keys = torch.empty((2, max(B, 1)), dtype=torch.int64, device=dev)
        scratch = torch.empty((lib.coverage_digest_scratch_words(B),),
                              dtype=torch.int32, device=dev)
        issued = (ctypes.c_int * 2)()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.coverage_digest_launch(
                sched_hash.data_ptr(), B, pairs.data_ptr(), n.data_ptr(),
                keys[0].data_ptr(), keys[1].data_ptr(), scratch.data_ptr(),
                issued, stream)
        if err != 0:
            raise RuntimeError(f"coverage_digest: kernel launch failed "
                               f"(cudaError {err})")
        self.issued = dict(kernels=issued[0], memsets=issued[1])
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return pairs, n


coverage_digest = _CoverageDigest()
