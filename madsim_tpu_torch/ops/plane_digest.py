"""The batch reductions of the plane digests (K10): three hand-written
CUDA kernels (csrc/plane_digest.cu) and their plain PyTorch versions.

    plane_sums(leaves, masks)   every lane reduction of one digest in one
                                launch. Each leaf is (x [B, ...] int32 or
                                None, mask index[, op]):
                                  "sum" (the default) the masked hi/lo
                                  lane sums of `madsim_tpu/parallel/
                                  stats.py:169` `_masked_half_sums`, as
                                  `_profile_digest` (:201),
                                  `_latency_digest` (:391),
                                  `_series_digest` (:509) and
                                  `_attribution_digest` (:665) call it:
                                  an int32 [2, ...] tensor, row 0 the sum
                                  of x >> 16 and row 1 the sum of
                                  x & 0xFFFF over the lanes whose mask
                                  holds, wrapping at 32 bits as the JAX
                                  int32 sums do; None counts 1 a lane
                                  (the mask's lane count);
                                  "max" the max over every lane of
                                  where(mask, x, 0) (`_series_digest`'s
                                  sr_qhw and window_len,
                                  `_attribution_digest`'s slo_target): an
                                  int32 [...] tensor;
                                  "or" the bitwise OR of x over the lanes
                                  whose mask holds (`_series_digest`'s
                                  sr_fault words): an int32 [...] tensor
    lane_p99(lh_e2e)            `_lane_e2e_p99` (:465), the fuzzer's per-
                                lane tail signal: int32 [B], the bucket-
                                CDF lower edge of the p99 of each lane's
                                node-folded e2e histogram (0 for a lane
                                with no completion)
    lane_burst(sr_lat)          `_lane_burst_lat` (:609), the fuzzer's
                                per-lane burst signal: int32 [B], the max
                                over a lane's windows of the bucket-CDF
                                lower edge of each window's p99 (0 for a
                                lane with no completion)

The float32 arithmetic of `lane_p99` and `lane_burst` is fixed in order
(for lane_p99 nodes added from node 0; buckets accumulated from bucket
0, within a window for lane_burst; one rounding an operation), so kernel
and plain version agree exactly; the JAX package's float sums give the
same values wherever they are exact (every partial count below 2^24).

Each wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. `launches` counts kernel
launches and `captured` launches recorded into a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import CKernel, on_cpu

MAX_LEAVES = 16           # leaves a plane_sums launch (csrc kMaxLeaves)
THREADS = 256             # csrc kThreads
LOADS_PER_THREAD = 128    # csrc kLoadsPerThread
P99_LANES = 64            # csrc kP99Lanes: lanes a lane_p99 or lane_burst block
P99_SMEM = 48 * 1024      # the static shared-memory window a block takes
P99_Q = 0.99
SUM_OPS = {"sum": 0, "max": 1, "or": 2}

_I32 = torch.int32
I32_MIN = -2**31


def _leaf(spec):
    """(x, mask index, op) of a plane_sums leaf (op "sum" by default)."""
    return spec if len(spec) == 3 else (spec[0], spec[1], "sum")


def plane_sums_plain(leaves: list, masks: tuple) -> list:
    """The reductions of `plane_sums`, leaf by leaf."""
    out = []
    for spec in leaves:
        x, mi, op = _leaf(spec)
        on = masks[mi]
        if x is None:
            x = torch.ones(on.shape, dtype=_I32, device=on.device)
        on = on.reshape(on.shape + (1,) * (x.ndim - 1))
        if op == "max":
            out.append(torch.where(on, x, 0).amax(0).to(_I32))
        elif op == "or":
            acc = torch.zeros(x.shape[1:], dtype=_I32, device=x.device)
            for bit in range(32):
                m = (1 << bit) if bit < 31 else I32_MIN
                hit = ((x & m) != 0) & on
                acc = acc | torch.where(hit.any(0), m, 0).to(_I32)
            out.append(acc)
        else:
            xm = x * on.to(_I32)
            out.append(torch.stack([(xm >> 16).sum(0),
                                    (xm & 0xFFFF).sum(0)]).to(_I32))
    return out


def _p99_edges(hist: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The p99 lower edge of each float32 histogram [..., LB] (the
    kernels' `p99_edge`): the cumulative count from bucket 0, the first
    bucket j reaching max(ceil(total * q), 1), its lower edge (0, or
    2^(j-1)); 0 for an empty histogram."""
    c = torch.zeros(hist.shape[:-1], dtype=torch.float32,
                    device=hist.device)
    cdf = []
    for k in range(hist.shape[-1]):
        c = c + hist[..., k]
        cdf.append(c)
    cdf = torch.stack(cdf, -1)
    total = cdf[..., -1]
    need = torch.clamp(torch.ceil(total * q), min=1.0)
    j = torch.argmax((cdf >= need[..., None]).to(_I32), -1).to(_I32)
    edge = torch.where(j == 0, 0, torch.ones_like(j) << torch.clamp(
        j - 1, min=0))
    return torch.where(total > 0, edge, 0).to(_I32)


def lane_p99_plain(lh_e2e: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`lane_p99` in plain PyTorch, in the kernel's order of float32
    operations (the nodes folded from node 0); `q` is the float32 0-d
    quantile (0.99)."""
    hist = lh_e2e[:, 0].float()
    for n in range(1, lh_e2e.shape[1]):
        hist = hist + lh_e2e[:, n].float()
    return _p99_edges(hist, q)


def lane_burst_plain(sr_lat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`lane_burst` in plain PyTorch, in the kernel's order of float32
    operations (each window's buckets accumulated from bucket 0); `q` is
    the float32 0-d quantile (0.99)."""
    return _p99_edges(sr_lat.float(), q).amax(-1)


class _SumLeaf(ctypes.Structure):
    """csrc/plane_digest.cu `SumLeaf`, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("M", ctypes.c_int32),
                ("mask", ctypes.c_int32), ("out", ctypes.c_int32),
                ("first_block", ctypes.c_int32), ("op", ctypes.c_int32)]


class _SumsParams(ctypes.Structure):
    """csrc/plane_digest.cu `SumsParams`, field for field."""
    _fields_ = [("leaves", _SumLeaf * MAX_LEAVES),
                ("masks", ctypes.c_void_p * 2), ("out", ctypes.c_void_p),
                ("B", ctypes.c_int64), ("n_leaves", ctypes.c_int32),
                ("blocks", ctypes.c_int32)]


class _P99Params(ctypes.Structure):
    """csrc/plane_digest.cu `P99Params`, field for field."""
    _fields_ = [("hist", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("B", ctypes.c_int64), ("N", ctypes.c_int32),
                ("LB", ctypes.c_int32), ("lanes_per_block", ctypes.c_int32),
                ("q", ctypes.c_float)]


class _BurstParams(ctypes.Structure):
    """csrc/plane_digest.cu `BurstParams`, field for field."""
    _fields_ = [("hist", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("B", ctypes.c_int64), ("W", ctypes.c_int32),
                ("LB", ctypes.c_int32), ("lanes_per_block", ctypes.c_int32),
                ("q", ctypes.c_float)]


def sums_blocks(M: int, B: int) -> int:
    """Blocks of one leaf of M columns over B lanes: a block takes
    (THREADS // min(M, THREADS)) * LOADS_PER_THREAD lanes."""
    run = (THREADS // min(M, THREADS)) * LOADS_PER_THREAD
    return -(-B // run)


def sums_params(leaves: list, masks: tuple, out: torch.Tensor, B: int):
    """The parameter block of one plane_sums launch over `leaves`
    ([(x or None, mask index[, op])], contiguous), writing the flat int32
    `out` (zeroed): a sum leaf's hi row, then its lo row; a max leaf's
    row biased by 2^31 (0 stands for int32 min); an or leaf's row."""
    p = _SumsParams(out=out.data_ptr(), B=B, n_leaves=len(leaves))
    for i, m in enumerate(masks):
        p.masks[i] = m.data_ptr() if m is not None else None
    first = off = 0
    for i, spec in enumerate(leaves):
        x, mi, op = _leaf(spec)
        M = 1 if x is None else x.numel() // B
        p.leaves[i] = _SumLeaf(None if x is None else x.data_ptr(), M, mi,
                               off, first, SUM_OPS[op])
        first += sums_blocks(M, B)
        off += (2 if op == "sum" else 1) * M
    p.blocks = first
    return p


def staged_lanes(words: int) -> int:
    """Lanes a lane_p99 or lane_burst block stages in shared memory: as
    many lanes of `words` words each (the padded rows, and lane_burst's
    edge words) as fit its window, at most P99_LANES."""
    return max(1, min(P99_LANES, P99_SMEM // (4 * words)))


class _PlaneSums(CKernel):
    """Callable wrapper: CPU tensors -> `plane_sums_plain`; CUDA tensors
    -> the kernel."""

    def __init__(self):
        super().__init__("plane_digest", "plane_sums", _SumsParams)

    def __call__(self, leaves: list, masks: tuple) -> list:
        if on_cpu(masks[0], "plane_sums"):
            return plane_sums_plain(leaves, masks)
        return self.run(leaves, masks)

    def run(self, leaves: list, masks: tuple) -> list:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        m0 = masks[0]
        dev, B = m0.device, m0.shape[0]
        if not 1 <= len(leaves) <= MAX_LEAVES or len(masks) != 2:
            raise ValueError(f"plane_sums: {len(leaves)} leaves and "
                             f"{len(masks)} masks; the kernel takes 1 to "
                             f"{MAX_LEAVES} leaves and two masks")
        for i, m in enumerate(masks):
            if m is not None and (m.dtype != torch.bool or m.device != dev
                                  or tuple(m.shape) != (B,)
                                  or not m.is_contiguous()):
                raise ValueError(f"plane_sums: mask {i} is {m.dtype} "
                                 f"{tuple(m.shape)} on {m.device}; the "
                                 f"kernel takes a contiguous bool ({B},) "
                                 f"on {dev}")
        shapes, ops_, n_out = [], [], 0
        for spec in leaves:
            x, mi, op = _leaf(spec)
            if mi not in (0, 1) or masks[mi] is None:
                raise ValueError(f"plane_sums: mask index {mi} names no "
                                 f"mask")
            if op not in SUM_OPS or (x is None and op != "sum"):
                raise ValueError(f"plane_sums: op {op!r} (on "
                                 f"{'no leaf' if x is None else 'a leaf'}"
                                 f"); the kernel takes sum, max and or "
                                 f"of a leaf, and sum of none")
            ops_.append(op)
            if x is None:
                shapes.append(())
                n_out += 2
                continue
            if x.dtype != _I32 or x.device != dev or x.ndim < 1 \
                    or x.shape[0] != B or not x.is_contiguous() \
                    or x.numel() == 0:
                raise ValueError(
                    f"plane_sums: a leaf is {x.dtype} {tuple(x.shape)} on "
                    f"{x.device} (contiguous: {x.is_contiguous()}); the "
                    f"kernel takes a contiguous, non-empty int32 [{B}, ...] "
                    f"on {dev}")
            shapes.append(tuple(x.shape[1:]))
            n_out += (2 if op == "sum" else 1) * (x.numel() // B)
        if not B and "max" in ops_:
            raise ValueError("plane_sums: a max over no lane")
        out = torch.zeros(n_out, dtype=_I32, device=dev)
        if B:
            self._launch(sums_params(leaves, masks, out, B), dev)
        res, off = [], 0
        for shape, op in zip(shapes, ops_):
            m = int(torch.Size(shape).numel())
            if op == "sum":
                res.append(out[off:off + 2 * m].view((2,) + shape))
            elif op == "max":          # undo the bias of the unsigned max
                res.append((out[off:off + m] ^ I32_MIN).view(shape))
            else:
                res.append(out[off:off + m].view(shape))
            off += (2 if op == "sum" else 1) * m
        return res


class _LaneP99(CKernel):
    """Callable wrapper: CPU tensors -> `lane_p99_plain`; CUDA tensors ->
    the kernel."""

    def __init__(self):
        super().__init__("plane_digest", "lane_p99", _P99Params)
        self._q = {}

    def q(self, dev) -> torch.Tensor:
        """The float32 quantile as a 0-d tensor on `dev`, built once."""
        key = str(dev)
        if key not in self._q:
            self._q[key] = torch.tensor(P99_Q, dtype=torch.float32,
                                        device=dev)
        return self._q[key]

    def __call__(self, lh_e2e: torch.Tensor) -> torch.Tensor:
        if on_cpu(lh_e2e, "lane_p99"):
            return lane_p99_plain(lh_e2e, self.q(lh_e2e.device))
        return self.run(lh_e2e)

    def run(self, lh_e2e: torch.Tensor) -> torch.Tensor:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        if lh_e2e.dtype != _I32 or lh_e2e.ndim != 3 \
                or not lh_e2e.is_contiguous() or 0 in lh_e2e.shape[1:]:
            raise ValueError(
                f"lane_p99: lh_e2e is {lh_e2e.dtype} "
                f"{tuple(lh_e2e.shape)} (contiguous: "
                f"{lh_e2e.is_contiguous()}); the kernel takes a "
                f"contiguous int32 [B, N, LB] with N, LB >= 1")
        B, N, LB = lh_e2e.shape
        if 4 * (N * LB + 1) > P99_SMEM:
            raise ValueError(f"lane_p99: a lane's {N} x {LB} histogram "
                             f"does not fit a block's {P99_SMEM} bytes")
        dev = lh_e2e.device
        out = torch.empty(B, dtype=_I32, device=dev)
        if B:
            p = _P99Params(hist=lh_e2e.data_ptr(), out=out.data_ptr(), B=B,
                           N=N, LB=LB,
                           lanes_per_block=staged_lanes(N * LB + 1),
                           q=P99_Q)
            self._launch(p, dev)
        return out


class _LaneBurst(CKernel):
    """Callable wrapper: CPU tensors -> `lane_burst_plain`; CUDA tensors
    -> the kernel."""

    def __init__(self):
        super().__init__("plane_digest", "lane_burst", _BurstParams)

    def __call__(self, sr_lat: torch.Tensor) -> torch.Tensor:
        if on_cpu(sr_lat, "lane_burst"):
            return lane_burst_plain(sr_lat, lane_p99.q(sr_lat.device))
        return self.run(sr_lat)

    def run(self, sr_lat: torch.Tensor) -> torch.Tensor:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        if sr_lat.dtype != _I32 or sr_lat.ndim != 3 \
                or not sr_lat.is_contiguous() or 0 in sr_lat.shape[1:]:
            raise ValueError(
                f"lane_burst: sr_lat is {sr_lat.dtype} "
                f"{tuple(sr_lat.shape)} (contiguous: "
                f"{sr_lat.is_contiguous()}); the kernel takes a "
                f"contiguous int32 [B, W, LB] with W, LB >= 1")
        B, W, LB = sr_lat.shape
        if 4 * W * (LB + 2) > P99_SMEM:
            raise ValueError(f"lane_burst: a lane's {W} x {LB} windows do "
                             f"not fit a block's {P99_SMEM} bytes")
        dev = sr_lat.device
        out = torch.empty(B, dtype=_I32, device=dev)
        if B:
            p = _BurstParams(hist=sr_lat.data_ptr(), out=out.data_ptr(),
                             B=B, W=W, LB=LB,
                             lanes_per_block=staged_lanes(W * (LB + 2)),
                             q=P99_Q)
            self._launch(p, dev)
        return out


plane_sums = _PlaneSums()
lane_p99 = _LaneP99()
lane_burst = _LaneBurst()
