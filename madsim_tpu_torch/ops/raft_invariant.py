"""The Raft safety check of one step: `raft_invariant_check`, a
hand-written CUDA kernel (csrc/raft_invariant.cu), and
`raft_invariant_plain`, the same function in plain PyTorch.

It replaces the JAX package's `raft_invariant` (madsim_tpu/models/raft.py
:586, inner `invariant` :619) with its `entry_hash` (:64) and `_pow_table`
(:49), evaluated after every event in every lane:

  Election Safety        two peers lead in one term -> CRASH_TWO_LEADERS
  State Machine Safety   two peers' committed prefixes disagree, compared
                         through prefix digest chains -> CRASH_LOG_MISMATCH
  commit <= log length   -> CRASH_COMMIT_GT_LOG

Each node's chain is chain(t) = P^t * (snap_digest + sum_{k<t} h[k] *
P^-(k+1)), the digest of its absolute prefix [0, snap_len + t), with h[k]
the entry hash of log slot k. `window_slides` picks the JAX package's two
static forms: True compares every pair of peers at their deepest common
committed point (sound for compacting Raft); False compares each peer with
its predecessor in commit order (stable in the node index), which is
sound only while no log window slides. Every product and sum wraps at 32
bits, so kernel and plain version agree exactly.

`raft_invariant_check` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. The kernel
(csrc/raft_invariant.cu) gives each (lane, node) a thread, which reads
its node's log rows 16 bytes an access where `rows_vec4` holds, else 4.
It takes 1 <= L <= MAX_L: up to 32 slots a row in registers, beyond that
(`L > TILE`) in 32-slot tiles, with `block_warps(L)` warps a block so
that the shared prefix rows fit in 48 KB.
`raft_invariant_check.launches` counts kernel launches (a launch recorded
into a CUDA graph under capture counts in `captured` instead).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .kernels import CKernel, on_cpu
from .select import take1

LEADER = 2
DIGEST_P = 1000003     # chain multiplier (odd: invertible mod 2^32)
DIGEST_MIX = 920419823  # column-fold multiplier
DIGEST_P_INV = pow(DIGEST_P, -1, 2 ** 32)

CRASH_TWO_LEADERS = 101
CRASH_LOG_MISMATCH = 102
CRASH_COMMIT_GT_LOG = 103

MAX_FIELDS = 8   # log field columns the kernel takes
MAX_N = 32       # nodes of a lane (one warp lane each)
MAX_L = 192      # log slots of a node
TILE = 32        # slots a thread holds in registers at once
_WARPS = 4       # warps a block (L <= TILE; fewer where L's rows need it)
_SMEM_LIMIT = 48 * 1024

_I32 = torch.int32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 sum or cumsum of int32 values, cut back to int32 mod 2^32
    (the value jax's wrapping int32 reduction gives)."""
    return (x & 0xFFFFFFFF).to(_I32)


def _pow_table(L: int, base: int = DIGEST_P) -> torch.Tensor:
    """[L+1] table of base**k mod 2^32, as two's-complement int32."""
    out = np.empty(L + 1, np.int64)
    v = 1
    for k in range(L + 1):
        out[k] = v if v < 2 ** 31 else v - 2 ** 32
        v = (v * base) % 2 ** 32
    return torch.as_tensor(out.astype(np.int32))


def entry_hash(term_col, field_cols):
    """Mix one log entry's columns into a single int32 word (per slot)."""
    h = term_col
    for c in field_cols:
        h = h * DIGEST_MIX + c
    return h


def raft_invariant_plain(role, term, snap_len, log_len, commit, snap_digest,
                         log_term, log_fields, peer, powP, ipowP,
                         window_slides: bool):
    """Plain PyTorch form of the check. role, term, snap_len, log_len,
    commit, snap_digest int32 [B, N]; log_term and each of the
    `log_fields` columns int32 [B, N, L]; peer bool [N] (the Raft peers;
    other nodes are never checked); powP, ipowP int32 [L+1] (`_pow_table`
    of DIGEST_P and of its inverse). Returns (bad bool [B], code int32
    [B]); code is CRASH_COMMIT_GT_LOG where nothing is bad."""
    B, N = role.shape
    L = log_term.shape[-1]
    dev = role.device
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    leader = (role == LEADER) & peer
    same_term = term[:, :, None] == term[:, None, :]
    two_leaders = (leader[:, :, None] & leader[:, None, :] & same_term
                   & ~eye).flatten(1).any(-1)

    zero = torch.zeros_like(snap_len)
    sl = torch.where(peer, snap_len, zero)
    loglen = torch.where(peer, log_len, zero)
    ec = torch.maximum(torch.where(peer, commit, zero), sl)
    dig = snap_digest
    h = entry_hash(log_term, list(log_fields))                  # [B, N, L]

    # chain(t) = P^t * (snap_digest + sum_{k<t} h[k] * P^{-(k+1)}):
    # the digest of the absolute prefix [0, snap_len + t)
    # an int32 scan keeps the low 32 bits of every prefix sum, which is
    # the wrapped value whatever width the scan accumulates in
    S = torch.cumsum(h * ipowP[1:L + 1], -1, dtype=_I32)
    S = torch.cat([torch.zeros((B, N, 1), dtype=_I32, device=dev), S], -1)
    chain = powP * (dig[:, :, None] + S)                      # [B, N, L+1]
    ts = torch.arange(L + 1, dtype=_I32, device=dev)

    def pick(oh):   # the one chain value a one-hot selects (or 0)
        return _wrap32(torch.where(oh, chain[:, :, None, :] if
                                   oh.ndim == 4 else chain, 0).sum(-1))

    if window_slides:
        pair = peer[:, None] & peer[None, :] & ~eye
        a = torch.minimum(ec[:, :, None], ec[:, None, :])       # [B, N, N]
        t_i = a - sl[:, :, None]
        ok_i = (t_i >= 0) & (t_i <= L)
        oh = torch.clamp(t_i, 0, L)[..., None] == ts            # [B,N,N,L+1]
        ci = pick(oh)
        cj = ci.transpose(1, 2)
        mismatch = (pair & ok_i & ok_i.transpose(1, 2)
                    & (ci != cj)).flatten(1).any(-1)
    else:
        X = pick((ec - sl)[:, :, None] == ts)                   # [B, N]
        imax = torch.full_like(ec, 2 ** 31 - 1)
        order = torch.argsort(torch.where(peer, ec, imax), dim=-1,
                              stable=True).to(_I32)             # [B, N]
        ids = torch.arange(N, dtype=_I32, device=dev)
        rank = torch.where(ids[None, None, :] == order[:, :, None],
                           ids[None, :, None], 0).sum(1).to(_I32)
        ec_sorted = take1(ec, order)
        prev_ec = take1(ec_sorted, torch.clamp(rank - 1, 0, N - 1))
        prev_node = take1(order, torch.clamp(rank - 1, 0, N - 1))
        tY = prev_ec - sl
        okY = (tY >= 0) & (tY <= L)
        Y = pick(torch.clamp(tY, 0, L)[:, :, None] == ts)
        X_prev = take1(X, torch.clamp(prev_node, 0, N - 1))
        link = (peer & take1(peer, torch.clamp(prev_node, 0, N - 1))
                & (rank > 0) & okY)
        mismatch = (link & (Y != X_prev)).any(-1)

    commit_gt = (ec > loglen).any(-1)
    bad = two_leaders | mismatch | commit_gt
    code = torch.where(
        two_leaders, CRASH_TWO_LEADERS,
        torch.where(mismatch, CRASH_LOG_MISMATCH,
                    CRASH_COMMIT_GT_LOG)).to(_I32)
    return bad, code


_NODE_VECTORS = ("role", "term", "snap_len", "log_len", "commit",
                 "snap_digest")


class _Params(ctypes.Structure):
    """csrc/raft_invariant.cu `RaftInvParams`, field for field."""
    _fields_ = (
        [("vecs", ctypes.c_void_p * len(_NODE_VECTORS)),
         ("cols", ctypes.c_void_p * (1 + MAX_FIELDS))]
        + [(n, ctypes.c_void_p) for n in ("peer", "powP", "ipowP", "bad",
                                          "code")]
        + [(n, ctypes.c_int) for n in ("B", "N", "L", "F", "window_slides",
                                       "vec4", "warps")])


def smem_bytes(L: int, warps: int) -> int:
    """A block's shared memory: the two power tables and one prefix row
    of stride (L + 1) | 1 words for each of its threads."""
    return 4 * (2 * (L + 1) + warps * 32 * ((L + 1) | 1))


def block_warps(L: int) -> int:
    """The warps a block of the kernel takes at log length L: four up to
    L = TILE; past it the most (4, 3, 2 or 1) whose rows fit in 48 KB
    (4 at L=64, 3 at L=96, 1 at L=192)."""
    w = _WARPS
    while L > TILE and w > 1 and smem_bytes(L, w) > _SMEM_LIMIT:
        w -= 1
    return w


def rows_vec4(cols, L: int) -> bool:
    """Whether the kernel reads the log rows 16 bytes an access: L a
    multiple of 4 and every column 16-byte aligned (else 4 bytes)."""
    return L % 4 == 0 and all(c.data_ptr() % 16 == 0 for c in cols)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"raft_invariant: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"raft_invariant: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"raft_invariant: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"raft_invariant: {name} must be contiguous")


class _RaftInvariant(CKernel):
    """Callable wrapper: CPU tensors -> `raft_invariant_plain`; CUDA
    tensors -> the kernel. `launches` counts kernel launches (and nothing
    else); `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        super().__init__("raft_invariant", "raft_invariant", _Params)

    def __call__(self, role, term, snap_len, log_len, commit, snap_digest,
                 log_term, log_fields, peer, powP, ipowP,
                 window_slides: bool):
        args = (role, term, snap_len, log_len, commit, snap_digest,
                log_term, tuple(log_fields), peer, powP, ipowP,
                window_slides)
        if on_cpu(role, "raft_invariant"):
            return raft_invariant_plain(*args)
        return self.run(*args)

    def run(self, role, term, snap_len, log_len, commit, snap_digest,
            log_term, log_fields, peer, powP, ipowP, window_slides: bool):
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        dev = role.device
        vecs = (role, term, snap_len, log_len, commit, snap_digest)
        B, N = role.shape
        L = log_term.shape[-1]
        F = len(log_fields)
        if F > MAX_FIELDS:
            raise NotImplementedError(
                f"raft_invariant: the CUDA kernel takes at most "
                f"{MAX_FIELDS} log field columns; got {F}")
        if not 1 <= N <= MAX_N or not 1 <= L <= MAX_L:
            raise NotImplementedError(
                f"raft_invariant: the CUDA kernel supports 1 <= N <= "
                f"{MAX_N} and 1 <= L <= {MAX_L}; got N={N}, L={L}")
        i32 = torch.int32
        checks = [(n, t, i32, (B, N)) for n, t in zip(_NODE_VECTORS, vecs)]
        checks += [("log_term", log_term, i32, (B, N, L))]
        checks += [(f"log_fields[{i}]", c, i32, (B, N, L))
                   for i, c in enumerate(log_fields)]
        checks += [("peer", peer, torch.bool, (N,)),
                   ("powP", powP, i32, (L + 1,)),
                   ("ipowP", ipowP, i32, (L + 1,))]
        for name, t, dt, shape in checks:
            _check(name, t, dt, shape, dev)
        bad = torch.empty((B,), dtype=torch.bool, device=dev)
        code = torch.empty((B,), dtype=i32, device=dev)
        if B == 0:
            return bad, code
        cols = (log_term,) + tuple(log_fields)
        p = _Params(B=B, N=N, L=L, F=F, window_slides=int(bool(
            window_slides)), vec4=int(rows_vec4(cols, L)),
            warps=block_warps(L))
        for i, t in enumerate(vecs):
            p.vecs[i] = t.data_ptr()
        for i, c in enumerate(cols):
            p.cols[i] = c.data_ptr()
        p.peer, p.powP, p.ipowP = peer.data_ptr(), powP.data_ptr(), \
            ipowP.data_ptr()
        p.bad, p.code = bad.data_ptr(), code.data_ptr()
        self._launch(p, dev)
        return bad, code


raft_invariant_check = _RaftInvariant()
