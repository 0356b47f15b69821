"""Batch analytics: what the supervisor reads back from a seed sweep.

The counterpart of `madsim_tpu.parallel.stats`, for the reductions the
search entry points read: the per-trajectory schedule hashes
(`sched_hash_u64`), the on-device distinct-schedule reduction explore()
asks for every round (`coverage_digest`, through the kernel of
ops/coverage.py) with its host half (`digest_hashes`,
`distinct_schedules`), and the host-side first-divergence slots the
corpus reads from prefix sketches. The per-lane latency and burst signals
(`lane_e2e_p99`, `latency_brief`, `lane_burst`) return None when their
observation plane is compiled out, as the JAX functions do; this port
has not ported those planes yet (ROADMAP P11.3, P11.5), so a state that
carries one is refused.
"""

from __future__ import annotations

import numpy as np

from ..ops.coverage import coverage_digest as _coverage_digest


def coverage_digest(state):
    """Launch the device-side coverage reduction; returns DEVICE tensors
    (pairs int32 [B, 2] of uint32 bit patterns, n int32) without
    blocking, so the caller can queue more work before reading either."""
    return _coverage_digest(state.sched_hash)


def digest_hashes(pairs, n) -> np.ndarray:
    """Materialize a coverage digest host-side: only the `n` distinct rows
    cross to the host, combined into uint64 — the value domain of
    `sched_hash_u64`, already deduplicated and sorted."""
    top = pairs[:int(n)].cpu().numpy().view(np.uint32).astype(np.uint64)
    return (top[:, 0] << np.uint64(32)) | top[:, 1]


def distinct_schedules(state) -> int:
    """Distinct dispatch-order count via the on-device reduction; only one
    int32 crosses to the host."""
    _, n = coverage_digest(state)
    return int(n)


def sched_hash_u64(state) -> np.ndarray:
    """The two uint32 sched_hash words of each trajectory as one uint64."""
    h = state.sched_hash.cpu().numpy().view(np.uint32).astype(np.uint64)
    return (h[..., 0] << np.uint64(32)) | h[..., 1]


def first_divergence_slots(sketches, consensus=None) -> np.ndarray:
    """Per-lane first-divergence slot of a [B, S] prefix-sketch array: the
    first slot where a lane's sketch differs from the consensus prefix —
    by default the batch's per-slot modal value (ties to the smallest
    value) — or S where it never does. Host numpy, int64 [B]."""
    sk = np.asarray(sketches)
    B, S = sk.shape
    if S == 0:
        return np.zeros(B, np.int64)
    if consensus is None:
        consensus = np.zeros(S, sk.dtype)
        for j in range(S):
            vals, counts = np.unique(sk[:, j], return_counts=True)
            consensus[j] = vals[np.argmax(counts)]
    differs = sk != np.asarray(consensus)[None, :]
    return np.where(differs.any(1), differs.argmax(1), S).astype(np.int64)


def _refuse_latency_plane(state) -> None:
    lh = state.lh_e2e
    if lh.ndim == 3 and lh.shape[1] > 0 and lh.shape[2] > 0:
        raise NotImplementedError(
            "the latency plane is not ported to madsim_tpu_torch yet "
            "(ROADMAP P11.3)")


def lane_e2e_p99(state) -> np.ndarray | None:
    """Per-lane end-to-end p99 off the latency plane; None when the plane
    is compiled out."""
    _refuse_latency_plane(state)
    return None


def latency_brief(state) -> dict | None:
    """The latency rollup of observer records; None when the plane is
    compiled out."""
    _refuse_latency_plane(state)
    return None


def lane_burst(state) -> np.ndarray | None:
    """Per-lane deepest per-window spike off the series plane; None when
    the plane is compiled out."""
    sq = state.sr_qhw
    if sq.ndim == 2 and sq.shape[1] > 0:
        raise NotImplementedError(
            "the series plane is not ported to madsim_tpu_torch yet "
            "(ROADMAP P11.5)")
    return None
