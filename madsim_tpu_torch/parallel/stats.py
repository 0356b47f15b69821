"""Batch analytics: what the supervisor reads back from a seed sweep.

The counterpart of `madsim_tpu.parallel.stats`: the per-trajectory
schedule hashes (`sched_hash_u64`), the on-device distinct-schedule
reduction explore() asks for every round (`coverage_digest`, through the
kernel of ops/coverage.py) with its host half (`digest_hashes`,
`distinct_schedules`), the prefix sketches' consensus and first
divergence (`consensus_allreduce`, `first_divergence_slots`,
`divergence_profile`), the plane digests (`profile_counters`,
`latency_counters`, `series_counters`, `attribution_counters` and their
briefs), whose lane reductions are one `plane_sums` launch a digest
(K10, ops/plane_digest.py), the per-lane tail signals the fuzzer reads
(`lane_e2e_p99`, the `lane_p99` kernel; `lane_burst`, the `lane_burst`
kernel), and the fleet report `summarize`.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..ops.coverage import coverage_digest as _coverage_digest
from ..ops.plane_digest import lane_burst as _lane_burst_kernel
from ..ops.plane_digest import lane_p99 as _lane_p99_kernel
from ..ops.plane_digest import plane_sums


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


def _consensus_modal(sketches: torch.Tensor) -> torch.Tensor:
    """Per-slot modal value of a [B, S] sketch batch held as int32 bits,
    ties to the smallest uint32 value (the JAX package's
    `_consensus_modal`: a sort of each slot column and run lengths from
    searchsorted). int64 [S] uint32 values. Plain PyTorch (ROADMAP §2:
    K10 work still to do)."""
    v = torch.sort((sketches.to(torch.int64) & 0xFFFFFFFF), 0).values.T
    v = v.contiguous()                                     # [S, B]
    counts = (torch.searchsorted(v, v, right=True)
              - torch.searchsorted(v, v, right=False))
    # the first maximal count: v ascends, so it is the smallest modal
    return v.gather(1, torch.argmax(counts, 1, keepdim=True))[:, 0]


def consensus_allreduce(sketches) -> np.ndarray:
    """The batch-global per-slot modal value of a [B, S] prefix-sketch
    batch (ties to the smallest), computed where the sketches lie:
    bit-compatible with `first_divergence_slots(consensus=None)`. Takes
    the state's int32-bit tensor or uint32 values; returns uint32 [S]."""
    if isinstance(sketches, torch.Tensor):
        sk = sketches
    else:
        sk = torch.as_tensor(np.asarray(sketches, np.uint32).view(np.int32))
    return _consensus_modal(sk).cpu().numpy().astype(np.uint32)


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


def divergence_profile(state) -> dict | None:
    """First-divergence-step percentiles across a sweep, from the prefix
    sketches (cfg.sketch_slots > 0): when the batch's schedules split.
    None when the sketch is compiled out or the state is unbatched.
    Steps are upper bounds: a lane whose first divergent slot is j
    matched the consensus through (j) * sketch_every dispatches."""
    sk = getattr(state, "cov_sketch", None)
    if sk is None or sk.ndim != 2 or sk.shape[1] == 0:
        return None
    sk = sk.cpu().numpy().view(np.uint32)
    every = int(np.atleast_1d(state.sketch_every.cpu().numpy())
                .reshape(-1)[0])
    first = first_divergence_slots(sk)
    S = sk.shape[1]
    div = first < S
    out = dict(slots=S, every=every, batch=int(len(first)),
               diverged=int(div.sum()))
    if div.any():
        steps = (first[div] + 1) * every
        out.update(
            p10=int(np.percentile(steps, 10)),
            p50=int(np.percentile(steps, 50)),
            p90=int(np.percentile(steps, 90)),
            mean=round(float(steps.mean()), 1))
    return out


I32_MAX = 2**31 - 1


def _masked_lane_pcts(x, on, n, qs=(50, 90, 100)):
    """Per-lane percentiles of an int32 [B] metric over the masked-ON
    lanes: sort with masked lanes pushed to int32 max and index at the
    on-lane count; an all-masked batch reads 0 (q=100 = max). Plain
    PyTorch (ROADMAP §2: the sort is K10 work still to do)."""
    v = torch.sort(torch.where(on, x, I32_MAX)).values
    B = x.shape[0]
    out = [v[min(max((max(n, 1) - 1) * q // 100, 0), B - 1)] for q in qs]
    return torch.stack(out) if n > 0 else torch.zeros(
        len(qs), dtype=x.dtype, device=x.device)

# the profiler digest's counter leaves, in the order its sums come back
_PF_SUMS = ("dispatch", "busy", "kill", "restart", "drop", "delay",
            "now_sum", "steps_sum")


def _profile_digest(state) -> dict:
    """Device-side reduction of the sim-profiler counter plane: batch
    sums over the profiled lanes (one `plane_sums` launch: the lane count
    and the wide hi/lo sums of every counter) and per-lane percentiles
    (plain PyTorch), as the JAX package's `_profile_digest`."""
    on = state.pf_on
    sums = plane_sums(
        [(None, 0), (state.pf_dispatch, 0), (state.pf_busy, 0),
         (state.pf_kill, 0), (state.pf_restart, 0), (state.pf_drop, 0),
         (state.pf_delay, 0), (state.now, 0), (state.steps, 0)],
        (on, None))
    n = int(_wide(sums[0]))
    busy = state.pf_busy.float()
    total = busy[:, 0]
    for k in range(1, busy.shape[1]):     # node 0 first
        total = total + busy[:, k]
    busy_total = torch.clamp(total, 0, float(2**31 - 256)).to(torch.int32)
    out = dict(lanes=torch.tensor(n, dtype=torch.int32),
               **dict(zip(_PF_SUMS, sums[1:])))
    out.update(qmax_pct=_masked_lane_pcts(state.pf_qmax, on, n),
               steps_pct=_masked_lane_pcts(state.steps, on, n),
               now_pct=_masked_lane_pcts(state.now, on, n),
               busy_total_pct=_masked_lane_pcts(busy_total, on, n))
    return out


def _compiled_in(leaf, ndim: int) -> bool:
    """Whether a batched plane leaf is there (not zero-size)."""
    return (leaf is not None and leaf.ndim == ndim
            and all(d > 0 for d in leaf.shape[1:]))


def profile_digest(state):
    """Launch the device-side profiler reduction over a batched state;
    returns a dict of device tensors, or None when the counter plane is
    compiled out (cfg.profile=False) or the state is unbatched."""
    if not _compiled_in(getattr(state, "pf_busy", None), 2):
        return None
    return _profile_digest(state)


# confirmed-digest memo: (digest name, (leaf id, leaf version)...) ->
# (leaf refs, result). The held references keep the ids from being
# reused and the version counters change with every in-place write, so a
# hit is the same tensors with the same contents; bounded LRU.
_DIGEST_MEMO: OrderedDict = OrderedDict()
_DIGEST_MEMO_CAP = 8


def _agree_twice(first, again, key_of, what: str):
    """`first` confirmed by a second agreeing invocation of `again` (a
    third breaks a tie; three distinct results raise) — the JAX package's
    utils/verify.agree_twice."""
    second = again()
    if key_of(second) == key_of(first):
        return first
    third = again()
    if key_of(third) != key_of(second):
        raise RuntimeError(f"{what} does not replay deterministically — "
                           "three invocations disagree")
    return second


def _confirmed_digest(digest, state, leaves) -> dict | None:
    """A digest materialized on the host, confirmed by two agreeing
    invocations and memoized on the identity and version of its input
    leaves, as the JAX package's `_confirmed_digest`."""
    key = (getattr(digest, "__name__", str(digest)),
           tuple((id(t), t._version) for t in leaves))
    hit = _DIGEST_MEMO.get(key)
    if hit is not None:
        _DIGEST_MEMO.move_to_end(key)
        return hit[1]
    d = digest(state)
    if d is None:
        return None

    def host(dd):
        return {k: v.cpu().numpy() for k, v in dd.items()}

    out = _agree_twice(
        host(d), lambda: host(digest(state)),
        key_of=lambda r: tuple((k, r[k].tobytes()) for k in sorted(r)),
        what="masked-digest reduction")
    _DIGEST_MEMO[key] = (tuple(leaves), out)
    while len(_DIGEST_MEMO) > _DIGEST_MEMO_CAP:
        _DIGEST_MEMO.popitem(last=False)
    return out


def _wide(a) -> np.ndarray:
    """hi * 2^16 + lo of a [2, ...] half-sum pair, exact in int64."""
    a = np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                   ).astype(np.int64)
    return a[0] * 65536 + a[1]


def profile_counters(state) -> dict | None:
    """`profile_digest` on the host: plain numpy / int values (the
    16-bit half-sums recombined into exact int64s), None when the plane
    is compiled out. Run-twice confirmed and memoized."""
    if not _compiled_in(getattr(state, "pf_busy", None), 2):
        return None
    d = _confirmed_digest(
        profile_digest, state,
        (state.pf_dispatch, state.pf_busy, state.pf_kill,
         state.pf_restart, state.pf_qmax, state.pf_drop,
         state.pf_delay, state.pf_on, state.steps, state.now))
    if d is None:
        return None
    return dict(
        lanes=int(d["lanes"]),
        dispatch=_wide(d["dispatch"]),
        busy=_wide(d["busy"]), kill=_wide(d["kill"]),
        restart=_wide(d["restart"]),
        drop=int(_wide(d["drop"])), delay=int(_wide(d["delay"])),
        now_sum=int(_wide(d["now_sum"])),
        steps_sum=int(_wide(d["steps_sum"])),
        qmax_p50=int(d["qmax_pct"][0]), qmax_p90=int(d["qmax_pct"][1]),
        qmax_max=int(d["qmax_pct"][2]),
        steps_p50=int(d["steps_pct"][0]), steps_p90=int(d["steps_pct"][1]),
        steps_max=int(d["steps_pct"][2]),
        now_p50=int(d["now_pct"][0]), now_p90=int(d["now_pct"][1]),
        now_max=int(d["now_pct"][2]),
        busy_total_p50=int(d["busy_total_pct"][0]),
        busy_total_p90=int(d["busy_total_pct"][1]),
        busy_total_max=int(d["busy_total_pct"][2]),
    )


# latency-plane bucket edges: bucket j of a cfg.latency_hist histogram
# holds latencies in [edge(j), edge(j+1)) ticks with edge(0) = 0,
# edge(j) = 2^(j-1) (the step's exact integer bucketing rule)
def latency_bucket_edges(buckets: int) -> np.ndarray:
    """Lower edge of each log2 latency bucket, in ticks (int64)."""
    return np.asarray([0] + [1 << j for j in range(buckets - 1)], np.int64)


def bucket_lower_edge(b: torch.Tensor) -> torch.Tensor:
    """Lower edge (ticks) of log2 bucket index `b` (int32 tensor): 0 for
    bucket 0, 2^(b-1) otherwise. The one encoding of the bucket->edge
    rule: `_hist_quantiles` and `harness.slo` both use it."""
    return torch.where(b == 0, 0, torch.ones_like(b) << torch.clamp(
        b - 1, min=0))


def _hist_quantiles(hist_f: torch.Tensor, qs) -> torch.Tensor:
    """Bucket-CDF quantile estimates for a [..., LB] float32 histogram:
    for each q the lower edge of the bucket holding the ceil(q·total)-th
    sample (a lower bound on the true quantile); an empty histogram reads
    0. int32 [..., Q]. Plain PyTorch (ROADMAP §2: K10 work still to
    do)."""
    cdf = torch.cumsum(hist_f, -1)
    total = cdf[..., -1:]
    out = []
    for q in qs:
        need = torch.ceil(total * torch.tensor(q, dtype=torch.float32,
                                               device=hist_f.device))
        b = torch.argmax((cdf >= torch.clamp(need, min=1.0)).to(
            torch.int32), -1).to(torch.int32)
        out.append(torch.where(total[..., 0] > 0, bucket_lower_edge(b), 0))
    return torch.stack(out, -1).to(torch.int32)


_LAT_QS = (0.50, 0.90, 0.99, 0.999)
_LAT_QNAMES = ("p50", "p90", "p99", "p999")


def _latency_digest(state) -> dict:
    """Device-side reduction of the SLO latency plane: the merged
    histograms' exact wide sums over the recorded lanes (one
    `plane_sums` launch) and the quantile estimates of the merged bucket
    CDFs, as the JAX package's `_latency_digest`. The CDFs are float32
    of the exact merged counts (the JAX package's float32 lane sums give
    the same counts wherever they are exact, below 2^24)."""
    on = state.lh_on
    sums = plane_sums([(None, 0), (state.lh_sojourn, 0), (state.lh_e2e, 0),
                       (state.lh_slo_miss, 0)], (on, None))
    n, soj, e2e, miss = sums

    def merged(pair):        # exact [N, LB] merged counts as float32
        hi, lo = pair[0].to(torch.int64), pair[1].to(torch.int64)
        return hi * 65536 + lo

    soj_m, e2e_m = merged(soj), merged(e2e)
    return dict(
        lanes=(n[0].to(torch.int64) * 65536 + n[1]).to(torch.int32),
        sojourn=soj, e2e=e2e, slo_miss=miss,
        sojourn_q=_hist_quantiles(soj_m.sum(0).float(), _LAT_QS),
        e2e_q=_hist_quantiles(e2e_m.sum(0).float(), _LAT_QS),
        e2e_p99_by_node=_hist_quantiles(e2e_m.float(), (0.99,))[..., 0])


def _latency_on(state) -> bool:
    return _compiled_in(getattr(state, "lh_e2e", None), 3)


def latency_digest(state):
    """Launch the device-side latency reduction over a batched state;
    returns a dict of device tensors, or None when the plane is compiled
    out (cfg.latency_hist == 0) or the state is unbatched."""
    return _latency_digest(state) if _latency_on(state) else None


def latency_counters(state) -> dict | None:
    """`latency_digest` on the host: exact merged histograms (int64
    [N, LB]), total SLO misses, and the quantile estimates in ticks. None
    when the plane is compiled out. Run-twice confirmed and memoized."""
    if not _latency_on(state):
        return None
    d = _confirmed_digest(
        latency_digest, state,
        (state.lh_sojourn, state.lh_e2e, state.lh_slo_miss, state.lh_on))
    if d is None:
        return None
    out = dict(
        lanes=int(d["lanes"]),
        sojourn_hist=_wide(d["sojourn"]),
        e2e_hist=_wide(d["e2e"]),
        slo_miss_by_node=_wide(d["slo_miss"]).tolist(),
        slo_miss=int(_wide(d["slo_miss"]).sum()),
        e2e_p99_by_node=d["e2e_p99_by_node"].tolist(),
    )
    for i, nm in enumerate(_LAT_QNAMES):
        out[f"sojourn_{nm}"] = int(d["sojourn_q"][i])
        out[f"e2e_{nm}"] = int(d["e2e_q"][i])
    return out


def _lane_e2e_p99(lh_e2e: torch.Tensor) -> torch.Tensor:
    """Per-lane p99 estimate of each lane's own e2e histogram (nodes
    folded): int32 [B] bucket lower edges, 0 for a lane with no
    completion — the `lane_p99` kernel on CUDA."""
    return _lane_p99_kernel(lh_e2e)


def lane_e2e_p99(state) -> np.ndarray | None:
    """Host-side per-lane p99 (ticks) off the latency plane, the tail
    signal the fuzzer's corpus energy reads (search/corpus.py
    lat_bonus); None when the plane is compiled out."""
    if not _latency_on(state):
        return None
    return _lane_e2e_p99(state.lh_e2e).cpu().numpy()


def latency_brief(state) -> dict | None:
    """The small latency rollup observer records carry: cluster
    p50/p99/p999, sojourn p99, SLO misses, the target and the
    completions. None when the plane is compiled out."""
    c = latency_counters(state)
    if c is None:
        return None
    return dict(lanes=c["lanes"],
                e2e_p50=c["e2e_p50"], e2e_p99=c["e2e_p99"],
                e2e_p999=c["e2e_p999"], sojourn_p99=c["sojourn_p99"],
                slo_miss=c["slo_miss"],
                slo_target=int(np.asarray(
                    state.slo_target.cpu().numpy()).max()),
                completions=int(c["e2e_hist"].sum()))


# series-plane fault-marker bits a digest reports (core/types.py SRF_*:
# 7 bits today; the JAX digest ORs 8)
_SRF_BITS = 8


def series_leaves(state):
    """The series digest's `plane_sums` operands (leaves, masks): the
    lane count, the dominant window_len (max), the per-window sums, the
    sr_qhw max, the sr_fault OR and, with the latency plane, sr_lat."""
    leaves = [(None, 0), (state.window_len, 0, "max"),
              (state.sr_dispatch, 0), (state.sr_busy, 0),
              (state.sr_drop, 0), (state.sr_dup, 0), (state.sr_complete, 0),
              (state.sr_slo_miss, 0), (state.sr_qhw, 0, "max"),
              (state.sr_fault, 0, "or")]
    if _compiled_in(getattr(state, "sr_lat", None), 3):
        leaves.append((state.sr_lat, 0))
    return leaves, (state.sr_on, None)


def _series_digest(state) -> dict:
    """Device-side reduction of the windowed series plane: one
    `plane_sums` launch over the recording lanes (`series_leaves`), and
    the per-window p99 of the merged latency histograms (plain,
    [W, LB]), as the JAX package's `_series_digest`. The p99 reads
    float32 of the exact merged counts (the JAX float32 lane sums give
    the same counts wherever they are exact, below 2^24)."""
    has_lat = _compiled_in(getattr(state, "sr_lat", None), 3)
    r = plane_sums(*series_leaves(state))
    out = dict(lanes=(r[0][0].to(torch.int64) * 65536 + r[0][1]).to(
        torch.int32), window_len=r[1], dispatch=r[2], busy=r[3], drop=r[4],
        dup=r[5], complete=r[6], slo_miss=r[7], qhw=r[8],
        fault=r[9] & ((1 << _SRF_BITS) - 1))
    if has_lat:
        lat = r[10][0].to(torch.int64) * 65536 + r[10][1]
        out["lat"] = r[10]
        out["e2e_p99_by_window"] = _hist_quantiles(lat.float(),
                                                   (0.99,))[..., 0]
    return out


def _series_on(state) -> bool:
    return _compiled_in(getattr(state, "sr_qhw", None), 2)


def series_digest(state):
    """Launch the device-side series reduction over a batched state;
    returns a dict of device tensors, or None when the plane is compiled
    out (cfg.series_windows == 0) or the state is unbatched."""
    return _series_digest(state) if _series_on(state) else None


def series_counters(state) -> dict | None:
    """`series_digest` on the host: exact per-window int64 series, the
    batch-OR fault words and the per-window p99 estimates in ticks. None
    when the plane is compiled out. Run-twice confirmed and memoized."""
    if not _series_on(state):
        return None
    d = _confirmed_digest(
        series_digest, state,
        (state.sr_dispatch, state.sr_busy, state.sr_qhw, state.sr_drop,
         state.sr_dup, state.sr_complete, state.sr_slo_miss, state.sr_lat,
         state.sr_fault, state.sr_on, state.window_len))
    if d is None:
        return None
    out = dict(
        lanes=int(d["lanes"]),
        windows=int(state.sr_qhw.shape[1]),
        window_len=int(d["window_len"]),
        dispatch=_wide(d["dispatch"]),                    # int64 [W, N]
        busy=_wide(d["busy"]),                            # int64 [W, N]
        drop=_wide(d["drop"]).tolist(),
        dup=_wide(d["dup"]).tolist(),
        complete=_wide(d["complete"]).tolist(),
        slo_miss=_wide(d["slo_miss"]).tolist(),
        qhw=d["qhw"].tolist(),
        fault=d["fault"].tolist(),
    )
    if "lat" in d:
        out["lat"] = _wide(d["lat"])                      # int64 [W, LB]
        out["e2e_p99_by_window"] = d["e2e_p99_by_window"].tolist()
    return out


def _lane_burst_lat(sr_lat: torch.Tensor) -> torch.Tensor:
    """Per-lane deepest per-window p99 (windows kept apart, then the max
    over them): int32 [B] bucket lower edges — the `lane_burst` kernel
    on CUDA."""
    return _lane_burst_kernel(sr_lat)


def _lane_burst_qhw(sr_qhw: torch.Tensor) -> torch.Tensor:
    """Per-lane deepest per-window queue high-water. Plain PyTorch
    (ROADMAP §2: K10 work still to do)."""
    return sr_qhw.amax(-1)


def lane_burst(state) -> np.ndarray | None:
    """Host-side per-lane burst metric off the series plane: the deepest
    per-window p99 spike a lane hit (the per-window queue high-water when
    the latency plane is compiled out), the transient signal the
    fuzzer's burst_bonus hunts. None when the series plane is compiled
    out. One [B] int32 transfer."""
    if not _series_on(state):
        return None
    if _compiled_in(getattr(state, "sr_lat", None), 3):
        return _lane_burst_lat(state.sr_lat).cpu().numpy()
    return _lane_burst_qhw(state.sr_qhw).cpu().numpy()


def series_brief(state) -> dict | None:
    """The small JSON-able series rollup `summarize()` carries: window
    geometry, the peak window's dispatch volume and queue high-water,
    the worst per-window p99, and which windows saw faults. None when the
    plane is compiled out."""
    c = series_counters(state)
    if c is None:
        return None
    disp_w = c["dispatch"].sum(-1)                        # [W] totals
    out = dict(lanes=c["lanes"], windows=c["windows"],
               window_len=c["window_len"],
               dispatch_peak=int(disp_w.max(initial=0)),
               dispatch_peak_window=int(disp_w.argmax()) if len(disp_w)
               else 0,
               qhw_peak=int(max(c["qhw"], default=0)),
               drops=int(sum(c["drop"])), dups=int(sum(c["dup"])),
               fault_windows=[i for i, f in enumerate(c["fault"]) if f])
    if "e2e_p99_by_window" in c:
        p99w = c["e2e_p99_by_window"]
        out["e2e_p99_peak"] = int(max(p99w, default=0))
        out["slo_miss"] = int(sum(c["slo_miss"]))
    return out


def attribution_leaves(state):
    """The attribution digest's `plane_sums` operands (leaves, masks):
    the lane count, the dominant slo_target (max), the wide sums of
    sa_tail and sa_bottleneck over the attributing lanes."""
    return ([(None, 0), (state.slo_target, 0, "max"), (state.sa_tail, 0),
             (state.sa_bottleneck, 0)], (state.sp_on, None))


def _attribution_digest(state) -> dict:
    """Device-side reduction of the span plane's tail attribution: one
    `plane_sums` launch (`attribution_leaves`), as the JAX package's
    `_attribution_digest`."""
    r = plane_sums(*attribution_leaves(state))
    return dict(lanes=(r[0][0].to(torch.int64) * 65536 + r[0][1]).to(
        torch.int32), slo_target=r[1], tail=r[2], bottleneck=r[3])


def _span_on(state) -> bool:
    return _compiled_in(getattr(state, "sa_tail", None), 3)


def attribution_digest(state):
    """Launch the device-side attribution reduction over a batched state;
    returns a dict of device tensors, or None when the plane is compiled
    out (cfg.span_attr False) or the state is unbatched."""
    return _attribution_digest(state) if _span_on(state) else None


def attribution_counters(state) -> dict | None:
    """`attribution_digest` on the host: exact int64 tail component sums
    per completion node ([N, 4]: count, qwait, net, hops) and the
    bottleneck-node histogram ([N]). None when the plane is compiled
    out. Run-twice confirmed and memoized."""
    if not _span_on(state):
        return None
    d = _confirmed_digest(
        attribution_digest, state,
        (state.sa_tail, state.sa_bottleneck, state.sp_on,
         state.slo_target))
    if d is None:
        return None
    return dict(
        lanes=int(d["lanes"]),
        slo_target=int(d["slo_target"]),
        tail=_wide(d["tail"]),                            # int64 [N, 4]
        bottleneck=_wide(d["bottleneck"]).tolist(),
    )


# sa_tail's components (core/state.py SA_*)
SA_COUNT, SA_QWAIT, SA_NET, SA_HOPS = range(4)


def attribution_brief(state) -> dict | None:
    """The small JSON-able attribution rollup `summarize()` carries: how
    many requests blew the SLO, where their time went (queue-wait against
    transit, and the wait share), their mean hop depth, and which node
    owned the dominant segment most often. None when the plane is
    compiled out."""
    c = attribution_counters(state)
    if c is None:
        return None
    t = c["tail"]
    tails = int(t[:, SA_COUNT].sum())
    qwait = int(t[:, SA_QWAIT].sum())
    net = int(t[:, SA_NET].sum())
    hops = int(t[:, SA_HOPS].sum())
    bn = c["bottleneck"]
    out = dict(lanes=c["lanes"], slo_target=c["slo_target"],
               tails=tails, qwait_us=qwait, net_us=net,
               wait_share=(round(qwait / (qwait + net), 4)
                           if qwait + net else None),
               hops_mean=round(hops / tails, 2) if tails else None,
               tails_by_node=t[:, SA_COUNT].tolist(),
               bottleneck_by_node=bn)
    if tails:
        out["bottleneck_node"] = int(np.argmax(bn))
        out["bottleneck_share"] = round(max(bn) / sum(bn), 4) if sum(bn) \
            else None
    return out


def schedule_representatives(state, seeds) -> dict:
    """{sched_hash: first seed that produced it}: one replayable
    representative a distinct interleaving class. `seeds` must be the
    exact seed array the batch was initialized with."""
    hashes = sched_hash_u64(state)
    seeds = np.asarray(seeds)
    uniq, idx = np.unique(hashes, return_index=True)
    return dict(zip(uniq.tolist(), seeds[idx].tolist()))


def _profile_brief(state) -> dict | None:
    c = profile_counters(state)
    if c is None:
        return None
    return dict(
        lanes=c["lanes"],
        dispatch_by_node=c["dispatch"].sum(-1).tolist(),
        busy_by_node=c["busy"].tolist(),
        kills=int(c["kill"].sum()), restarts=int(c["restart"].sum()),
        drops=c["drop"], delay_ticks=c["delay"],
        qmax_p50=c["qmax_p50"], qmax_max=c["qmax_max"])


def summarize(rt, state, seeds=None) -> dict:
    """One-call fleet report for a (finished or running) batched state,
    the JAX package's `summarize`: crash histogram and first seed a code,
    virtual time, traffic, distinct outcomes and schedules, the first
    divergence, and the plane briefs (None for a plane compiled out).
    Without `seeds` the *_seed fields are lane indices, and
    `seed_labels` says so."""
    halted = state.halted.cpu().numpy()
    crashed = state.crashed.cpu().numpy()
    codes = state.crash_code.cpu().numpy()
    now = state.now.cpu().numpy()
    B = halted.shape[0]
    seed_labels = "seed" if seeds is not None else "lane_index"
    seeds = np.asarray(seeds) if seeds is not None else np.arange(B)
    crash_hist: dict[int, int] = {}
    first_seed_by_code: dict[int, int] = {}
    for i in np.nonzero(crashed)[0]:
        c = int(codes[i])
        crash_hist[c] = crash_hist.get(c, 0) + 1
        first_seed_by_code.setdefault(c, int(seeds[i]))
    fps = rt.fingerprints(state)
    stats_on = rt.cfg.collect_stats
    return dict(
        batch=B,
        seed_labels=seed_labels,
        halted=int(halted.sum()),
        crashed=int(crashed.sum()),
        crash_histogram=crash_hist,
        first_seed_by_code=first_seed_by_code,
        first_crash_seed=(int(seeds[np.argmax(crashed)])
                          if crashed.any() else None),
        virtual_time_mean_us=float(now.mean()),
        virtual_time_max_us=int(now.max()),
        events_total=int(state.steps.cpu().numpy().sum()),
        msgs_sent=(int(state.msg_sent.cpu().numpy().sum())
                   if stats_on else None),
        msgs_dropped=(int(state.msg_dropped.cpu().numpy().sum())
                      if stats_on else None),
        ev_peak_max=(int(state.ev_peak.cpu().numpy().max())
                     if stats_on else None),
        distinct_outcomes=int(len(np.unique(fps))),
        distinct_schedules=distinct_schedules(state),
        first_divergence=divergence_profile(state),
        profile=_profile_brief(state),
        latency=latency_brief(state),
        series=series_brief(state),
        attribution=attribution_brief(state),
        oops=int((state.oops.cpu().numpy() != 0).sum()),
    )
