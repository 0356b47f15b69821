"""Sim-profiler reports and Perfetto counter tracks over the counter,
latency, series and span planes (the counterpart of
`madsim_tpu.obs.profiler`).

The ring answers *what happened* and the lineage *why*; this module
answers *where the simulated cluster spends its effort* (the
`cfg.profile` pf_* counters) and *how long requests take* (the
`cfg.latency_hist` lh_* histograms). Two consumers:

  * `profile_summary` / `format_profile` and `latency_summary` /
    `format_latency` — the reports: batch-sum counters off the on-device
    `parallel.stats.profile_digest` / `latency_digest` reductions (the
    K10 kernels) plus derived rates — per-node busy%, dispatch mix by
    event kind, drop rate, mean imposed delay, queue high-water and
    latency percentiles.
  * Perfetto COUNTER tracks next to the instants and flow arrows:
    `counter_track_events` renders queue depth over virtual time (the
    `tr_qlen` ring column — compiled in when profile AND trace are),
    cumulative per-node busy% (from the ring's now-deltas), a rolling
    per-node e2e p99 (the `tr_lat` ring column) and the lane's
    divergence-from-consensus step off the prefix sketch.
    `export_profile_trace` writes one document with instants, flows and
    counters on one virtual-time axis. With the series plane compiled in
    the queue-depth, busy% and e2e p99 tracks come from its windows
    instead (obs/series.py), covering the whole run.
  * `attribution_summary` / `format_attribution`: where SLO-missing
    requests spent their time, off the span plane's
    `parallel.stats.attribution_digest` (one K10 launch).
"""

from __future__ import annotations

import json

import numpy as np

from ..parallel.stats import (SA_COUNT, SA_HOPS, SA_NET, SA_QWAIT,
                              attribution_counters, latency_bucket_edges,
                              latency_counters, profile_counters)
from .rings import ring_records
from .trace import _doc, to_chrome_events

# pf_dispatch's kind axis, named (core/types.py event kinds; FREE never
# counts — a valid dispatch is never EV_FREE)
KIND_NAMES = ("free", "msg", "timer", "super")


def profile_summary(state) -> dict | None:
    """The profiler report for a (finished or running) batched state:
    raw batch-sum counters plus derived rates. None when the counter
    plane is compiled out (cfg.profile=False) or the state is unbatched.

    Derived fields:
      busy_pct[n]    node n's busy virtual time as % of the profiled
                     lanes' total virtual time (sums to ~100 when every
                     dispatch advanced the clock — idle gaps and
                     zero-delta dispatches make it undershoot, never
                     overshoot)
      dispatch_mix   total dispatches by event kind name
      drop_rate      drops per dispatched event
      mean_delay_us  pf_delay / delivered message dispatches
    """
    c = profile_counters(state)
    if c is None:
        return None
    disp = np.asarray(c["dispatch"], np.int64)          # [N, K]
    busy = np.asarray(c["busy"], np.int64)              # [N]
    total_disp = int(disp.sum())
    total_now = max(c["now_sum"], 1)
    msgs = int(disp[:, 1].sum())
    out = dict(
        lanes=c["lanes"],
        dispatches=total_disp,
        dispatch_by_node=disp.sum(-1).tolist(),
        dispatch_mix={KIND_NAMES[k]: int(disp[:, k].sum())
                      for k in range(disp.shape[1]) if disp[:, k].sum()},
        busy_us=busy.tolist(),
        busy_pct=[round(100.0 * b / total_now, 2) for b in busy.tolist()],
        kills=c["kill"].tolist(),
        restarts=c["restart"].tolist(),
        drops=c["drop"],
        drop_rate=round(c["drop"] / max(total_disp, 1), 4),
        delay_ticks=c["delay"],
        mean_delay_us=round(c["delay"] / max(msgs, 1), 1),
        queue_p50=c["qmax_p50"], queue_p90=c["qmax_p90"],
        queue_max=c["qmax_max"],
        steps_p50=c["steps_p50"], steps_p90=c["steps_p90"],
        steps_max=c["steps_max"],
    )
    return out


def format_profile(summary: dict, node_names=None) -> str:
    """Render a `profile_summary` dict as a fixed-width text table —
    the operator-facing report (`python -m`-free: print it)."""
    if summary is None:
        return "profiler compiled out (SimConfig.profile=False)"
    N = len(summary["dispatch_by_node"])
    name = (node_names if node_names is not None
            else [f"node{n}" for n in range(N)])
    lines = [
        f"profiled lanes: {summary['lanes']}  "
        f"dispatches: {summary['dispatches']}  "
        f"mix: {summary['dispatch_mix']}",
        f"drops: {summary['drops']} ({summary['drop_rate']:.2%}/event)  "
        f"mean delay: {summary['mean_delay_us']}us  "
        f"queue p50/p90/max: {summary['queue_p50']}/"
        f"{summary['queue_p90']}/{summary['queue_max']}",
        f"{'node':<12} {'dispatches':>10} {'busy_us':>12} {'busy%':>7} "
        f"{'kills':>6} {'boots':>6}",
    ]
    for n in range(N):
        lines.append(
            f"{name[n]:<12} {summary['dispatch_by_node'][n]:>10} "
            f"{summary['busy_us'][n]:>12} {summary['busy_pct'][n]:>7} "
            f"{summary['kills'][n]:>6} {summary['restarts'][n]:>6}")
    return "\n".join(lines)


def latency_summary(state) -> dict | None:
    """The latency report for a (finished or running) batched state:
    merged histogram quantiles plus derived rates, off the on-device
    `parallel.stats.latency_digest` reduction (O(buckets) transfer).
    None when the plane is compiled out (cfg.latency_hist == 0) or the
    state is unbatched.

    Quantile estimates are bucket-CDF LOWER bounds in ticks (µs) —
    deterministic, conservative (DESIGN §17). `slo_miss_rate` is
    misses per completion (0 when slo_target was 0 or nothing
    completed)."""
    c = latency_counters(state)
    if c is None:
        return None
    e2e = np.asarray(c["e2e_hist"], np.int64)           # [N, B]
    soj = np.asarray(c["sojourn_hist"], np.int64)
    completions = int(e2e.sum())
    return dict(
        lanes=c["lanes"],
        buckets=int(e2e.shape[1]),
        completions=completions,
        completions_by_node=e2e.sum(-1).tolist(),
        e2e_p50=c["e2e_p50"], e2e_p90=c["e2e_p90"],
        e2e_p99=c["e2e_p99"], e2e_p999=c["e2e_p999"],
        e2e_p99_by_node=c["e2e_p99_by_node"],
        sojourn_p50=c["sojourn_p50"], sojourn_p90=c["sojourn_p90"],
        sojourn_p99=c["sojourn_p99"], sojourn_p999=c["sojourn_p999"],
        sojourn_events=int(soj.sum()),
        slo_miss=c["slo_miss"],
        slo_miss_by_node=c["slo_miss_by_node"],
        slo_miss_rate=round(c["slo_miss"] / max(completions, 1), 4),
    )


def format_latency(summary: dict, node_names=None) -> str:
    """Render a `latency_summary` dict as a fixed-width text table —
    the operator-facing SLO report."""
    if summary is None:
        return "latency plane compiled out (SimConfig.latency_hist=0)"
    N = len(summary["completions_by_node"])
    name = (node_names if node_names is not None
            else [f"node{n}" for n in range(N)])
    lines = [
        f"recorded lanes: {summary['lanes']}  "
        f"completions: {summary['completions']}  "
        f"slo_miss: {summary['slo_miss']} "
        f"({summary['slo_miss_rate']:.2%})",
        f"e2e p50/p90/p99/p999: {summary['e2e_p50']}/"
        f"{summary['e2e_p90']}/{summary['e2e_p99']}/"
        f"{summary['e2e_p999']}us  "
        f"sojourn p50/p99: {summary['sojourn_p50']}/"
        f"{summary['sojourn_p99']}us",
        f"{'node':<12} {'completions':>12} {'e2e_p99':>9} {'slo_miss':>9}",
    ]
    for n in range(N):
        lines.append(
            f"{name[n]:<12} {summary['completions_by_node'][n]:>12} "
            f"{summary['e2e_p99_by_node'][n]:>9} "
            f"{summary['slo_miss_by_node'][n]:>9}")
    return "\n".join(lines)


def attribution_summary(state) -> dict | None:
    """The tail-attribution report for a batched state: where SLO-missing
    requests spent their time, off the device-side
    `parallel.stats.attribution_digest` reduction (O(N) transfer). Per
    completion node: the tail count and that cohort's queue-wait,
    transit and hop totals; and the bottleneck-node histogram (which
    node owned each tail's dominant segment). None when the plane is
    compiled out (cfg.span_attr False) or the state is unbatched."""
    c = attribution_counters(state)
    if c is None:
        return None
    t = np.asarray(c["tail"], np.int64)                 # [N, 4]
    bn = c["bottleneck"]
    tails = int(t[:, SA_COUNT].sum())
    qwait = int(t[:, SA_QWAIT].sum())
    net = int(t[:, SA_NET].sum())
    return dict(
        lanes=c["lanes"], slo_target=c["slo_target"], tails=tails,
        qwait_us=qwait, net_us=net,
        wait_share=(round(qwait / (qwait + net), 4)
                    if qwait + net else None),
        hops_mean=(round(int(t[:, SA_HOPS].sum()) / tails, 2)
                   if tails else None),
        tails_by_node=t[:, SA_COUNT].tolist(),
        qwait_by_node=t[:, SA_QWAIT].tolist(),
        net_by_node=t[:, SA_NET].tolist(),
        bottleneck_by_node=bn,
        bottleneck_node=(int(np.argmax(bn)) if tails else None),
    )


def format_attribution(summary: dict, node_names=None) -> str:
    """Render an `attribution_summary` dict as a fixed-width table —
    the operator-facing answer to "who owns the tail". The bottleneck
    column counts DOMINANT segments owned; the starred row is the
    cluster's bottleneck node."""
    if summary is None:
        return ("attribution plane compiled out "
                "(SimConfig.span_attr=False)")
    N = len(summary["tails_by_node"])
    name = (node_names if node_names is not None
            else [f"node{n}" for n in range(N)])
    ws = summary["wait_share"]
    lines = [
        f"recorded lanes: {summary['lanes']}  "
        f"slo_target: {summary['slo_target']}us  "
        f"tail requests: {summary['tails']}",
        f"tail time split: wait {summary['qwait_us']}us / "
        f"transit {summary['net_us']}us"
        + (f" (wait share {ws:.1%})" if ws is not None else "")
        + (f"  mean hops: {summary['hops_mean']}"
           if summary["hops_mean"] is not None else ""),
        f"{'node':<12} {'tails':>8} {'wait_us':>12} {'transit_us':>12} "
        f"{'bottleneck':>11}",
    ]
    for n in range(N):
        star = " *" if summary["bottleneck_node"] == n else ""
        lines.append(
            f"{name[n]:<12} {summary['tails_by_node'][n]:>8} "
            f"{summary['qwait_by_node'][n]:>12} "
            f"{summary['net_by_node'][n]:>12} "
            f"{summary['bottleneck_by_node'][n]:>11}{star}")
    return "\n".join(lines)


def curve_brief(curve) -> dict | None:
    """Summarize a [[t, value], ...] series (the campaign timeline's
    coverage/rate/p99 curves) into the stat-tile shape the triage
    snapshots persist and the dashboard renders: point count, min /
    p50 / p90 / max over values, and the last value. None for an empty
    series (build without that plane). Deterministic — a pure function
    of the series, so it is safe inside the byte-stable snapshot body."""
    if not curve:
        return None
    vals = np.asarray([v for _t, v in curve], np.float64)
    return dict(
        n=int(len(curve)),
        min=round(float(vals.min()), 3),
        p50=round(float(np.percentile(vals, 50)), 3),
        p90=round(float(np.percentile(vals, 90)), 3),
        max=round(float(vals.max()), 3),
        last=round(float(vals[-1]), 3))


def latency_histogram_rows(state) -> list[dict] | None:
    """The merged histograms as JSON-able rows (one per bucket with any
    count): {bucket, lo_us, e2e, sojourn} — dashboard/ingest format.
    None when the plane is compiled out."""
    c = latency_counters(state)
    if c is None:
        return None
    e2e = np.asarray(c["e2e_hist"], np.int64).sum(0)
    soj = np.asarray(c["sojourn_hist"], np.int64).sum(0)
    edges = latency_bucket_edges(len(e2e))
    return [dict(bucket=int(b), lo_us=int(edges[b]),
                 e2e=int(e2e[b]), sojourn=int(soj[b]))
            for b in range(len(e2e)) if e2e[b] or soj[b]]


def _counter(name: str, ts: int, value, series: str = "value",
             pid: int = 0) -> dict:
    return dict(name=name, ph="C", ts=int(ts), pid=pid,
                args={series: float(value)})


def counter_track_events(state, lane: int = 0, node_names=None,
                         consensus=None, recs=None,
                         p99_window: int = 64) -> list[dict]:
    """Perfetto counter-track events for one lane, from the ring window
    (cfg.trace_cap > 0; the lane must be sampled):

      queue_depth    event-table occupancy at each dispatch (`tr_qlen` —
                     present only on cfg.profile builds; omitted, not
                     zeroed, elsewhere)
      busy_pct:<n>   node n's cumulative busy share of the ring window's
                     virtual time, from the ring's now-deltas (the delta
                     of each dispatch belongs to its record's node) —
                     window-relative after a ring wrap
      cov_divergence 0/1 step track: whether this lane's prefix sketch
                     had left the batch-consensus prefix by the
                     checkpoint nearest each ring record (cfg.sketch_slots
                     builds only; `consensus` overrides the batch modal,
                     e.g. with a campaign's cross-round consensus)
      e2e_p99:<n>    ROLLING p99 of the last `p99_window` completions at
                     node n, from the `tr_lat` ring column (present only
                     on cfg.latency_hist builds with complete_kinds) —
                     the tail curve over virtual time, next to the
                     pressure curves it correlates with

    Timestamps ride the same virtual-time axis as the r7 instants, so
    the tracks align with the event timeline in one document. Pass an
    already-unwrapped `recs` (a `ring_records` dict for this lane) to
    skip re-reading the ring — `export_profile_trace` does, halving
    its host transfer.

    r21: when the windowed series plane is compiled in
    (cfg.series_windows > 0) and this lane records, the queue_depth /
    busy% / e2e_p99 tracks are DERIVED FROM THE SERIES instead
    (obs/series.py) — true window-start timestamps covering the whole
    run, where the ring reconstruction goes silent for everything
    older than trace_cap dispatches after a wrap. The ring paths below
    remain the fallback (finer grain: one point per dispatch, per-node
    p99) when the plane is off or the lane is series-masked; the
    cov_divergence track is ring/sketch-based either way.
    """
    from .series import series_counter_track_events
    out = series_counter_track_events(state, lane, node_names=node_names)
    from_series = bool(out)
    if recs is None:
        if from_series:
            # series-only build: the ring may be compiled out entirely —
            # the series tracks stand on their own (no cov_divergence /
            # per-node rolling p99, which are ring/sketch-derived)
            try:
                recs = ring_records(state, lane)
            except ValueError:
                return out
        else:
            recs = ring_records(state, lane)
    n = len(recs["now"])
    qlen = recs.get("qlen")
    if qlen is not None and not from_series:
        out += [_counter("queue_depth", recs["now"][i], qlen[i], "depth")
                for i in range(n)]
    # cumulative busy% per node over the ring window
    if n and not from_series:
        t0 = int(recs["now"][0])
        nodes = sorted({int(x) for x in recs["node"]})
        label = {nd: (node_names[nd] if node_names is not None
                      else f"node{nd}") for nd in nodes}
        busy = {nd: 0 for nd in nodes}
        prev = t0
        for i in range(n):
            now_i = int(recs["now"][i])
            busy[int(recs["node"][i])] += now_i - prev
            prev = now_i
            span = max(now_i - t0, 1)
            for nd in nodes:
                out.append(_counter(f"busy_pct:{label[nd]}", now_i,
                                    round(100.0 * busy[nd] / span, 2),
                                    "busy_pct"))
    # rolling per-node e2e p99 over the ring window's completions
    lat = recs.get("lat")
    if lat is not None and n and not from_series:
        label = {}
        window: dict[int, list] = {}
        for i in range(n):
            li = int(lat[i])
            if li < 0:          # not a completion dispatch
                continue
            nd = int(recs["node"][i])
            if nd not in window:
                window[nd] = []
                label[nd] = (node_names[nd] if node_names is not None
                             else f"node{nd}")
            w = window[nd]
            w.append(li)
            if len(w) > p99_window:
                del w[0]
            out.append(_counter(
                f"e2e_p99:{label[nd]}", recs["now"][i],
                float(np.percentile(np.asarray(w), 99)), "p99_us"))
    # the sketch as the JAX package's uint32 values (held as int32 bits)
    sk = state.cov_sketch.cpu().numpy().view(np.uint32)
    if n and sk.ndim == 2 and sk.shape[1] > 0:
        from ..parallel.stats import first_divergence_slots
        every = int(np.atleast_1d(
            state.sketch_every.cpu().numpy()).reshape(-1)[0])
        div_slot = int(first_divergence_slots(
            sk, consensus=consensus)[lane])
        # 0/1 step track sampled at the ring records: diverged once the
        # record's dispatch index passes the first divergent checkpoint
        for i in range(n):
            diverged = int(recs["step"][i]) >= (div_slot + 1) * every - 1
            out.append(_counter("cov_divergence", recs["now"][i],
                                1.0 if diverged else 0.0, "diverged"))
    return out


def export_profile_trace(path: str, state, lane: int = 0,
                         node_names=None, consensus=None) -> int:
    """Write one Perfetto/Chrome JSON document for `lane`: the r7
    instant events and r10 flow arrows (`to_chrome_events` over the
    ring) PLUS the profiler counter tracks, all on one virtual-time
    axis. Returns the instant-event count (the `export_chrome_trace`
    contract — counters annotate dispatches, they aren't dispatches)."""
    recs = ring_records(state, lane)     # one unwrap serves both halves
    events = to_chrome_events(recs)
    events += counter_track_events(state, lane, node_names=node_names,
                                   consensus=consensus, recs=recs)
    with open(path, "w") as f:
        json.dump(_doc(events, node_names), f)
    return sum(1 for e in events if e["ph"] == "i")
