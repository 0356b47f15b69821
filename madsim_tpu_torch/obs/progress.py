"""Live sweep progress: one overwritten status line on a TTY.

The counterpart of `madsim_tpu.obs.progress`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

The operator-facing end of the metrics layer: where JsonlObserver feeds
dashboards, ProgressObserver answers "is my 100k-seed sweep actually
moving?" without attaching a profiler. Same hooks, same records — it just
renders instead of persisting. Throttled to `min_interval` seconds so a
fine-grained chunk loop doesn't spend its wall-clock printing.
"""

from __future__ import annotations

import sys
import time


def _rate(x: float) -> str:
    for div, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if x >= div:
            return f"{x / div:.1f}{suffix}"
    return f"{x:.0f}"


def _lat(rec) -> str:
    """Render the round/sweep's tail-latency column ("  p99 1.2ms"
    plus "  slo_miss N" when misses were counted) — empty when the
    record predates the latency plane (r16) or the build compiles it
    out."""
    if rec.get("lat_p99") is None:
        return ""
    p99 = rec["lat_p99"]
    txt = (f"  p99 {p99 / 1000:.1f}ms" if p99 >= 1000
           else f"  p99 {p99}us")
    if rec.get("slo_miss"):
        txt += f"  slo_miss {rec['slo_miss']}"
    return txt


def _targeted(rec) -> str:
    """Render the round's targeted-arm column ("  targeted 3/16 pool 8":
    admitted/launched lineage-synthesized lanes plus the support pool
    depth) — empty when the record predates the ldfi plane (r22) or the
    campaign never aimed."""
    if rec.get("targeted") is None:
        return ""
    txt = f"  targeted {rec.get('targeted_yield', 0)}/{rec['targeted']}"
    if rec.get("support_pool"):
        txt += f" pool {rec['support_pool']}"
    return txt


def _top_yield(op_yield) -> str:
    """Render the most productive mutation operator of a round/shard
    ("  yield time_nudge:3") — empty when nothing was admitted or the
    record predates yield attribution (r15)."""
    if not op_yield:
        return ""
    name, n = max(op_yield.items(), key=lambda kv: kv[1])
    return f"  yield {name}:{n}" if n else ""


class ProgressObserver:
    def __init__(self, stream=None, min_interval: float = 0.5):
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self._last = 0.0
        self._line_open = False

    def _show(self, text: str, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last < self.min_interval:
            return
        self._last = now
        self.stream.write("\r\x1b[2K" + text if self._line_open
                          else text)
        self.stream.flush()
        self._line_open = True

    def on_chunk(self, rec):
        b, h = rec["batch"], rec["lanes_halted"]
        # h is None on non-addressable (multi-process) batches, where
        # the runner can't fetch the per-lane halted vector
        halted = (f"halted {h}/{b} ({100 * h / max(b, 1):.0f}%)"
                  if h is not None else f"batch {b}")
        stashed = (f"  +{rec['stashed_total']} stashed"
                   if rec.get("stashed_total") else "")
        self._show(
            f"chunk {rec['chunk']:>4}  steps {rec['steps_done']:>8}  "
            f"{halted}{stashed}  "
            f"{_rate(rec['lane_steps_per_sec'])} lane-steps/s")

    def on_compact(self, rec):
        self._show(
            f"compact @{rec['steps_done']}: {rec['from_batch']} -> "
            f"{rec['to_batch']} lanes ({rec['stashed']} stashed)",
            force=True)
        self._line_open = False     # keep the repack visible
        self.stream.write("\n")

    def on_round(self, rec):
        if rec.get("kind") == "campaign":
            # the multi-process campaign rollup (service/campaign.py):
            # one line per poll of the shared corpus dir
            self._show(
                f"campaign {rec['uptime_s']:>5.0f}s  "
                f"{rec['workers_alive']}/{rec['workers']} workers  "
                f"corpus {rec['corpus_entries']}  "
                f"coverage {rec['coverage_keys']}  "
                f"buckets {rec['buckets']}  "
                f"{rec['schedules_per_sec']:.1f} sched/s", force=True)
            return
        if rec.get("kind") == "triage":
            # service.triage snapshot at a supervisor segment boundary:
            # the one-line "what changed" readout (full detail:
            # python -m madsim_tpu_torch.service.report <dir> --against prev)
            if rec.get("empty"):
                change = "no change"
            elif "coverage_added" in rec:
                change = (f"+{rec['coverage_added']} coverage  "
                          f"{rec.get('buckets_new', 0)} new / "
                          f"{rec.get('buckets_regressed', 0)} regressed / "
                          f"{rec.get('buckets_stale', 0)} stale buckets")
            else:
                change = "baseline"
            self._show(f"triage snapshot {rec['snapshot']:04d}  {change}",
                       force=True)
            self._line_open = False
            self.stream.write("\n")
            return
        if rec.get("kind") == "supervisor":
            # service.supervise_campaign segment boundary
            dead = rec.get("dead_workers") or []
            self._show(
                f"supervisor seg {rec['segment']}  "
                f"rounds->{rec['max_rounds']}  "
                f"restarts {rec['restarts']}  pruned {rec['pruned']}"
                + (f"  dead {dead}" if dead else ""), force=True)
            self._line_open = False
            self.stream.write("\n")
            return
        # explore() rounds and fuzz() rounds share the schema; fuzz adds
        # corpus_size (and kind="fuzz_round")
        corpus = (f"  corpus {rec['corpus_size']}"
                  if "corpus_size" in rec else "")
        shards = (f"  x{rec['shards']} shards"
                  if rec.get("shards", 1) > 1 else "")
        self._show(
            f"round {rec['round']:>3}  +{rec['new_schedules']} new "
            f"schedules ({rec['distinct_total']} distinct)  "
            f"crashes {rec['crashes']}{corpus}{shards}{_lat(rec)}"
            f"{_top_yield(rec.get('op_yield'))}{_targeted(rec)}",
            force=True)
        if rec.get("shards", 1) > 1 and rec.get("per_shard"):
            # one row per shard — a mesh campaign's telemetry must not
            # collapse the mesh into one line (wall_s is the round's
            # campaign wall: shards run concurrently, so per-shard
            # rates share it)
            wall = max(rec.get("wall_s", 0.0), 1e-9)
            self.stream.write("\n")
            for row in rec["per_shard"]:
                self.stream.write(
                    f"  shard {row['shard']} (w{row['worker_id']})  "
                    f"corpus {row['corpus_size']:>4}  "
                    f"coverage {row['coverage']:>5}  "
                    f"+{row['new']} new  crashes {row['crashes']}  "
                    f"{_rate(row['seeds_run'] / wall)} sched/s"
                    f"{_top_yield(row.get('op_yield'))}\n")
            self.stream.flush()
            self._line_open = False

    def on_done(self, rec):
        parts = [f"done: {rec.get('steps_done', rec.get('seeds_run', 0))} "
                 f"steps" if "steps_done" in rec
                 else f"done: {rec.get('seeds_run', 0)} seeds"]
        if rec.get("lanes_halted") is not None:
            parts.append(f"halted {rec['lanes_halted']}/{rec['batch']}")
        if "distinct_total" in rec:
            parts.append(f"{rec['distinct_total']} distinct schedules")
        if rec.get("lat_p99") is not None:
            parts.append(_lat(rec).strip())
        if "wall_s" in rec:
            parts.append(f"{rec['wall_s']:.2f}s")
        self._show("  ".join(parts), force=True)
        self.stream.write("\n")
        self.stream.flush()
        self._line_open = False
