"""Observability layer: flight-recorder rings, trace export, causal
lineage and the profiler and latency reports (the counterpart of
`madsim_tpu.obs`).

  * rings.py    — read the on-device flight-recorder ring
                  (cfg.trace_cap): the last events of each sampled lane.
  * trace.py    — export ring contents or `collect_events` streams as
                  Chrome-trace/Perfetto JSON.
  * causal.py   — the WHY layer over the ring: happens-before edges,
                  `explain_crash` and the crash fingerprints.
  * profiler.py — the WHERE and HOW-LONG layers: reports and Perfetto
                  counter tracks over the `cfg.profile` and
                  `cfg.latency_hist` planes, and the span plane's tail
                  attribution report.
  * series.py   — the WHEN layer: per-window reports and counter tracks
                  over the `cfg.series_windows` plane.
  * spans.py    — per-hop critical paths of requests over the
                  `cfg.span_attr` plane (`explain_latency`).
  * timetravel.py — lane checkpoints harvested by `run(ckpt_every=K)`
                  (`CheckpointLog`), window replay with observability
                  upgraded (`replay_window`, `full_chain_replay`,
                  `explain_crash(replay=True)`), the divergence
                  microscope (`divergence_report`) and the exact-step
                  advance (`Runtime.state_at`).

  * support.py  — the WHY-IT-WORKED layer: the lineage walk pointed at a
                  green lane's success witness, the support that
                  search/ldfi.py synthesizes cuts against.
  * metrics.py  — the SweepObserver protocol and its JSONL sink.
  * progress.py — a live one-line progress renderer (an observer).
  * dashboard.py — the static HTML triage dashboard (service/report.py).
"""

from .causal import (causal_fingerprint, code_fingerprint, explain_crash,
                     fingerprints_match, happens_before, sketch_divergence,
                     walk_lineage)
from .dashboard import render_html, sparkline_svg
from .metrics import JsonlObserver, SweepObserver, TeeObserver
from .profiler import (attribution_summary, counter_track_events,
                       curve_brief, export_profile_trace,
                       format_attribution, format_latency, format_profile,
                       latency_histogram_rows, latency_summary,
                       profile_summary)
from .progress import ProgressObserver
from .rings import ring_records, sampled_lanes
from .series import (fault_names, format_series, lane_series,
                     series_counter_track_events, series_summary)
from .spans import (explain_latency, format_span, request_span,
                    request_spans)
from .support import extract_support, support_from_records
from .timetravel import (CheckpointLog, ReplayDivergence, divergence_report,
                         full_chain_replay, replay_window)
from .trace import export_chrome_trace, to_chrome_events

__all__ = [
    "ring_records", "sampled_lanes", "to_chrome_events",
    "export_chrome_trace",
    "explain_crash", "happens_before", "sketch_divergence",
    "causal_fingerprint", "code_fingerprint", "fingerprints_match",
    "walk_lineage",
    "profile_summary", "format_profile", "counter_track_events",
    "export_profile_trace",
    "latency_summary", "format_latency", "latency_histogram_rows",
    "attribution_summary", "format_attribution", "curve_brief",
    "series_summary", "format_series", "lane_series",
    "series_counter_track_events", "fault_names",
    "request_span", "request_spans", "explain_latency", "format_span",
    "CheckpointLog", "replay_window", "full_chain_replay",
    "divergence_report", "ReplayDivergence",
    "extract_support", "support_from_records",
    "SweepObserver", "JsonlObserver", "TeeObserver", "ProgressObserver",
    "render_html", "sparkline_svg",
]
