"""Static triage dashboard: one self-contained HTML file, zero deps.

The counterpart of `madsim_tpu.obs.dashboard`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

The operator surface of the campaign triage plane (service/triage.py):
`render_html(cur, diff)` turns a snapshot (+ its diff against the
previous one) into a single document with inline-SVG sparklines for the
coverage / schedules-per-sec / p99 curves, per-recipe and per-operator
attribution bars, the bucket lifecycle table with repro one-liners, and
the repro-health audit verdicts. No server, no JavaScript, no external
assets — the file is the artifact, so it attaches to a CI run or an
email and still renders in ten years.

Rendering rules (kept deliberately boring): every chart is a single
series in one hue, so identity lives in titles and row labels, never in
a legend the reader must color-match; values and labels wear text ink,
never the series color; lifecycle/audit verdicts use the reserved
status palette WITH their word — color never carries meaning alone;
hover detail rides native SVG ``<title>`` tooltips. Light and dark are
both real: the dark values are selected steps, not an automatic invert.
"""

from __future__ import annotations

import html as _html
import json

# palette: validated reference instance (light / dark pairs). Marks use
# the single categorical slot-1 blue; status colors are reserved for
# verdicts and always ship beside their word.
_CSS = """
.triage-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --ink-1: #0b0b0b; --ink-2: #52514e; --ink-3: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7;
  --border: rgba(11,11,11,0.10);
  --series-1: #2a78d6;
  --good: #0ca30c; --warn: #fab219; --serious: #ec835a;
  --critical: #d03b3b;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--ink-1);
  margin: 0; padding: 24px;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .triage-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --page: #0d0d0d;
    --ink-1: #ffffff; --ink-2: #c3c2b7; --ink-3: #898781;
    --grid: #2c2c2a; --axis: #383835;
    --border: rgba(255,255,255,0.10);
    --series-1: #3987e5;
  }
}
:root[data-theme="dark"] .triage-root {
  color-scheme: dark;
  --surface-1: #1a1a19; --page: #0d0d0d;
  --ink-1: #ffffff; --ink-2: #c3c2b7; --ink-3: #898781;
  --grid: #2c2c2a; --axis: #383835;
  --border: rgba(255,255,255,0.10);
  --series-1: #3987e5;
}
.triage-root h1 { font-size: 20px; margin: 0 0 2px; }
.triage-root h2 { font-size: 14px; margin: 24px 0 8px; color: var(--ink-2);
                  font-weight: 600; }
.triage-root .sub { color: var(--ink-3); font-size: 12px; margin: 0 0 16px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--surface-1); border: 1px solid var(--border);
        border-radius: 8px; padding: 12px 16px; min-width: 150px; }
.tile .label { font-size: 12px; color: var(--ink-2); }
.tile .value { font-size: 26px; font-weight: 600; margin-top: 2px; }
.tile .delta { font-size: 12px; margin-top: 2px; color: var(--ink-2); }
.tile .delta.bad { color: var(--critical); }    /* more bugs = attention */
.tile .delta.good { color: #006300; }           /* coverage up = progress */
.tile .delta.flat { color: var(--ink-3); }
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .triage-root
    .tile .delta.good { color: #0ca30c; }
}
:root[data-theme="dark"] .triage-root .tile .delta.good { color: #0ca30c; }
.tile svg { display: block; margin-top: 6px; }
.bars { background: var(--surface-1); border: 1px solid var(--border);
        border-radius: 8px; padding: 12px 16px; display: inline-block;
        vertical-align: top; margin-right: 12px; min-width: 300px; }
.bars .row { display: flex; align-items: center; gap: 8px;
             margin: 4px 0; font-size: 12px; }
.bars .name { width: 120px; color: var(--ink-2); text-align: right; }
.bars .track { flex: 1; height: 16px; }
.bars .val { width: 48px; color: var(--ink-1);
             font-variant-numeric: tabular-nums; }
table.buckets { border-collapse: collapse; width: 100%;
                background: var(--surface-1); border: 1px solid
                var(--border); border-radius: 8px; font-size: 12.5px; }
table.buckets th { text-align: left; color: var(--ink-2); font-weight:
                   600; padding: 8px 10px; border-bottom: 1px solid
                   var(--grid); }
table.buckets td { padding: 7px 10px; border-bottom: 1px solid
                   var(--grid); vertical-align: top;
                   font-variant-numeric: tabular-nums; }
table.buckets tr:last-child td { border-bottom: none; }
.badge { display: inline-block; border-radius: 999px; padding: 1px 8px;
         font-size: 11px; font-weight: 600; color: #fff; }
.badge.new { background: var(--serious); }
.badge.regressed { background: var(--critical); }
.badge.grew { background: var(--series-1); }
.badge.stale { background: var(--ink-3); }
.badge.known { background: var(--axis); color: var(--ink-1); }
.badge.pass { background: var(--good); }
.badge.fail { background: var(--critical); }
.badge.flaky { background: var(--warn); color: #0b0b0b; }
.badge.unaudited { background: var(--axis); color: var(--ink-1); }
.mono { font-family: ui-monospace, Menlo, Consolas, monospace;
        font-size: 11.5px; color: var(--ink-2); }
"""

_SYM = {"new": "●", "regressed": "▲", "grew": "↗", "stale": "○",
        "known": "·", "pass": "✓", "fail": "✗", "flaky": "≈",
        "unaudited": "—"}


def _esc(x) -> str:
    return _html.escape(str(x), quote=True)


def _fmt(v) -> str:
    v = float(v)
    if v >= 1e6:
        return f"{v / 1e6:.1f}M"
    if v >= 1e4:
        return f"{v / 1e3:.1f}K"
    if v == int(v):
        return f"{int(v):,}"
    return f"{v:,.2f}"


def sparkline_svg(curve, w: int = 220, h: int = 44,
                  unit: str = "") -> str:
    """One single-series sparkline: 2px line in the series hue, ~10%
    area wash to the baseline, an end dot (r=4) with a 2px surface
    ring, and a native ``<title>`` tooltip per sampled point (the
    no-JS hover layer). `curve` is the timeline's [[t_rel_s, value],
    ...]; empty/None renders an em-dash placeholder."""
    if not curve:
        return '<span class="sub">&mdash;</span>'
    ts = [float(t) for t, _v in curve]
    vs = [float(v) for _t, v in curve]
    t0, t1 = min(ts), max(ts)
    v0, v1 = min(vs), max(vs)
    pad = 5.0
    sx = ((w - 2 * pad) / (t1 - t0)) if t1 > t0 else 0.0
    sy = ((h - 2 * pad) / (v1 - v0)) if v1 > v0 else 0.0

    def xy(t, v):
        return (pad + (t - t0) * sx,
                h - pad - (v - v0) * sy)

    pts = [xy(t, v) for t, v in zip(ts, vs)]
    line = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
    area = (f"{pts[0][0]:.1f},{h - 1:.1f} " + line
            + f" {pts[-1][0]:.1f},{h - 1:.1f}")
    ex, ey = pts[-1]
    # sampled hover targets (every point; invisible 8px circles so the
    # native tooltip has a real hit area)
    hits = "".join(
        f'<circle cx="{x:.1f}" cy="{y:.1f}" r="8" fill="transparent">'
        f"<title>t+{ts[i]:.0f}s: {_fmt(vs[i])}{_esc(unit)}</title>"
        f"</circle>"
        for i, (x, y) in enumerate(pts))
    return (
        f'<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}" '
        f'role="img" aria-label="sparkline, last {_fmt(vs[-1])}'
        f'{_esc(unit)}">'
        f'<line x1="{pad}" y1="{h - 1}" x2="{w - pad}" y2="{h - 1}" '
        f'stroke="var(--axis)" stroke-width="1"/>'
        f'<polygon points="{area}" fill="var(--series-1)" '
        f'fill-opacity="0.1"/>'
        f'<polyline points="{line}" fill="none" stroke="var(--series-1)" '
        f'stroke-width="2" stroke-linejoin="round" '
        f'stroke-linecap="round"/>'
        f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="6" '
        f'fill="var(--surface-1)"/>'
        f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="4" '
        f'fill="var(--series-1)"/>'
        f"{hits}</svg>")


def _tile(label: str, value, delta: str | None = None,
          curve=None, unit: str = "", delta_tone: str = "bad") -> str:
    spark = sparkline_svg(curve, unit=unit) if curve else ""
    d = ""
    if delta:
        # tone is per-METRIC (delta_tone: coverage growth is progress,
        # bucket growth is attention) and only applies when some count
        # is nonzero — "+0 new, 0 regressed vs prev" reads flat
        cls = (delta_tone if any(c.isdigit() and c != "0" for c in delta)
               else "flat")
        d = f'<div class="delta {cls}">{_esc(delta)}</div>'
    return (f'<div class="tile"><div class="label">{_esc(label)}</div>'
            f'<div class="value">{_esc(value)}</div>{d}{spark}</div>')


def series_sparklines_html(summary: dict | None) -> str:
    """Sim-time sparkline tiles off a `series_summary` dict (the r21
    windowed telemetry plane, obs/series.py): dispatches, queue
    high-water, and per-window e2e p99 on the VIRTUAL-time axis —
    every other curve on this dashboard is wall-clock campaign
    history; these are one run's own timeline, so a partition window
    reads as a spike at its sim-time offset. The fault markers ride
    as a decoded footnote (which windows saw disruptions/heals).
    Empty string when there is nothing to render (plane compiled out
    or no summary attached — the section simply doesn't appear)."""
    if not summary or not summary.get("rows"):
        return ""
    rows = summary["rows"]
    ts = [r["t0_us"] / 1e6 for r in rows]       # virtual seconds

    def curve(key):
        return [[ts[i], rows[i].get(key, 0)] for i in range(len(rows))]

    tiles = [
        _tile("Dispatches / window",
              _fmt(max(r["dispatches"] for r in rows)),
              curve=curve("dispatches")),
        _tile("Queue high-water",
              _fmt(max(r["qhw"] for r in rows)),
              curve=curve("qhw")),
    ]
    if any("e2e_p99" in r for r in rows):
        tiles.append(_tile(
            "e2e p99 / window",
            f"{_fmt(max(r.get('e2e_p99', 0) for r in rows))}us",
            curve=curve("e2e_p99"), unit="us"))
        tiles.append(_tile("SLO misses / window",
                           _fmt(sum(r["slo_miss"] for r in rows)),
                           curve=curve("slo_miss")))
    marks = [f"w{r['window']} {'+'.join(r['faults'])}"
             for r in rows if r["faults"]]
    note = ("fault windows: " + " &middot; ".join(_esc(m) for m in marks)
            if marks else "no fault markers")
    return (
        f"<h2>Sim-time telemetry &mdash; {_esc(summary['windows'])} "
        f"windows &times; {_esc(summary['window_len'])}us of virtual "
        f"time ({_esc(summary['lanes'])} recording lanes)</h2>"
        f'<div class="tiles">{"".join(tiles)}</div>'
        f'<p class="sub">{note}</p>')


def attribution_bars_html(title: str, counts: dict,
                          order=None) -> str:
    """One attribution panel: a horizontal bar per class, single hue
    (identity is the row label — magnitude is the only encoding), 16px
    bars with a 4px rounded data end and the value at the tip in text
    ink. Zero-count classes are listed muted so the accounting contract
    stays visible (everything sums to the total, nothing hides)."""
    keys = [k for k in (order or sorted(counts)) if k in counts]
    keys += [k for k in sorted(counts) if k not in keys]
    total = sum(counts.values()) or 1
    peak = max(counts.values(), default=0) or 1
    rows = []
    for k in keys:
        v = int(counts[k])
        # floor 5px: the path below spends 4px on the rounded data-end,
        # so anything smaller would emit a malformed negative h segment
        bw = max(5, round(180 * v / peak)) if v else 0
        bar = ("" if not v else
               f'<svg width="188" height="16" viewBox="0 0 188 16">'
               f'<path d="M0,0 h{bw - 4} a4,4 0 0 1 4,4 v8 a4,4 0 0 1 '
               f'-4,4 h-{bw - 4} z" fill="var(--series-1)">'
               f"<title>{_esc(k)}: {v} ({100 * v / total:.0f}%)</title>"
               f"</path></svg>")
        rows.append(
            f'<div class="row"><div class="name">{_esc(k)}</div>'
            f'<div class="track">{bar}</div>'
            f'<div class="val">{v or "·"}</div></div>')
    return (f'<div class="bars"><h2>{_esc(title)}</h2>'
            + "".join(rows)
            + f'<div class="row"><div class="name">total</div>'
              f'<div class="track"></div>'
              f'<div class="val">{sum(counts.values())}</div></div></div>')


def _lifecycle_of(key: str, diff: dict | None) -> str:
    from ..service.triage import bucket_lifecycle
    return bucket_lifecycle(key, diff)


def _badge(cls: str) -> str:
    # word + symbol + color: meaning never rides color alone
    return (f'<span class="badge {cls}">{_SYM.get(cls, "")}&nbsp;'
            f"{_esc(cls)}</span>")


def _repro_line(b: dict) -> str:
    r = b.get("repro", {})
    parts = [f"seed={r.get('seed')}", f"round={r.get('round')}",
             f"worker={r.get('worker_id')}"]
    if "nudge" in r:
        parts.append(f"nudge={r['nudge']}")
    if b.get("minimized"):
        parts.append("minimized")
    return " ".join(parts)


def bucket_table_html(cur: dict, diff: dict | None) -> str:
    rows = []
    order = sorted(
        cur.get("buckets", {}).items(),
        key=lambda kv: ({"new": 0, "regressed": 1, "grew": 2,
                         "known": 3, "stale": 4}
                        .get(_lifecycle_of(kv[0], diff), 3),
                        -kv[1]["observations"], kv[0]))
    from ..service.triage import bucket_audit
    for key, b in order:
        cls = _lifecycle_of(key, diff)
        a = bucket_audit(cur, key, b.get("members", ()))
        astat = (a or {}).get("status", "unaudited")
        # r20 chain column: complete chain vs truncated-at-wrap, with
        # the replayed-window trace linked when replay_bucket/audit
        # wrote one (a file path — the dashboard is serverless, so the
        # link is the store-relative name, always worded)
        if "chain_complete" not in b:
            chain = '<span class="sub">unknown</span>'
        else:
            chain = ("complete" if b["chain_complete"]
                     else "truncated at wrap")
            if b.get("window_trace"):
                chain += (' &middot; <span class="mono">buckets/'
                          f"{_esc(b['window_trace'][:16])}&hellip;"
                          ".window.trace.json</span>")
        rows.append(
            "<tr>"
            f'<td class="mono">{_esc(key[:16])}</td>'
            f"<td>{_badge(cls)}</td>"
            f"<td>{b['crash_code']}</td>"
            f"<td>{_esc(b['recipe'])}</td>"
            f"<td>{_esc(b['op'])}</td>"
            f"<td>{b['observations']}</td>"
            f"<td>{b['first_round']}&ndash;{b['last_round']}</td>"
            f"<td>{_badge(astat)}</td>"
            f"<td>{chain}</td>"
            f'<td class="mono">{_esc(_repro_line(b))}</td>'
            "</tr>")
    if not rows:
        rows = ['<tr><td colspan="10" class="sub">no buckets — the '
                "campaign found no crashes (yet)</td></tr>"]
    head = "".join(f"<th>{h}</th>" for h in (
        "bucket", "lifecycle", "code", "recipe", "operator", "obs",
        "rounds", "repro health", "chain", "repro handle"))
    return (f'<table class="buckets"><thead><tr>{head}</tr></thead>'
            f'<tbody>{"".join(rows)}</tbody></table>')


def workers_table_html(cur: dict) -> str:
    rows = []
    for label, h in sorted(cur.get("workers_health", {}).items()):
        stale = _badge("stale") if h.get("stale") else _badge("pass")
        rows.append(
            f'<tr><td class="mono">{_esc(label)}</td>'
            f"<td>{h.get('rounds_done', 0)}</td>"
            f"<td>{h.get('sync_gap_s', 0)}s</td>"
            f"<td>{h.get('age_s', 0)}s</td>"
            f"<td>{stale}</td></tr>")
    if not rows:
        return '<p class="sub">no worker timeline rows yet</p>'
    head = "".join(f"<th>{h}</th>" for h in (
        "worker", "rounds", "sync cadence", "age vs newest", "health"))
    return (f'<table class="buckets"><thead><tr>{head}</tr></thead>'
            f'<tbody>{"".join(rows)}</tbody></table>')


def render_html(cur: dict, diff: dict | None = None,
                title: str = "madsim campaign triage") -> str:
    """The whole dashboard as one HTML string (write it wherever —
    `service.report --html out.html` does)."""
    st = cur.get("store", {})
    curves = cur.get("curves", {})
    slo = cur.get("slo") or {}
    d_new = len((diff or {}).get("buckets", {}).get("new", ()))
    d_reg = len((diff or {}).get("buckets", {}).get("regressed", ()))
    d_cov = (diff or {}).get("coverage", {}).get("added", 0)
    tiles = [
        _tile("Coverage keys", _fmt(st.get("coverage_total", 0)),
              delta=(f"+{d_cov} vs prev" if diff else None),
              delta_tone="good",
              curve=curves.get("coverage")),
        _tile("Crash buckets", _fmt(st.get("buckets_total", 0)),
              delta=(f"+{d_new} new, {d_reg} regressed vs prev"
                     if diff else None)),
        _tile("Observations", _fmt(st.get("crash_observations", 0))),
        _tile("Schedules/s", (_fmt(cur["rate"]["last"])
                              if cur.get("rate") else "—"),
              curve=curves.get("rate")),
        _tile("e2e p99", (f"{_fmt(cur['p99']['last'])}us"
                          if cur.get("p99") else "—"),
              # the SLO verdict beside the quantile (r23): what target
              # the campaign ran against and how many requests blew it
              delta=(f"SLO {_fmt(slo['target'])}us — "
                     f"{_fmt(slo.get('miss', 0))} miss"
                     if slo.get("target") else None),
              curve=curves.get("p99"), unit="us"),
        _tile("Rounds", _fmt(st.get("max_round", 0))),
    ]
    attr = cur.get("attribution", {})
    from ..runtime.scenario import RECIPE_FAMILIES
    fam_order = list(RECIPE_FAMILIES) + ["base"]
    empty_note = ""
    if diff is not None and diff.get("empty"):
        empty_note = ('<p class="sub">diff vs previous snapshot: '
                      "EMPTY — nothing changed</p>")
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{_esc(title)}</title>
<style>{_CSS}</style></head>
<body class="triage-root">
<h1>{_esc(title)}</h1>
<p class="sub">snapshot of {_esc(st.get("entries", 0))} corpus entries
&middot; {_esc(st.get("max_round", 0))} rounds &middot;
{_esc(len(cur.get("workers_health", {})))} workers
&middot; generated from the durable store alone</p>
{empty_note}
<div class="tiles">{"".join(tiles)}</div>
<h2>Attribution — every key and bucket accounted, `base` = unattributable</h2>
<div>
{attribution_bars_html("Coverage by recipe",
                       attr.get("recipe_coverage", {}), fam_order)}
{attribution_bars_html("Buckets by recipe",
                       attr.get("recipe_buckets", {}), fam_order)}
{attribution_bars_html("Coverage by operator",
                       attr.get("operator_coverage", {}))}
{attribution_bars_html("Buckets by operator",
                       attr.get("operator_buckets", {}))}
{attribution_bars_html("Coverage by origin",
                       attr.get("origin_coverage", {}),
                       ["targeted", "havoc"])}
{attribution_bars_html("Buckets by origin",
                       attr.get("origin_buckets", {}),
                       ["targeted", "havoc"])}
</div>
{series_sparklines_html(cur.get("series"))}
<h2>Buckets — lifecycle, attribution, repro health</h2>
{bucket_table_html(cur, diff)}
<h2>Workers</h2>
{workers_table_html(cur)}
<p class="sub">triage format v{_esc(cur.get("version", "?"))}
&middot; quiet_rounds={_esc(cur.get("quiet_rounds", "?"))}
&middot; diff lifecycle: {json.dumps({k: len(v) for k, v in
(diff or {}).get("buckets", {}).items()}) if diff else "no diff"}</p>
</body></html>
"""
