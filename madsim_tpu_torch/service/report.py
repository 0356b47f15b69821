"""`python -m madsim_tpu_torch.service.report <corpus_dir>` — the triage CLI.

The counterpart of `madsim_tpu.service.report`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

The operator's standing view of a durable campaign: renders the latest
triage snapshot (service/triage.py) as a terminal report, diffs it
against the previous one (`--against prev`, the default when history
exists) or any numbered snapshot (`--against 0003`), and optionally
writes the self-contained HTML dashboard (`--html out.html`,
obs/dashboard.py). Pure read side: it never runs the engine — taking a
fresh snapshot first is `--snapshot` (cheap, store-only), and the
repro-health audit stays in `triage.audit_buckets` because it needs a
Runtime. Works on any store a worker ever synced, live or long dead.
"""

from __future__ import annotations

import argparse
import sys

from .store import CorpusStore
from .triage import (bucket_audit, bucket_lifecycle, list_snapshots,
                     load_snapshot, triage_diff, triage_snapshot)


def _fmt_counts(counts: dict) -> str:
    return "  ".join(f"{k}:{v}" for k, v in counts.items() if v) or "-"


def render_text(cur: dict, diff: dict | None = None) -> str:
    """The terminal report (the HTML dashboard's plain twin)."""
    st = cur["store"]
    lines = [
        f"corpus: {st['entries']} entries  "
        f"coverage: {st['coverage_total']}  "
        f"buckets: {st['buckets_total']} "
        f"({st['crash_observations']} observations)  "
        f"rounds: {st['max_round']}",
    ]
    if cur.get("rate"):
        lines[-1] += f"  sched/s: {cur['rate']['last']}"
    if cur.get("p99"):
        lines[-1] += f"  p99: {cur['p99']['last']}us"
    attr = cur["attribution"]
    lines.append("recipe coverage:   "
                 + _fmt_counts(attr["recipe_coverage"]))
    lines.append("recipe buckets:    "
                 + _fmt_counts(attr["recipe_buckets"]))
    lines.append("operator coverage: "
                 + _fmt_counts(attr["operator_coverage"]))
    lines.append("operator buckets:  "
                 + _fmt_counts(attr["operator_buckets"]))
    if not attr.get("rows_known"):
        lines.append("  (no triage/ROWS.json — recipe attribution is "
                     "all `base`; run one r18+ worker to write it)")
    if diff is not None:
        if diff["empty"]:
            lines.append("diff: EMPTY — nothing changed")
        else:
            b = diff["buckets"]
            lines.append(
                f"diff: +{diff['coverage']['added']} coverage keys "
                f"(-{diff['coverage']['removed']})  buckets: "
                f"{len(b['new'])} new, {len(b['regressed'])} regressed, "
                f"{len(b['grew'])} grew, {len(b['stale'])} stale")
            for cls in ("new", "regressed", "stale"):
                for k in b[cls]:
                    bk = cur.get("buckets", {}).get(k) or {}
                    lines.append(f"  [{cls}] {k[:16]} "
                                 f"code={bk.get('crash_code', '?')} "
                                 f"recipe={bk.get('recipe', '?')}")
    lines.append(f"{'bucket':<18}{'life':<11}{'code':>5} "
                 f"{'recipe':<15}{'operator':<17}{'obs':>4} "
                 f"{'rounds':<9}{'audit':<7}{'chain':<9} repro")

    for k, bk in sorted(cur.get("buckets", {}).items()):
        a = bucket_audit(cur, k, bk.get("members", ()))
        r = bk["repro"]
        repro = (f"seed={r.get('seed')} round={r.get('round')} "
                 f"worker={r.get('worker_id')}")
        if bk.get("minimized"):
            repro += " minimized"
        # r20: is the recorded causal chain the whole story or still
        # truncated-at-wrap, and does a replayed window trace exist?
        # (pre-r20 snapshots lack both fields — rendered as "-")
        if "chain_complete" not in bk:
            chain = "-"
        else:
            chain = "full" if bk["chain_complete"] else "cut"
            if bk.get("window_trace"):
                chain += "+tr"
        if bk.get("window_trace"):
            # the full member key: this line is the copy-pasteable
            # repro surface, so the path must be the real filename
            repro += (f" trace=buckets/{bk['window_trace']}"
                      ".window.trace.json")
        lines.append(
            f"{k[:16]:<18}{bucket_lifecycle(k, diff):<11}"
            f"{bk['crash_code']:>5} "
            f"{bk['recipe']:<15}{bk['op']:<17}"
            f"{bk['observations']:>4} "
            f"{bk['first_round']}-{bk['last_round']:<7}"
            f"{(a or {}).get('status', '-'):<7}"
            f"{chain:<9} {repro}")
    stale_w = [w for w, h in cur.get("workers_health", {}).items()
               if h.get("stale")]
    if stale_w:
        lines.append(f"STALE workers: {', '.join(stale_w)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.service.report", description=__doc__)
    ap.add_argument("corpus_dir")
    ap.add_argument("--snapshot", action="store_true",
                    help="fold the store into a fresh triage snapshot "
                         "first (store-only, no engine)")
    ap.add_argument("--against", default=None, metavar="prev|NNNN",
                    help="diff the latest snapshot against this one "
                         "(default: prev when history allows)")
    ap.add_argument("--html", default=None, metavar="OUT",
                    help="also write the self-contained HTML dashboard")
    ap.add_argument("--quiet-rounds", type=int, default=2,
                    help="rounds without observation before a bucket "
                         "counts as quiet (lifecycle thresholds)")
    ap.add_argument("--json", action="store_true",
                    help="emit {snapshot, diff} as one JSON document "
                         "instead of the text report")
    args = ap.parse_args(argv)

    store = CorpusStore(args.corpus_dir, create=False)
    if args.snapshot:
        n, cur = triage_snapshot(store, quiet_rounds=args.quiet_rounds)
        print(f"snapshot {n:04d} written", file=sys.stderr)
    else:
        cur = load_snapshot(store, "last")
    have = list_snapshots(store)
    against = args.against
    if against is None and len(have) >= 2:
        against = "prev"
    diff = None
    if against is not None:
        prev = load_snapshot(store, against)
        diff = triage_diff(prev, cur, quiet_rounds=args.quiet_rounds)
    if args.html:
        from ..obs.dashboard import render_html
        with open(args.html, "w") as f:
            f.write(render_html(cur, diff))
        print(f"dashboard: {args.html}", file=sys.stderr)
    if args.json:
        import json
        print(json.dumps(dict(snapshot=cur, diff=diff)))
    else:
        print(render_text(cur, diff))
    return 0


if __name__ == "__main__":
    sys.exit(main())
