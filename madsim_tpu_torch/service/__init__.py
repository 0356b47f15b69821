"""Persistent fuzzing campaigns (r11): the service layer over search/.

The counterpart of `madsim_tpu.service`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

A campaign today survives its process: the corpus, the cross-round
consensus sketch, and every crash repro serialize into a versioned
corpus directory (`store.py`, the checkpoint contract of MIGRATION.md:
schema version + structural signature, reject-on-mismatch); crashes
dedup into causal-fingerprint buckets (`buckets.py`, one bug = one
bucket across lanes, seeds, processes, and ring-wrap depths); and N
worker processes share one dir lock-free (`campaign.py`/`worker.py`,
merge-by-construction: namespaced immutable entries + atomic renames).

The triage plane (r18, `triage.py`) sits on top as the read side's
product surface: byte-stable `triage/NNNN.json` snapshots, run-over-run
diffs with a bucket lifecycle (new/regressed/grew/stale), per-recipe
and per-operator attribution with exact sum-to-total accounting, the
repro-health audit ledger, and the `python -m madsim_tpu_torch.service.report`
terminal/HTML dashboard (obs/dashboard.py). See DESIGN.md §13
"Persistence discipline" and §19 "Triage discipline".
"""

from .buckets import CrashBuckets, merged_buckets
from .campaign import (campaign_report, campaign_stats, campaign_timeline,
                       prune_cold_entries, replay_bucket, run_campaign,
                       spawn_worker, supervise_campaign, worker_cmd)
from .store import CorpusStore, StoreMismatch, store_signature
from .triage import (audit_buckets, list_snapshots, load_snapshot,
                     triage_diff, triage_snapshot)

__all__ = [
    "CorpusStore", "StoreMismatch", "store_signature",
    "CrashBuckets", "merged_buckets",
    "run_campaign", "supervise_campaign", "prune_cold_entries",
    "campaign_report", "campaign_stats", "campaign_timeline",
    "spawn_worker", "worker_cmd", "replay_bucket",
    "triage_snapshot", "triage_diff", "audit_buckets",
    "list_snapshots", "load_snapshot",
]
