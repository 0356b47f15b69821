"""One campaign worker process: `python -m madsim_tpu_torch.service.worker`.

The counterpart of `madsim_tpu.service.worker`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

The smallest unit of a persistent fuzzing service — builds its runtime
from a "module:function" factory spec, joins the shared corpus dir under
its worker id, runs its share of rounds through `fuzz(corpus_dir=...)`,
and exits with a one-line JSON result on stdout. SIGKILL-safe at any
instant (the store's write-then-rename contract); relaunching with the
same arguments resumes where it died.

Factory specs resolve against sys.path plus the current working
directory, so `--factory madsim_tpu_torch.workloads:ldfi_echo_runtime`
works from a repo checkout and `--factory mypkg.workloads:make_rt` from
an install. The runtime's device is the factory's: the package's
workload builders run on CUDA, and `--factory-kwargs '{"device": "cpu"}'`
asks for the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys


def resolve_factory(spec: str):
    mod, _, fn = spec.partition(":")
    if not fn:
        raise SystemExit(f"--factory must be 'module:function', got {spec!r}")
    if os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())
    return getattr(importlib.import_module(mod), fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--corpus-dir", required=True)
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--factory", required=True,
                    help="module:function returning a Runtime")
    ap.add_argument("--factory-kwargs", default=None,
                    help="JSON kwargs for the factory")
    ap.add_argument("--max-steps", type=int, required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-rounds", type=int, default=4,
                    help="campaign-total rounds for this worker "
                         "(a resume runs only the remainder)")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--dry-rounds", type=int, default=None)
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--rng-seed", type=int, default=None,
                    help="corpus/mutation randomness (default: worker id)")
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--minimize", action="store_true")
    ap.add_argument("--shards", type=int, default=1,
                    help="mesh-shard this worker's campaign across N "
                         "devices (not in this package yet: refused)")
    ap.add_argument("--verify-resume", action="store_true",
                    help="run-twice guard on the first post-resume "
                         "round")
    ap.add_argument("--progress", action="store_true",
                    help="render live rounds on stderr too")
    args = ap.parse_args(argv)

    if args.shards > 1:
        raise NotImplementedError(
            "--shards > 1: the mesh-sharded campaign (search/shard.py, "
            "run_fused_sharded) is not in madsim_tpu_torch yet "
            "(ROADMAP P15)")

    factory = resolve_factory(args.factory)
    rt = factory(**json.loads(args.factory_kwargs or "{}"))

    from ..obs import JsonlObserver, ProgressObserver, TeeObserver
    from ..search.fuzz import fuzz
    from .store import CorpusStore, store_signature
    from ..search.mutate import KnobPlan
    # fail fast (and loudly, before compiling anything) on a dir written
    # by a structurally different runtime
    store = CorpusStore(args.corpus_dir, signature=store_signature(
        rt, KnobPlan.from_runtime(rt)))
    # fsync per record: under supervise_campaign respawns the observer
    # log must be complete up to the last sync even across power loss
    obs = JsonlObserver(store.worker_log_path(args.worker_id), fsync=True)
    if args.progress:
        obs = TeeObserver(obs, ProgressObserver())
    dry = (args.dry_rounds if args.dry_rounds is not None
           else args.max_rounds + 1)
    kw = dict(max_steps=args.max_steps, batch=args.batch,
              max_rounds=args.max_rounds, dry_rounds=dry,
              base_seed=args.base_seed, chunk=args.chunk,
              observer=obs, minimize=args.minimize,
              corpus_dir=args.corpus_dir, worker_id=args.worker_id,
              sync_every=args.sync_every,
              verify_resume=args.verify_resume or None)
    res = fuzz(rt, rng_seed=(args.rng_seed if args.rng_seed is not None
                             else args.worker_id), **kw)
    print(json.dumps({
        k: res[k] for k in
        ("seeds_run", "rounds", "rounds_done_total", "distinct_schedules",
         "saturated", "crashes", "corpus_size", "buckets_total",
         "buckets_opened", "shards") if k in res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
