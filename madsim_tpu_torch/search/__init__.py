"""Coverage-guided schedule search: the subsystem that SEARCHES the
schedule space instead of sampling it (the counterpart of
`madsim_tpu.search`).

  corpus.py   energy-scheduled corpus of knob vectors, deduped by
              sched_hash coverage (host numpy)
  mutate.py   the per-lane knob schema, the havoc mutation kernel and the
              knob-write kernel
  pct.py      PCT-style tie-break perturbation (SimState.prio_nudge)
  fuzz.py     the pipelined loop-until-dry driver, in memory or over a
              durable store (service/)
  ldfi.py     lineage-driven fault targeting: green-run supports pooled
              into a hitting-set ranking and synthesized into targeted
              knob vectors (fuzz(ldfi=LdfiConfig(...)))

Not ported yet: the mesh-sharded driver (shard.py); see ROADMAP P15.
"""

from .corpus import Corpus, merge_consensus
from .fuzz import fuzz
from .ldfi import LdfiConfig, SupportPool, synthesize
from .mutate import N_MUT_OPS, OP_NAMES, KnobPlan
from .pct import pct_sweep, with_prio_nudge

__all__ = ["Corpus", "KnobPlan", "fuzz", "pct_sweep", "with_prio_nudge",
           "merge_consensus", "OP_NAMES", "N_MUT_OPS",
           "LdfiConfig", "SupportPool", "synthesize"]
