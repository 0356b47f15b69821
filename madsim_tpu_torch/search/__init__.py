"""Coverage-guided schedule search: the subsystem that SEARCHES the
schedule space instead of sampling it (the counterpart of
`madsim_tpu.search`).

  corpus.py   energy-scheduled corpus of knob vectors, deduped by
              sched_hash coverage (host numpy)
  mutate.py   the per-lane knob schema, the havoc mutation kernel and the
              knob-write kernel
  pct.py      PCT-style tie-break perturbation (SimState.prio_nudge)
  fuzz.py     the pipelined loop-until-dry driver

Not ported yet: the mesh-sharded driver (shard.py) and lineage-driven
fault targeting (ldfi.py); see ROADMAP P13 and P15.
"""

from .corpus import Corpus, merge_consensus
from .fuzz import fuzz
from .mutate import N_MUT_OPS, OP_NAMES, KnobPlan
from .pct import pct_sweep, with_prio_nudge

__all__ = ["Corpus", "KnobPlan", "fuzz", "pct_sweep", "with_prio_nudge",
           "merge_consensus", "OP_NAMES", "N_MUT_OPS"]
