"""Success witnesses: declaring WHAT a green run's outcome was, so the
lineage plane can explain WHY it happened (the counterpart of
`madsim_tpu.harness.witness`).

The crash oracles (`recovery_invariant`, `slo_invariant`, model
invariants) are traced callables that mark a lane RED and implicate the
dispatch that did it — the causal plane then walks backward from that
dispatch for free, because the crash check runs inside the step it
indicts. A GREEN lane has no such anchor: nothing in the state says
which dispatch *was* the success. `success_witness` is the host-side
mirror of the oracle pattern: the model declares the shape of its
success event (kind / tag / node), and the witness locates the LAST
matching dispatch in a lane's flight-recorder ring — the record
lineage-driven fault injection (search/ldfi.py, DESIGN §23) walks
backward from to extract the support of success.

Host-side on purpose: witnesses run on `ring_records()` dicts after the
sweep, never inside the step — declaring a witness changes no
compiled program and pierces no replay-domain contract (unlike
installing a recovery oracle, which makes the series plane observable).

Default witness (kinds=()): the lane's final dispatch. For a lane that
ran to quiescence or HALT that is exactly "the outcome", and it keeps
`extract_support` usable on models that never declare anything.
"""

from __future__ import annotations

import numpy as np


def success_witness(kinds=(), *, tags=None, node=None):
    """Build a witness finder for `obs.support.extract_support`.

    Args:
      kinds: event kinds (EV_MSG / EV_TIMER / EV_SUPER) a success record
        may have; empty = any kind.
      tags: message/timer tags that mark success (e.g. the commit-ack
        tag); None = any tag.
      node: the node that must have dispatched it; None = any node.

    Returns `find(recs) -> ring index | None`: the LAST record of a
    `ring_records()` dict matching every given constraint, or None when
    the lane never dispatched a matching event (the run was not a
    witnessed success — callers skip its support).
    """
    kinds = tuple(int(k) for k in kinds)
    tagset = None if tags is None else {int(t) for t in tags}
    want_node = None if node is None else int(node)

    def find(recs: dict):
        n = len(np.asarray(recs["step"]))
        for i in range(n - 1, -1, -1):
            if kinds and int(recs["kind"][i]) not in kinds:
                continue
            if tagset is not None and int(recs["tag"][i]) not in tagset:
                continue
            if want_node is not None and int(recs["node"][i]) != want_node:
                continue
            return i
        return None

    return find
