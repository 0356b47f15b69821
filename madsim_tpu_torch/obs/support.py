"""Green-run support extraction: the happens-before slice a SUCCESS
depended on (the counterpart of `madsim_tpu.obs.support`).

The causal plane (r10) walks parent edges backward from a crash to
explain a failure; this module points the same walk at a SUCCESS — the
LDFI move (Alvaro et al., "Lineage-driven Fault Injection"): run green,
extract the support of the good outcome, and let the fault planner cut
precisely those edges instead of spraying faults blind. The support of
a lane is the set of message edges (src → dst at a sim-time instant)
and timer firings (node, deadline) on the lineage chain from the lane's
success witness (`harness.success_witness`, default: its last dispatch)
back to an external root.

Wrap honesty (the r11 suffix contract, verbatim): ring wrap truncates
lineage at the ROOT end, so a support extracted from a wrapped ring is
a faithful SUFFIX of the true support — `truncated=True` rides the
support dict and every consumer must treat the edge set as a lower
bound, never as "the whole story". `extract_support(replay=True)`
refuses to settle for the suffix: it re-executes the lane's
(seed, knobs) repro handle from the t=0 checkpoint (r20 window replay)
with the ring upgraded to hold every dispatch, and extracts the support
from the unwrapped replayed ring instead.

Everything here is host-side numpy over `ring_records()` reads (one
lane's ring columns copied off the device), so no captured graph changes
because a support was extracted.
"""

from __future__ import annotations

import numpy as np

from ..core import types as T
from .causal import walk_lineage
from .rings import ring_records


def support_from_records(recs: dict, witness=None) -> dict | None:
    """Extract the support of one lane's outcome from its ring records.

    `recs` is a `ring_records()` dict; `witness` a finder built by
    `harness.success_witness` (None = the lane's last dispatch). Returns
    None when the witness matches no record (the lane never dispatched
    its declared success event — there is no support to extract), else:

      msg_edges    [(src, dst, now)] — message deliveries on the chain
      timer_edges  [(node, now)]     — timer firings on the chain
      depth        chain length (records walked, witness included)
      witness_step the dispatch index walked back from
      truncated    ring wrap cut the walk: the edges are a faithful
                   SUFFIX of the true support (honest lower bound)
      root_external  the walk reached an external cause (complete)
    """
    n = len(np.asarray(recs["step"]))
    if n == 0:
        return None
    if witness is None:
        idx = n - 1
    else:
        idx = witness(recs)
        if idx is None:
            return None
    walk = walk_lineage(recs, from_step=int(recs["step"][idx]))
    msg_edges: list[tuple[int, int, int]] = []
    timer_edges: list[tuple[int, int]] = []
    for rec in walk["chain"]:
        if rec["kind"] == T.EV_MSG:
            msg_edges.append((rec["src"], rec["node"], rec["now"]))
        elif rec["kind"] == T.EV_TIMER:
            timer_edges.append((rec["node"], rec["now"]))
    return dict(msg_edges=msg_edges, timer_edges=timer_edges,
                depth=len(walk["chain"]),
                witness_step=int(recs["step"][idx]),
                truncated=walk["truncated"],
                root_external=walk["root_external"])


def extract_support(state, lane: int = 0, *, witness=None,
                    replay: bool = False, rt=None, seed: int | None = None,
                    knobs: dict | None = None, nudge: int | None = None,
                    max_steps: int = 100_000, chunk: int = 512) -> dict | None:
    """The support of a live lane's outcome (`support_from_records` over
    its ring), with the r20 escape hatch for wrapped rings: when the
    live support comes back `truncated=True` and `replay=True`, the
    lane's (seed[, knobs][, nudge]) handle is replayed from t=0 with
    the ring upgraded to hold the whole window (`full_chain_replay`
    machinery) and the support re-extracted from the unwrapped ring —
    full fidelity at replay cost. Returns None when the witness never
    matched; the result carries `lane` and `replayed`.

    Raises (via ring_records) if the ring is compiled out or the lane
    unsampled; ValueError if replay=True without rt= and seed=.
    """
    sup = support_from_records(ring_records(state, lane), witness)
    if sup is not None and sup["truncated"] and replay:
        if rt is None or seed is None:
            raise ValueError("extract_support(replay=True) needs rt= and "
                             "seed= (the lane's repro handle)")
        from .timetravel import init_checkpoint, replay_window
        until = int(state.steps.reshape(-1)[lane])
        ckpt = init_checkpoint(rt, seed, knobs=knobs, nudge=nudge)
        win = replay_window(rt, ckpt, until_step=until,
                            max_steps=max_steps, chunk=chunk)
        rsup = support_from_records(ring_records(win["state"], 0), witness)
        if rsup is not None:
            rsup.update(lane=int(lane), replayed=True)
            return rsup
    if sup is not None:
        sup.update(lane=int(lane), replayed=False)
    return sup
