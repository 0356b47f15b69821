"""Chrome-trace/Perfetto export: the visual timeline over virtual time (the
counterpart of `madsim_tpu.obs.trace`).

Converts either source of event records into one JSON document that
chrome://tracing and ui.perfetto.dev open directly:

  * a `collect_events` stream (Runtime.run(collect_events=True) /
    run_single) — frozen-lane `fired=False` records are filtered out;
  * a flight-recorder ring (obs/rings.py) from any final state, including
    one produced by `run_fused`.

Track layout: one thread track per node (tid = node id, named via
thread_name metadata), virtual-time microseconds on the time axis (a tick
is a microsecond). Every dispatch renders as an instant event; supervisor
ops land on the track of the node they act on, named "SUPER:<OP>". Ring
sources with lineage columns also render message causality: every
resolvable happens-before edge becomes a Perfetto flow arrow (`ph:"s"` at
the enqueuing dispatch, `ph:"f"` at the child), and instant args carry
step/lamport/parent. Rings of the span plane (marked by the `qw`
queue-wait column) also render each recorded completion as a request
duration span (an async `b`/`e` pair from its root to its completion).

Export contract: `export_chrome_trace` returns the INSTANT count only;
flow arrows and request spans ride in the document but are never counted.
The document is byte-identical to the JAX package's for the same records
(tests hold it to the frozen tests/data/golden_r22_trace.json).
"""

from __future__ import annotations

import json

import numpy as np

from ..core import types as T

_KIND = {T.EV_MSG: "MSG", T.EV_TIMER: "TIMER", T.EV_SUPER: "SUPER"}
_OP = {v: k[3:] for k, v in vars(T).items() if k.startswith("OP_")}


def _event(now, kind, node, src, tag, **extra):
    k = _KIND.get(kind, f"?{kind}")
    if kind == T.EV_SUPER:
        name = f"SUPER:{_OP.get(tag, tag)}"
    else:
        name = f"{k}:tag{tag}"
    return dict(name=name, ph="i", s="t", ts=now, pid=0, tid=node,
                args=dict(src=src, tag=tag, **extra))


def _doc(events: list[dict], node_names=None, node_args=None) -> dict:
    # counter-track events (ph="C", obs/profiler.py) carry no tid —
    # thread metadata names only the per-node instant/flow tracks.
    # node_args (r17) folds extra per-node facts (clock skew, disk
    # latency) into the thread metadata args, so a gray-failure run's
    # fault assignment reads straight off the Perfetto track list.
    tids = sorted({e["tid"] for e in events if "tid" in e})
    meta = [dict(name="thread_name", ph="M", pid=0, tid=t,
                 args=dict(name=(node_names[t] if node_names is not None
                                 else f"node{t}"),
                           **((node_args or {}).get(t, {}))))
            for t in tids]
    return dict(traceEvents=meta + events, displayTimeUnit="ms")


def to_chrome_events(source, b: int = 0) -> list[dict]:
    """Normalize a record source into Chrome-trace instant events.

    `source` is either the dict returned by `collect_events=True` (leaves
    shaped [steps, batch, ...]; `b` selects the lane and `fired=False`
    frozen-lane records are dropped) or a `ring_records()` dict (already
    one lane, already only real dispatches).

    Every instant event's `args` carries `step` — the dispatch index —
    so Perfetto queries can join the timeline against divergence
    reports and `explain_crash` chains (a stream's k-th `fired` record
    IS dispatch k, matching the ring's `tr_step`). Ring sources with
    lineage columns (r10) additionally carry `parent` and `lamport`,
    and each resolvable happens-before edge is rendered as a Perfetto
    FLOW arrow: a `ph:"s"` at the parent dispatch paired with a
    `ph:"f"` at the child (id = the child's dispatch index), appended
    after the instants.
    """
    if "fired" in source:                      # collect_events stream
        cols = {k: np.asarray(source[k])[:, b]
                for k in ("fired", "now", "kind", "node", "src", "tag")}
        idx = np.nonzero(cols["fired"])[0]
        return [_event(int(cols["now"][i]), int(cols["kind"][i]),
                       int(cols["node"][i]), int(cols["src"][i]),
                       int(cols["tag"][i]), step=k)
                for k, i in enumerate(idx)]
    cols = source                              # ring_records dict
    n = len(np.asarray(cols["now"]))
    steps = cols.get("step")
    parents = cols.get("parent")
    lamports = cols.get("lamport")
    out = []
    for i in range(n):
        extra = {}
        if steps is not None:
            extra["step"] = int(steps[i])
        if lamports is not None:
            extra["lamport"] = int(lamports[i])
        if parents is not None:
            extra["parent"] = int(parents[i])
        out.append(_event(int(cols["now"][i]), int(cols["kind"][i]),
                          int(cols["node"][i]), int(cols["src"][i]),
                          int(cols["tag"][i]), **extra))
    if steps is not None and parents is not None:
        # message causality as arrows on the per-node tracks: one flow
        # start ("s") at the enqueuing dispatch, one finish ("f") at the
        # child, bound by id = child dispatch index (each dispatch has
        # exactly one parent). Edges whose parent fell off the ring are
        # simply not drawn — the wrap contract (obs/causal.py).
        present = {int(s): i for i, s in enumerate(steps)}
        for i in range(n):
            p = int(parents[i])
            if p < 0 or p not in present:
                continue
            j = present[p]
            flow = dict(name="causal", cat="causal", id=int(steps[i]),
                        pid=0)
            out.append(dict(flow, ph="s", ts=int(cols["now"][j]),
                            tid=int(cols["node"][j])))
            out.append(dict(flow, ph="f", bp="e", ts=int(cols["now"][i]),
                            tid=int(cols["node"][i])))
    lats = cols.get("lat")
    if steps is not None and lats is not None and "qw" in cols:
        # request duration spans (r23): one async "b"/"e" pair per
        # recorded completion, spanning its root dispatch → completion
        # in virtual time (ts = now − recorded e2e), id = the
        # completion's dispatch index — joinable against
        # `explain_latency` output. Gated on the `qw` column, the
        # attribution plane's ring marker (cfg.span_attr): a span-off
        # document is byte-identical to what r22 wrote.
        for i in range(n):
            lat = int(lats[i])
            if lat < 0:
                continue
            span = dict(name=f"request:tag{int(cols['tag'][i])}",
                        cat="request", id=int(steps[i]), pid=0)
            out.append(dict(span, ph="b", ts=int(cols["now"][i]) - lat,
                            args=dict(step=int(steps[i]), lat_us=lat,
                                      node=int(cols["node"][i]))))
            out.append(dict(span, ph="e", ts=int(cols["now"][i])))
    return out


def export_chrome_trace(path: str, events=None, b: int = 0,
                        state=None, lane: int = 0, node_names=None) -> int:
    """Write one lane's trace as Chrome/Perfetto JSON; returns the number
    of INSTANT events written — which equals the lane's `fired=True`
    record count (collect_events source) or its surviving ring length
    (state source). Causal flow arrows (`ph:"s"/"f"` pairs, emitted for
    ring sources with lineage columns) and request duration spans
    (`ph:"b"/"e"` pairs, emitted for attribution-plane rings, r23) ride
    in the document but are not counted — they annotate dispatches,
    they aren't dispatches.

    Pass exactly one source: `events` (+ `b`) from a
    `collect_events=True` run, or `state` (+ `lane`) to read the
    flight-recorder ring of a final state — the only trace source a
    `run_fused` sweep has.
    """
    if (events is None) == (state is None):
        raise ValueError("pass exactly one of events= or state=")
    node_args = None
    if state is not None:
        from .rings import ring_records
        out = to_chrome_events(ring_records(state, lane))
        # gray-failure fault assignment (r17) on the track args: the
        # lane's final per-node clock skew and disk latency, included
        # only when some node actually carries a fault — a clean run's
        # golden document is byte-identical to r16's
        skew, dlat = state.skew, state.disk_lat
        if skew.ndim == 2:          # batched state: this lane's view
            skew, dlat = skew[lane], dlat[lane]
        skew, dlat = skew.cpu().numpy(), dlat.cpu().numpy()
        if skew.any() or dlat.any():
            node_args = {n: dict(skew=int(skew[n]),
                                 disk_lat=int(dlat[n]))
                         for n in range(skew.shape[0])}
    else:
        out = to_chrome_events(events, b)
    with open(path, "w") as f:
        json.dump(_doc(out, node_names, node_args), f)
    return sum(1 for e in out if e["ph"] == "i")
