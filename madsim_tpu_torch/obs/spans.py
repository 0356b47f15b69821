"""Request spans: per-hop critical paths over the span plane (the
counterpart of `madsim_tpu.obs.spans`).

With `cfg.span_attr` the engine carries a per-row span accumulator
(`ev_span`) and records each dispatch's own queue-wait in the ring's
`qw` column, which makes every completion's chain decomposable on the
host into per-hop (wait, transit) segments from the ring alone:

    wait(hop)    = qw[hop]                      the dispatch's sojourn
                                                past its deadline
    transit(hop) = (now[hop] - qw[hop])         deadline minus the
                   - now[parent]                parent's dispatch time

Segments telescope: over a completion's chain, sum wait + sum transit ==
the ring's recorded e2e latency, the identity the device's `sa_tail`
fold keeps too. A chain stops where the device's measurement stops: at
an external root (parent == -1) or at a root-kind re-mint.

Everything here is host-side numpy over a `ring_records()` read, except
`explain_latency(replay=True)` on a chain the ring wrapped past, which
re-runs the lane from a harvested checkpoint (obs/timetravel.py).
"""

from __future__ import annotations

import numpy as np

from .causal import _rec_at
from .rings import ring_records


def _require_span(recs: dict) -> None:
    if "qw" not in recs:
        raise ValueError(
            "no span columns in the ring: build with "
            "SimConfig(span_attr=True) (and trace_cap > 0) — the qw "
            "queue-wait column is what makes per-hop attribution "
            "host-recoverable")


def _is_root_kind(recs: dict, i: int, root_kinds) -> bool:
    return any(int(recs["kind"][i]) == int(k) and int(recs["tag"][i]) == int(t)
               for k, t in root_kinds)


def request_span(recs: dict, from_step: int | None = None, *,
                 root_kinds=()) -> dict:
    """Decompose one dispatch's causal chain into per-hop segments.

    `recs` is a `ring_records()` dict from a `span_attr` build;
    `from_step` the DISPATCH INDEX to decompose (default: the lane's
    last recorded dispatch — for a completion, pass its step). Returns

      hops         hop records, OLDEST first, ENDING at `from_step`;
                   each is the causal record (step/now/kind/node/src/
                   tag/parent/lamport) plus wait_us / transit_us /
                   seg_us (wait + transit; transit_us is None on the
                   oldest hop of a truncated chain — its parent's
                   dispatch time is gone)
      root         the record the chain is measured FROM (the external
                   root or the re-mint dispatch), or None if truncated
      reminted     the root is a `root_kinds` re-mint, not an external
      truncated    the walk hit a parent overwritten by ring wrap —
                   hops are a faithful SUFFIX, totals partial
      lat_us       now(from_step) − now(root), None when truncated
      wait_us / transit_us    segment totals over the resolved hops
      dominant     {hop, node, seg_us} of the FIRST strictly-largest
                   segment walking root→completion — the same
                   strict-> update rule the device's dominant-segment
                   fold applies (core/step.py), so the two agree
                   hop-for-hop; None when no hop resolved fully

    The single-parent caveat: the engine's parent edge is the dispatch
    that ENQUEUED the event, so a chain is the request's one dependency
    path — which for this event model IS the critical path. Protocols
    that logically join several messages (quorums) surface only the
    edge of the message that actually enqueued the continuation.

    Raises ValueError on a ring without span columns (`span_attr` off),
    an empty ring, or a `from_step` the ring does not hold.
    """
    _require_span(recs)
    steps = np.asarray(recs["step"])
    n = len(steps)
    if n == 0:
        raise ValueError("empty ring — nothing to decompose "
                         "(did the lane ever dispatch?)")
    by_step = {int(s): i for i, s in enumerate(steps)}
    if from_step is None:
        i = n - 1
    elif int(from_step) in by_step:
        i = by_step[int(from_step)]
    else:
        raise ValueError(f"dispatch step {from_step} is not in the ring "
                         "(overwritten by wrap, or never recorded)")

    idxs = []                    # chain indices, NEWEST first
    root_i = None
    reminted = False
    truncated = False
    while True:
        idxs.append(i)
        parent = int(recs["parent"][i])
        if parent < 0:
            # external mint: the event roots at its OWN dispatch — it
            # is the chain's clock origin, not one of its hops
            root_i = idxs.pop()
            break
        if parent not in by_step:
            truncated = True
            break
        ip = by_step[parent]
        if _is_root_kind(recs, ip, root_kinds):
            root_i = ip
            reminted = True
            break
        i = ip

    idxs.reverse()               # oldest hop first
    hops = []
    wait_total = 0
    transit_total = 0
    for k, j in enumerate(idxs):
        h = _rec_at(recs, j)
        h["wait_us"] = int(recs["qw"][j])
        prev_now = (int(recs["now"][idxs[k - 1]]) if k > 0
                    else int(recs["now"][root_i]) if root_i is not None
                    else None)
        if prev_now is None:     # oldest hop of a truncated chain
            h["transit_us"] = None
            h["seg_us"] = None
        else:
            h["transit_us"] = (int(recs["now"][j]) - h["wait_us"]
                               - prev_now)
            h["seg_us"] = h["wait_us"] + h["transit_us"]
        wait_total += h["wait_us"]
        transit_total += h["transit_us"] or 0
        hops.append(h)

    dominant = None
    for k, h in enumerate(hops):
        if h["seg_us"] is not None and (dominant is None
                                        or h["seg_us"] > dominant["seg_us"]):
            dominant = dict(hop=k, node=h["node"], seg_us=h["seg_us"])

    root = _rec_at(recs, root_i) if root_i is not None else None
    lat = (int(recs["now"][idxs[-1]]) - root["now"]
           if root is not None and idxs else None)
    return dict(hops=hops, root=root, reminted=reminted,
                truncated=truncated, lat_us=lat,
                wait_us=wait_total, transit_us=transit_total,
                dominant=dominant)


def request_spans(state, lane: int = 0, *, root_kinds=(),
                  slo_target: int | None = None) -> list[dict]:
    """Every completion the lane's ring still holds, decomposed: a
    `request_span` per record with a recorded e2e latency (the ring's
    `lat` column, `cfg.complete_kinds`), ring order, each extended with
    `step` / `lat_us` (the ring's own measurement — asserted equal to
    the span's root-walk when the chain resolved) and, when
    `slo_target` is given, `tail` (lat > target). Raises like
    `request_span`; completions whose chain wrapped come back
    `truncated=True` rather than being dropped."""
    recs = ring_records(state, lane)
    _require_span(recs)
    if "lat" not in recs:
        raise ValueError("no completion latencies in the ring: set "
                         "cfg.complete_kinds (and latency_hist > 0)")
    lat = np.asarray(recs["lat"])
    out = []
    for i in np.nonzero(lat >= 0)[0]:
        sp = request_span(recs, int(recs["step"][i]),
                          root_kinds=root_kinds)
        if sp["lat_us"] is not None:
            assert sp["lat_us"] == int(lat[i]), \
                (sp["lat_us"], int(lat[i]))   # the telescoping identity
        sp["step"] = int(recs["step"][i])
        sp["lat_us"] = int(lat[i])
        if slo_target is not None:
            sp["tail"] = int(lat[i]) > int(slo_target)
        out.append(sp)
    return out


def explain_latency(state, lane: int = 0, *, rank: int = 0,
                    root_kinds=None, replay: bool = False, rt=None,
                    ckpts=None, max_steps: int = 100_000, chunk: int = 512,
                    trace_cap: int | None = None,
                    export_trace: str | None = None) -> dict:
    """Name the hop-by-hop critical path of a lane's slowest request.

    Ranks the lane's recorded completions by e2e latency (`rank=0` the
    slowest, 1 the runner-up, ...; ties break toward the earlier
    dispatch, so re-running on the same state names the same request)
    and returns its `request_span` extended with
      lane / rank / step      which request this is
      slo_target / slo_miss   the lane's dynamic SLO verdict for it
      dropped                 the ring's wrap-overwrite count
      replayed [/ from_step]  whether window replay recovered the chain

    `root_kinds` defaults from `rt.cfg` when a runtime is passed (the
    usual call shape), else to () — external roots only.

    replay=True on a truncated chain (pass `rt=` and the sweep's
    harvested `ckpts=`, a CheckpointLog from `run(ckpt_every=...)`)
    recovers the chain by window replay from the newest checkpoint
    preceding it, with a ring sized to the whole window, checked against
    the live lane on fingerprint and crash verdict (ReplayDivergence on a
    mismatch): `truncated=False` whenever a checkpoint precedes the
    chain's root. On a whole chain there is nothing to recover and the
    live answer is returned. `export_trace=` writes the Perfetto trace
    (with the request duration spans, obs/trace.py) of whichever state
    the answer came from.

    Raises ValueError when the ring/span columns are compiled out, the
    lane recorded no completions, or `rank` is out of range.
    """
    if root_kinds is None:
        root_kinds = tuple(rt.cfg.root_kinds) if rt is not None else ()

    def pick(recs):
        if "lat" not in recs:
            raise ValueError("no completion latencies in the ring: set "
                             "cfg.complete_kinds (and latency_hist > 0)")
        lat = np.asarray(recs["lat"])
        done = np.nonzero(lat >= 0)[0]
        if len(done) == 0:
            raise ValueError(f"lane {lane} recorded no completions — "
                             "nothing to explain")
        if not 0 <= rank < len(done):
            raise ValueError(f"rank {rank} out of range: the ring holds "
                             f"{len(done)} completions")
        # slowest first; ties toward the earlier dispatch (stable sort
        # over (-lat, step) — deterministic on re-run by construction)
        order = sorted(done, key=lambda i: (-int(lat[i]),
                                            int(recs["step"][i])))
        i = order[rank]
        return int(recs["step"][i]), int(lat[i])

    def lane_scalar(leaf):
        a = leaf.cpu().numpy()
        return a[lane] if a.ndim else a

    recs = ring_records(state, lane)
    _require_span(recs)
    step, lat = pick(recs)
    span = request_span(recs, step, root_kinds=root_kinds)
    slo = int(lane_scalar(state.slo_target))
    out = dict(span, lane=int(lane), rank=int(rank), step=step,
               lat_us=lat, slo_target=slo,
               slo_miss=bool(slo > 0 and lat > slo),
               dropped=int(recs["dropped"]), replayed=False)

    if replay and span["truncated"]:
        if rt is None:
            raise ValueError("explain_latency(replay=True) needs rt= "
                             "(and usually ckpts= — a CheckpointLog "
                             "harvested with run(ckpt_every=...))")
        from .timetravel import replay_window
        live = dict(fingerprint=int(rt.fingerprints(state)[lane]),
                    crashed=bool(lane_scalar(state.crashed)),
                    crash_code=int(lane_scalar(state.crash_code)),
                    crash_node=int(lane_scalar(state.crash_node)))
        lane_steps = int(lane_scalar(state.steps))
        live_halted = bool(lane_scalar(state.halted))
        until = None if live_halted else lane_steps
        cks = (ckpts.iter_checkpoints(lane, before_step=step)
               if ckpts is not None else ())
        any_ckpt = False
        best = None
        for ckpt in cks:
            any_ckpt = True
            win = replay_window(
                rt, ckpt, until_step=until, max_steps=max_steps,
                chunk=chunk, expect=live,
                trace_cap=(trace_cap if trace_cap is not None
                           else max(16, lane_steps - ckpt.steps)))
            rrecs = ring_records(win["state"], 0)
            rspan = request_span(rrecs, step, root_kinds=root_kinds)
            cand = {**out, **rspan, "lat_us": lat, "replayed": True,
                    "from_step": int(ckpt.steps)}
            if not rspan["truncated"]:
                out = cand
                if export_trace is not None:
                    from .trace import export_chrome_trace
                    export_chrome_trace(export_trace, state=win["state"],
                                        lane=0)
                    out["trace_path"] = export_trace
                return out
            if best is None or len(rspan["hops"]) > len(best["hops"]):
                best = cand      # the root precedes this checkpoint too
        if not any_ckpt:
            raise ValueError(
                f"no harvested checkpoint covers lane {lane} before "
                f"dispatch {step} — run with ckpt_every=...")
        out = best if best is not None else out

    if export_trace is not None:
        from .trace import export_chrome_trace
        export_chrome_trace(export_trace, state=state, lane=lane)
        out["trace_path"] = export_trace
    return out


def format_span(exp: dict) -> str:
    """Render an `explain_latency` / `request_span` dict as an aligned
    per-hop table: one line per hop (node, wait, transit, segment), the
    dominant hop starred, totals and the SLO verdict in the footer."""
    lines = []
    lat = exp.get("lat_us")
    head = f"request @ step {exp['step']}" if "step" in exp else "request"
    if lat is not None:
        head += f": {lat} us e2e"
    slo = exp.get("slo_target", 0)
    if slo:
        head += (f" (SLO {slo} us — "
                 + ("MISS" if exp.get("slo_miss") else "ok") + ")")
    lines.append(head)
    root = exp.get("root")
    if root is not None:
        lines.append(
            f"  root: {'re-mint' if exp.get('reminted') else 'external'}"
            f" @ step {root['step']} node {root['node']} t={root['now']}")
    elif exp.get("truncated"):
        lines.append("  root: lost to ring wrap (chain is a suffix; "
                     "replay=True recovers it)")
    dom = exp.get("dominant") or {}
    for k, h in enumerate(exp["hops"]):
        star = " *" if dom.get("hop") == k else "  "
        tr = ("?" if h["transit_us"] is None else h["transit_us"])
        sg = ("?" if h["seg_us"] is None else h["seg_us"])
        lines.append(f"{star}hop {k}: node {h['node']} "
                     f"kind={h['kind']} tag={h['tag']} "
                     f"wait={h['wait_us']} transit={tr} seg={sg}")
    tail = (f"  totals: wait={exp['wait_us']} transit={exp['transit_us']}"
            + (" (partial — truncated)" if exp.get("truncated") else ""))
    lines.append(tail)
    if dom:
        lines.append(f"  bottleneck: node {dom['node']} "
                     f"(hop {dom['hop']}, {dom['seg_us']} us)")
    return "\n".join(lines)
