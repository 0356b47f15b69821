"""Event-trace formatting: the virtual-time logger.

The port's copy of `madsim_tpu.runtime.trace`'s text renderer. The
reference's logger stamps every record with virtual time, node and
target (`[virtual-time level node target] msg`, runtime/mod.rs:342-383)
and can filter records before a virtual instant (MADSIM_LOG_TIME_START,
runtime/mod.rs:349-358). Here the engine emits a structured event record
per step when run with collect_events=True (numpy arrays shaped
[steps, B, ...]); this module renders one seed's stream the same way,
line for line as the JAX package renders it. The Perfetto export of the
same records is `obs/trace.py`; `export_chrome_trace` here is the
original exporter signature, kept as a shim over it.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import types as T

# event-name rendering: the JAX package's obs/trace.py tables
_KIND = {T.EV_MSG: "MSG", T.EV_TIMER: "TIMER", T.EV_SUPER: "SUPER"}
_OP = {v: k[3:] for k, v in vars(T).items() if k.startswith("OP_")}


def _columns(events: dict, b: int):
    """One seed's event columns + the indices of fired steps."""
    cols = {k: np.asarray(events[k])[:, b]
            for k in ("fired", "now", "kind", "node", "src", "tag")}
    return cols, np.nonzero(cols["fired"])[0]


def format_trace(events: dict, b: int = 0, time_start: int | None = None,
                 node_names=None, limit: int | None = None) -> list[str]:
    """Render trajectory b's event stream as text lines.

    events: the structure returned by Runtime.run(collect_events=True).
    time_start filters records before a virtual instant; when None it
    honors the MADSIM_LOG_TIME_START env var (milliseconds).
    """
    if time_start is None:
        v = os.environ.get("MADSIM_LOG_TIME_START")
        time_start = int(float(v) * T.TICKS_PER_MS) if v else 0
    cols, idx = _columns(events, b)
    now, kind = cols["now"], cols["kind"]
    node, src, tag = cols["node"], cols["src"], cols["tag"]
    lines = []
    for i in idx:
        if now[i] < time_start:
            continue
        t_ms = now[i] / T.TICKS_PER_MS
        name = (node_names[node[i]] if node_names is not None
                else f"node{node[i]}")
        k = _KIND.get(int(kind[i]), f"?{kind[i]}")
        if kind[i] == T.EV_MSG:
            detail = f"tag={tag[i]} from {src[i]}"
        elif kind[i] == T.EV_SUPER:
            detail = _OP.get(int(tag[i]), f"op={tag[i]}")
        else:
            detail = f"tag={tag[i]}"
        lines.append(f"[{t_ms:12.3f}ms {name:>7} {k:>5}] {detail}")
        if limit is not None and len(lines) >= limit:
            break
    return lines


def print_trace(events: dict, b: int = 0, **kw) -> None:
    for line in format_trace(events, b, **kw):
        print(line)


def export_chrome_trace(events: dict, path: str, b: int = 0,
                        node_names=None) -> int:
    """Back-compat shim for the original exporter signature; the
    implementation (and the ring-source variant `run_fused` sweeps need)
    lives in obs/trace.py."""
    from ..obs.trace import export_chrome_trace as _export
    return _export(path, events=events, b=b, node_names=node_names)
