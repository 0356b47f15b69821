"""The emission write of one step: `emit_write`, a hand-written CUDA kernel
(csrc/emit_write.cu), and `emit_write_plain`, the same function in plain
PyTorch.

It replaces the XLA-lowered emission write of the JAX package's step
(`madsim_tpu/core/step.py` `live_step` section 4, lines 476-655): rank
each lane's free event-table rows, put every send through the network
fault model (clog, loss and latency draws, micro-jitter, disk delay) and
every timer through the clock-skew stretch, and write the emissions that
survive into their rows — with the lineage plane, their provenance pair
too, with the latency plane their root-birth time (`ev_root_t`,
lines 629-641), and with the span plane their carried span vector
(`ev_span`, lines 642-653). Its epilogue is the flight-recorder ring
write (lines 941-1001): where the step dispatched an event in a sampled
lane, the ring row at `trace_pos mod trace_cap` takes the event's
record, with the profiler's queue-depth column (`tr_qlen`), the latency
plane's e2e column (`tr_lat`) and the span plane's queue-wait column
(`tr_qw`, lines 977-981) when those planes are compiled in. With `delay=True`
(the profiler) it also sums the latency imposed on delivered sends
(`delay_acc`, lines 485 and 528-532). Every value is an integer or the
exact float32 compare of a Bernoulli draw, so kernel and plain version
agree exactly.

Unlike the JAX function, which returns new tables, both versions write IN
PLACE: the rows emissions take (every table column, the payload words,
the provenance pairs) and the one ring row go straight into the tensors
they are given, and every other row is left untouched. That saves the
copy of every unchanged row (about 1.5 GB a step at the flagship's
B=100,000). The caller must own what it hands in: the step writes the
state it is given, and the runners step a private copy of the caller's
state (runtime/runtime.py).

Operands, all with a leading [B] lane axis (int32 unless noted):

  tables  t_deadline, t_kind, t_node, t_src, t_tag [B, C], t_payload
          [B, C, P], ev_prov [B, C, 2] ([B, 0, 2] with the lineage plane
          compiled out: then it is returned as it is); optional ev_root_t
          [B, C] ([B, 0], or absent, with the latency plane compiled out)
          and ev_span [B, C, 6] ([B, 0, 6], or absent, with the span
          plane compiled out)
  em      the staged emissions, sends first: m bool [B, E], a [B, E] (a
          send's destination, a timer's delay), tag [B, E], payload
          [B, E, P]; E may be 0
  lane    now, h_node (the acting node), sk_h and dlat_h (its clock skew
          and disk delay), loss float32, lat_lo, lat_hi, jitter, k_net
          [B, 2] (the step's network key, int32 bit patterns), clog_node
          bool [B, N], clog_link bool [B, N, N], disp_idx (this dispatch's
          index) and ev_lamport (its Lamport clock); with ev_root_t, ev_root
          (the dispatch's post-mint root); with ev_span, span_new [B, 6]
          (the span vector its emissions carry); with tr_qlen, occ_disp
          (the table's pre-pop occupancy); with tr_lat, lat_ring (the
          completion's e2e latency, or -1); with tr_qw, lat_sojourn (the
          dispatch's queue-wait)
  ring    None (recorder compiled out) or fired bool, trace_on bool,
          trace_pos, trace_cap, kind, node, src, tag, parent [B] and the
          columns tr_now, tr_step, tr_kind, tr_node, tr_src, tr_tag,
          tr_parent, tr_lamport [B, TC], and the optional tr_qlen, tr_lat
          and tr_qw [B, TC] ([B, 0], or absent, when compiled out)

Returns (tables, stats, ring): a dict of the very table tensors it was
given, written in place; stats = sent, delivered_drop int32, overflow
bool, high_water int32 [B] (and with delay=True delay_acc int32 [B]); and
the ring (None without one): a new trace_pos [B] and the very column
tensors it was given, written in place.

`emit_write` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. `emit_write.launches`
counts kernel launches; a launch recorded into a CUDA graph under capture
counts in `emit_write.captured` instead (a replay launches it again
without calling the wrapper).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import prng
from ..core import types as T
from . import select as sel

MAX_C = 384   # the rank walks C rows in batches; nothing is sized by C
MAX_N = 32
MAX_E = 32    # one emission per thread of a warp

TABLE_COLS = ("t_deadline", "t_kind", "t_node", "t_src", "t_tag",
              "t_payload", "ev_prov")
RING_COLS = ("tr_now", "tr_step", "tr_kind", "tr_node", "tr_src", "tr_tag",
             "tr_parent", "tr_lamport")
# the plane columns: optional, zero-size when their plane is compiled out
PLANE_TABLE_COLS = ("ev_root_t", "ev_span")
PLANE_RING_COLS = ("tr_qlen", "tr_lat", "tr_qw")
SPAN_WORDS = 6
# each plane ring column's lane operand
_PLANE_RING_VALS = dict(tr_qlen="occ_disp", tr_lat="lat_ring",
                        tr_qw="lat_sojourn")
_I32 = torch.int32


def drift(t, sk):
    """(t * sk) >> 10 in exact int32-safe pieces — the clock-skew fold;
    identically 0 at sk == 0."""
    return (t >> 10) * sk + (((t & 1023) * sk) >> 10)


def _present(cols, name) -> bool:
    """Whether an optional plane column is compiled in (there and not
    zero-size)."""
    t = cols.get(name)
    return t is not None and t.shape[1] > 0


def _ring_plain(lane, ring):
    rec_w = ring["fired"] & ring["trace_on"]
    cols = ring["cols"]
    TC = cols["tr_now"].shape[1]
    slot = torch.remainder(ring["trace_pos"], ring["trace_cap"])
    lanes = torch.nonzero(rec_w & (slot >= 0) & (slot < TC))[:, 0]
    rows = slot[lanes].to(torch.int64)
    vals = dict(tr_now=lane["now"], tr_step=lane["disp_idx"],
                tr_kind=ring["kind"], tr_node=ring["node"],
                tr_src=ring["src"], tr_tag=ring["tag"],
                tr_parent=ring["parent"], tr_lamport=lane["ev_lamport"])
    for k, v in _PLANE_RING_VALS.items():
        if _present(cols, k):
            vals[k] = lane[v]
    for k in vals:
        cols[k].index_put_((lanes, rows), vals[k][lanes].to(cols[k].dtype))
    return dict(trace_pos=ring["trace_pos"] + rec_w.to(_I32), cols=cols)


def emit_write_plain(tables, em, lane, ring, n_sends: int,
                     use_jitter: bool, delay: bool = False):
    """Plain PyTorch form of the emission write, in place (operands and
    results in the module doc)."""
    t_kind = tables["t_kind"]
    B = t_kind.shape[0]
    dev = t_kind.device
    E = em["m"].shape[1]
    zi = torch.zeros(B, dtype=_I32, device=dev)
    stats = dict(sent=zi, delivered_drop=zi,
                 overflow=torch.zeros(B, dtype=torch.bool, device=dev),
                 high_water=zi)
    if delay:
        stats["delay_acc"] = zi
    out = dict(tables)
    if E > 0:
        n_timers = E - n_sends
        N = lane["clog_node"].shape[1]
        now, h_node = lane["now"], lane["h_node"]
        dlat_h = lane["dlat_h"]
        free = t_kind == T.EV_FREE
        occupied_now = (~free).sum(-1, dtype=_I32)
        slots, slot_ok = sel.first_k_free(free, E)
        ns = max(n_sends, 1)
        net_keys = prng.split(lane["k_net"],
                              2 * ns + (E if use_jitter else 0))
        # per-emission micro-jitter (statically gated, as in the JAX
        # package: a jitterless build draws nothing)
        jit = (prng.randint(net_keys[:, 2 * ns:], 0, lane["jitter"][:, None])
               if use_jitter else None)
        m, a = em["m"], em["a"]
        overflow = stats["overflow"]
        writes, deadlines, kinds, nodes = [], [], [], []
        if n_sends:
            m_s = m[:, :n_sends]
            dst = torch.clamp(a[:, :n_sends], 0, N - 1)
            src_links = sel.take_row(lane["clog_link"], h_node)   # [B, N]
            clogged = (sel.take1(lane["clog_node"], h_node)[:, None]
                       | sel.take1(lane["clog_node"], dst)
                       | sel.take1(src_links, dst))
            lost = prng.bernoulli(net_keys[:, 0:2 * n_sends:2],
                                  lane["loss"][:, None])
            latency = prng.randint(net_keys[:, 1:2 * n_sends:2],
                                   lane["lat_lo"][:, None],
                                   lane["lat_hi"][:, None])
            if use_jitter:
                latency = latency + jit[:, :n_sends]
            ok = m_s & ~clogged & ~lost
            stats["sent"] = m_s.sum(-1, dtype=_I32)
            stats["delivered_drop"] = (m_s & ~ok).sum(-1, dtype=_I32)
            if delay:
                # the latency imposed on delivered sends (a dropped send
                # imposes a drop, not a delay); int32, wrapping
                stats["delay_acc"] = torch.where(ok, latency, 0).sum(
                    -1).to(_I32)
            writes.append(ok & slot_ok[:, :n_sends])
            overflow = overflow | (ok & ~slot_ok[:, :n_sends]).any(-1)
            deadlines.append(now[:, None] + latency + dlat_h[:, None])
            kinds.append(torch.full_like(dst, T.EV_MSG))
            nodes.append(dst)
        if n_timers:
            m_t = m[:, n_sends:]
            ok_t = slot_ok[:, n_sends:]
            overflow = overflow | (m_t & ~ok_t).any(-1)
            writes.append(m_t & ok_t)
            delay = a[:, n_sends:]
            # clock-skew stretch, then the slow-disk delay
            d_eff = torch.clamp(delay - drift(delay, lane["sk_h"][:, None]),
                                min=0)
            deadline = now[:, None] + d_eff + dlat_h[:, None]
            deadlines.append(deadline + jit[:, n_sends:] if use_jitter
                             else deadline)
            kinds.append(torch.full_like(delay, T.EV_TIMER))
            nodes.append(h_node[:, None].expand(B, n_timers))
        w = torch.cat(writes, -1)                            # [B, E]
        stats["overflow"] = overflow
        stats["high_water"] = occupied_now + w.sum(-1, dtype=_I32)
        # written (lane, emission) pairs only: their rows are distinct
        lanes, es = torch.nonzero(w, as_tuple=True)
        rows = slots[lanes, es].to(torch.int64)

        def put(col, v):
            col.index_put_((lanes, rows), v[lanes, es].to(col.dtype))

        put(tables["t_deadline"], torch.cat(deadlines, 1))
        put(t_kind, torch.cat(kinds, 1))
        put(tables["t_node"], torch.cat(nodes, 1))
        put(tables["t_src"], h_node[:, None].expand(B, E))
        put(tables["t_tag"], em["tag"])
        put(tables["t_payload"], em["payload"])
        if tables["ev_prov"].shape[1] > 0:
            # every emission of a dispatch carries the same provenance:
            # enqueued by this dispatch, at the acting node's clock
            prov = torch.stack([lane["disp_idx"], lane["ev_lamport"]], -1)
            put(tables["ev_prov"], prov[:, None, :].expand(B, E, 2))
        if _present(tables, "ev_root_t"):
            # every emission inherits the dispatch's post-mint root
            put(tables["ev_root_t"], lane["ev_root"][:, None].expand(B, E))
        if _present(tables, "ev_span"):
            # and the span vector carried through this dispatch
            put(tables["ev_span"], lane["span_new"][:, None, :].expand(
                B, E, SPAN_WORDS))
    return out, stats, (None if ring is None else _ring_plain(lane, ring))


class _Params(ctypes.Structure):
    """csrc/emit_write.cu `EmitParams`, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in TABLE_COLS]
        + [(n, ctypes.c_void_p) for n in (
            "em_m", "em_a", "em_tag", "em_payload", "now", "h_node", "sk_h",
            "dlat_h", "loss", "lat_lo", "lat_hi", "jitter", "k_net",
            "clog_node", "clog_link", "disp_idx", "ev_lamport", "sent",
            "delivered_drop", "overflow", "high_water", "fired", "trace_on",
            "trace_pos", "trace_cap", "rec_kind", "rec_node", "rec_src",
            "rec_tag", "rec_parent")]
        + [("tr", ctypes.c_void_p * len(RING_COLS)),
           ("o_trace_pos", ctypes.c_void_p)]
        + [(n, ctypes.c_void_p) for n in (
            "ev_root_t", "ev_root", "tr_qlen", "occ_disp", "tr_lat",
            "lat_ring", "delay_acc", "ev_span", "span_new", "tr_qw",
            "lat_sojourn")]
        + [(n, ctypes.c_int) for n in (
            "B", "C", "P", "N", "E", "n_sends", "use_jitter", "has_prov",
            "TC")])


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"emit_write: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"emit_write: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"emit_write: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"emit_write: {name} must be contiguous")


class _EmitWrite:
    """Callable wrapper: CPU tensors -> `emit_write_plain`; CUDA tensors ->
    the kernel. `launches` counts kernel launches (and nothing else);
    `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            from .kernels import load
            fn = load("emit_write").emit_write_launch
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, tables, em, lane, ring, n_sends: int,
                 use_jitter: bool, delay: bool = False):
        dev = tables["t_kind"].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"emit_write: unsupported device {dev}")
        B, C = tables["t_kind"].shape
        P = tables["t_payload"].shape[2]
        N = lane["clog_node"].shape[1]
        E = em["m"].shape[1]
        prov_rows = tables["ev_prov"].shape[1]
        cuda = dev.type == "cuda"
        if cuda and tables["t_kind"].dtype != _I32:
            raise NotImplementedError(
                "emit_write: the CUDA kernel takes int32 event tables only "
                f"(table_dtype='int32'); got {tables['t_kind'].dtype}")
        if cuda and not (1 <= C <= MAX_C and 1 <= N <= MAX_N
                         and E <= MAX_E and 0 <= n_sends <= E):
            raise NotImplementedError(
                f"emit_write: the CUDA kernel supports 1 <= C <= {MAX_C}, "
                f"1 <= N <= {MAX_N} and E <= {MAX_E}; got C={C}, N={N}, "
                f"E={E}, n_sends={n_sends}")
        i32, b8 = torch.int32, torch.bool
        checks = [(n, tables[n], i32, (B, C)) for n in TABLE_COLS[:5]]
        checks += [("t_payload", tables["t_payload"], i32, (B, C, P)),
                   ("ev_prov", tables["ev_prov"], i32, (B, prov_rows, 2)),
                   ("em.m", em["m"], b8, (B, E)),
                   ("em.a", em["a"], i32, (B, E)),
                   ("em.tag", em["tag"], i32, (B, E)),
                   ("em.payload", em["payload"], i32, (B, E, P)),
                   ("loss", lane["loss"], torch.float32, (B,)),
                   ("k_net", lane["k_net"], i32, (B, 2)),
                   ("clog_node", lane["clog_node"], b8, (B, N)),
                   ("clog_link", lane["clog_link"], b8, (B, N, N))]
        checks += [(n, lane[n], i32, (B,)) for n in (
            "now", "h_node", "sk_h", "dlat_h", "lat_lo", "lat_hi", "jitter",
            "disp_idx", "ev_lamport")]
        if prov_rows not in (0, C):
            raise ValueError(f"emit_write: ev_prov has {prov_rows} rows, "
                             f"expected 0 or {C}")
        has_root = _present(tables, "ev_root_t")
        if has_root:
            checks += [("ev_root_t", tables["ev_root_t"], i32, (B, C)),
                       ("ev_root", lane["ev_root"], i32, (B,))]
        has_span = _present(tables, "ev_span")
        if has_span:
            checks += [("ev_span", tables["ev_span"], i32,
                        (B, C, SPAN_WORDS)),
                       ("span_new", lane["span_new"], i32, (B, SPAN_WORDS))]
        TC = 0
        plane_ring = []
        if ring is not None:
            TC = ring["cols"]["tr_now"].shape[1]
            checks += [(n, ring[n], b8, (B,)) for n in ("fired", "trace_on")]
            checks += [(n, ring[n], i32, (B,)) for n in (
                "trace_pos", "trace_cap", "kind", "node", "src", "tag",
                "parent")]
            checks += [(n, ring["cols"][n], i32, (B, TC)) for n in RING_COLS]
            plane_ring = [n for n in PLANE_RING_COLS
                          if _present(ring["cols"], n)]
            for n in plane_ring:
                v = _PLANE_RING_VALS[n]
                checks += [(n, ring["cols"][n], i32, (B, TC)),
                           (v, lane[v], i32, (B,))]
        # the CPU checks shapes and layout (what the kernel would be
        # handed), the CUDA path dtypes too
        for name, t, dt, shape in checks:
            _check(name, t, dt if cuda else t.dtype, shape, dev)
        if not cuda:
            return emit_write_plain(tables, em, lane, ring, n_sends,
                                    use_jitter, delay)

        # with no emission the kernel writes no statistic: they are 0
        alloc = torch.empty if E > 0 else torch.zeros
        stats = {n: alloc((B,), dtype=b8 if n == "overflow" else i32,
                          device=dev)
                 for n in ("sent", "delivered_drop", "overflow",
                           "high_water") + (("delay_acc",) if delay
                                            else ())}
        if E == 0 and ring is None:       # nothing to write: the identity
            return dict(tables), stats, None
        p = _Params()
        for n in TABLE_COLS:
            setattr(p, n, tables[n].data_ptr())
        for n in ("m", "a", "tag", "payload"):
            setattr(p, "em_" + n, em[n].data_ptr())
        for n in ("now", "h_node", "sk_h", "dlat_h", "loss", "lat_lo",
                  "lat_hi", "jitter", "k_net", "clog_node", "clog_link",
                  "disp_idx", "ev_lamport"):
            setattr(p, n, lane[n].data_ptr())
        for n, t in stats.items():
            setattr(p, n, t.data_ptr())
        ring_out = None
        if ring is not None:
            ring_out = dict(trace_pos=torch.empty((B,), dtype=i32,
                                                  device=dev),
                            cols=ring["cols"])
            for n in ("fired", "trace_on", "trace_pos", "trace_cap"):
                setattr(p, n, ring[n].data_ptr())
            for n in ("kind", "node", "src", "tag", "parent"):
                setattr(p, "rec_" + n, ring[n].data_ptr())
            for i, n in enumerate(RING_COLS):
                p.tr[i] = ring["cols"][n].data_ptr()
            p.o_trace_pos = ring_out["trace_pos"].data_ptr()
            for n in plane_ring:
                setattr(p, n, ring["cols"][n].data_ptr())
                v = _PLANE_RING_VALS[n]
                setattr(p, v, lane[v].data_ptr())
        if has_root:
            p.ev_root_t = tables["ev_root_t"].data_ptr()
            p.ev_root = lane["ev_root"].data_ptr()
        if has_span:
            p.ev_span = tables["ev_span"].data_ptr()
            p.span_new = lane["span_new"].data_ptr()
        p.B, p.C, p.P, p.N, p.E = B, C, P, N, E
        p.n_sends, p.use_jitter = n_sends, int(bool(use_jitter))
        p.has_prov, p.TC = int(prov_rows > 0), TC
        fn = self._kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(p), stream)
        if err != 0:
            raise RuntimeError(f"emit_write: kernel launch failed "
                               f"(cudaError {err})")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return dict(tables), stats, ring_out


emit_write = _EmitWrite()
