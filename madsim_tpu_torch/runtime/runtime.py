"""Runtime: the batched supervisor (madsim::runtime::Runtime, vectorised).

Builds the step for one configuration and drives a whole batch of seeds
through it: `run` in chunks of `chunk` steps, syncing with the host once
per chunk to test whether every lane has halted — the chunk contract of
`madsim_tpu.runtime.runtime.Runtime.run` — and `run_fused` as a replayed
CUDA graph with no host sync per block. State lives on one device:
CUDA by default (the entry points raise when no GPU is present), or the
CPU when the caller passes `device="cpu"`. `run_compacting` repacks the
live lanes of a long-tailed sweep into narrower batches as lanes halt
(BASELINE.md config 4), `run_exact` advances exactly a number of steps
(time travel with `state_at`, divergence bisection), and `derived`
rebuilds the runtime with config fields replaced.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core import prng
from ..core import types as T
from ..core.api import Program
from ..core.device import resolve_device
from ..core.extension import build_ext_state
from ..core.state import SimState, init_state, map_state, tree_map
from ..core.step import make_step
from ..interop import state_leaves
from ..ops.lane_rows import lane_put, lane_take
from ..ops.select import first_k_free
from ..utils.hashing import fingerprint
from .scenario import Scenario


def _lanes_of(x, B):
    return x.unsqueeze(0).expand((B,) + tuple(x.shape)).clone()


# steps per captured CUDA graph: a step is some thousands of graph nodes,
# so a block of a few steps keeps capture and instantiation short
FUSED_BLOCK = 8


def _signature(state: SimState) -> tuple:
    return tuple((p, tuple(t.shape), t.dtype, str(t.device))
                 for p, t in state_leaves(state).items())


class FusedGraph:
    """`block` steps of a runtime's step function, captured as one CUDA
    graph over static state buffers, with the copy of the block's final
    state back into those buffers and `halted.all()` at its end.

    The step writes its input's event table and ring in place, so the
    graph's steps write the static buffers themselves: the caller's state
    is copied into them before a run, and a copy of them is returned.
    Capture needs every lazily built constant (prng's constant cache,
    the kernels' libraries, model tables) to exist first — building one
    inside the capture would copy from the host and break it — so the
    step runs WARMUP_STEPS times on a scratch copy of the state before.
    Kernel wrappers count the launches recorded in the capture in their
    `captured` counters; `captured` here holds the per-block numbers, so
    a run's launches are those times the replays."""

    WARMUP_STEPS = 1

    def __init__(self, step, state: SimState, block: int,
                 own: bool = False):
        """`own`: the caller hands `state` over, and its tensors become
        the static buffers (no copy); else the buffers are a copy."""
        from ..ops.kernels import wrappers
        self.block = block
        dev = state.now.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                scratch = map_state(torch.clone, state)
                for _ in range(self.WARMUP_STEPS):
                    scratch, _ = step(scratch)
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch
            self.static = state if own else map_state(torch.clone, state)
            kernels = wrappers()
            before = {k: w.captured for k, w in kernels.items()}
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                s = self.static
                for _ in range(block):
                    s, _ = step(s)
                self._copy_back(s)
                self.all_halted = self.static.halted.all()
            self.captured = {k: w.captured - before[k]
                             for k, w in kernels.items()}

    def _copy_back(self, out: SimState) -> None:
        """Copy the block's final state into the static buffers. A leaf
        the step wrote in place IS its static buffer and is skipped; a
        leaf sharing storage with any other static buffer raises (the
        copy would read a buffer it has already overwritten)."""
        static = state_leaves(self.static)
        ptrs = {t.untyped_storage().data_ptr() for t in static.values()
                if t.numel()}
        for path, t in state_leaves(out).items():
            dst = static[path]
            if t is dst:
                continue
            if t.numel() and t.untyped_storage().data_ptr() in ptrs:
                raise RuntimeError(
                    f"run_fused: leaf {path} of the captured block's final "
                    "state aliases an input buffer")
            dst.copy_(t)

    def run(self, state: SimState, n_steps: int):
        """Replay from `state` for n_steps (a multiple of the block), or
        until every lane has halted. Returns (a copy of the final state,
        the number of replays)."""
        self.load(state)
        replays = self.advance(n_steps)
        return map_state(torch.clone, self.static), replays

    def load(self, state: SimState) -> None:
        """Copy `state` into the static buffers (a leaf that IS its
        buffer is left as it is)."""
        static = state_leaves(self.static)
        for path, t in state_leaves(state).items():
            if t is not static[path]:
                static[path].copy_(t)

    def advance(self, n_steps: int) -> int:
        """Replay on the static buffers as they are for n_steps (a
        multiple of the block), or until every lane has halted; returns
        the number of replays."""
        flags = [torch.empty((), dtype=torch.bool).pin_memory()
                 for _ in range(2)]
        done = [torch.cuda.Event() for _ in range(2)]
        replays = 0
        for i in range(n_steps // self.block):
            self.graph.replay()
            flags[i % 2].copy_(self.all_halted, non_blocking=True)
            done[i % 2].record()
            replays += 1
            # read the previous block's flag while this block runs
            if i >= 1:
                done[(i - 1) % 2].synchronize()
                if bool(flags[(i - 1) % 2]):
                    break
        return replays


class Runtime:
    """Batched simulation runtime.

    Args:
      cfg: static SimConfig.
      programs: node programs (state machines).
      state_spec: one node's default protocol state (dict of tensors).
      node_prog: node -> program index (default: all nodes run programs[0]).
      scenario: scheduled supervisor ops; a HALT at cfg.time_limit is
        appended when the scenario has none.
      invariant: optional global safety check f(state) -> (bad, code).
      persist: optional dict of bools: stable-storage leaves.
      halt_when: optional success condition f(state) -> bool [B].
      extensions: Extension instances.
      device: "cuda" (the default, which requires a GPU), "cpu", or a
        torch.device.
    """

    def __init__(self, cfg: T.SimConfig, programs: Sequence[Program],
                 state_spec: Any, node_prog=None,
                 scenario: Scenario | None = None,
                 invariant: Callable | None = None, persist: Any = None,
                 halt_when: Callable | None = None,
                 extensions: Sequence = (), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.programs = list(programs)
        self.state_spec = state_spec
        self.node_prog = np.asarray(
            node_prog if node_prog is not None
            else np.zeros(cfg.n_nodes, np.int32), np.int32)
        self.invariant = invariant
        self.extensions = list(extensions)
        self._persist = persist          # kept for derived()
        self._halt_when = halt_when
        self._step = make_step(cfg, self.programs, self.node_prog,
                               state_spec, invariant, persist=persist,
                               halt_when=halt_when,
                               extensions=self.extensions,
                               device=self.device)
        self._graphs: dict = {}     # run_fused's captured CUDA graph
        self.set_scenario(scenario)

    def set_scenario(self, scenario: Scenario | None) -> None:
        """Swap the scheduled supervisor script (it is initial-state data).
        Copies the rows and re-applies the auto-HALT at cfg.time_limit."""
        new = Scenario()
        if scenario is not None:
            new.rows = list(scenario.rows)
        if not new.has_halt():
            new.at(self.cfg.time_limit).halt()
        old = getattr(self, "scenario", None)
        self.scenario = new
        try:
            self._template = self._build_template()
        except Exception:
            self.scenario = old
            raise

    def derived(self, **overrides) -> "Runtime":
        """A Runtime over the SAME world (programs, state spec,
        node->program map, scenario, invariant, persistence mask,
        halt_when, extensions, device) with config fields replaced, e.g.
        `derived(trace_cap=64)` for a recorded replay of a lean sweep.
        Replay-domain overrides (n_nodes, time_limit, ...) are legal too
        but give a different replay domain."""
        return Runtime(dataclasses.replace(self.cfg, **overrides),
                       self.programs, self.state_spec,
                       node_prog=self.node_prog, scenario=self.scenario,
                       invariant=self.invariant, persist=self._persist,
                       halt_when=self._halt_when,
                       extensions=self.extensions, device=self.device)

    # ------------------------------------------------------------------
    def _build_template(self) -> SimState:
        """One lane's initial state, no lane axis: an OP_INIT row per node
        at t=0 (node boot) plus every scenario row."""
        cfg, dev = self.cfg, self.device
        rows = self.scenario.build(cfg)
        n_init = cfg.n_nodes
        n_rows = n_init + rows["time"].shape[0]
        if n_rows > cfg.event_capacity:
            raise ValueError(
                f"scenario ({n_rows} rows) exceeds event_capacity "
                f"({cfg.event_capacity})")
        node_state = tree_map(
            lambda a: torch.as_tensor(a, device=dev).unsqueeze(0).expand(
                (cfg.n_nodes,) + tuple(torch.as_tensor(a).shape)).clone(),
            self.state_spec)
        ext = tree_map(lambda a: torch.as_tensor(a, device=dev),
                       build_ext_state(cfg, self.extensions))
        s = init_state(cfg, node_state, ext, device=dev)

        C, Pw = cfg.event_capacity, cfg.payload_words
        deadline = np.full(C, T.T_INF, np.int32)
        kind = np.zeros(C, np.int32)
        node = np.zeros(C, np.int32)
        src = np.zeros(C, np.int32)
        tag = np.zeros(C, np.int32)
        payload = np.zeros((C, Pw), np.int32)
        # node boots at t=0, except nodes with a scheduled Scenario.boot
        deferred = {r.node for r in self.scenario.rows
                    if r.op == T.OP_INIT and r.node != T.NODE_RANDOM}
        deadline[:n_init] = 0
        kind[:n_init] = T.EV_SUPER
        node[:n_init] = np.arange(n_init)
        tag[:n_init] = T.OP_INIT
        for d in deferred:
            deadline[d] = T.T_INF
            kind[d] = 0
            tag[d] = 0
        deadline[n_init:n_rows] = rows["time"]
        kind[n_init:n_rows] = T.EV_SUPER
        node[n_init:n_rows] = rows["node"]
        src[n_init:n_rows] = rows["src"]
        tag[n_init:n_rows] = rows["op"]
        payload[n_init:n_rows] = rows["payload"]

        def col(a, like):
            return torch.as_tensor(a, device=dev).to(like.dtype)

        return s.replace(t_deadline=col(deadline, s.t_deadline),
                         t_kind=col(kind, s.t_kind),
                         t_node=col(node, s.t_node),
                         t_src=col(src, s.t_src), t_tag=col(tag, s.t_tag),
                         t_payload=col(payload, s.t_payload))

    @staticmethod
    def _lane_mask(lanes, B: int, what: str) -> np.ndarray:
        """A lane-selection argument (int index array or bool[B] mask) as
        a bool[B] mask."""
        lanes = np.asarray(lanes)
        if lanes.dtype == bool:
            if lanes.shape != (B,):
                raise ValueError(
                    f"bool {what} mask shape {lanes.shape} != "
                    f"batch ({B},)")
            return lanes
        mask = np.zeros(B, bool)
        mask[lanes.astype(np.int64)] = True
        return mask

    def init_batch(self, seeds, trace_lanes=None, profile_lanes=None,
                   latency_lanes=None, series_lanes=None,
                   span_lanes=None) -> SimState:
        """Initial batched state for an array of seeds; seed i always
        reproduces the same trajectory, whatever the batch around it.

        trace_lanes: which LANES the flight-recorder ring records when
        cfg.trace_cap > 0 (None = all; an int index array or a bool[B]
        mask narrows it). Lanes, not seeds: obs/rings.py readers take
        lane indices too.

        profile_lanes: which lanes the sim profiler counts when
        cfg.profile (None = all; same forms).

        latency_lanes: which lanes the latency plane histograms when
        cfg.latency_hist > 0 (None = all; same forms). The root column
        ev_root_t is kept on every lane regardless; only the histogram
        folds are gated. A runtime whose `invariant=` is
        harness.slo.slo_invariant should keep every lane on: a masked
        lane never folds, so its SLO can never fire.

        series_lanes: which lanes the windowed series records when
        cfg.series_windows > 0 (None = all; same forms). A runtime whose
        `invariant=` is harness.recovery.recovery_invariant should keep
        every lane on: a masked lane never fills a window.

        span_lanes: which lanes the span plane attributes when
        cfg.span_attr (None = all; same forms). Like ev_root_t, the
        carried ev_span column is kept on every lane; only the sa_*
        folds are gated."""
        seeds = np.atleast_1d(np.asarray(seeds)).astype(np.int64) \
            & 0xFFFFFFFF
        B = seeds.shape[0]
        keys = prng.seed_key(torch.as_tensor(seeds, device=self.device))
        s = map_state(lambda a: _lanes_of(a, B), self._template)
        s = s.replace(key=keys, hash_base=keys.clone())
        cfg = self.cfg
        for lanes, field, compiled, what in (
                (trace_lanes, "trace_on", cfg.trace_cap > 0,
                 "trace_lanes given but cfg.trace_cap == 0 — the ring "
                 "is compiled out; set SimConfig(trace_cap=...) > 0"),
                (profile_lanes, "pf_on", cfg.profile,
                 "profile_lanes given but cfg.profile is False — the "
                 "counter plane is compiled out; set "
                 "SimConfig(profile=True)"),
                (latency_lanes, "lh_on", cfg.latency_hist > 0,
                 "latency_lanes given but cfg.latency_hist == 0 — the "
                 "latency plane is compiled out; set "
                 "SimConfig(latency_hist=...) > 0"),
                (series_lanes, "sr_on", cfg.series_windows > 0,
                 "series_lanes given but cfg.series_windows == 0 — the "
                 "windowed telemetry plane is compiled out; set "
                 "SimConfig(series_windows=...) > 0"),
                (span_lanes, "sp_on", cfg.span_attr,
                 "span_lanes given but cfg.span_attr is False — the "
                 "attribution plane is compiled out; set "
                 "SimConfig(span_attr=True)")):
            if lanes is None:
                continue
            if not compiled:
                raise ValueError(what)
            mask = self._lane_mask(lanes, B, what.split()[0])
            s = s.replace(**{field: torch.as_tensor(mask,
                                                    device=self.device)})
        return s

    def init_single(self, seed: int) -> SimState:
        return self.init_batch([seed])

    # ------------------------------------------------------------------
    def run(self, state: SimState, max_steps: int, chunk: int = 512,
            collect_events: bool = False, observer=None):
        """Advance until every lane halts or ~max_steps events each
        (rounded up to whole chunks). Returns (state, events | None).

        Chunks always run in full; between chunks the host reads
        `halted.all()` once (the only sync). With collect_events, the
        per-step records come back as numpy arrays stacked [steps, B, ...];
        lanes that halted keep emitting records with fired=False. The
        number of steps executed is left in `self.steps_run`.

        observer: `on_chunk` a chunk and `on_done` at the end, with the
        JAX package's records (the done record carries the latency
        plane's lat_p50 / lat_p99 / slo_miss when it is compiled in).

        The step writes its input in place, so the run steps a private
        copy of `state` (one clone per call): the caller's state is left
        as it was."""
        events = [] if collect_events else None
        done = k = 0
        B = int(state.halted.shape[0])
        state = map_state(torch.clone, state)
        t0 = t_prev = time.perf_counter()
        with torch.no_grad():
            while done < max_steps:
                for _ in range(chunk):
                    state, rec = self._step(state)
                    if collect_events:
                        events.append({k: v.cpu().numpy()
                                       for k, v in rec.items()})
                done += chunk
                k += 1
                all_halted = bool(state.halted.all())
                if observer is not None:
                    t_now = time.perf_counter()
                    observer.on_chunk(dict(
                        kind="chunk", chunk=k, steps_done=done, batch=B,
                        lanes_halted=int(state.halted.sum()),
                        wall_s=t_now - t0,
                        lane_steps_per_sec=B * chunk / max(t_now - t_prev,
                                                           1e-9)))
                    t_prev = t_now
                if all_halted:
                    break
        if observer is not None:
            wall = time.perf_counter() - t0
            rec = dict(kind="done", steps_done=done, batch=B, chunks=k,
                       lanes_halted=int(state.halted.sum()), wall_s=wall,
                       lane_steps_per_sec=B * done / max(wall, 1e-9))
            rec.update(self._latency_fields(state))
            observer.on_done(rec)
        self.steps_run = done
        if collect_events:
            events = {k: np.stack([e[k] for e in events])
                      for k in events[0]} if events else {}
        return state, events

    def run_fused(self, state: SimState, max_steps: int, chunk: int = 512,
                  ckpt_every=None, ckpt_log=None) -> SimState:
        """`run()` without the per-chunk host sync: advance until every
        lane halts or ~max_steps events each (rounded up to whole
        chunks), and return the final state. Bit-equal to
        `run(state, max_steps, chunk)`: halted lanes are a fixed point of
        the step, so where this runner stops a little after the last lane
        halted, no leaf differs.

        On CUDA the steps run as a replayed CUDA graph (`FusedGraph`): a
        block of steps captured once per runtime and batch shape, replayed
        with no host sync per block; `halted.all()` comes back through
        pinned memory and is read one block late. A failed capture or
        kernel launch raises — there is no eager fallback. The number of
        steps executed is left in `self.steps_run`, the graph's
        launch accounting in `self.fused_stats`. On the CPU it is `run()`
        itself. Either way the caller's state is left as it was.

        ckpt_every / ckpt_log (a CheckpointLog harvest at segment
        boundaries) are not ported yet (ROADMAP P11.8); whole-batch
        snapshots are `runtime.checkpoint.save` / `load`."""
        if ckpt_every is not None or ckpt_log is not None:
            raise NotImplementedError(
                "run_fused(ckpt_every=..., ckpt_log=...): the checkpoint "
                "log is not ported to madsim_tpu_torch yet (ROADMAP "
                "P11.8)")
        if state.now.device.type != "cuda":
            state, _ = self.run(state, max_steps, chunk)
            return state
        total = -(-max_steps // chunk) * chunk
        with torch.no_grad():
            block = math.gcd(chunk, FUSED_BLOCK)
            graph, warmup = self._fused_graph(state, block)
            state, replays = graph.run(state, total)
        self.steps_run = replays * block
        self.fused_stats = dict(block=block, replays=replays,
                                steps=self.steps_run, warmup_steps=warmup,
                                captured=dict(graph.captured))
        return state

    def _fused_graph(self, state: SimState, block: int, own: bool = False):
        """The captured graph for `state`'s shapes and the warm-up steps
        its capture took (0 when it was cached): captured once a shape,
        and only one graph (with its memory pool) is kept at a time, so a
        capture at a new shape releases the last. `own`: a new capture
        adopts `state`'s tensors as its static buffers."""
        key = (block, _signature(state))
        if key in self._graphs:
            return self._graphs[key], 0
        self._graphs.clear()
        self._graphs[key] = FusedGraph(self._step, state, block, own=own)
        return self._graphs[key], FusedGraph.WARMUP_STEPS

    def run_compacting(self, state: SimState, max_steps: int,
                       chunk: int = 512, compact_when: float = 0.5,
                       min_batch: int = 256, observer=None) -> SimState:
        """Like run(), with early-exit compaction for long-tailed sweeps
        (BASELINE.md config 4): when more than `compact_when` of the
        lanes have halted, the halted ones are stashed and the live ones
        repacked into a narrower batch, padded with halted lanes to
        max(min_batch, a power of two), the JAX package's rule. Returns
        the full batch in the ORIGINAL lane order, equal to `run`'s
        result (halted lanes are a fixed point of the step).

        On CUDA each chunk replays the graph runner's captured block on
        the current width's buffers (a capture a width: at most
        log2(B / min_batch) + 1), the repack and the stash are
        `lane_take` (the stash stays on the card) and the merge is one
        `lane_put` a part into a batch allocated once. On the CPU the
        chunks are the eager step, on a private copy. Either way the
        caller's state is left as it was.

        observer: `on_chunk` a chunk, `on_compact` a repack (from/to
        widths) and `on_done`, with the JAX package's records; the done
        record also carries the whole batch's latency rollup (lat_p50,
        lat_p99, slo_miss) when the latency plane is compiled in, as the
        JAX package's chunked runner's does. The
        widths, repacks, graph captures and the stash's bytes are left in
        `self.compact_stats`."""
        B = int(state.halted.shape[0])
        cuda = state.now.device.type == "cuda"
        block = math.gcd(chunk, FUSED_BLOCK)
        orig_idx = np.arange(B)
        stash: list = []          # (original lanes, their state)
        done = k = repacks = stashed_total = captures = stash_bytes = 0
        widths = [B]
        t0 = time.perf_counter()
        t_prev = t0
        with torch.no_grad():
            if cuda:
                graph, warm = self._fused_graph(state, block)
                graph.load(state)
                captures += warm > 0
                cur = graph.static
            else:
                cur = map_state(torch.clone, state)
            while done < max_steps:
                if cuda:
                    graph.advance(chunk)
                else:
                    for _ in range(chunk):
                        cur, _ = self._step(cur)
                done += chunk
                k += 1
                halted = cur.halted.cpu().numpy()
                n = halted.shape[0]
                if observer is not None:
                    t_now = time.perf_counter()
                    observer.on_chunk(dict(
                        kind="chunk", chunk=k, steps_done=done, batch=n,
                        lanes_halted=int(halted.sum()),
                        stashed_total=stashed_total, wall_s=t_now - t0,
                        lane_steps_per_sec=n * chunk / max(t_now - t_prev,
                                                           1e-9)))
                    t_prev = t_now
                if halted.all():
                    break
                live = int((~halted).sum())
                if not (n > min_batch and live / n < (1 - compact_when)):
                    continue
                target = max(min_batch, 1 << int(np.ceil(np.log2(live))))
                if target >= n:
                    continue
                # the live lanes, padded with the first halted ones
                keep = np.concatenate([np.nonzero(~halted)[0],
                                       np.nonzero(halted)[0][:target - live]])
                drop = np.setdiff1d(np.arange(n), keep)
                stash.append((orig_idx[drop], lane_take(cur, drop)))
                stash_bytes += sum(t.numel() * t.element_size()
                                   for t in state_leaves(stash[-1][1])
                                   .values())
                cur = lane_take(cur, keep)
                orig_idx = orig_idx[keep]
                if cuda:
                    del graph
                    graph, warm = self._fused_graph(cur, block, own=True)
                    graph.load(cur)
                    captures += warm > 0
                    cur = graph.static
                repacks += 1
                stashed_total += len(drop)
                widths.append(target)
                if observer is not None:
                    observer.on_compact(dict(
                        kind="compact", steps_done=done, from_batch=n,
                        to_batch=target, stashed=len(drop),
                        stashed_total=stashed_total,
                        wall_s=time.perf_counter() - t0))
            if observer is not None:
                done_rec = dict(
                    kind="done", steps_done=done, batch=B, chunks=k,
                    repacks=repacks,
                    lanes_halted=int(cur.halted.sum()) + stashed_total,
                    stashed_total=stashed_total,
                    wall_s=time.perf_counter() - t0)
            # merge: every part into its original lanes of one batch
            out = map_state(lambda t: torch.empty(
                (B,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device),
                cur)
            for idx, part in stash + [(orig_idx, cur)]:
                lane_put(out, idx, part)
            if observer is not None:
                # the whole batch's latency rollup, read off the merge
                done_rec.update(self._latency_fields(out))
                observer.on_done(done_rec)
        self.steps_run = done
        self.compact_stats = dict(widths=widths, repacks=repacks,
                                  chunks=k, captures=captures,
                                  stashed_total=stashed_total,
                                  stash_bytes=stash_bytes)
        return out

    def _latency_fields(self, state: SimState) -> dict:
        """The done record's latency rollup (lat_p50, lat_p99, slo_miss),
        empty when the latency plane is compiled out."""
        if self.cfg.latency_hist == 0:
            return {}
        from ..parallel.stats import latency_brief
        lb = latency_brief(state)
        if lb is None:
            return {}
        return dict(lat_p50=lb["e2e_p50"], lat_p99=lb["e2e_p99"],
                    slo_miss=lb["slo_miss"])

    def run_exact(self, state: SimState, steps: int,
                  collect_events: bool = False):
        """Exactly `steps` steps of every lane (a halted lane stays as it
        is) on a private copy of `state`: (state, events | None). The
        exact-length runner of `state_at` (obs/timetravel.advance_exact)
        and `harness.determinism.find_divergence`: the JAX package's
        chunk runner at chunk length `steps`."""
        return self.run(state, steps, chunk=steps,
                        collect_events=collect_events)

    def state_at(self, seed: int, step: int) -> SimState:
        """Time travel: the exact state of `seed` after `step` events
        (power-of-two pieces; an all-halted lane stops early)."""
        from ..obs.timetravel import advance_exact
        return advance_exact(self, self.init_single(seed), step,
                             chunk=1 << 30)

    def run_single(self, seed: int, max_steps: int, chunk: int = 512,
                   collect_events: bool = True):
        """One seed, optionally with its event trace (the repro path)."""
        return self.run(self.init_single(seed), max_steps, chunk,
                        collect_events)

    # ------------------------------------------------------------------
    # Host-driven supervisor ops (Handle::kill/... runtime/mod.rs:200-256):
    # write a supervisor row into every live lane's first free event slot
    # at the lane's current time; it dispatches on a following step.
    def inject(self, state: SimState, op: int, node: int = 0, src: int = 0,
               payload=()) -> SimState:
        cfg = self.cfg
        B = state.now.shape[0]
        dev = state.now.device
        slots, ok = first_k_free(state.t_kind == T.EV_FREE, 1)
        slot = slots[:, 0].to(torch.int64)
        ok = ok[:, 0]
        w = ok & ~state.halted
        hit = (torch.arange(cfg.event_capacity, device=dev)
               == slot[:, None]) & w[:, None]          # [B, C]
        pw = np.zeros(cfg.payload_words, np.int32)
        pw[:len(payload)] = payload
        pw = torch.as_tensor(pw, device=dev)

        def put(col, value):
            value = torch.as_tensor(value, device=dev).to(col.dtype)
            if col.ndim == 3:
                return torch.where(hit[:, :, None], value, col)
            return torch.where(hit, value, col)

        lineage = {}
        if cfg.trace_cap > 0:
            # host-injected ops are external causes (parent -1, carried
            # clock 0): the reused row must not keep its previous
            # occupant's provenance
            lineage["ev_prov"] = put(state.ev_prov, [-1, 0])
        if cfg.latency_hist > 0:
            # and the latency plane's: the injected op mints its root at
            # its own dispatch (-1 = unset), not the slot's last occupant's
            lineage["ev_root_t"] = put(state.ev_root_t, -1)
        if cfg.span_attr:
            # and the span plane's: a fresh chain, nothing accumulated, no
            # dominant segment, no emitter stamp
            lineage["ev_span"] = put(state.ev_span, [0, 0, 0, -1, 0, -1])
        return state.replace(
            **lineage,
            t_deadline=torch.where(hit, state.now[:, None], state.t_deadline),
            t_kind=put(state.t_kind, T.EV_SUPER),
            t_node=put(state.t_node, node), t_src=put(state.t_src, src),
            t_tag=put(state.t_tag, op), t_payload=put(state.t_payload, pw),
            oops=state.oops | torch.where(
                ~ok & ~state.halted, T.OOPS_EVENT_OVERFLOW, 0).to(torch.int32))

    def kill(self, state, node):
        return self.inject(state, T.OP_KILL, node)

    def restart(self, state, node):
        return self.inject(state, T.OP_RESTART, node)

    def pause(self, state, node):
        return self.inject(state, T.OP_PAUSE, node)

    def resume(self, state, node):
        return self.inject(state, T.OP_RESUME, node)

    def clog_link(self, state, src, dst):
        return self.inject(state, T.OP_CLOG_LINK, dst, src)

    def heal(self, state):
        return self.inject(state, T.OP_HEAL)

    def set_time_limit(self, state: SimState, limit: int) -> SimState:
        """Move every lane's virtual-time limit; the auto-HALT row (the one
        sitting exactly at the current limit) moves with it."""
        auto = ((state.t_kind == T.EV_SUPER) & (state.t_tag == T.OP_HALT)
                & (state.t_deadline == state.tlimit[:, None]))
        return state.replace(
            tlimit=torch.full_like(state.tlimit, int(limit)),
            t_deadline=torch.where(auto, int(limit), state.t_deadline))

    def set_slo_target(self, state: SimState, target: int) -> SimState:
        """Retune every lane's SLO target (ticks; 0 disables the miss
        counter): slo_target is a state leaf like tlimit. Requires the
        latency plane compiled in (cfg.latency_hist > 0)."""
        if self.cfg.latency_hist == 0:
            raise ValueError(
                "set_slo_target needs cfg.latency_hist > 0 — the latency "
                "plane is compiled out")
        return state.replace(
            slo_target=torch.full_like(state.slo_target, int(target)))

    def set_window_len(self, state: SimState, ticks: int) -> SimState:
        """Retune every lane's series window length (ticks a window):
        window_len is a state leaf like slo_target, so a captured graph
        picks the new value up. Requires the series plane compiled in
        (cfg.series_windows > 0). A retune mid-run re-buckets only later
        dispatches: windows already folded keep their old bounds."""
        if self.cfg.series_windows == 0:
            raise ValueError(
                "set_window_len needs cfg.series_windows > 0 — the "
                "windowed telemetry plane is compiled out")
        if int(ticks) < 1:
            raise ValueError("window_len must be >= 1 tick")
        return state.replace(
            window_len=torch.full_like(state.window_len, int(ticks)))

    # ------------------------------------------------------------------
    def fingerprints(self, state: SimState) -> np.ndarray:
        """uint32 fingerprint per lane (equal to the JAX package's
        `Runtime.fingerprints` of the same state)."""
        return fingerprint(state).cpu().numpy().astype(np.uint32)

    def check_determinism(self, seed: int, max_steps: int,
                          net_override=None, chunk: int = 512) -> bool:
        """Run one seed twice and compare the final fingerprints."""
        from ..harness.simtest import apply_net_override

        def once():
            s = apply_net_override(self.init_single(seed), net_override,
                                   cfg=self.cfg)
            s, _ = self.run(s, max_steps, chunk=chunk)
            return s

        return bool((self.fingerprints(once())
                     == self.fingerprints(once())).all())
