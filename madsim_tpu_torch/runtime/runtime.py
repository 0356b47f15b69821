"""Runtime: the batched supervisor (madsim::runtime::Runtime, vectorised).

Builds the step for one configuration and drives a whole batch of seeds
through it: `run` in chunks of `chunk` steps, syncing with the host once
per chunk to test whether every lane has halted — the chunk contract of
`madsim_tpu.runtime.runtime.Runtime.run` — and `run_fused` as a replayed
CUDA graph with no host sync per block. State lives on one device:
CUDA by default (the entry points raise when no GPU is present), or the
CPU when the caller passes `device="cpu"`.
"""

from __future__ import annotations

import math
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
from ..ops.select import first_k_free
from ..utils.hashing import fingerprint
from .scenario import Scenario


# observation planes of the JAX package that this port does not have yet,
# with the ROADMAP item that ports each
_UNPORTED_PLANES = (
    ("profile", lambda c: c.profile, "the sim profiler (ROADMAP P11.2)"),
    ("latency_hist", lambda c: c.latency_hist > 0,
     "the latency plane (ROADMAP P11.3)"),
    ("sketch_slots", lambda c: c.sketch_slots > 0,
     "the coverage sketch (ROADMAP P11.4)"),
    ("series_windows", lambda c: c.series_windows > 0,
     "the series plane (ROADMAP P11.5)"),
    ("span_attr", lambda c: c.span_attr, "the span plane (ROADMAP P11.6)"),
)


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

    def __init__(self, step, state: SimState, block: int):
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
            self.static = map_state(torch.clone, state)
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
        static = state_leaves(self.static)
        for path, t in state_leaves(state).items():
            if t is not static[path]:
                static[path].copy_(t)
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
        return map_state(torch.clone, self.static), replays


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
        for field, enabled, what in _UNPORTED_PLANES:
            if enabled(cfg):
                raise NotImplementedError(
                    f"SimConfig.{field}: {what} is not ported to "
                    f"madsim_tpu_torch yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.programs = list(programs)
        self.state_spec = state_spec
        self.node_prog = np.asarray(
            node_prog if node_prog is not None
            else np.zeros(cfg.n_nodes, np.int32), np.int32)
        self.invariant = invariant
        self.extensions = list(extensions)
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

    def init_batch(self, seeds, trace_lanes=None) -> SimState:
        """Initial batched state for an array of seeds; seed i always
        reproduces the same trajectory, whatever the batch around it.

        trace_lanes: which LANES the flight-recorder ring records when
        cfg.trace_cap > 0 (None = all; an int index array or a bool[B]
        mask narrows it). Lanes, not seeds: obs/rings.py readers take
        lane indices too."""
        seeds = np.atleast_1d(np.asarray(seeds)).astype(np.int64) \
            & 0xFFFFFFFF
        B = seeds.shape[0]
        keys = prng.seed_key(torch.as_tensor(seeds, device=self.device))
        s = map_state(lambda a: _lanes_of(a, B), self._template)
        s = s.replace(key=keys, hash_base=keys.clone())
        if trace_lanes is not None:
            if self.cfg.trace_cap == 0:
                raise ValueError(
                    "trace_lanes given but cfg.trace_cap == 0 — the ring "
                    "is compiled out; set SimConfig(trace_cap=...) > 0")
            lanes = np.asarray(trace_lanes)
            if lanes.dtype == bool:
                if lanes.shape != (B,):
                    raise ValueError(f"bool trace_lanes mask shape "
                                     f"{lanes.shape} != batch ({B},)")
                mask = lanes
            else:
                mask = np.zeros(B, bool)
                mask[lanes.astype(np.int64)] = True
            s = s.replace(trace_on=torch.as_tensor(mask, device=self.device))
        return s

    def init_single(self, seed: int) -> SimState:
        return self.init_batch([seed])

    # ------------------------------------------------------------------
    def run(self, state: SimState, max_steps: int, chunk: int = 512,
            collect_events: bool = False):
        """Advance until every lane halts or ~max_steps events each
        (rounded up to whole chunks). Returns (state, events | None).

        Chunks always run in full; between chunks the host reads
        `halted.all()` once (the only sync). With collect_events, the
        per-step records come back as numpy arrays stacked [steps, B, ...];
        lanes that halted keep emitting records with fired=False. The
        number of steps executed is left in `self.steps_run`.

        The step writes its input in place, so the run steps a private
        copy of `state` (one clone per call): the caller's state is left
        as it was."""
        events = [] if collect_events else None
        done = 0
        state = map_state(torch.clone, state)
        with torch.no_grad():
            while done < max_steps:
                for _ in range(chunk):
                    state, rec = self._step(state)
                    if collect_events:
                        events.append({k: v.cpu().numpy()
                                       for k, v in rec.items()})
                done += chunk
                if bool(state.halted.all()):
                    break
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

        ckpt_every / ckpt_log (checkpoint harvest at segment boundaries)
        are not ported yet (ROADMAP P8 / P11.8)."""
        if ckpt_every is not None or ckpt_log is not None:
            raise NotImplementedError(
                "run_fused(ckpt_every=..., ckpt_log=...): checkpoints are "
                "not ported to madsim_tpu_torch yet (ROADMAP P8/P11.8)")
        if state.now.device.type != "cuda":
            state, _ = self.run(state, max_steps, chunk)
            return state
        total = -(-max_steps // chunk) * chunk
        with torch.no_grad():
            block = math.gcd(chunk, FUSED_BLOCK)
            key = (block, _signature(state))
            warmup = 0
            if key not in self._graphs:
                self._graphs.clear()    # one graph (and its pool) at a time
                self._graphs[key] = FusedGraph(self._step, state, block)
                warmup = FusedGraph.WARMUP_STEPS
            graph = self._graphs[key]
            state, replays = graph.run(state, total)
        self.steps_run = replays * block
        self.fused_stats = dict(block=block, replays=replays,
                                steps=self.steps_run, warmup_steps=warmup,
                                captured=dict(graph.captured))
        return state

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
