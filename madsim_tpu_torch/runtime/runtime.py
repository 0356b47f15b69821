"""Runtime: the batched supervisor (madsim::runtime::Runtime, vectorised).

Builds the step for one configuration and drives a whole batch of seeds
through it in chunks of `chunk` steps, syncing with the host once per
chunk to test whether every lane has halted — the chunk contract of
`madsim_tpu.runtime.runtime.Runtime.run`. State lives on one device:
CUDA by default (the entry points raise when no GPU is present), or the
CPU when the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core import prng
from ..core import types as T
from ..core.api import Program
from ..core.extension import build_ext_state
from ..core.state import SimState, init_state, map_state, tree_map
from ..core.step import make_step
from ..ops.select import first_k_free
from ..utils.hashing import fingerprint
from .scenario import Scenario


def resolve_device(device=None) -> torch.device:
    """The device a runtime runs on: CUDA unless the caller names another.
    With no GPU present and no device named, raise instead of moving to
    the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: madsim_tpu_torch runs on the "
                "GPU by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# observation planes of the JAX package that this port does not have yet,
# with the ROADMAP item that ports each
_UNPORTED_PLANES = (
    ("trace_cap", lambda c: c.trace_cap > 0,
     "the flight recorder and lineage (ROADMAP P7/P11.1)"),
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

    def init_batch(self, seeds) -> SimState:
        """Initial batched state for an array of seeds; seed i always
        reproduces the same trajectory, whatever the batch around it."""
        seeds = np.atleast_1d(np.asarray(seeds)).astype(np.int64) \
            & 0xFFFFFFFF
        B = seeds.shape[0]
        keys = prng.seed_key(torch.as_tensor(seeds, device=self.device))
        s = map_state(lambda a: _lanes_of(a, B), self._template)
        return s.replace(key=keys, hash_base=keys.clone())

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
        number of steps executed is left in `self.steps_run`."""
        events = [] if collect_events else None
        done = 0
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

        return state.replace(
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
