"""Per-lane fault-knob vectors and the device half of the fuzzer: mutate a
batch of them, and write a batch into an init state.

The counterpart of `madsim_tpu.search.mutate`. Every fault knob is
initial-state data (scenario rows are event-table rows; loss, latency,
jitter and the PCT nudge are SimState scalars), so a mutant is nothing
but a different initial state: `KnobPlan.mutate` derives a batch of
mutants in one launch of the havoc kernel (ops/mutate.py,
csrc/mutate.cu) and `KnobPlan.apply` writes a batch into a batched init
state, in place, in one launch of the knob-write kernel
(ops/apply_knobs.py, csrc/apply_knobs.cu).

The knob vector (one lane) — everything the fuzzer may perturb:

  row_time  i32[R]   scenario row fire times (HALT/INIT rows pinned)
  row_node  i32[R]   row targets (NODE_RANDOM = -1 preserved; reshuffles
                     stay inside the row's `among=` pool)
  row_on    bool[R]  row enabled (drop/revive; HALT/INIT pinned on)
  row_val   i32[R]   fault value (skew rate / disk latency / dup rate)
  row_flag  i32[R]   fault flag (one-way direction / torn mode)
  dup_src   i32[D]   dup slots: clone of scenario row dup_src[d] ...
  dup_time  i32[D]   ... firing at dup_time[d], in D spare event-table
  dup_on    bool[D]  slots past the scenario segment
  loss      f32      packet loss rate
  lat_lo/hi i32      send-latency range
  jitter    i32      per-op jitter bound (only on jitter-enabled builds)
  prio_nudge i32     PCT tie-break policy (0 = the uniform draw)

Bounds are enforced at APPLY time, not trusted from the mutator: times
clip to [0, tlimit], targets to [-1, N-1] and the row's pool, values to
the row's [lo, hi], loss to [0, 0.99], lat_lo <= lat_hi; pinned rows keep
their base time and stay enabled.

Host-side knob batches are dicts of numpy arrays (corpus entries, the
JAX package's batches: interop.knobs_to_torch / knobs_to_numpy carry
them across); device batches are dicts of tensors on the plan's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import types as T
from ..interop import knobs_to_numpy, knobs_to_torch
from ..ops.apply_knobs import TABLE_COLS, apply_knobs
from ..ops.mutate import GUARD_KEYS, N_MUT_OPS, mutate_batch
from ..core.device import resolve_device

# mutation operator ids (the op histogram in fuzz results uses this order)
OP_NAMES = ("time_nudge", "target_reshuffle", "row_toggle", "row_dup",
            "latency_perturb", "loss_perturb", "prio_perturb",
            "fault_perturb")
# ops whose node target is meaningful and pool-restricted (the random-
# target pool packing of the supervisor op); everything else keeps its
# base node
_NODE_OPS = (T.OP_KILL, T.OP_RESTART, T.OP_PAUSE, T.OP_RESUME,
             T.OP_CLOG_NODE, T.OP_UNCLOG_NODE,
             T.OP_SET_SKEW, T.OP_SET_DISK,
             T.OP_RESET_PEER, T.OP_SET_DUP)
# rows whose tail payload word carries a bounded value (skew rate / disk
# latency / dup-delivery rate)
_VAL_OPS = (T.OP_SET_SKEW, T.OP_SET_DISK, T.OP_SET_DUP)
# rows that never move, drop or duplicate: HALT carries the time-limit
# contract, INIT rows the template's deferred-boot bookkeeping
_PINNED_OPS = (T.OP_HALT, T.OP_INIT)


@dataclasses.dataclass
class KnobPlan:
    """The static half of a fuzz campaign: which knobs exist for this
    Runtime's scenario, their base values, and the mutability guards
    (the JAX package's fields, plus the device the kernels run on: CUDA
    unless the caller names another, as for a Runtime)."""

    n_init: int                 # scenario rows start at this slot
    R: int                      # scenario rows (incl. the auto-HALT)
    D: int                      # dup slots (free event rows past them)
    N: int                      # nodes
    payload_words: int
    jitter_gate: bool           # static build gate (NetConfig.op_jitter_max)
    base: dict                  # time/op/node/src [R], payload [R, P]
    time_ok: np.ndarray         # bool[R]
    node_ok: np.ndarray         # bool[R]
    drop_ok: np.ndarray         # bool[R]
    pool_ok: np.ndarray         # bool[R, N+1]: pool_ok[r, t+1] — target t
                                # allowed for row r (t = -1 always allowed)
    val_ok: np.ndarray          # bool[R]
    val_lo: np.ndarray          # int32[R] — value bound, 0 on non-val rows
    val_hi: np.ndarray          # int32[R]
    dir_ok: np.ndarray          # bool[R]
    torn_ok: np.ndarray         # bool[R]
    net0: tuple                 # (loss, lat_lo, lat_hi, jitter) base scalars
    device: object = None       # CUDA unless named (resolve_device)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._dev_cache: dict = {}

    @staticmethod
    def from_runtime(rt, dup_slots: int = 2) -> "KnobPlan":
        cfg = rt.cfg
        rows = rt.scenario.build(cfg)
        R = rows["op"].shape[0]
        n_init = cfg.n_nodes
        # dup slots live past the scenario segment and must exist in the
        # table before any emission claims slots: capacity-bound them
        D = max(0, min(int(dup_slots), cfg.event_capacity - n_init - R))
        op = rows["op"]
        pinned = np.isin(op, _PINNED_OPS)
        node_ok = np.isin(op, _NODE_OPS)
        N = cfg.n_nodes
        pool_ok = np.zeros((R, N + 1), bool)
        pool_ok[:, 0] = True                       # NODE_RANDOM always legal
        # only the words node ids can pack into count as "a pool was given"
        # (the value-carrying ops keep their values in the TAIL words)
        n_pool_words = min(cfg.payload_words, (N + 30) // 31)
        for r in range(R):
            pay = rows["payload"][r][:n_pool_words]
            if node_ok[r] and pay.any():
                for t in range(N):
                    pool_ok[r, t + 1] = bool(
                        (int(pay[t // 31]) >> (t % 31)) & 1)
            else:
                pool_ok[r, 1:] = True
        val_ok = np.isin(op, _VAL_OPS)
        dir_ok = op == T.OP_PARTITION_ONEWAY
        torn_ok = (op == T.OP_SET_DISK) & (cfg.payload_words >= 2)
        val_lo = np.where(op == T.OP_SET_SKEW, -T.SKEW_CAP, 0)
        val_hi = np.where(op == T.OP_SET_SKEW, T.SKEW_CAP,
                          np.where(op == T.OP_SET_DISK, T.DISK_LAT_CAP,
                                   np.where(op == T.OP_SET_DUP,
                                            T.DUP_RATE_CAP, 0)))
        return KnobPlan(
            n_init=n_init, R=R, D=D, N=N, payload_words=cfg.payload_words,
            jitter_gate=cfg.net.op_jitter_max > 0,
            base=dict(time=rows["time"].astype(np.int32),
                      op=op.astype(np.int32),
                      node=rows["node"].astype(np.int32),
                      src=rows["src"].astype(np.int32),
                      payload=rows["payload"].astype(np.int32)),
            time_ok=~pinned, node_ok=node_ok, drop_ok=~pinned,
            pool_ok=pool_ok,
            val_ok=val_ok, val_lo=val_lo.astype(np.int32),
            val_hi=val_hi.astype(np.int32), dir_ok=dir_ok, torn_ok=torn_ok,
            net0=(float(cfg.net.packet_loss_rate),
                  int(cfg.net.send_latency_min),
                  int(cfg.net.send_latency_max),
                  int(cfg.net.op_jitter_max)),
            device=torch.device(rt.device))

    # -- knob construction -------------------------------------------------
    def base_knobs(self) -> dict:
        """The unmutated knob vector: exactly the Runtime's own scenario
        and NetConfig."""
        loss, lo, hi, jit = self.net0
        P = self.payload_words
        pay = self.base["payload"]
        row_val = np.where(self.val_ok, pay[:, P - 1], 0).astype(np.int32)
        row_flag = np.where(
            self.dir_ok, self.base["src"] & 1,
            np.where(self.torn_ok, pay[:, P - 2] if P >= 2
                     else np.zeros(self.R, np.int32), 0)).astype(np.int32)
        return dict(
            row_time=self.base["time"].copy(),
            row_node=self.base["node"].copy(),
            row_on=np.ones(self.R, bool),
            row_val=row_val, row_flag=row_flag,
            dup_src=np.zeros(self.D, np.int32),
            dup_time=np.full(self.D, T.T_INF, np.int32),
            dup_on=np.zeros(self.D, bool),
            loss=np.float32(loss), lat_lo=np.int32(lo), lat_hi=np.int32(hi),
            jitter=np.int32(jit), prio_nudge=np.int32(0))

    def base_batch(self, batch: int) -> dict:
        return self.stack([self.base_knobs()] * batch)

    @staticmethod
    def stack(knobs_list) -> dict:
        return {k: np.stack([kn[k] for kn in knobs_list])
                for k in knobs_list[0]}

    @staticmethod
    def lane(knobs_batch, i: int) -> dict:
        """One lane's knob vector as owned host arrays (corpus entries)."""
        kb = knobs_to_numpy(knobs_batch)
        return {k: np.array(v[i]) for k, v in kb.items()}

    def _device_tables(self, device) -> tuple:
        """(guards, base) as tensors on `device`, built once per device
        (a host-to-device copy waits for the device)."""
        key = str(device)
        got = self._dev_cache.get(key)
        if got is None:
            guards = {k: torch.as_tensor(np.ascontiguousarray(
                getattr(self, k)), device=device) for k in GUARD_KEYS}
            base = {k: torch.as_tensor(np.ascontiguousarray(v),
                                       device=device)
                    for k, v in self.base.items()}
            got = self._dev_cache[key] = (guards, base)
        return got

    def _on_device(self, knobs_batch) -> dict:
        return knobs_to_torch(knobs_batch, self.device)

    # -- the two kernels ----------------------------------------------------
    def mutate(self, knobs_batch, key, havoc: int = 3):
        """Derive a batch of mutants: per lane, `havoc` stacked operators
        drawn uniformly (the AFL havoc stage, batched). `knobs_batch` is
        host or device arrays [B, ...]; `key` one PRNG key (an int32 [2]
        tensor of uint32 bits, or a uint32 [2] array). Returns (device
        knob batch, int32 [N_MUT_OPS] operator histogram, int32 [B]
        per-lane LAST applied operator, -1 when none landed). havoc=0 is
        the identity (the blind-sampling control)."""
        return self.mutate_masked(knobs_batch, key, None, havoc)

    def mutate_masked(self, knobs_batch, key, mask, havoc: int = 3):
        """`mutate` where a per-lane bool `mask` selects which lanes keep
        the mutant: False lanes pass their parent through, count nothing
        in the histogram and get last-op -1. With mask None (or all
        True) this is exactly `mutate`. The knob batch comes back with
        its keys sorted, as the JAX package's jitted mutator returns it
        (a durable store writes an entry's arrays in that order)."""
        kb = self._on_device(knobs_batch)
        B = int(kb["row_time"].shape[0])
        if havoc <= 0:
            out = kb
            hist = torch.zeros((N_MUT_OPS,), dtype=torch.int32,
                               device=self.device)
            last_op = torch.full((B,), -1, dtype=torch.int32,
                                 device=self.device)
        else:
            guards, _ = self._device_tables(self.device)
            if mask is not None:
                mask = torch.as_tensor(mask, dtype=torch.bool,
                                       device=self.device)
            out, hist, last_op = mutate_batch(
                kb, _key_tensor(key, self.device), guards, int(havoc), mask)
        return dict(sorted(out.items())), hist, last_op

    def apply(self, state, knobs_batch):
        """Write a knob batch into a batched init state: scenario slots
        [n_init, n_init+R+D) plus the network/priority scalars, bounds
        enforced (see the module doc). The slots are written IN PLACE,
        into the state's own event-table columns (ops/apply_knobs.py):
        hand it a state nothing else reads, as `fuzz` does with a fresh
        `init_batch`. Returns the state with the new scalars; its table
        columns are the input's tensors."""
        dev = state.now.device
        kb = knobs_to_torch(knobs_batch, dev)
        guards, base = self._device_tables(dev)
        cols = {n: getattr(state, n) for n in TABLE_COLS}
        out = apply_knobs(cols, state.tlimit, state.jitter, kb, base,
                          guards, self.n_init, self.jitter_gate)
        return state.replace(**out)

    # -- human-facing rendering -------------------------------------------
    def to_scenario(self, knobs: dict):
        """Render one knob vector as a Scenario (repro reports): enabled
        rows with their mutated times/targets, dup clones as real rows.
        The network/priority scalars don't fit a Scenario — carry them
        alongside (fuzz repros do)."""
        from ..runtime.scenario import Scenario, _Row
        sc = Scenario()
        kn = knobs_to_numpy(knobs)

        def row_src_pay(r):
            """The row's src/payload with the fault knobs rendered in
            (same bounds as apply)."""
            src = int(self.base["src"][r])
            pay = [int(w) for w in self.base["payload"][r]]
            P = self.payload_words
            if self.val_ok[r]:
                pay[P - 1] = int(np.clip(kn["row_val"][r],
                                         self.val_lo[r], self.val_hi[r]))
            if self.torn_ok[r]:
                pay[P - 2] = int(kn["row_flag"][r]) & 1
            if self.dir_ok[r]:
                src = int(kn["row_flag"][r]) & 1
            return src, tuple(pay)

        for r in range(self.R):
            on = bool(kn["row_on"][r]) or not self.drop_ok[r]
            if not on:
                continue
            t = (int(kn["row_time"][r]) if self.time_ok[r]
                 else int(self.base["time"][r]))
            node = (int(kn["row_node"][r]) if self.node_ok[r]
                    else int(self.base["node"][r]))
            src, pay = row_src_pay(r)
            sc.rows.append(_Row(t, int(self.base["op"][r]), node, src, pay))
        for d in range(self.D):
            if not bool(kn["dup_on"][d]):
                continue
            srow = int(np.clip(kn["dup_src"][d], 0, self.R - 1))
            if not self.drop_ok[srow]:
                continue
            node = (int(kn["row_node"][srow]) if self.node_ok[srow]
                    else int(self.base["node"][srow]))
            src, pay = row_src_pay(srow)
            sc.rows.append(_Row(int(kn["dup_time"][d]),
                                int(self.base["op"][srow]), node, src, pay))
        sc.rows.sort(key=lambda r: r.time)
        return sc


def _key_tensor(key, device) -> torch.Tensor:
    """A PRNG key as an int32 [2] tensor of uint32 bits on `device`."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int32).contiguous()
    a = np.asarray(key).astype(np.uint32).view(np.int32)
    return torch.as_tensor(a, device=device)


def apply_repro_knobs(rt, state, knobs: dict, plan: "KnobPlan" = None):
    """Re-apply ONE repro handle's knob vector to every lane of a batched
    init state — the `(seed, knobs[, nudge])` replay idiom of `pct_sweep`.
    Infers the plan's dup-slot count from the vector itself when no plan
    is given. Returns (state, plan); the caller's state is not written
    (the write goes to a copy of its table columns)."""
    if plan is None:
        plan = KnobPlan.from_runtime(
            rt, dup_slots=len(np.atleast_1d(knobs_to_numpy(knobs)[
                "dup_src"])))
    B = int(state.halted.shape[0])
    own = state.replace(**{n: getattr(state, n).clone() for n in TABLE_COLS})
    return plan.apply(own, KnobPlan.stack([knobs_to_numpy(knobs)] * B)), \
        plan
