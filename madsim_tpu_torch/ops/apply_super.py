"""The supervisor op of one step: `apply_super`, a hand-written CUDA kernel
(csrc/apply_super.cu), and `apply_super_plain`, the same function in plain
PyTorch.

It replaces the JAX package's `_apply_super` (madsim_tpu/core/step.py
:1007) with its NODE_RANDOM pick (`masked_choice` over the node pool,
:1041; madsim_tpu/ops/select.py:17): apply each lane's supervisor opcode
— kill, restart, pause/resume, clog and unclog a node or a link,
partition (two-way and one-way), heal, loss and latency, clock skew,
slow and torn disks, duplicate delivery — as edits of the event table,
the node vectors, the link matrix, the lane's network scalars and the
booted node's protocol state. Every value is an integer or the correctly
rounded float32 quotient payload / 1e6, so kernel and plain version
agree exactly.

`apply_super_plain` is functional, as the JAX function is: it returns a
new state. The kernel writes IN PLACE, into the tensors of the state it
is given (the rows of t_kind and t_deadline it clears, the target's
entries of the node vectors, the link matrix, the lane scalars and the
booted node's rows of every non-persistent node-state leaf), and returns
that state. The step owns its input: the runners step a private copy of
the caller's state (runtime/runtime.py `run`, and `run_fused`'s static
buffers).

The two schema-specific edits run inside the kernel too, in schemas that
carry their leaves: the torn-write kill flush (fs_* leaves: a live,
torn-mode node's kill copies a random prefix of each file's unsynced tail
into the durable view, from the rows as they were before the op, then the
boot resets the non-persistent fs leaves) and the OP_RESET_PEER tear of
the conn/stream fabric (cn_*, sx_*, sr_*, st_epoch: every entry touching
the target zeroed, both incarnation epochs bumped once). The wrapper
hands the kernel one leaf table: every non-persistent leaf with its
default row, each conn/stream leaf with its tear action (`TEAR_ZERO`,
`TEAR_BUMP`), and the four fs leaves by name. A persistent conn/stream
leaf is not in that table, and the kernel's path refuses such a schema
(no model persists one; the plain version takes it).

`apply_super` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises (`apply_super.run`, the
kernel's path, which the CPU tests drive through a stand-in launcher).
`apply_super.launches` counts kernel launches (a launch recorded into a
CUDA graph under capture counts in `captured` instead).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import prng
from ..core import types as T
from ..core.state import tree_map
from . import select as sel
from .kernels import CKernel, on_cpu

_I32 = torch.int32
MAX_N = 32        # a lane's node pool is one 32-bit mask
MAX_LEAVES = 48   # node-state leaves the kernel resets on boot

FS_LEAVES = ("fs_mem", "fs_mlen", "fs_disk", "fs_dlen")
CONN_LEAVES = ("cn_state", "cn_epoch")
STREAM_LEAVES = ("sx_seq", "sx_base", "sx_val", "sr_next", "sr_val",
                 "sr_have", "st_epoch")
# a leaf's reset-peer tear action in the kernel's leaf table
# (csrc/apply_super.cu SuperLeaf::act)
TEAR_ZERO, TEAR_BUMP = 1, 2


def tear_actions(top) -> dict:
    """{leaf: TEAR_ZERO or TEAR_BUMP} of the reset-peer tear, for a state
    schema with the top-level keys `top` (a leaf set counts only whole)."""
    acts = {}
    if set(CONN_LEAVES) <= set(top):
        acts.update(cn_state=TEAR_ZERO, cn_epoch=TEAR_BUMP)
    if set(STREAM_LEAVES) <= set(top):
        acts.update({k: TEAR_ZERO for k in STREAM_LEAVES}, st_epoch=TEAR_BUMP)
    return acts


def _torn_flush(ns, target, tearing, k_tear):
    """A KILL of a live torn-mode node flushes a random prefix of each
    file's unsynced tail into the durable view (`tearing` [B] lanes)."""
    dev = target.device
    mem_t = sel.take_row(ns["fs_mem"], target)      # [B, F, S]
    mlen_t = sel.take_row(ns["fs_mlen"], target)    # [B, F]
    disk_t = sel.take_row(ns["fs_disk"], target)
    dlen_t = sel.take_row(ns["fs_dlen"], target)
    F, S = mem_t.shape[1:]
    gap = torch.clamp(mlen_t - dlen_t, min=0)
    draw = prng.randint_raw(k_tear, 0, 2 ** 30, (F,))
    cut = dlen_t + torch.remainder(draw, gap + 1)
    ws = torch.arange(S, dtype=_I32, device=dev)
    flushed = ((ws >= dlen_t[..., None]) & (ws < cut[..., None]))
    return dict(ns,
                fs_disk=sel.put_row(ns["fs_disk"], target,
                                    torch.where(flushed, mem_t, disk_t),
                                    tearing),
                fs_dlen=sel.put_row(ns["fs_dlen"], target,
                                    torch.maximum(dlen_t, cut), tearing))


def _reset_peer_tear(ns, ohT, rp):
    """OP_RESET_PEER (`rp` [B] lanes) closes every conn/stream entry
    touching the target (`ohT` [B, N]) on both sides and bumps both
    incarnation epochs."""
    touched = ((ohT[:, :, None] | ohT[:, None, :])
               & rp[:, None, None])                         # [B, N, N]

    def _cut(leaf, zero):
        m = touched.reshape(touched.shape + (1,) * (leaf.ndim - 3))
        return torch.where(m, zero, leaf)

    if set(CONN_LEAVES) <= set(ns):
        ns = dict(ns, cn_state=_cut(ns["cn_state"], 0),
                  cn_epoch=ns["cn_epoch"] + touched.to(_I32))
    if set(STREAM_LEAVES) <= set(ns):
        ns = dict(ns,
                  st_epoch=ns["st_epoch"] + touched.to(_I32),
                  sx_seq=_cut(ns["sx_seq"], 0),
                  sx_base=_cut(ns["sx_base"], 0),
                  sr_next=_cut(ns["sr_next"], 0),
                  sx_val=_cut(ns["sx_val"], 0),
                  sr_val=_cut(ns["sr_val"], 0),
                  sr_have=_cut(ns["sr_have"], False))
    return ns


def apply_super_plain(cfg, spec_default, persist_mask, s, op, node, src,
                      payload, key):
    """Apply one supervisor opcode per lane as masked state edits.

    Returns (state, init_node, target, reset_mask); init_node >= 0 asks
    the program's `init` handler to run on that node this step."""
    k = prng.split(key, 2)
    k_t, k_tear = k[:, 0], k[:, 1]
    N, P = cfg.n_nodes, cfg.payload_words
    dev = op.device

    def is_op(*codes):
        return functools.reduce(torch.logical_or, [op == c for c in codes])

    # NODE_RANDOM targets draw from the pool each op can act on; a nonzero
    # payload pool (31 nodes per word) restricts the candidates
    col = lambda m: m[:, None]     # noqa: E731 - [B] -> [B, 1]
    ones = torch.ones((op.shape[0], N), dtype=torch.bool, device=dev)
    pool = torch.where(
        col(is_op(T.OP_KILL, T.OP_PAUSE, T.OP_CLOG_NODE)), s.alive,
        torch.where(col(op == T.OP_RESTART), ~s.alive,
                    torch.where(col(op == T.OP_RESUME), s.paused,
                                torch.where(col(op == T.OP_UNCLOG_NODE),
                                            s.clog_node, ones))))
    ids = torch.arange(N, dtype=_I32, device=dev)
    word = ids // 31
    words = torch.where(word < P, payload[:, word.clamp(max=P - 1)],
                        torch.zeros((), dtype=_I32, device=dev))  # [B, N]
    in_bits = ((words >> (ids % 31)) & 1) == 1
    n_pool_words = min(P, (N + 30) // 31)
    pool = pool & torch.where(
        col((payload[:, :n_pool_words] != 0).any(-1)), in_bits, ones)
    rnd, rnd_ok = sel.masked_choice(k_t, pool)
    is_random = node == T.NODE_RANDOM
    target = torch.clamp(torch.where(is_random, rnd, node), 0, N - 1)
    effective = ~is_random | rnd_ok
    src_c = torch.clamp(src, 0, N - 1)

    def when(cond):
        return cond & effective

    kill = when(is_op(T.OP_KILL, T.OP_RESTART))
    boot = when(is_op(T.OP_INIT, T.OP_RESTART))

    # KILL drops the node's queued messages and timers
    clear = (col(kill) & (s.t_node == col(target))
             & ((s.t_kind == T.EV_MSG) | (s.t_kind == T.EV_TIMER)))
    t_kind = torch.where(clear, torch.zeros_like(s.t_kind), s.t_kind)
    t_deadline = torch.where(clear, torch.full_like(s.t_deadline,
                                                    int(T.T_INF)),
                             s.t_deadline)

    ohT = sel.row_onehot(N, target)                         # [B, N]
    alive = torch.where(ohT & col(kill & ~boot), False,
                        torch.where(ohT & col(boot), True, s.alive))
    paused = torch.where(ohT & col(kill | boot | when(op == T.OP_RESUME)),
                         False,
                         torch.where(ohT & col(when(op == T.OP_PAUSE)), True,
                                     s.paused))

    ns = s.node_state
    # torn-write kill flush (fs-layer state schemas only)
    if isinstance(ns, dict) and set(FS_LEAVES) <= set(ns):
        tearing = kill & sel.take1(s.torn & s.alive, target)
        ns = _torn_flush(ns, target, tearing, k_tear)

    # connection-fault tear (conn/stream state schemas only)
    rp = when(op == T.OP_RESET_PEER)
    if isinstance(ns, dict):
        ns = _reset_peer_tear(ns, ohT, rp)

    # boot/restart resets volatile protocol state to the spec default;
    # persistent leaves (stable storage) survive
    node_state = tree_map(
        lambda full, dflt, keep: full if keep
        else sel.put_row(full, target, dflt.unsqueeze(0), boot),
        ns, spec_default, persist_mask)

    clog_node = torch.where(
        ohT & col(when(op == T.OP_CLOG_NODE)), True,
        torch.where(ohT & col(when(op == T.OP_UNCLOG_NODE)), False,
                    s.clog_node))
    oh_link = sel.row_onehot(N, src_c)[:, :, None] & ohT[:, None, :]
    cube = lambda m: m[:, None, None]   # noqa: E731 - [B] -> [B, 1, 1]
    clog_link = torch.where(
        oh_link & cube(when(op == T.OP_CLOG_LINK)), True,
        torch.where(oh_link & cube(when(op == T.OP_UNCLOG_LINK)), False,
                    s.clog_link))

    # whole-matrix ops: PARTITION replaces the link matrix with the cut
    # A <-> not-A, PARTITION_ONEWAY ORs a directional cut in, HEAL clears
    in_a = in_bits
    cut = in_a[:, :, None] != in_a[:, None, :]
    clog_link = torch.where(cube(when(op == T.OP_PARTITION)), cut, clog_link)
    a_out = in_a[:, :, None] & ~in_a[:, None, :]
    cut_dir = torch.where(cube((src & 1) == 1), a_out.transpose(1, 2), a_out)
    clog_link = torch.where(cube(when(op == T.OP_PARTITION_ONEWAY)),
                            clog_link | cut_dir, clog_link)
    heal = when(op == T.OP_HEAL)
    clog_link = torch.where(cube(heal), False, clog_link)
    clog_node = torch.where(col(heal), False, clog_node)

    # the divisor is a tensor on the state's device: CUDA torch divides a
    # float32 tensor by a host scalar as a multiply by its reciprocal,
    # which is not the correctly rounded quotient the reference takes
    loss = torch.where(when(op == T.OP_SET_LOSS),
                       payload[:, 0].to(torch.float32)
                       / torch.full_like(s.loss, 1e6), s.loss)
    set_lat = when(op == T.OP_SET_LATENCY)
    lat_lo = torch.where(set_lat, payload[:, 0], s.lat_lo)
    lat_hi = torch.where(set_lat, torch.maximum(payload[:, 1], payload[:, 0]),
                         s.lat_hi)

    # gray-failure per-node knobs: values ride the TAIL payload words
    last = payload[:, P - 1]
    ohSk = ohT & col(when(op == T.OP_SET_SKEW))
    skew = torch.where(ohSk, col(torch.clamp(last, -T.SKEW_CAP, T.SKEW_CAP)),
                       s.skew)
    ohDk = ohT & col(when(op == T.OP_SET_DISK))
    disk_lat = torch.where(ohDk, col(torch.clamp(last, 0, T.DISK_LAT_CAP)),
                           s.disk_lat)
    torn = torch.where(ohDk, col(payload[:, P - 2] != 0), s.torn)
    ohDup = ohT & col(when(op == T.OP_SET_DUP))
    dup_rate = torch.where(ohDup, col(torch.clamp(last, 0, T.DUP_RATE_CAP)),
                           s.dup_rate)

    init_node = torch.where(boot, target, torch.full_like(target, -1))
    s = s.replace(t_kind=t_kind, t_deadline=t_deadline, alive=alive,
                  paused=paused, node_state=node_state, clog_node=clog_node,
                  clog_link=clog_link, loss=loss, lat_lo=lat_lo,
                  lat_hi=lat_hi, skew=skew, disk_lat=disk_lat, torn=torn,
                  dup_rate=dup_rate)
    return s, init_node, target, kill | boot


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class SuperPlan:
    """What the supervisor op needs of one runtime's node-state schema,
    built once: the spec defaults and persist mask (the plain version's
    operands), the kernel's leaf table (the leaves the boot resets, with
    their default rows as one int32 table per device), each leaf's tear
    action, the persistent leaves the tear would write (which the
    kernel's path refuses), and whether the schema has the fs leaves of
    the torn-write flush."""

    def __init__(self, cfg, spec_default, persist_mask):
        self.cfg = cfg
        self.spec_default = spec_default
        self.persist_mask = persist_mask
        top = set(spec_default) if isinstance(spec_default, dict) else set()
        self.fs = set(FS_LEAVES) <= top
        tears = tear_actions(top)
        keep = dict(_flat(persist_mask))
        flat = list(_flat(spec_default))
        self.leaves = [(path, dflt) for path, dflt in flat if not keep[path]]
        self.persistent_tears = [path[0] for path, _ in flat
                                 if keep[path] and len(path) == 1
                                 and path[0] in tears]
        self.acts = [tears.get(path[0], 0) if len(path) == 1 else 0
                     for path, _ in self.leaves]
        self.n_tear = sum(1 for a in self.acts if a)
        N = cfg.n_nodes
        for path, dflt in self.leaves:
            name = ".".join(path)
            if dflt.dtype not in (torch.int32, torch.bool):
                raise NotImplementedError(
                    f"apply_super: node-state leaf {name} is {dflt.dtype}; "
                    "the kernel takes int32 and bool leaves")
            if len(path) == 1 and path[0] in tears and (
                    dflt.ndim < 1 or dflt.shape[0] != N
                    or (tears[path[0]] == TEAR_BUMP
                        and dflt.dtype != torch.int32)):
                raise NotImplementedError(
                    f"apply_super: conn/stream leaf {name} of shape "
                    f"{tuple(dflt.shape)} {dflt.dtype}; the reset-peer "
                    f"tear takes [N={N}, ...] leaves (int32 where bumped)")
        if len(self.leaves) > MAX_LEAVES:
            raise NotImplementedError(
                f"apply_super: {len(self.leaves)} node-state leaves in the "
                f"kernel's table; it takes at most {MAX_LEAVES}")
        # the prefix table of the reset rows: leaf i holds elements
        # [starts[i], starts[i] + its row length) of the flattened (leaf,
        # element) space the kernel's warp spreads a boot over, and the
        # defaults table is laid out the same way
        rows = [d.numel() for _, d in self.leaves]
        self.reset_elems = sum(rows)
        self.starts = [sum(rows[:i]) for i in range(len(rows))]
        self._defaults: dict = {}

    def defaults(self, dev) -> torch.Tensor:
        """The int32 table of every reset leaf's default row on `dev`,
        leaf i's at `starts[i]`; built once per device."""
        if dev not in self._defaults:
            rows = [d.reshape(-1).to(_I32).to(dev) for _, d in self.leaves]
            self._defaults[dev] = (
                torch.cat(rows) if self.reset_elems
                else torch.zeros(1, dtype=_I32, device=dev))
        return self._defaults[dev]


class _Leaf(ctypes.Structure):
    """csrc/apply_super.cu `SuperLeaf`, field for field."""
    _fields_ = [("ptr", ctypes.c_void_p), ("row", ctypes.c_int),
                ("esize", ctypes.c_int), ("start", ctypes.c_int),
                ("act", ctypes.c_int)]


_LANE_IN = ("op", "node", "src", "payload", "key")
_STATE = ("t_kind", "t_node", "t_deadline", "alive", "paused", "clog_node",
          "clog_link", "loss", "lat_lo", "lat_hi", "skew", "disk_lat", "torn",
          "dup_rate")
_OUT = ("init_node", "target", "reset_mask", "effective")
_FS = ("fs_mem", "fs_mlen", "fs_disk", "fs_dlen")


class _Params(ctypes.Structure):
    """csrc/apply_super.cu `SuperParams`, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in _LANE_IN + _STATE + ("defaults",)
         + _OUT + _FS]
        + [("leaves", _Leaf * MAX_LEAVES)]
        + [(n, ctypes.c_int) for n in ("B", "C", "N", "P", "n_leaves",
                                       "reset_elems", "F", "S", "n_tear")])


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"apply_super: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"apply_super: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"apply_super: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"apply_super: {name} must be contiguous")


class _ApplySuper(CKernel):
    """Callable wrapper: CPU tensors -> `apply_super_plain`; CUDA tensors
    -> `run`, the kernel (in place, nothing after it). `launches`
    counts kernel launches (and nothing else); `captured` counts launches
    recorded into a CUDA graph."""

    def __init__(self):
        super().__init__("apply_super", "apply_super", _Params)

    def __call__(self, plan: SuperPlan, s, op, node, src, payload, key):
        """(state, init_node, target, reset_mask) of the op `op` [B] on
        node `node` [B] (NODE_RANDOM: drawn from the op's pool with the
        key [B, 2]), link source `src` [B] and `payload` [B, P]."""
        if on_cpu(op, "apply_super"):
            return apply_super_plain(plan.cfg, plan.spec_default,
                                     plan.persist_mask, s, op, node, src,
                                     payload, key)
        return self.run(plan, s, op, node, src, payload, key)

    def run(self, plan: SuperPlan, s, op, node, src, payload, key):
        """The kernel's path on the operands' device (the module's call
        sends only CUDA tensors here)."""
        dev = op.device
        B, C = s.t_kind.shape
        N, P = plan.cfg.n_nodes, plan.cfg.payload_words
        if s.t_kind.dtype != torch.int32:
            raise NotImplementedError(
                "apply_super: the CUDA kernel takes int32 event tables only "
                f"(table_dtype='int32'); got {s.t_kind.dtype}")
        if not 1 <= N <= MAX_N or P < 2:
            raise NotImplementedError(
                f"apply_super: the CUDA kernel supports 1 <= N <= {MAX_N} "
                f"and P >= 2; got N={N}, P={P}")
        if plan.persistent_tears:
            raise NotImplementedError(
                "apply_super: the CUDA kernel tears only conn/stream leaves "
                "that the boot resets; persistent: "
                + ", ".join(plan.persistent_tears))
        i32, b8 = torch.int32, torch.bool
        lane = dict(op=op, node=node, src=src, payload=payload, key=key)
        state = {n: getattr(s, n) for n in _STATE}
        checks = [(n, lane[n], i32, (B,)) for n in ("op", "node", "src")]
        checks += [("payload", payload, i32, (B, P)),
                   ("key", key, i32, (B, 2))]
        checks += [(n, state[n], i32, (B, C))
                   for n in ("t_kind", "t_node", "t_deadline")]
        checks += [(n, state[n], b8, (B, N))
                   for n in ("alive", "paused", "clog_node", "torn")]
        checks += [("clog_link", state["clog_link"], b8, (B, N, N)),
                   ("loss", state["loss"], torch.float32, (B,))]
        checks += [(n, state[n], i32, (B,)) for n in ("lat_lo", "lat_hi")]
        checks += [(n, state[n], i32, (B, N))
                   for n in ("skew", "disk_lat", "dup_rate")]
        leaves = [(".".join(path), _get(s.node_state, path), dflt)
                  for path, dflt in plan.leaves]
        checks += [("node_state." + n, t, d.dtype, (B, N) + tuple(d.shape))
                   for n, t, d in leaves]
        fs = {k: s.node_state[k] for k in _FS} if plan.fs else {}
        checks += [("node_state." + k, t, i32, (B, N) + tuple(
            plan.spec_default[k].shape)) for k, t in fs.items()]
        for name, t, dt, shape in checks:
            _check(name, t, dt, shape, dev)
        out = dict(init_node=torch.empty((B,), dtype=i32, device=dev),
                   target=torch.empty((B,), dtype=i32, device=dev),
                   reset_mask=torch.empty((B,), dtype=b8, device=dev),
                   effective=torch.empty((B,), dtype=b8, device=dev))
        table = plan.defaults(dev)
        p = _Params()
        for n, t in list(lane.items()) + list(state.items()) \
                + list(out.items()):
            setattr(p, n, t.data_ptr())
        p.defaults = table.data_ptr()
        for n, t in fs.items():
            setattr(p, n, t.data_ptr())
        for i, ((_, t, d), start, act) in enumerate(
                zip(leaves, plan.starts, plan.acts)):
            p.leaves[i].ptr = t.data_ptr()
            p.leaves[i].row = d.numel()
            p.leaves[i].esize = t.element_size()
            p.leaves[i].start = start
            p.leaves[i].act = act
        p.B, p.C, p.N, p.P = B, C, N, P
        p.n_leaves, p.reset_elems = len(leaves), plan.reset_elems
        if plan.fs:
            p.F, p.S = plan.spec_default["fs_mem"].shape
        p.n_tear = plan.n_tear
        if B:
            self._launch(p, dev)
        return s, out["init_node"], out["target"], out["reset_mask"]


apply_super = _ApplySuper()
