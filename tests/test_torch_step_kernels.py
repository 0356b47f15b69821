"""The step's kernels of the sixth slice against the JAX package
(tolerance: zero — every value is an integer or a correctly rounded
float32 quotient): the Raft safety check (ROADMAP K11,
`ops/raft_invariant.py`), the supervisor op (K3, `ops/apply_super.py`)
and the state fingerprint (K6, `utils/hashing.py`).

On CPU tensors each wrapper takes its plain version, which is what these
tests hold to the JAX package; chip_smoke.py holds the CUDA kernels to
the plain versions on the card. Inputs are made with numpy (or a seeded
torch generator, then exported to numpy) and handed to both sides; the
JAX side is vmapped over the lane axis and runs on the non-partitionable
threefry stream (see _torch_parity).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_step_kernels.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.core import types as T
from madsim_tpu_torch.ops.apply_super import (FS_LEAVES, TEAR_BUMP,
                                              TEAR_ZERO, SuperPlan,
                                              apply_super,
                                              apply_super_plain)
from madsim_tpu_torch.ops.raft_invariant import (raft_invariant_check,
                                                 raft_invariant_plain)
from madsim_tpu_torch.utils.hashing import fingerprint, fingerprint_plain


class _St:
    """The one attribute the JAX invariant reads of a state."""

    def __init__(self, node_state):
        self.node_state = node_state


# --------------------------------------------------------------------------
# K11: the Raft safety check
# --------------------------------------------------------------------------
RAFT_CASES = {
    # id: (B, N, L, fields, snapshots, peer mask)
    "N5_L32_one_field": (4099, 5, 32, ("cmd",), False, None),
    "N5_L32_snapshots": (1024, 5, 32, ("cmd",), True, None),
    "N3_L8_two_fields_raft_nodes": (1024, 3, 8, ("cmd", "x"), True,
                                    (True, False, True)),
    "N5_L8_B1_raft_nodes": (1, 5, 8, ("cmd",), False,
                            (True, True, False, True, True)),
}
# the log lengths of raft_kv and bank (K11's tiled form past 32 slots),
# with their five and six entry fields
_KV_FIELDS = ("op", "key", "val", "client", "rtag")
_BANK_FIELDS = ("op", "afrom", "ato", "amt", "client", "rtag")
RAFT_CASES.update({
    f"N8_L{L}_F{len(f)}": (1024, 8, L, f, True,
                           (True,) * 5 + (False,) * 3)
    for L in (12, 48, 64, 96, 192) for f in (_KV_FIELDS, _BANK_FIELDS)})


@pytest.mark.parametrize("window_slides", [False, True])
@pytest.mark.parametrize("case", sorted(RAFT_CASES))
def test_raft_invariant_matches_reference(case, window_slides):
    """Both static forms on chip_smoke's edge operands: words over the
    whole int32 range, equal logs, ties in the effective commit, one
    entry that differs at the common commit point, a commit past the log,
    two leaders of one term, commits and snapshot lengths at the int32
    extremes (the window point wraps), snapshots, a raft_nodes mask."""
    from madsim_tpu.models import raft as jraft
    B, N, L, fields, snap, peer = RAFT_CASES[case]
    ops = chip_smoke.raft_edge_operands("cpu", B, N, L, len(fields),
                                        seed=B + N, peer=peer, snap=snap)
    names = ("role", "term", "snap_len", "log_len", "commit", "snap_digest",
             "log_term")
    ns = {k: ops[i].numpy() for i, k in enumerate(names)}
    ns.update({f"log_{f}": c.numpy() for f, c in zip(fields, ops[7])})
    jinv = jraft.raft_invariant(N, L, fields=fields, raft_nodes=peer,
                                window_slides=window_slides)
    jbad, jcode = jax.vmap(lambda d: jinv(_St(d)))(
        {k: jnp.asarray(v) for k, v in ns.items()})
    before = raft_invariant_check.launches
    bad, code = raft_invariant_check(*ops, window_slides)
    assert raft_invariant_check.launches == before
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    if B > 1:   # the operands reach every verdict
        assert 0 < int(bad.sum()) < B
        assert set(code[bad].tolist()) == {
            jraft.CRASH_TWO_LEADERS, jraft.CRASH_LOG_MISMATCH,
            jraft.CRASH_COMMIT_GT_LOG}


def _tiled_prefix(cols, ipowP, L):
    """A thread's prefix row S[0..L] as the kernel walks it: 32-slot
    tiles of every column folded into entry hashes, the running sum
    carried from tile to tile (uint32 arithmetic)."""
    mix = np.uint32(920419823)
    w = cols[0].shape[:-1]
    S = np.zeros(w + (L + 1,), np.uint32)
    s = np.zeros(w, np.uint32)
    ipw = ipowP.numpy().view(np.uint32)
    for k0 in range(0, L, 32):
        n = min(32, L - k0)
        h = cols[0][..., k0:k0 + n].numpy().view(np.uint32).copy()
        for c in cols[1:]:
            h = h * mix + c[..., k0:k0 + n].numpy().view(np.uint32)
        for k in range(n):
            s = s + h[..., k] * ipw[k0 + k + 1]
            S[..., k0 + k + 1] = s
    return S


def _raft_standin(ref, stream):
    """csrc/raft_invariant.cu on host memory: its blocks of `warps` warps
    (4 up to L = 32; past that the most whose shared rows fit in 48 KB),
    floor(32 / N) lanes a warp, each lane checked with the plain version
    from operands read through the parameter block's pointers; past 32
    slots each block's prefix rows are walked in 32-slot tiles as the
    kernel does and held to the plain version's. Refuses
    (cudaErrorInvalidValue) what the launcher refuses: L past 192, a
    `warps` other than the launcher's, 16-byte row reads of columns that
    are not 16-byte aligned or of an L no multiple of 4."""
    from madsim_tpu_torch.ops import raft_invariant as ri
    from test_torch_node_rows import _host
    p = ref._obj
    B, N, L, F = p.B, p.N, p.L, p.F
    if p.vec4 and (L % 4 or any(c % 16 for c in p.cols[:1 + F])):
        return 1
    warps = 4
    while L > 32 and warps > 1 and ri.smem_bytes(L, warps) > 48 * 1024:
        warps -= 1
    if not 1 <= L <= 192 or p.warps != warps:
        return 1
    assert ri.smem_bytes(L, warps) <= 48 * 1024

    def arr(ptr, shape, esize=4, dtype=np.int32):
        return torch.as_tensor(_host(ptr, int(np.prod(shape)), esize)
                               .view(dtype).reshape(shape))

    peer = arr(p.peer, (N,), 1, np.bool_)
    powP, ipowP = arr(p.powP, (L + 1,)), arr(p.ipowP, (L + 1,))
    bad = _host(p.bad, B, 1)
    code = _host(p.code, B, 4).view(np.int32)
    lanes = warps * (32 // N)             # a block's
    for b0 in range(0, B, lanes):
        w = min(lanes, B - b0)
        vecs = [arr(v + b0 * N * 4, (w, N)) for v in p.vecs[:6]]
        cols = [arr(c + b0 * N * L * 4, (w, N, L)) for c in p.cols[:1 + F]]
        if L > 32:
            h = ri.entry_hash(cols[0], cols[1:])
            want = torch.cumsum(h * ipowP[1:], -1, dtype=torch.int32)
            S = _tiled_prefix(cols, ipowP, L)
            assert (S[..., 0] == 0).all()
            np.testing.assert_array_equal(S[..., 1:].view(np.int32),
                                          want.numpy())
        got = ri.raft_invariant_plain(*vecs, cols[0], tuple(cols[1:]), peer,
                                      powP, ipowP, bool(p.window_slides))
        bad[b0:b0 + w] = got[0].numpy()
        code[b0:b0 + w] = got[1].numpy()
    return 0


# (B, N, L, F, peer mask, columns one element into their allocation,
# 16-byte row reads)
RAFT_LAUNCHES = {
    "flagship_shape": (1000, 5, 32, 1, None, False, True),
    "ragged_B1003": (1003, 5, 32, 1, None, False, True),
    "columns_one_element_in": (1003, 5, 32, 1, None, True, False),
    "B1_N3_L8_F2": (1, 3, 8, 2, (True, False, True), False, True),
    "N8_L6_F2": (300, 8, 6, 2, None, False, False),
    "N32_L32_F8": (45, 32, 32, 8, None, False, True),
    "tiled_N8_L48_F5": (203, 8, 48, 5, None, False, True),
    "tiled_N8_L64_F5": (300, 8, 64, 5, (True,) * 5 + (False,) * 3, False,
                        True),
    "tiled_N5_L96_F6_one_element_in": (77, 5, 96, 6, None, True, False),
    "tiled_N8_L192_F6": (33, 8, 192, 6, None, False, True),
    "tiled_N3_L50_F1": (40, 3, 50, 1, None, False, False),
}


@pytest.mark.parametrize("window_slides", [False, True])
@pytest.mark.parametrize("case", sorted(RAFT_LAUNCHES))
def test_raft_invariant_launch_reads_rows_by_their_alignment(
        monkeypatch, case, window_slides):
    """The kernel's launch logic on the CPU: rows read 16 bytes an access
    (`vec4`) only where every log column is 16-byte aligned and L is a
    multiple of 4; a stand-in launcher that refuses what the launcher
    refuses checks every lane with the plain version through the
    parameter block, walking the prefix rows in the kernel's tiles past
    32 slots. Equal to the plain version, one launch."""
    from madsim_tpu_torch.ops import raft_invariant as ri
    B, N, L, F, peer, off, vec4 = RAFT_LAUNCHES[case]
    ops = chip_smoke.raft_edge_operands("cpu", B, N, L, F, seed=B + N,
                                        peer=peer, snap=True)
    if off:
        ops = ops[:6] + (chip_smoke.unaligned(ops[6]), tuple(
            chip_smoke.unaligned(c) for c in ops[7])) + ops[8:]
    seen = []

    def standin(ref, stream):
        seen.append(ref._obj.vec4)
        return _raft_standin(ref, stream)

    monkeypatch.setattr(raft_invariant_check, "_fn", standin)
    before = raft_invariant_check.launches
    bad, code = raft_invariant_check.run(*ops, window_slides)
    assert raft_invariant_check.launches == before + 1
    assert seen == [int(vec4)] == [int(ri.rows_vec4((ops[6],) + ops[7], L))]
    want = raft_invariant_plain(*ops, window_slides)
    assert torch.equal(bad, want[0]) and torch.equal(code, want[1])


def test_raft_invariant_kernel_takes_logs_up_to_192_slots(monkeypatch):
    """The kernel path's limits: L = 192 launches (with one warp a block,
    its shared rows within 48 KB), L = 193 raises before any launch."""
    from madsim_tpu_torch.ops import raft_invariant as ri
    assert ri.MAX_L == 192
    assert [ri.block_warps(L) for L in (12, 32, 48, 64, 96, 192)] == [
        4, 4, 4, 4, 3, 1]
    monkeypatch.setattr(raft_invariant_check, "_fn", _raft_standin)
    for L, ok in ((192, True), (193, False)):
        ops = chip_smoke.raft_edge_operands("cpu", 9, 5, L, 1, seed=L)
        before = raft_invariant_check.launches
        if ok:
            got = raft_invariant_check.run(*ops, True)
            want = raft_invariant_plain(*ops, True)
            assert torch.equal(got[1], want[1])
        else:
            with pytest.raises(NotImplementedError, match="L <= 192"):
                raft_invariant_check.run(*ops, True)
        assert raft_invariant_check.launches == before + ok


# --------------------------------------------------------------------------
# K3: the supervisor op
# --------------------------------------------------------------------------
def _jax_apply_super(cfg, spec, persist, template, leaves, op, node, src,
                     payload, key):
    """The JAX package's `_apply_super`, vmapped over the lanes of a state
    given as numpy leaves in the layout of the JAX state `template`."""
    from madsim_tpu.core import step as jstep
    with reference_stream():
        treedef = jax.tree.structure(template)
        batched = jax.tree.unflatten(
            treedef, [jnp.asarray(leaves[k]) for k in jax_leaves(template)])
        out = jax.vmap(lambda s, o, n, c, p, k: jstep._apply_super(
            cfg, spec, persist, s, o, n, c, p, k))(
                batched, op.numpy(), node.numpy(), src.numpy(),
                payload.numpy(), key.numpy().view(np.uint32))
        return jax_leaves(out[0]), [np.asarray(x) for x in out[1:]]


def test_apply_super_matches_reference_on_the_raft_schema():
    """Every opcode 0-19 and an unknown one on random flagship (Raft)
    states: NODE_RANDOM targets with and without a payload pool and with
    an empty one, src out of range, boot resets of every non-persistent
    Raft leaf, RESTARTs of live nodes, loss quotients a reciprocal
    multiply would round differently."""
    import bench
    from madsim_tpu.models import raft as jraft
    B = 1024
    rt = workloads.flagship_runtime(device="cpu")
    plan, s, op, node, src, payload, key = chip_smoke.super_edge_operands(
        rt, B, seed=3)
    with reference_stream():
        jrt = bench._make_runtime()
        template = jrt.init_batch(np.arange(B, dtype=np.uint32))
        spec = {k: jnp.asarray(v)
                for k, v in jraft.state_spec(5, 32).items()}
    ref, ref_rest = _jax_apply_super(
        jrt.cfg, spec, jraft.persist_spec(), template,
        interop.state_to_numpy(s), op, node, src, payload, key)
    before = apply_super.launches
    out = apply_super(plan, s, op, node, src, payload, key)
    assert apply_super.launches == before
    assert_same(ref, interop.state_to_numpy(out[0]), what="apply_super")
    for name, r, t in zip(("init_node", "target", "reset_mask"), ref_rest,
                          out[1:]):
        np.testing.assert_array_equal(t.numpy(), r, err_msg=name)
    # the operands reach what the test names
    assert set(op.tolist()) == set(range(21))
    booted = out[1] >= 0
    reset = ref[".node_state['role']"] != interop.state_to_numpy(s)[
        ".node_state['role']"]
    assert booted.any() and reset.any()
    void = ((node == T.NODE_RANDOM) & (payload[:, 0] == 1 << 30)
            & (op == T.OP_KILL))
    assert void.any() and not out[3][void].any()
    loss_set = ref[".loss"] != interop.state_to_numpy(s)[".loss"]
    assert loss_set.sum() > 10


def test_the_kernel_paths_plain_remainder_reads_the_state_before_the_op():
    """The torn-write flush and the reset-peer tear run inside the kernel
    now, and the flush must read the state from before the op: the
    target's pre-kill `alive` and, in a RESTART lane, its `fs_mem` and
    `fs_mlen` rows before the boot resets them. Through the stand-in
    launcher on the fs + conn/stream schema (RESTARTs of torn, live nodes
    included) the kernel path equals the reference order of
    `apply_super_plain`, with nothing run after the launch; a stand-in
    that resets the boot rows before it flushes does not."""
    from madsim_tpu_torch.core.state import map_state
    rt, plan = chip_smoke.fs_conn_runtime("cpu")
    B, N = 1024, rt.cfg.n_nodes
    _, s, op, node, src, payload, key = chip_smoke.super_edge_operands(
        rt, B, seed=5, plan=plan)
    want = apply_super_plain(plan.cfg, plan.spec_default, plan.persist_mask,
                             s, op, node, src, payload, key)
    outs = {}
    for order in ("flush_first", "boot_first"):
        mine = map_state(torch.clone, s)
        apply_super._fn = (lambda ref, st, o=order:
                           _super_standin(ref, st, order=o))
        try:
            outs[order] = apply_super.run(plan, mine, op, node, src,
                                          payload, key)
        finally:
            apply_super._fn = None
    got = outs["flush_first"]
    assert_same(interop.state_to_numpy(want[0]),
                interop.state_to_numpy(got[0]), what="kernel path")
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    naive = interop.state_to_numpy(outs["boot_first"][0])
    assert (naive[".node_state['fs_disk']"]
            != interop.state_to_numpy(want[0])[".node_state['fs_disk']"]
            ).any()
    # the fs leaves are in the kernel's table (reset on boot) or handed
    # to it by name (the durable pair), and every conn/stream leaf tears
    table = {p[0]: a for (p, _), a in zip(plan.leaves, plan.acts)}
    assert {"fs_mem", "fs_mlen"} <= set(table) and plan.fs
    assert table["cn_epoch"] == table["st_epoch"] == TEAR_BUMP
    assert all(table[k] == TEAR_ZERO for k in ("cn_state", "sx_seq",
                                                "sx_val", "sr_have"))
    assert plan.n_tear == 9 and not plan.persistent_tears


def _tear_draw(k0, k1, F, f):
    """csrc/threefry.cuh `randint_raw_at(k, F, f, 0, 2^30)` on the host,
    word by word as the kernel computes it: both halves of split(k, 2)
    (`split_key`), word f of each half's `random_bits(., (F,))` (block
    (j, j + h) of the padded counts, `bits_at`) and jax's reduction."""
    from madsim_tpu_torch.core import prng

    def block(a, b, x0, x1):
        y = prng.threefry2x32(*(torch.tensor([v], dtype=torch.int32)
                                for v in (prng.u32(a), prng.u32(b),
                                          prng.u32(x0), prng.u32(x1))))
        return [int(t) & 0xFFFFFFFF for t in y]

    def split_key(a, b, n, i):
        words = []
        for w in (2 * i, 2 * i + 1):
            j = w if w < n else w - n
            y = block(a, b, j, j + n)
            words.append(y[0] if w < n else y[1])
        return words

    def bits_at(a, b, n, f):
        h = (n + 1) // 2
        j = f if f < h else f - h
        y = block(a, b, j, j + h if j + h < n else 0)
        return y[0] if f < h else y[1]

    hi = bits_at(*split_key(k0, k1, 2, 0), F, f)
    lo = bits_at(*split_key(k0, k1, 2, 1), F, f)
    span = 1 << 30
    mult = (65536 % span) ** 2 % span
    return ((hi % span) * mult + lo % span) % (1 << 32) % span


def _super_standin(ref, stream, seen=None, order="flush_first"):
    """csrc/apply_super.cu on host memory, as its kernel maps the work:
    phase 1 a thread a lane (here vectorised over the lanes: the pool
    pick, the lane's scalar and node-vector writes, the four outputs and
    the heavy flags, the flush flag from the pre-kill `alive`); phase 2
    each warp of 32 lanes (the last one partial where B is not a multiple
    of 32) takes its heavy lanes in ballot order, its 32 threads each
    scanning table rows c = t, t + 32, ...; a torn kill's flush a file f
    a thread for the draw (`_tear_draw`, the device function's word
    mapping) and the flushed words w = dlen + t, dlen + t + 32, ... of
    each file; boot elements e = t, t + 32, ... of the flattened (leaf,
    element) space (the leaf found by walking the prefix table forward);
    a reset-peer's tear entries q = t, t + 32, ... of each tear leaf; and
    link cells q = t, t + 32, .... `seen` collects (kind, lane, thread,
    index) of every phase-2 visit. `order="boot_first"` resets the boot
    rows before the flush (a mutation the tests tell apart). Refuses what
    the launcher refuses."""
    from madsim_tpu_torch.core import prng
    from test_torch_node_rows import _host
    p = ref._obj
    B, C, N, P, L = p.B, p.C, p.N, p.P, p.n_leaves
    nxt, n_tear = 0, 0
    for lf in p.leaves[:L]:
        act = lf.act
        if (lf.esize not in (1, 4) or lf.row < 0 or lf.start != nxt
                or act not in (0, TEAR_ZERO, TEAR_BUMP)
                or (act and (lf.row % N or not lf.row))
                or (act == TEAR_BUMP and lf.esize != 4)):
            return 1
        n_tear += bool(act)
        nxt += lf.row
    if (nxt != p.reset_elems or n_tear != p.n_tear or not 1 <= N <= 32
            or P < 2 or C < 1 or p.F < 0 or p.S < 0
            or (p.F and not (p.fs_mem and p.fs_mlen and p.fs_disk
                             and p.fs_dlen))):
        return 1

    def i32(ptr, n):
        return _host(ptr, n, 4).view(np.int32)

    op, nd, src = i32(p.op, B), i32(p.node, B), i32(p.src, B)
    pay = i32(p.payload, B * P).reshape(B, P)
    key = torch.as_tensor(i32(p.key, 2 * B).reshape(B, 2).copy())
    t_kind, t_node = i32(p.t_kind, B * C), i32(p.t_node, B * C)
    t_deadline = i32(p.t_deadline, B * C)
    alive, paused = _host(p.alive, B * N, 1), _host(p.paused, B * N, 1)
    clog_node, torn = _host(p.clog_node, B * N, 1), _host(p.torn, B * N, 1)
    link = _host(p.clog_link, B * N * N, 1)
    dflt = i32(p.defaults, max(p.reset_elems, 1))
    F, S = p.F, p.S
    if F:
        fs_mem, fs_disk = i32(p.fs_mem, B * N * F * S), i32(
            p.fs_disk, B * N * F * S)
        fs_mlen, fs_dlen = i32(p.fs_mlen, B * N * F), i32(p.fs_dlen,
                                                          B * N * F)

    # ---- phase 1 ----
    u = np.uint64
    full = u((1 << N) - 1)
    lanes = np.arange(B)

    def bits(v):
        v = v.reshape(B, N).astype(u)
        return (v << np.arange(N, dtype=u)).sum(1).astype(u)

    rand = nd == -1
    w0 = pay[:, 0].astype(np.uint32).astype(u)
    w1 = pay[:, 1].astype(np.uint32).astype(u)
    in_a = w0 & u(0x7FFFFFFF)
    if N > 31:
        in_a |= (w1 & u(1)) << u(31)
    in_a = np.where(rand | (op == T.OP_PARTITION)
                    | (op == T.OP_PARTITION_ONEWAY), in_a & full, u(0))
    pool = np.full(B, full, dtype=u)
    pool = np.where(np.isin(op, (T.OP_KILL, T.OP_PAUSE, T.OP_CLOG_NODE)),
                    bits(alive), pool)
    pool = np.where(op == T.OP_RESTART, ~bits(alive) & full, pool)
    pool = np.where(op == T.OP_RESUME, bits(paused), pool)
    pool = np.where(op == T.OP_UNCLOG_NODE, bits(clog_node), pool)
    any_word = (w0 != 0) | ((w1 != 0) if N > 31 else False)
    pool = np.where(any_word, pool & in_a, pool)
    cnt = np.array([bin(int(x)).count("1") for x in pool])
    r = prng.randint_raw(prng.split(key, 2)[:, 0], 0, torch.as_tensor(
        np.maximum(cnt, 1).astype(np.int32))).numpy()
    rnd = np.zeros(B, dtype=np.int64)
    for b in np.nonzero(rand)[0]:
        set_bits = [n for n in range(N) if (int(pool[b]) >> n) & 1]
        rnd[b] = set_bits[r[b]] if set_bits else 0
    eff = np.where(rand, cnt > 0, True)
    target = np.where(rand, rnd, np.clip(nd, 0, N - 1)).astype(np.int64)
    at = lanes * N + target

    def when(c):
        return c & eff

    kill = when((op == T.OP_KILL) | (op == T.OP_RESTART))
    boot = when((op == T.OP_INIT) | (op == T.OP_RESTART))
    flush = (kill & (torn[at] != 0) & (alive[at] != 0)) if F else \
        np.zeros(B, dtype=bool)
    tear = when(op == T.OP_RESET_PEER) & (p.n_tear > 0)
    alive[at[kill | boot]] = boot[kill | boot]
    paused[at[kill | boot | when(op == T.OP_RESUME)]] = 0
    paused[at[when(op == T.OP_PAUSE) & ~(kill | boot)]] = 1
    clog_node[at[when(op == T.OP_CLOG_NODE)]] = 1
    clog_node[at[when(op == T.OP_UNCLOG_NODE)]] = 0
    for code, v in ((T.OP_CLOG_LINK, 1), (T.OP_UNCLOG_LINK, 0)):
        m = when(op == code)
        link[(at * N + np.clip(src, 0, N - 1) * N + target
              - target * N)[m]] = v
    m = when(op == T.OP_SET_LOSS)
    _host(p.loss, B, 4).view(np.float32)[m] = (
        pay[m, 0].astype(np.float32) / np.float32(1e6))
    m = when(op == T.OP_SET_LATENCY)
    i32(p.lat_lo, B)[m] = pay[m, 0]
    i32(p.lat_hi, B)[m] = np.maximum(pay[m, 1], pay[m, 0])
    m = when(op == T.OP_SET_SKEW)
    i32(p.skew, B * N)[at[m]] = np.clip(pay[m, P - 1], -T.SKEW_CAP,
                                        T.SKEW_CAP)
    m = when(op == T.OP_SET_DISK)
    i32(p.disk_lat, B * N)[at[m]] = np.clip(pay[m, P - 1], 0,
                                            T.DISK_LAT_CAP)
    torn[at[m]] = pay[m, P - 2] != 0
    m = when(op == T.OP_SET_DUP)
    i32(p.dup_rate, B * N)[at[m]] = np.clip(pay[m, P - 1], 0,
                                            T.DUP_RATE_CAP)
    i32(p.init_node, B)[:] = np.where(boot, target, -1)
    i32(p.target, B)[:] = target
    _host(p.reset_mask, B, 1)[:] = kill | boot
    _host(p.effective, B, 1)[:] = eff
    part, oneway = when(op == T.OP_PARTITION), when(
        op == T.OP_PARTITION_ONEWAY)
    heal = when(op == T.OP_HEAL)
    heavy = kill | boot | part | oneway | heal | flush | tear
    k_tear = prng.split(key, 2)[:, 1].numpy().view(np.uint32)

    # ---- phase 2 ----
    leaves = p.leaves[:L]

    def do_flush(hb, ht):
        fr = (hb * N + ht) * F
        for f0 in range(0, F, 32):
            d = [0] * 32
            cut = [0] * 32
            for t in range(32):            # a file a thread
                f = f0 + t
                if f < F:
                    d[t] = int(fs_dlen[fr + f])
                    gap = max(int(fs_mlen[fr + f]) - d[t], 0)
                    cut[t] = d[t] + _tear_draw(int(k_tear[hb, 0]),
                                               int(k_tear[hb, 1]), F,
                                               f) % (gap + 1)
            for j in range(min(32, F - f0)):   # every thread, each file
                row = (fr + f0 + j) * S
                for t in range(32):
                    for w in range(max(d[j], 0) + t, min(cut[j], S), 32):
                        if seen is not None:
                            seen.append(("flush", hb, t, (f0 + j, w)))
                        fs_disk[row + w] = fs_mem[row + w]
            for t in range(32):
                if f0 + t < F:
                    fs_dlen[fr + f0 + t] = max(d[t], cut[t])

    for w0_ in range(0, B, 32):
        ballot = [b for b in range(w0_, w0_ + 32) if b < B and heavy[b]]
        for hb in ballot:           # ascending: __ffs order
            ht, ha = int(target[hb]), int(in_a[hb])
            if flush[hb] and order == "flush_first":
                do_flush(hb, ht)
            for t in range(32):
                if kill[hb]:
                    for c in range(t, C, 32):
                        i = hb * C + c
                        if seen is not None:
                            seen.append(("row", hb, t, c))
                        if t_node[i] == ht and t_kind[i] in (T.EV_MSG,
                                                            T.EV_TIMER):
                            t_kind[i] = T.EV_FREE
                            t_deadline[i] = T.T_INF
                if boot[hb]:
                    lf_i = 0
                    for e in range(t, p.reset_elems, 32):
                        while lf_i + 1 < L and e >= leaves[lf_i + 1].start:
                            lf_i += 1
                        lf = leaves[lf_i]
                        if seen is not None:
                            seen.append(("reset", hb, t, (lf_i, e - lf.start)))
                        off = (hb * N + ht) * lf.row + e - lf.start
                        dst = _host(lf.ptr + off * lf.esize, 1, lf.esize)
                        dst[0] = (int(dflt[e]) & 0xFFFFFFFF if lf.esize == 4
                                  else int(dflt[e] != 0))
            if flush[hb] and order == "boot_first":
                do_flush(hb, ht)
            for t in range(32):
                if tear[hb]:
                    for li, lf in enumerate(leaves):
                        act = lf.act
                        if not act:
                            continue
                        rr = lf.row // N
                        base = hb * N * lf.row
                        for q in range(t, lf.row + (N - 1) * rr, 32):
                            if q < lf.row:
                                off = ht * lf.row + q
                            else:
                                i, e = divmod(q - lf.row, rr)
                                i += i >= ht
                                off = i * lf.row + ht * rr + e
                            if seen is not None:
                                seen.append(("tear", hb, t, (li, off)))
                            dst = _host(lf.ptr + (base + off) * lf.esize, 1,
                                        lf.esize)
                            dst[0] = ((int(dst[0]) + 1) & 0xFFFFFFFF
                                      if act == TEAR_BUMP else 0)
                if part[hb] or oneway[hb] or heal[hb]:
                    for q in range(t, N * N, 32):
                        i, j = divmod(q, N)
                        ai, aj = (ha >> i) & 1, (ha >> j) & 1
                        if seen is not None:
                            seen.append(("link", hb, t, q))
                        if part[hb]:
                            link[hb * N * N + q] = ai != aj
                        elif oneway[hb]:
                            cut = (aj and not ai) if src[hb] & 1 else (
                                ai and not aj)
                            if cut:
                                link[hb * N * N + q] = 1
                        else:
                            link[hb * N * N + q] = 0
                    if heal[hb]:
                        for n in range(t, N, 32):
                            clog_node[hb * N + n] = 0
    return 0


SUPER_LAUNCHES = {
    # case: (runtime, B)
    "flagship_B1000_partial_warp": (lambda: (
        workloads.flagship_runtime(device="cpu"), None), 1000),
    "flagship_B1": (lambda: (workloads.flagship_runtime(device="cpu"),
                             None), 1),
    "fs_conn_C16_bool_leaf": (lambda: chip_smoke.fs_conn_runtime("cpu"),
                              1003),
    "N32_C512": (lambda: (workloads.flagship_runtime(device="cpu",
                                                     n_nodes=32), None), 70),
    "C100_mixed_leaves": (lambda: chip_smoke.mixed_leaf_runtime("cpu"), 333),
    "N32_C33_mixed_leaves": (lambda: chip_smoke.mixed_leaf_runtime(
        "cpu", N=32, C=33), 77),
    # the conn/stream tear on minipg's own schema: 5-d rings ([B, N, N,
    # W, V]), 32 leaves, two of them persistent
    "minipg_5d_leaves": (lambda: (_minipg_rt(), None), 333),
}


def _minipg_rt():
    from madsim_tpu_torch.models.minipg import make_minipg_runtime
    return make_minipg_runtime(device="cpu")


@pytest.mark.parametrize("case", sorted(SUPER_LAUNCHES))
def test_apply_super_warp_mapping_through_the_kernel_path(monkeypatch, case):
    """The supervisor op's kernel path on the CPU with a stand-in launcher
    that maps the work as the kernel's two phases do, on chip_smoke's edge
    operands: equal to `apply_super_plain` in every leaf and output, one
    launch, in place. Each heavy lane's table rows, boot elements, tear
    entries and link cells are visited once each, by thread index mod 32
    of a 32-wide chunk; a torn kill's flushed words once each; C not a
    multiple of 32 (16, 100), B not a multiple of 32 (a partial last
    warp), N = 32, int32, bool and zero-size leaves and minipg's 5-d
    rings."""
    from madsim_tpu_torch.core.state import map_state
    build, B = SUPER_LAUNCHES[case]
    rt, plan = build()
    plan, s, op, node, src, payload, key = chip_smoke.super_edge_operands(
        rt, B, seed=B, plan=plan)
    seen = []
    monkeypatch.setattr(apply_super, "_fn",
                        lambda ref, st: _super_standin(ref, st, seen))
    mine = map_state(torch.clone, s)
    before = apply_super.launches
    got = apply_super.run(plan, mine, op, node, src, payload, key)
    assert apply_super.launches == before + 1
    assert got[0].alive is mine.alive and got[0].t_kind is mine.t_kind
    want = apply_super_plain(plan.cfg, plan.spec_default, plan.persist_mask,
                             s, op, node, src, payload, key)
    assert_same(interop.state_to_numpy(want[0]),
                interop.state_to_numpy(got[0]), what=case)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    # every heavy lane's work visited once, a 32-wide chunk a thread
    C, N = s.t_kind.shape[1], rt.cfg.n_nodes
    E = plan.reset_elems
    by = {}
    for kind, b, t, i in seen:
        by.setdefault((kind, b), []).append((t, i))
    kill = want[3] & (op != T.OP_INIT)
    boot = want[1] >= 0
    assert {b for k, b in by if k == "row"} == set(
        torch.nonzero(kill).flatten().tolist())
    assert {b for k, b in by if k == "reset"} == set(
        torch.nonzero(boot).flatten().tolist())
    flat = [(li, e) for li, (_, d) in enumerate(plan.leaves)
            for e in range(d.numel())]
    # each tear leaf's touched entries: the target's own row of N x r
    # elements, then the target's r elements in every other node's row
    table = plan.leaves
    tear = (op == T.OP_RESET_PEER) & (plan.n_tear > 0)
    torn_kill = kill & (s.torn & s.alive).gather(
        1, want[2].long()[:, None])[:, 0] if plan.fs else kill & False

    def touched(b):
        t_ = int(want[2][b])
        out = []
        for li, ((_, d), act) in enumerate(zip(table, plan.acts)):
            if not act:
                continue
            row, r = d.numel(), d.numel() // N
            q = [t_ * row + e for e in range(row)]
            q += [i * row + t_ * r + e for i in range(N) if i != t_
                  for e in range(r)]
            out += [(li, x) for x in q]
        return out

    for (kind, b), visits in by.items():
        idx = [i for _, i in visits]
        if kind == "row":
            assert sorted(idx) == list(range(C))
            assert all(t == c % 32 for t, c in visits)
        elif kind == "reset":
            assert sorted(idx) == flat
            assert all(t == flat.index(i) % 32 for t, i in visits)
        elif kind == "tear":
            assert bool(tear[b])
            want_q = touched(b)
            assert sorted(idx) == sorted(want_q)
            # entry q of a leaf's walk (own row first) is thread q % 32's
            pos = {}
            for li, off in want_q:
                pos[li, off] = sum(1 for x, _ in pos if x == li)
            assert all(t == pos[i] % 32 for t, i in visits)
        elif kind == "flush":
            assert bool(torn_kill[b])
            assert len(set(idx)) == len(idx)
            assert all(t == (w - idx[0][1]) % 32 for t, (f, w) in visits
                       if f == idx[0][0])
        else:
            assert sorted(idx) == list(range(N * N))
            assert all(t == q % 32 for t, q in visits)
    # every RESET_PEER lane tears but one whose NODE_RANDOM pool is empty
    torn_lanes = {b for k, b in by if k == "tear"}
    assert torn_lanes <= set(torch.nonzero(tear).flatten().tolist())
    assert set(torch.nonzero(tear & (node != T.NODE_RANDOM)).flatten()
               .tolist()) <= torn_lanes
    assert len(flat) == E
    if B > 1:           # the operands reach what the test names
        assert kill.any() and boot.any()
        assert any(k == "link" for k, _ in by)
        assert B % 32 == 0 or (kill | boot)[B - B % 32:].any()
        if plan.n_tear:
            assert any(k == "tear" for k, _ in by)
        if plan.fs:
            assert any(k == "flush" for k, _ in by)


def test_kernel_path_refuses_a_persistent_tear_leaf():
    """The kernel tears only conn/stream leaves that the boot resets: a
    schema that persists one is refused on the kernel's path before any
    launch, and the plain version (the CPU's) still tears it."""
    from madsim_tpu_torch.core.state import map_state
    rt, plan = chip_smoke.fs_conn_runtime("cpu")
    kp = SuperPlan(plan.cfg, plan.spec_default,
                   {**plan.persist_mask, "cn_epoch": True})
    assert kp.persistent_tears == ["cn_epoch"] and kp.n_tear == 8
    _, s, op, node, src, payload, key = chip_smoke.super_edge_operands(
        rt, 64, seed=3, plan=kp)
    op[:] = T.OP_RESET_PEER
    node[:] = torch.arange(64, dtype=torch.int32) % plan.cfg.n_nodes
    before = apply_super.launches
    with pytest.raises(NotImplementedError, match="cn_epoch"):
        apply_super.run(kp, s, op, node, src, payload, key)
    assert apply_super.launches == before
    got = apply_super(kp, map_state(torch.clone, s), op, node, src,
                      payload, key)[0]
    moved = got.node_state["cn_epoch"] != s.node_state["cn_epoch"]
    assert moved.flatten(1).any(1).all()


@pytest.mark.cuda
def test_the_plain_loss_quotient_is_correctly_rounded_on_the_card():
    """CUDA torch divides a float32 tensor by a host scalar as a multiply
    by the scalar's reciprocal; the supervisor op's loss must be the
    correctly rounded quotient payload / 1e6 that the JAX package takes
    (59 / 1e6 is one of the values where the two differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rt = workloads.flagship_runtime(device="cuda")
    plan, s, op, node, src, payload, key = chip_smoke.super_edge_operands(
        rt, 4096, seed=3)
    op[:] = T.OP_SET_LOSS
    node[:] = 0
    payload[:, 0] = torch.arange(4096, device="cuda", dtype=torch.int32)
    out = apply_super_plain(plan.cfg, plan.spec_default, plan.persist_mask,
                            s, op, node, src, payload, key)[0]
    want = np.arange(4096).astype(np.float32) / np.float32(1e6)
    np.testing.assert_array_equal(out.loss.cpu().numpy(), want)


# --------------------------------------------------------------------------
# K6: the state fingerprint
# --------------------------------------------------------------------------
def test_fingerprint_matches_reference_on_the_flagship():
    """A flagship state after 64 steps, carried over by interop, has the
    JAX package's fingerprints; with zero-size leaves added on both sides
    (each folds lh = 0) too."""
    import bench
    from madsim_tpu.utils.hashing import batch_fingerprints
    B = 8
    with reference_stream():
        jrt = bench._make_runtime()
        js, _ = jrt.run(jrt.init_batch(np.arange(B, dtype=np.uint32)), 64,
                        chunk=64)
        want = jrt.fingerprints(js)
        leaves = jax_leaves(js)
        js0 = js.replace(ext={"z": jnp.zeros((B, 0), jnp.int32)},
                         node_state=dict(js.node_state,
                                         zz=jnp.zeros((B, 5, 0), bool)))
        want0 = np.asarray(batch_fingerprints(js0))
    port = interop.state_from_numpy(leaves, "cpu")
    before = fingerprint.launches
    got = fingerprint(port).numpy().astype(np.uint32)
    assert fingerprint.launches == before
    np.testing.assert_array_equal(got, want)
    assert len(set(want.tolist())) == B
    port0 = port.replace(ext={"z": torch.zeros((B, 0), dtype=torch.int32)},
                         node_state=dict(port.node_state, zz=torch.zeros(
                             (B, 5, 0), dtype=torch.bool)))
    got0 = fingerprint(port0).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got0, want0)
    assert (got0 != got).all()


# The fingerprint kernel's launch logic, with a stand-in launcher on host
# memory
_FP_NP = {0: np.uint32, 1: np.uint8, 2: np.int8, 3: np.int16}


def _fp_host(ptr, nbytes):
    import ctypes
    return np.frombuffer((ctypes.c_char * nbytes).from_address(ptr),
                         dtype=np.uint8, count=nbytes)


def _fp_region_bytes(T, leaves):
    """csrc/fingerprint.cu's shared memory, region by region: the lh table
    (4 bytes a leaf and lane), then each leaf's T * n elements, each
    region rounded up to 16 bytes."""
    up = lambda x: (x + 15) // 16 * 16                       # noqa: E731
    size = {0: 4, 1: 1, 2: 1, 3: 2}
    offs, o = [], up(4 * T * len(leaves))
    for n, kind in leaves:
        offs.append(o)
        o += up(T * n * size[kind])
    return offs, o


def _fp_standin(ref, stream, seen):
    """csrc/fingerprint.cu on host memory, read from the parameter block as
    the kernel reads it: refuses (cudaErrorInvalidValue) what the launcher
    refuses (its layout, a copy width that does not divide a leaf's address
    and tile bytes), then folds one tile of `tile` lanes a block, the last
    one ragged, each leaf's words read from its tile's byte range; records
    each launch's (tile, [chunk a leaf], [(first lane, lanes) a block])."""
    from madsim_tpu_torch.utils import hashing as hs
    p = ref._obj
    T, L = p.tile, p.n_leaves
    leaves = p.leaves[:L]
    meta = [(lf.n, lf.kind) for lf in leaves]
    offs, smem = _fp_region_bytes(T, meta)
    if not (0 <= L <= hs.MAX_LEAVES and 1 <= T <= 32
            and list(p.off[:L]) == offs and p.smem == smem <= hs.SMEM_MAX):
        return 1
    size = {0: 4, 1: 1, 2: 1, 3: 2}
    for lf in leaves:
        c = lf.chunk
        if c not in (0, 4, 8, 16) or (c and (T * lf.n * size[lf.kind] % c
                                             or lf.ptr % c)):
            return 1
    blocks = []
    out = np.frombuffer(_fp_host(p.out, 8 * p.B).data, dtype=np.int64)
    for b0 in range(0, p.B, T):
        nt = min(T, p.B - b0)
        blocks.append((b0, nt))
        h = np.full(nt, hs.FNV_OFFSET, np.uint64)
        for i, lf in enumerate(leaves):
            es = size[lf.kind]
            raw = _fp_host(lf.ptr + b0 * lf.n * es, nt * lf.n * es)
            w = raw.view(_FP_NP[lf.kind]).astype(np.int64).astype(
                np.uint64) & np.uint64(0xFFFFFFFF)
            w = w.reshape(nt, lf.n)
            mix = (np.arange(lf.n, dtype=np.uint64) * np.uint64(2654435761)
                   + np.uint64(2 * i + 1)) & np.uint64(0xFFFFFFFF)
            lh = ((w * mix) & np.uint64(0xFFFFFFFF)).sum(-1) \
                & np.uint64(0xFFFFFFFF)
            h = ((h ^ lh) * np.uint64(hs.FNV_PRIME)) & np.uint64(0xFFFFFFFF)
        out[b0:b0 + nt] = h.astype(np.int64)
    seen.append((T, [lf.chunk for lf in leaves], blocks))
    return 0


def _fp_state(B, steps=8):
    rt = workloads.flagship_runtime(device="cpu")
    s, _ = rt.run(rt.init_batch(np.arange(B, dtype=np.uint32)), steps,
                  chunk=steps)
    return s


@pytest.mark.parametrize("B", [1, 9, 21, 64])
def test_fingerprint_launch_tiles_every_lane_once(monkeypatch, B):
    """The kernel's path on the CPU with a stand-in launcher, on a flagship
    state: an 8-lane tile (its 49 leaves take 56,784 bytes of shared
    memory, within the 60 KB target; 16 lanes would take 113,456),
    ceil(B / 8) blocks, the last one ragged (B = 1, 9 = T + 1, 21), every
    leaf copied 16 bytes an access where its address and tile bytes allow,
    8 or 4 where they do not (the one-word bool leaves: 8 bytes a tile);
    equal to `fingerprint_plain`, one launch."""
    from madsim_tpu_torch.utils import hashing as hs
    s = _fp_state(B)
    seen = []
    monkeypatch.setattr(fingerprint, "_fn",
                        lambda ref, st: _fp_standin(ref, st, seen))
    before = fingerprint.launches
    got = fingerprint.run(s)
    assert fingerprint.launches == before + 1
    assert torch.equal(got, fingerprint_plain(s))
    (T, chunks, blocks), = seen
    leaves = hs._leaves(s)
    meta = [(t.numel() // B, hs._KIND[t.dtype]) for t in leaves]
    assert len(leaves) == 49 and T == hs.fp_tile(meta) == 8
    assert _fp_region_bytes(8, meta)[1] == 56784
    assert _fp_region_bytes(16, meta)[1] == 113456
    assert blocks == [(b0, min(8, B - b0)) for b0 in range(0, B, 8)]
    want = [16 if 8 * n * hs._ESIZE[k] % 16 == 0 else 8 for n, k in meta]
    assert chunks == want and 8 in chunks


@pytest.mark.parametrize("how", ["one_element_in", "one_byte_in"])
def test_fingerprint_launch_takes_the_copy_width_a_leaf_allows(monkeypatch,
                                                               how):
    """A leaf that is a view one element past a 16-byte boundary (an int32
    payload: 4 bytes; a bool leaf: an element at a time) takes the
    narrower copy its address allows, as chip_smoke's `unaligned` cases
    do on the card; the other leaves keep theirs. Equal to the plain
    version."""
    import chip_smoke
    from madsim_tpu_torch.utils import hashing as hs
    s = _fp_state(21)
    if how == "one_element_in":
        s = s.replace(t_payload=chip_smoke.unaligned(s.t_payload))
    else:
        s = s.replace(halted=chip_smoke.unaligned(s.halted))
    seen = []
    monkeypatch.setattr(fingerprint, "_fn",
                        lambda ref, st: _fp_standin(ref, st, seen))
    got = fingerprint.run(s)
    assert torch.equal(got, fingerprint_plain(s))
    (T, chunks, _), = seen
    leaves = hs._leaves(s)
    moved = [i for i, t in enumerate(leaves)
             if t.data_ptr() == (s.t_payload if how == "one_element_in"
                                 else s.halted).data_ptr()]
    assert len(moved) == 1
    assert chunks[moved[0]] == (4 if how == "one_element_in" else 0)
    assert all(c in (8, 16) for i, c in enumerate(chunks) if i != moved[0])


def test_fingerprint_launch_limits(monkeypatch):
    """192 leaves go in one launch and 193 are refused; a lane too wide for
    the card's shared memory is refused; a state past the 60 KB target
    takes the largest tile that fits the card."""
    from madsim_tpu_torch.utils import hashing as hs
    s = _fp_state(5)
    base = len(hs._leaves(s))
    seen = []
    monkeypatch.setattr(fingerprint, "_fn",
                        lambda ref, st: _fp_standin(ref, st, seen))

    def with_ext(k, n=1, dtype=torch.int16):
        return s.replace(ext={f"x{i:03d}": torch.full(
            (5, n), i - 7, dtype=dtype) for i in range(k)})

    wide = with_ext(hs.MAX_LEAVES - base)
    assert torch.equal(fingerprint.run(wide), fingerprint_plain(wide))
    assert len(seen[-1][1]) == hs.MAX_LEAVES
    with pytest.raises(NotImplementedError, match="at most 192"):
        fingerprint.run(with_ext(hs.MAX_LEAVES - base + 1))
    with pytest.raises(NotImplementedError, match="shared memory"):
        fingerprint.run(with_ext(1, n=60_000, dtype=torch.int32))
    big = with_ext(1, n=16_000, dtype=torch.int32)     # 71 KB a lane
    assert torch.equal(fingerprint.run(big), fingerprint_plain(big))
    assert seen[-1][0] == 2


# --------------------------------------------------------------------------
# The wrappers and the step's sections
# --------------------------------------------------------------------------
def _wrapper_case(name):
    """(wrapper, plain version, operands, operands -> meta) of a kernel."""
    from madsim_tpu_torch.core.state import map_state
    rt = workloads.flagship_runtime(device="cpu")
    if name == "raft_invariant":
        ops = chip_smoke.raft_edge_operands("cpu", 64, 5, 32, 1, seed=2)
        return (raft_invariant_check, raft_invariant_plain, ops + (False,),
                lambda a: tuple(x.to("meta") if isinstance(x, torch.Tensor)
                                else tuple(c.to("meta") for c in x)
                                if isinstance(x, tuple) else x for x in a))
    if name == "apply_super":
        plan, *rest = chip_smoke.super_edge_operands(rt, 64, seed=2)

        def plain(plan, *a):
            return apply_super_plain(plan.cfg, plan.spec_default,
                                     plan.persist_mask, *a)
        return (apply_super, plain, (plan, *rest),
                lambda a: (a[0], map_state(lambda t: t.to("meta"), a[1]))
                + tuple(t.to("meta") for t in a[2:]))
    s, _ = rt.run(rt.init_batch(np.arange(64)), 16, chunk=16)
    return (fingerprint, fingerprint_plain, (s,),
            lambda a: (map_state(lambda t: t.to("meta"), a[0]),))


@pytest.mark.parametrize("name", ["raft_invariant", "apply_super",
                                  "fingerprint"])
def test_wrapper_takes_the_plain_version_on_the_cpu_and_refuses_meta(name):
    """On CPU tensors a wrapper returns its plain version's result and
    launches nothing; on any device but the CPU and CUDA it raises."""
    def flat(out):      # apply_super returns (state, *tensors)
        if name != "apply_super":
            return chip_smoke.flat_tree(out)
        return dict(chip_smoke.flat_tree(out[1:]),
                    **interop.state_leaves(out[0]))

    wrapper, plain, args, to_meta = _wrapper_case(name)
    before = wrapper.launches
    got = flat(wrapper(*args))
    want = flat(plain(*args))
    assert wrapper.launches == before
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*to_meta(args))


@pytest.mark.parametrize("build,sections", [
    ("flagship", tuple(k for k in chip_smoke.SECTIONS
                       if k not in ("obs", "spans"))),
    ("pingpong", tuple(k for k in chip_smoke.SECTIONS
                       if k not in ("invariant", "obs", "spans"))),
    ("plane_flagship", tuple(k for k in chip_smoke.SECTIONS
                             if k != "spans")),
    ("all_planes_flagship", chip_smoke.SECTIONS)])
def test_every_section_of_the_step_is_a_profiler_range(build, sections):
    """One step under torch.profiler opens the `live_step.<section>`
    ranges chip_smoke splits the device time by (pingpong has no
    invariant; only a step with an observation plane has the obs
    section, and only one with the span plane the spans section), and
    their host ops hold the step's ops."""
    from torch.profiler import ProfilerActivity, profile
    rt = dict(flagship=workloads.flagship_runtime,
              pingpong=workloads.pingpong_runtime,
              plane_flagship=workloads.plane_flagship_runtime,
              all_planes_flagship=workloads.all_planes_flagship_runtime)[
                  build](device="cpu")
    s = rt.init_batch(np.arange(4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt._step(s)
    names = {e.name for e in prof.events() if e.name.startswith("live_step.")}
    assert names == {"live_step." + k for k in sections}
