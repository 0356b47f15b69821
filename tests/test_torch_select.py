"""The port's selection primitives, fingerprint and plain event select
against the JAX package (tolerance: zero — every value is an integer).

Inputs are made with numpy from a seed and handed to both sides; the JAX
side is vmapped over the lane axis the port writes out explicitly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu.core import types as JT
from madsim_tpu.ops import select as jsel
from madsim_tpu_torch import interop
from madsim_tpu_torch.ops import select as tsel
from madsim_tpu_torch.ops.sched_pick import sched_pick, sched_pick_plain

B, C, N = 256, 96, 5


def _rng(seed):
    return np.random.default_rng(seed)


def _keys(rng, b=B):
    return rng.integers(-2 ** 31, 2 ** 31 - 1, (b, 2)).astype(np.int32)


def _masks(rng):
    m = rng.random((B, C)) < rng.random((B, 1))
    m[0] = False           # nothing set
    m[1] = True            # everything set
    m[2] = False
    m[2, 37] = True        # one candidate
    return m


def test_masked_choice_matches():
    rng = _rng(0)
    mask, keys = _masks(rng), _keys(rng)
    with reference_stream():
        ji, jv = jax.vmap(jsel.masked_choice)(keys.view(np.uint32), mask)
    ti, tv = tsel.masked_choice(torch.as_tensor(keys), torch.as_tensor(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


def test_min_deadline_matches():
    rng = _rng(1)
    dl = rng.integers(0, 40, (B, C)).astype(np.int32)
    dl[5] = JT.T_INF
    elig = _masks(rng)
    jd, ja, je = jax.vmap(lambda d, e: jsel.min_deadline(d, e, JT.T_INF))(
        dl, elig)
    td, ta, te = tsel.min_deadline(torch.as_tensor(dl),
                                   torch.as_tensor(elig), JT.T_INF)
    for j, t in ((jd, td), (ja, ta), (je, te)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
def test_take1_take_row_row_onehot_match(dtype):
    rng = _rng(2)
    vec = rng.integers(-9, 9, (B, C)).astype(dtype)
    mat = rng.integers(-9, 9, (B, N, 4)).astype(dtype)
    idx = rng.integers(0, C, (B, 3)).astype(np.int32)
    row = rng.integers(0, N, B).astype(np.int32)
    j1 = jax.vmap(jsel.take1)(vec, idx)
    jr = jax.vmap(jsel.take_row)(mat, row)
    jo = jax.vmap(lambda i: jsel.row_onehot(N, i))(row)
    np.testing.assert_array_equal(
        tsel.take1(torch.as_tensor(vec), torch.as_tensor(idx)).numpy(),
        np.asarray(j1))
    np.testing.assert_array_equal(
        tsel.take_row(torch.as_tensor(mat), torch.as_tensor(row)).numpy(),
        np.asarray(jr))
    np.testing.assert_array_equal(
        tsel.row_onehot(N, torch.as_tensor(row)).numpy(), np.asarray(jo))
    # a table shared by every lane (the node -> program map)
    table = rng.integers(0, 3, N).astype(np.int32)
    np.testing.assert_array_equal(
        tsel.take1(torch.as_tensor(table), torch.as_tensor(row)).numpy(),
        table[row])


def test_put_row_matches():
    rng = _rng(3)
    mat = rng.integers(-9, 9, (B, N, 4)).astype(np.int32)
    row = rng.integers(-1, N + 1, B).astype(np.int32)   # out of range too
    val = rng.integers(100, 200, (B, 4)).astype(np.int32)
    mask = rng.random(B) < 0.7
    jp = jax.vmap(jsel.put_row)(mat, row, val, mask)
    tp = tsel.put_row(torch.as_tensor(mat), torch.as_tensor(row),
                      torch.as_tensor(val), torch.as_tensor(mask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # a scalar value with no mask (the step's pop of the picked row)
    vec = rng.integers(0, 4, (B, C)).astype(np.int32)
    col = rng.integers(0, C, B).astype(np.int32)
    js = jax.vmap(lambda v, i: jsel.put_row(v, i, jnp.int32(0)))(vec, col)
    ts = tsel.put_row(torch.as_tensor(vec), torch.as_tensor(col), 0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("scatter", [False, True])
def test_first_k_free_matches_both_lowerings(k, scatter):
    rng = _rng(4 + k)
    free = rng.random((B, C)) < rng.random((B, 1)) * 0.2
    free[0] = False
    free[1] = True
    js, jo = jax.vmap(lambda f: jsel.first_k_free(f, k, scatter=scatter))(
        free)
    ts, to = tsel.first_k_free(torch.as_tensor(free), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _jax_select(kind, node, dl, tag, src, alive, paused, nudge, halted,
                ks, sh):
    """`live_step` section 1 of the JAX package (step.py:141-232) for one
    lane, composed from its own select primitives."""
    u32 = jnp.uint32
    C, N = kind.shape[-1], alive.shape[-1]
    occupied = kind != JT.EV_FREE
    tnode = jnp.clip(node, 0, N - 1)
    parked = jsel.take1(alive & paused, tnode) & (kind != JT.EV_SUPER)
    eligible = occupied & ~parked
    dmin, at_min, any_ev = jsel.min_deadline(dl, eligible, JT.T_INF)
    idx, picked = jsel.masked_choice(ks, at_min)
    prio = (tag.astype(u32) * u32(0x9E3779B1)
            ^ node.astype(u32) * u32(0x85EBCA77)
            ^ jnp.arange(C, dtype=jnp.int32).astype(u32) * u32(0xC2B2AE3D)
            ^ nudge.astype(u32) * u32(0x27D4EB2F))
    prio = (prio ^ (prio >> 15)) * u32(0x2C1B3C6D)
    nudged = jnp.argmax(jnp.where(at_min, prio | u32(1), u32(0))).astype(
        jnp.int32)
    idx = jnp.where(nudge != 0, nudged, idx)
    valid = picked & any_ev & ~halted
    ev_kind = jnp.where(valid, jsel.take1(kind, idx), JT.EV_FREE)
    ev_node = jnp.clip(jsel.take1(node, idx), 0, N - 1)
    ev_src = jsel.take1(src, idx)
    ev_tag = jsel.take1(tag, idx)
    mix = jnp.stack([
        (ev_kind.astype(u32) * u32(0x9E3779B1)
         ^ ev_node.astype(u32) * u32(0x85EBCA77)
         ^ ev_src.astype(u32) * u32(0xC2B2AE3D)
         ^ ev_tag.astype(u32) * u32(0x27D4EB2F)),
        (ev_kind.astype(u32) * u32(0x27D4EB2F)
         ^ ev_node.astype(u32) * u32(0xC2B2AE3D)
         ^ ev_src.astype(u32) * u32(0x9E3779B1)
         ^ ev_tag.astype(u32) * u32(0x85EBCA77))])
    fold = jnp.asarray([16777619, 0x85EBCA6B], u32)
    new_hash = jnp.where(valid, (sh ^ mix) * fold, sh)
    return (idx, dmin, valid, any_ev, new_hash, ev_kind,
            jsel.take1(node, idx), ev_src, ev_tag)


def select_inputs(seed, b=B, C=C, N=N):
    """Random event tables with the edge lanes the select must handle:
    nothing eligible, one candidate, all rows tied, nudged lanes, halted
    lanes, paused nodes and T_INF rows."""
    rng = _rng(seed)
    kind = rng.integers(0, 4, (b, C)).astype(np.int32)
    kind[rng.random((b, C)) < 0.4] = JT.EV_FREE
    node = rng.integers(-1, N + 1, (b, C)).astype(np.int32)
    dl = rng.integers(0, 30, (b, C)).astype(np.int32)
    dl[rng.random((b, C)) < 0.05] = JT.T_INF
    tag = rng.integers(-2 ** 31, 2 ** 31 - 1, (b, C)).astype(np.int32)
    src = rng.integers(0, N, (b, C)).astype(np.int32)
    alive = rng.random((b, N)) < 0.8
    paused = rng.random((b, N)) < 0.3
    nudge = np.where(rng.random(b) < 0.25,
                     rng.integers(-2 ** 31, 2 ** 31 - 1, b), 0).astype(
                         np.int32)
    halted = rng.random(b) < 0.1
    kind[0] = JT.EV_FREE                      # nothing eligible
    kind[1] = JT.EV_FREE
    kind[1, min(50, C - 1)] = JT.EV_MSG       # one candidate
    kind[2:4] = JT.EV_TIMER                   # all rows tied
    dl[2:4] = 11
    alive[2:4] = True
    paused[2:4] = False
    nudge[3] = 77
    return (kind, node, dl, tag, src, alive, paused, nudge, halted,
            _keys(rng, b), _keys(rng, b))


# (C, N): the flagship's table (the cases named by their seed alone); one
# row over a warp's 32 with a node per bit of the parked mask; wal_kv's
# table; one row past it (the kernel's first wide instantiation); chain
# replication's table, the kernel's largest; a single row
_SHAPES = [(seed, c, n) for c, n in ((96, 5), (33, 32), (256, 5), (257, 6),
                                     (384, 6), (1, 1))
           for seed in (0, 1)]


@pytest.mark.parametrize(
    "seed,C_,N_", _SHAPES,
    ids=[f"{s}" if (c, n) == (C, N) else f"{s}-C{c}-N{n}"
         for s, c, n in _SHAPES])
def test_sched_pick_plain_matches_reference_select(seed, C_, N_):
    args = select_inputs(seed, C=C_, N=N_)
    j_args = list(args)
    j_args[9] = args[9].view(np.uint32)
    j_args[10] = args[10].view(np.uint32)
    with reference_stream():
        ref = jax.vmap(_jax_select)(*j_args)
    got = sched_pick_plain(*(torch.as_tensor(a) for a in args))
    assert len(got) == len(ref)
    for name, j, t in zip(("idx", "dmin", "valid", "any_ev", "sched_hash",
                           "ev_kind", "ev_node", "ev_src", "ev_tag"),
                          ref, got):
        j = np.asarray(j)
        t = t.numpy()
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert t.dtype == j.dtype, name
        bad = np.nonzero((t != j).reshape(len(t), -1).any(1))[0]
        assert not len(bad), f"{name} differs first at lane {bad[0]}"


def test_sched_pick_dispatch_on_cpu():
    """On CPU tensors the wrapper computes the plain version and launches
    nothing; any other non-CUDA device is refused."""
    args = [torch.as_tensor(a) for a in select_inputs(2, b=8)]
    before = sched_pick.launches
    out = sched_pick(*args)
    ref = sched_pick_plain(*args)
    assert sched_pick.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sched_pick(*(a.to("meta") for a in args))


def test_fingerprint_of_reference_state_matches():
    """The port's fingerprint of a JAX final state (carried over by
    interop) equals the JAX package's Runtime.fingerprints."""
    from madsim_tpu import NetConfig, Runtime, Scenario, SimConfig, ms, sec
    from madsim_tpu.models.pingpong import PingPong, state_spec
    from madsim_tpu_torch.utils.hashing import fingerprint
    sc = Scenario()
    sc.at(ms(3)).kill_random()
    sc.at(ms(30)).restart_random()
    cfg = SimConfig(n_nodes=3, time_limit=sec(2),
                    net=NetConfig(packet_loss_rate=0.3))
    with reference_stream():
        rt = Runtime(cfg, [PingPong(3, target=4)], state_spec(),
                     scenario=sc)
        s, _ = rt.run(rt.init_batch(np.arange(32)), 64, chunk=64)
        fp = rt.fingerprints(s)
        leaves = jax_leaves(s)
    port = interop.state_from_numpy(leaves, "cpu")
    got = fingerprint(port).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, fp)
    assert len(set(fp.tolist())) > 1
    # the round trip is lossless, leaf for leaf and digest for digest
    assert_same(leaves, interop.state_to_numpy(port), what="round trip")
    from _grayfail_golden import leaf_digests
    with reference_stream():
        want = leaf_digests(s)
    assert interop.leaf_digests(port) == want


def test_chip_smoke_mixed_tiles_hold_every_lane_kind():
    """The select operands chip_smoke.py holds the kernel to, where every
    warp tile mixes lane kinds in turns of seven: each kind does what its
    name says under the plain select (which equals the JAX select above)."""
    from chip_smoke import lanes_of, mixed_tile_inputs
    B, C, N = 70, 33, 32
    args = mixed_tile_inputs("cpu", B, C, N, seed=5)
    idx, dmin, valid, any_ev, _, ev_kind = sched_pick_plain(*args)[:6]
    turn = torch.arange(B) % 7
    nudge, halted = args[7], args[8]
    assert ((nudge != 0) == ((turn == 0) | (turn == 6))).all()
    assert torch.equal(halted, turn == 1)
    assert not valid[turn == 1].any()
    tied = (turn == 2) | (turn == 6)
    assert (dmin[tied] == 11).all() and valid[tied].all()
    assert (idx[turn == 3] == C // 2).all() and valid[turn == 3].all()
    assert not any_ev[turn == 4].any() and (ev_kind[turn == 4] == 0).all()
    parked = turn == 5
    assert (args[5][parked] & args[6][parked]).all()
    assert (ev_kind[parked & valid] == JT.EV_SUPER).all()
    # a tile of one lane is a copy of that lane
    one = lanes_of(args, [3])
    assert one[0].shape == (1, C) and one[0].is_contiguous()
    assert torch.equal(sched_pick_plain(*one)[0], idx[3:4])
