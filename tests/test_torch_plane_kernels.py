"""K8 (`obs_fold`, madsim_tpu_torch/ops/obs_fold.py, with its sketch,
series and span groups) and K10 (`plane_sums` with its sum, max and or
leaves, `lane_p99`, `lane_burst`, ops/plane_digest.py) on the CPU: their
plain versions against the JAX package's functions (tolerance: zero),
and their launch logic through stand-in launchers.

The CUDA kernels (csrc/obs_fold.cu, csrc/plane_digest.cu) run only on the
card, where chip_smoke.py holds them exactly equal to these plain
versions on the same edge cases (chip_smoke `fold_edge_operands`,
`digest_edge_operands`, `series_digest_operands`). Here each wrapper's kernel path runs with a
stand-in launcher that reads and writes host memory through the
parameter block's pointers as the kernel does — one lane a thread for
the fold, the per-leaf block layout for the sums, float32 in the kernel's
order for the p99 — so a pointer, shape, layout or arithmetic slip shows
on the CPU; and the wrappers' refusals are checked.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_stream
from chip_smoke import (DIGEST_CASES, FOLD_CASES, FOLD_PLANE_CASES,
                        SERIES_DIGEST_CASES, bucket_probes, clone_tree,
                        digest_edge_operands, fold_edge_operands,
                        series_digest_operands)
from madsim_tpu_torch.ops import obs_fold as of
from madsim_tpu_torch.ops import plane_digest as pd

I32 = 2**31 - 1
CPU = torch.device("cpu")


def _view(ptr, n, dtype):
    """A writable numpy view of n elements of host memory at ptr."""
    if n == 0 or not ptr:
        return np.zeros(0, dtype)
    ct = {np.int32: ctypes.c_int32, np.uint8: ctypes.c_uint8,
          np.uint32: ctypes.c_uint32}[dtype]
    return np.ctypeslib.as_array((ct * n).from_address(ptr))


def _sat(a, d):
    """`_sat_add` on Python ints with int32 wrap, as the kernel."""
    lim = (I32 - d + 2**31) % 2**32 - 2**31
    return I32 if a > lim else (a + d + 2**31) % 2**32 - 2**31


def _bucket(d, LB):
    if d < 1:
        return 0
    return min(d.bit_length(), LB - 1)


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def _floordiv(a, b):
    """The kernel's floor_div: C's truncating / and % corrected."""
    q = abs(a) // b * (1 if a >= 0 else -1)
    return q - 1 if (a % b != 0 and a < 0) else q


def _srf(op, effective):
    bits = 0
    if effective and op in (2, 3):
        bits |= 1
    if effective and op in (1, 3):
        bits |= 2
    for bit, ops in ((4, (6, 8, 14, 15)), (8, (7, 9, 13)), (16, (10, 12)),
                     (32, (16, 17)), (64, (18, 19))):
        if op in ops:
            bits |= bit
    return bits


def _fold_standin(ref, stream):
    """csrc/obs_fold.cu on host memory: one lane at a time, each counter
    read and written only at the element its one-hot selects."""
    p = ref._obj
    B, N, K, LB, S, W = p.B, p.N, p.K, p.LB, p.S, p.W
    if N < 1 or K < 0 or LB < 0 or (p.has_lh and LB < 1) or S < 0 \
            or W < 0 or (p.has_sp and not (p.has_lh and p.has_cpl)):
        return 1
    nP = N if p.has_pf else 0
    nL = N if p.has_lh else 0
    nS = N if p.has_sp else 0
    v = {}
    for name, n in (("pf_dispatch", B * nP * K), ("pf_busy", B * nP),
                    ("pf_kill", B * nP), ("pf_restart", B * nP),
                    ("pf_qmax", B), ("pf_drop", B), ("pf_delay", B),
                    ("lh_sojourn", B * nL * LB), ("lh_e2e", B * nL * LB),
                    ("lh_slo_miss", B * nL), ("cov_sketch", B * S),
                    ("sr_dispatch", B * W * N), ("sr_busy", B * W * N),
                    ("sr_qhw", B * W), ("sr_drop", B * W), ("sr_dup", B * W),
                    ("sr_complete", B * W), ("sr_slo_miss", B * W),
                    ("sr_lat", B * W * LB if p.has_lh else 0),
                    ("sr_fault", B * W), ("sa_tail", B * nS * 4),
                    ("sa_bottleneck", B * nS)):
        v[name] = _view(getattr(p, name), n, np.int32)
    for name in of.BOOL_OPS:
        v[name] = _view(getattr(p, name), B, np.uint8)
    for name in of.INT_OPS:
        v[name] = _view(getattr(p, name), B, np.int32)
    v["sched_hash"] = _view(p.sched_hash, 2 * B, np.int32)

    def add(leaf, i, d):
        v[leaf][i] = _sat(int(v[leaf][i]), int(d))

    for b in range(B):
        valid = bool(v["valid"][b])
        act = int(v["act_node"][b])
        act_ok = 0 <= act < N
        if p.has_pf and valid and v["pf_on"][b]:
            kind = int(v["ev_kind"][b])
            if act_ok:
                na = b * N + act
                if 0 <= kind < K:
                    add("pf_dispatch", na * K + kind, 1)
                add("pf_busy", na, v["now_delta"][b])
                if v["reset_mask"][b]:
                    op = int(v["op"][b])
                    if op in (2, 3):
                        add("pf_kill", na, 1)
                    if op in (1, 3):
                        add("pf_restart", na, 1)
            q = max(int(v["occ_disp"][b]), int(v["high_water"][b]))
            v["pf_qmax"][b] = max(int(v["pf_qmax"][b]), q)
            add("pf_drop", b, (int(v["delivered_drop"][b])
                               + int(v["dropped"][b]) + 2**31) % 2**32
                - 2**31)
            add("pf_delay", b, v["delay_acc"][b])
        if p.has_lh:
            on = bool(v["lh_on"][b])
            if valid and on and act_ok:
                add("lh_sojourn", (b * N + act) * LB
                    + _bucket(int(v["lat_sojourn"][b]), LB), 1)
            if p.has_cpl and on and v["is_complete"][b]:
                cpl = int(v["cpl_node"][b])
                if 0 <= cpl < N:
                    lat, tgt = int(v["lat_e2e"][b]), int(v["slo_target"][b])
                    add("lh_e2e", (b * N + cpl) * LB + _bucket(lat, LB), 1)
                    if tgt > 0 and lat > tgt:
                        add("lh_slo_miss", b * N + cpl, 1)
        lat, tgt = int(v["lat_e2e"][b]), int(v["slo_target"][b])
        if p.has_sp and p.has_cpl and v["is_complete"][b] \
                and v["sp_on"][b] and tgt > 0 and lat > tgt:
            cpl = int(v["cpl_node"][b])
            if 0 <= cpl < N:
                t = (b * N + cpl) * 4
                for c, d in enumerate((1, v["meas_sq"][b], v["meas_sn"][b],
                                       v["meas_sh"][b])):
                    add("sa_tail", t + c, d)
            dn = int(v["meas_dnode"][b])
            if dn >= 0:
                add("sa_bottleneck", b * N + min(dn, N - 1), 1)
        if S > 0 and valid:
            period = max(int(v["sketch_every"][b]), 1)
            steps = int(v["steps"][b])
            ck = _floordiv(steps, period)
            if 1 <= ck <= S and steps == ck * period:
                v["cov_sketch"][b * S + ck - 1] = (
                    v["sched_hash"][2 * b] ^ v["sched_hash"][2 * b + 1])
        if W > 0 and valid and v["sr_on"][b]:
            w = min(_floordiv(int(v["now"][b]),
                              max(int(v["window_len"][b]), 1)), W - 1)
            if w >= 0:
                bw = b * W + w
                if act_ok:
                    add("sr_dispatch", bw * N + act, 1)
                    add("sr_busy", bw * N + act, v["now_delta"][b])
                q = max(int(v["occ_disp"][b]), int(v["high_water"][b]))
                v["sr_qhw"][bw] = max(int(v["sr_qhw"][bw]), q)
                add("sr_drop", bw, _wrap(int(v["delivered_drop"][b])
                                         + int(v["dropped"][b])))
                if v["dup_fire"][b]:
                    add("sr_dup", bw, 1)
                v["sr_fault"][bw] |= _srf(int(v["op"][b]),
                                          bool(v["reset_mask"][b]))
                if p.has_cpl and v["is_complete"][b]:
                    add("sr_complete", bw, 1)
                    if tgt > 0 and lat > tgt:
                        add("sr_slo_miss", bw, 1)
                    add("sr_lat", bw * LB + _bucket(lat, LB), 1)
    return 0


def _sums_standin(ref, stream):
    """csrc/plane_digest.cu plane_sums on host memory: each leaf's blocks
    from its first block on, each block summing its run of lanes."""
    p = ref._obj
    if p.n_leaves < 1 or p.n_leaves > pd.MAX_LEAVES or p.blocks < 1:
        return 1
    B = p.B
    masks = [_view(p.masks[i], B, np.uint8) if p.masks[i] else None
             for i in range(2)]
    total = sum((2 if p.leaves[i].op == 0 else 1) * p.leaves[i].M
                for i in range(p.n_leaves))
    out = _view(p.out, total, np.uint32)
    for i in range(p.n_leaves):
        lf = p.leaves[i]
        if lf.M < 1 or masks[lf.mask] is None or not 0 <= lf.op <= 2 \
                or (lf.op and not lf.x):
            return 1
        nxt = (p.leaves[i + 1].first_block if i + 1 < p.n_leaves
               else p.blocks)
        run = (pd.THREADS // min(lf.M, pd.THREADS)) * pd.LOADS_PER_THREAD
        assert (nxt - lf.first_block) * run >= B > (
            nxt - lf.first_block - 1) * run
        x = (_view(lf.x, B * lf.M, np.int32).reshape(B, lf.M).astype(
            np.int64) if lf.x else np.ones((B, lf.M), np.int64))
        on = masks[lf.mask].astype(bool)
        if lf.op:           # max (biased unsigned) or or, a block a run
            o = out[lf.out:lf.out + lf.M]
            for blk in range(nxt - lf.first_block):
                rows = x[blk * run:(blk + 1) * run]
                ons = on[blk * run:(blk + 1) * run]
                if lf.op == 1:
                    u = (np.where(ons[:, None], rows, 0) % 2**32) ^ 2**31
                    o[:] = np.maximum(o, u.max(0).astype(np.uint32))
                else:
                    for r in rows[ons]:
                        o[:] |= (r % 2**32).astype(np.uint32)
            continue
        for blk in range(nxt - lf.first_block):
            rows = x[blk * run:(blk + 1) * run][on[blk * run:(blk + 1)
                                                   * run]]
            hi = (rows >> 16).sum(0) % 2**32
            lo = (rows & 0xFFFF).sum(0) % 2**32
            out[lf.out:lf.out + lf.M] += hi.astype(np.uint32)
            out[lf.out + lf.M:lf.out + 2 * lf.M] += lo.astype(np.uint32)
    return 0


def _edge_standin(h, q):
    """csrc/plane_digest.cu `p99_edge` on one host histogram [N, LB],
    float32 in the kernel's order of operations."""
    f32 = np.float32
    N, LB = h.shape

    def bucket_sum(k):
        s = f32(h[0, k])
        for n in range(1, N):
            s = f32(s + f32(h[n, k]))
        return s
    cdf = f32(0)
    for k in range(LB):
        cdf = f32(cdf + bucket_sum(k))
    total = cdf
    need = max(f32(np.ceil(f32(total * q))), f32(1))
    j, cdf = 0, f32(0)
    for k in range(LB):
        cdf = f32(cdf + bucket_sum(k))
        if cdf >= need:
            j = k
            break
    return (0 if j == 0 else 1 << (j - 1)) if total > 0 else 0


def _p99_standin(ref, stream):
    """csrc/plane_digest.cu lane_p99 on host memory."""
    p = ref._obj
    if p.N < 1 or p.LB < 1 or not 1 <= p.lanes_per_block <= pd.P99_LANES:
        return 1
    if p.lanes_per_block * (p.N * p.LB + 1) * 4 > pd.P99_SMEM:
        return 1
    B, N, LB = p.B, p.N, p.LB
    h = _view(p.hist, B * N * LB, np.int32).reshape(B, N, LB)
    out = _view(p.out, B, np.int32)
    for b in range(B):
        out[b] = _edge_standin(h[b], np.float32(p.q))
    return 0


def _burst_standin(ref, stream):
    """csrc/plane_digest.cu lane_burst on host memory, a window at a
    time."""
    p = ref._obj
    if p.W < 1 or p.LB < 1 or not 1 <= p.lanes_per_block <= pd.P99_LANES:
        return 1
    if p.lanes_per_block * p.W * (p.LB + 2) * 4 > pd.P99_SMEM:
        return 1
    B, W, LB = p.B, p.W, p.LB
    h = _view(p.hist, B * W * LB, np.int32).reshape(B, W, LB)
    out = _view(p.out, B, np.int32)
    for b in range(B):
        edges = [_edge_standin(h[b, w][None], np.float32(p.q))
                 for w in range(W)]
        out[b] = max(edges)
    return 0


@pytest.fixture
def standin(monkeypatch):
    """Each wrapper's kernel path on the CPU with its stand-in launcher."""
    for w, fn in ((of.obs_fold, _fold_standin),
                  (pd.plane_sums, _sums_standin),
                  (pd.lane_p99, _p99_standin),
                  (pd.lane_burst, _burst_standin)):
        monkeypatch.setattr(w, "_fn", fn)
        monkeypatch.setattr(w, "launches", 0)


# --------------------------------------------------------------------------
# obs_fold
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", FOLD_CASES + FOLD_PLANE_CASES)
def test_obs_fold_kernel_path_equals_the_plain_version(standin, case):
    plan, planes, ops, has_cpl = fold_edge_operands(CPU, 67, 5, 24, 11,
                                                    case)
    a, b = clone_tree(planes), clone_tree(planes)
    held = {k: a[k] for k in a}
    of.obs_fold.run(plan, a, ops, has_cpl)
    of.obs_fold_plain(plan, b, ops, has_cpl)
    assert of.obs_fold.launches == 1
    for k in planes:
        assert a[k] is held[k]
        assert torch.equal(a[k], b[k]), k
    changed = {k for k in planes if (a[k] != planes[k]).any()}
    if case in ("all_masked", "planes_masked"):
        # only the sketch, which has no lane gate, writes
        assert changed <= {"cov_sketch"}
    else:
        assert changed
    if case.startswith("planes_") and case != "planes_B1":
        assert "cov_sketch" in changed
    if case in ("planes_random", "planes_int32_max", "planes_windows"):
        assert {"sr_dispatch", "sr_lat", "sr_fault", "sa_tail",
                "sa_bottleneck"} <= changed
    if case == "planes_no_spans":
        assert not changed & {"sa_tail", "sa_bottleneck", "sr_lat"}


def test_obs_fold_plain_is_the_jax_steps_fold():
    """The plain fold against the JAX step's own expressions
    (`_sat_add` and the one-hot blocks of madsim_tpu/core/step.py
    673-768), lane by lane, on the bucket probes and at int32 max."""
    from madsim_tpu.core import step as jstep
    from madsim_tpu.core import types as JT
    for case in ("buckets", "int32_max", "random"):
        plan, planes, ops, has_cpl = fold_edge_operands(CPU, 33, 5, 24, 3,
                                                        case)
        got = clone_tree(planes)
        of.obs_fold_plain(plan, got, ops, has_cpl)
        o = {k: v.numpy() for k, v in ops.items()}
        pl = {k: v.numpy() for k, v in planes.items()}
        LB = plan.LB
        thr = jnp.asarray([1 << j for j in range(LB - 1)], jnp.int32)
        with reference_stream():
            for b in range(33):
                rec = o["valid"][b] & o["pf_on"][b]
                oh = np.arange(5) == o["act_node"][b]
                k_oh = np.arange(4) == o["ev_kind"][b]
                rm, op = o["reset_mask"][b], o["op"][b]
                kill = rm & (op in (JT.OP_KILL, JT.OP_RESTART))
                boot = rm & (op in (JT.OP_INIT, JT.OP_RESTART))
                want = dict(
                    pf_dispatch=jstep._sat_add(
                        pl["pf_dispatch"][b],
                        (oh[:, None] & k_oh[None] & rec).astype(np.int32)),
                    pf_busy=jstep._sat_add(
                        pl["pf_busy"][b],
                        np.where(oh & rec, o["now_delta"][b], 0)),
                    pf_kill=jstep._sat_add(pl["pf_kill"][b],
                                           (oh & kill & rec).astype(
                                               np.int32)),
                    pf_restart=jstep._sat_add(pl["pf_restart"][b],
                                              (oh & boot & rec).astype(
                                                  np.int32)))

                def boh(d):
                    return np.asarray(jnp.arange(LB) == (d >= thr).sum())
                recl = o["valid"][b] & o["lh_on"][b]
                want["lh_sojourn"] = jstep._sat_add(
                    pl["lh_sojourn"][b],
                    (oh[:, None] & boh(o["lat_sojourn"][b])[None]
                     & recl).astype(np.int32))
                done = o["is_complete"][b] & o["lh_on"][b]
                cpl = np.arange(5) == o["cpl_node"][b]
                lat, tgt = o["lat_e2e"][b], o["slo_target"][b]
                want["lh_e2e"] = jstep._sat_add(
                    pl["lh_e2e"][b],
                    (cpl[:, None] & boh(lat)[None] & done).astype(
                        np.int32))
                want["lh_slo_miss"] = jstep._sat_add(
                    pl["lh_slo_miss"][b],
                    (cpl & done & (tgt > 0) & (lat > tgt)).astype(
                        np.int32))
                for k, w in want.items():
                    np.testing.assert_array_equal(
                        np.asarray(w), got[k][b].numpy(),
                        err_msg=f"{case} lane {b} {k}")


def test_bucket_probes_fall_in_the_jax_steps_buckets():
    """The kernel's clz bucket rule and the plain threshold count are the
    JAX step's `(d >= thr).sum()` at every power of two and its
    neighbours, for several bucket counts."""
    d = np.asarray(bucket_probes(), np.int64)
    for LB in (1, 2, 8, 24, 32):
        plan = of.FoldPlan(2, 4, LB, CPU)
        oh = plan.bucket_onehot(torch.as_tensor(d.astype(np.int32)))
        got = oh.to(torch.int64).argmax(-1).numpy()
        thr = np.asarray([1 << j for j in range(LB - 1)], np.int64)
        want = (d[:, None] >= thr[None]).sum(-1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            [_bucket(int(x), LB) for x in d], want)


def test_obs_fold_refuses_what_the_kernel_does_not_take(standin):
    plan, planes, ops, has_cpl = fold_edge_operands(CPU, 8, 5, 24, 1)
    bad = dict(planes, pf_busy=planes["pf_busy"].t().contiguous().t())
    with pytest.raises(ValueError, match="pf_busy"):
        of.obs_fold.run(plan, bad, ops, has_cpl)
    bad = dict(planes, lh_e2e=planes["lh_e2e"][:, :, :4])
    with pytest.raises(ValueError, match="lh_e2e"):
        of.obs_fold.run(plan, bad, ops, has_cpl)
    with pytest.raises(ValueError, match="op"):
        of.obs_fold.run(plan, planes, dict(ops, op=ops["op"].to(
            torch.int64)), has_cpl)
    off = {k: v[:, :0] if v.ndim > 1 else v for k, v in planes.items()}
    with pytest.raises(ValueError, match="every plane"):
        of.obs_fold.run(plan, off, ops, has_cpl)
    assert of.obs_fold.launches == 0


# --------------------------------------------------------------------------
# plane_sums and lane_p99
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", DIGEST_CASES)
def test_plane_sums_kernel_path_equals_the_plain_version(standin, case):
    leaves, masks, _ = digest_edge_operands(CPU, 1200, 5, 24, 7, case)
    got = pd.plane_sums.run(leaves, masks)
    want = pd.plane_sums_plain(leaves, masks)
    assert pd.plane_sums.launches == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g, w)
    n = int(got[0][1]) + 65536 * int(got[0][0])
    assert n == int(masks[0].sum())


@pytest.mark.parametrize("case", DIGEST_CASES)
def test_lane_p99_kernel_path_equals_the_plain_version(standin, case):
    _, _, hist = digest_edge_operands(CPU, 300, 5, 24, 9, case)
    got = pd.lane_p99.run(hist)
    want = pd.lane_p99(hist)
    assert pd.lane_p99.launches == 1
    assert torch.equal(got, want)


def test_plain_digests_are_the_jax_packages():
    """plane_sums_plain against `_masked_half_sums` and lane_p99_plain
    against `_lane_e2e_p99` of the JAX package."""
    from madsim_tpu.parallel import stats as js
    for case in ("random", "negative", "int32_max", "sparse"):
        leaves, masks, hist = digest_edge_operands(CPU, 500, 5, 24, 4,
                                                   case)
        got = pd.plane_sums_plain(leaves, masks)
        for (x, mi), g in zip(leaves, got):
            m = masks[mi].numpy()
            xv = (np.ones(500, np.int32) if x is None else x.numpy())
            w = m.astype(np.int32).reshape((500,) + (1,) * (xv.ndim - 1))
            want = np.asarray(js._masked_half_sums(jnp.asarray(xv),
                                                   jnp.asarray(w)))
            np.testing.assert_array_equal(want, g.numpy(), err_msg=case)
        if case != "int32_max":      # float sums exact below 2^24
            np.testing.assert_array_equal(
                np.asarray(js._lane_e2e_p99(jnp.asarray(hist.numpy()))),
                pd.lane_p99(hist).numpy(), err_msg=case)


def test_digest_wrappers_refuse_what_the_kernels_do_not_take(standin):
    leaves, masks, hist = digest_edge_operands(CPU, 64, 5, 24, 2)
    with pytest.raises(ValueError, match="names no mask"):
        pd.plane_sums.run([(None, 1)], (masks[0], None))
    with pytest.raises(ValueError, match="leaf"):
        pd.plane_sums.run([(leaves[1][0].to(torch.int64), 0)], masks)
    with pytest.raises(ValueError, match="leaf"):
        pd.plane_sums.run([(leaves[2][0][:, :0], 0)], masks)
    with pytest.raises(ValueError, match="1 to 16"):
        pd.plane_sums.run([(None, 0)] * 17, masks)
    with pytest.raises(ValueError, match="mask 1"):
        pd.plane_sums.run([(None, 0)], (masks[0], masks[1][:3]))
    with pytest.raises(ValueError, match="contiguous int32"):
        pd.lane_p99.run(hist.transpose(1, 2))
    with pytest.raises(ValueError, match="fit"):
        pd.lane_p99.run(torch.zeros((2, 32, 512), dtype=torch.int32))
    assert pd.plane_sums.launches == pd.lane_p99.launches == 0


def test_sums_blocks_cover_every_lane_once():
    for M in (1, 3, 5, 20, 120, 256, 300):
        for B in (1, 127, 128, 100_000):
            run = (pd.THREADS // min(M, pd.THREADS)) * pd.LOADS_PER_THREAD
            n = pd.sums_blocks(M, B)
            assert (n - 1) * run < B <= n * run


def test_the_select_counts_the_occupied_rows():
    """sched_pick's optional occupancy output (the profiler's pre-pop
    queue depth, the JAX step's `occupied.sum()`) leaves its nine outputs
    as they are."""
    from chip_smoke import edge_inputs
    from madsim_tpu_torch.ops.sched_pick import sched_pick
    args = edge_inputs(CPU, 300, 33, 5, seed=2)
    plain = sched_pick(*args)
    out = sched_pick(*args, True)
    assert len(plain) == 9 and len(out) == 10
    assert all(torch.equal(a, b) for a, b in zip(plain, out))
    want = (args[0].numpy() != 0).sum(-1)
    np.testing.assert_array_equal(out[9].numpy(), want)
    assert out[9].dtype == torch.int32


# --------------------------------------------------------------------------
# the sketch, series and span groups of obs_fold, against the JAX step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["planes_random", "planes_int32_max",
                                  "planes_windows", "planes_every_1"])
def test_new_fold_groups_are_the_jax_steps_fold(case):
    """The plain fold's sketch, series and span groups against the JAX
    step's own expressions (madsim_tpu/core/step.py 770-902: `_sat_add`,
    the one-hots, the window and checkpoint arithmetic in jnp int32), all
    lanes at once: window boundaries, the clamp into the last window,
    saturation, sketch_every = 1, meas_dnode = -1 and past N - 1."""
    from madsim_tpu.core import step as jstep
    from madsim_tpu.core import types as JT
    plan, planes, ops, has_cpl = fold_edge_operands(CPU, 97, 5, 24, 7,
                                                    case)
    got = clone_tree(planes)
    of.obs_fold_plain(plan, got, ops, has_cpl)
    o = {k: jnp.asarray(v.numpy()) for k, v in ops.items()}
    pl = {k: jnp.asarray(v.numpy()) for k, v in planes.items()}
    N, LB, S, W = plan.N, plan.LB, plan.S, plan.W
    thr = jnp.asarray([1 << j for j in range(LB - 1)], jnp.int32)
    sat = jstep._sat_add
    with reference_stream():
        valid = o["valid"]
        # spans (step.py:770-792)
        lat, tgt = o["lat_e2e"], o["slo_target"]
        tail = o["is_complete"] & o["sp_on"] & (tgt > 0) & (lat > tgt)
        oh_cpl = jnp.arange(N) == o["cpl_node"][:, None]
        comp = jnp.stack([jnp.ones_like(lat), o["meas_sq"], o["meas_sn"],
                          o["meas_sh"]], -1)
        dn = o["meas_dnode"]
        oh_dom = ((jnp.arange(N) == jnp.clip(dn, 0, N - 1)[:, None])
                  & (tail & (dn >= 0))[:, None])
        want = dict(
            sa_tail=sat(pl["sa_tail"], jnp.where(
                (oh_cpl & tail[:, None])[:, :, None], comp[:, None, :], 0)),
            sa_bottleneck=sat(pl["sa_bottleneck"],
                              oh_dom.astype(jnp.int32)))
        # sketch (:794-811)
        period = jnp.maximum(o["sketch_every"], 1)
        ck = o["steps"] // period
        at_ck = (valid & (o["steps"] == ck * period) & (ck >= 1)
                 & (ck <= S))
        oh_ck = (jnp.arange(S) == jnp.clip(ck - 1, 0, S - 1)[:, None]) \
            & at_ck[:, None]
        sh = o["sched_hash"]
        want["cov_sketch"] = jnp.where(oh_ck, (sh[:, 0] ^ sh[:, 1])[:, None],
                                       pl["cov_sketch"])
        # series (:813-902)
        rec = valid & o["sr_on"]
        w_idx = jnp.minimum(o["now"] // jnp.maximum(o["window_len"], 1),
                            W - 1)
        oh_w = jnp.arange(W) == w_idx[:, None]
        oh_n = jnp.arange(N) == o["act_node"][:, None]
        cell = oh_w[:, :, None] & oh_n[:, None, :] & rec[:, None, None]
        op, rm = o["op"], o["reset_mask"]

        def opin(*ops_):
            hit = op == ops_[0]
            for x in ops_[1:]:
                hit = hit | (op == x)
            return hit
        f_bits = (
            jnp.where(rm & opin(JT.OP_KILL, JT.OP_RESTART), JT.SRF_KILL, 0)
            | jnp.where(rm & opin(JT.OP_INIT, JT.OP_RESTART), JT.SRF_BOOT, 0)
            | jnp.where(opin(JT.OP_CLOG_NODE, JT.OP_CLOG_LINK,
                             JT.OP_PARTITION, JT.OP_PARTITION_ONEWAY),
                        JT.SRF_PARTITION, 0)
            | jnp.where(opin(JT.OP_HEAL, JT.OP_UNCLOG_NODE,
                             JT.OP_UNCLOG_LINK), JT.SRF_HEAL, 0)
            | jnp.where(opin(JT.OP_SET_LOSS, JT.OP_SET_LATENCY),
                        JT.SRF_NET, 0)
            | jnp.where(opin(JT.OP_SET_SKEW, JT.OP_SET_DISK),
                        JT.SRF_GRAY, 0)
            | jnp.where(opin(JT.OP_RESET_PEER, JT.OP_SET_DUP),
                        JT.SRF_CONN, 0))
        ohr = oh_w & rec[:, None]
        done = o["is_complete"] & o["sr_on"]
        boh = jnp.arange(LB) == (lat[:, None] >= thr).sum(-1)[:, None]
        want.update(
            sr_dispatch=sat(pl["sr_dispatch"], cell.astype(jnp.int32)),
            sr_busy=sat(pl["sr_busy"], jnp.where(
                cell, o["now_delta"][:, None, None], 0)),
            sr_qhw=jnp.where(ohr, jnp.maximum(pl["sr_qhw"], jnp.maximum(
                o["occ_disp"], o["high_water"])[:, None]), pl["sr_qhw"]),
            sr_drop=sat(pl["sr_drop"], jnp.where(
                ohr, (o["delivered_drop"] + o["dropped"].astype(jnp.int32))
                [:, None], 0)),
            sr_dup=sat(pl["sr_dup"],
                       (ohr & o["dup_fire"][:, None]).astype(jnp.int32)),
            sr_fault=pl["sr_fault"] | jnp.where(ohr, f_bits[:, None], 0),
            sr_complete=sat(pl["sr_complete"],
                            (oh_w & done[:, None]).astype(jnp.int32)),
            sr_slo_miss=sat(pl["sr_slo_miss"], (oh_w & (
                done & (tgt > 0) & (lat > tgt))[:, None]).astype(jnp.int32)),
            sr_lat=sat(pl["sr_lat"], (oh_w[:, :, None] & boh[:, None, :]
                                      & done[:, None, None]).astype(
                jnp.int32)))
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(w), got[k].numpy(),
                                          err_msg=f"{case} {k}")


# --------------------------------------------------------------------------
# plane_sums' max and or leaves, lane_burst
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", SERIES_DIGEST_CASES)
def test_series_digest_kernel_paths_equal_the_plain_versions(standin, case):
    leaves, masks, lat = series_digest_operands(CPU, 700, 6, 5, 24, 3, case)
    got = pd.plane_sums.run(leaves, masks)
    want = pd.plane_sums_plain(leaves, masks)
    assert pd.plane_sums.launches == 1 and len(got) == len(leaves)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g, w)
    b = pd.lane_burst.run(lat)
    assert pd.lane_burst.launches == 1
    assert torch.equal(b, pd.lane_burst(lat))


def test_series_digest_plain_versions_are_the_jax_packages():
    """The max and or leaves against `_series_digest`'s `where(on, x,
    0).max(0)` and its 8-bit OR fold, the sums against
    `_masked_half_sums`, and lane_burst_plain against `_lane_burst_lat`
    (float sums exact below 2^24)."""
    from madsim_tpu.parallel import stats as js
    for case in ("random", "negative", "sparse", "int32_max"):
        leaves, masks, lat = series_digest_operands(CPU, 300, 6, 5, 24, 8,
                                                    case)
        got = pd.plane_sums_plain(leaves, masks)
        with reference_stream():
            for lf, g in zip(leaves, got):
                x, mi = lf[0], lf[1]
                op = lf[2] if len(lf) == 3 else "sum"
                on = jnp.asarray(masks[mi].numpy())
                xv = (jnp.ones(300, jnp.int32) if x is None
                      else jnp.asarray(x.numpy()))
                onb = on.reshape((300,) + (1,) * (xv.ndim - 1))
                if op == "max":
                    want = jnp.where(onb, xv, 0).max(0)
                elif op == "or":
                    bits = jnp.arange(8)
                    present = (((xv[..., None] >> bits) & 1) > 0) \
                        & onb[..., None]
                    want = (present.any(0).astype(jnp.int32) << bits).sum(-1)
                    g = g & 0xFF
                else:
                    want = js._masked_half_sums(xv, onb.astype(jnp.int32))
                np.testing.assert_array_equal(np.asarray(want), g.numpy(),
                                              err_msg=f"{case} {op}")
            if case != "int32_max":
                np.testing.assert_array_equal(
                    np.asarray(js._lane_burst_lat(jnp.asarray(lat.numpy()))),
                    pd.lane_burst(lat).numpy(), err_msg=case)


def test_new_digest_wrappers_refuse_what_the_kernels_do_not_take(standin):
    leaves, masks, lat = series_digest_operands(CPU, 64, 4, 5, 24, 2)
    with pytest.raises(ValueError, match="op"):
        pd.plane_sums.run([(None, 0, "max")], masks)
    with pytest.raises(ValueError, match="op"):
        pd.plane_sums.run([(leaves[2][0], 0, "min")], masks)
    with pytest.raises(ValueError, match="contiguous int32"):
        pd.lane_burst.run(lat.transpose(1, 2))
    with pytest.raises(ValueError, match="fit"):
        pd.lane_burst.run(torch.zeros((2, 400, 32), dtype=torch.int32))
    assert pd.plane_sums.launches == pd.lane_burst.launches == 0
