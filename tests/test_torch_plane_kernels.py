"""K8 (`obs_fold`, madsim_tpu_torch/ops/obs_fold.py) and K10
(`plane_sums`, `lane_p99`, ops/plane_digest.py) on the CPU: their plain
versions against the JAX package's functions (tolerance: zero), and their
launch logic through stand-in launchers.

The CUDA kernels (csrc/obs_fold.cu, csrc/plane_digest.cu) run only on the
card, where chip_smoke.py holds them exactly equal to these plain
versions on the same edge cases (chip_smoke `fold_edge_operands`,
`digest_edge_operands`). Here each wrapper's kernel path runs with a
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
from chip_smoke import (DIGEST_CASES, FOLD_CASES, bucket_probes,
                        clone_tree, digest_edge_operands,
                        fold_edge_operands)
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


def _fold_standin(ref, stream):
    """csrc/obs_fold.cu on host memory: one lane at a time, each counter
    read and written only at the element its one-hot selects."""
    p = ref._obj
    B, N, K, LB = p.B, p.N, p.K, p.LB
    if N < 1 or K < 0 or LB < 0 or (p.has_lh and LB < 1):
        return 1
    nP = N if p.has_pf else 0
    nL = N if p.has_lh else 0
    v = {}
    for name, n in (("pf_dispatch", B * nP * K), ("pf_busy", B * nP),
                    ("pf_kill", B * nP), ("pf_restart", B * nP),
                    ("pf_qmax", B), ("pf_drop", B), ("pf_delay", B),
                    ("lh_sojourn", B * nL * LB), ("lh_e2e", B * nL * LB),
                    ("lh_slo_miss", B * nL)):
        v[name] = _view(getattr(p, name), n, np.int32)
    for name in of.BOOL_OPS:
        v[name] = _view(getattr(p, name), B, np.uint8)
    for name in of.INT_OPS:
        v[name] = _view(getattr(p, name), B, np.int32)

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
    total = sum(2 * p.leaves[i].M for i in range(p.n_leaves))
    out = _view(p.out, total, np.uint32)
    for i in range(p.n_leaves):
        lf = p.leaves[i]
        if lf.M < 1 or masks[lf.mask] is None:
            return 1
        nxt = (p.leaves[i + 1].first_block if i + 1 < p.n_leaves
               else p.blocks)
        run = (pd.THREADS // min(lf.M, pd.THREADS)) * pd.LOADS_PER_THREAD
        assert (nxt - lf.first_block) * run >= B > (
            nxt - lf.first_block - 1) * run
        x = (_view(lf.x, B * lf.M, np.int32).reshape(B, lf.M).astype(
            np.int64) if lf.x else np.ones((B, lf.M), np.int64))
        on = masks[lf.mask].astype(bool)
        for blk in range(nxt - lf.first_block):
            rows = x[blk * run:(blk + 1) * run][on[blk * run:(blk + 1)
                                                   * run]]
            hi = (rows >> 16).sum(0) % 2**32
            lo = (rows & 0xFFFF).sum(0) % 2**32
            out[lf.out:lf.out + lf.M] += hi.astype(np.uint32)
            out[lf.out + lf.M:lf.out + 2 * lf.M] += lo.astype(np.uint32)
    return 0


def _p99_standin(ref, stream):
    """csrc/plane_digest.cu lane_p99 on host memory, float32 in the
    kernel's order of operations."""
    p = ref._obj
    if p.N < 1 or p.LB < 1 or not 1 <= p.lanes_per_block <= pd.P99_LANES:
        return 1
    if p.lanes_per_block * (p.N * p.LB + 1) * 4 > pd.P99_SMEM:
        return 1
    B, N, LB = p.B, p.N, p.LB
    h = _view(p.hist, B * N * LB, np.int32).reshape(B, N, LB)
    out = _view(p.out, B, np.int32)
    f32, q = np.float32, np.float32(p.q)
    for b in range(B):
        def bucket_sum(k):
            s = f32(h[b, 0, k])
            for n in range(1, N):
                s = f32(s + f32(h[b, n, k]))
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
        out[b] = (0 if j == 0 else 1 << (j - 1)) if total > 0 else 0
    return 0


@pytest.fixture
def standin(monkeypatch):
    """Each wrapper's kernel path on the CPU with its stand-in launcher."""
    for w, fn in ((of.obs_fold, _fold_standin),
                  (pd.plane_sums, _sums_standin),
                  (pd.lane_p99, _p99_standin)):
        monkeypatch.setattr(w, "_fn", fn)
        monkeypatch.setattr(w, "launches", 0)


# --------------------------------------------------------------------------
# obs_fold
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", FOLD_CASES)
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
    changed = sum(int((a[k] != planes[k]).sum()) for k in planes)
    if case == "all_masked":
        assert changed == sum(int((a[k] != planes[k]).sum())
                              for k in ("pf_qmax",))
    else:
        assert changed > 0


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
    with pytest.raises(ValueError, match="both planes"):
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
