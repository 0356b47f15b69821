// obs_fold: the observation fold of one simulation step (K8), for every
// lane, IN PLACE: the sim profiler's counters (pf_*), the latency plane's
// log2 histograms (lh_*), and, each in a gated group of its own, the
// span plane's tail attribution (sa_*), the prefix-coverage sketch
// (cov_sketch) and the windowed series (sr_*).
//
// Replaces the XLA-lowered fold blocks of the JAX package's step
// (madsim_tpu/core/step.py `live_step`: the profiler block, lines
// 673-714, the latency block, 716-768, the span fold, 770-792, the
// sketch, 794-811, and the series fold, 813-902). Per lane b, where the
// dispatch was valid and the lane's gate is on (pf_on, lh_on, sp_on,
// sr_on):
//
//   pf_dispatch[b, act, kind] += 1       pf_busy[b, act] += now_delta
//   pf_kill[b, act] += 1    where reset_mask and op is KILL or RESTART
//   pf_restart[b, act] += 1 where reset_mask and op is INIT or RESTART
//   pf_qmax[b] = max(pf_qmax[b], occ_disp, high_water)
//   pf_drop[b] += delivered_drop + dropped   pf_delay[b] += delay_acc
//   lh_sojourn[b, act, bucket(lat_sojourn)] += 1
//   with complete_kinds, where is_complete and lh_on:
//     lh_e2e[b, cpl, bucket(lat_e2e)] += 1
//     lh_slo_miss[b, cpl] += 1 where slo_target > 0 and lat_e2e > it
//   spans (has_sp), where is_complete, sp_on, slo_target > 0 and
//   lat_e2e > slo_target:
//     sa_tail[b, cpl, :] += [1, meas_sq, meas_sn, meas_sh]
//     sa_bottleneck[b, min(meas_dnode, N - 1)] += 1 where meas_dnode >= 0
//   sketch (S > 0), where valid, with period = max(sketch_every, 1) and
//   ck = steps / period (floor): where steps == ck * period and
//   1 <= ck <= S, cov_sketch[b, ck - 1] = sched_hash[0] ^ sched_hash[1]
//   series (W > 0), in window w = min(now / max(window_len, 1), W - 1)
//   (floor; none where w < 0), where sr_on:
//     sr_dispatch[b, w, act] += 1         sr_busy[b, w, act] += now_delta
//     sr_qhw[b, w] = max(sr_qhw[b, w], occ_disp, high_water)
//     sr_drop[b, w] += delivered_drop + dropped
//     sr_dup[b, w] += dup_fire            sr_fault[b, w] |= SRF bits of op
//     with complete_kinds, for a completion: sr_complete[b, w] += 1,
//     sr_slo_miss[b, w] += 1 on a miss, sr_lat[b, w, bucket(lat_e2e)] += 1
//
// Every += saturates at int32 max as `_sat_add` (step.py:46-51): a + d
// unless a > INT32_MAX - d (that difference wrapping as int32 does). A
// log2 bucket is the count of thresholds 2^j <= d for j < LB - 1: 0 for
// d < 1, else min(32 - clz(d), LB - 1). An acting or completion node
// outside [0, N), or a kind outside [0, K), selects nothing, as the JAX
// one-hot does. sketch_every and window_len are read from the state a
// lane at a time (never launch constants), so a retune reaches a
// captured graph. Integers only, so the kernel must equal its plain
// PyTorch version (madsim_tpu_torch/ops/obs_fold.py `obs_fold_plain`,
// which writes the whole one-hot the way the JAX package does) exactly.
//
// Bound: bytes. Each lane reads its operands (up to 9 bools, 20 int32
// and its two sched_hash words) and reads and writes the elements it
// changes, each a 32-byte sector of its own since the lanes' rows are
// far apart: up to 6 counter words and 3 scalars for the profiler and
// latency planes, 5 for spans, 1 sketch word, up to 10 series words. At
// the flagship's B = 100,000 with the profiler and latency planes that
// is about 7 MB of operands and up to 9 sectors a recording lane, some
// 0.01 ms at 3.35 TB/s. Design: one thread a lane; consecutive lanes on
// consecutive threads, so each [B] operand is read coalesced, and a
// counter element is read and written only where its one-hot selects
// it. Nothing else is touched: the whole-one-hot write of the JAX
// package would move every plane leaf (about 6 KB a lane with every
// plane) each step. A group whose plane is compiled out is skipped by a
// launch-uniform branch and its operands are never read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr int32_t kOpInit = 1;
constexpr int32_t kOpKill = 2;
constexpr int32_t kOpRestart = 3;
constexpr int kSaComponents = 4;
// core/types.py SRF_* bits and the ops that mark each on dispatch
constexpr int32_t kSrfKill = 1, kSrfBoot = 2, kSrfPartition = 4,
                  kSrfHeal = 8, kSrfNet = 16, kSrfGray = 32, kSrfConn = 64;

}  // namespace

// Operands of one launch. The plane leaves are contiguous int32, [B, N, K]
// / [B, N] / [B] for pf_*, [B, N, LB] / [B, N] for lh_*, [B, S] for
// cov_sketch, [B, W, N] / [B, W, LB] / [B, W] for sr_*, [B, N, 4] / [B, N]
// for sa_*, written in place (null where a plane is compiled out); the
// [B] operands are bool (uint8) or int32, sched_hash [B, 2] int32.
struct FoldParams {
  int32_t* pf_dispatch;
  int32_t* pf_busy;
  int32_t* pf_kill;
  int32_t* pf_restart;
  int32_t* pf_qmax;
  int32_t* pf_drop;
  int32_t* pf_delay;
  int32_t* lh_sojourn;
  int32_t* lh_e2e;
  int32_t* lh_slo_miss;
  int32_t* cov_sketch;
  int32_t* sr_dispatch;
  int32_t* sr_busy;
  int32_t* sr_qhw;
  int32_t* sr_drop;
  int32_t* sr_dup;
  int32_t* sr_complete;
  int32_t* sr_slo_miss;
  int32_t* sr_lat;
  int32_t* sr_fault;
  int32_t* sa_tail;
  int32_t* sa_bottleneck;
  const uint8_t* valid;
  const uint8_t* pf_on;
  const uint8_t* lh_on;
  const uint8_t* reset_mask;
  const uint8_t* dropped;
  const uint8_t* is_complete;
  const uint8_t* sr_on;
  const uint8_t* sp_on;
  const uint8_t* dup_fire;
  const int32_t* act_node;
  const int32_t* cpl_node;
  const int32_t* ev_kind;
  const int32_t* op;
  const int32_t* now_delta;
  const int32_t* occ_disp;
  const int32_t* high_water;
  const int32_t* delivered_drop;
  const int32_t* delay_acc;
  const int32_t* lat_sojourn;
  const int32_t* lat_e2e;
  const int32_t* slo_target;
  const int32_t* steps;
  const int32_t* sketch_every;
  const int32_t* window_len;
  const int32_t* now;
  const int32_t* meas_sq;
  const int32_t* meas_sn;
  const int32_t* meas_sh;
  const int32_t* meas_dnode;
  const int32_t* sched_hash;
  int B, N, K, LB, has_pf, has_lh, has_cpl, S, W, has_sp;
};

namespace {

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              - static_cast<uint32_t>(b));
}

// `_sat_add`: a + d, or INT32_MAX where a > INT32_MAX - d (int32 wrap).
__device__ __forceinline__ void sat_add(int32_t* at, int32_t d) {
  const int32_t a = *at;
  *at = a > sub32(kI32Max, d) ? kI32Max : add32(a, d);
}

// The log2 bucket of d: the count of thresholds 2^j <= d, j < LB - 1.
__device__ __forceinline__ int bucket(int32_t d, int LB) {
  if (d < 1) return 0;
  const int b = 32 - __clz(d);
  return b < LB - 1 ? b : LB - 1;
}

// Floor division of a by b > 0 (jnp's // on int32).
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The SRF_* bits of a lane's supervisor op (op is 0 for a non-op
// dispatch): kill and boot where the op was effective (reset_mask),
// the other classes on dispatch.
__device__ __forceinline__ int32_t fault_bits(int32_t op, bool effective) {
  int32_t bits = 0;
  if (effective && (op == kOpKill || op == kOpRestart)) bits |= kSrfKill;
  if (effective && (op == kOpInit || op == kOpRestart)) bits |= kSrfBoot;
  switch (op) {
    case 6: case 8: case 14: case 15: bits |= kSrfPartition; break;
    case 7: case 9: case 13: bits |= kSrfHeal; break;
    case 10: case 12: bits |= kSrfNet; break;
    case 16: case 17: bits |= kSrfGray; break;
    case 18: case 19: bits |= kSrfConn; break;
    default: break;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
obs_fold_kernel(const FoldParams p) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (b >= p.B) return;
  const int N = p.N;
  const bool valid = p.valid[b] != 0;
  const int32_t act = p.act_node[b];
  const bool act_ok = act >= 0 && act < N;

  if (p.has_pf && valid && p.pf_on[b] != 0) {
    const int32_t kind = p.ev_kind[b];
    if (act_ok) {
      const int64_t na = b * N + act;
      if (kind >= 0 && kind < p.K) sat_add(p.pf_dispatch + na * p.K + kind, 1);
      sat_add(p.pf_busy + na, p.now_delta[b]);
      if (p.reset_mask[b] != 0) {
        const int32_t op = p.op[b];
        if (op == kOpKill || op == kOpRestart) sat_add(p.pf_kill + na, 1);
        if (op == kOpInit || op == kOpRestart) sat_add(p.pf_restart + na, 1);
      }
    }
    const int32_t occ = p.occ_disp[b], hw = p.high_water[b];
    const int32_t q = occ > hw ? occ : hw;
    if (q > p.pf_qmax[b]) p.pf_qmax[b] = q;
    sat_add(p.pf_drop + b, add32(p.delivered_drop[b], p.dropped[b]));
    sat_add(p.pf_delay + b, p.delay_acc[b]);
  }

  if (p.has_lh) {
    const bool on = p.lh_on[b] != 0;
    const int LB = p.LB;
    if (valid && on && act_ok)
      sat_add(p.lh_sojourn + (b * N + act) * LB
              + bucket(p.lat_sojourn[b], LB), 1);
    if (p.has_cpl && on && p.is_complete[b] != 0) {
      const int32_t cpl = p.cpl_node[b];
      if (cpl >= 0 && cpl < N) {
        const int32_t lat = p.lat_e2e[b];
        const int32_t target = p.slo_target[b];
        sat_add(p.lh_e2e + (b * N + cpl) * LB + bucket(lat, LB), 1);
        if (target > 0 && lat > target) sat_add(p.lh_slo_miss + b * N + cpl, 1);
      }
    }
  }

  // ---- spans: a tail completion's components at its node, its dominant
  // segment's owner
  if (p.has_sp && p.has_cpl && p.is_complete[b] != 0 && p.sp_on[b] != 0) {
    const int32_t lat = p.lat_e2e[b];
    const int32_t target = p.slo_target[b];
    if (target > 0 && lat > target) {
      const int32_t cpl = p.cpl_node[b];
      if (cpl >= 0 && cpl < N) {
        int32_t* t = p.sa_tail + (b * N + cpl) * kSaComponents;
        sat_add(t, 1);
        sat_add(t + 1, p.meas_sq[b]);
        sat_add(t + 2, p.meas_sn[b]);
        sat_add(t + 3, p.meas_sh[b]);
      }
      const int32_t dn = p.meas_dnode[b];
      if (dn >= 0) sat_add(p.sa_bottleneck + b * N + (dn < N ? dn : N - 1), 1);
    }
  }

  // ---- the prefix-coverage sketch: the running hash at a checkpoint
  if (p.S > 0 && valid) {
    const int32_t e = p.sketch_every[b];
    const int32_t period = e > 1 ? e : 1;
    const int32_t steps = p.steps[b];
    const int32_t ck = floor_div(steps, period);
    if (ck >= 1 && ck <= p.S && steps == ck * period)
      p.cov_sketch[b * p.S + ck - 1] =
          p.sched_hash[2 * b] ^ p.sched_hash[2 * b + 1];
  }

  // ---- the series: this dispatch's window
  if (p.W > 0 && valid && p.sr_on[b] != 0) {
    const int32_t wl = p.window_len[b];
    int32_t w = floor_div(p.now[b], wl > 1 ? wl : 1);
    if (w > p.W - 1) w = p.W - 1;
    if (w >= 0) {
      const int64_t bw = b * p.W + w;
      if (act_ok) {
        sat_add(p.sr_dispatch + bw * N + act, 1);
        sat_add(p.sr_busy + bw * N + act, p.now_delta[b]);
      }
      const int32_t occ = p.occ_disp[b], hw = p.high_water[b];
      const int32_t q = occ > hw ? occ : hw;
      if (q > p.sr_qhw[bw]) p.sr_qhw[bw] = q;
      sat_add(p.sr_drop + bw, add32(p.delivered_drop[b], p.dropped[b]));
      if (p.dup_fire[b] != 0) sat_add(p.sr_dup + bw, 1);
      const int32_t bits = fault_bits(p.op[b], p.reset_mask[b] != 0);
      if (bits != 0) p.sr_fault[bw] |= bits;
      if (p.has_cpl && p.is_complete[b] != 0) {
        const int32_t lat = p.lat_e2e[b];
        const int32_t target = p.slo_target[b];
        sat_add(p.sr_complete + bw, 1);
        if (target > 0 && lat > target) sat_add(p.sr_slo_miss + bw, 1);
        sat_add(p.sr_lat + bw * p.LB + bucket(lat, p.LB), 1);
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int obs_fold_launch(const FoldParams* params, void* stream) {
  const FoldParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.N < 1 || p.K < 0 || p.LB < 0 || (p.has_lh && p.LB < 1)
      || p.S < 0 || p.W < 0 || (p.has_sp && !(p.has_lh && p.has_cpl)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.B + kThreads - 1) / kThreads));
  obs_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
