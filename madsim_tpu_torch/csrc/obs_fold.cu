// obs_fold: the observation fold of one simulation step (K8), for every
// lane, IN PLACE: the sim profiler's counters (pf_*) and the latency
// plane's log2 histograms (lh_*).
//
// Replaces the XLA-lowered fold blocks of the JAX package's step
// (madsim_tpu/core/step.py `live_step`: the profiler block, lines
// 673-714, and the latency block, lines 716-768). Per lane b, where the
// dispatch was valid and the lane's gate is on (pf_on, lh_on):
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
//
// Every += saturates at int32 max as `_sat_add` (step.py:46-51): a + d
// unless a > INT32_MAX - d (that difference wrapping as int32 does). A
// log2 bucket is the count of thresholds 2^j <= d for j < LB - 1: 0 for
// d < 1, else min(32 - clz(d), LB - 1). An acting or completion node
// outside [0, N), or a kind outside [0, K), selects nothing, as the JAX
// one-hot does. Integers only, so the kernel must equal its plain
// PyTorch version (madsim_tpu_torch/ops/obs_fold.py `obs_fold_plain`,
// which writes the whole one-hot the way the JAX package does) exactly.
//
// Bound: bytes. Each lane reads its 18 operands (6 bools, 12 int32) and
// reads and writes the elements it changes: at most 6 counter words and
// 3 scalars, each a 32-byte sector of its own since the lanes' rows are
// far apart. At the flagship's B = 100,000 that is about 7 MB of operands
// and up to 9 sectors a recording lane, some 0.01 ms at 3.35 TB/s.
// Design: one thread a lane; consecutive lanes on consecutive threads,
// so each [B] operand is read coalesced, and a counter element is read
// and written only where its one-hot selects it. Nothing else is
// touched: the whole-one-hot write of the JAX package would move every
// plane leaf (about 1 KB a lane with both planes) each step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr int32_t kOpInit = 1;
constexpr int32_t kOpKill = 2;
constexpr int32_t kOpRestart = 3;

}  // namespace

// Operands of one launch. The ten plane leaves are contiguous int32,
// [B, N, K] / [B, N] / [B] for pf_*, [B, N, LB] / [B, N] for lh_*, written
// in place; the [B] operands are bool (uint8) or int32.
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
  const uint8_t* valid;
  const uint8_t* pf_on;
  const uint8_t* lh_on;
  const uint8_t* reset_mask;
  const uint8_t* dropped;
  const uint8_t* is_complete;
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
  int B, N, K, LB, has_pf, has_lh, has_cpl;
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
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int obs_fold_launch(const FoldParams* params, void* stream) {
  const FoldParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.N < 1 || p.K < 0 || p.LB < 0 || (p.has_lh && p.LB < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.B + kThreads - 1) / kThreads));
  obs_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
