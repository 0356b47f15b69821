// apply_super: the supervisor op of one step, IN PLACE.
//
// Replaces the JAX package's `_apply_super` (madsim_tpu/core/step.py
// :1007) with its NODE_RANDOM pick (`masked_choice` over the node pool,
// :1041; madsim_tpu/ops/select.py:17). The plain version, held equal to
// this kernel, is madsim_tpu_torch/ops/apply_super.py
// `apply_super_plain`. Per lane, with op, node, src and the payload of
// the dispatched supervisor event:
//
//   target      node, or with node = NODE_RANDOM the (r+1)-th node of the
//               op's pool (alive for KILL/PAUSE/CLOG_NODE, dead for
//               RESTART, paused for RESUME, clogged for UNCLOG_NODE, else
//               every node), narrowed by the payload's bitmask words (31
//               nodes a word) where any is nonzero, r = randint(split(key,
//               2)[0], 0, max(count, 1)); an empty pool makes the op void
//   KILL        clears the target's MSG and TIMER rows (kind FREE,
//               deadline T_INF), kills it; RESTART = KILL + INIT (boot)
//   node ops    alive, paused, clog_node of the target; clog_link[src][
//               target] for CLOG_LINK / UNCLOG_LINK; the whole link matrix
//               for PARTITION (the cut A <-> not-A of the payload's bit
//               set), PARTITION_ONEWAY (ORs the cut A -> not-A, reversed
//               for odd src) and HEAL (clears it and clog_node)
//   lane knobs  loss = payload[0] / 1e6 (correctly rounded float32, as the
//               reference's division), lat_lo / lat_hi; the target's skew,
//               disk delay (torn from payload[P-2]) and dup rate from
//               payload[P-1], each clipped to its cap
//   boot        the target's row of every leaf of the reset table (the
//               non-persistent node-state leaves) takes its default
//   outputs     init_node (target on boot, else -1), target, reset_mask
//               (kill | boot), effective (the op was not void)
//
// The writes go into the state's own tensors; nothing else is touched.
//
// Bound: bytes, and for the flagship's data very few of them. Most lanes
// dispatched no supervisor event (op 0, an in-range node): such a lane
// reads op, node and src and writes its four outputs. Design: a thread
// takes a lane, so those lanes are four coalesced loads and four stores,
// and the rare op lanes (a kill's scan of the lane's C table rows, a
// boot's reset rows, a partition's matrix) run in their own thread with
// no coordination. The pool is a bitmask, so the pick is a popcount and a
// walk over at most 32 bits.

#include <cstdint>

#include "threefry.cuh"

constexpr int kMaxLeaves = 48;

// One node-state leaf of the boot reset table: its [B, N, row] tensor,
// the element size (4: int32, 1: bool) and the offset of its default row
// in the defaults table.
struct SuperLeaf {
  void* ptr;
  int32_t row;
  int32_t esize;
  int32_t dflt;
  int32_t pad;
};

// The launch parameters, field for field the ctypes structure of the
// wrapper; outside the unnamed namespace so that the C entry point keeps
// external linkage.
struct SuperParams {
  const int32_t* op;          // [B]
  const int32_t* node;        // [B]
  const int32_t* src;         // [B]
  const int32_t* payload;     // [B, P]
  const int32_t* key;         // [B, 2]
  int32_t* t_kind;            // [B, C], written in place
  const int32_t* t_node;      // [B, C]
  int32_t* t_deadline;        // [B, C], written in place
  uint8_t* alive;             // [B, N] bool, all in place from here
  uint8_t* paused;
  uint8_t* clog_node;
  uint8_t* clog_link;         // [B, N, N]
  float* loss;                // [B]
  int32_t* lat_lo;
  int32_t* lat_hi;
  int32_t* skew;              // [B, N]
  int32_t* disk_lat;
  uint8_t* torn;
  int32_t* dup_rate;
  const int32_t* defaults;    // every reset leaf's default row, int32
  int32_t* init_node;         // [B] outputs
  int32_t* target;
  uint8_t* reset_mask;
  uint8_t* effective;
  SuperLeaf leaves[kMaxLeaves];
  int B, C, N, P, n_leaves;
};

namespace {

constexpr int kThreads = 256;
constexpr int32_t kNodeRandom = -1;
constexpr int32_t kEvFree = 0, kEvMsg = 1, kEvTimer = 2;
constexpr int32_t kTInf = 0x7FFFFFFF;
constexpr int32_t kSkewCap = 512;
constexpr int32_t kDiskLatCap = 10000000;
constexpr int32_t kDupRateCap = 900000;

enum : int32_t {
  kOpInit = 1, kOpKill = 2, kOpRestart = 3, kOpPause = 4, kOpResume = 5,
  kOpClogNode = 6, kOpUnclogNode = 7, kOpClogLink = 8, kOpUnclogLink = 9,
  kOpSetLoss = 10, kOpSetLatency = 12, kOpHeal = 13, kOpPartition = 14,
  kOpPartitionOneway = 15, kOpSetSkew = 16, kOpSetDisk = 17,
  kOpSetDup = 19
};

__device__ __forceinline__ int32_t clip(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// bit n: byte n of a lane's [N] bool vector is set
__device__ __forceinline__ uint32_t bits_of(const uint8_t* v, int N) {
  uint32_t m = 0;
  for (int n = 0; n < N; ++n) m |= (v[n] ? 1u : 0u) << n;
  return m;
}

__global__ void __launch_bounds__(kThreads)
apply_super_kernel(const SuperParams p) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (b >= p.B) return;
  const int N = p.N, P = p.P, C = p.C;
  const int32_t op = p.op[b];
  const int32_t nd = p.node[b];
  const int32_t src = p.src[b];
  const int32_t* pay = p.payload + b * P;
  const uint32_t all = N == 32 ? 0xFFFFFFFFu : (1u << N) - 1u;
  const bool is_random = nd == kNodeRandom;

  // the payload's node set, 31 nodes a word (PARTITION's group A, and a
  // NODE_RANDOM op's pool)
  uint32_t in_a = 0;
  if (is_random || op == kOpPartition || op == kOpPartitionOneway) {
    for (int n = 0; n < N; ++n) {
      const int w = n / 31;
      const uint32_t word = w < P ? static_cast<uint32_t>(pay[w]) : 0u;
      in_a |= ((word >> (n - 31 * w)) & 1u) << n;
    }
  }

  int32_t target;
  bool eff = true;
  const int64_t row0 = b * N;
  if (is_random) {
    uint32_t pool = all;
    if (op == kOpKill || op == kOpPause || op == kOpClogNode)
      pool = bits_of(p.alive + row0, N);
    else if (op == kOpRestart)
      pool = ~bits_of(p.alive + row0, N) & all;
    else if (op == kOpResume)
      pool = bits_of(p.paused + row0, N);
    else if (op == kOpUnclogNode)
      pool = bits_of(p.clog_node + row0, N);
    const int n_pool_words = P < (N + 30) / 31 ? P : (N + 30) / 31;
    bool any = false;
    for (int w = 0; w < n_pool_words; ++w) any |= pay[w] != 0;
    if (any) pool &= in_a;
    const int cnt = __popc(pool);
    uint32_t k0, k1;
    threefry::split_key(static_cast<uint32_t>(p.key[2 * b]),
                        static_cast<uint32_t>(p.key[2 * b + 1]), 2, 0, k0,
                        k1);
    int r = threefry::randint_raw(k0, k1, 0, cnt > 1 ? cnt : 1);
    int rnd = 0;
    for (int n = 0; n < N; ++n) {     // the (r+1)-th node of the pool
      if ((pool >> n) & 1u) {
        if (r == 0) {
          rnd = n;
          break;
        }
        --r;
      }
    }
    eff = cnt > 0;
    target = rnd;
  } else {
    target = clip(nd, 0, N - 1);
  }
  const int64_t at = row0 + target;       // the target's [B, N] entry

  auto when = [&](bool c) { return c && eff; };
  const bool kill = when(op == kOpKill || op == kOpRestart);
  const bool boot = when(op == kOpInit || op == kOpRestart);

  if (kill) {    // drop the target's queued messages and timers
    const int64_t t0 = b * C;
    for (int c = 0; c < C; ++c) {
      if (p.t_node[t0 + c] == target) {
        const int32_t k = p.t_kind[t0 + c];
        if (k == kEvMsg || k == kEvTimer) {
          p.t_kind[t0 + c] = kEvFree;
          p.t_deadline[t0 + c] = kTInf;
        }
      }
    }
  }
  if (kill || boot) p.alive[at] = boot ? 1 : 0;
  if (kill || boot || when(op == kOpResume)) p.paused[at] = 0;
  else if (when(op == kOpPause)) p.paused[at] = 1;
  if (when(op == kOpClogNode)) p.clog_node[at] = 1;
  if (when(op == kOpUnclogNode)) p.clog_node[at] = 0;

  uint8_t* link = p.clog_link + b * N * N;
  const int src_c = clip(src, 0, N - 1);
  if (when(op == kOpClogLink)) link[src_c * N + target] = 1;
  if (when(op == kOpUnclogLink)) link[src_c * N + target] = 0;
  if (when(op == kOpPartition)) {
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j)
        link[i * N + j] = ((in_a >> i) & 1u) != ((in_a >> j) & 1u);
  }
  if (when(op == kOpPartitionOneway)) {
    const bool rev = (src & 1) == 1;
    for (int i = 0; i < N; ++i) {
      for (int j = 0; j < N; ++j) {
        const int from = rev ? j : i, to = rev ? i : j;
        if (((in_a >> from) & 1u) && !((in_a >> to) & 1u))
          link[i * N + j] = 1;
      }
    }
  }
  if (when(op == kOpHeal)) {
    for (int q = 0; q < N * N; ++q) link[q] = 0;
    for (int n = 0; n < N; ++n) p.clog_node[row0 + n] = 0;
  }

  if (when(op == kOpSetLoss))
    p.loss[b] = __fdiv_rn(static_cast<float>(pay[0]), 1e6f);
  if (when(op == kOpSetLatency)) {
    p.lat_lo[b] = pay[0];
    p.lat_hi[b] = pay[1] > pay[0] ? pay[1] : pay[0];
  }
  // the gray-failure values ride the payload's last word
  if (when(op == kOpSetSkew))
    p.skew[at] = clip(pay[P - 1], -kSkewCap, kSkewCap);
  if (when(op == kOpSetDisk)) {
    p.disk_lat[at] = clip(pay[P - 1], 0, kDiskLatCap);
    p.torn[at] = pay[P - 2] != 0 ? 1 : 0;
  }
  if (when(op == kOpSetDup))
    p.dup_rate[at] = clip(pay[P - 1], 0, kDupRateCap);

  if (boot) {    // volatile protocol state back to the spec default
    for (int l = 0; l < p.n_leaves; ++l) {
      const SuperLeaf lf = p.leaves[l];
      const int64_t off = at * lf.row;
      const int32_t* d = p.defaults + lf.dflt;
      if (lf.esize == 4) {
        int32_t* dst = static_cast<int32_t*>(lf.ptr) + off;
        for (int e = 0; e < lf.row; ++e) dst[e] = d[e];
      } else {
        uint8_t* dst = static_cast<uint8_t*>(lf.ptr) + off;
        for (int e = 0; e < lf.row; ++e) dst[e] = d[e] != 0 ? 1 : 0;
      }
    }
  }

  p.init_node[b] = boot ? target : -1;
  p.target[b] = target;
  p.reset_mask[b] = (kill || boot) ? 1 : 0;
  p.effective[b] = eff ? 1 : 0;
}

}  // namespace

extern "C" int apply_super_launch(const SuperParams* params, void* stream) {
  const SuperParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.C < 1 || p.N < 1 || p.N > 32 || p.P < 2 || p.n_leaves < 0
      || p.n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < p.n_leaves; ++l)
    if (p.leaves[l].esize != 4 && p.leaves[l].esize != 1)
      return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.B + kThreads - 1) / kThreads));
  apply_super_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
