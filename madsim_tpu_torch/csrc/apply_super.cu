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
// reads op, node and src and writes its four outputs. The rare op lanes
// add a kill's scan of the lane's C table rows, a boot's reset rows and a
// partition's N x N matrix. Design, in two phases per warp:
//
//   phase 1   a thread a lane: the coalesced loads of op, node and src,
//             the pool pick (the pool is a bitmask, so the pick is a
//             popcount and a walk over at most 32 bits), the lane's
//             scalar and node-vector writes and the four outputs
//   phase 2   the warp takes its heavy lanes (a kill, a boot, PARTITION,
//             PARTITION_ONEWAY or HEAL) one after another, picked out by a
//             ballot; the lane's index, target, node set and flags reach
//             the other threads by shuffle. The 32 threads scan its C
//             table rows in coalesced 32-wide chunks (four chunks' loads
//             in flight before the first compare), write its boot
//             reset rows spread over the flattened (leaf, element) space
//             (leaf l holds elements [start_l, start_l + row_l), the
//             prefix table `SuperPlan` builds; the defaults table is laid
//             out the same way) and write its link matrix a cell a thread
//
// So a kill's 3 x C dependent loads and stores in one thread become C/32
// coalesced ones for the warp, and a warp that holds one op lane no
// longer waits on that lane's serial loops. Where every lane is heavy
// (a RESTART in each), a boot's small scattered row writes, a sector
// each, bound both this mapping and a thread a lane alike. Every thread
// of a warp runs the ballot and the shuffles (ROADMAP F9): a thread past
// the last lane takes part with no lane of its own.

#include <cstdint>

#include "threefry.cuh"

constexpr int kMaxLeaves = 48;

// One node-state leaf of the boot reset table: its [B, N, row] tensor,
// the element size (4: int32, 1: bool) and its first element in the
// flattened (leaf, element) space, which is also the offset of its
// default row in the defaults table.
struct SuperLeaf {
  void* ptr;
  int32_t row;
  int32_t esize;
  int32_t start;
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
  int B, C, N, P, n_leaves, reset_elems;
};

namespace {

constexpr int kThreads = 256;
constexpr int kKillChunks = 4;      // a kill's table rows: 128 a pass
constexpr unsigned kFull = 0xFFFFFFFFu;
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

// a heavy lane's work, as the flags phase 2 receives by shuffle
enum : int {
  kDoKill = 1, kDoBoot = 2, kDoPartition = 4, kDoOneway = 8, kDoHeal = 16,
  kReversed = 32
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
  const int32_t* __restrict__ op_in = p.op;
  const int32_t* __restrict__ node_in = p.node;
  const int32_t* __restrict__ src_in = p.src;
  const int32_t* __restrict__ payload = p.payload;
  const int32_t* __restrict__ key = p.key;
  const int32_t* __restrict__ t_node = p.t_node;
  const int32_t* __restrict__ defaults = p.defaults;
  int32_t* __restrict__ t_kind = p.t_kind;
  int32_t* __restrict__ t_deadline = p.t_deadline;
  uint8_t* __restrict__ alive = p.alive;
  uint8_t* __restrict__ paused = p.paused;
  uint8_t* __restrict__ clog_node = p.clog_node;
  uint8_t* __restrict__ clog_link = p.clog_link;

  const int b = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int N = p.N, P = p.P, C = p.C;

  // ---- phase 1: a thread a lane -------------------------------------------
  int32_t target = 0;
  uint32_t in_a = 0;
  int flags = 0;
  if (b < p.B) {
    const int32_t op = __ldg(op_in + b);
    const int32_t nd = __ldg(node_in + b);
    const int32_t src = __ldg(src_in + b);
    const int32_t* pay = payload + static_cast<int64_t>(b) * P;
    const uint32_t all = N == 32 ? kFull : (1u << N) - 1u;
    const bool is_random = nd == kNodeRandom;

    // the payload's node set, 31 nodes a word (PARTITION's group A, and a
    // NODE_RANDOM op's pool): nodes 0-30 in word 0, node 31 in word 1
    if (is_random || op == kOpPartition || op == kOpPartitionOneway) {
      in_a = static_cast<uint32_t>(__ldg(pay)) & 0x7FFFFFFFu;
      if (N > 31) in_a |= (static_cast<uint32_t>(__ldg(pay + 1)) & 1u) << 31;
      in_a &= all;
    }

    bool eff = true;
    const int64_t row0 = static_cast<int64_t>(b) * N;
    if (is_random) {
      uint32_t pool = all;
      if (op == kOpKill || op == kOpPause || op == kOpClogNode)
        pool = bits_of(alive + row0, N);
      else if (op == kOpRestart)
        pool = ~bits_of(alive + row0, N) & all;
      else if (op == kOpResume)
        pool = bits_of(paused + row0, N);
      else if (op == kOpUnclogNode)
        pool = bits_of(clog_node + row0, N);
      // the pool words: min(P, ceil(N / 31)), P >= 2
      const bool any = __ldg(pay) != 0 || (N > 31 && __ldg(pay + 1) != 0);
      if (any) pool &= in_a;
      const int cnt = __popc(pool);
      uint32_t k0, k1;
      const int32_t* kp = key + 2 * static_cast<int64_t>(b);
      threefry::split_key(static_cast<uint32_t>(__ldg(kp)),
                          static_cast<uint32_t>(__ldg(kp + 1)), 2, 0, k0, k1);
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

    if (kill || boot) alive[at] = boot ? 1 : 0;
    if (kill || boot || when(op == kOpResume)) paused[at] = 0;
    else if (when(op == kOpPause)) paused[at] = 1;
    if (when(op == kOpClogNode)) clog_node[at] = 1;
    if (when(op == kOpUnclogNode)) clog_node[at] = 0;
    if (when(op == kOpClogLink || op == kOpUnclogLink)) {
      const int src_c = clip(src, 0, N - 1);
      clog_link[row0 * N + src_c * N + target] = op == kOpClogLink ? 1 : 0;
    }

    if (when(op == kOpSetLoss))
      p.loss[b] = __fdiv_rn(static_cast<float>(__ldg(pay)), 1e6f);
    if (when(op == kOpSetLatency)) {
      const int32_t lo = __ldg(pay), hi = __ldg(pay + 1);
      p.lat_lo[b] = lo;
      p.lat_hi[b] = hi > lo ? hi : lo;
    }
    // the gray-failure values ride the payload's last word
    if (when(op == kOpSetSkew))
      p.skew[at] = clip(__ldg(pay + P - 1), -kSkewCap, kSkewCap);
    if (when(op == kOpSetDisk)) {
      p.disk_lat[at] = clip(__ldg(pay + P - 1), 0, kDiskLatCap);
      p.torn[at] = __ldg(pay + P - 2) != 0 ? 1 : 0;
    }
    if (when(op == kOpSetDup))
      p.dup_rate[at] = clip(__ldg(pay + P - 1), 0, kDupRateCap);

    p.init_node[b] = boot ? target : -1;
    p.target[b] = target;
    p.reset_mask[b] = (kill || boot) ? 1 : 0;
    p.effective[b] = eff ? 1 : 0;

    flags = (kill ? kDoKill : 0) | (boot ? kDoBoot : 0)
        | (when(op == kOpPartition) ? kDoPartition : 0)
        | (when(op == kOpPartitionOneway) ? kDoOneway : 0)
        | (when(op == kOpHeal) ? kDoHeal : 0)
        | ((src & 1) == 1 ? kReversed : 0);
    if (!(flags & (kDoKill | kDoBoot | kDoPartition | kDoOneway | kDoHeal)))
      flags = 0;
  }

  // ---- phase 2: the warp takes its heavy lanes one after another -----------
  unsigned todo = __ballot_sync(kFull, flags != 0);
  while (todo) {
    const int from = __ffs(todo) - 1;
    todo &= todo - 1;
    const int hb = __shfl_sync(kFull, b, from);
    const int ht = __shfl_sync(kFull, target, from);
    const uint32_t ha = __shfl_sync(kFull, in_a, from);
    const int hf = __shfl_sync(kFull, flags, from);

    if (hf & kDoKill) {    // drop the target's queued messages and timers
      // kKillChunks chunks of 32 rows a pass, every load issued before
      // the first compare: one round trip to memory a pass
      const int64_t t0 = static_cast<int64_t>(hb) * C;
      for (int c0 = lane; c0 < C; c0 += 32 * kKillChunks) {
        int32_t tn[kKillChunks], tk[kKillChunks];
#pragma unroll
        for (int u = 0; u < kKillChunks; ++u) {
          const int c = c0 + 32 * u;
          tn[u] = c < C ? __ldg(t_node + t0 + c) : -1;
          tk[u] = c < C ? t_kind[t0 + c] : kEvFree;
        }
#pragma unroll
        for (int u = 0; u < kKillChunks; ++u) {
          if (tn[u] == ht && (tk[u] == kEvMsg || tk[u] == kEvTimer)) {
            const int c = c0 + 32 * u;
            t_kind[t0 + c] = kEvFree;
            t_deadline[t0 + c] = kTInf;
          }
        }
      }
    }
    if (hf & kDoBoot) {    // volatile protocol state back to the default
      const int64_t at = static_cast<int64_t>(hb) * N + ht;
      int l = 0;
      for (int e = lane; e < p.reset_elems; e += 32) {
        while (l + 1 < p.n_leaves && e >= p.leaves[l + 1].start) ++l;
        const SuperLeaf& lf = p.leaves[l];
        const int32_t v = __ldg(defaults + e);
        const int64_t off = at * lf.row + (e - lf.start);
        if (lf.esize == 4)
          static_cast<int32_t*>(lf.ptr)[off] = v;
        else
          static_cast<uint8_t*>(lf.ptr)[off] = v != 0 ? 1 : 0;
      }
    }
    if (hf & (kDoPartition | kDoOneway | kDoHeal)) {
      // PARTITION: the cut A <-> not-A; PARTITION_ONEWAY: ORs in A ->
      // not-A (reversed for odd src); HEAL: clears the matrix
      uint8_t* link = clog_link + static_cast<int64_t>(hb) * N * N;
      for (int q = lane; q < N * N; q += 32) {
        const int i = q / N, j = q - i * N;
        const uint32_t ai = (ha >> i) & 1u, aj = (ha >> j) & 1u;
        if (hf & kDoPartition) {
          link[q] = ai != aj ? 1 : 0;
        } else if (hf & kDoOneway) {
          const bool cut = (hf & kReversed) ? (aj && !ai) : (ai && !aj);
          if (cut) link[q] = 1;
        } else {
          link[q] = 0;
        }
      }
      if (hf & kDoHeal)
        for (int n = lane; n < N; n += 32)
          clog_node[static_cast<int64_t>(hb) * N + n] = 0;
    }
  }
}

}  // namespace

extern "C" int apply_super_launch(const SuperParams* params, void* stream) {
  const SuperParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.C < 1 || p.N < 1 || p.N > 32 || p.P < 2 || p.n_leaves < 0
      || p.n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  // the leaves tile [0, reset_elems) in order (the prefix table)
  int32_t next = 0;
  for (int l = 0; l < p.n_leaves; ++l) {
    const SuperLeaf& lf = p.leaves[l];
    if ((lf.esize != 4 && lf.esize != 1) || lf.row < 0 || lf.start != next)
      return static_cast<int>(cudaErrorInvalidValue);
    next += lf.row;
  }
  if (next != p.reset_elems) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.B + kThreads - 1) / kThreads));
  apply_super_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
