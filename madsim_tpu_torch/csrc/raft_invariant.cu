// raft_invariant: the Raft safety check of every lane, after every event.
//
// Replaces the JAX package's `raft_invariant` (madsim_tpu/models/raft.py
// :586, inner `invariant` :619) with its `entry_hash` (:64) and
// `_pow_table` (:49). The plain version, held equal to this kernel, is
// madsim_tpu_torch/ops/raft_invariant.py `raft_invariant_plain`:
//
//   Election Safety       two peers lead in one term         -> 101
//   State Machine Safety  committed prefixes disagree         -> 102
//   commit <= log length  (the effective commit, floored by
//                          the snapshot)                      -> 103
//
// in that priority; `code` is 103 where nothing is bad. Each node's
// digest chain is chain(t) = P^t * (snap_digest + S[t]) with S[t] =
// sum_{k<t} h[k] * P^-(k+1) and h[k] the entry hash of log slot k (the
// term folded with each field column by h = h * MIX + c). With
// window_slides every pair of peers (i, j) compares chain_i and chain_j at
// a = min(ec_i, ec_j) where both windows hold a; without, each peer
// compares its chain at its predecessor's commit (commit order, ties by
// node index, non-peers last) with the predecessor's chain at its own
// commit. Every sum and product, `a - snap_len` included, is uint32
// arithmetic: it wraps at 32 bits as the plain version's int32 does.
//
// Bound: bytes. The check reads every lane's six [N] node vectors and its
// (1 + F) [N, L] log columns once and writes two words (1,405 bytes a
// lane for the flagship's N=5, L=32, F=1: 0.042 ms at B=100,000). What
// holds a warp-a-lane design at over twice that bound on this card is
// its instructions, not its loads: the warp walks a lane's N nodes one
// after another, each a round of 32-slot loads, a five-shuffle prefix sum
// and chain shuffles, ~450 warp instructions a lane, with N of its 32
// threads at work outside the rounds. Staging a group of lanes through a
// two-stage ring of bulk copies (cp.async.bulk into shared memory on an
// mbarrier) keeps those instructions and ran slower still (PERF.md).
//
// Design: a thread per (lane, node). A warp takes floor(32 / N) lanes
// (6 for N=5; thread t is node t % N of lane t / N). Each thread reads
// its node's six vector words (the warp's reads are one contiguous run)
// and its own log rows: L words of each column, contiguous, 16 bytes an
// access, every access of the row issued before the first is used. It
// folds the entry hashes and runs the prefix sum S over its L slots in
// order, in registers, writing S into a row of shared memory (stride
// L + 1 made odd, so the warp's writes hit 32 banks). The lane-wide
// parts (two leaders, the commit order and predecessor, the verdict) are
// shuffles and ballots inside the lane's N threads. A chain value is
// then one shared-memory read: the adjacent form reads its own row at
// its two points; the pairwise form, for each peer j, its own row and
// j's at their common point, so one thread settles a pair. About 70
// warp instructions a lane for the flagship.
//
// Where a log column is not 16-byte aligned or L is no multiple of 4, the
// rows are read 4 bytes an access (`vec4` 0), in the same kernel.
//
// Log lengths past 32 (up to kMaxTiledL = 192: raft_kv's default 64, the
// reference's tests at 48 and 96, shard_kv's 192) take a second
// instantiation, `kTiled`: the thread walks its row in 32-slot tiles, each
// tile's columns loaded into registers (16 bytes an access where `vec4`
// holds; a tile starts at a multiple of 32 slots, so its rows stay 16-byte
// aligned) and folded, the running prefix sum carried from tile to tile
// and S written tile by tile. The shared rows grow with L (stride
// (L + 1) | 1 words a thread), so the launcher gives a block as many warps
// (4, 3, 2 or 1) as fit in 48 KB: 4 at L=64, 3 at L=96, 1 at L=192. The
// chain reads are those of the L <= 32 form. L <= 32 keeps its own
// instantiation, unchanged.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxFields = 8;
constexpr int kVectors = 6;

// The launch parameters, field for field the ctypes structure of the
// wrapper; outside the unnamed namespace so that the C entry point keeps
// external linkage.
struct RaftInvParams {
  const int32_t* vecs[kVectors];   // role, term, snap_len, log_len,
                                   // commit, snap_digest: [B, N]
  const int32_t* cols[1 + kMaxFields];   // log_term, then F field
                                         // columns: [B, N, L]
  const uint8_t* peer;          // [N] bool
  const int32_t* powP;          // [L + 1]
  const int32_t* ipowP;         // [L + 1]
  uint8_t* bad;                 // [B] bool
  int32_t* code;                // [B]
  int B, N, L, F, window_slides;
  int vec4;                     // rows read 16 bytes an access
  int warps;                    // warps a block (the wrapper's choice,
                                // checked by the launcher)
};

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;                  // warps a block (L <= 32)
constexpr int kMaxL = 32;                  // slots a tile (and L <= 32)
constexpr int kMaxTiledL = 192;
constexpr int kSmemLimit = 48 * 1024;      // bytes a block, no opt-in
constexpr int kLeader = 2;
constexpr uint32_t kMix = 920419823u;
constexpr int32_t kTwoLeaders = 101;
constexpr int32_t kLogMismatch = 102;
constexpr int32_t kCommitGtLog = 103;
constexpr int32_t kIntMax = 0x7FFFFFFF;

__host__ __device__ constexpr int row_stride(int L) { return (L + 1) | 1; }

__host__ __device__ constexpr int smem_words(int L, int warps) {
  return 2 * (L + 1) + warps * 32 * row_stride(L);
}

// The warps a block of the tiled instantiation takes: the most (up to
// kWarps) whose shared rows fit in kSmemLimit.
__host__ constexpr int tiled_warps(int L) {
  int w = kWarps;
  while (w > 1 && smem_words(L, w) * 4 > kSmemLimit) --w;
  return w;
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int clamp_t(int32_t t, int L) {
  return t < 0 ? 0 : (t > L ? L : t);
}

__device__ __forceinline__ bool in_window(int32_t t, int L) {
  return t >= 0 && t <= L;
}

// A node's L log slots of one column (row at element `row0`) into
// v[0..L), every load issued before any is used: 16 bytes an access with
// vec4, else 4.
__device__ __forceinline__ void load_row(const int32_t* col, int64_t row0,
                                         int L, bool vec4,
                                         uint32_t (&v)[kMaxL]) {
  if (vec4) {
    const int4* r = reinterpret_cast<const int4*>(col + row0);
#pragma unroll
    for (int c = 0; c < kMaxL / 4; ++c) {
      const int4 x = 4 * c < L ? __ldg(r + c) : make_int4(0, 0, 0, 0);
      v[4 * c] = static_cast<uint32_t>(x.x);
      v[4 * c + 1] = static_cast<uint32_t>(x.y);
      v[4 * c + 2] = static_cast<uint32_t>(x.z);
      v[4 * c + 3] = static_cast<uint32_t>(x.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxL; ++k)
      v[k] = k < L ? static_cast<uint32_t>(__ldg(col + row0 + k)) : 0u;
  }
}

// A node's prefix row S[k], k = 0..L, into `S` (S[0] = 0): its entry
// hashes folded over the columns, times P^-(k+1), summed in order.
__device__ __forceinline__ void prefix_row(const RaftInvParams& p,
                                           int64_t row0, const uint32_t* ipw,
                                           uint32_t* S) {
  const int L = p.L;
  uint32_t h[kMaxL];
  load_row(p.cols[0], row0, L, p.vec4, h);
  for (int f = 1; f <= p.F; ++f) {
    uint32_t y[kMaxL];
    load_row(p.cols[f], row0, L, p.vec4, y);
#pragma unroll
    for (int k = 0; k < kMaxL; ++k) h[k] = h[k] * kMix + y[k];
  }
  uint32_t s = 0;
  S[0] = 0;
#pragma unroll
  for (int k = 0; k < kMaxL; ++k) {
    if (k < L) {
      s += h[k] * ipw[k + 1];
      S[k + 1] = s;
    }
  }
}

// The same row for L > 32, in 32-slot tiles: each tile's slots of every
// column into registers, folded, and the prefix sum carried across tiles.
__device__ __forceinline__ void prefix_row_tiled(const RaftInvParams& p,
                                                 int64_t row0,
                                                 const uint32_t* ipw,
                                                 uint32_t* S) {
  const int L = p.L;
  uint32_t s = 0;
  S[0] = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < L; k0 += kMaxL) {
    const int n = L - k0 < kMaxL ? L - k0 : kMaxL;
    uint32_t h[kMaxL];
    load_row(p.cols[0], row0 + k0, n, p.vec4, h);
    for (int f = 1; f <= p.F; ++f) {
      uint32_t y[kMaxL];
      load_row(p.cols[f], row0 + k0, n, p.vec4, y);
#pragma unroll
      for (int k = 0; k < kMaxL; ++k) h[k] = h[k] * kMix + y[k];
    }
#pragma unroll
    for (int k = 0; k < kMaxL; ++k) {
      if (k < n) {
        s += h[k] * ipw[k0 + k + 1];
        S[k0 + k + 1] = s;
      }
    }
  }
}

template <bool kTiled>
__global__ void __launch_bounds__(kWarps * 32)
raft_invariant_kernel(const __grid_constant__ RaftInvParams p) {
  extern __shared__ uint32_t sm[];
  const int N = p.N, L = p.L, stride = row_stride(L);
  const int warps = kTiled ? static_cast<int>(blockDim.x >> 5) : kWarps;
  uint32_t* pw = sm;
  uint32_t* ipw = sm + (L + 1);
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    pw[i] = static_cast<uint32_t>(p.powP[i]);
    ipw[i] = static_cast<uint32_t>(p.ipowP[i]);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  uint32_t* rows = sm + 2 * (L + 1) + warp * 32 * stride;
  const int G = 32 / N;                    // lanes a warp
  const int g = t / N;                     // this thread's lane in the warp
  const int n = t - g * N;                 // and its node
  const int base = g * N;                  // the lane's first thread
  const int64_t b = (static_cast<int64_t>(blockIdx.x) * warps + warp) * G
      + g;
  const bool mine = g < G && b < p.B;      // thread holds node n of lane b
  // the lane's threads in a ballot
  const unsigned grp = g < G ? (N == 32 ? kFull : ((1u << N) - 1u) << base)
                             : 0u;

  int32_t role = 0, term = 0, sl = 0, ll = 0, cm = 0;
  uint32_t dig = 0;
  bool peer = false;
  if (mine) {
    const int64_t i = b * N + n;
    role = p.vecs[0][i];
    term = p.vecs[1][i];
    sl = p.vecs[2][i];
    ll = p.vecs[3][i];
    cm = p.vecs[4][i];
    dig = static_cast<uint32_t>(p.vecs[5][i]);
    peer = p.peer[n] != 0;
    if (kTiled)
      prefix_row_tiled(p, i * L, ipw, rows + t * stride);
    else
      prefix_row(p, i * L, ipw, rows + t * stride);
  }
  // the reference's masked views: non-peers count as empty, uncommitted
  const int32_t slm = peer ? sl : 0;
  const int32_t loglen = peer ? ll : 0;
  const int32_t cmm = peer ? cm : 0;
  const int32_t ec = cmm > slm ? cmm : slm;       // effective commit

  // Election Safety
  const bool leader = mine && peer && role == kLeader;
  bool two = false;
  for (int j = 0; j < N; ++j) {
    const int32_t term_j = __shfl_sync(kFull, term, base + j);
    const bool leader_j = __shfl_sync(kFull, static_cast<int>(leader),
                                      base + j);
    two |= leader && leader_j && j != n && term == term_j;
  }
  const bool two_leaders = (__ballot_sync(kFull, two) & grp) != 0;
  const bool commit_gt = (__ballot_sync(kFull, mine && ec > loglen) & grp)
      != 0;
  const unsigned peers = __ballot_sync(kFull, mine && peer) & grp;
  const unsigned peer_mask = g < G ? peers >> base : 0u;   // bit j: node j

  bool mm = false;
  __syncwarp();                            // every node row is written
  auto chain = [&](int row, uint32_t d, int32_t at) -> uint32_t {
    return pw[at] * (d + rows[row * stride + at]);
  };
  if (p.window_slides) {
    // thread n settles each pair (n, j), j > n, from both rows
    for (int j = 0; j < N; ++j) {
      const int32_t ec_j = __shfl_sync(kFull, ec, base + j);
      const int32_t sl_j = __shfl_sync(kFull, slm, base + j);
      const uint32_t dig_j = __shfl_sync(kFull, dig, base + j);
      if (mine && j > n && peer && ((peer_mask >> j) & 1u)) {
        const int32_t a = ec_j < ec ? ec_j : ec;
        const int32_t ti = sub32(a, slm), tj = sub32(a, sl_j);
        if (in_window(ti, L) && in_window(tj, L)
            && chain(t, dig, ti) != chain(base + j, dig_j, tj))
          mm = true;
      }
    }
  } else {
    // rank in the stable commit order (non-peers last) and the
    // predecessor (the rank-0 node's own index stands in for it, as the
    // reference's clipped gather does; it is never linked)
    const int32_t key = peer ? ec : kIntMax;
    int rank = 0;
    for (int j = 0; j < N; ++j) {
      const int32_t key_j = __shfl_sync(kFull, key, base + j);
      rank += (key_j < key || (key_j == key && j < n)) ? 1 : 0;
    }
    int prev = n;
    for (int j = 0; j < N; ++j) {
      const int rank_j = __shfl_sync(kFull, rank, base + j);
      if (rank > 0 && rank_j == rank - 1) prev = j;
    }
    if (!mine) prev = 0;
    const int32_t prev_ec = __shfl_sync(kFull, ec, base + prev);
    const int32_t tY = sub32(prev_ec, slm);
    const int32_t tX = sub32(ec, slm);
    const uint32_t X = in_window(tX, L) ? chain(t, dig, tX) : 0u;
    const uint32_t Y = chain(t, dig, clamp_t(tY, L));
    const uint32_t x_prev = __shfl_sync(kFull, X, base + prev);
    const bool link = mine && peer && ((peer_mask >> prev) & 1u)
        && rank > 0 && in_window(tY, L);
    mm = link && Y != x_prev;
  }
  const bool mismatch = (__ballot_sync(kFull, mm) & grp) != 0;
  if (mine && n == 0) {
    p.bad[b] = (two_leaders || mismatch || commit_gt) ? 1 : 0;
    p.code[b] = two_leaders ? kTwoLeaders
        : (mismatch ? kLogMismatch : kCommitGtLog);
  }
}

}  // namespace

extern "C" int raft_invariant_launch(const RaftInvParams* params,
                                     void* stream) {
  const RaftInvParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.N < 1 || p.N > 32 || p.L < 1 || p.L > kMaxTiledL || p.F < 0
      || p.F > kMaxFields)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.vec4) {
    if (p.L % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int c = 0; c <= p.F; ++c)
      if (reinterpret_cast<uintptr_t>(p.cols[c]) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tiled = p.L > kMaxL;
  const int warps = tiled ? tiled_warps(p.L) : kWarps;
  if (p.warps != warps) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lanes = static_cast<int64_t>(warps) * (32 / p.N);
  const dim3 grid(static_cast<unsigned>((p.B + lanes - 1) / lanes));
  const size_t smem = static_cast<size_t>(smem_words(p.L, warps)) * 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiled)
    raft_invariant_kernel<true><<<grid, warps * 32, smem, st>>>(p);
  else
    raft_invariant_kernel<false><<<grid, kWarps * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
