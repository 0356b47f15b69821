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
// (1 + F) [N, L] log columns once and writes two words. Design: a warp
// takes a lane; thread n holds node n's vectors, and for each node the
// warp loads log slot k into thread k (the columns are contiguous, so a
// node's slots are one coalesced 4L-byte read), folds the entry hash,
// multiplies by P^-(k+1) and runs the wrapping prefix sum as five
// shuffles. A chain value chain(t) is then one shuffle of S[t] away, so
// the [N, N, L+1] one-hot of the reference becomes N (pairwise form: N*N
// in all, kept in shared memory for the pair compare) or two (adjacent
// form) shuffles a node. No prefix table leaves registers.

#include <cstdint>

constexpr int kMaxFields = 8;

// The launch parameters, field for field the ctypes structure of the
// wrapper; outside the unnamed namespace so that the C entry point keeps
// external linkage.
struct RaftInvParams {
  const int32_t* role;          // [B, N]
  const int32_t* term;
  const int32_t* snap_len;
  const int32_t* log_len;
  const int32_t* commit;
  const int32_t* snap_digest;
  const int32_t* log_term;      // [B, N, L]
  const int32_t* fields[kMaxFields];   // F columns [B, N, L]
  const uint8_t* peer;          // [N] bool
  const int32_t* powP;          // [L + 1]
  const int32_t* ipowP;         // [L + 1]
  uint8_t* bad;                 // [B] bool
  int32_t* code;                // [B]
  int B, N, L, F, window_slides;
};

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;                  // lanes (warps) a block
constexpr int kLeader = 2;
constexpr uint32_t kMix = 920419823u;
constexpr int32_t kTwoLeaders = 101;
constexpr int32_t kLogMismatch = 102;
constexpr int32_t kCommitGtLog = 103;
constexpr int32_t kIntMax = 0x7FFFFFFF;

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int clamp_t(int32_t t, int L) {
  return t < 0 ? 0 : (t > L ? L : t);
}

__global__ void __launch_bounds__(kWarps * 32)
raft_invariant_kernel(const RaftInvParams p) {
  extern __shared__ uint32_t sm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= p.B) return;                    // the whole warp leaves
  const int N = p.N, L = p.L;
  const bool mine = lane < N;              // this thread holds node `lane`

  int32_t role = 0, term = 0, sl = 0, ll = 0, cm = 0;
  uint32_t dig = 0;
  bool peer = false;
  if (mine) {
    const int64_t i = b * N + lane;
    role = p.role[i];
    term = p.term[i];
    sl = p.snap_len[i];
    ll = p.log_len[i];
    cm = p.commit[i];
    dig = static_cast<uint32_t>(p.snap_digest[i]);
    peer = p.peer[lane] != 0;
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
    const int32_t term_j = __shfl_sync(kFull, term, j);
    const bool leader_j = __shfl_sync(kFull, static_cast<int>(leader), j);
    two |= leader && leader_j && j != lane && term == term_j;
  }
  const bool two_leaders = __any_sync(kFull, two);
  const bool commit_gt = __any_sync(kFull, mine && ec > loglen);
  const unsigned peer_mask = __ballot_sync(kFull, mine && peer);

  // adjacent form: rank in the stable commit order (non-peers last) and
  // the predecessor (the rank-0 node's own index stands in for it, as
  // the reference's clipped gather does; it is never linked)
  const int32_t key = peer ? ec : kIntMax;
  int rank = 0;
  for (int j = 0; j < N; ++j) {
    const int32_t key_j = __shfl_sync(kFull, key, j);
    rank += (key_j < key || (key_j == key && j < lane)) ? 1 : 0;
  }
  int prev = lane;
  for (int j = 0; j < N; ++j) {
    const int rank_j = __shfl_sync(kFull, rank, j);
    if (rank > 0 && rank_j == rank - 1) prev = j;
  }
  if (!mine) prev = 0;
  const int32_t prev_ec = __shfl_sync(kFull, ec, prev);
  const int32_t tY = sub32(prev_ec, slm);
  const int32_t tX = sub32(ec, slm);

  uint32_t* ci = sm + warp * (N * N + N);  // pairwise form: chain_i(a_ij)
  uint32_t* okrow = ci + N * N;            // bit j of row i: t_ij in window
  uint32_t X = 0, Y = 0;

  for (int n = 0; n < N; ++n) {
    // node n's entry hashes, times P^-(k+1), prefix-summed over the warp
    uint32_t w = 0;
    if (lane < L) {
      const int64_t at = (b * N + n) * L + lane;
      uint32_t h = static_cast<uint32_t>(p.log_term[at]);
      for (int f = 0; f < p.F; ++f)
        h = h * kMix + static_cast<uint32_t>(p.fields[f][at]);
      w = h * static_cast<uint32_t>(__ldg(p.ipowP + lane + 1));
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += v;
    }
    // thread k now holds S[k + 1]; chain(t) needs S[t]
    const uint32_t dig_n = __shfl_sync(kFull, dig, n);
    auto chain = [&](int t) -> uint32_t {
      const uint32_t s = __shfl_sync(kFull, w, (t + 31) & 31);
      return static_cast<uint32_t>(__ldg(p.powP + t))
          * (dig_n + (t == 0 ? 0u : s));
    };
    if (p.window_slides) {
      const int32_t ec_n = __shfl_sync(kFull, ec, n);
      const int32_t sl_n = __shfl_sync(kFull, slm, n);
      const int32_t a = ec_n < ec ? ec_n : ec;     // thread j: a_nj
      const int32_t t = sub32(a, sl_n);
      const bool ok = t >= 0 && t <= L;
      const uint32_t c = chain(clamp_t(t, L));
      const unsigned okm = __ballot_sync(kFull, mine && ok);
      if (mine) ci[n * N + lane] = c;
      if (lane == 0) okrow[n] = okm;
    } else {
      const int32_t tX_n = __shfl_sync(kFull, tX, n);
      const int32_t tY_n = __shfl_sync(kFull, tY, n);
      const uint32_t cx = chain(clamp_t(tX_n, L));
      const uint32_t cy = chain(clamp_t(tY_n, L));
      if (lane == n) {
        X = (tX_n >= 0 && tX_n <= L) ? cx : 0u;   // exact point, else 0
        Y = cy;
      }
    }
  }

  bool mm = false;
  if (p.window_slides) {
    __syncwarp();
    for (int q = lane; q < N * N; q += 32) {
      const int i = q / N, j = q - (q / N) * N;
      if (i < j && ((peer_mask >> i) & 1u) && ((peer_mask >> j) & 1u)
          && ((okrow[i] >> j) & 1u) && ((okrow[j] >> i) & 1u)
          && ci[i * N + j] != ci[j * N + i])
        mm = true;
    }
  } else {
    const uint32_t x_prev = __shfl_sync(kFull, X, prev);
    const bool okY = tY >= 0 && tY <= L;
    const bool link = mine && peer && ((peer_mask >> prev) & 1u)
        && rank > 0 && okY;
    mm = link && Y != x_prev;
  }
  const bool mismatch = __any_sync(kFull, mm);
  if (lane == 0) {
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
  if (p.N < 1 || p.N > 32 || p.L < 1 || p.L > 32 || p.F < 0
      || p.F > kMaxFields)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = p.window_slides
      ? sizeof(uint32_t) * kWarps * (p.N * p.N + p.N) : 0;
  const dim3 grid(static_cast<unsigned>((p.B + kWarps - 1) / kWarps));
  raft_invariant_kernel<<<grid, kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
