// plane_digest: the batch reductions of the plane digests (K10), three
// entry points.
//
// plane_sums replaces the lane reductions of the JAX package's digests
// (madsim_tpu/parallel/stats.py `_masked_half_sums`, line 169, as
// `_profile_digest` (line 201), `_latency_digest` (line 391),
// `_series_digest` (line 509) and `_attribution_digest` (line 665) call
// it on every counter leaf, and their max and OR folds). For each leaf x,
// viewed as [B, M] int32 with its lane mask on [B], by the leaf's op:
//
//   sum: out[0, c] = sum over lanes with on of (x[b, c] >> 16)
//        out[1, c] = sum over lanes with on of (x[b, c] & 0xFFFF)
//        both wrapping at 32 bits as the JAX int32 sum does; a leaf with
//        no data pointer counts 1 a lane (its lo row is the lane count)
//   max: out[c] = 2^31 + max over every lane of (on ? x[b, c] : 0), as
//        an unsigned max (the wrapper subtracts the bias)
//   or:  out[c] = OR over lanes with on of x[b, c]
//
// Integer adds, max and OR commute, so the order the blocks combine in
// does not matter: the kernel must equal its plain PyTorch version
// (madsim_tpu_torch/ops/plane_digest.py `plane_sums_plain`) exactly.
//
// Bound: bytes. Every leaf is read once with its mask (about 1.2 KB a
// lane for both planes of the flagship's plane config: 5 nodes, 24
// buckets; about 3.2 KB for the series digest at 16 windows), 120 MB at
// B = 100,000, 0.036 ms at 3.35 TB/s; the output is a few KB. Design: a block takes one leaf and a run of lanes. Its
// threads split into G = 256 / min(M, 256) groups of min(M, 256)
// consecutive columns, so a warp reads consecutive words of one or two
// lane rows (or, for a one-column leaf, 32 consecutive lanes); each
// thread sums its column over every G-th lane of the run in registers,
// the groups' partials meet in shared memory, and one atomicAdd a
// column a block adds them into the output.
//
// lane_p99 replaces `_lane_e2e_p99` (stats.py:465), the fuzzer's per-lane
// tail signal: for each lane, the [N, LB] e2e histogram folded over its
// nodes in float32 (node 0 first, as the plain version adds), its float32
// cumulative sum over the buckets, and the lower edge (0, or 2^(j-1)) of
// the first bucket j whose cumulative count reaches max(ceil(total *
// 0.99f), 1); 0 for a lane with no completion (`_hist_quantiles`). Every
// float operation is one IEEE round-to-nearest add or multiply in that
// order (no contraction), so it too equals its plain version exactly.
// Bound: bytes, N * LB * 4 bytes a lane read once (48 MB at the
// flagship's B = 100,000), 0.014 ms. Design: a block copies the rows of
// its lanes (at most 64) into shared memory, consecutive threads on
// consecutive 16-byte words where the rows allow (each row a multiple of
// 16 bytes from a 16-byte aligned start; else 4-byte words), with each
// lane's row one word longer there than in device memory, so the lanes'
// threads then fold their rows from shared memory without bank
// conflicts.
//
// lane_burst replaces `_lane_burst_lat` (stats.py:609), the fuzzer's
// per-lane burst signal: for each lane and each of its W windows, the
// window's [LB] e2e histogram's float32 cumulative sum (bucket 0 first)
// and the lower edge of the first bucket reaching max(ceil(total *
// 0.99f), 1) (0 for an empty window), then the max over the windows.
// The float operations are lane_p99's (one device function, `p99_edge`,
// with one node), so it equals its plain version exactly. Bound: bytes,
// W * LB * 4 bytes a lane read once (154 MB at the flagship's 16 windows
// of 24 buckets, B = 100,000), 0.046 ms. Design: a block stages its
// lanes' windows (at most 64 lanes) as lane_p99 stages its rows
// (`stage_rows`, a window a row), then a thread takes a (lane, window)
// pair, writes its edge beside the rows, and a thread a lane takes the
// max of its lane's edges.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;
constexpr int kLoadsPerThread = 128;   // lanes a thread sums a column pass
constexpr int kP99Threads = 128;
constexpr int kP99Lanes = 64;          // lanes a lane_p99 or lane_burst
                                       // block at most
constexpr int kSmem = 48 * 1024;
constexpr int kOpSum = 0, kOpMax = 1, kOpOr = 2;

}  // namespace

// One leaf of a plane_sums launch: x [B, M] (nullptr: the constant 1), its
// lane mask (index into masks), its output offset (a sum's hi row at out,
// its lo row at out + M; a max's or an or's one row at out), its first
// block and its op (0 sum, 1 max, 2 or).
struct SumLeaf {
  const int32_t* x;
  int32_t M;
  int32_t mask;
  int32_t out;
  int32_t first_block;
  int32_t op;
};

struct SumsParams {
  SumLeaf leaves[kMaxLeaves];
  const uint8_t* masks[2];
  uint32_t* out;              // zeroed by the wrapper
  int64_t B;
  int32_t n_leaves;
  int32_t blocks;
};

struct P99Params {
  const int32_t* hist;        // [B, N, LB] int32, contiguous
  int32_t* out;               // [B]
  int64_t B;
  int32_t N, LB, lanes_per_block;
  float q;
};

struct BurstParams {
  const int32_t* hist;        // [B, W, LB] int32, contiguous
  int32_t* out;               // [B]
  int64_t B;
  int32_t W, LB, lanes_per_block;
  float q;
};

namespace {

// A leaf's column layout: `cols` columns a pass, `groups` lane groups.
__device__ __forceinline__ void layout(int M, int& cols, int& groups) {
  cols = M < kThreads ? M : kThreads;
  groups = kThreads / cols;
}

__global__ void __launch_bounds__(kThreads)
plane_sums_kernel(const SumsParams p) {
  __shared__ uint32_t s_hi[kThreads];
  __shared__ uint32_t s_lo[kThreads];
  int l = 0;
  while (l + 1 < p.n_leaves && p.leaves[l + 1].first_block <= blockIdx.x)
    ++l;
  const SumLeaf lf = p.leaves[l];
  const int M = lf.M;
  int cols, groups;
  layout(M, cols, groups);
  const int64_t run = static_cast<int64_t>(groups) * kLoadsPerThread;
  const int64_t l0 = (blockIdx.x - lf.first_block) * run;
  const int64_t l1 = l0 + run < p.B ? l0 + run : p.B;
  const uint8_t* on = p.masks[lf.mask];
  const int t = threadIdx.x;
  const int g = t / cols;
  const int c0 = t - g * cols;
  if (lf.op != kOpSum) {                      // block-uniform
    // max (biased: the unsigned max of v + 2^31) or OR, one word a column
    const bool is_max = lf.op == kOpMax;
    for (int cb = 0; cb < M; cb += cols) {
      const int c = cb + c0;
      uint32_t acc = 0;
      if (g < groups && c < M) {
        for (int64_t b = l0 + g; b < l1; b += groups) {
          const bool lane_on = on[b] != 0;
          if (is_max) {
            const int32_t v = lane_on ? lf.x[b * M + c] : 0;
            const uint32_t u = static_cast<uint32_t>(v) ^ 0x80000000u;
            acc = u > acc ? u : acc;
          } else if (lane_on) {
            acc |= static_cast<uint32_t>(lf.x[b * M + c]);
          }
        }
      }
      s_hi[t] = acc;
      __syncthreads();
      if (t < cols && cb + t < M) {
        uint32_t a = 0;
        for (int k = 0; k < groups; ++k) {
          const uint32_t v = s_hi[k * cols + t];
          a = is_max ? (v > a ? v : a) : (a | v);
        }
        if (is_max) atomicMax(p.out + lf.out + cb + t, a);
        else atomicOr(p.out + lf.out + cb + t, a);
      }
      __syncthreads();
    }
    return;
  }
  for (int cb = 0; cb < M; cb += cols) {      // block-uniform
    const int c = cb + c0;
    uint32_t hi = 0, lo = 0;
    if (g < groups && c < M) {
      for (int64_t b = l0 + g; b < l1; b += groups) {
        if (on[b] == 0) continue;
        const int32_t v = lf.x != nullptr ? lf.x[b * M + c] : 1;
        hi += static_cast<uint32_t>(v >> 16);
        lo += static_cast<uint32_t>(v & 0xFFFF);
      }
    }
    s_hi[t] = hi;
    s_lo[t] = lo;
    __syncthreads();
    if (t < cols && cb + t < M) {
      uint32_t sh = 0, sl = 0;
      for (int k = 0; k < groups; ++k) {
        sh += s_hi[k * cols + t];
        sl += s_lo[k * cols + t];
      }
      atomicAdd(p.out + lf.out + cb + t, sh);
      atomicAdd(p.out + lf.out + M + cb + t, sl);
    }
    __syncthreads();
  }
}

// Copies `nrows` rows of `row` words from `src` into shared memory at
// `dst`, each row one word longer there (a row's threads then read their
// rows without bank conflicts): consecutive threads on consecutive
// 16-byte words where every row is whole 16-byte words from a 16-byte
// aligned start (such a word never straddles two rows), else 4-byte
// words.
template <int kT>
__device__ void stage_rows(int32_t* dst, const int32_t* src, int nrows,
                           int row) {
  const int pitch = row + 1;
  const int words = nrows * row;
  if (row % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < words / 4; i += kT) {
      const int4 v = src4[i];
      const int w = 4 * i;
      const int r = w / row;
      int32_t* d = dst + r * pitch + (w - r * row);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < words; i += kT) {
      const int r = i / row;
      dst[r * pitch + (i - r * row)] = src[i];
    }
  }
}

// The p99 lower edge of one histogram: its LB buckets, each the float32
// sum of N rows LB words apart (row 0 first), summed in bucket order into
// the float32 cumulative count; the lower edge (0, or 2^(j-1)) of the
// first bucket j whose count reaches max(ceil(total * q), 1), 0 for an
// empty histogram.
__device__ int32_t p99_edge(const int32_t* h, int N, int LB, float q) {
  // pass 1: the total (the last cumulative count)
  float cdf = 0.0f;
  for (int k = 0; k < LB; ++k) {
    float v = __int2float_rn(h[k]);
    for (int n = 1; n < N; ++n)
      v = __fadd_rn(v, __int2float_rn(h[n * LB + k]));
    cdf = __fadd_rn(cdf, v);
  }
  const float total = cdf;
  float need = ceilf(__fmul_rn(total, q));
  need = need > 1.0f ? need : 1.0f;
  // pass 2: the first bucket whose cumulative count reaches `need`
  int j = 0;
  cdf = 0.0f;
  for (int k = 0; k < LB; ++k) {
    float v = __int2float_rn(h[k]);
    for (int n = 1; n < N; ++n)
      v = __fadd_rn(v, __int2float_rn(h[n * LB + k]));
    cdf = __fadd_rn(cdf, v);
    if (cdf >= need) {
      j = k;
      break;
    }
  }
  return total > 0.0f ? (j == 0 ? 0 : (1 << (j - 1))) : 0;
}

__global__ void __launch_bounds__(kP99Threads)
lane_p99_kernel(const P99Params p) {
  extern __shared__ int32_t rows[];     // lane l's row at l * (row + 1)
  const int row = p.N * p.LB;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * p.lanes_per_block;
  const int nb = static_cast<int>(p.B - b0 < p.lanes_per_block
                                  ? p.B - b0 : p.lanes_per_block);
  stage_rows<kP99Threads>(rows, p.hist + b0 * row, nb, row);
  __syncthreads();
  if (threadIdx.x >= nb) return;
  p.out[b0 + threadIdx.x] =
      p99_edge(rows + threadIdx.x * (row + 1), p.N, p.LB, p.q);
}

__global__ void __launch_bounds__(kThreads)
lane_burst_kernel(const BurstParams p) {
  // lane l's window w at rows + (l * W + w) * (LB + 1); the edges after
  // the rows, one word a (lane, window)
  extern __shared__ int32_t rows[];
  const int W = p.W, LB = p.LB;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * p.lanes_per_block;
  const int nb = static_cast<int>(p.B - b0 < p.lanes_per_block
                                  ? p.B - b0 : p.lanes_per_block);
  int32_t* edges = rows + p.lanes_per_block * W * (LB + 1);
  stage_rows<kThreads>(rows, p.hist + b0 * W * LB, nb * W, LB);
  __syncthreads();
  for (int r = threadIdx.x; r < nb * W; r += kThreads)
    edges[r] = p99_edge(rows + r * (LB + 1), 1, LB, p.q);
  __syncthreads();
  for (int l = threadIdx.x; l < nb; l += kThreads) {
    int32_t m = edges[l * W];
    for (int w = 1; w < W; ++w) m = edges[l * W + w] > m ? edges[l * W + w] : m;
    p.out[b0 + l] = m;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int plane_sums_launch(const SumsParams* params, void* stream) {
  const SumsParams& p = *params;
  if (p.B <= 0 || p.n_leaves == 0) return 0;
  if (p.n_leaves < 0 || p.n_leaves > kMaxLeaves || p.blocks < 1
      || p.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < p.n_leaves; ++l)
    if (p.leaves[l].M < 1 || p.leaves[l].mask < 0 || p.leaves[l].mask > 1
        || p.masks[p.leaves[l].mask] == nullptr || p.leaves[l].op < kOpSum
        || p.leaves[l].op > kOpOr
        || (p.leaves[l].op != kOpSum && p.leaves[l].x == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  plane_sums_kernel<<<p.blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lane_p99_launch(const P99Params* params, void* stream) {
  const P99Params& p = *params;
  if (p.B <= 0) return 0;
  if (p.N < 1 || p.LB < 1 || p.lanes_per_block < 1
      || p.lanes_per_block > kP99Lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p.lanes_per_block)
      * (p.N * p.LB + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(
      (p.B + p.lanes_per_block - 1) / p.lanes_per_block);
  lane_p99_kernel<<<grid, kP99Threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lane_burst_launch(const BurstParams* params, void* stream) {
  const BurstParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.W < 1 || p.LB < 1 || p.lanes_per_block < 1
      || p.lanes_per_block > kP99Lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p.lanes_per_block) * p.W
      * (p.LB + 2) * sizeof(int32_t);
  if (smem > kSmem) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(
      (p.B + p.lanes_per_block - 1) / p.lanes_per_block);
  lane_burst_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
