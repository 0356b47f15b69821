// plane_digest: the batch reductions of the profiler and latency digests
// (K10), two entry points.
//
// plane_sums replaces the masked hi/lo lane sums of the JAX package's
// digests (madsim_tpu/parallel/stats.py `_masked_half_sums`, line 169, as
// `_profile_digest` (line 201) and `_latency_digest` (line 391) call it
// on every counter leaf). For each leaf x, viewed as [B, M] int32 with
// its lane mask on [B]:
//
//   out[0, c] = sum over lanes with on of (x[b, c] >> 16)   (arithmetic)
//   out[1, c] = sum over lanes with on of (x[b, c] & 0xFFFF)
//
// both wrapping at 32 bits as the JAX int32 sum does; a leaf with no
// data pointer counts 1 a lane (its lo row is the mask's lane count).
// Integer adds commute, so the order the blocks add in does not matter:
// the kernel must equal its plain PyTorch version
// (madsim_tpu_torch/ops/plane_digest.py `plane_sums_plain`) exactly.
//
// Bound: bytes. Every leaf is read once with its mask (about 1.2 KB a
// lane for both planes of the flagship's plane config: 5 nodes, 24
// buckets), 120 MB at B = 100,000, 0.036 ms at 3.35 TB/s; the output is
// a few KB. Design: a block takes one leaf and a run of lanes. Its
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;
constexpr int kLoadsPerThread = 128;   // lanes a thread sums a column pass
constexpr int kP99Threads = 128;
constexpr int kP99Lanes = 64;          // lanes a block at most

}  // namespace

// One leaf of a plane_sums launch: x [B, M] (nullptr: the constant 1), its
// lane mask (index into masks), its output offset (hi row at out, lo row
// at out + M) and its first block.
struct SumLeaf {
  const int32_t* x;
  int32_t M;
  int32_t mask;
  int32_t out;
  int32_t first_block;
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

__global__ void __launch_bounds__(kP99Threads)
lane_p99_kernel(const P99Params p) {
  extern __shared__ int32_t rows[];     // lane l's row at l * (row + 1)
  const int row = p.N * p.LB;
  const int pitch = row + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * p.lanes_per_block;
  const int nb = static_cast<int>(p.B - b0 < p.lanes_per_block
                                  ? p.B - b0 : p.lanes_per_block);
  const int32_t* src = p.hist + b0 * row;
  const int words = nb * row;
  if (row % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    // a 16-byte word never straddles two rows (each row is whole words)
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < words / 4; i += kP99Threads) {
      const int4 v = src4[i];
      const int w = 4 * i;
      const int lane = w / row;
      int32_t* dst = rows + lane * pitch + (w - lane * row);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < words; i += kP99Threads) {
      const int lane = i / row;
      rows[lane * pitch + (i - lane * row)] = src[i];
    }
  }
  __syncthreads();
  if (threadIdx.x >= nb) return;
  const int32_t* h = rows + threadIdx.x * pitch;
  // pass 1: the total (the last cumulative count)
  float cdf = 0.0f;
  for (int k = 0; k < p.LB; ++k) {
    float v = __int2float_rn(h[k]);
    for (int n = 1; n < p.N; ++n)
      v = __fadd_rn(v, __int2float_rn(h[n * p.LB + k]));
    cdf = __fadd_rn(cdf, v);
  }
  const float total = cdf;
  float need = ceilf(__fmul_rn(total, p.q));
  need = need > 1.0f ? need : 1.0f;
  // pass 2: the first bucket whose cumulative count reaches `need`
  int j = 0;
  cdf = 0.0f;
  for (int k = 0; k < p.LB; ++k) {
    float v = __int2float_rn(h[k]);
    for (int n = 1; n < p.N; ++n)
      v = __fadd_rn(v, __int2float_rn(h[n * p.LB + k]));
    cdf = __fadd_rn(cdf, v);
    if (cdf >= need) {
      j = k;
      break;
    }
  }
  p.out[b0 + threadIdx.x] =
      total > 0.0f ? (j == 0 ? 0 : (1 << (j - 1))) : 0;
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
        || p.masks[p.leaves[l].mask] == nullptr)
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
