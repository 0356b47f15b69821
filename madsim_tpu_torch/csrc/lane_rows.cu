// lane_rows: the whole-state lane gather and scatter of the runners and
// the harness (K14), every leaf of a state in one launch.
//
// Replaces no TPU kernel: the JAX package does this work in host numpy.
// `Runtime.run_compacting` repacks the live lanes with `a[keep]` and
// stashes the halted ones with `a[drop]` (madsim_tpu/runtime/runtime.py
// :703-712), then merges the parts back into the original lane order
// (:729-737); the determinism sanitizer un-permutes the second run with
// `vb[align]` (madsim_tpu/harness/simtest.py:151-152). The port keeps the
// state on the card, where the same work is a gather and a scatter of
// every leaf; as plain PyTorch that is one `index_select` or
// `index_copy_` a leaf (the plain versions, held equal to this kernel:
// madsim_tpu_torch/ops/lane_rows.py `lane_take_plain`,
// `lane_put_plain`):
//
//   take  dst[l][i] = src[l][idx[i]]   for i < T, every leaf l
//   put   dst[l][idx[i]] = src[l][i]   for i < T, every leaf l (idx
//                                      distinct: the writes are unordered)
//
// A lane's row of a leaf is `row` contiguous bytes; idx is an int64 [T]
// that the wrapper has checked on the host (in range; distinct for put).
//
// Bound: bytes: every row read once and written once (the flagship's
// state is about 6,900 bytes a lane, so a take of all 100,000 lanes moves
// about 1.38 GB: 0.41 ms at 3.35 TB/s).
//
// Design: the launch's leaves share one grid. Each leaf's rows are cut
// into pieces of `chunk` bytes (16 where both bases and the row's bytes
// are 16-byte aligned, else the widest power of two that divides them
// all), T * chunks pieces a leaf, kPer * kThreads pieces a block; a block
// finds its leaf by a binary search over the leaves' first blocks, and a
// thread issues its kPer loads before its stores. Consecutive threads take
// consecutive pieces of a row, so a warp moves whole 16-byte pieces of one
// or a few rows of neighbouring lanes.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxRows = 112;    // leaves a launch (a 4 KB parameter block)

// One leaf: src and dst, `row` bytes a lane, copied `chunk` bytes an access
// (`chunks` a row); its pieces start at block `first` of the grid.
struct RowsLeaf {
  const void* src;
  void* dst;
  int32_t row;
  int32_t first;
  int32_t chunk;
  int32_t chunks;
};

// The launch parameters, field for field the ctypes structure of
// madsim_tpu_torch/ops/lane_rows.py; outside the unnamed namespace so that
// the C entry point keeps external linkage.
struct RowsParams {
  RowsLeaf leaves[kMaxRows];
  const int64_t* idx;   // [T]
  int64_t T;            // lanes of the index
  int64_t B;            // lanes of the indexed side (take: src; put: dst)
  int32_t n_leaves;
  int32_t put;          // 0: take, 1: put
  int32_t blocks;       // the grid
  int32_t pad;
};

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                      // pieces a thread
constexpr int kPieces = kThreads * kPer;     // pieces a block

// `chunk` bytes at p (aligned to chunk), in the low words of a uint4
__device__ __forceinline__ uint4 load_chunk(const char* p, int chunk) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  switch (chunk) {
    case 16: v = *reinterpret_cast<const uint4*>(p); break;
    case 8: {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      v.x = t.x;
      v.y = t.y;
      break;
    }
    case 4: v.x = *reinterpret_cast<const uint32_t*>(p); break;
    case 2: v.x = *reinterpret_cast<const uint16_t*>(p); break;
    default: v.x = *reinterpret_cast<const uint8_t*>(p); break;
  }
  return v;
}

__device__ __forceinline__ void store_chunk(char* p, uint4 v, int chunk) {
  switch (chunk) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.x);
      break;
    default: *reinterpret_cast<uint8_t*>(p) = static_cast<uint8_t>(v.x);
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
lane_rows_kernel(const __grid_constant__ RowsParams p) {
  const int bx = static_cast<int>(blockIdx.x);
  int lo = 0, hi = p.n_leaves - 1;       // the last leaf with first <= bx
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.leaves[mid].first <= bx) lo = mid; else hi = mid - 1;
  }
  const RowsLeaf& lf = p.leaves[lo];
  const uint32_t chunks = static_cast<uint32_t>(lf.chunks);
  const uint32_t total = static_cast<uint32_t>(p.T) * chunks;
  const uint32_t base = static_cast<uint32_t>(bx - lf.first) * kPieces
      + threadIdx.x;
  const int cb = lf.chunk;
  const int64_t rb = lf.row;
  const char* src = static_cast<const char*>(lf.src);
  char* dst = static_cast<char*>(lf.dst);
  uint4 v[kPer];
  int64_t at[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t q = base + k * kThreads;
    at[k] = -1;
    if (q < total) {
      const uint32_t i = q / chunks;
      const uint32_t c = q - i * chunks;
      const int64_t r = p.idx[i];
      const int64_t s = p.put ? static_cast<int64_t>(i) : r;
      const int64_t d = p.put ? r : static_cast<int64_t>(i);
      v[k] = load_chunk(src + s * rb + static_cast<int64_t>(c) * cb, cb);
      at[k] = d * rb + static_cast<int64_t>(c) * cb;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (at[k] >= 0) store_chunk(dst + at[k], v[k], cb);
}

inline bool aligned(const void* ptr, int chunk) {
  return reinterpret_cast<uintptr_t>(ptr) % chunk == 0;
}

}  // namespace

// The table the wrapper laid out: each leaf copyable at its chunk, its
// blocks starting where the last leaf's end, the grid their sum.
extern "C" int lane_rows_launch(const RowsParams* params, void* stream) {
  const RowsParams& p = *params;
  if (p.n_leaves < 1 || p.n_leaves > kMaxRows || p.T < 1 || p.B < 1
      || p.idx == nullptr || (p.put != 0 && p.put != 1) || p.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t next = 0;
  for (int l = 0; l < p.n_leaves; ++l) {
    const RowsLeaf& lf = p.leaves[l];
    const int c = lf.chunk;
    if ((c != 1 && c != 2 && c != 4 && c != 8 && c != 16) || lf.row < 1
        || lf.row % c != 0 || lf.row / c != lf.chunks || lf.src == nullptr
        || lf.dst == nullptr || !aligned(lf.src, c) || !aligned(lf.dst, c))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t pieces = p.T * lf.chunks;
    if (pieces >= (int64_t{1} << 31) || lf.first != next)
      return static_cast<int>(cudaErrorInvalidValue);
    next += (pieces + kPieces - 1) / kPieces;
  }
  if (next != p.blocks) return static_cast<int>(cudaErrorInvalidValue);
  lane_rows_kernel<<<p.blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
