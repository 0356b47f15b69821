// lane_diff: which lanes of which leaves differ between two states of one
// shape (K15), every leaf pair in one launch.
//
// Replaces no TPU kernel: the JAX package diffs in host numpy
// (madsim_tpu/harness/simtest.py:138-165 `diff_states`, the determinism
// sanitizer's comparator). The port keeps both states on the card, where
// the diff is a compare of every leaf; as plain PyTorch that is one
// `ne().any()` a leaf (the plain version, held equal to this kernel:
// madsim_tpu_torch/ops/lane_diff.py `lane_diff_plain`):
//
//   flags[l][b] = 1 if any element of leaf l of lane b differs between
//                 a and b, else 0
//
// compared by value as numpy's `!=` does, with NaN equal to NaN: a
// float32 leaf (kind 1) compares its words as floats (-0.0 == 0.0, NaN ==
// NaN); every other leaf (kind 0: integers and bools) compares its bytes,
// which for these types is the same as comparing values. A zero-size leaf
// (row 0) writes 0 for every lane.
//
// Bound: bytes: both states read once, one byte written a leaf and lane
// (the traced flagship at B = 100,000: about 1.38 GB, 0.41 ms at 3.35
// TB/s).
//
// Design: the launch's leaves share one grid, a block finding its leaf by
// a binary search over the leaves' first blocks. A lane's row is cut into
// pieces of `chunk` bytes (16 where both bases and the row's bytes are
// 16-byte aligned, else the widest power of two that divides them all)
// and taken by a group of 1 << shift threads of one warp (the least power
// of two at or above its pieces, at most 32); each thread compares its
// pieces, several loads in flight, and the group ORs its results by xor
// shuffles, which every thread of the warp runs (a thread past the last
// lane compares nothing but still shuffles). The group's first thread
// writes the lane's flag: every flag is written exactly once, so the
// output needs no clearing.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxDiff = 112;    // leaves a launch (a 4 KB parameter block)

// One leaf pair: a and b, `row` bytes a lane compared `chunk` bytes an
// access (`chunks` a row), 1 << shift threads a lane, `kind` 1 for
// float32; its lanes start at block `first` of the grid.
struct DiffLeaf {
  const void* a;
  const void* b;
  int32_t row;
  int32_t first;
  int32_t chunks;
  uint8_t chunk;
  uint8_t shift;
  uint8_t kind;
  uint8_t pad;
};

// The launch parameters, field for field the ctypes structure of
// madsim_tpu_torch/ops/lane_diff.py; outside the unnamed namespace so that
// the C entry point keeps external linkage. Leaf l's flags are
// flags[l * B, (l + 1) * B).
struct DiffParams {
  DiffLeaf leaves[kMaxDiff];
  uint8_t* flags;
  int64_t B;
  int32_t n_leaves;
  int32_t blocks;
};

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// float32 words x and y differ by value, NaN equal to NaN
__device__ __forceinline__ bool fdiff(uint32_t x, uint32_t y) {
  const float fx = __uint_as_float(x), fy = __uint_as_float(y);
  return fx != fy && !(fx != fx && fy != fy);
}

// two chunks differ (unused words are zero in both)
__device__ __forceinline__ bool chunk_diff(uint4 x, uint4 y, bool as_float) {
  if (as_float)
    return fdiff(x.x, y.x) || fdiff(x.y, y.y) || fdiff(x.z, y.z)
        || fdiff(x.w, y.w);
  return x.x != y.x || x.y != y.y || x.z != y.z || x.w != y.w;
}

__global__ void __launch_bounds__(kThreads)
lane_diff_kernel(const __grid_constant__ DiffParams p) {
  const int bx = static_cast<int>(blockIdx.x);
  int lo = 0, hi = p.n_leaves - 1;       // the last leaf with first <= bx
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.leaves[mid].first <= bx) lo = mid; else hi = mid - 1;
  }
  const DiffLeaf& lf = p.leaves[lo];
  const int shift = lf.shift;
  const int group = 1 << shift;
  const int sub = threadIdx.x & (group - 1);
  const int64_t lane = static_cast<int64_t>(bx - lf.first)
      * (kThreads >> shift) + (threadIdx.x >> shift);
  const bool live = lane < p.B;
  const int cb = lf.chunk;
  const bool as_float = lf.kind == 1;
  const char* a = static_cast<const char*>(lf.a) + lane * lf.row;
  const char* b = static_cast<const char*>(lf.b) + lane * lf.row;
  bool d = false;
  if (live) {
#pragma unroll 4
    for (int c = sub; c < lf.chunks; c += group)
      d |= chunk_diff(load_chunk(a + c * cb, cb), load_chunk(b + c * cb, cb),
                      as_float);
  }
  // the group's OR: every thread of the warp runs every shuffle (the
  // group size is uniform over the block)
  unsigned any = d ? 1u : 0u;
  for (int o = 1; o < group; o <<= 1) any |= __shfl_xor_sync(kFull, any, o);
  if (live && sub == 0)
    p.flags[static_cast<int64_t>(lo) * p.B + lane] = static_cast<uint8_t>(any);
}

inline bool aligned(const void* ptr, int chunk) {
  return reinterpret_cast<uintptr_t>(ptr) % chunk == 0;
}

}  // namespace

// The table the wrapper laid out: each leaf comparable at its chunk with
// its group, its blocks starting where the last leaf's end, the grid
// their sum.
extern "C" int lane_diff_launch(const DiffParams* params, void* stream) {
  const DiffParams& p = *params;
  if (p.n_leaves < 1 || p.n_leaves > kMaxDiff || p.B < 1
      || p.flags == nullptr || p.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t next = 0;
  for (int l = 0; l < p.n_leaves; ++l) {
    const DiffLeaf& lf = p.leaves[l];
    const int c = lf.chunk;
    if ((c != 1 && c != 2 && c != 4 && c != 8 && c != 16) || lf.row < 0
        || lf.row % c != 0 || lf.row / c != lf.chunks || lf.shift > 5
        || lf.kind > 1 || (lf.kind == 1 && c < 4))
      return static_cast<int>(cudaErrorInvalidValue);
    // the group: the least power of two at or above the row's pieces,
    // at most a warp
    int want = 0;
    while (want < 5 && (1 << want) < lf.chunks) ++want;
    if (lf.shift != want) return static_cast<int>(cudaErrorInvalidValue);
    if (lf.row > 0 && (lf.a == nullptr || lf.b == nullptr
                       || !aligned(lf.a, c) || !aligned(lf.b, c)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (lf.first != next) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t per = kThreads >> lf.shift;         // lanes a block
    next += (p.B + per - 1) / per;
  }
  if (next != p.blocks || next >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  lane_diff_kernel<<<p.blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
