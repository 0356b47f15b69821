// coverage_digest: the distinct-schedule reduction of a batch.
//
// Replaces the JAX package's `_coverage_digest`
// (madsim_tpu/parallel/stats.py:23, the device half of explore()'s
// per-round coverage count): sort the B two-word schedule hashes
// lexicographically as UNSIGNED words, flag each pair's first
// occurrence, and write the distinct pairs first (in sorted order), then
// the remaining rows (in sorted order), with n = the distinct count.
// Equal keys are equal values, so the output is determined element for
// element and must equal the plain PyTorch version
// (madsim_tpu_torch/ops/coverage.py `coverage_digest_plain`) exactly.
//
// Design: the 64-bit key (h0 << 32 | h1) is sorted by an LSD radix sort,
// 8 passes of 8 bits. Each pass is three launches: per-tile digit counts
// (a tile is 1024 keys), one exclusive scan over the digit-major count
// table, and a stable scatter in which each warp ranks equal digits with
// __match_any_sync and the block's warps are ordered through shared
// counters (stability of every pass is what makes an LSD sort right).
// Then a flag count per tile, a scan of the tile counts (its total is n)
// and a two-way compaction. No library sort is used.
//
// Bound: bytes. The function reads 8 bytes and writes 8 bytes per lane
// (plus n); the sort moves each key 16 times through device memory,
// which at B = 100,000 stays inside the 50 MB L2, so the launches
// themselves (29 of them) are the cost at this size.

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;               // keys per block
constexpr int kRounds = kTile / kThreads;  // keys per thread
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void make_keys(const uint32_t* __restrict__ hash, int B,
                          uint64_t* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B)
    keys[i] = (static_cast<uint64_t>(hash[2 * i]) << 32) | hash[2 * i + 1];
}

// counts[d * tiles + tile] = keys of this tile whose digit is d
__global__ void digit_counts(const uint64_t* __restrict__ src, int B,
                             int shift, uint32_t* __restrict__ counts) {
  __shared__ uint32_t h[kRadix];
  const int tid = threadIdx.x;
  h[tid] = 0;
  __syncthreads();
  for (int k = 0; k < kRounds; ++k) {
    const int i = blockIdx.x * kTile + k * kThreads + tid;
    if (i < B) atomicAdd(&h[(src[i] >> shift) & 0xff], 1u);
  }
  __syncthreads();
  counts[tid * gridDim.x + blockIdx.x] = h[tid];
}

// Exclusive scan of a[0..n) in place, by one block; *total (if given)
// receives the sum.
__global__ void scan_exclusive(uint32_t* __restrict__ a, int n,
                               int32_t* __restrict__ total) {
  __shared__ uint32_t s[2][kScanThreads];
  const int tid = threadIdx.x;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, n);
  const int hi = min(lo + per, n);
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  s[0][tid] = sum;
  __syncthreads();
  int cur = 0;
  for (int off = 1; off < kScanThreads; off <<= 1) {   // inclusive scan
    const uint32_t v = s[cur][tid] + (tid >= off ? s[cur][tid - off] : 0u);
    s[cur ^ 1][tid] = v;
    cur ^= 1;
    __syncthreads();
  }
  uint32_t run = s[cur][tid] - sum;                      // exclusive
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = a[i];
    a[i] = run;
    run += v;
  }
  if (total != nullptr && tid == kScanThreads - 1)
    *total = static_cast<int32_t>(s[cur][tid]);
}

// Stable scatter of one pass: key i of tile t with digit d goes to
// offsets[d * tiles + t] + (keys of digit d before it in the tile).
__global__ void scatter_digits(const uint64_t* __restrict__ src, int B,
                               int shift,
                               const uint32_t* __restrict__ offsets,
                               uint64_t* __restrict__ dst) {
  __shared__ uint32_t base[kRadix];
  __shared__ uint32_t wcount[kWarps][kRadix];
  __shared__ uint32_t woff[kWarps][kRadix];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  base[tid] = offsets[tid * gridDim.x + blockIdx.x];
  for (int k = 0; k < kRounds; ++k) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcount[w][tid] = 0;
    __syncthreads();
    const int i = blockIdx.x * kTile + k * kThreads + tid;
    const bool valid = i < B;
    const uint64_t key = valid ? src[i] : 0;
    // out-of-range threads take digit 256 and still join the collective
    const unsigned d = valid ? static_cast<unsigned>((key >> shift) & 0xff)
                             : static_cast<unsigned>(kRadix);
    const unsigned peers = __match_any_sync(kFull, d);
    const unsigned rank = __popc(peers & lanemask_lt());
    if (valid && lane == __ffs(peers) - 1) wcount[warp][d] = __popc(peers);
    __syncthreads();
    uint32_t run = base[tid];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      woff[w][tid] = run;
      run += wcount[w][tid];
    }
    base[tid] = run;
    __syncthreads();
    if (valid) dst[woff[warp][d] + rank] = key;
    __syncthreads();
  }
}

__device__ __forceinline__ bool is_first(const uint64_t* keys, int i) {
  return i == 0 || keys[i] != keys[i - 1];
}

__global__ void first_counts(const uint64_t* __restrict__ keys, int B,
                             uint32_t* __restrict__ tile_sums) {
  __shared__ uint32_t c;
  if (threadIdx.x == 0) c = 0;
  __syncthreads();
  uint32_t mine = 0;
  for (int k = 0; k < kRounds; ++k) {
    const int i = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (i < B && is_first(keys, i)) ++mine;
  }
  if (mine) atomicAdd(&c, mine);
  __syncthreads();
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = c;
}

// First occurrences go to their rank among first occurrences; every other
// row to n + its rank among the others. Ranks count in key order.
__global__ void compact(const uint64_t* __restrict__ keys, int B,
                        const uint32_t* __restrict__ tile_offsets,
                        const int32_t* __restrict__ n_distinct,
                        uint32_t* __restrict__ pairs) {
  __shared__ uint32_t wsum[kWarps];
  __shared__ uint32_t base;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t n = static_cast<uint32_t>(*n_distinct);
  if (tid == 0) base = tile_offsets[blockIdx.x];
  for (int k = 0; k < kRounds; ++k) {
    __syncthreads();
    const int i = blockIdx.x * kTile + k * kThreads + tid;
    const bool valid = i < B;
    const bool f = valid && is_first(keys, i);
    const unsigned ballot = __ballot_sync(kFull, f);
    if (lane == 0) wsum[warp] = __popc(ballot);
    __syncthreads();
    uint32_t before = base;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    before += __popc(ballot & lanemask_lt());
    if (valid) {
      const uint64_t key = keys[i];
      const uint32_t pos = f ? before : n + (static_cast<uint32_t>(i) - before);
      pairs[2 * pos] = static_cast<uint32_t>(key >> 32);
      pairs[2 * pos + 1] = static_cast<uint32_t>(key);
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t t = 0;
      for (int w = 0; w < kWarps; ++w) t += wsum[w];
      base += t;
    }
  }
}

}  // namespace

// hash: int32 [B, 2] (uint32 words); pairs: int32 [B, 2] out; n: int32 out;
// keys_a, keys_b: int64 [B] scratch; counts: int32 [256 * tiles];
// tile_sums: int32 [tiles], tiles = ceil(B / 1024).
extern "C" int coverage_digest_launch(const void* hash, int B, void* pairs,
                                      void* n, void* keys_a, void* keys_b,
                                      void* counts, void* tile_sums,
                                      void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;   // the caller's n is already 0
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (B + kTile - 1) / kTile;
  auto* a = static_cast<uint64_t*>(keys_a);
  auto* b = static_cast<uint64_t*>(keys_b);
  auto* cnt = static_cast<uint32_t*>(counts);
  auto* ts = static_cast<uint32_t*>(tile_sums);
  make_keys<<<(B + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(hash), B, a);
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 8 * pass;
    digit_counts<<<tiles, kThreads, 0, st>>>(a, B, shift, cnt);
    scan_exclusive<<<1, kScanThreads, 0, st>>>(cnt, kRadix * tiles, nullptr);
    scatter_digits<<<tiles, kThreads, 0, st>>>(a, B, shift, cnt, b);
    uint64_t* t = a;
    a = b;
    b = t;
  }
  first_counts<<<tiles, kThreads, 0, st>>>(a, B, ts);
  scan_exclusive<<<1, kScanThreads, 0, st>>>(ts, tiles,
                                              static_cast<int32_t*>(n));
  compact<<<tiles, kThreads, 0, st>>>(a, B, ts, static_cast<int32_t*>(n),
                                      static_cast<uint32_t*>(pairs));
  return static_cast<int>(cudaGetLastError());
}
