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
// Bound: bytes. The function reads 8 bytes and writes 8 bytes per lane
// (plus n): 1,600,004 B at B = 100,000, 0.00048 ms at 3.35 TB/s. The
// sort moves each key through the 50 MB L2 a few times over, so at this
// size the cost is the number of launches and how long each one's
// blocks wait on each other, not bytes.
//
// Design: an LSD radix sort of the 64-bit key (h0 << 32 | h1), 8 passes
// of 8-bit digits, in the onesweep style (Adinets & Merrill, 2022), in
// 10 kernel launches and one memset a call, all on the caller's stream
// (so the call can be captured in a CUDA graph):
//
//   memset     zeroes the scratch: digit histograms, tile counters and
//              every status word
//   histogram  one read of the hashes: builds each key, stores it, and
//              counts all eight digit histograms (shared-memory counters,
//              then one global atomic per nonzero bin)
//   8 passes   one launch each. A block takes its tile (512 keys) from an
//              atomic counter, never from blockIdx, so every tile it
//              waits on belongs to a block already running; ranks equal
//              digits stably (a warp's __match_any_sync, warps and rounds
//              in index order through shared counters); publishes its
//              per-digit counts as status words (flag A: the tile's own
//              count; flag P: the inclusive count of all tiles up to it)
//              and finds its exclusive offset by decoupled look-back over
//              earlier tiles' words, one thread per digit; adds the
//              digit's global offset (an exclusive scan of the pass's
//              histogram, which every block computes for itself) and
//              scatters. Stability of every pass makes the LSD sort right.
//   compact    first-occurrence flags and the two-way compaction in one
//              launch: each tile counts its first occurrences and chains
//              them by the same look-back; the last tile's inclusive
//              count is n; then each tile writes its distinct keys to
//              their rank and the others to n + their rank. Tiles come
//              from atomic counters, so a block only waits on tiles that
//              running blocks hold.
//
// No launch has one block walk all B keys, and every launch at
// B = 100,000 has 196 tiles, more than the card's 132 SMs. Eight-bit
// digits keep each pass's counters and status words (256 per tile) small
// enough to scan with one thread per digit; 11-bit digits would cut two
// passes but need 2,048 status words a tile. No library sort is used.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 2;                  // keys per thread per tile
constexpr int kTile = kThreads * kRounds;   // 512 keys per tile
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kPasses = 8;
constexpr int kHistKeys = kThreads * 16;    // keys per histogram block
constexpr int kCounters = 16;               // 8 passes + 2 compact phases
constexpr unsigned kFull = 0xffffffffu;

// status word: 2-bit flag over a 30-bit count (B < 2^30)
constexpr uint32_t kFlagA = 1u << 30;       // the tile's own count
constexpr uint32_t kFlagP = 2u << 30;       // inclusive count up to it
constexpr uint32_t kFlags = 3u << 30;
constexpr uint32_t kValue = ~kFlags;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Publish `count` for `tile` and return the inclusive count of all tiles
// before it: walk back over their status words (stride apart in
// `words`), adding own counts (flag A) until an inclusive one (flag P).
__device__ uint32_t look_back(volatile uint32_t* words, int stride,
                              uint32_t tile, uint32_t count) {
  if (tile == 0) {
    words[0] = kFlagP | count;
    return 0;
  }
  words[static_cast<size_t>(tile) * stride] = kFlagA | count;
  uint32_t excl = 0;
  for (int64_t j = static_cast<int64_t>(tile) - 1;; --j) {
    uint32_t v;
    do {
      v = words[j * stride];
    } while ((v & kFlags) == 0);
    excl += v & kValue;
    if (v & kFlagP) break;
  }
  words[static_cast<size_t>(tile) * stride] = kFlagP | (excl + count);
  return excl;
}

// The exclusive prefix sum of `v` over the block's threads in order.
__device__ __forceinline__ uint32_t block_exclusive_scan(
    uint32_t v, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
histogram(const uint32_t* __restrict__ hash, int B,
          uint64_t* __restrict__ keys, uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kPasses * kRadix];
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) h[i] = 0;
  __syncthreads();
  for (int k = 0; k < kHistKeys / kThreads; ++k) {
    const int i = blockIdx.x * kHistKeys + k * kThreads + threadIdx.x;
    if (i < B) {
      const uint64_t key = (static_cast<uint64_t>(hash[2 * i]) << 32)
          | hash[2 * i + 1];
      keys[i] = key;
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        atomicAdd(&h[p * kRadix + ((key >> (8 * p)) & 0xff)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

// One stable pass on the digit at `shift`. hist: this pass's 256 counts;
// status: this pass's [tiles][256] words; counter: this pass's tile
// counter.
__global__ void __launch_bounds__(kThreads)
scatter_pass(const uint64_t* __restrict__ src, uint64_t* __restrict__ dst,
             int B, int shift, const uint32_t* __restrict__ hist,
             uint32_t* status, uint32_t* counter) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_wsum[kWarps];
  __shared__ uint32_t s_base[kRadix];
  __shared__ uint32_t s_cnt[kRounds][kWarps][kRadix];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_cnt[k][w][tid] = 0;
  // the digit's global offset (thread tid is digit tid); syncs the block
  const uint32_t digit_base = block_exclusive_scan(hist[tid], s_wsum);
  const uint32_t tile = s_tile;

  uint64_t key[kRounds];
  unsigned d[kRounds], rank[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int64_t i = static_cast<int64_t>(tile) * kTile + k * kThreads
        + tid;
    const bool valid = i < B;
    key[k] = valid ? src[i] : 0;
    // out-of-range threads take digit 256 and still join the collective
    d[k] = valid ? static_cast<unsigned>((key[k] >> shift) & 0xff)
                 : static_cast<unsigned>(kRadix);
    const unsigned peers = __match_any_sync(kFull, d[k]);
    rank[k] = __popc(peers & lanemask_lt());
    if (valid && lane == __ffs(peers) - 1) s_cnt[k][warp][d[k]] = __popc(peers);
  }
  __syncthreads();
  // digit tid: each (round, warp)'s offset inside the tile, and the total
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = s_cnt[k][w][tid];
      s_cnt[k][w][tid] = run;
      run += c;
    }
  s_base[tid] = digit_base + look_back(status + tid, kRadix, tile, run);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
    if (d[k] < kRadix)
      dst[s_base[d[k]] + s_cnt[k][warp][d[k]] + rank[k]] = key[k];
}

__device__ __forceinline__ bool is_first(const uint64_t* keys, int64_t i) {
  return i == 0 || keys[i] != keys[i - 1];
}

// First occurrences go to their rank among first occurrences; every other
// row to n + its rank among the others. Ranks count in key order.
// status: [tiles] words; counters: the two phases' tile counters.
__global__ void __launch_bounds__(kThreads)
compact(const uint64_t* __restrict__ keys, int B, int tiles,
        uint32_t* status, uint32_t* counters,
        int32_t* __restrict__ n_distinct, uint32_t* __restrict__ pairs) {
  __shared__ uint32_t s_tile, s_excl, s_n;
  __shared__ uint32_t s_wsum[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  volatile uint32_t* vstatus = status;

  // phase 1: each tile's count of first occurrences, chained by look-back
  for (;;) {
    if (tid == 0) s_tile = atomicAdd(&counters[0], 1u);
    __syncthreads();
    const uint32_t tile = s_tile;
    if (tile >= static_cast<uint32_t>(tiles)) break;   // block-uniform
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int64_t i = static_cast<int64_t>(tile) * kTile + k * kThreads
          + tid;
      mine += (i < B && is_first(keys, i)) ? 1u : 0u;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(kFull, mine, o);
    if (lane == 0) s_wsum[warp] = mine;
    __syncthreads();
    if (tid == 0) {
      uint32_t count = 0;
      for (int w = 0; w < kWarps; ++w) count += s_wsum[w];
      look_back(vstatus, 1, tile, count);
    }
    __syncthreads();
  }

  // n: the last tile's inclusive count. Every tile has been taken by a
  // running block before any block gets here, so the wait ends.
  if (tid == 0) {
    uint32_t v;
    do {
      v = vstatus[tiles - 1];
    } while ((v & kFlagP) == 0);
    s_n = v & kValue;
  }
  __syncthreads();
  const uint32_t n = s_n;

  // phase 2: the two-way compaction
  for (;;) {
    if (tid == 0) {
      const uint32_t t = atomicAdd(&counters[1], 1u);
      s_tile = t;
      uint32_t excl = 0;
      if (t > 0 && t < static_cast<uint32_t>(tiles)) {
        uint32_t v;
        do {
          v = vstatus[t - 1];
        } while ((v & kFlagP) == 0);
        excl = v & kValue;
      }
      s_excl = excl;
      if (t == 0) *n_distinct = static_cast<int32_t>(n);
    }
    __syncthreads();
    const uint32_t tile = s_tile;
    if (tile >= static_cast<uint32_t>(tiles)) break;   // block-uniform
    uint32_t base = s_excl;
    for (int k = 0; k < kRounds; ++k) {
      const int64_t i = static_cast<int64_t>(tile) * kTile + k * kThreads
          + tid;
      const bool valid = i < B;
      const bool f = valid && is_first(keys, i);
      const unsigned ballot = __ballot_sync(kFull, f);
      if (lane == 0) s_wsum[warp] = __popc(ballot);
      __syncthreads();
      uint32_t before = base, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += s_wsum[w];
        total += s_wsum[w];
      }
      before += __popc(ballot & lanemask_lt());
      if (valid) {
        const uint64_t key = keys[i];
        const uint32_t pos =
            f ? before : n + (static_cast<uint32_t>(i) - before);
        pairs[2 * static_cast<size_t>(pos)] =
            static_cast<uint32_t>(key >> 32);
        pairs[2 * static_cast<size_t>(pos) + 1] = static_cast<uint32_t>(key);
      }
      base += total;
      __syncthreads();
    }
  }
}

int64_t tiles_of(int B) { return (static_cast<int64_t>(B) + kTile - 1) / kTile; }

}  // namespace

// int32 words of scratch a call on B keys needs: the 8 x 256 digit
// histograms, the tile counters, 8 x tiles x 256 pass status words and
// tiles compaction status words.
extern "C" int64_t coverage_digest_scratch_words(int B) {
  return kPasses * kRadix + kCounters
      + tiles_of(B) * (static_cast<int64_t>(kPasses) * kRadix + 1);
}

// hash: int32 [B, 2] (uint32 words); pairs: int32 [B, 2] out; n: int32 out
// (the caller zeroes it: B == 0 launches nothing); keys_a, keys_b: int64
// [B] scratch; scratch: int32 [coverage_digest_scratch_words(B)].
// issued[0] / issued[1] receive the kernel launches / memsets enqueued.
// Returns the first CUDA error (0 = launched).
extern "C" int coverage_digest_launch(const void* hash, int B, void* pairs,
                                      void* n, void* keys_a, void* keys_b,
                                      void* scratch, int* issued,
                                      void* stream) {
  issued[0] = issued[1] = 0;
  if (B < 0 || B >= (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(B);
  auto* hist = static_cast<uint32_t*>(scratch);
  uint32_t* counters = hist + kPasses * kRadix;
  uint32_t* status = counters + kCounters;
  uint32_t* cstatus = status + tiles * kPasses * kRadix;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, coverage_digest_scratch_words(B) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  issued[1] = 1;
  auto* a = static_cast<uint64_t*>(keys_a);
  auto* b = static_cast<uint64_t*>(keys_b);
  histogram<<<(B + kHistKeys - 1) / kHistKeys, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(hash), B, a, hist);
  for (int pass = 0; pass < kPasses; ++pass) {
    scatter_pass<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        a, b, B, 8 * pass, hist + pass * kRadix,
        status + static_cast<size_t>(pass) * tiles * kRadix,
        counters + pass);
    uint64_t* t = a;
    a = b;
    b = t;
  }
  compact<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      a, B, static_cast<int>(tiles), cstatus, counters + kPasses,
      static_cast<int32_t*>(n), static_cast<uint32_t*>(pairs));
  issued[0] = 1 + kPasses + 1;
  return static_cast<int>(cudaGetLastError());
}
