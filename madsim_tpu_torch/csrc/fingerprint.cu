// fingerprint: the per-lane state fingerprint, one uint32 a lane, a tile
// of lanes a block.
//
// Replaces the JAX package's `fingerprint` (madsim_tpu/utils/hashing.py
// :43) under `batch_fingerprints` (:74, its vmap). The plain version, held
// equal to this kernel, is madsim_tpu_torch/utils/hashing.py
// `fingerprint_plain`. For leaf i of the state (every non-observation
// leaf, in the order the plain version lists them), with the lane's
// elements as 32-bit words w[0..n) (a float32's bit pattern, an int32 as
// it is, a bool or an integer narrower than 32 bits cast to int32):
//
//   lh = sum_k w[k] * (k * 2654435761 + 2i + 1)   (mod 2^32)
//   h  = (h ^ lh) * 16777619                      (mod 2^32)
//
// from h = 2166136261; a zero-size leaf folds lh = 0. Every sum is a
// uint32 sum, exact mod 2^32 in any order, so any split of a sum among
// threads equals the plain version's sequential one.
//
// Bound: bytes: every leaf of every lane read once, one word written a
// lane (the flagship's 49 leaves, 6,895 bytes a lane: 0.21 ms at
// B = 100,000). A first version, a warp a lane walking its leaves in
// turn, took 0.66 ms on an NVIDIA H100 80GB HBM3 at 700 W: a lane's next
// leaf waited on this leaf's load and reduction, so a warp had about one
// load in flight, and on the 29 leaves of at most 5 words 27 or more of
// its threads idled.
//
// Design: a block takes a tile of T consecutive lanes (T <= 32, chosen by
// the wrapper so that the tile fits in shared memory). A leaf's elements
// of the tile are one contiguous range of device memory, [b0 * n,
// (b0 + T) * n), and go to a 16-byte aligned region of shared memory
// (the wrapper lays the regions out). Warp w takes leaves w, w + 8, ...:
// it first starts the copies of all of them with `cp.async`, 16, 8 or 4
// bytes an access (`chunk`: the widest that divides the leaf's address
// and its tile's bytes, so that every tile's range starts aligned), or
// an element at a time where no width fits (a leaf one byte off), then
// waits for its own copies and computes each leaf's lh for the tile's
// lanes from shared memory: a leaf of at least 32 words a warp a lane
// (16-byte loads of four words where the lane's row allows, several in
// flight, then one `__reduce_add_sync`), a narrower one a thread a lane.
// The lh table [leaf][lane] sits in shared memory too; after a block
// barrier, a thread a lane folds it in leaf order. So a block keeps its
// whole tile in flight, and several blocks an SM overlap one tile's loads
// with another's sums.

#include <cstdint>

constexpr int kMaxLeaves = 192;

// A leaf: its [B, n] elements, how to read one as a 32-bit word (kind 0:
// 4-byte word, 1: unsigned byte, 2: signed byte, 3: signed 16-bit) and
// its copy width (chunk: 16, 8 or 4 bytes, 0 an element at a time).
struct FpLeaf {
  const void* ptr;
  int32_t n;
  uint8_t kind;
  uint8_t chunk;
  uint16_t pad;
};

// The launch parameters, field for field the ctypes structure of the
// wrapper; outside the unnamed namespace so that the C entry point keeps
// external linkage. off[i] is leaf i's region; the lh table is at 0.
struct FpParams {
  FpLeaf leaves[kMaxLeaves];
  int32_t off[kMaxLeaves];
  int64_t* out;               // [B], the fingerprint in [0, 2^32)
  int B, n_leaves, tile, smem;
};

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;                  // a block's warps
constexpr int kMaxTile = 32;
constexpr int kSmemMax = 231424;           // a block's 227 KB less static
constexpr uint32_t kOffset = 2166136261u;
constexpr uint32_t kPrime = 16777619u;
constexpr uint32_t kGolden = 2654435761u;

__host__ __device__ inline int esize(int kind) {
  return kind == 0 ? 4 : kind == 3 ? 2 : 1;
}

__host__ __device__ inline long long up16(long long x) {
  return (x + 15) & ~15LL;
}

// sum over k < n of word(k) * (k * kGolden + odd) for the k this thread
// of a warp takes (k = wl, wl + 32, ... for a warp's sum, every k for a
// thread's), word(k) element e0 + k of a region read as a 32-bit word;
// several loads in flight before their products
template <typename E>
__device__ __forceinline__ uint32_t sum_of(const unsigned char* base, int e0,
                                           int n, int k0, int step,
                                           uint32_t odd) {
  const E* x = reinterpret_cast<const E*>(base) + e0;
  uint32_t acc = 0;
#pragma unroll 4
  for (int k = k0; k < n; k += step)
    acc += static_cast<uint32_t>(static_cast<int32_t>(x[k]))
        * (static_cast<uint32_t>(k) * kGolden + odd);
  return acc;
}

// A warp's share of a lane's sum over 4-byte words where the lane's row is
// 16-byte aligned (n % 4 == 0): four words a 16-byte load, thread wl
// taking k = 4 wl .. 4 wl + 3, then 128 words on.
__device__ __forceinline__ uint32_t sum_vec4(const unsigned char* base,
                                             int e0, int n, int wl,
                                             uint32_t odd) {
  const uint4* x = reinterpret_cast<const uint4*>(
      reinterpret_cast<const uint32_t*>(base) + e0);
  uint32_t acc = 0;
#pragma unroll 4
  for (int q = wl; q < n / 4; q += 32) {
    const uint4 w = x[q];
    const uint32_t m = static_cast<uint32_t>(4 * q) * kGolden + odd;
    acc += w.x * m + w.y * (m + kGolden) + w.z * (m + 2u * kGolden)
        + w.w * (m + 3u * kGolden);
  }
  return acc;
}

__device__ __forceinline__ uint32_t leaf_sum(const unsigned char* base,
                                             int kind, int e0, int n, int k0,
                                             int step, uint32_t odd) {
  switch (kind) {
    case 0: return sum_of<uint32_t>(base, e0, n, k0, step, odd);
    case 1: return sum_of<uint8_t>(base, e0, n, k0, step, odd);
    case 2: return sum_of<int8_t>(base, e0, n, k0, step, odd);
    default: return sum_of<int16_t>(base, e0, n, k0, step, odd);
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kWarps * 32)
fingerprint_kernel(const FpParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* lh = reinterpret_cast<uint32_t*>(smem);   // [n_leaves][T]
  const int T = p.tile;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * T;
  const int nt = min(T, p.B - static_cast<int>(blockIdx.x) * T);

  // ---- start every copy of this warp's leaves ----------------------------
  for (int i = warp; i < p.n_leaves; i += kWarps) {
    const FpLeaf lf = p.leaves[i];
    const int es = esize(lf.kind);
    const int bytes = nt * lf.n * es;
    const unsigned char* src = static_cast<const unsigned char*>(lf.ptr)
        + b0 * lf.n * es;
    unsigned char* dst = smem + p.off[i];
    int done = 0;
    if (lf.chunk) {
      const int c = lf.chunk;
      const int full = bytes / c;
      for (int k = wl; k < full; k += 32) cp_async(dst + k * c, src + k * c,
                                                   c);
      done = full * c;
    }
    // the rest (a ragged tile's tail, or a leaf no width fits): an element
    // at a time
    if (es == 4)
      for (int e = done / 4 + wl; e < bytes / 4; e += 32)
        reinterpret_cast<uint32_t*>(dst)[e] =
            reinterpret_cast<const uint32_t*>(src)[e];
    else if (es == 2)
      for (int e = done / 2 + wl; e < bytes / 2; e += 32)
        reinterpret_cast<uint16_t*>(dst)[e] =
            reinterpret_cast<const uint16_t*>(src)[e];
    else
      for (int e = done + wl; e < bytes; e += 32) dst[e] = src[e];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // ---- each of this warp's leaves' lh for the tile's lanes --------------
  for (int i = warp; i < p.n_leaves; i += kWarps) {
    const FpLeaf lf = p.leaves[i];
    const unsigned char* base = smem + p.off[i];
    const uint32_t odd = 2u * static_cast<uint32_t>(i) + 1u;
    const int n = lf.n;
    if (n >= 32) {                 // a warp a lane
      const bool vec4 = lf.kind == 0 && n % 4 == 0;
#pragma unroll 2
      for (int l = 0; l < nt; ++l) {
        const uint32_t acc = vec4
            ? sum_vec4(base, l * n, n, wl, odd)
            : leaf_sum(base, lf.kind, l * n, n, wl, 32, odd);
        const uint32_t lh_l = __reduce_add_sync(kFull, acc);
        if (wl == 0) lh[i * T + l] = lh_l;
      }
    } else if (wl < nt) {          // a thread a lane
      lh[i * T + wl] = leaf_sum(base, lf.kind, wl * n, n, 0, 1, odd);
    }
  }
  __syncthreads();

  // ---- fold, a thread a lane ---------------------------------------------
  if (threadIdx.x < nt) {
    uint32_t h = kOffset;
#pragma unroll 8
    for (int i = 0; i < p.n_leaves; ++i)
      h = (h ^ lh[i * T + threadIdx.x]) * kPrime;
    p.out[b0 + threadIdx.x] = static_cast<int64_t>(h);
  }
}

}  // namespace

// The layout the wrapper laid out (utils/hashing.py `fp_layout`): the lh
// table, then each leaf's region, each 16-byte aligned; a copy width that
// divides the leaf's address and its tile's bytes.
static bool layout_ok(const FpParams& p) {
  long long o = up16(4LL * p.tile * p.n_leaves);
  for (int i = 0; i < p.n_leaves; ++i) {
    const FpLeaf& lf = p.leaves[i];
    if (lf.kind > 3 || lf.n < 0 || p.off[i] != o) return false;
    const long long bytes = static_cast<long long>(p.tile) * lf.n
        * esize(lf.kind);
    const int c = lf.chunk;
    if (c != 0 && c != 4 && c != 8 && c != 16) return false;
    if (c && (bytes % c != 0
              || reinterpret_cast<uintptr_t>(lf.ptr) % c != 0))
      return false;
    o += up16(bytes);
  }
  return o == p.smem && o <= kSmemMax;
}

extern "C" int fingerprint_launch(const FpParams* params, void* stream) {
  const FpParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.n_leaves < 0 || p.n_leaves > kMaxLeaves || p.tile < 1
      || p.tile > kMaxTile || !layout_ok(p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fingerprint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((p.B + p.tile - 1) / p.tile));
  fingerprint_kernel<<<grid, kWarps * 32, static_cast<size_t>(p.smem),
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
