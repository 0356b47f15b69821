// fingerprint: the per-lane state fingerprint, one uint32 a lane.
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
// uint32 sum, exact mod 2^32 in any order, so the warp's reduction equals
// the plain version's sequential one.
//
// Bound: bytes: every leaf of every lane read once, one word written a
// lane. Design: a warp takes a lane and walks its leaves in order; the
// lane's n words of a leaf are contiguous, so the warp's threads read
// consecutive words (coalesced for the wide leaves: the event table, the
// payload, the logs), each multiplies its words by their weights, and one
// `__reduce_add_sync` gives lh to every thread, which all fold into h.
// The leaf table (pointer, words a lane, how to read an element) is the
// kernel's parameter block.

#include <cstdint>

constexpr int kMaxLeaves = 192;

// A leaf: its [B, n] elements and how to read one as a 32-bit word
// (0: 4-byte word, 1: unsigned byte, 2: signed byte, 3: signed 16-bit).
struct FpLeaf {
  const void* ptr;
  int32_t n;
  int32_t kind;
};

// The launch parameters, field for field the ctypes structure of the
// wrapper; outside the unnamed namespace so that the C entry point keeps
// external linkage.
struct FpParams {
  FpLeaf leaves[kMaxLeaves];
  int64_t* out;               // [B], the fingerprint in [0, 2^32)
  int B, n_leaves;
};

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;                  // lanes (warps) a block
constexpr uint32_t kOffset = 2166136261u;
constexpr uint32_t kPrime = 16777619u;
constexpr uint32_t kGolden = 2654435761u;

__device__ __forceinline__ uint32_t word_at(const FpLeaf& lf, int64_t i) {
  switch (lf.kind) {
    case 0: return static_cast<const uint32_t*>(lf.ptr)[i];
    case 1: return static_cast<const uint8_t*>(lf.ptr)[i];
    case 2: return static_cast<uint32_t>(
        static_cast<int32_t>(static_cast<const int8_t*>(lf.ptr)[i]));
    default: return static_cast<uint32_t>(
        static_cast<int32_t>(static_cast<const int16_t*>(lf.ptr)[i]));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
fingerprint_kernel(const FpParams p) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  if (b >= p.B) return;                    // the whole warp leaves
  uint32_t h = kOffset;
  for (int i = 0; i < p.n_leaves; ++i) {
    const FpLeaf lf = p.leaves[i];
    const uint32_t odd = 2u * static_cast<uint32_t>(i) + 1u;
    const int64_t base = b * lf.n;
    uint32_t acc = 0;
    for (int k = lane; k < lf.n; k += 32)
      acc += word_at(lf, base + k)
          * (static_cast<uint32_t>(k) * kGolden + odd);
    h = (h ^ __reduce_add_sync(kFull, acc)) * kPrime;
  }
  if (lane == 0) p.out[b] = static_cast<int64_t>(h);
}

}  // namespace

extern "C" int fingerprint_launch(const FpParams* params, void* stream) {
  const FpParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.n_leaves < 0 || p.n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.B + kWarps - 1) / kWarps));
  fingerprint_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
