// prng: jax's threefry2x32 draws outside the step kernels (K1).
//
// Replaces the JAX package's threefry draws (madsim_tpu/core/prng.py:24
// `split`, :28 `randint`, :35 `uniform`, :39 `bernoulli`, :49
// `node_hash_key`; `jax.random.fold_in` at madsim_tpu/core/step.py:246
// and :315) where the step draws outside a kernel: the select's key
// split, the duplicate-delivery draws, the supervisor section's
// extension split and every handler draw (core/api.py `Ctx`). The plain
// version, held equal to these kernels, is madsim_tpu_torch/core/prng.py.
// Both kernels are built from threefry.cuh, whose device functions the
// other kernels (sched_pick, apply_super, emit_write, mutate) already
// hold exact, so the stream is the same by construction:
//
//   threefry_keys   split(key, n) for any n >= 1 (n keys a key), or
//                   fold_in(key, word) with one word a key (n = 0)
//   threefry_draw   one draw a (key, f): randint_raw over exclusive int32
//                   bounds (or inclusive ones, the high bound wrapping),
//                   uniform, or bernoulli(p); F values a key are
//                   `random_bits(split(key, 2), (F,))`'s, as
//                   randint_raw(key, lo, hi, shape) draws them
//
// Operands are [M, W] grids over strided memory: element (m, w) of an
// operand lies at ptr + m * sm + w * sw (elements; a stride of 0
// broadcasts), a key's two words next to each other. A bound or p with
// a null pointer is the scalar passed by value. Everything is uint32
// arithmetic (ROADMAP F2); the bernoulli compare is float32 on both
// sides, and nothing divides (F15).
//
// Bound: each launch moves a few bytes a key (8 in, 4-40 out) and does
// one to sixteen 20-round threefry blocks a key, at the step's B=100,000
// keys a few microseconds of either; it is latency-bound (one launch,
// one wave). Design: a thread a key (a key and a value for the draws),
// so every operand is one coalesced pass when its stride is 1 and a
// broadcast read hits the same line.

#include <cstdint>

#include "threefry.cuh"

// A [M, W] grid of elements over strided memory (see above).
struct Operand {
  const void* ptr;
  int64_t sm;
  int64_t sw;
};

// The launch parameters, field for field the ctypes structures of
// madsim_tpu_torch/ops/threefry.py; outside the unnamed namespace so that
// the C entry points keep external linkage.
struct KeysParams {
  Operand key;        // int32 pairs
  Operand data;       // fold_in: int32 words; ptr null: `word` for all
  int32_t* out;       // split: [M, W, n, 2]; fold_in: [M, W, 2]
  int32_t word;
  int32_t M, W, n;    // n == 0: fold_in
};

struct DrawParams {
  Operand key;        // int32 pairs
  Operand lo;         // randint: minval (int32); bernoulli: p (float32)
  Operand hi;         // randint: maxval (int32)
  void* out;          // [M, W, F]: int32, float32 or bool
  int32_t lo_val, hi_val;   // the bounds by value (null pointers)
  float p_val;              // p by value (null pointer)
  int32_t M, W, F;
  int32_t mode;             // kRandint, kUniform or kBernoulli
  int32_t inclusive;        // randint: maxval is inclusive (hi + 1 wraps)
};

namespace {

constexpr int kThreads = 256;
constexpr int32_t kRandint = 0, kUniform = 1, kBernoulli = 2;

__device__ __forceinline__ const int32_t* at_i32(const Operand& o,
                                                 int64_t m, int64_t w) {
  return static_cast<const int32_t*>(o.ptr) + m * o.sm + w * o.sw;
}

// Word f of threefry_2x32(key, iota(F)) (`_threefry_random_bits_original`
// for F words): the counters split in halves that pair up as blocks
// (j, h + j), h = ceil(F / 2), an odd count padded with one zero
// counter; word f is the first word of block f when f < h, else the
// second word of block f - h. F = 1 is `threefry::bits`.
__device__ __forceinline__ uint32_t count_word(uint32_t k0, uint32_t k1,
                                               int F, int f) {
  const int h = (F + 1) / 2;
  const int j = f < h ? f : f - h;
  uint32_t x0 = static_cast<uint32_t>(j);
  uint32_t x1 = h + j < F ? static_cast<uint32_t>(h + j) : 0u;
  threefry::block(k0, k1, x0, x1);
  return f < h ? x0 : x1;
}

__global__ void __launch_bounds__(kThreads)
threefry_keys_kernel(const KeysParams p) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (t >= static_cast<int64_t>(p.M) * p.W) return;
  const int64_t m = t / p.W, w = t - m * p.W;
  const int32_t* kp = at_i32(p.key, m, w);
  const uint32_t k0 = static_cast<uint32_t>(kp[0]);
  const uint32_t k1 = static_cast<uint32_t>(kp[1]);
  if (p.n == 0) {   // fold_in: threefry(key, (0, word))
    uint32_t x0 = 0;
    uint32_t x1 = static_cast<uint32_t>(
        p.data.ptr != nullptr ? *at_i32(p.data, m, w) : p.word);
    threefry::block(k0, k1, x0, x1);
    int32_t* o = p.out + 2 * t;
    o[0] = static_cast<int32_t>(x0);
    o[1] = static_cast<int32_t>(x1);
    return;
  }
  // split: the counters iota(2n) as blocks (j, j + n); the flat output
  // holds the blocks' first words, then their second words
  int32_t* o = p.out + 2 * static_cast<int64_t>(p.n) * t;
  for (int j = 0; j < p.n; ++j) {
    uint32_t x0 = static_cast<uint32_t>(j);
    uint32_t x1 = static_cast<uint32_t>(j + p.n);
    threefry::block(k0, k1, x0, x1);
    o[j] = static_cast<int32_t>(x0);
    o[j + p.n] = static_cast<int32_t>(x1);
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const DrawParams p) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (t >= static_cast<int64_t>(p.M) * p.W * p.F) return;
  const int64_t mw = t / p.F;
  const int f = static_cast<int>(t - mw * p.F);
  const int64_t m = mw / p.W, w = mw - m * p.W;
  const int32_t* kp = at_i32(p.key, m, w);
  const uint32_t k0 = static_cast<uint32_t>(kp[0]);
  const uint32_t k1 = static_cast<uint32_t>(kp[1]);
  if (p.mode == kRandint) {
    // the key splits in two (blocks (0, 2) and (1, 3)): key (a0, b0)
    // draws the high words, key (a1, b1) the low ones
    uint32_t a0 = 0, a1 = 2, b0 = 1, b1 = 3;
    threefry::block(k0, k1, a0, a1);
    threefry::block(k0, k1, b0, b1);
    const uint32_t hi = count_word(a0, b0, p.F, f);
    const uint32_t lo = count_word(a1, b1, p.F, f);
    const int32_t minval =
        p.lo.ptr != nullptr ? *at_i32(p.lo, m, w) : p.lo_val;
    int32_t maxval = p.hi.ptr != nullptr ? *at_i32(p.hi, m, w) : p.hi_val;
    if (p.inclusive)
      maxval = static_cast<int32_t>(static_cast<uint32_t>(maxval) + 1u);
    static_cast<int32_t*>(p.out)[t] =
        threefry::randint_reduce(hi, lo, minval, maxval);
    return;
  }
  const float u = __uint_as_float((threefry::bits(k0, k1) >> 9)
                                  | 0x3F800000u) - 1.0f;
  if (p.mode == kUniform) {
    static_cast<float*>(p.out)[t] = u;
    return;
  }
  const float prob = p.lo.ptr != nullptr
      ? static_cast<const float*>(p.lo.ptr)[m * p.lo.sm + w * p.lo.sw]
      : p.p_val;
  static_cast<uint8_t*>(p.out)[t] = u < prob ? 1 : 0;
}

inline unsigned grid_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int threefry_keys_launch(const KeysParams* params, void* stream) {
  const KeysParams& p = *params;
  if (p.M < 0 || p.W < 0 || p.n < 0 || p.key.ptr == nullptr
      || p.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(p.M) * p.W;
  if (n == 0) return 0;
  threefry_keys_kernel<<<grid_of(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_draw_launch(const DrawParams* params, void* stream) {
  const DrawParams& p = *params;
  if (p.M < 0 || p.W < 0 || p.F < 0 || p.mode < kRandint
      || p.mode > kBernoulli || p.key.ptr == nullptr || p.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(p.M) * p.W * p.F;
  if (n == 0) return 0;
  threefry_draw_kernel<<<grid_of(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
