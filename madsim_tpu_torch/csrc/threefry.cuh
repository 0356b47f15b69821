// threefry.cuh: jax's threefry2x32 random stream as CUDA device functions.
//
// The counterpart of madsim_tpu_torch/core/prng.py (and of jax's
// NON-partitionable threefry stream, `jax_threefry_partitionable=False`,
// the stream the JAX package's golden digests were recorded under), bit
// for bit, for the kernels that draw inside a lane:
//
//   block          the threefry2x32 block function, 20 rounds
//   split_key      key i of `split(key, n)`
//   bits           `random_bits(key, ())`: 32 bits
//   randint_raw    `randint(key, (), minval, maxval)`, jax's two-draw
//                  span / multiplier reduction, uint32 wrap throughout;
//                  its halves randint_bits (the draws, from the key
//                  alone) and randint_reduce (the span)
//   bits_at        word f of `random_bits(key, (n,))`
//   randint_raw_at element f of `randint(key, (n,), minval, maxval)`
//   randint        the same over [lo, hi] INCLUSIVE (prng.randint)
//   bernoulli      `uniform(key) < p` in float32
//
// Words are uint32; keys are (k0, k1) pairs.

#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32 block function, 20 rounds (jax _threefry2x32_lowering)
__device__ __forceinline__ void block(uint32_t k0, uint32_t k1,
                                      uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// Word w of `split(key, n)`'s flat output. The non-partitionable split
// hashes the counters iota(2n) in ONE call whose two halves pair up as
// blocks (j, j + n), j < n, and concatenates the blocks' first words
// before their second words: word w is the first word of block w when
// w < n, else the second word of block w - n.
__device__ __forceinline__ uint32_t split_word(uint32_t k0, uint32_t k1,
                                               int n, int w) {
  const int j = w < n ? w : w - n;
  uint32_t x0 = static_cast<uint32_t>(j);
  uint32_t x1 = static_cast<uint32_t>(j + n);
  block(k0, k1, x0, x1);
  return w < n ? x0 : x1;
}

// Key i of `split(key, n)`: words 2i and 2i + 1 of the flat output.
__device__ __forceinline__ void split_key(uint32_t k0, uint32_t k1, int n,
                                          int i, uint32_t& o0,
                                          uint32_t& o1) {
  o0 = split_word(k0, k1, n, 2 * i);
  o1 = split_word(k0, k1, n, 2 * i + 1);
}

// `random_bits(key, ())`: one word (the count iota(1) is padded to two
// zero words: block (0, 0), first word).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1) {
  uint32_t x0 = 0, x1 = 0;
  block(k0, k1, x0, x1);
  return x0;
}

// The two 32-bit draws of jax.random.randint(key, ...): the key splits in
// two (blocks (0, 2) and (1, 3)) and 32 bits are drawn from each half.
// They depend on the key alone, so a kernel can draw them before it
// knows the span.
__device__ __forceinline__ void randint_bits(uint32_t k0, uint32_t k1,
                                             uint32_t& hi, uint32_t& lo) {
  uint32_t a0 = 0, a1 = 2, b0 = 1, b1 = 3;
  block(k0, k1, a0, a1);
  block(k0, k1, b0, b1);
  hi = bits(a0, b0);   // first half key (a0, b0)
  lo = bits(a1, b1);   // second half key (a1, b1)
}

// The draws reduced modulo the span [minval, maxval) with jax's
// multiplier, all in uint32: minval when maxval <= minval.
__device__ __forceinline__ int32_t randint_reduce(uint32_t hi, uint32_t lo,
                                                  int32_t minval,
                                                  int32_t maxval) {
  const uint32_t span = maxval <= minval
      ? 1u : static_cast<uint32_t>(maxval) - static_cast<uint32_t>(minval);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((hi % span) * mult + (lo % span)) % span;
  return static_cast<int32_t>(static_cast<uint32_t>(minval) + off);
}

// jax.random.randint(key, (), minval, maxval, int32).
__device__ __forceinline__ int32_t randint_raw(uint32_t k0, uint32_t k1,
                                               int32_t minval,
                                               int32_t maxval) {
  uint32_t hi, lo;
  randint_bits(k0, k1, hi, lo);
  return randint_reduce(hi, lo, minval, maxval);
}

// Word f of `random_bits(key, (n,))`: the counts iota(n), padded with one
// zero word when n is odd, split in two halves of h words that pair up
// as blocks (j, j + h); the blocks' first words come before their second
// words, so word f is the first word of block f when f < h, else the
// second word of block f - h.
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, int n,
                                            int f) {
  const int h = (n + 1) / 2;
  const int j = f < h ? f : f - h;
  uint32_t x0 = static_cast<uint32_t>(j);
  uint32_t x1 = j + h < n ? static_cast<uint32_t>(j + h) : 0u;
  block(k0, k1, x0, x1);
  return f < h ? x0 : x1;
}

// Element f of `jax.random.randint(key, (n,), minval, maxval, int32)`:
// both halves of split(key, 2) draw n words, and word f of each is
// reduced as the scalar draw's.
__device__ __forceinline__ int32_t randint_raw_at(uint32_t k0, uint32_t k1,
                                                  int n, int f,
                                                  int32_t minval,
                                                  int32_t maxval) {
  uint32_t a0, a1, b0, b1;
  split_key(k0, k1, 2, 0, a0, a1);
  split_key(k0, k1, 2, 1, b0, b1);
  return randint_reduce(bits_at(a0, a1, n, f), bits_at(b0, b1, n, f),
                        minval, maxval);
}

// prng.randint: uniform int32 in [lo, hi] INCLUSIVE (hi + 1 wraps in
// int32, as the reference's does).
__device__ __forceinline__ int32_t randint(uint32_t k0, uint32_t k1,
                                           int32_t lo, int32_t hi) {
  const int32_t maxval =
      static_cast<int32_t>(static_cast<uint32_t>(hi) + 1u);
  return randint_raw(k0, k1, lo, maxval);
}

// uniform(key) < p: the float32 in [1, 2) built from the top 23 bits,
// minus 1 (exact), compared in float32.
__device__ __forceinline__ bool bernoulli(uint32_t k0, uint32_t k1,
                                          float p) {
  const float u = __uint_as_float((bits(k0, k1) >> 9) | 0x3F800000u) - 1.0f;
  return u < p;
}

}  // namespace threefry
