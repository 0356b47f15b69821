// prng: jax's threefry2x32 draws outside the step kernels (K1).
//
// Replaces the JAX package's threefry draws (madsim_tpu/core/prng.py:24
// `split`, :28 `randint`, :35 `uniform`, :39 `bernoulli`, :49
// `node_hash_key`; `jax.random.fold_in` at madsim_tpu/core/step.py:246
// and :315) where the step draws outside a kernel: the step's own keys
// (madsim_tpu/core/step.py:138 the 5-way split, :246 and :315 the
// duplicate-delivery fold_ins, :338 the extension split), the
// duplicate-delivery draws and every handler draw (core/api.py `Ctx`).
// The plain version, held equal to these kernels, is
// madsim_tpu_torch/core/prng.py (and ops/threefry.py `step_keys_plain`,
// which composes it as the step does). The kernels are built from
// threefry.cuh, whose device functions the other kernels (sched_pick,
// apply_super, emit_write, mutate) already hold exact, so the stream is
// the same by construction:
//
//   step_keys       every key the step's select, dup and super sections
//                   use, from the lane's key and halted flag, in one
//                   pass: the next key where(live, split(key, 5)[0],
//                   key), k_sched, k_handler and k_net (split(key, 5)[1],
//                   [3], [4]), fold_in(k_sched, word) for the two dup
//                   words, and the first n_write keys of
//                   split(k_super, n_ext), k_super = split(key, 5)[2]
//   threefry_keys   split(key, n) for any n >= 1 (n keys a key), or
//                   fold_in(key, word) with one word a key (n = 0)
//   threefry_draw   one draw a (key, f): randint_raw over exclusive int32
//                   bounds (or inclusive ones, the high bound wrapping),
//                   uniform, or bernoulli(p); F values a key are
//                   `random_bits(split(key, 2), (F,))`'s, as
//                   randint_raw(key, lo, hi, shape) draws them
//   dup_draws       the step's duplicate-delivery section (madsim_tpu/
//                   core/step.py:244-317) a thread a lane: the clock
//                   where(valid, max(now, dmin), now), time_over = now >
//                   tlimit, dup_fire = valid & kind == MSG &
//                   bernoulli(k_dupf, float32(dup_rate[node]) * 1e-6f),
//                   the popped row's deadline where(dup_fire, now +
//                   max(randint(k_dupd, lat_lo, lat_hi), 1), T_INF) and
//                   its free mask valid & ~dup_fire
//   split_randint   a handler's `Ctx.randint` with int bounds: split(key,
//                   2) and the inclusive randint of its second key, the
//                   next key, the drawn key and the value in one pass
//
// Operands of threefry_keys and threefry_draw are [M, W] grids over
// strided memory: element (m, w) of an operand lies at ptr + m * sm + w *
// sw (elements; a stride of 0 broadcasts), a key's two words next to each
// other. A bound or p with a null pointer is the scalar passed by value.
// Everything is uint32 arithmetic (ROADMAP F2); the bernoulli compare is
// float32 on both sides, and nothing divides (F15).
//
// Bound: each launch moves a few bytes a key (8 in, 4-64 out) and does
// one to sixteen 20-round threefry blocks a key, at the step's B=100,000
// keys a few microseconds of either: one wave, bound by its latency. So
// the step makes as few launches as it can: step_keys every key the
// step itself needs, dup_draws both of the dup section's draws and the
// elementwise ops around them (it draws only where the draw decides a
// value: the Bernoulli where the lane may fire, p > 0, the latency
// where it fired), split_randint a handler's split and its draw.
// Design: a thread a key (a key and a value for the draws), indexed in
// 32 bits (a lane's row and column by one 32-bit division only where the
// grid has more than one row); a key's blocks are independent, so where
// their count is a compile-time constant (step_keys' nine at the
// step's 2-wide extension split; a split into at most 8) they are
// unrolled and run interleaved in one thread. A key is stored as one
// 8-byte int2, so a warp's store is 256 contiguous bytes: step_keys
// writes each key of the step to its own [B, 2] tensor, a split stages
// its block's keys in shared memory and writes them out in order, a
// fold_in writes its thread's key.

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

// step_keys: out holds [6 + n_write, B, 2] keys, one [B, 2] row each:
// the next key, k_sched, k_handler, k_net, the two dup keys, and the
// extension keys 0 .. n_write - 1.
struct StepKeysParams {
  const int32_t* key;       // [B, 2], 8-byte aligned
  const uint8_t* halted;    // [B] bool
  int32_t* out;
  int32_t dup_word0, dup_word1;
  int32_t B, n_ext, n_write;
};

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

// dup_draws: the step's dup section, every operand [B] (keys [B, 2],
// 8-byte aligned; dup_rate [B, N]).
struct DupParams {
  const int32_t* k_dupf;
  const int32_t* k_dupd;
  const uint8_t* valid;       // bool
  const int32_t* ev_kind;
  const int32_t* ev_node;     // clamped to [0, N)
  const int32_t* dup_rate;
  const int32_t* now;
  const int32_t* dmin;
  const int32_t* lat_lo;
  const int32_t* lat_hi;
  const int32_t* tlimit;
  int32_t* now_out;
  uint8_t* time_over;         // bool outputs
  uint8_t* dup_fire;
  int32_t* deadline;
  uint8_t* free_row;
  int32_t B, N;
};

// split_randint: out holds [2, M * W, 2] keys (the next key, then the
// drawn key) and value [M * W] the draw in [lo, hi] inclusive.
struct SplitRandintParams {
  Operand key;        // int32 pairs
  int32_t* out;
  int32_t* value;
  int32_t lo, hi;
  int32_t M, W;
};

namespace {

constexpr int kThreads = 256;       // threefry_draw
constexpr int kKeyThreads = 128;    // the key kernels: 782 blocks at 100k
constexpr int32_t kRandint = 0, kUniform = 1, kBernoulli = 2;
constexpr int32_t kEvMsg = 1;            // core/types.py EV_MSG
constexpr int32_t kTInf = 0x7FFFFFFF;    // core/types.py T_INF

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

// (m, w) of flat index t on a [M, W] grid, in 32 bits: no division for
// a grid of one row (a batch of keys) or one column.
__device__ __forceinline__ void grid_at(uint32_t t, int32_t M, int32_t W,
                                        uint32_t& m, uint32_t& w) {
  if (M == 1) {
    m = 0;
    w = t;
  } else if (W == 1) {
    m = t;
    w = 0;
  } else {
    m = t / static_cast<uint32_t>(W);
    w = t - m * static_cast<uint32_t>(W);
  }
}

__device__ __forceinline__ void load_key(const Operand& o, uint32_t m,
                                         uint32_t w, uint32_t& k0,
                                         uint32_t& k1) {
  const int32_t* kp = at_i32(o, m, w);
  k0 = static_cast<uint32_t>(kp[0]);
  k1 = static_cast<uint32_t>(kp[1]);
}

// The N blocks of split(key, N), unrolled: block j hashes (j, j + N), and
// word w of the flat output is x0[w] for w < N, else x1[w - N].
template <int N>
__device__ __forceinline__ void split_blocks(uint32_t k0, uint32_t k1,
                                             uint32_t (&x0)[N],
                                             uint32_t (&x1)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x0[j] = static_cast<uint32_t>(j);
    x1[j] = static_cast<uint32_t>(j + N);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) threefry::block(k0, k1, x0[j], x1[j]);
}

// Key i of split(key, N) from its unrolled blocks.
template <int N>
__device__ __forceinline__ int2 split_out(const uint32_t (&x0)[N],
                                          const uint32_t (&x1)[N], int i) {
  const int a = 2 * i, b = 2 * i + 1;
  return make_int2(static_cast<int32_t>(a < N ? x0[a] : x1[a - N]),
                   static_cast<int32_t>(b < N ? x0[b] : x1[b - N]));
}

// split(key, N) for N <= 8: a thread a key, its N blocks
// unrolled; the block's keys staged in shared memory in output order,
// then stored a key an int2, consecutive threads on consecutive keys.
template <int N>
__global__ void __launch_bounds__(kKeyThreads)
threefry_keys_split(const KeysParams p) {
  __shared__ int2 stage[kKeyThreads * N];
  const uint32_t n = static_cast<uint32_t>(p.M) * p.W;
  const uint32_t t0 = blockIdx.x * kKeyThreads;
  const uint32_t t = t0 + threadIdx.x;
  if (t < n) {
    uint32_t m, w, k0, k1;
    grid_at(t, p.M, p.W, m, w);
    load_key(p.key, m, w, k0, k1);
    uint32_t x0[N], x1[N];
    split_blocks<N>(k0, k1, x0, x1);
#pragma unroll
    for (int i = 0; i < N; ++i)
      stage[threadIdx.x * N + i] = split_out<N>(x0, x1, i);
  }
  __syncthreads();
  const uint32_t here = min(n - t0, static_cast<uint32_t>(kKeyThreads)) * N;
  int2* out = reinterpret_cast<int2*>(p.out) + static_cast<size_t>(t0) * N;
  for (uint32_t i = threadIdx.x; i < here; i += kKeyThreads)
    out[i] = stage[i];
}

// split(key, n) for any n: the blocks in a loop, word by word (the
// non-partitionable stream's order: block j's first word at j, its
// second at j + n).
__global__ void __launch_bounds__(kKeyThreads)
threefry_keys_split_any(const KeysParams p) {
  const uint32_t t = blockIdx.x * kKeyThreads + threadIdx.x;
  if (t >= static_cast<uint32_t>(p.M) * p.W) return;
  uint32_t m, w, k0, k1;
  grid_at(t, p.M, p.W, m, w);
  load_key(p.key, m, w, k0, k1);
  int32_t* o = p.out + 2 * static_cast<size_t>(p.n) * t;
  for (int j = 0; j < p.n; ++j) {
    uint32_t x0 = static_cast<uint32_t>(j);
    uint32_t x1 = static_cast<uint32_t>(j + p.n);
    threefry::block(k0, k1, x0, x1);
    o[j] = static_cast<int32_t>(x0);
    o[j + p.n] = static_cast<int32_t>(x1);
  }
}

// fold_in(key, word) = threefry(key, (0, word)): a thread a key.
__global__ void __launch_bounds__(kKeyThreads)
threefry_keys_fold_in(const KeysParams p) {
  const uint32_t t = blockIdx.x * kKeyThreads + threadIdx.x;
  if (t >= static_cast<uint32_t>(p.M) * p.W) return;
  uint32_t m, w, k0, k1;
  grid_at(t, p.M, p.W, m, w);
  load_key(p.key, m, w, k0, k1);
  uint32_t x0 = 0;
  uint32_t x1 = static_cast<uint32_t>(
      p.data.ptr != nullptr ? *at_i32(p.data, m, w) : p.word);
  threefry::block(k0, k1, x0, x1);
  reinterpret_cast<int2*>(p.out)[t] = make_int2(static_cast<int32_t>(x0),
                                                static_cast<int32_t>(x1));
}

// The step's keys, a thread a lane: split(key, 5)'s five blocks, then
// the two dup fold_ins and split(k_super, NE)'s NE blocks, all unrolled
// (NE 0: any n_ext, key by key); each key one int2 store into its own
// [B, 2] row of the output.
template <int NE>
__global__ void __launch_bounds__(kKeyThreads)
step_keys_kernel(const StepKeysParams p) {
  const uint32_t b = blockIdx.x * kKeyThreads + threadIdx.x;
  if (b >= static_cast<uint32_t>(p.B)) return;
  const int2 key = reinterpret_cast<const int2*>(p.key)[b];
  const bool halted = p.halted[b] != 0;
  uint32_t x0[5], x1[5];
  split_blocks<5>(static_cast<uint32_t>(key.x), static_cast<uint32_t>(key.y),
                  x0, x1);
  const int2 sched = split_out<5>(x0, x1, 1);
  const int2 ksuper = split_out<5>(x0, x1, 2);
  const uint32_t s0 = static_cast<uint32_t>(sched.x);
  const uint32_t s1 = static_cast<uint32_t>(sched.y);
  uint32_t d0 = 0, d1 = static_cast<uint32_t>(p.dup_word0);
  uint32_t e0 = 0, e1 = static_cast<uint32_t>(p.dup_word1);
  threefry::block(s0, s1, d0, d1);
  threefry::block(s0, s1, e0, e1);
  int2* out = reinterpret_cast<int2*>(p.out);
  const size_t B = static_cast<uint32_t>(p.B);
  out[b] = halted ? key : split_out<5>(x0, x1, 0);
  out[B + b] = sched;
  out[2 * B + b] = split_out<5>(x0, x1, 3);
  out[3 * B + b] = split_out<5>(x0, x1, 4);
  out[4 * B + b] = make_int2(static_cast<int32_t>(d0),
                             static_cast<int32_t>(d1));
  out[5 * B + b] = make_int2(static_cast<int32_t>(e0),
                             static_cast<int32_t>(e1));
  const uint32_t u0 = static_cast<uint32_t>(ksuper.x);
  const uint32_t u1 = static_cast<uint32_t>(ksuper.y);
  if constexpr (NE > 0) {
    uint32_t y0[NE], y1[NE];
    split_blocks<NE>(u0, u1, y0, y1);
#pragma unroll
    for (int i = 0; i < NE; ++i)
      if (i < p.n_write) out[(6 + i) * B + b] = split_out<NE>(y0, y1, i);
  } else {
    for (int i = 0; i < p.n_write; ++i) {
      uint32_t a, c;
      threefry::split_key(u0, u1, p.n_ext, i, a, c);
      out[(6 + i) * B + b] = make_int2(static_cast<int32_t>(a),
                                       static_cast<int32_t>(c));
    }
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

// The dup section, a thread a lane. The Bernoulli draw decides only
// where the lane may fire (valid, a message, p > 0: u >= 0 is never
// below p <= 0), the latency draw only where it fired, so each is drawn
// there alone; the values are the reference's everywhere.
__global__ void __launch_bounds__(kKeyThreads)
dup_draws_kernel(const DupParams p) {
  const uint32_t b = blockIdx.x * kKeyThreads + threadIdx.x;
  if (b >= static_cast<uint32_t>(p.B)) return;
  const bool valid = __ldg(p.valid + b) != 0;
  const int32_t now0 = __ldg(p.now + b);
  const int32_t dmin = __ldg(p.dmin + b);
  const int32_t now = valid ? (dmin > now0 ? dmin : now0) : now0;
  bool fire = false;
  if (valid && __ldg(p.ev_kind + b) == kEvMsg) {
    const int32_t nd = __ldg(p.ev_node + b);     // take1 clamps
    const int32_t rate = __ldg(p.dup_rate + static_cast<size_t>(b) * p.N
                               + (nd < 0 ? 0 : (nd >= p.N ? p.N - 1 : nd)));
    const float prob = __fmul_rn(static_cast<float>(rate), 1e-6f);
    if (prob > 0.0f) {
      const int2 k = __ldg(reinterpret_cast<const int2*>(p.k_dupf) + b);
      fire = threefry::bernoulli(static_cast<uint32_t>(k.x),
                                 static_cast<uint32_t>(k.y), prob);
    }
  }
  int32_t deadline = kTInf;
  if (fire) {       // the redelivery: a fresh latency draw, at least 1
    const int2 k = __ldg(reinterpret_cast<const int2*>(p.k_dupd) + b);
    const int32_t lat = threefry::randint(
        static_cast<uint32_t>(k.x), static_cast<uint32_t>(k.y),
        __ldg(p.lat_lo + b), __ldg(p.lat_hi + b));
    deadline = static_cast<int32_t>(static_cast<uint32_t>(now)
                                    + static_cast<uint32_t>(
                                        lat > 1 ? lat : 1));
  }
  p.now_out[b] = now;
  p.time_over[b] = now > __ldg(p.tlimit + b) ? 1 : 0;
  p.dup_fire[b] = fire ? 1 : 0;
  p.deadline[b] = deadline;
  p.free_row[b] = valid && !fire ? 1 : 0;
}

// split(key, 2) (blocks (0, 2) and (1, 3)) and randint(key 1, lo, hi)
// inclusive, a thread a key: six blocks, each key one int2 store.
__global__ void __launch_bounds__(kKeyThreads)
split_randint_kernel(const SplitRandintParams p) {
  const uint32_t n = static_cast<uint32_t>(p.M) * p.W;
  const uint32_t t = blockIdx.x * kKeyThreads + threadIdx.x;
  if (t >= n) return;
  uint32_t m, w, k0, k1;
  grid_at(t, p.M, p.W, m, w);
  load_key(p.key, m, w, k0, k1);
  uint32_t x0[2], x1[2];
  split_blocks<2>(k0, k1, x0, x1);
  const int2 next = split_out<2>(x0, x1, 0);
  const int2 drawn = split_out<2>(x0, x1, 1);
  int2* out = reinterpret_cast<int2*>(p.out);
  out[t] = next;
  out[n + t] = drawn;
  p.value[t] = threefry::randint(static_cast<uint32_t>(drawn.x),
                                 static_cast<uint32_t>(drawn.y), p.lo, p.hi);
}

inline unsigned grid_of(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int threefry_keys_launch(const KeysParams* params, void* stream) {
  const KeysParams& p = *params;
  if (p.M < 0 || p.W < 0 || p.n < 0 || p.key.ptr == nullptr
      || p.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(p.M) * p.W;
  if (n == 0) return 0;
  // keys and output words indexed in 32 bits
  if (2 * n * (p.n > 0 ? p.n : 1) >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = grid_of(n, kKeyThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.n) {
    case 0: threefry_keys_fold_in<<<grid, kKeyThreads, 0, s>>>(p); break;
    case 1: threefry_keys_split<1><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 2: threefry_keys_split<2><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 3: threefry_keys_split<3><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 4: threefry_keys_split<4><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 5: threefry_keys_split<5><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 6: threefry_keys_split<6><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 7: threefry_keys_split<7><<<grid, kKeyThreads, 0, s>>>(p); break;
    case 8: threefry_keys_split<8><<<grid, kKeyThreads, 0, s>>>(p); break;
    default: threefry_keys_split_any<<<grid, kKeyThreads, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int step_keys_launch(const StepKeysParams* params, void* stream) {
  const StepKeysParams& p = *params;
  if (p.B < 0 || p.n_ext < 1 || p.n_write < 1 || p.n_write > p.n_ext
      || p.key == nullptr || p.halted == nullptr || p.out == nullptr
      || reinterpret_cast<uintptr_t>(p.key) % 8 != 0
      || reinterpret_cast<uintptr_t>(p.out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B == 0) return 0;
  const unsigned grid = grid_of(p.B, kKeyThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the step's extension split is 2 wide unless it has two or more
  // extensions
  if (p.n_ext == 2)
    step_keys_kernel<2><<<grid, kKeyThreads, 0, s>>>(p);
  else
    step_keys_kernel<0><<<grid, kKeyThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_draw_launch(const DrawParams* params, void* stream) {
  const DrawParams& p = *params;
  if (p.M < 0 || p.W < 0 || p.F < 0 || p.mode < kRandint
      || p.mode > kBernoulli || p.key.ptr == nullptr || p.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(p.M) * p.W * p.F;
  if (n == 0) return 0;
  threefry_draw_kernel<<<grid_of(n, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dup_draws_launch(const DupParams* params, void* stream) {
  const DupParams& p = *params;
  if (p.B < 0 || p.N < 1 || p.k_dupf == nullptr || p.k_dupd == nullptr
      || reinterpret_cast<uintptr_t>(p.k_dupf) % 8 != 0
      || reinterpret_cast<uintptr_t>(p.k_dupd) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B == 0) return 0;
  dup_draws_kernel<<<grid_of(p.B, kKeyThreads), kKeyThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int split_randint_launch(const SplitRandintParams* params,
                                    void* stream) {
  const SplitRandintParams& p = *params;
  if (p.M < 0 || p.W < 0 || p.key.ptr == nullptr || p.out == nullptr
      || p.value == nullptr || reinterpret_cast<uintptr_t>(p.out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(p.M) * p.W;
  if (n == 0) return 0;
  if (4 * n >= (int64_t{1} << 31))     // output words indexed in 32 bits
    return static_cast<int>(cudaErrorInvalidValue);
  split_randint_kernel<<<grid_of(n, kKeyThreads), kKeyThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
