// mutate: the havoc mutation engine of the schedule fuzzer, a tile of
// lanes a block, staged through shared memory.
//
// Replaces the JAX package's `_mutate_batch` / `_mutate_batch_masked`
// (madsim_tpu/search/mutate.py:471,482; body `_mutate_one` at :344), with
// jax's threefry2x32 draws (madsim_tpu/core/prng.py) from threefry.cuh.
// Lane b takes key b of split(key, B); havoc step h takes key h of
// split(lane_key, havoc) and splits it 16 ways (ks[0..15]); ks[0] draws
// the operator in [0, 8) and the operator draws from its own ks:
//
//   0 time nudge      row r = choice(ks[1], time_ok); mag = randint(ks[2],
//                     6, 20); raw = randint(ks[3], 0, 1 << mag); sign =
//                     bernoulli(ks[4], 0.5): row_time[r] += +-(raw + 1)
//   1 target          row r = choice(ks[5], node_ok); cand = randint(ks[6],
//                     -1, N - 1): row_node[r] = cand if pool_ok[r][cand+1]
//                     else NODE_RANDOM
//   2 toggle          row r = choice(ks[7], drop_ok): row_on[r] ^= 1
//   3 dup             slot d = randint(ks[8], 0, D - 1); row s =
//                     choice(ks[9], drop_ok); near = randint(ks[10],
//                     -200 ms, 200 ms): dup_on[d] ^= 1, and where it turns
//                     on, dup_src[d] = s, dup_time[d] = row_time[s] + near
//   4 latency         dlo = randint(ks[2], +-5000), dhi = randint(ks[3],
//                     +-20000): lat_lo += dlo, lat_hi += dhi, jitter += dlo
//   5 loss            u = uniform(ks[4]), reset = bernoulli(ks[7], 0.2):
//                     loss = 0 or clip(fma(u - 0.5, 0.2f, loss), 0,
//                     max(0.9, loss)) — XLA contracts the reference's
//                     float32 expression into this one fma (see
//                     ops/mutate.py)
//   6 priority        prio_nudge = randint(ks[11], -2^31 + 1, 2^31 - 1)
//   7 fault           row r = choice(ks[12], val_ok | dir_ok | torn_ok);
//                     flag toggle where it has a flag and (bernoulli(ks[13],
//                     0.35) or no value), else row_val[r] += randint(ks[14],
//                     -8, 8) * max(span / 64, 1)
//
// choice(k, mask) is jax's masked_choice: the randint(k, 0, count)-th set
// row, row 0 when none is set. An operator applies when its guard found a
// row (0-3, 7) or always (4-6); every step also clips row_time to
// [0, T_INF - 1] (after operator 0's sum, before operator 3 reads it) and
// row_val to [val_lo, val_hi] (after operator 7's sum). Clipping is
// idempotent, so only the first step clips every row; with havoc = 0
// nothing is clipped. hist counts applied operators over the batch
// (integer atomics, order-independent); last_op is the lane's last
// applied operator. A masked-off lane is copied as it is, counts nothing
// and gets last_op -1.
//
// Bound: bytes (each lane's knob vector read once and written once, 599
// bytes at the flagship's R = 33, D = 2: 0.036 ms at B = 100,000) against
// operations (the threefry blocks, ~80 integer operations each; a step's
// key, operator subkey and operator draw take 7 or 8 blocks, the
// operator's own draws 3 to 21). A first version, a thread a lane editing
// its rows in device memory, took 1.19 ms at the flagship's first mutated
// round on an NVIDIA H100 80GB HBM3 at 700 W: every row access was a warp
// request over 32 lanes 132 bytes apart, and the operator switch ran a
// warp's up to eight branches, with their draws, one after another. With
// havoc 0 this kernel only copies the tile through shared memory; each
// havoc step adds about 0.009 ms of draws, near the card's integer rate.
//
// Design, for both:
//   - A block takes a tile of T consecutive lanes (T a multiple of 32,
//     chosen by the wrapper from R, D and N so that the tile fits in
//     shared memory). Each knob array's tile is one contiguous range. The
//     block starts its copy into shared memory at once, 16-byte
//     `cp.async` where every knob array is 16-byte aligned (`vec`), else
//     an element at a time, and waits for it only before the edits: the
//     draws below read no row, so they run while the tile is in flight.
//     The lanes edit their rows in shared memory, and the block stores
//     the tile back with 16-byte accesses (where `vec`).
//   - A lane's draws depend on its key and the guards alone, never on its
//     rows (a draw is a stateless function of its key, and the reference
//     draws every one of them), so they run before the edits, in kGroup
//     threads a lane: thread j of a lane takes step h0 + j of each chunk
//     of kGroup steps, draws the step's key and operator, and puts the
//     operator's own draws (one to four: randint draws in slots A-C,
//     single words in D-E, below) on two block-wide lists. Every thread of
//     the block then takes list entries alike, so a warp runs one kind of
//     draw at a time where a thread a lane would run each operator's
//     branch in turn, and no lane draws what its operator does not use.
//     One thread a lane then applies the chunk's steps in order; the
//     first step's clip of every row runs before, the lane's kGroup
//     threads side by side, and leaves out the one row whose first-step
//     sum (operator 0, or 7 on a value) clips itself.
//   - The guards are loaded into registers at the start and staged in
//     shared memory while the first step's keys are drawn; four warps
//     then list their set rows with ballots.
//   - At most 64 registers a thread, so that four 64-lane blocks share
//     an SM.

#include <cstdint>

#include "threefry.cuh"

// The launch parameters, field for field the ctypes structure of the
// wrapper (it names this struct); outside the unnamed namespace so that
// the C entry point keeps external linkage.
struct MutateParams {
  const int32_t* in_row_time;
  const int32_t* in_row_node;
  const uint8_t* in_row_on;
  const int32_t* in_row_val;
  const int32_t* in_row_flag;
  const int32_t* in_dup_src;
  const int32_t* in_dup_time;
  const uint8_t* in_dup_on;
  const float* in_loss;
  const int32_t* in_lat_lo;
  const int32_t* in_lat_hi;
  const int32_t* in_jitter;
  const int32_t* in_prio_nudge;
  int32_t* out_row_time;
  int32_t* out_row_node;
  uint8_t* out_row_on;
  int32_t* out_row_val;
  int32_t* out_row_flag;
  int32_t* out_dup_src;
  int32_t* out_dup_time;
  uint8_t* out_dup_on;
  float* out_loss;
  int32_t* out_lat_lo;
  int32_t* out_lat_hi;
  int32_t* out_jitter;
  int32_t* out_prio_nudge;
  const uint8_t* time_ok;
  const uint8_t* node_ok;
  const uint8_t* drop_ok;
  const uint8_t* pool_ok;   // [R, N + 1]
  const uint8_t* val_ok;
  const int32_t* val_lo;
  const int32_t* val_hi;
  const uint8_t* dir_ok;
  const uint8_t* torn_ok;
  const uint32_t* key;      // [2]
  const uint8_t* mask;      // [B] or null
  int32_t* hist;            // [8], zeroed by the caller
  int32_t* last_op;         // [B]
  int B, R, D, N, havoc;
  int tile;                 // T lanes a block
  int smem;                 // dynamic shared memory bytes (tile_layout)
  int vec;                  // every knob array 16-byte aligned
};

namespace {

constexpr int kGroup = 4;          // threads a lane while drawing
constexpr int kMaxTile = 128;
constexpr int kSmemMax = 231424;   // 226 KB: a block's 227 less static
constexpr int kOps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kTimeMax = 2147483646;   // T_INF - 1
constexpr int32_t kLatCap = 30000000;
constexpr int32_t kJitCap = 1000000;
constexpr int32_t kNodeRandom = -1;

// Byte offsets of the shared-memory regions of a T-lane tile, each
// 16-byte aligned (ops/mutate.py `mutate_smem` lays out the same):
// the guard lists [4][R], val_lo, val_hi [R], the guard flags [R], the
// pool [R][N + 1], the draws [kGroup][T] (48 bytes; once used, their
// first 16 hold the step's edit values), the lists of randint draws
// [3 kGroup T] and of word draws [2 kGroup T] (uint16), the lane keys [T]
// uint2, then the tile's knob rows.
struct Layout {
  long long list, lo, hi, flags, pool, draws, rlist, wlist, keys, rt, rn,
      rv, rf, ron, ds, dt, don, total;
};

__host__ __device__ inline long long up16(long long x) {
  return (x + 15) & ~15LL;
}

__host__ __device__ inline Layout tile_layout(long long T, long long R,
                                              long long D, long long N) {
  Layout L;
  long long o = 0;
  L.list = o; o += up16(16 * R);
  L.lo = o; o += up16(4 * R);
  L.hi = o; o += up16(4 * R);
  L.flags = o; o += up16(R);
  L.pool = o; o += up16(R * (N + 1));
  L.draws = o; o += 48 * T * kGroup;
  L.rlist = o; o += up16(2 * 3 * T * kGroup);
  L.wlist = o; o += up16(2 * 2 * T * kGroup);
  L.keys = o; o += 8 * T;
  L.rt = o; o += up16(4 * T * R);
  L.rn = o; o += up16(4 * T * R);
  L.rv = o; o += up16(4 * T * R);
  L.rf = o; o += up16(4 * T * R);
  L.ron = o; o += up16(T * R);
  L.ds = o; o += up16(4 * T * D);
  L.dt = o; o += up16(4 * T * D);
  L.don = o; o += up16(T * D);
  L.total = o;
  return L;
}

// Each slot's subkey index by operator, a nibble an operator (15: the
// operator has no draw in this slot). A, B and C hold randint draws, D and
// E single words (bernoulli, uniform); an operator fills the first of
// each.
constexpr uint32_t pack8(int o0, int o1, int o2, int o3, int o4, int o5,
                         int o6, int o7) {
  return static_cast<uint32_t>(o0) | static_cast<uint32_t>(o1) << 4
      | static_cast<uint32_t>(o2) << 8 | static_cast<uint32_t>(o3) << 12
      | static_cast<uint32_t>(o4) << 16 | static_cast<uint32_t>(o5) << 20
      | static_cast<uint32_t>(o6) << 24 | static_cast<uint32_t>(o7) << 28;
}
constexpr uint32_t kSlotA = pack8(1, 5, 7, 9, 2, 15, 11, 12);
constexpr uint32_t kSlotB = pack8(2, 6, 15, 8, 3, 15, 15, 14);
constexpr uint32_t kSlotC = pack8(3, 15, 15, 10, 15, 15, 15, 15);
constexpr uint32_t kSlotD = pack8(4, 15, 15, 15, 15, 7, 15, 13);
constexpr uint32_t kSlotE = pack8(15, 15, 15, 15, 15, 4, 15, 15);
// how many of slots A, B, C (randint draws) and of D, E (words) each
// operator fills: always the first ones
constexpr uint32_t kRandints = pack8(3, 2, 1, 3, 2, 0, 1, 2);
constexpr uint32_t kWords = pack8(1, 0, 0, 0, 0, 2, 0, 1);

__device__ __forceinline__ int nibble(uint32_t table, int op) {
  return static_cast<int>((table >> (4 * op)) & 15u);
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}

// jnp.maximum / jnp.minimum on float32: NaN propagates
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// uniform(key) from its 32 bits: the float32 in [1, 2) from the top 23
// bits, minus 1
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Start the copy of a tile's range of n elements from device memory to
// its region of shared memory, the block's threads side by side: 16 bytes
// a `cp.async` where `vec` (both ends 16-byte aligned), which the block
// waits for only before its edits; the rest an element at a time.
template <typename E>
__device__ __forceinline__ void load_range(E* dst, const E* src, int n,
                                           bool vec) {
  int done = 0;
  if (vec) {
    const int nv = n * static_cast<int>(sizeof(E)) / 16;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(
          reinterpret_cast<int4*>(dst) + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d), "l"(reinterpret_cast<const int4*>(src) + i)
                   : "memory");
    }
    done = nv * 16 / static_cast<int>(sizeof(E));
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Copy n elements of a tile's region of shared memory back to its range
// in device memory, 16 bytes an access where `vec`.
template <typename E>
__device__ __forceinline__ void store_range(E* dst, const E* src, int n,
                                            bool vec) {
  int done = 0;
  if (vec) {
    const int nv = n * static_cast<int>(sizeof(E)) / 16;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
    done = nv * 16 / static_cast<int>(sizeof(E));
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

struct Guards {
  const int32_t* list;     // [4][R]: time_ok, node_ok, drop_ok, fault
  const int32_t* count;    // [4]
  int R;
};

// jax masked_choice over guard `which` from a randint's two draws: the
// chosen row, -1 when the guard has no set row
__device__ __forceinline__ int32_t choose(const Guards& g, int which,
                                          uint32_t hi, uint32_t lo) {
  const int32_t n = g.count[which];
  const int32_t r = threefry::randint_reduce(hi, lo, 0, n > 0 ? n : 1);
  return n > 0 ? g.list[which * g.R + r] : -1;
}

// randint(k, 0, 7), the operator: a span of 8 divides 2^16, so jax's
// multiplier is 0 and only the second of randint's two draws decides it
// (three threefry blocks where randint takes four)
__device__ __forceinline__ int op_draw(uint32_t k0, uint32_t k1) {
  uint32_t a0 = 0, a1 = 2, b0 = 1, b1 = 3;
  threefry::block(k0, k1, a0, a1);
  threefry::block(k0, k1, b0, b1);
  return static_cast<int>(threefry::bits(a1, b1) & 7u);
}

// A (lane, step) item's draws: its step key, its operator, then its slots'
// randint draws (A, B, C: the two words of each) and single words (D, E).
struct Draws {
  uint2 key;
  int32_t op;
  int32_t pad;
  uint2 r[3];
  uint32_t w[2];
};

// The values a step's edit needs, from its draws, {op, a, b, c}:
//   0 {row or -1, delta}        1 {row or -1, cand}     2 {row or -1}
//   3 {row s or -1, slot d, near}                        4 {dlo, dhi}
//   5 {reset, uniform's float bits}                      6 {prio}
//   7 {row or -1, want flag, step}
__device__ int4 edit_values(const Draws& d, const Guards& g, int N, int D) {
  using threefry::randint_reduce;
  const int op = d.op;
  int4 r = make_int4(op, 0, 0, 0);
  switch (op) {
    case 0: {
      r.y = choose(g, 0, d.r[0].x, d.r[0].y);
      const int32_t mag = randint_reduce(d.r[1].x, d.r[1].y, 6, 21);
      const int32_t raw = randint_reduce(d.r[2].x, d.r[2].y, 0, 1 << mag);
      r.z = unit_float(d.w[0]) < 0.5f ? add32(raw, 1) : -add32(raw, 1);
      break;
    }
    case 1:
      r.y = choose(g, 1, d.r[0].x, d.r[0].y);
      r.z = randint_reduce(d.r[1].x, d.r[1].y, -1, N);
      break;
    case 2:
      r.y = choose(g, 2, d.r[0].x, d.r[0].y);
      break;
    case 3:
      r.y = D > 0 ? choose(g, 2, d.r[0].x, d.r[0].y) : -1;
      r.z = randint_reduce(d.r[1].x, d.r[1].y, 0, D);
      r.w = randint_reduce(d.r[2].x, d.r[2].y, -200000, 200001);
      break;
    case 4:
      r.y = randint_reduce(d.r[0].x, d.r[0].y, -5000, 5001);
      r.z = randint_reduce(d.r[1].x, d.r[1].y, -20000, 20001);
      break;
    case 5:
      r.y = unit_float(d.w[0]) < 0.2f;
      r.z = __float_as_int(unit_float(d.w[1]));
      break;
    case 6:
      r.y = randint_reduce(d.r[0].x, d.r[0].y, -2147483647, 2147483647);
      break;
    default:
      r.y = choose(g, 3, d.r[0].x, d.r[0].y);
      r.z = unit_float(d.w[0]) < 0.35f;
      r.w = randint_reduce(d.r[1].x, d.r[1].y, -8, 9);
      break;
  }
  return r;
}

// At most 64 registers a thread (two blocks of kMaxTile * kGroup threads
// an SM), so four blocks of 64-lane tiles (256 threads) fit an SM.
__global__ void __launch_bounds__(kMaxTile * kGroup, 2)
mutate_kernel(const MutateParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t counts[4];
  __shared__ int32_t hist_s[kOps];
  __shared__ int32_t n_r, n_w;      // entries of rlist, wlist
  const int T = p.tile, R = p.R, D = p.D, N = p.N;
  const Layout L = tile_layout(T, R, D, N);
  int32_t* list = reinterpret_cast<int32_t*>(smem + L.list);
  int32_t* lo = reinterpret_cast<int32_t*>(smem + L.lo);
  int32_t* hi = reinterpret_cast<int32_t*>(smem + L.hi);
  uint8_t* flags = smem + L.flags;   // bit 0 val_ok, bit 1 dir | torn
  uint8_t* pool = smem + L.pool;
  Draws* draws = reinterpret_cast<Draws*>(smem + L.draws);
  uint16_t* rlist = reinterpret_cast<uint16_t*>(smem + L.rlist);
  uint16_t* wlist = reinterpret_cast<uint16_t*>(smem + L.wlist);
  uint2* keys = reinterpret_cast<uint2*>(smem + L.keys);
  int32_t* row_time = reinterpret_cast<int32_t*>(smem + L.rt);
  int32_t* row_node = reinterpret_cast<int32_t*>(smem + L.rn);
  int32_t* row_val = reinterpret_cast<int32_t*>(smem + L.rv);
  int32_t* row_flag = reinterpret_cast<int32_t*>(smem + L.rf);
  uint8_t* row_on = smem + L.ron;
  int32_t* dup_src = reinterpret_cast<int32_t*>(smem + L.ds);
  int32_t* dup_time = reinterpret_cast<int32_t*>(smem + L.dt);
  uint8_t* dup_on = smem + L.don;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const int b0 = blockIdx.x * T;
  const int nt = min(T, p.B - b0);       // lanes of this tile
  const bool vec = p.vec != 0;

  // ---- the tile's rows into shared memory (in flight), the guards -------
  const size_t rows0 = static_cast<size_t>(b0) * R;
  const size_t dups0 = static_cast<size_t>(b0) * D;
  load_range(row_time, p.in_row_time + rows0, nt * R, vec);
  load_range(row_node, p.in_row_node + rows0, nt * R, vec);
  load_range(row_val, p.in_row_val + rows0, nt * R, vec);
  load_range(row_flag, p.in_row_flag + rows0, nt * R, vec);
  load_range(row_on, p.in_row_on + rows0, nt * R, vec);
  load_range(dup_src, p.in_dup_src + dups0, nt * D, vec);
  load_range(dup_time, p.in_dup_time + dups0, nt * D, vec);
  load_range(dup_on, p.in_dup_on + dups0, nt * D, vec);
  // the guards' row tid, into registers now and into shared memory once
  // the first step's keys are drawn (their loads' wait falls there)
  uint8_t g_time = 0, g_node = 0, g_drop = 0, g_val = 0, g_dir = 0,
      g_torn = 0, g_pool = 0;
  int32_t g_lo = 0, g_hi = 0;
  if (tid < R) {
    g_time = p.time_ok[tid];
    g_node = p.node_ok[tid];
    g_drop = p.drop_ok[tid];
    g_val = p.val_ok[tid];
    g_dir = p.dir_ok[tid];
    g_torn = p.torn_ok[tid];
    g_lo = p.val_lo[tid];
    g_hi = p.val_hi[tid];
  }
  if (tid < R * (N + 1)) g_pool = p.pool_ok[tid];
  if (tid < kOps) hist_s[tid] = 0;
  if (tid == 0) n_r = n_w = 0;
  const int lane = tid % T;
  const int j = tid / T;
  const int b = b0 + lane;
  const bool in_tile = lane < nt;
  const bool active = in_tile && (p.mask == nullptr || p.mask[b]);
  if (j == 0 && active && p.havoc > 0) {   // the lane's key, drawn once
    uint2 k;
    threefry::split_key(p.key[0], p.key[1], p.B, b, k.x, k.y);
    keys[lane] = k;
  }
  __syncthreads();       // the lane keys (the tile's copies in flight)

  // ---- draws (kGroup threads a lane), then edits (one thread a lane) -----
  const Guards g{list, counts, R};
  const uint2 lk = active && p.havoc > 0 ? keys[lane] : make_uint2(0, 0);
  float loss = 0.0f;
  int32_t lat_lo = 0, lat_hi = 0, jitter = 0, prio = 0, last = -1;
  if (j == 0 && in_tile) {
    loss = p.in_loss[b];
    lat_lo = p.in_lat_lo[b];
    lat_hi = p.in_lat_hi[b];
    jitter = p.in_jitter[b];
    prio = p.in_prio_nudge[b];
  }
  int32_t* rt = row_time + lane * R;
  int32_t* rv = row_val + lane * R;
  for (int h0 = 0; h0 < p.havoc; h0 += kGroup) {
    // the step's key and operator; the draws its operator needs go on the
    // lists (a warp's share at once: a scan of both counts, one int)
    const bool mine = active && h0 + j < p.havoc;
    int need = 0;
    if (mine) {
      uint32_t s0, s1, k0, k1;
      threefry::split_key(lk.x, lk.y, p.havoc, h0 + j, s0, s1);
      threefry::split_key(s0, s1, 16, 0, k0, k1);
      const int op = op_draw(k0, k1);
      draws[tid].key = make_uint2(s0, s1);
      draws[tid].op = op;
      need = nibble(kRandints, op) | nibble(kWords, op) << 16;
    }
    int incl = need;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (wl >= o) incl += v;
    }
    int base = 0;
    if (wl == 31)
      base = atomicAdd(&n_r, incl & 0xFFFF)
          | atomicAdd(&n_w, incl >> 16) << 16;
    base = __shfl_sync(kFull, base, 31) + incl - need;
    for (int k = 0; k < (need & 0xFFFF); ++k)
      rlist[(base & 0xFFFF) + k] = static_cast<uint16_t>(4 * tid + k);
    for (int k = 0; k < need >> 16; ++k)
      wlist[(base >> 16) + k] = static_cast<uint16_t>(2 * tid + k);
    if (h0 == 0) {         // the guards into shared memory
      auto stage = [&](int r, uint8_t t, uint8_t n, uint8_t d, uint8_t v,
                       uint8_t dt, uint8_t tn, int32_t l, int32_t h) {
        lo[r] = l;
        hi[r] = h;
        flags[r] = (v ? 1 : 0) | (dt | tn ? 2 : 0) | (t ? 4 : 0)
            | (n ? 8 : 0) | (d ? 16 : 0);
      };
      if (tid < R)
        stage(tid, g_time, g_node, g_drop, g_val, g_dir, g_torn, g_lo, g_hi);
      for (int r = tid + blockDim.x; r < R; r += blockDim.x)
        stage(r, p.time_ok[r], p.node_ok[r], p.drop_ok[r], p.val_ok[r],
              p.dir_ok[r], p.torn_ok[r], p.val_lo[r], p.val_hi[r]);
      if (tid < R * (N + 1)) pool[tid] = g_pool;
      for (int i = tid + blockDim.x; i < R * (N + 1); i += blockDim.x)
        pool[i] = p.pool_ok[i];
    }
    __syncthreads();
    if (h0 == 0 && warp < 4) {     // warp w lists guard w's set rows
      int c = 0;
      for (int r0 = 0; r0 < R; r0 += 32) {
        const int r = r0 + wl;
        const bool on = r < R
            && (flags[r] & (warp == 0 ? 4 : warp == 1 ? 8 : warp == 2 ? 16
                            : 3)) != 0;
        const unsigned m = __ballot_sync(kFull, on);
        if (on) list[warp * R + c + __popc(m & ((1u << wl) - 1u))] = r;
        c += __popc(m);
      }
      if (wl == 0) counts[warp] = c;
    }
    // the draws, every thread of the block taking list entries alike
    const int nr = n_r, nw = n_w;
    for (int e = tid; e < nr; e += blockDim.x) {
      Draws& d = draws[rlist[e] >> 2];
      const int k = rlist[e] & 3;
      uint32_t k0, k1;
      threefry::split_key(d.key.x, d.key.y, 16,
                          nibble(k == 0 ? kSlotA : k == 1 ? kSlotB : kSlotC,
                                 d.op), k0, k1);
      threefry::randint_bits(k0, k1, d.r[k].x, d.r[k].y);
    }
    for (int e = tid; e < nw; e += blockDim.x) {
      Draws& d = draws[wlist[e] >> 1];
      const int k = wlist[e] & 1;
      uint32_t k0, k1;
      threefry::split_key(d.key.x, d.key.y, 16,
                          nibble(k == 0 ? kSlotD : kSlotE, d.op), k0, k1);
      d.w[k] = threefry::bits(k0, k1);
    }
    __syncthreads();
    if (tid == 0) n_r = n_w = 0;
    if (mine) {          // the values over the draws they come from
      const int4 v = edit_values(draws[tid], g, N, D);
      *reinterpret_cast<int4*>(&draws[tid]) = v;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // the tile
    __syncthreads();
    if (h0 == 0 && active) {
      // step 0's clip of every row, the lane's threads side by side; the
      // row step 0's operator 0 (or 7, adding to the value) sums into
      // keeps its unclipped value for that sum, which its edit clips
      const int4 d0 = *reinterpret_cast<const int4*>(&draws[lane]);
      const int keep_t = d0.x == 0 ? d0.y : -1;
      int keep_v = -1;
      if (d0.x == 7 && d0.y >= 0) {
        const uint8_t f = flags[d0.y];
        if (!((f & 2) && (d0.z || !(f & 1)))) keep_v = d0.y;
      }
      for (int r = j; r < R; r += kGroup) {
        if (r != keep_t) rt[r] = clip(rt[r], 0, kTimeMax);
        if (r != keep_v) rv[r] = clip(rv[r], lo[r], hi[r]);
      }
    }
    __syncthreads();
    if (j == 0 && active) {
      const int h1 = min(h0 + kGroup, p.havoc);
      for (int h = h0; h < h1; ++h) {
        const int4 d =
            *reinterpret_cast<const int4*>(&draws[(h - h0) * T + lane]);
        const int op = d.x;
        bool applied = true;
        if (op == 0) {     // step 0 sums the unclipped time: it clips the
          if (d.y >= 0)    // sum, not the addend
            rt[d.y] = clip(add32(rt[d.y], d.z), 0, kTimeMax);
          else
            applied = false;
        } else if (op == 1) {
          if (d.y >= 0)
            row_node[lane * R + d.y] =
                pool[d.y * (N + 1) + d.z + 1] ? d.z : kNodeRandom;
          else
            applied = false;
        } else if (op == 2) {
          if (d.y >= 0)
            row_on[lane * R + d.y] ^= 1;
          else
            applied = false;
        } else if (op == 3) {
          if (d.y >= 0) {
            const int at = lane * D + d.z;
            if (!dup_on[at]) {
              dup_src[at] = d.y;
              dup_time[at] = clip(add32(rt[d.y], d.w), 0, kTimeMax);
            }
            dup_on[at] ^= 1;
          } else {
            applied = false;
          }
        } else if (op == 4) {
          lat_lo = clip(add32(lat_lo, d.y), 0, kLatCap);
          lat_hi = clip(add32(lat_hi, d.z), 0, kLatCap);
          jitter = clip(add32(jitter, d.y), 0, kJitCap);
        } else if (op == 5) {
          if (d.y) {
            loss = 0.0f;
          } else {
            const float x = __fmaf_rn(__fsub_rn(__int_as_float(d.z), 0.5f),
                                      0.2f, loss);
            loss = fmin_nan(fmax_nan(x, 0.0f), fmax_nan(0.9f, loss));
          }
        } else if (op == 6) {
          prio = d.y;
        } else if (op == 7) {
          if (d.y >= 0) {
            const int r = d.y;
            const uint8_t f = flags[r];
            if ((f & 2) && (d.z || !(f & 1))) {
              row_flag[lane * R + r] ^= 1;
            } else {
              const int32_t span = hi[r] - lo[r];
              const int32_t unit = max(floordiv(span, 64), 1);
              const int32_t vd = static_cast<int32_t>(
                  static_cast<uint32_t>(d.w) * static_cast<uint32_t>(unit));
              rv[r] = clip(add32(rv[r], vd), lo[r], hi[r]);
            }
          } else {
            applied = false;
          }
        }
        if (applied) {
          atomicAdd(&hist_s[op], 1);
          last = op;
        }
      }
    }
    __syncthreads();
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");     // havoc 0
  __syncthreads();

  // ---- the tile back out ---------------------------------------------------
  if (j == 0 && in_tile) {
    p.out_loss[b] = loss;
    p.out_lat_lo[b] = lat_lo;
    p.out_lat_hi[b] = lat_hi;
    p.out_jitter[b] = jitter;
    p.out_prio_nudge[b] = prio;
    p.last_op[b] = last;
  }
  store_range(p.out_row_time + rows0, row_time, nt * R, vec);
  store_range(p.out_row_node + rows0, row_node, nt * R, vec);
  store_range(p.out_row_val + rows0, row_val, nt * R, vec);
  store_range(p.out_row_flag + rows0, row_flag, nt * R, vec);
  store_range(p.out_row_on + rows0, row_on, nt * R, vec);
  store_range(p.out_dup_src + dups0, dup_src, nt * D, vec);
  store_range(p.out_dup_time + dups0, dup_time, nt * D, vec);
  store_range(p.out_dup_on + dups0, dup_on, nt * D, vec);
  if (tid < kOps && hist_s[tid] != 0) atomicAdd(&p.hist[tid], hist_s[tid]);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" int mutate_launch(const MutateParams* params, void* stream) {
  const MutateParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.R < 1 || p.D < 0 || p.N < 1 || p.havoc < 0 || p.tile < 32
      || p.tile > kMaxTile || p.tile % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = tile_layout(p.tile, p.R, p.D, p.N).total;
  if (smem != p.smem || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.vec) {
    const void* knobs[] = {
        p.in_row_time, p.in_row_node, p.in_row_on, p.in_row_val,
        p.in_row_flag, p.in_dup_src, p.in_dup_time, p.in_dup_on,
        p.out_row_time, p.out_row_node, p.out_row_on, p.out_row_val,
        p.out_row_flag, p.out_dup_src, p.out_dup_time, p.out_dup_on};
    for (const void* k : knobs)
      if (!aligned16(k)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mutate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.B + p.tile - 1) / p.tile);
  mutate_kernel<<<grid, p.tile * kGroup, static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
