// mutate: the havoc mutation engine of the schedule fuzzer, one thread per
// lane.
//
// Replaces the JAX package's `_mutate_batch` / `_mutate_batch_masked`
// (madsim_tpu/search/mutate.py:470,481; body `_mutate_one` at :344), with
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
// applied operator. A masked-off lane is copied as it
// is, counts nothing and gets last_op -1. A lane draws only the keys of
// the operators it drew: every draw is a stateless function of its key,
// so the result equals the reference's, which draws all of them.
//
// Bound: operations (threefry blocks, ~80 integer operations each: a
// havoc step needs 2 blocks for its key, 2 per subkey and 4 per randint)
// against bytes (each lane's knob rows read once and written once); at
// the flagship's R = 33, havoc = 3 both are some tens of microseconds at
// B = 100,000. Design: the guards sit in shared memory as the lists of
// their set rows, so a choice is one draw and one load; each thread edits
// its lane's rows in the output where they lie.

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
};

namespace {

constexpr int kThreads = 128;
constexpr int kOps = 8;
constexpr int32_t kTimeMax = 2147483646;   // T_INF - 1
constexpr int32_t kLatCap = 30000000;
constexpr int32_t kJitCap = 1000000;
constexpr int32_t kNodeRandom = -1;

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

// Shared guard tables: the set rows of each guard, in row order.
struct Guards {
  int32_t* list[4];     // time_ok, node_ok, drop_ok, fault (val|dir|torn)
  int32_t* count;       // [4]
  int32_t* lo;
  int32_t* hi;
  uint8_t* flags;       // bit 0 val_ok, bit 1 dir_ok | torn_ok
  uint8_t* pool;        // [R, N + 1]
};

// jax masked_choice over a guard's set rows: (row, found)
__device__ __forceinline__ int32_t choose(const Guards& g, int which,
                                          uint32_t k0, uint32_t k1,
                                          bool& found) {
  const int32_t n = g.count[which];
  const int32_t r = threefry::randint_raw(k0, k1, 0, n > 0 ? n : 1);
  found = n > 0;
  return found ? g.list[which][r] : 0;
}

__global__ void __launch_bounds__(kThreads)
mutate_kernel(const MutateParams p) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t counts[4];
  __shared__ int32_t hist_s[kOps];
  const int R = p.R, D = p.D, N = p.N;
  const int tid = threadIdx.x;
  Guards g;
  for (int i = 0; i < 4; ++i) g.list[i] = smem + i * R;
  g.lo = smem + 4 * R;
  g.hi = smem + 5 * R;
  g.flags = reinterpret_cast<uint8_t*>(smem + 6 * R);
  g.pool = g.flags + R;
  g.count = counts;
  for (int r = tid; r < R; r += blockDim.x) {
    g.lo[r] = p.val_lo[r];
    g.hi[r] = p.val_hi[r];
    g.flags[r] = (p.val_ok[r] ? 1 : 0) | (p.dir_ok[r] | p.torn_ok[r] ? 2 : 0);
  }
  for (int i = tid; i < R * (N + 1); i += blockDim.x) g.pool[i] = p.pool_ok[i];
  if (tid < kOps) hist_s[tid] = 0;
  if (tid == 0) {
    int c[4] = {0, 0, 0, 0};
    for (int r = 0; r < R; ++r) {
      if (p.time_ok[r]) g.list[0][c[0]++] = r;
      if (p.node_ok[r]) g.list[1][c[1]++] = r;
      if (p.drop_ok[r]) g.list[2][c[2]++] = r;
      if (p.val_ok[r] | p.dir_ok[r] | p.torn_ok[r]) g.list[3][c[3]++] = r;
    }
    for (int i = 0; i < 4; ++i) counts[i] = c[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + tid;
  if (b < p.B) {
    const bool active = p.mask == nullptr || p.mask[b];
    int32_t* row_time = p.out_row_time + static_cast<size_t>(b) * R;
    int32_t* row_node = p.out_row_node + static_cast<size_t>(b) * R;
    uint8_t* row_on = p.out_row_on + static_cast<size_t>(b) * R;
    int32_t* row_val = p.out_row_val + static_cast<size_t>(b) * R;
    int32_t* row_flag = p.out_row_flag + static_cast<size_t>(b) * R;
    int32_t* dup_src = p.out_dup_src + static_cast<size_t>(b) * D;
    int32_t* dup_time = p.out_dup_time + static_cast<size_t>(b) * D;
    uint8_t* dup_on = p.out_dup_on + static_cast<size_t>(b) * D;
    for (int r = 0; r < R; ++r) {
      const size_t i = static_cast<size_t>(b) * R + r;
      row_time[r] = p.in_row_time[i];
      row_val[r] = p.in_row_val[i];
      row_node[r] = p.in_row_node[i];
      row_on[r] = p.in_row_on[i];
      row_flag[r] = p.in_row_flag[i];
    }
    for (int d = 0; d < D; ++d) {
      const size_t i = static_cast<size_t>(b) * D + d;
      dup_src[d] = p.in_dup_src[i];
      dup_time[d] = p.in_dup_time[i];
      dup_on[d] = p.in_dup_on[i];
    }
    float loss = p.in_loss[b];
    int32_t lat_lo = p.in_lat_lo[b];
    int32_t lat_hi = p.in_lat_hi[b];
    int32_t jitter = p.in_jitter[b];
    int32_t prio = p.in_prio_nudge[b];
    int32_t last = -1;
    if (active) {
      uint32_t l0, l1;
      threefry::split_key(p.key[0], p.key[1], p.B, b, l0, l1);
      for (int h = 0; h < p.havoc; ++h) {
        uint32_t s0, s1;
        threefry::split_key(l0, l1, p.havoc, h, s0, s1);
        uint32_t k0, k1;
        auto sub = [&](int i) { threefry::split_key(s0, s1, 16, i, k0, k1); };
        sub(0);
        const int op = threefry::randint(k0, k1, 0, kOps - 1);
        bool applied = true;
        if (op == 0) {     // before step 0's clip of every row: it clips
          sub(1);          // the sum, not the addend
          const int32_t r = choose(g, 0, k0, k1, applied);
          if (applied) {
            sub(2);
            const int32_t mag = threefry::randint(k0, k1, 6, 20);
            sub(3);
            const int32_t raw = threefry::randint_raw(k0, k1, 0, 1 << mag);
            sub(4);
            const int32_t delta = threefry::bernoulli(k0, k1, 0.5f)
                ? add32(raw, 1) : -add32(raw, 1);
            row_time[r] = clip(add32(row_time[r], delta), 0, kTimeMax);
          }
        }
        if (h == 0)        // later steps only see clipped times
          for (int r = 0; r < R; ++r) row_time[r] = clip(row_time[r], 0,
                                                         kTimeMax);
        if (op == 1) {
          sub(5);
          const int32_t r = choose(g, 1, k0, k1, applied);
          if (applied) {
            sub(6);
            const int32_t cand = threefry::randint(k0, k1, -1, N - 1);
            row_node[r] = g.pool[r * (N + 1) + cand + 1] ? cand : kNodeRandom;
          }
        } else if (op == 2) {
          sub(7);
          const int32_t r = choose(g, 2, k0, k1, applied);
          if (applied) row_on[r] ^= 1;
        } else if (op == 3) {
          applied = false;
          if (D > 0) {
            sub(9);
            const int32_t s = choose(g, 2, k0, k1, applied);
            if (applied) {
              sub(8);
              const int32_t d = threefry::randint(k0, k1, 0, D - 1);
              if (!dup_on[d]) {
                sub(10);
                const int32_t near =
                    threefry::randint(k0, k1, -200000, 200000);
                dup_src[d] = s;
                dup_time[d] = clip(add32(row_time[s], near), 0, kTimeMax);
              }
              dup_on[d] ^= 1;
            }
          }
        } else if (op == 4) {
          sub(2);
          const int32_t dlo = threefry::randint(k0, k1, -5000, 5000);
          sub(3);
          const int32_t dhi = threefry::randint(k0, k1, -20000, 20000);
          lat_lo = clip(add32(lat_lo, dlo), 0, kLatCap);
          lat_hi = clip(add32(lat_hi, dhi), 0, kLatCap);
          jitter = clip(add32(jitter, dlo), 0, kJitCap);
        } else if (op == 5) {
          sub(7);
          if (threefry::bernoulli(k0, k1, 0.2f)) {
            loss = 0.0f;
          } else {
            sub(4);
            const float u = __uint_as_float(
                (threefry::bits(k0, k1) >> 9) | 0x3F800000u) - 1.0f;
            const float x = __fmaf_rn(__fsub_rn(u, 0.5f), 0.2f, loss);
            loss = fmin_nan(fmax_nan(x, 0.0f), fmax_nan(0.9f, loss));
          }
        } else if (op == 6) {
          sub(11);
          prio = threefry::randint_raw(k0, k1, -2147483647, 2147483647);
        } else if (op == 7) {
          sub(12);
          const int32_t r = choose(g, 3, k0, k1, applied);
          if (applied) {
            const uint8_t f = g.flags[r];
            sub(13);
            const bool want = threefry::bernoulli(k0, k1, 0.35f);
            if ((f & 2) && (want || !(f & 1))) {
              row_flag[r] ^= 1;
            } else {
              sub(14);
              const int32_t step = threefry::randint(k0, k1, -8, 8);
              const int32_t span = g.hi[r] - g.lo[r];
              const int32_t unit = max(floordiv(span, 64), 1);
              const int32_t vd = static_cast<int32_t>(
                  static_cast<uint32_t>(step) * static_cast<uint32_t>(unit));
              row_val[r] = clip(add32(row_val[r], vd), g.lo[r], g.hi[r]);
            }
          }
        }
        if (h == 0)        // after op 7's sum, as for the times
          for (int r = 0; r < R; ++r) row_val[r] = clip(row_val[r], g.lo[r],
                                                        g.hi[r]);
        if (applied) {
          atomicAdd(&hist_s[op], 1);
          last = op;
        }
      }
    }
    p.out_loss[b] = loss;
    p.out_lat_lo[b] = lat_lo;
    p.out_lat_hi[b] = lat_hi;
    p.out_jitter[b] = jitter;
    p.out_prio_nudge[b] = prio;
    p.last_op[b] = last;
  }
  __syncthreads();
  if (tid < kOps && hist_s[tid] != 0) atomicAdd(&p.hist[tid], hist_s[tid]);
}

}  // namespace

extern "C" int mutate_launch(const MutateParams* params, void* stream) {
  const MutateParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.R < 1 || p.D < 0 || p.N < 1 || p.havoc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(6) * p.R * sizeof(int32_t)
      + static_cast<size_t>(p.R) * (p.N + 2);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.B + kThreads - 1) / kThreads);
  mutate_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
