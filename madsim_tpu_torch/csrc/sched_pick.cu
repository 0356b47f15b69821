// sched_pick: the event select of one simulation step, for every lane.
//
// Replaces the XLA-lowered select of the JAX package's step
// (madsim_tpu/core/step.py `live_step` section 1, lines 141-232:
// ops/select.py `min_deadline` + `masked_choice`, the PCT priority nudge
// and the two-lane FNV `sched_hash` fold), with jax's threefry2x32
// `randint` (madsim_tpu/core/prng.py) inlined as a device function.
// Per lane b, over its event table of C rows:
//
//   eligible[c] = t_kind[c] != EV_FREE
//                 && !(alive[n] && paused[n] && t_kind[c] != EV_SUPER),
//                 n = clip(t_node[c], 0, N-1)
//   dmin        = min over eligible rows of t_deadline (T_INF if none)
//   at_min[c]   = eligible[c] && t_deadline[c] == dmin
//   nudge == 0: idx = the row of the (r+1)-th at_min row, r = jax
//               randint(k_sched, 0, max(count, 1)) (0 if none)
//   nudge != 0: idx = first argmax over rows of (at_min ? prio|1 : 0),
//               prio a hash of (tag, node, row, nudge)
//   valid       = count > 0 && dmin < T_INF && !halted
//   sched_hash  = valid ? (h ^ mix(kind, node, src, tag)) * fold : h
//   ev_*        = the picked row's kind (0 unless valid), node (unclipped),
//                 src and tag, which the step goes on to dispatch
//
// Every value is an integer, so the kernel must equal its plain PyTorch
// version (madsim_tpu_torch/ops/sched_pick.py `sched_pick_plain`) exactly.
//
// Bound: bytes. Per lane it must read the t_kind and t_deadline rows
// (2 * 4 * C bytes), the t_node row only when a node of the lane is alive
// and paused (otherwise no row can be parked), and else only the picked
// row of t_node, t_tag and t_src (all at_min rows of t_tag and t_node when
// the nudge is on); the arithmetic is a few integer ops per row plus four
// threefry blocks per lane. Design: one
// warp per lane, each thread holding C/32 rows in registers, so every
// row is read from device memory once, coalesced; the minimum is a warp
// reduction, the tie count a ballot + popc per 32 rows, the rank match a
// popc of the ballot below each thread, and the nudge a warp argmax of
// (priority, -row) packed in 64 bits. The threefry draw runs only when
// more than one row ties (with one candidate the draw is always 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 8;            // C <= 32 * kMaxChunks = 256
constexpr int32_t kTInf = 0x7FFFFFFF;
constexpr int32_t kEvFree = 0;
constexpr int32_t kEvSuper = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32 block function, 20 rounds (jax _threefry2x32_lowering)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
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

// jax.random.randint(key, (), 0, maxval, int32) on the non-partitionable
// threefry stream, for maxval >= 1: split the key in two (counts iota(4):
// blocks (0, 2) and (1, 3)), draw 32 bits from each half (block (0, 0),
// first word), then jax's span / multiplier reduction in uint32.
__device__ int32_t randint_below(uint32_t k0, uint32_t k1, int32_t maxval) {
  uint32_t a0 = 0, a1 = 2, b0 = 1, b1 = 3;
  threefry2x32(k0, k1, a0, a1);
  threefry2x32(k0, k1, b0, b1);
  uint32_t hi = 0, hi1 = 0, lo = 0, lo1 = 0;
  threefry2x32(a0, b0, hi, hi1);   // first half key (a0, b0)
  threefry2x32(a1, b1, lo, lo1);   // second half key (a1, b1)
  const uint32_t span = maxval <= 0 ? 1u : static_cast<uint32_t>(maxval);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((hi % span) * mult + (lo % span)) % span;
  return static_cast<int32_t>(off);
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, s);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sched_pick_kernel(const int32_t* __restrict__ t_kind,
                  const int32_t* __restrict__ t_node,
                  const int32_t* __restrict__ t_deadline,
                  const int32_t* __restrict__ t_tag,
                  const int32_t* __restrict__ t_src,
                  const uint8_t* __restrict__ alive,
                  const uint8_t* __restrict__ paused,
                  const int32_t* __restrict__ prio_nudge,
                  const uint8_t* __restrict__ halted,
                  const uint32_t* __restrict__ k_sched,
                  const uint32_t* __restrict__ hash_in,
                  int32_t* __restrict__ idx_out,
                  int32_t* __restrict__ dmin_out,
                  uint8_t* __restrict__ valid_out,
                  uint8_t* __restrict__ any_out,
                  uint32_t* __restrict__ hash_out,
                  int32_t* __restrict__ ev_out,
                  int B, int C, int N) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform: a warp owns one lane
  const size_t row0 = static_cast<size_t>(b) * C;

  // nodes whose queued events are parked: alive and paused
  bool pk = false;
  if (lane < N) {
    const size_t j = static_cast<size_t>(b) * N + lane;
    pk = alive[j] != 0 && paused[j] != 0;
  }
  const uint32_t parked = __ballot_sync(kFull, pk);

  int32_t dl[kMaxChunks];
  int32_t nd[kMaxChunks];  // t_node rows, loaded only when parked != 0
  bool el[kMaxChunks];
  int32_t local_min = kTInf;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int r = (k << 5) + lane;
    el[k] = false;
    dl[k] = kTInf;
    nd[k] = 0;
    if (r < C) {
      const int32_t kind = t_kind[row0 + r];
      dl[k] = t_deadline[row0 + r];
      bool park = false;
      if (parked != 0) {  // warp-uniform
        nd[k] = t_node[row0 + r];
        const int32_t n = nd[k] < 0 ? 0 : (nd[k] > N - 1 ? N - 1 : nd[k]);
        park = ((parked >> n) & 1u) != 0 && kind != kEvSuper;
      }
      el[k] = kind != kEvFree && !park;
      if (el[k] && dl[k] < local_min) local_min = dl[k];
    }
  }
  const int32_t dmin = __reduce_min_sync(kFull, local_min);
  const bool any_ev = dmin < kTInf;

  uint32_t at[kMaxChunks];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    at[k] = __ballot_sync(kFull, el[k] && dl[k] == dmin);
    cnt += __popc(at[k]);
  }

  const int32_t nudge = prio_nudge[b];
  int32_t idx = 0;
  if (nudge == 0) {
    const int32_t r = cnt > 1
        ? randint_below(k_sched[2 * b], k_sched[2 * b + 1], cnt) : 0;
    // rank match: the at_min row whose inclusive prefix count is r + 1
    const uint32_t le = lane == 31 ? kFull : ((2u << lane) - 1u);
    int base = 0;
    int32_t mine = -1;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      if (((at[k] >> lane) & 1u) && base + __popc(at[k] & le) == r + 1)
        mine = (k << 5) + lane;
      base += __popc(at[k]);
    }
    const int32_t found = __reduce_max_sync(kFull, mine);
    idx = found < 0 ? 0 : found;
  } else {
    // first argmax of (at_min ? prio | 1 : 0): ties go to the lowest row
    unsigned long long best = 0;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int r = (k << 5) + lane;
      if (r < C) {
        uint32_t v = 0;
        if ((at[k] >> lane) & 1u) {
          const int32_t node = parked != 0 ? nd[k] : t_node[row0 + r];
          uint32_t p = static_cast<uint32_t>(t_tag[row0 + r]) * 0x9E3779B1u
                       ^ static_cast<uint32_t>(node) * 0x85EBCA77u
                       ^ static_cast<uint32_t>(r) * 0xC2B2AE3Du
                       ^ static_cast<uint32_t>(nudge) * 0x27D4EB2Fu;
          p = (p ^ (p >> 15)) * 0x2C1B3C6Du;
          v = p | 1u;
        }
        const unsigned long long key =
            (static_cast<unsigned long long>(v) << 32)
            | static_cast<unsigned long long>(0xFFFFFFFFu
                                              - static_cast<uint32_t>(r));
        best = key > best ? key : best;
      }
    }
    best = warp_max_u64(best);
    idx = static_cast<int32_t>(0xFFFFFFFFu
                               - static_cast<uint32_t>(best & 0xFFFFFFFFull));
  }

  if (lane == 0) {
    const bool valid = cnt > 0 && any_ev && halted[b] == 0;
    const size_t ri = row0 + idx;
    const int32_t ev_kind = valid ? t_kind[ri] : kEvFree;
    const int32_t ev_node = t_node[ri];
    const int32_t ev_src = t_src[ri];
    const int32_t ev_tag = t_tag[ri];
    uint32_t h0 = hash_in[2 * b], h1 = hash_in[2 * b + 1];
    if (valid) {
      const uint32_t kind = static_cast<uint32_t>(ev_kind);
      const int32_t n = ev_node < 0 ? 0 : (ev_node > N - 1 ? N - 1 : ev_node);
      const uint32_t node = static_cast<uint32_t>(n);
      const uint32_t src = static_cast<uint32_t>(ev_src);
      const uint32_t tag = static_cast<uint32_t>(ev_tag);
      const uint32_t m0 = kind * 0x9E3779B1u ^ node * 0x85EBCA77u
                          ^ src * 0xC2B2AE3Du ^ tag * 0x27D4EB2Fu;
      const uint32_t m1 = kind * 0x27D4EB2Fu ^ node * 0xC2B2AE3Du
                          ^ src * 0x9E3779B1u ^ tag * 0x85EBCA77u;
      h0 = (h0 ^ m0) * 16777619u;
      h1 = (h1 ^ m1) * 0x85EBCA6Bu;
    }
    idx_out[b] = idx;
    dmin_out[b] = dmin;
    valid_out[b] = valid ? 1 : 0;
    any_out[b] = any_ev ? 1 : 0;
    hash_out[2 * b] = h0;
    hash_out[2 * b + 1] = h1;
    ev_out[4 * b] = ev_kind;
    ev_out[4 * b + 1] = ev_node;
    ev_out[4 * b + 2] = ev_src;
    ev_out[4 * b + 3] = ev_tag;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 = launched). Requires C <= 256, N <= 32.
extern "C" int sched_pick_launch(
    const void* t_kind, const void* t_node, const void* t_deadline,
    const void* t_tag, const void* t_src, const void* alive,
    const void* paused, const void* prio_nudge, const void* halted,
    const void* k_sched, const void* hash_in, void* idx_out,
    void* dmin_out, void* valid_out, void* any_out, void* hash_out,
    void* ev_out, int B, int C, int N, void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || C > 32 * kMaxChunks || N < 1 || N > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sched_pick_kernel<<<grid, block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t_kind),
      static_cast<const int32_t*>(t_node),
      static_cast<const int32_t*>(t_deadline),
      static_cast<const int32_t*>(t_tag),
      static_cast<const int32_t*>(t_src),
      static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(paused),
      static_cast<const int32_t*>(prio_nudge),
      static_cast<const uint8_t*>(halted),
      static_cast<const uint32_t*>(k_sched),
      static_cast<const uint32_t*>(hash_in),
      static_cast<int32_t*>(idx_out), static_cast<int32_t*>(dmin_out),
      static_cast<uint8_t*>(valid_out), static_cast<uint8_t*>(any_out),
      static_cast<uint32_t*>(hash_out), static_cast<int32_t*>(ev_out), B, C,
      N);
  return static_cast<int>(cudaGetLastError());
}
