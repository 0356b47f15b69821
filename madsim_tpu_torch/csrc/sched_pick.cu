// sched_pick: the event select of one simulation step, for every lane.
//
// Replaces the XLA-lowered select of the JAX package's step
// (madsim_tpu/core/step.py `live_step` section 1, lines 141-232:
// ops/select.py `min_deadline` + `masked_choice`, the PCT priority nudge
// and the two-lane FNV `sched_hash` fold), with jax's threefry2x32
// `randint` (madsim_tpu/core/prng.py) inlined from threefry.cuh.
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
//   occ         = the count of rows with t_kind != EV_FREE (the sim
//                 profiler's pre-pop queue depth, step.py:187-188), written
//                 only when occ_out is not null: a launch-uniform branch,
//                 so a step without the profiler runs no part of it
//
// Every value is an integer, so the kernel must equal its plain PyTorch
// version (madsim_tpu_torch/ops/sched_pick.py `sched_pick_plain`) exactly.
//
// Bound: bytes. Per lane it must read the t_kind and t_deadline rows
// (2 * 4 * C bytes), the t_node row only when a node of the lane is alive
// and paused (otherwise no row can be parked), and else only the picked
// row of t_node, t_tag and t_src (all at_min rows of t_tag and t_node when
// the nudge is on); the arithmetic is a few integer ops per row plus four
// threefry blocks per lane.
//
// Design: the rows are a stream, so the kernel is built to keep loads in
// flight and to spend few instructions a lane. A warp owns a tile of 32
// lanes, one lane per thread for everything that is per lane: at the top
// each thread loads its lane's alive and paused bytes (the parked-node
// mask), prio_nudge, halted, k_sched and hash_in, all at once, and draws
// its lane's two threefry words (they depend on the key alone; only the
// reduction by the tie count waits for the rows). The rows are reduced a
// half-warp a lane, two lanes a step (lanes i and 16 + i of the tile),
// C/16 rows a thread: the minimum and the rank match by xor shuffles
// inside the half, the ties by one ballot a 16 rows, the nudge by a
// 64-bit argmax inside the half. They reach the half through a ring in
// shared memory that the warp fills with cp.async (16-byte copies through
// L2 where the tables are 16-byte aligned), a step ahead of the step it
// reduces: the t_kind and t_deadline rows of every lane, the t_node row of
// a lane with a parked node or a nudge, the t_tag row of a nudged lane
// (what the lane's scalars, known at the top, say it needs). The lane's
// owner thread sits in the half that reduces it and keeps idx, dmin and
// the picked row's kind (and node, where staged) from the stage. After
// the tile, each owner gathers t_src and t_tag (and t_node, where not
// staged) of its picked row, folds the hash and writes its lane's
// outputs: one trip to memory for 32 lanes' gathers, and coalesced
// stores. Every collective is reached by all 32 threads: the steps are
// uniform over the warp, the shuffles of the two halves run as one, and
// each tie-break runs for both halves when either needs it.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChunks = 12;           // C <= 32 * kMaxChunks = 384
constexpr int32_t kTInf = 0x7FFFFFFF;
constexpr int32_t kEvFree = 0;
constexpr int32_t kEvSuper = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;

// stages of the row ring, each two lanes' four rows (kind, deadline,
// node, tag) of slot(C) words: room for C words copied from the 16-byte
// boundary at or below the row's start. Two stages, one step ahead: the
// kernel is bound by its own instructions more than by memory latency, and
// on an H100 a deeper ring ran slower (it only takes shared memory)
constexpr int kStages = 2;
__host__ __device__ constexpr int slot(int C) { return (C + 6) / 4 * 4; }

// 16 bytes, through L2 only (.cg): the ring's copies take no L1 lines, of
// which little is left beside the ring's shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4 bytes (.ca: the only cache mode of the small sizes), for tables
// whose addresses are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Reductions over a half-warp: xor offsets below 16 never cross the
// halves, so all 32 threads run them, each half reducing its own lane.
__device__ __forceinline__ int32_t half_min(int32_t v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) v = min(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ int32_t half_max(int32_t v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) v = max(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ int half_sum(int v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

__device__ __forceinline__ unsigned long long half_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, s);
    v = o > v ? o : v;
  }
  return v;
}

template <int NCH>
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
                  int32_t* __restrict__ occ_out,
                  int B, int C, int N, int vec16) {
  constexpr int S = kStages;
  constexpr int RT = 2 * NCH;                 // rows a thread reduces
  constexpr int KI = (8 * NCH + 1 + 15) / 16;  // 16-byte copies a thread
  const int CP = slot(C);
  extern __shared__ int32_t smem[];
  const int t = threadIdx.x & 31;
  const int h = t >> 4;        // the half, and the half of the tile it takes
  const int u = t & 15;        // the thread within its half
  const int w = threadIdx.x >> 5;
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + w) * 32;
  if (b0 >= B) return;  // warp-uniform: a warp owns one tile
  const int nl = static_cast<int>(B - b0 < 32 ? B - b0 : 32);
  // the ring: S stages of two lanes (one a half) of four rows
  int32_t* ring = smem + static_cast<size_t>(w) * S * 2 * 4 * CP;

  // ---- the tile's per-lane loads, all issued before any collective
  const int64_t b = b0 + t;
  const bool own = t < nl;
  uint32_t parked = 0, k0 = 0, k1 = 0, h0 = 0, h1 = 0;
  int32_t nudge = 0;
  bool halt = false;
  if (own) {
    nudge = prio_nudge[b];
    halt = halted[b] != 0;
    k0 = k_sched[2 * b];
    k1 = k_sched[2 * b + 1];
    h0 = hash_in[2 * b];
    h1 = hash_in[2 * b + 1];
    const uint8_t* al = alive + b * N;
    const uint8_t* pa = paused + b * N;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      if (n < N) {  // both bytes loaded, neither load waits on the other
        const uint32_t a = al[n], p = pa[n];
        if ((a & p) != 0) parked |= 1u << n;
      }
    }
  }

  // where lane j's rows start in its slot: 16-byte copies start at the
  // 16-byte boundary at or below the row (the tables share an alignment,
  // the launch checks), 4-byte copies at the row itself
  auto shift = [&](int j) {
    return vec16 ? static_cast<int>((static_cast<size_t>(b0 + j) * C) & 3)
                 : 0;
  };
  auto slot_of = [&](int i) { return ring + ((i % S) * 2 + h) * 4 * CP; };

  // step i stages, in each half, lane 16 h + i of the tile: its rows into
  // its slot of stage i % S by the half's 16 threads, one commit group a
  // step (empty past the half's lanes)
  auto issue = [&](int i) {
    const int j = 16 * h + i;
    const uint32_t pj = __shfl_sync(kFull, parked, j & 31);
    const int32_t nj = __shfl_sync(kFull, nudge, j & 31);
    if (i < 16 && j < nl) {
      int32_t* st = slot_of(i);
      const bool node = pj != 0 || nj != 0, tag = nj != 0;
      if (vec16) {
        // whole 16-byte blocks; the last may run past the row (and, for
        // the last lane, past the table's end inside its 16-byte block)
        const size_t a0 = static_cast<size_t>(b0 + j) * C - shift(j);
        const int chunks = (shift(j) + C + 3) >> 2;
#pragma unroll
        for (int k = 0; k < KI; ++k) {
          const int c = u + 16 * k;
          if (c < chunks) {
            const size_t g = a0 + 4 * c;
            cp_async16(st + 4 * c, t_kind + g);
            cp_async16(st + CP + 4 * c, t_deadline + g);
            if (node) cp_async16(st + 2 * CP + 4 * c, t_node + g);
            if (tag) cp_async16(st + 3 * CP + 4 * c, t_tag + g);
          }
        }
      } else {
        const size_t row0 = static_cast<size_t>(b0 + j) * C;
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          const int r = (k << 4) + u;
          if (r < C) {
            cp_async4(st + r, t_kind + row0 + r);
            cp_async4(st + CP + r, t_deadline + row0 + r);
            if (node) cp_async4(st + 2 * CP + r, t_node + row0 + r);
            if (tag) cp_async4(st + 3 * CP + r, t_tag + row0 + r);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);

  // the lane's two draws, while the first stages are in flight
  uint32_t rhi = 0, rlo = 0;
  threefry::randint_bits(k0, k1, rhi, rlo);

  // what the owner thread keeps of its lane
  int32_t my_idx = 0, my_dmin = kTInf, my_kind = kEvFree, my_node = 0;
  int32_t my_occ = 0;
  bool my_picked = false, my_node_staged = false;
  const bool count_occ = occ_out != nullptr;   // launch-uniform

  const int steps = nl < 16 ? nl : 16;
  for (int i = 0; i < steps; ++i) {
    issue(i + S - 1);
    cp_async_wait<S - 1>();  // step i's stage has landed (this thread's)
    __syncwarp();            // ... and every thread's
    const int j = 16 * h + i;  // this half's lane; its owner is thread j
    const int32_t* st = slot_of(i) + shift(j);
    const uint32_t pj = __shfl_sync(kFull, parked, j);
    const int32_t nj = __shfl_sync(kFull, nudge, j);
    const uint32_t hj = __shfl_sync(kFull, rhi, j);
    const uint32_t lj = __shfl_sync(kFull, rlo, j);

    int32_t dl[RT];
    bool el[RT];
    int32_t local_min = kTInf;
    int occ = 0;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int r = (k << 4) + u;
      el[k] = false;
      dl[k] = kTInf;
      if (r < C) {
        const int32_t kind = st[r];
        dl[k] = st[CP + r];
        bool park = false;
        if (pj != 0) {  // no collective inside: the halves may differ
          const int32_t nd = st[2 * CP + r];
          const int32_t n = nd < 0 ? 0 : (nd > N - 1 ? N - 1 : nd);
          park = ((pj >> n) & 1u) != 0 && kind != kEvSuper;
        }
        el[k] = kind != kEvFree && !park;
        if (el[k] && dl[k] < local_min) local_min = dl[k];
        if (count_occ) occ += kind != kEvFree;
      }
    }
    const int32_t dmin = half_min(local_min);
    if (count_occ) occ = half_sum(occ);

    uint32_t at[RT];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      at[k] = (__ballot_sync(kFull, el[k] && dl[k] == dmin) >> (16 * h))
              & 0xFFFFu;
      cnt += __popc(at[k]);
    }

    // the two tie-breaks, each run when either half needs it (so that
    // every thread reaches its collectives), and each half takes its own
    const bool some_drawn = __any_sync(kFull, nj == 0);
    const bool some_nudged = __any_sync(kFull, nj != 0);
    int32_t idx = 0;
    if (some_drawn) {
      const int32_t r = nj == 0 && cnt > 1
          ? threefry::randint_reduce(hj, lj, 0, cnt) : 0;
      // rank match: the at_min row whose inclusive prefix count is r + 1
      const uint32_t le = (2u << u) - 1u;
      int base = 0;
      int32_t mine = -1;
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (((at[k] >> u) & 1u) && base + __popc(at[k] & le) == r + 1)
          mine = (k << 4) + u;
        base += __popc(at[k]);
      }
      const int32_t found = half_max(mine);
      if (nj == 0) idx = found < 0 ? 0 : found;
    }
    if (some_nudged) {
      // first argmax of (at_min ? prio | 1 : 0): ties go to the lowest row
      unsigned long long best = 0;
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const int r = (k << 4) + u;
        if (r < C) {
          uint32_t v = 0;
          if (nj != 0 && ((at[k] >> u) & 1u)) {
            uint32_t p = static_cast<uint32_t>(st[3 * CP + r]) * 0x9E3779B1u
                         ^ static_cast<uint32_t>(st[2 * CP + r]) * 0x85EBCA77u
                         ^ static_cast<uint32_t>(r) * 0xC2B2AE3Du
                         ^ static_cast<uint32_t>(nj) * 0x27D4EB2Fu;
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
      best = half_max_u64(best);
      if (nj != 0)
        idx = static_cast<int32_t>(
            0xFFFFFFFFu - static_cast<uint32_t>(best & 0xFFFFFFFFull));
    }

    if (t == j) {
      my_idx = idx;
      my_dmin = dmin;
      my_picked = cnt > 0;
      my_kind = st[idx];
      my_node_staged = pj != 0 || nj != 0;
      if (my_node_staged) my_node = st[2 * CP + idx];
      my_occ = occ;
    }
    __syncwarp();  // the stage is read before the next issue refills it
  }

  // ---- the owners: gather the picked row, fold, write
  if (own) {
    const bool any_ev = my_dmin < kTInf;
    const bool valid = my_picked && any_ev && !halt;
    const size_t ri = static_cast<size_t>(b) * C + my_idx;
    const int32_t ev_node = my_node_staged ? my_node : t_node[ri];
    const int32_t ev_src = t_src[ri];
    const int32_t ev_tag = t_tag[ri];
    const int32_t ev_kind = valid ? my_kind : kEvFree;
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
    idx_out[b] = my_idx;
    dmin_out[b] = my_dmin;
    valid_out[b] = valid ? 1 : 0;
    any_out[b] = any_ev ? 1 : 0;
    hash_out[2 * b] = h0;
    hash_out[2 * b + 1] = h1;
    ev_out[4 * b] = ev_kind;
    ev_out[4 * b + 1] = ev_node;
    ev_out[4 * b + 2] = ev_src;
    ev_out[4 * b + 3] = ev_tag;
    if (count_occ) occ_out[b] = my_occ;
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, const uint8_t*,
                          const uint8_t*, const int32_t*, const uint8_t*,
                          const uint32_t*, const uint32_t*, int32_t*,
                          int32_t*, uint8_t*, uint8_t*, uint32_t*, int32_t*,
                          int32_t*, int, int, int, int);

// the instantiation for C rows (NCH = ceil(C / 32): 2 NCH rows a thread).
// NCH 9-12 (256 < C <= 384, chain replication's C = 384) are the same
// code with up to 24 rows a thread; their ring (up to ~97 KB a block of
// four warps at C = 384) takes the dynamic shared-memory opt-in, as every
// C >= 190 does, and leaves an SM two blocks
KernelFn kernel_for(int C) {
  switch ((C + 31) / 32) {
    case 1: return sched_pick_kernel<1>;
    case 2: return sched_pick_kernel<2>;
    case 3: return sched_pick_kernel<3>;
    case 4: return sched_pick_kernel<4>;
    case 5: return sched_pick_kernel<5>;
    case 6: return sched_pick_kernel<6>;
    case 7: return sched_pick_kernel<7>;
    case 8: return sched_pick_kernel<8>;
    case 9: return sched_pick_kernel<9>;
    case 10: return sched_pick_kernel<10>;
    case 11: return sched_pick_kernel<11>;
    default: return sched_pick_kernel<12>;
  }
}

size_t smem_bytes(int C) {
  return static_cast<size_t>(kWarpsPerBlock) * kStages * 2 * 4 * slot(C)
         * sizeof(int32_t);
}

// The instantiation for C rows, allowed the dynamic shared memory its ring
// takes (above 48 KB, from C = 190 on, only by opting in: once a device
// and instantiation, at the first launch, which comes before any
// CUDA-graph capture of it). The opt-in is the ring of the instantiation's
// widest C, 32 NCH, so that a later launch at a wider C of the same
// instantiation (C = 257, then 288) is not refused.
cudaError_t prepare(int C, KernelFn* fn) {
  constexpr int kDevices = 64;
  static bool opted_in[kDevices][kMaxChunks + 1] = {};
  *fn = kernel_for(C);
  const size_t bytes = smem_bytes(C);
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int nch = (C + 31) / 32;
  if (dev < kDevices && opted_in[dev][nch]) return cudaSuccess;
  err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(32 * nch)));
  if (err == cudaSuccess && dev < kDevices) opted_in[dev][nch] = true;
  return err;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 = launched). Requires C <= 384, N <= 32.
// occ_out may be null (no occupancy count).
extern "C" int sched_pick_launch(
    const void* t_kind, const void* t_node, const void* t_deadline,
    const void* t_tag, const void* t_src, const void* alive,
    const void* paused, const void* prio_nudge, const void* halted,
    const void* k_sched, const void* hash_in, void* idx_out,
    void* dmin_out, void* valid_out, void* any_out, void* hash_out,
    void* ev_out, void* occ_out, int B, int C, int N, void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || C > 32 * kMaxChunks || N < 1 || N > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes_per_block = kWarpsPerBlock * 32;
  // the 16-byte ring copies need the four staged tables 16-byte aligned
  const int vec16 = ((reinterpret_cast<uintptr_t>(t_kind)
                      | reinterpret_cast<uintptr_t>(t_node)
                      | reinterpret_cast<uintptr_t>(t_deadline)
                      | reinterpret_cast<uintptr_t>(t_tag)) & 15) == 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + lanes_per_block - 1) / lanes_per_block);
  KernelFn fn;
  const cudaError_t err = prepare(C, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, block, smem_bytes(C),
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
      static_cast<uint32_t*>(hash_out), static_cast<int32_t*>(ev_out),
      static_cast<int32_t*>(occ_out), B, C, N, vec16);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for C rows: registers a thread, dynamic shared memory
// a block, threads a block, and resident blocks an SM on the current
// device (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a
// cudaError_t (0 = filled in).
extern "C" int sched_pick_occupancy(int C, int* regs, int* smem,
                                    int* threads, int* blocks_per_sm) {
  if (C < 1 || C > 32 * kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn fn;
  cudaError_t err = prepare(C, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = static_cast<int>(smem_bytes(C));
  *threads = kWarpsPerBlock * 32;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kWarpsPerBlock * 32, smem_bytes(C)));
}
