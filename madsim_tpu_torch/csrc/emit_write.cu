// emit_write: the emission write of one simulation step, for every lane,
// with the flight-recorder ring write as its epilogue.
//
// Replaces the XLA-lowered emission write of the JAX package's step
// (madsim_tpu/core/step.py `live_step` section 4, lines 476-655:
// ops/select.py `first_k_free`, the per-send network fault model, the
// per-timer skew stretch, the one-pass column write and the lineage
// provenance write) and the ring-row write (lines 941-1001), with jax's
// threefry2x32 draws (madsim_tpu/core/prng.py) inlined from threefry.cuh.
// Per lane b, with E staged emissions (sends first, then timers):
//
//   free rows      ranked in row order; emission e takes the e-th free
//                  row when there is one (slot_ok)
//   keys           split(k_net, 2 * max(n_sends, 1) (+ E with jitter));
//                  send j: loss key 2j, latency key 2j + 1; emission e's
//                  jitter key 2 * max(n_sends, 1) + e
//   send j         dst = clip(a, 0, N-1); clogged = clog_node[h] |
//                  clog_node[dst] | clog_link[h][dst]; lost =
//                  bernoulli(loss); deadline = now + randint(lat_lo,
//                  lat_hi) (+ jitter) + disk_lat; ok = m & !clogged &
//                  !lost; written where ok & slot_ok
//   timer          deadline = now + max(d - drift(d, skew), 0) + disk_lat
//                  (+ jitter); written where m & slot_ok
//   writes         every written emission sets its row's deadline, kind,
//                  node, src (the acting node), tag and payload, and with
//                  the lineage plane ev_prov = (disp_idx, ev_lamport);
//                  every other row is copied
//   outputs        sent, delivered_drop, overflow, high_water per lane
//   ring (TC > 0)  where fired & trace_on, the row at trace_pos mod
//                  trace_cap of the eight tr_* columns takes this step's
//                  record; trace_pos counts it
//
// Every value is an integer or the exact float32 compare of a Bernoulli
// draw, so the kernel must equal its plain PyTorch version
// (madsim_tpu_torch/ops/emit_write.py `emit_write_plain`) exactly.
//
// Bound: bytes. The outputs are new tables, so each lane reads and
// writes its whole event table (five int32 columns, the payload rows and
// the provenance pairs) and, with the ring, its eight ring columns; the
// draws are a few dozen threefry blocks per masked send, far below the
// card's integer rate. Design: one warp per lane, as sched_pick. Each
// thread holds C/32 rows of t_kind in registers; the free rows are
// ranked with a ballot + popc over each 32-row word, so row r's rank is
// the popc of the free rows below it. Thread e computes emission e's
// draws in registers (E <= 32), and a thread writing row r fetches the
// values of the emission that takes r with a shuffle. The payload and
// provenance copies stream the lane's rows coalesced, reading a per-warp
// row -> emission map in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 8;            // C <= 32 * kMaxChunks = 256
constexpr int kMaxE = 32;                // one emission per thread
constexpr int kRingCols = 8;
constexpr int32_t kEvFree = 0;
constexpr int32_t kEvMsg = 1;
constexpr int32_t kEvTimer = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;

}  // namespace

// Operands of one launch (host struct, passed by value to the kernel).
// Tables are [B, C] (payload [B, C, P], provenance [B, C, 2]); staged
// emissions [B, E] (payload [B, E, P]); lane scalars [B] (k_net [B, 2],
// clog_node [B, N], clog_link [B, N, N]); ring columns [B, TC], in the
// order tr_now, tr_step, tr_kind, tr_node, tr_src, tr_tag, tr_parent,
// tr_lamport. All contiguous, int32 unless noted.
struct EmitParams {
  const int32_t* t_deadline;
  const int32_t* t_kind;
  const int32_t* t_node;
  const int32_t* t_src;
  const int32_t* t_tag;
  const int32_t* t_payload;
  const int32_t* ev_prov;
  int32_t* o_deadline;
  int32_t* o_kind;
  int32_t* o_node;
  int32_t* o_src;
  int32_t* o_tag;
  int32_t* o_payload;
  int32_t* o_prov;
  const uint8_t* em_m;        // bool
  const int32_t* em_a;        // send: dst, timer: delay
  const int32_t* em_tag;
  const int32_t* em_payload;
  const int32_t* now;
  const int32_t* h_node;
  const int32_t* sk_h;
  const int32_t* dlat_h;
  const float* loss;
  const int32_t* lat_lo;
  const int32_t* lat_hi;
  const int32_t* jitter;
  const uint32_t* k_net;
  const uint8_t* clog_node;   // bool
  const uint8_t* clog_link;   // bool
  const int32_t* disp_idx;
  const int32_t* ev_lamport;
  int32_t* sent;
  int32_t* delivered_drop;
  uint8_t* overflow;          // bool
  int32_t* high_water;
  const uint8_t* fired;       // bool
  const uint8_t* trace_on;    // bool
  const int32_t* trace_pos;
  const int32_t* trace_cap;
  const int32_t* rec_kind;
  const int32_t* rec_node;
  const int32_t* rec_src;
  const int32_t* rec_tag;
  const int32_t* rec_parent;
  const int32_t* tr_in[kRingCols];
  int32_t* tr_out[kRingCols];
  int32_t* o_trace_pos;
  int B, C, P, N, E, n_sends, use_jitter, has_prov, TC;
};

namespace {

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              * static_cast<uint32_t>(b));
}

// (t * sk) >> 10 in int32-safe pieces, as core/step.py `_drift`:
// (t >> 10) * sk + (((t & 1023) * sk) >> 10), arithmetic shifts, wrap.
__device__ __forceinline__ int32_t drift(int32_t t, int32_t sk) {
  return add32(mul32(t >> 10, sk), mul32(t & 1023, sk) >> 10);
}

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
emit_write_kernel(const EmitParams p) {
  __shared__ int8_t row_em[kWarpsPerBlock][32 * kMaxChunks];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= p.B) return;  // warp-uniform: a warp owns one lane
  const int C = p.C, E = p.E, N = p.N;
  const int32_t now = p.now[b];

  if (E > 0) {
    const size_t row0 = static_cast<size_t>(b) * C;
    const int32_t h = p.h_node[b];
    const int hc = clip(h, 0, N - 1);

    // ---- rank the free rows: rank[k] = free ? #free rows below : -1
    int32_t kind[kMaxChunks];
    int rank[kMaxChunks];
    const uint32_t below = (1u << lane) - 1u;
    int n_free = 0;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int r = (k << 5) + lane;
      kind[k] = r < C ? p.t_kind[row0 + r] : -1;
      const bool free = r < C && kind[k] == kEvFree;
      const uint32_t word = __ballot_sync(kFull, free);
      rank[k] = free ? n_free + __popc(word & below) : -1;
      n_free += __popc(word);
    }

    // ---- emission `lane`: its draws and decision, in registers
    bool m = false, write = false, ovf = false, bad_send = false;
    int32_t dl = 0, ekind = 0, enode = 0, etag = 0;
    const bool is_send = lane < p.n_sends;
    if (lane < E) {
      const size_t ei = static_cast<size_t>(b) * E + lane;
      m = p.em_m[ei] != 0;
      const int32_t a = p.em_a[ei];
      etag = p.em_tag[ei];
      const bool slot_ok = lane < n_free;
      const int32_t dlat = p.dlat_h[b];
      const int ns = p.n_sends > 1 ? p.n_sends : 1;
      const int n_keys = 2 * ns + (p.use_jitter ? E : 0);
      const uint32_t k0 = p.k_net[2 * b], k1 = p.k_net[2 * b + 1];
      int32_t jit = 0;
      if (m && p.use_jitter) {
        uint32_t j0, j1;
        threefry::split_key(k0, k1, n_keys, 2 * ns + lane, j0, j1);
        jit = threefry::randint(j0, j1, 0, p.jitter[b]);
      }
      if (is_send) {
        const int dst = clip(a, 0, N - 1);
        ekind = kEvMsg;
        enode = dst;
        if (m) {
          const size_t nb = static_cast<size_t>(b) * N;
          const bool clogged = p.clog_node[nb + hc] != 0
              || p.clog_node[nb + dst] != 0
              || p.clog_link[(nb + hc) * N + dst] != 0;
          uint32_t l0, l1, t0, t1;
          threefry::split_key(k0, k1, n_keys, 2 * lane, l0, l1);
          const bool lost = threefry::bernoulli(l0, l1, p.loss[b]);
          threefry::split_key(k0, k1, n_keys, 2 * lane + 1, t0, t1);
          const int32_t lat = add32(
              threefry::randint(t0, t1, p.lat_lo[b], p.lat_hi[b]), jit);
          const bool ok = !clogged && !lost;
          bad_send = !ok;
          write = ok && slot_ok;
          ovf = ok && !slot_ok;
          dl = add32(add32(now, lat), dlat);
        }
      } else {
        ekind = kEvTimer;
        enode = h;
        if (m) {
          int32_t d_eff = sub32(a, drift(a, p.sk_h[b]));
          d_eff = d_eff < 0 ? 0 : d_eff;
          write = slot_ok;
          ovf = !slot_ok;
          dl = add32(add32(add32(now, d_eff), dlat), jit);
        }
      }
    }
    const uint32_t sends = __ballot_sync(kFull, lane < E && is_send && m);
    const uint32_t drops = __ballot_sync(kFull, bad_send);
    const uint32_t wrote = __ballot_sync(kFull, write);
    const bool any_ovf = __ballot_sync(kFull, ovf) != 0;
    if (lane == 0) {
      p.sent[b] = __popc(sends);
      p.delivered_drop[b] = __popc(drops);
      p.overflow[b] = any_ovf ? 1 : 0;
      p.high_water[b] = (C - n_free) + __popc(wrote);
    }

    // ---- the five int32 columns: row r takes emission rank[k]'s values
    // when that emission is written, else keeps its own
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int r = (k << 5) + lane;
      const int e = rank[k];
      const bool mine = e >= 0 && e < E;
      const int from = mine ? e : 0;
      // every thread shuffles (no short circuit: a shuffle is collective)
      const int write_e = __shfl_sync(kFull, static_cast<int>(write), from);
      const bool hit = mine && write_e != 0;
      const int32_t dl_e = __shfl_sync(kFull, dl, from);
      const int32_t kind_e = __shfl_sync(kFull, ekind, from);
      const int32_t node_e = __shfl_sync(kFull, enode, from);
      const int32_t tag_e = __shfl_sync(kFull, etag, from);
      if (r < C) {
        const size_t i = row0 + r;
        p.o_deadline[i] = hit ? dl_e : p.t_deadline[i];
        p.o_kind[i] = hit ? kind_e : kind[k];
        p.o_node[i] = hit ? node_e : p.t_node[i];
        p.o_src[i] = hit ? h : p.t_src[i];
        p.o_tag[i] = hit ? tag_e : p.t_tag[i];
        row_em[w][r] = static_cast<int8_t>(hit ? e : -1);
      }
    }
    __syncwarp();

    // ---- payload rows and provenance pairs, streamed coalesced
    const int P = p.P;
    const size_t pay0 = row0 * P;
    const size_t em_pay0 = static_cast<size_t>(b) * E * P;
    for (int i = lane; i < C * P; i += 32) {
      const int r = i / P;
      const int e = row_em[w][r];
      p.o_payload[pay0 + i] = e >= 0
          ? p.em_payload[em_pay0 + static_cast<size_t>(e) * P + (i - r * P)]
          : p.t_payload[pay0 + i];
    }
    if (p.has_prov) {
      const int32_t disp = p.disp_idx[b];
      const int32_t lam = p.ev_lamport[b];
      for (int i = lane; i < 2 * C; i += 32) {
        const int e = row_em[w][i >> 1];
        p.o_prov[2 * row0 + i] = e >= 0 ? ((i & 1) ? lam : disp)
                                        : p.ev_prov[2 * row0 + i];
      }
    }
  }

  // ---- epilogue: the flight-recorder ring row
  if (p.TC > 0) {
    const int TC = p.TC;
    const bool rec = p.fired[b] != 0 && p.trace_on[b] != 0;
    const int32_t pos = p.trace_pos[b];
    const int32_t cap = p.trace_cap[b];
    int slot = -1;
    if (rec && cap != 0) {
      int32_t s = pos % cap;        // floor mod, as torch.remainder
      if (s != 0 && ((s < 0) != (cap < 0))) s += cap;
      slot = s;
    }
    const int32_t vals[kRingCols] = {
        now, p.disp_idx[b], p.rec_kind[b], p.rec_node[b], p.rec_src[b],
        p.rec_tag[b], p.rec_parent[b], p.ev_lamport[b]};
    const size_t c0 = static_cast<size_t>(b) * TC;
#pragma unroll
    for (int c = 0; c < kRingCols; ++c) {
      for (int i = lane; i < TC; i += 32)
        p.tr_out[c][c0 + i] = i == slot ? vals[c] : p.tr_in[c][c0 + i];
    }
    if (lane == 0) p.o_trace_pos[b] = add32(pos, rec ? 1 : 0);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 = launched). Requires C <= 256, N <= 32,
// E <= 32; the table section runs when E > 0, the ring when TC > 0.
extern "C" int emit_write_launch(const EmitParams* params, void* stream) {
  const EmitParams& p = *params;
  if (p.B <= 0 || (p.E == 0 && p.TC == 0)) return 0;
  if (p.C < 1 || p.C > 32 * kMaxChunks || p.N < 1 || p.N > 32 || p.E < 0
      || p.E > kMaxE || p.n_sends < 0 || p.n_sends > p.E || p.P < 0
      || p.TC < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((p.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  emit_write_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
