// emit_write: the emission write of one simulation step, for every lane,
// with the flight-recorder ring write as its epilogue, IN PLACE.
//
// Replaces the XLA-lowered emission write of the JAX package's step
// (madsim_tpu/core/step.py `live_step` section 4, lines 476-655:
// ops/select.py `first_k_free`, the per-send network fault model, the
// per-timer skew stretch, the one-pass column write and the lineage
// provenance write, the latency plane's root column at lines 629-641 and
// the span plane's carried column at 642-653) and the ring-row write
// (lines 941-1001, with the plane columns tr_qlen and tr_lat at 966-976
// and tr_qw at 977-981), with jax's threefry2x32 draws
// (madsim_tpu/core/prng.py) inlined from threefry.cuh.
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
//                  the lineage plane ev_prov = (disp_idx, ev_lamport),
//                  with the latency plane ev_root_t = ev_root, and with
//                  the span plane its six ev_span words = span_new
//   outputs        sent, delivered_drop, overflow, high_water per lane;
//                  with the profiler (delay_acc != nullptr) the int32 sum
//                  of the latencies of the delivered (ok) sends
//   ring (TC > 0)  where fired & trace_on, the row at trace_pos mod
//                  trace_cap of the eight tr_* columns takes this step's
//                  record, and of tr_qlen / tr_lat / tr_qw (when compiled
//                  in) occ_disp / lat_ring / lat_sojourn; trace_pos
//                  counts it (a new [B] output)
//
// The plane columns are null pointers when their plane is compiled out:
// the kernel then does no plane work (a uniform branch per launch, and
// the delay sum's shuffles are skipped whole), as before the planes.
//
// The JAX function returns new tables. This kernel writes the rows that
// emissions take, and the one ring row, straight into the tensors it is
// given and touches no other row: the step owns those tensors (the
// runners step a private copy of the caller's state). Every value is an
// integer or the exact float32 compare of a Bernoulli draw, so the kernel
// must equal its plain PyTorch version (madsim_tpu_torch/ops/emit_write.py
// `emit_write_plain`, in place too) exactly.
//
// Bound: bytes. The write needs each lane's t_kind row (to rank the free
// rows), its staged masks, lane scalars and statistics, the operands of
// its masked emissions, and for each written emission its payload read
// and its table row written; with the ring, one ring row per recording
// lane. At the flagship's step-512 operands (B = 100,000, C = 96, E = 8,
// P = 8, ring of 64) that is 61,398,709 B, 0.0183 ms at 3.35 TB/s; the
// draws (a few dozen threefry blocks per masked send) are far below the
// card's integer rate. Design: a lane gets epad threads, the least power
// of two >= E, so a warp serves 32 / epad lanes (4 at the flagship's
// E = 8) and the draws keep every thread of the warp busy: with one warp
// per lane, 24 of its 32 threads would idle through the 8 emissions'
// threefry blocks, and the warp-instructions issued, not bytes, would set
// the time. A lane's threads rank its free rows together, epad rows of
// t_kind at a time with a ballot + popc (eight loads in flight before
// the ballots), and the thread holding the e-th free row (e < E) records
// it in a per-warp slot list in shared memory. Thread e of a lane computes emission e's draws and decision in
// registers and writes its row's five int32 columns; the payload words
// and provenance pairs of the taken rows are then written by the warp
// together, consecutive words of a row on consecutive threads. Nothing
// reads or copies a row the step leaves as it was.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxC = 256;
constexpr int kMaxE = 32;                // one emission per thread
constexpr int kBatch = 8;                // t_kind reads issued together
constexpr int kRingCols = 8;
constexpr int kPlaneRingCols = 3;        // tr_qlen, tr_lat, tr_qw
constexpr int kSpanWords = 6;
constexpr int32_t kEvFree = 0;
constexpr int32_t kEvMsg = 1;
constexpr int32_t kEvTimer = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;

}  // namespace

// Operands of one launch (host struct, passed by value to the kernel).
// Tables are [B, C] (payload [B, C, P], provenance [B, C, 2]), written in
// place; staged emissions [B, E] (payload [B, E, P]); lane scalars [B]
// (k_net [B, 2], clog_node [B, N], clog_link [B, N, N]); ring columns
// [B, TC], written in place, in the order tr_now, tr_step, tr_kind,
// tr_node, tr_src, tr_tag, tr_parent, tr_lamport. All contiguous, int32
// unless noted.
struct EmitParams {
  int32_t* t_deadline;
  int32_t* t_kind;
  int32_t* t_node;
  int32_t* t_src;
  int32_t* t_tag;
  int32_t* t_payload;
  int32_t* ev_prov;
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
  int32_t* tr[kRingCols];
  int32_t* o_trace_pos;
  int32_t* ev_root_t;         // [B, C] or nullptr (latency plane)
  const int32_t* ev_root;
  int32_t* tr_qlen;           // [B, TC] or nullptr (profiler + ring)
  const int32_t* occ_disp;
  int32_t* tr_lat;            // [B, TC] or nullptr (latency + ring)
  const int32_t* lat_ring;
  int32_t* delay_acc;         // [B] or nullptr (profiler)
  int32_t* ev_span;           // [B, C, 6] or nullptr (span plane)
  const int32_t* span_new;    // [B, 6]
  int32_t* tr_qw;             // [B, TC] or nullptr (span plane + ring)
  const int32_t* lat_sojourn;
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

// The value of ring column c (tr_now, tr_step, tr_kind, tr_node, tr_src,
// tr_tag, tr_parent, tr_lamport) for lane b.
__device__ __forceinline__ int32_t ring_value(const EmitParams& p, int c,
                                              int64_t b, int32_t now) {
  switch (c) {
    case 0: return now;
    case 1: return p.disp_idx[b];
    case 2: return p.rec_kind[b];
    case 3: return p.rec_node[b];
    case 4: return p.rec_src[b];
    case 5: return p.rec_tag[b];
    case 6: return p.rec_parent[b];
    default: return p.ev_lamport[b];
  }
}

// A warp serves G = 32 >> log_epad lanes; each lane has epad = 1 <<
// log_epad threads (epad >= E), thread e of a lane handling emission e.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
emit_write_kernel(const EmitParams p, const int log_epad) {
  // slot[w][g * epad + e]: the table row of lane g's e-th free row
  __shared__ int slot[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int epad = 1 << log_epad;
  const int G = 32 >> log_epad;
  const int g = lane >> log_epad;
  const int e = lane & (epad - 1);
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + w) * G;
  if (b0 >= p.B) return;  // warp-uniform
  const int64_t b = b0 + g;
  const bool lane_ok = b < p.B;
  const int C = p.C, E = p.E, N = p.N;
  const int32_t now = lane_ok ? p.now[b] : 0;

  if (E > 0) {
    // ---- rank the free rows: the lane's epad threads read its row epad
    // entries at a time, kBatch reads issued before their ballots; the
    // lane's bits of each ballot are its rows in order
    const int gshift = g * epad;
    const uint32_t glow = epad == 32 ? kFull : (1u << epad) - 1u;
    const uint32_t below = (1u << e) - 1u;
    const int32_t* kind = p.t_kind + (lane_ok ? b : 0) * C;
    int n_free = 0;
    for (int r0 = 0; r0 < C; r0 += kBatch * epad) {   // warp-uniform
      int32_t kv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = r0 + j * epad + e;
        kv[j] = lane_ok && r < C ? kind[r] : -1;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool free = kv[j] == kEvFree;
        const uint32_t word = (__ballot_sync(kFull, free) >> gshift) & glow;
        const int rank = n_free + __popc(word & below);
        if (free && rank < E) slot[w][gshift + rank] = r0 + j * epad + e;
        n_free += __popc(word);
      }
    }
    __syncwarp();

    // ---- emission e of lane b: its draws and decision, in registers
    bool m = false, write = false, ovf = false, bad_send = false;
    int32_t lat_ok = 0;               // this send's latency if delivered
    int32_t dl = 0, ekind = 0, enode = 0, etag = 0, h = 0;
    const bool is_send = e < p.n_sends;
    if (lane_ok && e < E) {
      const int64_t ei = b * E + e;
      h = p.h_node[b];
      const int hc = clip(h, 0, N - 1);
      m = p.em_m[ei] != 0;
      const int32_t a = p.em_a[ei];
      etag = p.em_tag[ei];
      const bool slot_ok = e < n_free;
      const int32_t dlat = p.dlat_h[b];
      const int ns = p.n_sends > 1 ? p.n_sends : 1;
      const int n_keys = 2 * ns + (p.use_jitter ? E : 0);
      const uint32_t k0 = p.k_net[2 * b], k1 = p.k_net[2 * b + 1];
      int32_t jit = 0;
      if (m && p.use_jitter) {
        uint32_t j0, j1;
        threefry::split_key(k0, k1, n_keys, 2 * ns + e, j0, j1);
        jit = threefry::randint(j0, j1, 0, p.jitter[b]);
      }
      if (is_send) {
        const int dst = clip(a, 0, N - 1);
        ekind = kEvMsg;
        enode = dst;
        if (m) {
          const int64_t nb = b * N;
          const bool clogged = p.clog_node[nb + hc] != 0
              || p.clog_node[nb + dst] != 0
              || p.clog_link[(nb + hc) * N + dst] != 0;
          uint32_t l0, l1, t0, t1;
          threefry::split_key(k0, k1, n_keys, 2 * e, l0, l1);
          const bool lost = threefry::bernoulli(l0, l1, p.loss[b]);
          threefry::split_key(k0, k1, n_keys, 2 * e + 1, t0, t1);
          const int32_t lat = add32(
              threefry::randint(t0, t1, p.lat_lo[b], p.lat_hi[b]), jit);
          const bool ok = !clogged && !lost;
          bad_send = !ok;
          lat_ok = ok ? lat : 0;
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
    const uint32_t sends = __ballot_sync(kFull, lane_ok && e < E && is_send
                                                && m);
    const uint32_t drops = __ballot_sync(kFull, bad_send);
    const uint32_t wrote = __ballot_sync(kFull, write);
    const uint32_t ovfs = __ballot_sync(kFull, ovf);
    const uint32_t mine = epad == 32 ? kFull
        : ((1u << epad) - 1u) << (g * epad);
    if (p.delay_acc != nullptr) {     // launch-uniform
      // the lane's delivered latencies summed over its epad threads
      // (xor offsets below epad stay inside the lane's group; every
      // thread of the warp runs each shuffle)
      int32_t acc = lat_ok;
      for (int off = 1; off < epad; off <<= 1)
        acc = add32(acc, __shfl_xor_sync(kFull, acc, off));
      if (lane_ok && e == 0) p.delay_acc[b] = acc;
    }
    if (lane_ok && e == 0) {
      p.sent[b] = __popc(sends & mine);
      p.delivered_drop[b] = __popc(drops & mine);
      p.overflow[b] = (ovfs & mine) != 0 ? 1 : 0;
      p.high_water[b] = (C - n_free) + __popc(wrote & mine);
    }

    // ---- the five int32 columns of the row this emission takes
    if (write) {
      const int64_t i = b * C + slot[w][lane];
      p.t_deadline[i] = dl;
      p.t_kind[i] = ekind;
      p.t_node[i] = enode;
      p.t_src[i] = h;
      p.t_tag[i] = etag;
    }

    // ---- payload words and provenance pairs of the taken rows, the warp
    // writing each row's words on consecutive threads (s = g * epad + e
    // numbers the warp's 32 emission slots)
    const int P = p.P;
    for (int i = lane; i < 32 * P; i += 32) {
      const int s = i / P;
      if ((wrote >> s) & 1u) {
        const int64_t bs = b0 + (s >> log_epad);
        const int word = i - s * P;
        p.t_payload[(bs * C + slot[w][s]) * P + word] =
            p.em_payload[(bs * E + (s & (epad - 1))) * P + word];
      }
    }
    if (p.ev_root_t != nullptr) {
      // the root column: one word a taken row, thread s for slot s
      if ((wrote >> lane) & 1u) {
        const int64_t bs = b0 + (lane >> log_epad);
        p.ev_root_t[bs * C + slot[w][lane]] = p.ev_root[bs];
      }
    }
    if (p.ev_span != nullptr) {       // launch-uniform
      // the span vectors: six words a taken row, consecutive threads on
      // consecutive words
      for (int i = lane; i < 32 * kSpanWords; i += 32) {
        const int s = i / kSpanWords;
        if ((wrote >> s) & 1u) {
          const int64_t bs = b0 + (s >> log_epad);
          const int word = i - s * kSpanWords;
          p.ev_span[(bs * C + slot[w][s]) * kSpanWords + word] =
              p.span_new[bs * kSpanWords + word];
        }
      }
    }
    if (p.has_prov) {
      for (int i = lane; i < 64; i += 32) {
        const int s = i >> 1;
        if ((wrote >> s) & 1u) {
          const int64_t bs = b0 + (s >> log_epad);
          p.ev_prov[2 * (bs * C + slot[w][s]) + (i & 1)] =
              (i & 1) ? p.ev_lamport[bs] : p.disp_idx[bs];
        }
      }
    }
  }

  // ---- epilogue: the flight-recorder ring row, a lane's threads taking
  // its eight columns in turn
  if (p.TC > 0 && lane_ok) {
    const bool rec = p.fired[b] != 0 && p.trace_on[b] != 0;
    const int32_t pos = p.trace_pos[b];
    const int32_t cap = p.trace_cap[b];
    int slot_r = -1;
    if (rec && cap != 0) {
      int32_t r = pos % cap;        // floor mod, as torch.remainder
      if (r != 0 && ((r < 0) != (cap < 0))) r += cap;
      slot_r = r;
    }
    if (slot_r >= 0 && slot_r < p.TC) {
      const int64_t i = b * p.TC + slot_r;
      for (int c = e; c < kRingCols + kPlaneRingCols; c += epad) {
        if (c < kRingCols)
          p.tr[c][i] = ring_value(p, c, b, now);
        else if (c == kRingCols && p.tr_qlen != nullptr)
          p.tr_qlen[i] = p.occ_disp[b];
        else if (c == kRingCols + 1 && p.tr_lat != nullptr)
          p.tr_lat[i] = p.lat_ring[b];
        else if (c == kRingCols + 2 && p.tr_qw != nullptr)
          p.tr_qw[i] = p.lat_sojourn[b];
      }
    }
    if (e == 0) p.o_trace_pos[b] = add32(pos, rec ? 1 : 0);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 = launched). Requires C <= 256, N <= 32,
// E <= 32; the table section runs when E > 0, the ring when TC > 0.
extern "C" int emit_write_launch(const EmitParams* params, void* stream) {
  const EmitParams& p = *params;
  if (p.B <= 0 || (p.E == 0 && p.TC == 0)) return 0;
  if (p.C < 1 || p.C > kMaxC || p.N < 1 || p.N > 32 || p.E < 0
      || p.E > kMaxE || p.n_sends < 0 || p.n_sends > p.E || p.P < 0
      || p.TC < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_epad = 0;                      // lanes of 2^log_epad >= E threads
  while ((1 << log_epad) < p.E) ++log_epad;
  const int64_t lanes_per_block = kWarpsPerBlock * (32 >> log_epad);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>(
      (p.B + lanes_per_block - 1) / lanes_per_block));
  emit_write_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      p, log_epad);
  return static_cast<int>(cudaGetLastError());
}
