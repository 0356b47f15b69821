// apply_knobs: the knob write of the schedule fuzzer, IN PLACE: it writes
// only the R + D event-table rows the knobs own, straight into the
// state's table columns.
//
// Replaces the JAX package's `_apply_batch`
// (madsim_tpu/search/mutate.py:499): write a batch of knob vectors into a
// batched init state, enforcing every bound at write time. Rows
// n_init .. n_init + R take the R scenario rows, the next D rows the dup
// slots, as the plain version documents (madsim_tpu_torch/ops/
// apply_knobs.py `apply_knobs_plain`):
//
//   scenario row j   deadline = clip(row_time, 0, tlimit) (time_ok) or the
//                    base time, T_INF when off (drop_ok rows only); kind
//                    EV_SUPER / EV_FREE; node = clip(row_node, -1, N - 1)
//                    (node_ok), NODE_RANDOM when outside pool_ok[j];
//                    src = row_flag & 1 (dir_ok); tag = base op; payload =
//                    base payload with word P-1 = clip(row_val, val_lo,
//                    val_hi) (val_ok), word P-2 = row_flag & 1 (torn_ok)
//   dup slot d       row s = clip(dup_src, 0, R - 1) as above, at
//                    clip(dup_time, 0, tlimit), on where dup_on and
//                    drop_ok[s]
//   other rows       not touched
//   lane scalars     (new [B] outputs) loss = clip(loss, 0, 0.99),
//                    lat_lo = clip(lat_lo, 0, 30 s), lat_hi = max(lat_lo,
//                    clip(lat_hi, 0, 30 s)), jitter = clip(jitter, 0, 1 s)
//                    with the build's jitter gate else the state's own,
//                    prio_nudge as given
//
// The written rows depend on the knobs, the plan and the lane's tlimit and
// jitter only, never on what the rows held: writing twice is writing once
// (a graph replay on the same operands repeats the same work). Every value
// is an integer or a float32 clip: the kernel must equal the plain version
// exactly. The reference's one-hot row gather of the dup payload is a
// plain indexed load here, with the same values.
//
// Bound: bytes. The write needs each lane's knob vector, tlimit and
// jitter, the plan's base rows and guards once, and writes each lane's
// R + D rows (five int32 columns and P payload words each) and its five
// scalars. Design: a block takes a tile of up to 32 lanes. It loads the
// plan's per-row tables (base rows, guards, value bounds, pools) and the
// tile's knobs (contiguous runs) into shared memory, every load issued
// before the first barrier, so the block waits on memory once; then one
// thread per (lane, written row) computes the row's five fields and its
// two knob-driven payload words once, from shared memory, writes the
// fields (consecutive threads on consecutive rows of a lane's column
// segment) and leaves the row's source and words in shared memory; then
// the block writes each lane's contiguous (R + D) * P payload slab with
// consecutive threads on consecutive 16-byte units (words, where P is not
// a multiple of 4). Indices advance by additions (no division in the
// loops).

#include <cstdint>

// The launch parameters, field for field the ctypes structure of the
// wrapper (it names this struct); outside the unnamed namespace so that
// the C entry point keeps external linkage.
struct ApplyParams {
  int32_t* t_deadline;           // the state's columns, written in place
  int32_t* t_kind;
  int32_t* t_node;
  int32_t* t_src;
  int32_t* t_tag;
  int32_t* t_payload;
  const int32_t* tlimit;
  const int32_t* jitter_in;
  const int32_t* k_row_time;
  const int32_t* k_row_node;
  const uint8_t* k_row_on;
  const int32_t* k_row_val;
  const int32_t* k_row_flag;
  const int32_t* k_dup_src;
  const int32_t* k_dup_time;
  const uint8_t* k_dup_on;
  const float* k_loss;
  const int32_t* k_lat_lo;
  const int32_t* k_lat_hi;
  const int32_t* k_jitter;
  const int32_t* k_prio_nudge;
  const int32_t* base_time;
  const int32_t* base_op;
  const int32_t* base_node;
  const int32_t* base_src;
  const int32_t* base_payload;   // [R, P]
  const uint8_t* time_ok;
  const uint8_t* node_ok;
  const uint8_t* drop_ok;
  const uint8_t* pool_ok;        // [R, N + 1]
  const uint8_t* val_ok;
  const int32_t* val_lo;
  const int32_t* val_hi;
  const uint8_t* dir_ok;
  const uint8_t* torn_ok;
  float* o_loss;
  int32_t* o_lat_lo;
  int32_t* o_lat_hi;
  int32_t* o_jitter;
  int32_t* o_prio_nudge;
  int B, C, P, R, D, N, n_init, jitter_gate;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanesPerBlock = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int32_t kTInf = 2147483647;
constexpr int32_t kEvFree = 0;
constexpr int32_t kEvSuper = 3;
constexpr int32_t kNodeRandom = -1;
constexpr int32_t kLatCap = 30000000;
constexpr int32_t kJitCap = 1000000;
// the guards of a row, as bits of one shared word
constexpr int32_t kTimeOk = 1, kNodeOk = 2, kDropOk = 4, kValOk = 8,
                  kDirOk = 16, kTornOk = 32;

__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}

// jnp.clip on float32: NaN propagates
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

// shared memory of a block, in 32-bit words: the plan's tables (time, op,
// node, src, val_lo, val_hi, guard bits: 7 R; payload R * P); the tile's
// knobs (row time, node, val, flag: 4 lanes R; dup src, time: 2 lanes D;
// tlimit: lanes); per written row of the tile, its source row, value word
// and flag word (3 lanes (R + D)); then the bytes: pools R * (N + 1), the
// tile's row_on and dup_on, lanes (R + D)
size_t smem_words(int R, int D, int P, int N, int lanes) {
  const size_t L = lanes, W = static_cast<size_t>(R) + D;
  return 7 * static_cast<size_t>(R) + static_cast<size_t>(R) * P
         + L * (4 * static_cast<size_t>(R) + 2 * D + 1) + 3 * L * W
         + (static_cast<size_t>(R) * (N + 1) + L * W + 3) / 4;
}

// Write the tile's payload slabs, VEC words a store (VEC = 4: 16-byte
// stores, when P is a multiple of 4 and the payload is 16-byte aligned),
// consecutive threads on consecutive units of a lane's slab: the base
// payload of the row's source, with its value and flag words.
template <int VEC>
__device__ __forceinline__ void write_slab(
    const ApplyParams& p, const int32_t* s_pay, const int32_t* s_guard,
    const int32_t* s_rsrc, const int32_t* s_rval, const int32_t* s_rflag,
    int64_t b0, int lanes) {
  const int P = p.P, W = p.R + p.D, U = p.P / VEC;  // units a row
  const int tid = threadIdx.x, stride = blockDim.x;
  int q = tid % U;
  int l = (tid / U) / W, w = (tid / U) % W;
  const int dq = stride % U, drow = stride / U;
  const int dl = drow / W, dw = drow % W;
  for (int e = tid; e < lanes * W * U; e += stride) {
    const int i = l * W + w;
    const int s = s_rsrc[i];
    const int g = s_guard[s];
    int32_t v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int word = q * VEC + k;
      int32_t x = s_pay[s * P + word];
      if (word == P - 1 && (g & kValOk)) x = s_rval[i];
      if (P >= 2 && word == P - 2 && (g & kTornOk)) x = s_rflag[i];
      v[k] = x;
    }
    int32_t* dst = p.t_payload + ((b0 + l) * p.C + p.n_init + w) * P
                   + q * VEC;
    if constexpr (VEC == 4)
      *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
    else
      *dst = v[0];
    q += dq;  // e += stride, in (lane, row, unit) coordinates
    int carry = 0;
    if (q >= U) {
      q -= U;
      carry = 1;
    }
    w += dw + carry;
    l += dl;
    if (w >= W) {
      w -= W;
      ++l;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
apply_knobs_kernel(const ApplyParams p, int lanes_per_block, int vec4) {
  extern __shared__ int32_t sm[];
  const int R = p.R, D = p.D, P = p.P, N = p.N, W = R + D;
  const int LB = lanes_per_block;
  int32_t* s_time = sm;
  int32_t* s_op = s_time + R;
  int32_t* s_node = s_op + R;
  int32_t* s_src = s_node + R;
  int32_t* s_vlo = s_src + R;
  int32_t* s_vhi = s_vlo + R;
  int32_t* s_guard = s_vhi + R;
  int32_t* s_pay = s_guard + R;                           // [R, P]
  int32_t* k_time = s_pay + static_cast<size_t>(R) * P;   // [lanes, R]
  int32_t* k_node = k_time + LB * R;
  int32_t* k_val = k_node + LB * R;
  int32_t* k_flag = k_val + LB * R;
  int32_t* d_src = k_flag + LB * R;                       // [lanes, D]
  int32_t* d_time = d_src + LB * D;
  int32_t* s_tlimit = d_time + LB * D;                    // [lanes]
  int32_t* s_rsrc = s_tlimit + LB;                        // [lanes, W]
  int32_t* s_rval = s_rsrc + LB * W;
  int32_t* s_rflag = s_rval + LB * W;
  uint8_t* s_pool = reinterpret_cast<uint8_t*>(s_rflag + LB * W);
  uint8_t* k_on = s_pool + R * (N + 1);                   // [lanes, R]
  uint8_t* d_on = k_on + LB * R;                          // [lanes, D]

  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * LB;
  const int lanes = static_cast<int>(p.B - b0 < LB ? p.B - b0 : LB);

  // ---- every load of the block, none waiting on another: the plan's
  // tables, the tile's knobs (contiguous runs of lanes * R and lanes * D
  // words), and the lane scalars
  for (int i = tid; i < R; i += stride) {
    s_time[i] = p.base_time[i];
    s_op[i] = p.base_op[i];
    s_node[i] = p.base_node[i];
    s_src[i] = p.base_src[i];
    s_vlo[i] = p.val_lo[i];
    s_vhi[i] = p.val_hi[i];
    s_guard[i] = (p.time_ok[i] ? kTimeOk : 0) | (p.node_ok[i] ? kNodeOk : 0)
                 | (p.drop_ok[i] ? kDropOk : 0) | (p.val_ok[i] ? kValOk : 0)
                 | (p.dir_ok[i] ? kDirOk : 0) | (p.torn_ok[i] ? kTornOk : 0);
  }
  for (int i = tid; i < R * P; i += stride) s_pay[i] = p.base_payload[i];
  for (int i = tid; i < R * (N + 1); i += stride) s_pool[i] = p.pool_ok[i];
  const int64_t kr0 = b0 * R, kd0 = b0 * D;
#pragma unroll 4
  for (int i = tid; i < lanes * R; i += stride) {
    k_time[i] = p.k_row_time[kr0 + i];
    k_node[i] = p.k_row_node[kr0 + i];
    k_val[i] = p.k_row_val[kr0 + i];
    k_flag[i] = p.k_row_flag[kr0 + i];
    k_on[i] = p.k_row_on[kr0 + i];
  }
  for (int i = tid; i < lanes * D; i += stride) {
    d_src[i] = p.k_dup_src[kd0 + i];
    d_time[i] = p.k_dup_time[kd0 + i];
    d_on[i] = p.k_dup_on[kd0 + i];
  }
  if (tid < lanes) {
    const int64_t b = b0 + tid;
    s_tlimit[tid] = p.tlimit[b];
    p.o_loss[b] = clipf(p.k_loss[b], 0.0f, 0.99f);
    const int32_t lo = clip(p.k_lat_lo[b], 0, kLatCap);
    p.o_lat_lo[b] = lo;
    p.o_lat_hi[b] = max(lo, clip(p.k_lat_hi[b], 0, kLatCap));
    p.o_jitter[b] = p.jitter_gate ? clip(p.k_jitter[b], 0, kJitCap)
                                  : p.jitter_in[b];
    p.o_prio_nudge[b] = p.k_prio_nudge[b];
  }
  __syncthreads();

  // ---- one thread per (lane, written row): the five column fields, from
  // shared memory alone
  {
    int l = tid / W, w = tid % W;
    const int dl = stride / W, dw = stride % W;
    for (int i = tid; i < lanes * W; i += stride) {
      const int32_t tlimit = s_tlimit[l];
      int s;            // the scenario row this table row writes
      bool on;
      int32_t deadline;
      if (w < R) {
        s = w;
        on = !(s_guard[s] & kDropOk) || k_on[l * R + s];
        deadline = (s_guard[s] & kTimeOk) ? clip(k_time[l * R + s], 0,
                                                 tlimit)
                                          : s_time[s];
      } else {
        const int di = l * D + (w - R);
        s = clip(d_src[di], 0, R - 1);
        on = d_on[di] && (s_guard[s] & kDropOk);
        deadline = clip(d_time[di], 0, tlimit);
      }
      const int g = s_guard[s];
      const int ks = l * R + s;
      int32_t node = (g & kNodeOk) ? clip(k_node[ks], -1, N - 1)
                                   : s_node[s];
      const bool in_pool = node >= -1 && node <= N - 1
          && s_pool[s * (N + 1) + node + 1];
      if ((g & kNodeOk) && !in_pool) node = kNodeRandom;
      const int32_t flag = k_flag[ks];
      const int64_t row = (b0 + l) * p.C + p.n_init + w;
      p.t_deadline[row] = on ? deadline : kTInf;
      p.t_kind[row] = on ? kEvSuper : kEvFree;
      p.t_node[row] = node;
      p.t_src[row] = (g & kDirOk) ? (flag & 1) : s_src[s];
      p.t_tag[row] = s_op[s];
      s_rsrc[i] = s;
      s_rval[i] = (g & kValOk) ? clip(k_val[ks], s_vlo[s], s_vhi[s]) : 0;
      s_rflag[i] = flag & 1;
      w += dw;       // i += stride, in (lane, row) coordinates
      l += dl;
      if (w >= W) {
        w -= W;
        ++l;
      }
    }
  }
  __syncthreads();

  // ---- each lane's contiguous (R + D) * P payload slab
  if (vec4)
    write_slab<4>(p, s_pay, s_guard, s_rsrc, s_rval, s_rflag, b0, lanes);
  else
    write_slab<1>(p, s_pay, s_guard, s_rsrc, s_rval, s_rflag, b0, lanes);
}

}  // namespace

extern "C" int apply_knobs_launch(const ApplyParams* params, void* stream) {
  const ApplyParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.C < 1 || p.P < 1 || p.R < 1 || p.D < 0 || p.N < 1 || p.n_init < 0
      || p.n_init + p.R + p.D > p.C)
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes = kMaxLanesPerBlock;
  size_t bytes = 4 * smem_words(p.R, p.D, p.P, p.N, lanes);
  while (bytes > kDefaultSmem && lanes > 1) {
    lanes /= 2;
    bytes = 4 * smem_words(p.R, p.D, p.P, p.N, lanes);
  }
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        apply_knobs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec4 = p.P % 4 == 0
      && (reinterpret_cast<uintptr_t>(p.t_payload) & 15) == 0;
  const dim3 grid(static_cast<unsigned>((p.B + lanes - 1) / lanes));
  apply_knobs_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(p, lanes, vec4);
  return static_cast<int>(cudaGetLastError());
}
