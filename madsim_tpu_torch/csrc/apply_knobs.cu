// apply_knobs: the knob write of the schedule fuzzer, one thread per
// (lane, event-table row).
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
//   other rows       copied
//   lane scalars     (the thread of row 0) loss = clip(loss, 0, 0.99),
//                    lat_lo = clip(lat_lo, 0, 30 s), lat_hi = max(lat_lo,
//                    clip(lat_hi, 0, 30 s)), jitter = clip(jitter, 0, 1 s)
//                    with the build's jitter gate else the state's own,
//                    prio_nudge as given
//
// Every value is an integer or a float32 clip: the kernel must equal the
// plain version exactly. The reference's one-hot row gather of the dup
// payload is a plain indexed load here, with the same values.
//
// Bound: bytes. The write needs each lane's knob vector, tlimit and
// jitter, and the R + D rows it writes (five int32 columns and P payload
// words each); the result is new columns, so the kernel also copies every
// other row of the table (read once, written once), which at the
// flagship's C = 96 is most of its traffic. Threads of a warp hold
// neighbouring rows of a lane, so the copy is coalesced.

#include <cstdint>

// The launch parameters, field for field the ctypes structure of the
// wrapper (it names this struct); outside the unnamed namespace so that
// the C entry point keeps external linkage.
struct ApplyParams {
  const int32_t* t_deadline;
  const int32_t* t_kind;
  const int32_t* t_node;
  const int32_t* t_src;
  const int32_t* t_tag;
  const int32_t* t_payload;
  int32_t* o_deadline;
  int32_t* o_kind;
  int32_t* o_node;
  int32_t* o_src;
  int32_t* o_tag;
  int32_t* o_payload;
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
constexpr int32_t kTInf = 2147483647;
constexpr int32_t kEvFree = 0;
constexpr int32_t kEvSuper = 3;
constexpr int32_t kNodeRandom = -1;
constexpr int32_t kLatCap = 30000000;
constexpr int32_t kJitCap = 1000000;

__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}

// jnp.clip on float32: NaN propagates
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
apply_knobs_kernel(const ApplyParams p) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (idx >= static_cast<size_t>(p.B) * p.C) return;
  const int b = static_cast<int>(idx / p.C);
  const int row = static_cast<int>(idx % p.C);
  const int P = p.P, R = p.R, N = p.N;
  const int j = row - p.n_init;
  int32_t* pay_out = p.o_payload + idx * P;
  if (j < 0 || j >= R + p.D) {
    p.o_deadline[idx] = p.t_deadline[idx];
    p.o_kind[idx] = p.t_kind[idx];
    p.o_node[idx] = p.t_node[idx];
    p.o_src[idx] = p.t_src[idx];
    p.o_tag[idx] = p.t_tag[idx];
    const int32_t* pay_in = p.t_payload + idx * P;
    for (int w = 0; w < P; ++w) pay_out[w] = pay_in[w];
  } else {
    const int32_t tlimit = p.tlimit[b];
    int s;            // the scenario row this table row writes
    bool on;
    int32_t deadline;
    if (j < R) {
      s = j;
      on = !p.drop_ok[s] || p.k_row_on[static_cast<size_t>(b) * R + s];
      deadline = p.time_ok[s]
          ? clip(p.k_row_time[static_cast<size_t>(b) * R + s], 0, tlimit)
          : p.base_time[s];
    } else {
      const size_t di = static_cast<size_t>(b) * p.D + (j - R);
      s = clip(p.k_dup_src[di], 0, R - 1);
      on = p.k_dup_on[di] && p.drop_ok[s];
      deadline = clip(p.k_dup_time[di], 0, tlimit);
    }
    const size_t ks = static_cast<size_t>(b) * R + s;
    int32_t node = p.node_ok[s] ? clip(p.k_row_node[ks], -1, N - 1)
                                : p.base_node[s];
    const bool in_pool = node >= -1 && node <= N - 1
        && p.pool_ok[s * (N + 1) + node + 1];
    if (p.node_ok[s] && !in_pool) node = kNodeRandom;
    const int32_t flag = p.k_row_flag[ks];
    p.o_deadline[idx] = on ? deadline : kTInf;
    p.o_kind[idx] = on ? kEvSuper : kEvFree;
    p.o_node[idx] = node;
    p.o_src[idx] = p.dir_ok[s] ? (flag & 1) : p.base_src[s];
    p.o_tag[idx] = p.base_op[s];
    const int32_t* pay_base = p.base_payload + static_cast<size_t>(s) * P;
    for (int w = 0; w < P; ++w) pay_out[w] = pay_base[w];
    if (p.val_ok[s])
      pay_out[P - 1] = clip(p.k_row_val[ks], p.val_lo[s], p.val_hi[s]);
    if (P >= 2 && p.torn_ok[s]) pay_out[P - 2] = flag & 1;
  }
  if (row == 0) {
    p.o_loss[b] = clipf(p.k_loss[b], 0.0f, 0.99f);
    const int32_t lo = clip(p.k_lat_lo[b], 0, kLatCap);
    p.o_lat_lo[b] = lo;
    p.o_lat_hi[b] = max(lo, clip(p.k_lat_hi[b], 0, kLatCap));
    p.o_jitter[b] = p.jitter_gate ? clip(p.k_jitter[b], 0, kJitCap)
                                  : p.jitter_in[b];
    p.o_prio_nudge[b] = p.k_prio_nudge[b];
  }
}

}  // namespace

extern "C" int apply_knobs_launch(const ApplyParams* params, void* stream) {
  const ApplyParams& p = *params;
  if (p.B <= 0) return 0;
  if (p.C < 1 || p.P < 1 || p.R < 1 || p.D < 0 || p.N < 1 || p.n_init < 0
      || p.n_init + p.R + p.D > p.C)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(p.B) * p.C;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  apply_knobs_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
