// node_rows: the per-lane row gather and the in-place masked row write
// of the step (K4).
//
// Replaces the JAX package's one-hot row slice and scatter
// (madsim_tpu/ops/select.py:66 `take_row`, :76 `put_row`;
// madsim_tpu/core/step.py:69 `_slice_node`, :73 `_scatter_node`) where
// the step applies them to state it owns. The plain versions, held equal
// to these kernels, are madsim_tpu_torch/ops/node_rows.py
// `node_gather_plain` (the tree of `select.take_row`) and
// `put_rows_plain` (an indexed write held equal to `select.put_row`):
//
//   node_gather  for each leaf of a table ([B, R, row...] in, [B, row...]
//                out), out[b] = leaf[b, clamp(idx[b], 0, R - 1)]
//   put_rows     for each entry of a table, in place: where mask[b] holds
//                and 0 <= idx[b] < R, dst[b, idx[b]] = the lane's source
//                row (src[b]), or the entry's scalar; an out-of-range
//                index writes nothing, as `put_row`'s one-hot does
//
// The tables (pointers, row sizes, element sizes; a scalar's bits) ride
// in the parameter block, so a CUDA graph holds the step's own buffers
// and nothing is copied from the host a step.
//
// Bound: bytes, every row read once and written once (the flagship's
// 16 node-state leaves: a 344-byte row a lane each way, B=100,000).
// Design: a block takes a tile of one leaf's (or entry's) B * row
// elements, a thread one element, so consecutive threads copy
// consecutive elements (the output [B, row] is one coalesced stream,
// the source rows contiguous runs) and a lane's index and mask are one
// broadcast load for its threads. The launcher lays the leaves' tiles
// end to end (`first_block`); a block finds its leaf by a scan that is
// the same for all its threads, so the table reads are broadcasts and
// the element size a uniform branch.

#include <cstdint>

constexpr int kMaxGather = 48;   // leaves a node_gather launch
constexpr int kMaxPut = 16;      // entries a put_rows launch

// One leaf of node_gather: src [B, R, row] and dst [B, row], `row`
// elements of `esize` bytes; its tiles start at block `first_block` (set
// by the launcher).
struct GatherLeaf {
  const void* src;
  void* dst;
  int64_t row;
  int32_t esize;
  int32_t first_block;
};

// The launch parameters, field for field the ctypes structures of
// madsim_tpu_torch/ops/node_rows.py; outside the unnamed namespace so
// that the C entry points keep external linkage.
struct GatherParams {
  const int32_t* idx;   // [B]
  GatherLeaf leaves[kMaxGather];
  int64_t B;
  int32_t R, n_leaves;
  int32_t n_blocks, pad;    // set by the launcher
};

// One entry of put_rows: dst [B, R, row] written in place; src a row a
// lane at src + b * src_sb (null: the scalar `value`'s low esize bytes);
// idx [B]; mask [B] bool (null: every lane); its tiles start at block
// `first_block` (set by the launcher).
struct PutRow {
  void* dst;
  const void* src;
  const int32_t* idx;
  const uint8_t* mask;
  int64_t row;
  int64_t src_sb;
  uint64_t value;
  int32_t R, esize, first_block, pad;
};

struct PutParams {
  PutRow rows[kMaxPut];
  int64_t B;
  int32_t n, n_blocks;      // n_blocks: set by the launcher
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_elem(void* dst, const void* src,
                                          int64_t di, int64_t si,
                                          int esize) {
  switch (esize) {
    case 1: static_cast<uint8_t*>(dst)[di] =
        static_cast<const uint8_t*>(src)[si]; break;
    case 2: static_cast<uint16_t*>(dst)[di] =
        static_cast<const uint16_t*>(src)[si]; break;
    case 4: static_cast<uint32_t*>(dst)[di] =
        static_cast<const uint32_t*>(src)[si]; break;
    default: static_cast<uint64_t*>(dst)[di] =
        static_cast<const uint64_t*>(src)[si]; break;
  }
}

__device__ __forceinline__ void store_value(void* dst, int64_t di,
                                            uint64_t v, int esize) {
  switch (esize) {
    case 1: static_cast<uint8_t*>(dst)[di] = static_cast<uint8_t>(v); break;
    case 2: static_cast<uint16_t*>(dst)[di] = static_cast<uint16_t>(v);
      break;
    case 4: static_cast<uint32_t*>(dst)[di] = static_cast<uint32_t>(v);
      break;
    default: static_cast<uint64_t*>(dst)[di] = v; break;
  }
}

__global__ void __launch_bounds__(kThreads)
node_gather_kernel(const GatherParams p) {
  const int bid = blockIdx.x;
  int l = 0;      // the same for every thread of the block
  while (l + 1 < p.n_leaves && p.leaves[l + 1].first_block <= bid) ++l;
  const GatherLeaf& lf = p.leaves[l];
  const uint32_t row = static_cast<uint32_t>(lf.row);
  const uint32_t e = static_cast<uint32_t>(bid - lf.first_block) * kThreads
      + threadIdx.x;
  if (e >= static_cast<uint32_t>(p.B) * row) return;
  const uint32_t b = e / row, j = e - b * row;
  int32_t r = p.idx[b];
  r = r < 0 ? 0 : (r >= p.R ? p.R - 1 : r);
  copy_elem(lf.dst, lf.src, e,
            (static_cast<int64_t>(b) * p.R + r) * row + j, lf.esize);
}

__global__ void __launch_bounds__(kThreads)
put_rows_kernel(const PutParams p) {
  const int bid = blockIdx.x;
  int l = 0;      // the same for every thread of the block
  while (l + 1 < p.n && p.rows[l + 1].first_block <= bid) ++l;
  const PutRow& w = p.rows[l];
  const uint32_t row = static_cast<uint32_t>(w.row);
  const uint32_t e = static_cast<uint32_t>(bid - w.first_block) * kThreads
      + threadIdx.x;
  if (e >= static_cast<uint32_t>(p.B) * row) return;
  const uint32_t b = e / row, j = e - b * row;
  if (w.mask != nullptr && w.mask[b] == 0) return;
  const int32_t r = w.idx[b];
  if (r < 0 || r >= w.R) return;
  const int64_t di = (static_cast<int64_t>(b) * w.R + r) * row + j;
  if (w.src != nullptr)
    copy_elem(w.dst, w.src, di, b * w.src_sb + j, w.esize);
  else
    store_value(w.dst, di, w.value, w.esize);
}

inline bool esize_ok(int esize) {
  return esize == 1 || esize == 2 || esize == 4 || esize == 8;
}

// The tiles of one leaf or entry: B * row elements, indexed in 32 bits.
inline bool tiles(int64_t B, int64_t row, int32_t* blocks) {
  const int64_t n = B * row;
  if (row < 1 || n >= (int64_t{1} << 31)) return false;
  *blocks = static_cast<int32_t>((n + kThreads - 1) / kThreads);
  return true;
}

}  // namespace

extern "C" int node_gather_launch(const GatherParams* params, void* stream) {
  GatherParams p = *params;
  if (p.B < 0 || p.R < 1 || p.n_leaves < 1 || p.n_leaves > kMaxGather
      || p.idx == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B == 0) return 0;
  p.n_blocks = 0;
  for (int l = 0; l < p.n_leaves; ++l) {
    int32_t blocks;
    if (!esize_ok(p.leaves[l].esize) || !tiles(p.B, p.leaves[l].row,
                                               &blocks))
      return static_cast<int>(cudaErrorInvalidValue);
    p.leaves[l].first_block = p.n_blocks;
    p.n_blocks += blocks;
  }
  node_gather_kernel<<<p.n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int put_rows_launch(const PutParams* params, void* stream) {
  PutParams p = *params;
  if (p.B < 0 || p.n < 1 || p.n > kMaxPut)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B == 0) return 0;
  p.n_blocks = 0;
  for (int l = 0; l < p.n; ++l) {
    int32_t blocks;
    if (!esize_ok(p.rows[l].esize) || p.rows[l].R < 1
        || p.rows[l].idx == nullptr || !tiles(p.B, p.rows[l].row, &blocks))
      return static_cast<int>(cudaErrorInvalidValue);
    p.rows[l].first_block = p.n_blocks;
    p.n_blocks += blocks;
  }
  put_rows_kernel<<<p.n_blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
