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
// The tables (pointers, row sizes, element sizes; a scalar's bits; for
// put_rows the groups and units the wrapper lays out) ride in the
// parameter block, so a CUDA graph holds the step's own buffers and
// nothing is copied from the host a step.
//
// Both are bound by bytes: every row read once and written once (the
// flagship's 16 node-state leaves, 344 bytes a lane each way at
// B=100,000). On this card that bound is reached only with many
// independent loads in flight, since a load waits on the order of a
// microsecond for device memory.
//
// Both are lane-major: a thread owns one lane, a block 128 lanes, and
// the wrapper cuts a launch's leaves (or entries) into units, one row of
// blocks (grid.y) each, which run side by side; a thread loads its lane's
// index (and mask) once a unit, where a thread an element would load it
// once an element (86 times a lane in the flagship's 16 leaves):
//   - up to kBatch one-element rows (the flagship's 12 scalar leaves, the
//     pop's table columns, the Lamport clock): the lane's thread issues
//     every load of the unit before its first store, so kBatch loads are
//     in flight a thread where a thread an element had one;
//   - one longer row (log_term, log_cmd: 32 int32, 128 bytes; next_idx,
//     match_idx: 5 int32): the warp copies its 32 lanes' rows together,
//     cut into chunks, a thread a chunk, each lane's row index reaching
//     its chunks' threads by shuffle, kWarpBatch chunk loads in flight
//     before their stores, so an access moves whole rows of neighbouring
//     lanes rather than one word of 32 lanes. A chunk is 16 bytes (int4;
//     8 threads a 128-byte row, 4 lanes an instruction) where both bases,
//     the source's lane stride and the row's bytes are all 16-byte
//     aligned; else the widest power of two that divides them all (4
//     bytes for an int32 row one element off a 16-byte boundary, or for
//     the 20-byte rows); a scalar source is stored an element at a time.
// No integer division is left: a row's chunks are padded to a power of
// two, so a thread finds its lane and chunk by shift and mask.
//
// node_gather reads: its stores to the fresh [B, row] outputs are
// coalesced (a one-element leaf's 32 lanes are 32 neighbouring elements,
// a longer row's lanes neighbouring rows), its loads are one row a lane
// at the lane's index, so a scalar leaf's 4-byte load touches a sector of
// the lane's [R] slot (20 bytes at R=5) that it only partly uses; the
// byte bound (each row read once) does not count that.
//
// put_rows groups a launch's entries by their (idx, mask) pair (the node
// scatter's 16 entries are one group; the dup pop's two share an index
// but not a mask, so they are two) and cuts each group into units. A
// one-element unit's thread issues every source load before its first
// store, without waiting for its index (every source row b < B exists),
// so index, mask and sources are in flight together. A scalar leaf's
// 4-byte stores land 20 bytes apart, so each touches a sector it only
// partly writes; rewriting the lanes' whole [R] slots instead
// (full-sector stores after coalesced loads) measured slower on this
// card.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxGather = 48;   // leaves a node_gather launch
constexpr int kMaxPut = 16;      // entries (and units) a put_rows launch
constexpr int kBatch = 8;        // one-element rows a unit

// One leaf of node_gather: src [B, R, row] and dst [B, row], `row`
// elements of `esize` bytes. chunk 0: a one-element row, copied by its
// lane's thread; else the warp copies its 32 lanes' rows `chunk` bytes an
// access, `chunks` a row, padded to 1 << shift.
struct GatherLeaf {
  const void* src;
  void* dst;
  int64_t row;
  int32_t esize;
  int32_t chunk, chunks, shift;
};

// One row of blocks (grid.y) of a node_gather launch: a longer row
// (`leaf`), or up to kBatch one-element rows, the leaves
// items[first_item, first_item + n_items).
struct GatherUnit {
  int32_t leaf;             // -1: one-element rows
  int32_t first_item, n_items, pad;
};

// The launch parameters, field for field the ctypes structures of
// madsim_tpu_torch/ops/node_rows.py; outside the unnamed namespace so
// that the C entry points keep external linkage.
struct GatherParams {
  const int32_t* idx;   // [B]
  GatherLeaf leaves[kMaxGather];
  GatherUnit units[kMaxGather];
  uint8_t items[kMaxGather];    // leaves of the one-element units
  int64_t B;
  int32_t R, n_leaves, n_units, n_items;
};

// One entry of put_rows: dst [B, R, row] written in place; src lane b's
// row at src + b * src_sb elements (src_sb 0: one row for every lane;
// null: the scalar `value`'s low esize bytes). chunk 0: a one-element
// row, written by its lane's thread; else the warp copies its 32 lanes'
// rows `chunk` bytes an access, `chunks` a row, padded to 1 << shift.
struct PutRow {
  void* dst;
  const void* src;
  int64_t row;
  int64_t src_sb;
  uint64_t value;
  int32_t R, esize;
  int32_t chunk, chunks, shift, pad;
};

// The entries that share one (idx, mask) pair.
struct PutGroup {
  const int32_t* idx;       // [B]
  const uint8_t* mask;      // [B] bool; null: every lane
};

// One row of blocks (grid.y) of a put_rows launch, all of group `group`:
// a longer row (`entry`), or up to kBatch one-element rows, the entries
// items[first_item, first_item + n_items).
struct PutUnit {
  int32_t group, entry;     // entry -1: one-element rows
  int32_t first_item, n_items;
};

struct PutParams {
  PutRow rows[kMaxPut];
  PutGroup groups[kMaxPut];
  PutUnit units[kMaxPut];
  uint8_t items[kMaxPut];       // entries of the one-element units
  int64_t B;
  int32_t n, n_groups, n_units, n_items;
};

namespace {

constexpr int kLanes = 128;        // lanes a block (both kernels)
constexpr int kWarpBatch = 8;      // long-row chunk loads before stores
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t load_elem(const void* src, int64_t si,
                                              int esize) {
  switch (esize) {
    case 1: return static_cast<const uint8_t*>(src)[si];
    case 2: return static_cast<const uint16_t*>(src)[si];
    case 4: return static_cast<const uint32_t*>(src)[si];
    default: return static_cast<const uint64_t*>(src)[si];
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

// `chunk` bytes at p (aligned to chunk), in the low words of a uint4
__device__ __forceinline__ uint4 load_chunk(const char* p, int chunk) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  switch (chunk) {
    case 16: v = *reinterpret_cast<const uint4*>(p); break;
    case 8: {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      v.x = t.x;
      v.y = t.y;
      break;
    }
    case 4: v.x = *reinterpret_cast<const uint32_t*>(p); break;
    case 2: v.x = *reinterpret_cast<const uint16_t*>(p); break;
    default: v.x = *reinterpret_cast<const uint8_t*>(p); break;
  }
  return v;
}

__device__ __forceinline__ void store_chunk(char* p, uint4 v, int chunk) {
  switch (chunk) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.x);
      break;
    default: *reinterpret_cast<uint8_t*>(p) = static_cast<uint8_t>(v.x);
      break;
  }
}

// A lane's one-element rows of one gather unit: every load (the lane's
// row r, already clamped; -1 past the last lane), then the stores.
__device__ __forceinline__ void gather_short(const GatherParams& p,
                                             const GatherUnit& u, int64_t b,
                                             int32_t r) {
  uint64_t v[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    v[k] = 0;
    if (r >= 0 && k < u.n_items) {
      const GatherLeaf& lf = p.leaves[p.items[u.first_item + k]];
      v[k] = load_elem(lf.src, b * p.R + r, lf.esize);
    }
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (r >= 0 && k < u.n_items) {
      const GatherLeaf& lf = p.leaves[p.items[u.first_item + k]];
      store_value(lf.dst, b, v[k], lf.esize);
    }
  }
}

// One longer row of the warp's 32 lanes (from lane `warp0`), chunk by
// chunk, as put_long: slot s of the 32 << shift is lane s >> shift's
// chunk s & mask; thread t takes slots t, t + 32, ... Every thread runs
// every shuffle.
__device__ __forceinline__ void gather_long(const GatherLeaf& lf,
                                            int64_t warp0, int t, int32_t r,
                                            int32_t R) {
  const int cb = lf.chunk, shift = lf.shift;
  const int64_t rb = lf.row * lf.esize;          // a row's bytes
  const int per = 1 << shift;
  const char* src = static_cast<const char*>(lf.src);
  char* dst = static_cast<char*>(lf.dst);
  for (int i0 = 0; i0 < per; i0 += kWarpBatch) {
    uint4 v[kWarpBatch];
    int32_t rl[kWarpBatch];
#pragma unroll
    for (int k = 0; k < kWarpBatch; ++k) {
      rl[k] = -1;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i0 + k < per) {          // uniform over the warp
        const int slot = ((i0 + k) << 5) + t;
        const int l = slot >> shift, c = slot & (per - 1);
        const int32_t rr = __shfl_sync(kFull, r, l);
        rl[k] = (rr >= 0 && c < lf.chunks) ? rr : -1;
        if (rl[k] >= 0)
          v[k] = load_chunk(src + ((warp0 + l) * R + rr) * rb + c * cb, cb);
      }
    }
#pragma unroll
    for (int k = 0; k < kWarpBatch; ++k) {
      if (rl[k] >= 0) {
        const int slot = ((i0 + k) << 5) + t;
        const int l = slot >> shift, c = slot & (per - 1);
        store_chunk(dst + (warp0 + l) * rb + c * cb, v[k], cb);
      }
    }
  }
}

__global__ void __launch_bounds__(kLanes)
node_gather_kernel(const __grid_constant__ GatherParams p) {
  const GatherUnit& u = p.units[blockIdx.y];
  const int t = threadIdx.x & 31;
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * kLanes
      + (threadIdx.x & ~31);
  const int64_t b = warp0 + t;
  // the lane's row, clamped; -1 past the last lane (no thread leaves:
  // the warp shuffles)
  int32_t r = -1;
  if (b < p.B) {
    const int32_t i = p.idx[b];
    r = i < 0 ? 0 : (i >= p.R ? p.R - 1 : i);
  }
  if (u.leaf >= 0)
    gather_long(p.leaves[u.leaf], warp0, t, r, p.R);
  else
    gather_short(p, u, b, r);
}

// A lane's one-element rows of one unit: every source load, then the
// stores where the lane writes (0 <= r < R).
__device__ __forceinline__ void put_short(const PutParams& p,
                                          const PutUnit& u, int64_t b,
                                          bool live, int32_t r) {
  uint64_t v[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    v[k] = 0;
    if (live && k < u.n_items) {
      const PutRow& w = p.rows[p.items[u.first_item + k]];
      v[k] = w.src != nullptr ? load_elem(w.src, b * w.src_sb, w.esize)
                              : w.value;
    }
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (r >= 0 && k < u.n_items) {
      const PutRow& w = p.rows[p.items[u.first_item + k]];
      if (r < w.R) store_value(w.dst, b * w.R + r, v[k], w.esize);
    }
  }
}

// One longer row of the warp's 32 lanes (from lane `warp0`), chunk by
// chunk: slot s of the 32 << shift is lane s >> shift's chunk s & mask;
// thread t takes slots t, t + 32, ... Every thread runs every shuffle.
__device__ __forceinline__ void put_long(const PutRow& w, int64_t warp0,
                                         int t, int32_t r) {
  const int cb = w.chunk, shift = w.shift;
  const int64_t rb = w.row * w.esize;            // a row's bytes
  const int64_t sb = w.src_sb * w.esize;         // between lanes' sources
  const int per = 1 << shift;
  const char* src = static_cast<const char*>(w.src);
  char* dst = static_cast<char*>(w.dst);
  const uint4 value = make_uint4(static_cast<uint32_t>(w.value),
                                 static_cast<uint32_t>(w.value >> 32), 0u,
                                 0u);
  for (int i0 = 0; i0 < per; i0 += kWarpBatch) {
    uint4 v[kWarpBatch];
    int32_t rl[kWarpBatch];
#pragma unroll
    for (int k = 0; k < kWarpBatch; ++k) {
      rl[k] = -1;
      if (i0 + k < per) {          // uniform over the warp
        const int slot = ((i0 + k) << 5) + t;
        const int l = slot >> shift, c = slot & (per - 1);
        const int32_t rr = __shfl_sync(kFull, r, l);
        rl[k] = (rr >= 0 && rr < w.R && c < w.chunks) ? rr : -1;
        v[k] = value;
        if (rl[k] >= 0 && src != nullptr)
          v[k] = load_chunk(src + (warp0 + l) * sb + c * cb, cb);
      }
    }
#pragma unroll
    for (int k = 0; k < kWarpBatch; ++k) {
      if (rl[k] >= 0) {
        const int slot = ((i0 + k) << 5) + t;
        const int l = slot >> shift, c = slot & (per - 1);
        store_chunk(dst + ((warp0 + l) * w.R + rl[k]) * rb + c * cb, v[k],
                    cb);
      }
    }
  }
}

__global__ void __launch_bounds__(kLanes)
put_rows_kernel(const __grid_constant__ PutParams p) {
  const PutUnit& u = p.units[blockIdx.y];
  const PutGroup& g = p.groups[u.group];
  const int t = threadIdx.x & 31;
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * kLanes
      + (threadIdx.x & ~31);
  const int64_t b = warp0 + t;
  const bool live = b < p.B;     // no thread leaves: the warp shuffles
  // the lane's row, or -1 where it writes nothing
  int32_t r = -1;
  if (live) {
    const int32_t i = g.idx[b];
    const bool on = g.mask == nullptr || g.mask[b] != 0;
    r = (on && i >= 0) ? i : -1;
  }
  if (u.entry >= 0)
    put_long(p.rows[u.entry], warp0, t, r);
  else
    put_short(p, u, b, live, r);
}

inline bool esize_ok(int esize) {
  return esize == 1 || esize == 2 || esize == 4 || esize == 8;
}

inline bool aligned(const void* ptr, int64_t bytes, int chunk) {
  return (reinterpret_cast<uintptr_t>(ptr) % chunk) == 0
      && bytes % chunk == 0;
}

// A warp copy's chunking: `chunk` bytes an access divides the row's `rb`
// bytes into `chunks`, and 1 << shift is the least power of two that
// holds them.
inline bool chunks_ok(int64_t rb, int chunk, int chunks, int shift) {
  const int c = chunk;
  return (c == 1 || c == 2 || c == 4 || c == 8 || c == 16) && rb % c == 0
      && rb / c == chunks && shift >= 0 && shift <= 24
      && (int64_t{1} << shift) >= chunks
      && (shift == 0 || (int64_t{1} << (shift - 1)) < chunks);
}

// A leaf the kernel can copy as its table says: a thread's row has one
// element; a warp's row's chunk divides its bytes and both bases.
inline bool leaf_ok(const GatherLeaf& lf) {
  if (!esize_ok(lf.esize) || lf.row < 1 || lf.src == nullptr
      || lf.dst == nullptr)
    return false;
  if (lf.chunk == 0) return lf.row == 1;
  const int64_t rb = lf.row * lf.esize;
  return chunks_ok(rb, lf.chunk, lf.chunks, lf.shift)
      && aligned(lf.src, rb, lf.chunk) && aligned(lf.dst, rb, lf.chunk);
}

// An entry the kernel can copy as its table says: a thread's row has one
// element; a warp's row's chunk divides its bytes, bases and source
// stride.
inline bool row_ok(const PutRow& w) {
  if (!esize_ok(w.esize) || w.R < 1 || w.row < 1 || w.dst == nullptr)
    return false;
  if (w.chunk == 0) return w.row == 1;
  const int64_t rb = w.row * w.esize;
  const int c = w.chunk;
  if (!chunks_ok(rb, c, w.chunks, w.shift) || !aligned(w.dst, rb, c))
    return false;
  if (w.src == nullptr) return c == w.esize;
  return aligned(w.src, w.src_sb * w.esize, c);
}

// The grid of a lane-major launch: a row of blocks a unit.
inline bool lane_grid(int64_t B, int n_units, dim3* grid) {
  const int64_t blocks = (B + kLanes - 1) / kLanes;
  if (blocks >= (int64_t{1} << 31)) return false;
  *grid = dim3(static_cast<unsigned>(blocks),
               static_cast<unsigned>(n_units));
  return true;
}

}  // namespace

extern "C" int node_gather_launch(const GatherParams* params, void* stream) {
  const GatherParams& p = *params;
  if (p.B < 0 || p.R < 1 || p.idx == nullptr || p.n_leaves < 1
      || p.n_leaves > kMaxGather || p.n_units < 1
      || p.n_units > kMaxGather || p.n_items < 0
      || p.n_items > p.n_leaves)
    return static_cast<int>(cudaErrorInvalidValue);
  // every leaf copyable, and taken by exactly one unit
  int taken[kMaxGather] = {};
  for (int l = 0; l < p.n_leaves; ++l)
    if (!leaf_ok(p.leaves[l])) return static_cast<int>(cudaErrorInvalidValue);
  for (int ui = 0; ui < p.n_units; ++ui) {
    const GatherUnit& u = p.units[ui];
    if (u.leaf >= 0) {
      if (u.leaf >= p.n_leaves || p.leaves[u.leaf].chunk == 0)
        return static_cast<int>(cudaErrorInvalidValue);
      ++taken[u.leaf];
      continue;
    }
    if (u.leaf != -1 || u.first_item < 0 || u.n_items < 1
        || u.n_items > kBatch || u.first_item + u.n_items > p.n_items)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = u.first_item; i < u.first_item + u.n_items; ++i) {
      if (p.items[i] >= p.n_leaves || p.leaves[p.items[i]].chunk != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      ++taken[p.items[i]];
    }
  }
  for (int l = 0; l < p.n_leaves; ++l)
    if (taken[l] != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p.B == 0) return 0;
  dim3 grid;
  if (!lane_grid(p.B, p.n_units, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  node_gather_kernel<<<grid, kLanes, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int put_rows_launch(const PutParams* params, void* stream) {
  const PutParams& p = *params;
  if (p.B < 0 || p.n < 1 || p.n > kMaxPut || p.n_groups < 1
      || p.n_groups > p.n || p.n_units < 1 || p.n_units > kMaxPut
      || p.n_items < 0 || p.n_items > p.n)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int e = 0; e < p.n; ++e)
    if (!row_ok(p.rows[e])) return static_cast<int>(cudaErrorInvalidValue);
  for (int gi = 0; gi < p.n_groups; ++gi)
    if (p.groups[gi].idx == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  for (int ui = 0; ui < p.n_units; ++ui) {
    const PutUnit& u = p.units[ui];
    if (u.group < 0 || u.group >= p.n_groups || u.entry >= p.n)
      return static_cast<int>(cudaErrorInvalidValue);
    if (u.entry >= 0) {
      if (p.rows[u.entry].chunk == 0)
        return static_cast<int>(cudaErrorInvalidValue);
      continue;
    }
    if (u.first_item < 0 || u.n_items < 1 || u.n_items > kBatch
        || u.first_item + u.n_items > p.n_items)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = u.first_item; i < u.first_item + u.n_items; ++i)
      if (p.items[i] >= p.n || p.rows[p.items[i]].chunk != 0)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.B == 0) return 0;
  dim3 grid;
  if (!lane_grid(p.B, p.n_units, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  put_rows_kernel<<<grid, kLanes, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
