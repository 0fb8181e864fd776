// The ELL row code shared by spmv_ell (csrc/spmv_ell.cu), spmv_ell_alpha
// (csrc/lanczos_fused.cu) and spmv_ell_packed (csrc/spmv_ell_packed.cu).
//
// Row-major ELL (rows, width) of val (S) and int32 col; x (X: S, or the
// accum dtype A where the wrapper widened it) is gathered through L2 and the
// read-only path (the whole of x at 4.2M rows is 17 MB
// in f32, inside the 50 MB L2).  Four row paths, picked by the wrapper
// from the shapes (kernels/spmv_ell.py:ell_launch_plan) and checked here
// (ell_plan_ok):
// - vector: a lane reads 16 B of val (V = 16 / sizeof(S) slots: 4 in f32,
//   8 in bf16/f16, 2 in f64) and the V matching int32 columns, so a row
//   takes width / V lanes, rounded up to a power of two (2 for an f32 row
//   of 8: a lane pair covers one 32 B sector, and a warp reads 512
//   contiguous bytes per instruction).  Each thread holds kRows rows in
//   flight: it issues all its val and col vectors, then all its x gathers,
//   and only then any arithmetic.  Blocks walk row tiles with a grid
//   stride over a grid sized from the SM count and the kernel's occupancy.
// - wide (more than 32 vectors a row: hybrid bulk, and spmv_ell_alpha's
//   every wide row): a warp per row walks its 16 B vectors, kWideVecs of
//   them in flight per lane.
// - split (more than 32 x kWideVecs vectors a row, under 4 rows a SM: the
//   hub chunks of power-law graphs; spmv_ell and spmv_ell_packed only,
//   never spmv_ell_alpha; kernels/spmv_ell.py:split_plan): the row is cut into
//   segments of 32 lanes x seg_vecs vectors, one warp a segment, so an
//   8-row chunk runs thousands of warps where the wide path ran 8.  Bound
//   by bytes, as the others: the segment's loads all go out before its
//   gathers.  Each segment writes its partial sum to a (rows, segs) scratch
//   array, and a second small launch (common.cuh: reduce_partials_kernel,
//   a block a row) sums each row's partials in a fixed order: no atomics
//   and no float atomics, the same bits on every run.  (A last-arriving
//   segment with a counter a row would save that launch, but every segment
//   of a row then adds to one address: about 4 ns a segment, serialized,
//   on the card, more than the launch.)
// - scalar (row bytes not a multiple of 16, or a base pointer that is not
//   16-byte aligned): a group of lanes per row, one slot per lane per step.
// val and col stream with evict-first loads (__ldcs), x goes through the
// read-only path (__ldg).  Every lane sums its slots in slot order and the
// lanes of a row combine in one fixed xor butterfly: the same bits on every
// run.
//
// Each finished row goes to an epilogue E, in lane 0 of the row's lanes:
//   typename E::Pre pre = e.load(r);  issued with the row's val and col loads
//   e.store(r, acc, pre);             after the row's sum
// spmv_ell's epilogue stores y[r] (an empty Pre, which compiles to
// nothing); spmv_ell_alpha's stores w[r] and adds v[r] * w[r] into the
// thread's part of alpha.  One row code: w and y have the same bits.
#pragma once

#include "common.cuh"

namespace {

enum EllPath : int { kVector = 0, kWide = 1, kScalar = 2, kSplit = 3 };  // kernels/spmv_ell.py:ELL_PATHS
constexpr int kRows = 4;       // rows in flight per thread on the vector path
constexpr int kWideVecs = 4;   // 16 B vectors in flight per lane on the wide path (WIDE_VECS)
constexpr int kSplitVecs = 4;  // the most 16 B vectors a lane takes in one split segment

template <typename X>
__device__ __forceinline__ X gather(const X* __restrict__ x, int c) {
  return __ldg(x + c);
}

// Sum over an aligned group of `lanes` lanes (a power of two <= 32); every
// lane of the group gets the total.  Every lane of the warp must call it.
template <typename A>
__device__ __forceinline__ A butterfly(A v, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename S, typename X, typename A, typename E>
__device__ __forceinline__ void vector_rows(const S* __restrict__ val, const int* __restrict__ col,
                                            const X* __restrict__ x, E& e, long long rows,
                                            int width, int lanes) {
  constexpr int V = 16 / sizeof(S);
  const int lane = threadIdx.x & (lanes - 1);
  const int sub = threadIdx.x / lanes;  // this group's row within a block step
  const int step = kThreads / lanes;    // rows per block step
  const long long tile_rows = static_cast<long long>(kRows) * step;
  const bool has_vec = lane < width / V;
  for (long long t0 = blockIdx.x * tile_rows; t0 < rows; t0 += gridDim.x * tile_rows) {
    const long long r0 = t0 + sub;
    S v[kRows][V];
    int c[kRows][V];
    bool live[kRows];
    typename E::Pre pre[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long r = r0 + static_cast<long long>(j) * step;
      live[j] = has_vec && r < rows;
      if (live[j]) {
        const long long off = r * width + static_cast<long long>(lane) * V;
        load_stream(val + off, v[j]);
        load_stream(col + off, c[j]);
      }
      if (lane == 0 && r < rows) pre[j] = e.load(r);
    }
    X xs[kRows][V];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int s = 0; s < V; ++s)
        if (live[j]) xs[j][s] = gather(x, c[j][s]);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      A acc = A(0);
      if (live[j])
#pragma unroll
        for (int s = 0; s < V; ++s) acc += to_acc<A>(v[j][s]) * to_acc<A>(xs[j][s]);
      acc = butterfly(acc, lanes);
      const long long r = r0 + static_cast<long long>(j) * step;
      if (lane == 0 && r < rows) e.store(r, acc, pre[j]);
    }
  }
}

template <typename S, typename X, typename A, typename E>
__device__ __forceinline__ void wide_rows(const S* __restrict__ val, const int* __restrict__ col,
                                          const X* __restrict__ x, E& e, long long rows,
                                          int width) {
  constexpr int V = 16 / sizeof(S);
  const int lane = threadIdx.x & 31;
  const int nvec = width / V;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  for (long long r = first; r < rows; r += warps) {
    const S* vr = val + r * width;
    const int* cr = col + r * width;
    typename E::Pre pre;
    if (lane == 0) pre = e.load(r);
    A acc = A(0);
    for (int q0 = lane; q0 < nvec; q0 += 32 * kWideVecs) {
      S v[kWideVecs][V];
      int c[kWideVecs][V];
#pragma unroll
      for (int w = 0; w < kWideVecs; ++w) {
        const int q = q0 + 32 * w;
        if (q < nvec) {
          load_stream(vr + q * V, v[w]);
          load_stream(cr + q * V, c[w]);
        }
      }
      X xs[kWideVecs][V];
#pragma unroll
      for (int w = 0; w < kWideVecs; ++w)
#pragma unroll
        for (int s = 0; s < V; ++s)
          if (q0 + 32 * w < nvec) xs[w][s] = gather(x, c[w][s]);
#pragma unroll
      for (int w = 0; w < kWideVecs; ++w)
        if (q0 + 32 * w < nvec)
#pragma unroll
          for (int s = 0; s < V; ++s) acc += to_acc<A>(v[w][s]) * to_acc<A>(xs[w][s]);
    }
    acc = butterfly(acc, 32);
    if (lane == 0) e.store(r, acc, pre);
  }
}

template <typename S, typename X, typename A, typename E>
__device__ __forceinline__ void scalar_rows(const S* __restrict__ val, const int* __restrict__ col,
                                            const X* __restrict__ x, E& e, long long rows,
                                            int width, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int step = kThreads / lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * step; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * step) {
    const long long r = r0 + threadIdx.x / lanes;
    typename E::Pre pre;
    if (lane == 0 && r < rows) pre = e.load(r);
    A acc = A(0);
    if (r < rows) {
      const S* vr = val + r * width;
      const int* cr = col + r * width;
      for (int s = lane; s < width; s += lanes)
        acc += to_acc<A>(__ldcs(vr + s)) * to_acc<A>(gather(x, __ldcs(cr + s)));
    }
    acc = butterfly(acc, lanes);
    if (lane == 0 && r < rows) e.store(r, acc, pre);
  }
}

// Every row of the ELL through the planned path, each handed to `e`.
template <typename S, typename X, typename A, typename E>
__device__ __forceinline__ void ell_rows(const S* __restrict__ val, const int* __restrict__ col,
                                         const X* __restrict__ x, E& e, long long rows, int width,
                                         int lanes, int path) {
  if (path == kVector)
    vector_rows<S, X, A>(val, col, x, e, rows, width, lanes);
  else if (path == kWide)
    wide_rows<S, X, A>(val, col, x, e, rows, width);
  else
    scalar_rows<S, X, A>(val, col, x, e, rows, width, lanes);
}

// ------------------------------------------------------------ split path
// Segments of a split row: 32 lanes x seg_vecs vectors of `vec` slots each.
__host__ __device__ __forceinline__ long long split_segs(int width, int vec, int seg_vecs) {
  const long long len = 32LL * seg_vecs;  // vectors a segment
  return (width / vec + len - 1) / len;
}

// spmv_ell's split path: warp t takes segment t % segs of row t / segs (a
// grid stride over rows x segs), issues all its val and col vectors (lane
// `lane` takes vectors lane, lane + 32, ... of the segment), then all its
// gathers, then sums in slot order per lane and the butterfly, and writes
// the segment's partial to partials[t] (= partials[r * segs + seg]).
template <typename S, typename X, typename A>
__device__ __forceinline__ void split_rows(const S* __restrict__ val, const int* __restrict__ col,
                                           const X* __restrict__ x, A* __restrict__ partials,
                                           long long rows, int width, int seg_vecs) {
  constexpr int V = 16 / sizeof(S);
  const int lane = threadIdx.x & 31;
  const int nvec = width / V;
  const long long segs = split_segs(width, V, seg_vecs);
  const long long units = rows * segs;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long t = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
       t < units; t += warps) {
    const long long r = t / segs;
    const long long seg = t - r * segs;
    const S* vr = val + r * width;
    const int* cr = col + r * width;
    const long long q0 = seg * 32 * seg_vecs + lane;
    S v[kSplitVecs][V];
    int c[kSplitVecs][V];
    bool live[kSplitVecs];
#pragma unroll
    for (int w = 0; w < kSplitVecs; ++w) {
      const long long q = q0 + 32 * w;
      live[w] = w < seg_vecs && q < nvec;
      if (live[w]) {
        load_stream(vr + q * V, v[w]);
        load_stream(cr + q * V, c[w]);
      }
    }
    X xs[kSplitVecs][V];
#pragma unroll
    for (int w = 0; w < kSplitVecs; ++w)
#pragma unroll
      for (int s = 0; s < V; ++s)
        if (live[w]) xs[w][s] = gather(x, c[w][s]);
    A acc = A(0);
#pragma unroll
    for (int w = 0; w < kSplitVecs; ++w)
      if (live[w])
#pragma unroll
        for (int s = 0; s < V; ++s) acc += to_acc<A>(v[w][s]) * to_acc<A>(xs[w][s]);
    acc = butterfly(acc, 32);
    if (lane == 0) partials[t] = acc;
  }
}

// A launch plan the row code can run: `lanes` a power of two <= 32; the
// vector, wide and split paths only on whole `vec`-slot vectors from
// 16-byte aligned bases (`bases`: the OR of the streamed arrays' addresses),
// the vector path with a lane for every vector, the wide and split paths
// with a warp, the split path's segments of 1 to kSplitVecs vectors a lane
// (`seg_vecs`; 0 on the other paths).
inline bool ell_plan_ok(int width, int vec, uintptr_t bases, int lanes, int path, int sms,
                        int seg_vecs = 0) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || sms < 1) return false;
  if (path == kSplit) {
    if (seg_vecs < 1 || seg_vecs > kSplitVecs) return false;
  } else if (seg_vecs != 0) {
    return false;
  }
  if (path == kScalar) return true;
  if ((path != kVector && path != kWide && path != kSplit) || width % vec || (bases & 15))
    return false;
  return path == kVector ? static_cast<long long>(lanes) * vec >= width : lanes == 32;
}

// Blocks of `kernel` one SM holds at once (at least 1).
template <typename K>
int blocks_per_sm(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) || n < 1) n = 1;
  return n;
}

// Blocks of one launch: enough to cover the rows once, at most as many as
// the card holds at once (SMs times the kernel's occupancy `per_sm`); the
// vector path takes `rows_in_flight` rows a thread, the wide path a warp a
// row, the split path a warp a segment (`rows` counts rows x segments).
// kernels/spmv_ell.py:ell_max_blocks mirrors it with per_sm at its most.
inline long long ell_grid(long long rows, int lanes, int path, int sms, int per_sm,
                          int rows_in_flight = kRows) {
  const long long step = path == kWide || path == kSplit ? kThreads / 32 : kThreads / lanes;
  const long long per_block = path == kVector ? step * rows_in_flight : step;
  const long long need = ceil_div(rows, per_block);
  const long long most = static_cast<long long>(sms) * per_sm;
  return need < most ? need : most;
}

}  // namespace
