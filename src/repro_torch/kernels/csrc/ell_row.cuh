// The ELL row code shared by spmv_ell (csrc/spmv_ell.cu), spmv_ell_alpha
// (csrc/lanczos_fused.cu) and spmv_ell_packed (csrc/spmv_ell_packed.cu).
//
// Row-major ELL (rows, width) of val (S) and int32 col; x (X: S, or the
// accum dtype A where the wrapper widened it) is gathered through L2 and the
// read-only path (the whole of x at 4.2M rows is 17 MB
// in f32, inside the 50 MB L2).  Three row paths, picked by the wrapper
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
// - wide (more than 32 vectors a row: hybrid bulk, hub chunks): a warp per
//   row walks its 16 B vectors, kWideVecs of them in flight per lane.
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

enum EllPath : int { kVector = 0, kWide = 1, kScalar = 2 };  // kernels/spmv_ell.py:ELL_PATHS
constexpr int kRows = 4;      // rows in flight per thread on the vector path
constexpr int kWideVecs = 4;  // 16 B vectors in flight per lane on the wide path

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

// A launch plan the row code can run: `lanes` a power of two <= 32; the
// vector and wide paths only on whole `vec`-slot vectors from 16-byte
// aligned bases (`bases`: the OR of the streamed arrays' addresses), the
// vector path with a lane for every vector, the wide path with a warp.
inline bool ell_plan_ok(int width, int vec, uintptr_t bases, int lanes, int path, int sms) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || sms < 1) return false;
  if (path == kScalar) return true;
  if ((path != kVector && path != kWide) || width % vec || (bases & 15)) return false;
  return path == kWide ? lanes == 32 : static_cast<long long>(lanes) * vec >= width;
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
// vector path takes `rows_in_flight` rows a thread.
// kernels/spmv_ell.py:ell_max_blocks mirrors it with per_sm at its most.
inline long long ell_grid(long long rows, int lanes, int path, int sms, int per_sm,
                          int rows_in_flight = kRows) {
  const long long step = path == kWide ? kThreads / 32 : kThreads / lanes;
  const long long per_block = path == kVector ? step * rows_in_flight : step;
  const long long need = ceil_div(rows, per_block);
  const long long most = static_cast<long long>(sms) * per_sm;
  return need < most ? need : most;
}

}  // namespace
