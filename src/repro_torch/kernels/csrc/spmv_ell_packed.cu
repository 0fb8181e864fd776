// spmv_ell_packed: the SpMV of one packed (compressed-staging) ELL chunk,
//   col[r, s] = base[r] + sum_{t <= s} dcol[r, t]
//   y[r]      = sum_s (val[r, s] * scale[r]) * x[col[r, s]]      (all in A)
// with val in bf16 or fp8 e4m3, scale f32, base int32, dcol int16 or int32.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell_packed.py:
// spmv_ell_packed_kernel_call.  There one grid step held a (block_r, width)
// tile and the whole of x in VMEM, and ran jnp.cumsum along the rows.
//
// Bound on the card: bytes.  A slot costs 1-2 value bytes and 2-4 delta
// bytes (8 for the f32 ELL of spmv_ell), a row 8 bytes of scale and base,
// plus the gather of x through L2.  The packing exists to shrink the
// host->device copy of each staged chunk; the kernel's part is to undo it
// in registers, so the card never holds the unpacked chunk.  A chunk is
// small (262K rows x 8, 17.8 MB, at chunk_nnz = 1 << 20): the time is one
// wave of loads, a gather and a store, so what counts is how many of them
// are in flight at once.
//
// Design: spmv_ell's vector design (ell_row.cuh) on the packed operands,
// with three paths picked by the wrapper from the width and the alignment
// (kernels/spmv_ell_packed.py:packed_launch_plan) and checked here:
// - vector: a lane takes kSlots = 8 consecutive slots of one row as whole
//   vectors (__ldcs): 16 B of bf16 values or 8 B of fp8, 16 B of int16
//   deltas or 2 x 16 B of int32.  It scans its 8 deltas in registers, and
//   the lanes of a row (width / 8 of them, rounded up to a power of two;
//   one lane for a row of 8) combine their totals in an inclusive shuffle
//   scan that starts from base[r] in lane 0, which gives each lane its
//   first column.  Integer adds are exact: no order changes a bit.  Each
//   thread keeps kPackedRows rows in flight: all value, delta, scale and base
//   loads first (scale and base once a row, by lane 0), then the scans,
//   then all gathers of x (__ldg), then the arithmetic.  The grid is SMs x
//   occupancy, walked with a grid stride.
// - wide (more than 32 vectors a row: the hub chunks of power-law graphs):
//   a warp walks the row 32 x 8 slots at a time, carrying the scan total
//   from step to step.
// - scalar (width not a multiple of 8, or a base pointer that is not
//   16-byte aligned): an aligned group of lanes per row walks it in tiles
//   of `lanes` consecutive slots, one slot a lane, with a shuffle scan of
//   the tile's deltas plus the carry of the tiles before.
// Every lane sums its slots in slot order and the lanes of a row combine
// in one fixed order (an xor butterfly; the scalar path's shfl_down tree):
// the same bits on every run.  y is written with a streaming store.
//
// Each product is rounded in A before it is added (the build passes
// --fmad=false), in the plain version's order: (val * scale) * x.  Padding
// slots hold value 0 and delta 0 (after the one delta that returns the
// column to 0), so they add 0.
#include "ell_row.cuh"

namespace {

constexpr int kSlots = 8;       // slots a lane reads as vectors (kernels/spmv_ell_packed.py)
// Rows in flight per thread on the vector path: two rows are 16 gathers, as
// spmv_ell's four f32 rows are, in 80 registers (bf16 + int32, f32 -> f64);
// four rows took 156, one block an SM, and ran 15% slower (PERF.md).
constexpr int kPackedRows = 2;

// One lane's kSlots deltas as running columns from 0; returns their total.
template <typename I>
__device__ __forceinline__ int scan_slots(const I (&d)[kSlots], bool live, int (&cols)[kSlots]) {
  int run = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    run += live ? static_cast<int>(d[s]) : 0;
    cols[s] = run;
  }
  return run;
}

// Inclusive sum of `v` over the lanes of an aligned group of `lanes` lanes.
__device__ __forceinline__ int lane_scan(int v, int lane, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, off, lanes);
    if (lane >= off) v += up;
  }
  return v;
}

template <typename V, typename I, typename S, typename A>
__device__ __forceinline__ void packed_vector_rows(const V* __restrict__ val,
                                                   const float* __restrict__ scale,
                                                   const int* __restrict__ base,
                                                   const I* __restrict__ dcol,
                                                   const S* __restrict__ x, A* __restrict__ y,
                                                   long long rows, int width, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int sub = threadIdx.x / lanes;  // this group's row within a block step
  const int step = kThreads / lanes;    // rows per block step
  const long long tile_rows = static_cast<long long>(kPackedRows) * step;
  const bool has_vec = lane < width / kSlots;
  for (long long t0 = blockIdx.x * tile_rows; t0 < rows; t0 += gridDim.x * tile_rows) {
    const long long r0 = t0 + sub;
    V v[kPackedRows][kSlots];
    I d[kPackedRows][kSlots];
    float sc[kPackedRows];
    int start[kPackedRows];
    bool live[kPackedRows];
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j) {
      const long long r = r0 + static_cast<long long>(j) * step;
      live[j] = has_vec && r < rows;
      if (live[j]) {
        const long long off = r * width + static_cast<long long>(lane) * kSlots;
        load_stream(val + off, v[j]);
        load_stream(dcol + off, d[j]);
      }
      sc[j] = 0.0f;
      start[j] = 0;
      if (lane == 0 && r < rows) {
        sc[j] = __ldcs(scale + r);
        start[j] = __ldcs(base + r);
      }
    }
    int cols[kPackedRows][kSlots];
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j) {
      const int run = scan_slots(d[j], live[j], cols[j]);
      // base[r] enters through lane 0: each lane's first column is base plus
      // the deltas of the lanes before it.
      const int first = lane_scan(run + start[j], lane, lanes) - run;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) cols[j][s] += first;
      if (lanes > 1) sc[j] = __shfl_sync(0xffffffffu, sc[j], 0, lanes);
    }
    S xs[kPackedRows][kSlots];
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j)
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (live[j]) xs[j][s] = gather(x, cols[j][s]);
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j) {
      A acc = A(0);
      if (live[j]) {
        const A a_sc = to_acc<A>(sc[j]);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) acc += (to_acc<A>(v[j][s]) * a_sc) * to_acc<A>(xs[j][s]);
      }
      acc = butterfly(acc, lanes);
      const long long r = r0 + static_cast<long long>(j) * step;
      if (lane == 0 && r < rows) __stcs(y + r, acc);
    }
  }
}

template <typename V, typename I, typename S, typename A>
__device__ __forceinline__ void packed_wide_rows(const V* __restrict__ val,
                                                 const float* __restrict__ scale,
                                                 const int* __restrict__ base,
                                                 const I* __restrict__ dcol,
                                                 const S* __restrict__ x, A* __restrict__ y,
                                                 long long rows, int width) {
  const int lane = threadIdx.x & 31;
  const int nvec = width / kSlots;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  for (long long r = first; r < rows; r += warps) {
    const V* vr = val + r * width;
    const I* dr = dcol + r * width;
    const A sc = to_acc<A>(__shfl_sync(0xffffffffu, lane == 0 ? __ldcs(scale + r) : 0.0f, 0));
    int carry = __shfl_sync(0xffffffffu, lane == 0 ? __ldcs(base + r) : 0, 0);
    A acc = A(0);
    for (int q0 = 0; q0 < nvec; q0 += 32) {  // the same steps in every lane
      const int q = q0 + lane;
      const bool in = q < nvec;
      V v[kSlots];
      I d[kSlots];
      if (in) {
        load_stream(vr + static_cast<long long>(q) * kSlots, v);
        load_stream(dr + static_cast<long long>(q) * kSlots, d);
      }
      int cols[kSlots];
      const int run = scan_slots(d, in, cols);
      const int incl = lane_scan(run, lane, 32);
      const int col0 = carry + incl - run;
      S xs[kSlots];
      if (in) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) xs[s] = gather(x, col0 + cols[s]);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) acc += (to_acc<A>(v[s]) * sc) * to_acc<A>(xs[s]);
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    acc = butterfly(acc, 32);
    if (lane == 0) __stcs(y + r, acc);
  }
}

template <typename V, typename I, typename S, typename A>
__device__ __forceinline__ void packed_scalar_rows(const V* __restrict__ val,
                                                   const float* __restrict__ scale,
                                                   const int* __restrict__ base,
                                                   const I* __restrict__ dcol,
                                                   const S* __restrict__ x, A* __restrict__ y,
                                                   long long rows, int width, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int step = kThreads / lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * step; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * step) {
    const long long r = r0 + threadIdx.x / lanes;
    const bool live = r < rows;
    const long long row = live ? r : 0;
    const V* vr = val + row * width;
    const I* dr = dcol + row * width;
    const A sc = live ? to_acc<A>(scale[row]) : A(0);
    int carry = live ? base[row] : 0;
    A acc = A(0);
    for (int s0 = 0; s0 < width; s0 += lanes) {  // the same tiles in every lane
      const int s = s0 + lane;
      const bool in = live && s < width;
      const int d = lane_scan(in ? static_cast<int>(dr[s]) : 0, lane, lanes);
      if (in) acc += (to_acc<A>(vr[s]) * sc) * to_acc<A>(gather(x, carry + d));
      carry += __shfl_sync(0xffffffffu, d, lanes - 1, lanes);
    }
    acc = group_sum(acc, lanes);
    if (lane == 0 && live) __stcs(y + r, acc);
  }
}

template <typename V, typename I, typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_packed_kernel(const V* __restrict__ val, const float* __restrict__ scale,
                           const int* __restrict__ base, const I* __restrict__ dcol,
                           const S* __restrict__ x, A* __restrict__ y, long long rows, int width,
                           int lanes, int path) {
  if (path == kVector)
    packed_vector_rows<V, I, S, A>(val, scale, base, dcol, x, y, rows, width, lanes);
  else if (path == kWide)
    packed_wide_rows<V, I, S, A>(val, scale, base, dcol, x, y, rows, width);
  else
    packed_scalar_rows<V, I, S, A>(val, scale, base, dcol, x, y, rows, width, lanes);
}

template <typename V, typename I, typename S, typename A>
struct SpmvEllPacked {
  static int run(const void* val, const void* scale, const void* base, const void* dcol,
                 const void* x, void* y, long long rows, int width, int lanes, int path, int sms,
                 cudaStream_t stream) {
    if (rows == 0) return 0;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(dcol);
    if (!ell_plan_ok(width, kSlots, bases, lanes, path, sms))
      return static_cast<int>(cudaErrorInvalidValue);
    static const int per_sm = blocks_per_sm(spmv_ell_packed_kernel<V, I, S, A>);
    const long long blocks = ell_grid(rows, lanes, path, sms, per_sm, kPackedRows);
    spmv_ell_packed_kernel<V, I, S, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const V*>(val), static_cast<const float*>(scale),
        static_cast<const int*>(base), static_cast<const I*>(dcol), static_cast<const S*>(x),
        static_cast<A*>(y), rows, width, lanes, path);
    return static_cast<int>(cudaGetLastError());
  }
};

// (value, delta) dtypes as alias templates over the (x storage, accum) pair,
// so dispatch_pair instantiates the pairs the policies use for each.
template <typename S, typename A>
using PackedBf16I16 = SpmvEllPacked<__nv_bfloat16, short, S, A>;
template <typename S, typename A>
using PackedBf16I32 = SpmvEllPacked<__nv_bfloat16, int, S, A>;
template <typename S, typename A>
using PackedFp8I16 = SpmvEllPacked<__nv_fp8_e4m3, short, S, A>;
template <typename S, typename A>
using PackedFp8I32 = SpmvEllPacked<__nv_fp8_e4m3, int, S, A>;

}  // namespace

extern "C" int repro_spmv_ell_packed(int vdt, int idt, int sdt, int adt, const void* val,
                                     const void* scale, const void* base, const void* dcol,
                                     const void* x, void* y, long long rows, int width, int lanes,
                                     int path, int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vdt == DT_BF16 && idt == DT_I16)
    return dispatch_pair<PackedBf16I16>(sdt, adt, val, scale, base, dcol, x, y, rows, width, lanes,
                                        path, sms, s);
  if (vdt == DT_BF16 && idt == DT_I32)
    return dispatch_pair<PackedBf16I32>(sdt, adt, val, scale, base, dcol, x, y, rows, width, lanes,
                                        path, sms, s);
  if (vdt == DT_FP8_E4M3 && idt == DT_I16)
    return dispatch_pair<PackedFp8I16>(sdt, adt, val, scale, base, dcol, x, y, rows, width, lanes,
                                       path, sms, s);
  if (vdt == DT_FP8_E4M3 && idt == DT_I32)
    return dispatch_pair<PackedFp8I32>(sdt, adt, val, scale, base, dcol, x, y, rows, width, lanes,
                                       path, sms, s);
  return ERR_UNSUPPORTED_DTYPES;
}

#define SPMV_ELL_PACKED_KERNELS(X)                                      \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, float, float>)         \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, float, double>)        \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, double, double>)       \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, __nv_bfloat16, float>) \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, __half, float>)        \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, float, float>)           \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, float, double>)          \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, double, double>)         \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, __nv_bfloat16, float>)   \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, __half, float>)          \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, float, float>)         \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, float, double>)        \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, double, double>)       \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, __nv_bfloat16, float>) \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, __half, float>)        \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, float, float>)           \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, float, double>)          \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, double, double>)         \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, __nv_bfloat16, float>)   \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, __half, float>)         
REPRO_KERNEL_TABLE(repro_kernels_spmv_ell_packed, SPMV_ELL_PACKED_KERNELS)
