// spmv_ell: y[r] = sum_s val[r, s] * x[col[r, s]], accumulated in A.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py:spmv_ell_kernel_call.
// There the whole of x sat in VMEM and the width axis of the grid ran in
// order on one core, summing into the output tile.
//
// Bound on the card: bytes.  Each slot costs one value and one int32 index
// (8 B in f32) and does two flops, far below the H100's flop/byte balance
// even in f64.  On the main path (road 4.19M, ELL width 8, val f32, acc f64)
// the kernel must stream 268 MB of val and col; x (16.8 MB) stays in L2,
// since the columns of a road network sit near the row.
//
// Design (three paths in one kernel, picked by the wrapper from the shapes,
// see kernels/spmv_ell.py:ell_launch_plan):
// - vector: a lane reads 16 B of val (V = 16 / sizeof(S) slots: 4 in f32,
//   8 in bf16/f16, 2 in f64) and the V matching int32 columns, so a row
//   takes width / V lanes (2 for an f32 row of 8: a lane pair covers one
//   32 B sector, and a warp reads 512 contiguous bytes per instruction).
//   Each thread holds kRows rows in flight: it issues all its val and col
//   vectors, then all its x gathers, and only then any arithmetic.  Blocks
//   walk row tiles with a grid stride over a grid sized from the SM count
//   and the kernel's occupancy.
// - wide (more than 32 vectors a row: hybrid bulk, hub chunks): a warp per
//   row walks its 16 B vectors, kWideVecs of them in flight per lane.
// - scalar (row bytes not a multiple of 16, or a base pointer that is not
//   16-byte aligned): a group of lanes per row, one slot per lane per step.
// val and col stream with evict-first loads (__ldcs), x goes through the
// read-only path (__ldg) and stays in L2, y is written with a streaming
// store.  Every lane sums its slots in slot order and the lanes of a row
// combine in one fixed xor butterfly: the same bits on every run.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.108-0.114 ms a launch on the main path, 84-88% of its 0.0952 ms bound,
// against 0.22 ms for the lane-group design this replaces.
//
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py phase 1): 80 registers for
// <float, float> and <float, double>, 64 for <double, double>, 128 for the
// bf16 and f16 storage (eight columns a lane); no stack frame, no spills.
#include "common.cuh"

namespace {

enum EllPath : int { kVector = 0, kWide = 1, kScalar = 2 };  // kernels/spmv_ell.py:ELL_PATHS
constexpr int kRows = 4;      // rows in flight per thread on the vector path
constexpr int kWideVecs = 4;  // 16 B vectors in flight per lane on the wide path

template <typename T, int N>
__device__ __forceinline__ void load_stream(const T* p, T (&out)[N]) {
  constexpr int B = static_cast<int>(sizeof(T)) * N;
  static_assert(B % 8 == 0 && B <= 64, "vector of 8 to 64 bytes");
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p) + i);
      memcpy(reinterpret_cast<char*>(out) + 16 * i, &u, 16);
    }
  } else {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    memcpy(out, &u, 8);
  }
}

template <typename S>
__device__ __forceinline__ S gather(const S* __restrict__ x, int c) {
  return __ldg(x + c);
}

// Sum over an aligned group of `lanes` lanes (a power of two <= 32); every
// lane of the group gets the total.  Every lane of the warp must call it.
template <typename A>
__device__ __forceinline__ A butterfly(A v, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename S, typename A>
__device__ __forceinline__ void vector_rows(const S* __restrict__ val, const int* __restrict__ col,
                                            const S* __restrict__ x, A* __restrict__ y,
                                            long long rows, int width, int lanes) {
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
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long r = r0 + static_cast<long long>(j) * step;
      live[j] = has_vec && r < rows;
      if (live[j]) {
        const long long off = r * width + static_cast<long long>(lane) * V;
        load_stream(val + off, v[j]);
        load_stream(col + off, c[j]);
      }
    }
    S xs[kRows][V];
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
      if (lane == 0 && r < rows) __stcs(y + r, acc);
    }
  }
}

template <typename S, typename A>
__device__ __forceinline__ void wide_rows(const S* __restrict__ val, const int* __restrict__ col,
                                          const S* __restrict__ x, A* __restrict__ y,
                                          long long rows, int width) {
  constexpr int V = 16 / sizeof(S);
  const int lane = threadIdx.x & 31;
  const int nvec = width / V;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  for (long long r = first; r < rows; r += warps) {
    const S* vr = val + r * width;
    const int* cr = col + r * width;
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
      S xs[kWideVecs][V];
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
    if (lane == 0) __stcs(y + r, acc);
  }
}

template <typename S, typename A>
__device__ __forceinline__ void scalar_rows(const S* __restrict__ val, const int* __restrict__ col,
                                            const S* __restrict__ x, A* __restrict__ y,
                                            long long rows, int width, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int step = kThreads / lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * step; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * step) {
    const long long r = r0 + threadIdx.x / lanes;
    A acc = A(0);
    if (r < rows) {
      const S* vr = val + r * width;
      const int* cr = col + r * width;
      for (int s = lane; s < width; s += lanes)
        acc += to_acc<A>(__ldcs(vr + s)) * to_acc<A>(gather(x, __ldcs(cr + s)));
    }
    acc = butterfly(acc, lanes);
    if (lane == 0 && r < rows) __stcs(y + r, acc);
  }
}

template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_kernel(const S* __restrict__ val, const int* __restrict__ col, const S* __restrict__ x,
                    A* __restrict__ y, long long rows, int width, int lanes, int path) {
  if (path == kVector)
    vector_rows<S, A>(val, col, x, y, rows, width, lanes);
  else if (path == kWide)
    wide_rows<S, A>(val, col, x, y, rows, width);
  else
    scalar_rows<S, A>(val, col, x, y, rows, width, lanes);
}

// Blocks of one launch: enough to cover the rows once, at most as many as
// the card holds at once (SMs times the kernel's occupancy).
template <typename S, typename A>
long long spmv_ell_grid(long long rows, int lanes, int path, int sms) {
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, spmv_ell_kernel<S, A>, kThreads, 0) ||
        n < 1)
      n = 1;
    return n;
  }();
  const long long step = path == kWide ? kThreads / 32 : kThreads / lanes;
  const long long per_block = path == kVector ? step * kRows : step;
  const long long need = ceil_div(rows, per_block);
  const long long most = static_cast<long long>(sms) * per_sm;
  return need < most ? need : most;
}

template <typename S, typename A>
struct SpmvEll {
  static int run(const void* val, const void* col, const void* x, void* y, long long rows,
                 int width, int lanes, int path, int sms, cudaStream_t stream) {
    if (rows == 0) return 0;
    constexpr int V = 16 / sizeof(S);
    const bool bad_lanes = lanes < 1 || lanes > 32 || (lanes & (lanes - 1));
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(col);
    const bool vec_ok = width % V == 0 && (bases & 15) == 0;
    if (bad_lanes || path < kVector || path > kScalar || (path != kScalar && !vec_ok) ||
        (path == kWide && lanes != 32) || sms < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = spmv_ell_grid<S, A>(rows, lanes, path, sms);
    spmv_ell_kernel<S, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const S*>(val), static_cast<const int*>(col), static_cast<const S*>(x),
        static_cast<A*>(y), rows, width, lanes, path);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int repro_spmv_ell(int sdt, int adt, const void* val, const void* col, const void* x,
                              void* y, long long rows, int width, int lanes, int path, int sms,
                              void* stream) {
  return dispatch_pair<SpmvEll>(sdt, adt, val, col, x, y, rows, width, lanes, path, sms,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_error_string(int code) {
  if (code == ERR_UNSUPPORTED_DTYPES) return "unsupported (storage, accum) dtype pair";
  if (code == -2) return "unsupported BSR block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
