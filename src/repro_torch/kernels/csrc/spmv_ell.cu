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
// Design: the four row paths of ell_row.cuh (vector, wide, split, scalar),
// picked by the wrapper from the shapes and the card's SM count
// (kernels/spmv_ell.py:ell_launch_plan), with an epilogue that writes y[r]
// with a streaming store.  The split path is its own kernel
// (spmv_ell_split_kernel), so the other paths keep their registers.
//
// The split path (few wide rows: a chunk holding a hub, the top rows of a
// graph ordered by degree) is bound by bytes too: 8 B a slot of val and col
// (f32), read once, plus the x it touches.  The wide path gave each row one
// warp: 8 rows ran 8 warps on a card that holds 8,448, each walking its
// row in thousands of dependent steps.  The split path gives each segment
// of 32 x seg_vecs vectors its own warp; segments are independent, and a
// second launch (common.cuh: reduce_partials_kernel, a block a row) sums
// each row's partials in a fixed order.  No memset, no atomics.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.108-0.114 ms a launch on the main path, 84-88% of its 0.0952 ms bound,
// against 0.22 ms for the lane-group design this replaces.
//
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py phase 1): 80 registers for
// <float, float> and <float, double>, 64 for <double, double>, 128 for the
// bf16 and f16 storage (eight columns a lane); no stack frame, no spills.
//
// Instantiations <S, X, A>: x in the storage dtype (X = S) for the five
// policy pairs, and x already in the accum dtype (X = A) where S is not A:
// the wrapper widens a foreign x to A once (kernels/ops.py), the same
// value every product would have widened it to.
#include "ell_row.cuh"

namespace {

// The epilogue of spmv_ell: y[r] = the row's sum.
template <typename A>
struct StoreY {
  A* __restrict__ y;
  struct Pre {};
  __device__ __forceinline__ Pre load(long long) const { return {}; }
  __device__ __forceinline__ void store(long long r, A acc, Pre) const { __stcs(y + r, acc); }
};

template <typename S, typename X, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_kernel(const S* __restrict__ val, const int* __restrict__ col, const X* __restrict__ x,
                    A* __restrict__ y, long long rows, int width, int lanes, int path) {
  StoreY<A> e{y};
  ell_rows<S, X, A>(val, col, x, e, rows, width, lanes, path);
}

// The split path: one warp a segment of a row (ell_row.cuh:split_rows).
template <typename S, typename X, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_split_kernel(const S* __restrict__ val, const int* __restrict__ col,
                          const X* __restrict__ x, A* __restrict__ partials, long long rows,
                          int width, int seg_vecs) {
  split_rows<S, X, A>(val, col, x, partials, rows, width, seg_vecs);
}

template <typename S, typename X, typename A>
struct SpmvEll {
  static int run(const void* val, const void* col, const void* x, void* y, void* partials,
                 long long rows, int width, int lanes, int path, int seg_vecs, int sms,
                 cudaStream_t stream) {
    if (rows == 0) return 0;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(col);
    if (!ell_plan_ok(width, 16 / sizeof(S), bases, lanes, path, sms, seg_vecs))
      return static_cast<int>(cudaErrorInvalidValue);
    if (path == kSplit) {
      static const int split_per_sm = blocks_per_sm(spmv_ell_split_kernel<S, X, A>);
      const long long segs = split_segs(width, 16 / sizeof(S), seg_vecs);
      const long long blocks = ell_grid(rows * segs, lanes, path, sms, split_per_sm);
      spmv_ell_split_kernel<S, X, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const S*>(val), static_cast<const int*>(col), static_cast<const X*>(x),
          static_cast<A*>(partials), rows, width, seg_vecs);
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
      // each row's partials, in a fixed order, into y: a block a row
      return launch_reduce_partials<A>(static_cast<const A*>(partials), segs, static_cast<A*>(y),
                                       stream, static_cast<int>(rows));
    }
    static const int per_sm = blocks_per_sm(spmv_ell_kernel<S, X, A>);
    const long long blocks = ell_grid(rows, lanes, path, sms, per_sm);
    spmv_ell_kernel<S, X, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const S*>(val), static_cast<const int*>(col), static_cast<const X*>(x),
        static_cast<A*>(y), rows, width, lanes, path);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// xdt: x's dtype, the storage dtype sdt or the accum dtype adt (dispatch_gather).
// partials (rows x segs in the accum dtype) is the split path's scratch,
// from the wrapper; unused (may be null) on the other paths.
extern "C" int repro_spmv_ell(int sdt, int xdt, int adt, const void* val, const void* col,
                              const void* x, void* y, void* partials, long long rows, int width,
                              int lanes, int path, int seg_vecs, int sms, void* stream) {
  return dispatch_gather<SpmvEll>(sdt, xdt, adt, val, col, x, y, partials, rows, width, lanes,
                                  path, seg_vecs, sms, static_cast<cudaStream_t>(stream));
}

#define SPMV_ELL_KERNELS(K)                                  \
  K(spmv_ell_kernel<float, float, float>)                    \
  K(spmv_ell_kernel<float, float, double>)                   \
  K(spmv_ell_kernel<double, double, double>)                 \
  K(spmv_ell_kernel<__nv_bfloat16, __nv_bfloat16, float>)    \
  K(spmv_ell_kernel<__half, __half, float>)                  \
  K(spmv_ell_kernel<float, double, double>)                  \
  K(spmv_ell_kernel<__nv_bfloat16, float, float>)            \
  K(spmv_ell_kernel<__half, float, float>)                  \
  K(spmv_ell_split_kernel<float, float, float>)              \
  K(spmv_ell_split_kernel<float, float, double>)             \
  K(spmv_ell_split_kernel<double, double, double>)           \
  K(spmv_ell_split_kernel<__nv_bfloat16, __nv_bfloat16, float>) \
  K(spmv_ell_split_kernel<__half, __half, float>)            \
  K(spmv_ell_split_kernel<float, double, double>)            \
  K(spmv_ell_split_kernel<__nv_bfloat16, float, float>)      \
  K(spmv_ell_split_kernel<__half, float, float>)
REPRO_KERNEL_TABLE(repro_kernels_spmv_ell, SPMV_ELL_KERNELS)

extern "C" const char* repro_error_string(int code) {
  if (code == ERR_UNSUPPORTED_DTYPES) return "unsupported (storage, accum) dtype pair";
  if (code == -2) return "unsupported BSR block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
