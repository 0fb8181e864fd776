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
// Design: the three row paths of ell_row.cuh (vector, wide, scalar), picked
// by the wrapper from the shapes (kernels/spmv_ell.py:ell_launch_plan), with
// an epilogue that writes y[r] with a streaming store.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.108-0.114 ms a launch on the main path, 84-88% of its 0.0952 ms bound,
// against 0.22 ms for the lane-group design this replaces.
//
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py phase 1): 80 registers for
// <float, float> and <float, double>, 64 for <double, double>, 128 for the
// bf16 and f16 storage (eight columns a lane); no stack frame, no spills.
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

template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_kernel(const S* __restrict__ val, const int* __restrict__ col, const S* __restrict__ x,
                    A* __restrict__ y, long long rows, int width, int lanes, int path) {
  StoreY<A> e{y};
  ell_rows<S, A>(val, col, x, e, rows, width, lanes, path);
}

template <typename S, typename A>
struct SpmvEll {
  static int run(const void* val, const void* col, const void* x, void* y, long long rows,
                 int width, int lanes, int path, int sms, cudaStream_t stream) {
    if (rows == 0) return 0;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(col);
    if (!ell_plan_ok(width, 16 / sizeof(S), bases, lanes, path, sms))
      return static_cast<int>(cudaErrorInvalidValue);
    static const int per_sm = blocks_per_sm(spmv_ell_kernel<S, A>);
    const long long blocks = ell_grid(rows, lanes, path, sms, per_sm);
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

#define SPMV_ELL_KERNELS(X)                                                  \
  X(spmv_ell_kernel<float, float>) X(spmv_ell_kernel<float, double>)          \
  X(spmv_ell_kernel<double, double>) X(spmv_ell_kernel<__nv_bfloat16, float>) \
  X(spmv_ell_kernel<__half, float>)
REPRO_KERNEL_TABLE(repro_kernels_spmv_ell, SPMV_ELL_KERNELS)

extern "C" const char* repro_error_string(int code) {
  if (code == ERR_UNSUPPORTED_DTYPES) return "unsupported (storage, accum) dtype pair";
  if (code == -2) return "unsupported BSR block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
