// spmv_ell: y[r] = sum_s val[r, s] * x[col[r, s]], accumulated in A.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py:spmv_ell_kernel_call.
// There the whole of x sat in VMEM and the width axis of the grid ran in
// order on one core, summing into the output tile.  Here an aligned group
// of lanes takes one row (see ell_row.cuh) and sums it with warp shuffles;
// x is gathered through L2.
//
// Bound on the card: bytes.  Each slot costs one value and one int32 index
// (8 B in f32) and does two flops, far below the H100's ~20 flop/B balance
// even in f64.  The design's answer is to move no byte it need not: no
// 128-slot TPU width padding (the port pads the width to 8), coalesced
// reads of val/col, and x left to the L2 cache.
#include "ell_row.cuh"

namespace {

template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_kernel(const S* __restrict__ val, const int* __restrict__ col, const S* __restrict__ x,
                    A* __restrict__ y, long long rows, int width, int group) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long r = t / group;
  const int lane = threadIdx.x & (group - 1);
  A acc = ell_row_partial<S, A>(val, col, x, r, rows, width, lane, group);
  acc = group_sum(acc, group);
  if (lane == 0 && r < rows) y[r] = acc;
}

template <typename S, typename A>
struct SpmvEll {
  static int run(const void* val, const void* col, const void* x, void* y, long long rows,
                 int width, int group, cudaStream_t stream) {
    if (rows == 0) return 0;
    spmv_ell_kernel<S, A><<<static_cast<unsigned>(ell_blocks(rows, group)), kThreads, 0, stream>>>(
        static_cast<const S*>(val), static_cast<const int*>(col), static_cast<const S*>(x),
        static_cast<A*>(y), rows, width, group);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int repro_spmv_ell(int sdt, int adt, const void* val, const void* col, const void* x,
                              void* y, long long rows, int width, int group, void* stream) {
  return dispatch_pair<SpmvEll>(sdt, adt, val, col, x, y, rows, width, group,
                                static_cast<cudaStream_t>(stream));
}

extern "C" long long repro_ell_blocks(long long rows, int group) { return ell_blocks(rows, group); }

extern "C" const char* repro_error_string(int code) {
  if (code == ERR_UNSUPPORTED_DTYPES) return "unsupported (storage, accum) dtype pair";
  if (code == -2) return "unsupported BSR block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
