// spmv_bsr: for each block-row i, y_i = sum_s val[i, s] @ x[bcol[i, s]*BS : +BS].
//
// Replaces the TPU kernel src/repro/kernels/spmv_bsr.py:spmv_bsr_kernel_call,
// which ran one small matvec per (block-row, slot) step on the MXU and
// summed across the sequential slot axis.  Here one thread owns one output
// row of a block-row: BS threads per block-row, 32/BS block-rows per warp.
// It loops over the slots, loads the block column, the BS-slice of x and its
// own row of the block, and accumulates with plain multiply-adds.  No
// cross-thread reduction, so nothing to order.  (Tensor-core MMA for BS = 16
// and DMMA for f64 are later work.)
//
// Bound on the card: bytes (each stored block value is read once and used
// for one multiply-add; x slices are shared by the BS threads of a
// block-row and come from L1/L2).
#include "common.cuh"

namespace {

constexpr int ERR_UNSUPPORTED_BLOCK = -2;

template <typename S, typename A, int BS>
__global__ void __launch_bounds__(kThreads)
    spmv_bsr_kernel(const S* __restrict__ val, const int* __restrict__ bcol,
                    const S* __restrict__ x, A* __restrict__ y, long long nbr, int slots) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = t / BS;
  const int r = static_cast<int>(t % BS);
  if (i >= nbr) return;  // no cross-thread work below: a ragged tail may leave early
  A acc = A(0);
  for (int s = 0; s < slots; ++s) {
    const long long slot = i * slots + s;
    const S* blk = val + (slot * BS + r) * BS;
    const S* xs = x + static_cast<long long>(bcol[slot]) * BS;
#pragma unroll
    for (int j = 0; j < BS; ++j) acc += to_acc<A>(blk[j]) * to_acc<A>(xs[j]);
  }
  y[i * BS + r] = acc;
}

template <typename S, typename A, int BS>
int launch_bsr(const void* val, const void* bcol, const void* x, void* y, long long nbr, int slots,
               cudaStream_t stream) {
  const long long blocks = ceil_div(nbr * BS, kThreads);
  spmv_bsr_kernel<S, A, BS><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const S*>(val), static_cast<const int*>(bcol), static_cast<const S*>(x),
      static_cast<A*>(y), nbr, slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename A>
struct SpmvBsr {
  static int run(const void* val, const void* bcol, const void* x, void* y, long long nbr,
                 int slots, int bs, cudaStream_t stream) {
    if (nbr == 0) return 0;
    switch (bs) {
      case 4: return launch_bsr<S, A, 4>(val, bcol, x, y, nbr, slots, stream);
      case 8: return launch_bsr<S, A, 8>(val, bcol, x, y, nbr, slots, stream);
      case 16: return launch_bsr<S, A, 16>(val, bcol, x, y, nbr, slots, stream);
      default: return ERR_UNSUPPORTED_BLOCK;
    }
  }
};

}  // namespace

extern "C" int repro_spmv_bsr(int sdt, int adt, const void* val, const void* bcol, const void* x,
                              void* y, long long nbr, int slots, int bs, void* stream) {
  return dispatch_pair<SpmvBsr>(sdt, adt, val, bcol, x, y, nbr, slots, bs,
                                static_cast<cudaStream_t>(stream));
}

#define SPMV_BSR_KERNELS(X)                    \
  X(spmv_bsr_kernel<float, float, 4>)          \
  X(spmv_bsr_kernel<float, float, 8>)          \
  X(spmv_bsr_kernel<float, float, 16>)         \
  X(spmv_bsr_kernel<float, double, 4>)         \
  X(spmv_bsr_kernel<float, double, 8>)         \
  X(spmv_bsr_kernel<float, double, 16>)        \
  X(spmv_bsr_kernel<double, double, 4>)        \
  X(spmv_bsr_kernel<double, double, 8>)        \
  X(spmv_bsr_kernel<double, double, 16>)       \
  X(spmv_bsr_kernel<__nv_bfloat16, float, 4>)  \
  X(spmv_bsr_kernel<__nv_bfloat16, float, 8>)  \
  X(spmv_bsr_kernel<__nv_bfloat16, float, 16>) \
  X(spmv_bsr_kernel<__half, float, 4>)         \
  X(spmv_bsr_kernel<__half, float, 8>)         \
  X(spmv_bsr_kernel<__half, float, 16>)       
REPRO_KERNEL_TABLE(repro_kernels_spmv_bsr, SPMV_BSR_KERNELS)
