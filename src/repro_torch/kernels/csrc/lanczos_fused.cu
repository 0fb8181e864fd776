// spmv_ell_alpha: w = ELL(val, col) @ x and alpha = <v, w> in one pass.
//
// Replaces the TPU kernel src/repro/kernels/lanczos_fused.py:
// spmv_ell_alpha_kernel_call.  There each finished row tile of w was dotted
// with v while still in VMEM, and alpha was carried across the sequential
// grid.  Blocks on the card run in no order and carry nothing, so the
// contract becomes two passes: each block writes its partial of
// sum_r v[r] * w[r] (fixed in-block order), and one block then sums the
// partials in a fixed order.  No float atomics: alpha has the same bits on
// every run.
//
// Bound on the card: bytes, as spmv_ell, plus one read of v (the alpha
// operand in the accum dtype).  The design's answer: alpha costs no extra
// pass over w, which is never re-read.
#include "ell_row.cuh"

namespace {

template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_alpha_kernel(const S* __restrict__ val, const int* __restrict__ col,
                          const S* __restrict__ x, const A* __restrict__ v, long long nv,
                          A* __restrict__ w, A* __restrict__ partials, long long rows, int width,
                          int group) {
  __shared__ A scratch[kThreads / 32];
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long r = t / group;
  const int lane = threadIdx.x & (group - 1);
  A acc = ell_row_partial<S, A>(val, col, x, r, rows, width, lane, group);
  acc = group_sum(acc, group);
  A contrib = A(0);
  if (lane == 0 && r < rows) {
    w[r] = acc;
    if (r < nv) contrib = v[r] * acc;  // rows past len(v) are padding: alpha ignores them
  }
  contrib = block_sum(contrib, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = contrib;
}

template <typename S, typename A>
struct SpmvEllAlpha {
  static int run(const void* val, const void* col, const void* x, const void* v, long long nv,
                 void* w, void* partials, void* alpha, long long rows, int width, int group,
                 cudaStream_t stream) {
    if (rows == 0) return 0;
    const long long blocks = ell_blocks(rows, group);
    spmv_ell_alpha_kernel<S, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const S*>(val), static_cast<const int*>(col), static_cast<const S*>(x),
        static_cast<const A*>(v), nv, static_cast<A*>(w), static_cast<A*>(partials), rows, width,
        group);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    return launch_reduce_partials<A>(static_cast<const A*>(partials), blocks,
                                     static_cast<A*>(alpha), stream);
  }
};

}  // namespace

extern "C" int repro_spmv_ell_alpha(int sdt, int adt, const void* val, const void* col,
                                    const void* x, const void* v, long long nv, void* w,
                                    void* partials, void* alpha, long long rows, int width,
                                    int group, void* stream) {
  return dispatch_pair<SpmvEllAlpha>(sdt, adt, val, col, x, v, nv, w, partials, alpha, rows, width,
                                     group, static_cast<cudaStream_t>(stream));
}

extern "C" long long repro_ell_blocks(long long rows, int group) { return ell_blocks(rows, group); }
