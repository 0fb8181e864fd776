// spmv_ell_alpha: w = ELL(val, col) @ x and alpha = <v, w> in one pass.
//
// Replaces the TPU kernel src/repro/kernels/lanczos_fused.py:
// spmv_ell_alpha_kernel_call.  There each finished row tile of w was dotted
// with v while still in VMEM, and alpha was carried across the sequential
// grid.  Blocks on the card run in no order and carry nothing, so the
// contract becomes two passes: each block writes its partial of
// sum_r v[r] * w[r], and one block then sums the partials in a fixed
// order.  No float atomics: alpha has the same bits on every run.
//
// Bound on the card: bytes, as spmv_ell, plus one read of v (the alpha
// operand in the accum dtype).  The design's answer: alpha costs no extra
// pass over w, which is never re-read.
//
// Design: spmv_ell's row code (ell_row.cuh: vector, wide and scalar paths,
// a grid of SMs x occupancy walked with a grid stride), so w has spmv_ell's
// bits on every path.  The epilogue loads v[r] with the row's val and col,
// streams w[r] out, and adds v[r] * w[r] into the thread's running part of
// alpha, in its grid-stride order; rows past len(v) are padding and add
// nothing.  Each block ends with one block_sum of its threads' parts (one
// partial per block: SMs x occupancy, a few hundred, not one per 256 lanes
// of rows), and a second launch sums the partials in a fixed order.  A
// second launch rather than a last-block ticket: the ticket needs a counter
// that is zero before every call (a memset, itself a launch) or one shared
// by every stream, and the pass over a few hundred partials is a few
// microseconds either way.  The grid, and so the order of every sum,
// depends only on the rows, the plan and the card.
#include "ell_row.cuh"

namespace {

// The epilogue of spmv_ell_alpha: w[r] = the row's sum; contrib += v[r] * w[r].
template <typename A>
struct AlphaStore {
  A* __restrict__ w;
  const A* __restrict__ v;
  long long nv;
  A contrib;  // this thread's part of alpha
  using Pre = A;
  __device__ __forceinline__ A load(long long r) const { return r < nv ? __ldcs(v + r) : A(0); }
  __device__ __forceinline__ void store(long long r, A acc, A vr) {
    __stcs(w + r, acc);
    if (r < nv) contrib += vr * acc;  // rows past len(v) are padding: alpha ignores them
  }
};

template <typename S, typename X, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_alpha_kernel(const S* __restrict__ val, const int* __restrict__ col,
                          const X* __restrict__ x, const A* __restrict__ v, long long nv,
                          A* __restrict__ w, A* __restrict__ partials, long long rows, int width,
                          int lanes, int path) {
  __shared__ A scratch[kThreads / 32];
  AlphaStore<A> e{w, v, nv, A(0)};
  ell_rows<S, X, A>(val, col, x, e, rows, width, lanes, path);
  const A total = block_sum(e.contrib, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename S, typename X, typename A>
struct SpmvEllAlpha {
  static int run(const void* val, const void* col, const void* x, const void* v, long long nv,
                 void* w, void* partials, long long n_partials, void* alpha, long long rows,
                 int width, int lanes, int path, int sms, cudaStream_t stream) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(col);
    if (!ell_plan_ok(width, 16 / sizeof(S), bases, lanes, path, sms) || nv < 0 || nv > rows)
      return static_cast<int>(cudaErrorInvalidValue);
    static const int per_sm = blocks_per_sm(spmv_ell_alpha_kernel<S, X, A>);
    const long long blocks = rows == 0 ? 0 : ell_grid(rows, lanes, path, sms, per_sm);
    if (blocks > n_partials) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks > 0) {
      spmv_ell_alpha_kernel<S, X, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const S*>(val), static_cast<const int*>(col), static_cast<const X*>(x),
          static_cast<const A*>(v), nv, static_cast<A*>(w), static_cast<A*>(partials), rows,
          width, lanes, path);
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
    }
    // With no rows the pass sums no partials: alpha = 0.
    return launch_reduce_partials<A>(static_cast<const A*>(partials), blocks,
                                     static_cast<A*>(alpha), stream);
  }
};

}  // namespace

// xdt: x's dtype, the storage dtype sdt or the accum dtype adt (dispatch_gather).
extern "C" int repro_spmv_ell_alpha(int sdt, int xdt, int adt, const void* val, const void* col,
                                    const void* x, const void* v, long long nv, void* w,
                                    void* partials, long long n_partials, void* alpha,
                                    long long rows, int width, int lanes, int path, int sms,
                                    void* stream) {
  return dispatch_gather<SpmvEllAlpha>(sdt, xdt, adt, val, col, x, v, nv, w, partials,
                                       n_partials, alpha, rows, width, lanes, path, sms,
                                       static_cast<cudaStream_t>(stream));
}

#define SPMV_ELL_ALPHA_KERNELS(K)                                  \
  K(spmv_ell_alpha_kernel<float, float, float>)                    \
  K(spmv_ell_alpha_kernel<float, float, double>)                   \
  K(spmv_ell_alpha_kernel<double, double, double>)                 \
  K(spmv_ell_alpha_kernel<__nv_bfloat16, __nv_bfloat16, float>)    \
  K(spmv_ell_alpha_kernel<__half, __half, float>)                  \
  K(spmv_ell_alpha_kernel<float, double, double>)                  \
  K(spmv_ell_alpha_kernel<__nv_bfloat16, float, float>)            \
  K(spmv_ell_alpha_kernel<__half, float, float>)
REPRO_KERNEL_TABLE(repro_kernels_spmv_ell_alpha, SPMV_ELL_ALPHA_KERNELS)
