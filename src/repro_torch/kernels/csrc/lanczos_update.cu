// lanczos_update: u = w - alpha v - beta v_prev (in A, stored in T) and
// ||u||^2 (in A) in one pass over the three vectors.
//
// Replaces the TPU kernel src/repro/kernels/lanczos_update.py:
// lanczos_update_kernel_call, which carried the norm across its sequential
// grid.  Here a grid-stride pass writes u and leaves one partial of
// sum u^2 per block (fixed in-block order) in a scratch tensor; a second
// one-block launch sums the partials in a fixed order.  No float atomics.
//
// alpha and beta arrive as device pointers: a host float would need a
// device->host copy, and so a stall, on every Lanczos step.
//
// Bound on the card: bytes (three vector reads and one write against six
// flops per element).  The design's answer: the norm
// rides on the same pass, so u is never read back.  The number of blocks
// is capped (kMaxUpdateBlocks) so the partials stay a few KB and the second
// pass is one short launch.
//
// One kernel serves the solo launch (one row) and the batched launch of the
// multi-start sweep, the counterpart of jax.vmap over the TPU kernel: rows
// of (B, n) w, v and v_prev with (B,) alpha and beta, one grid row a start
// (blockIdx.y).  Each start runs the solo block count and in-block order
// over its row, and its partials are summed by one block of the rows-wide
// reduce launch in the solo order, so row s has the bits of a solo launch
// on row s.  A step pays two launches for all starts instead of 2 B.
#include "common.cuh"

namespace {

constexpr long long kMaxUpdateBlocks = 1024;

inline long long update_blocks(long long n) {
  const long long b = ceil_div(n, kThreads);
  return b < kMaxUpdateBlocks ? (b > 0 ? b : 1) : kMaxUpdateBlocks;
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    lanczos_update_kernel(const T* __restrict__ w, const T* __restrict__ v,
                          const T* __restrict__ vp, const A* __restrict__ alpha,
                          const A* __restrict__ beta, T* __restrict__ u, A* __restrict__ partials,
                          long long n) {
  __shared__ A scratch[kThreads / 32];
  const unsigned row = blockIdx.y;
  const long long off = static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const A a = alpha[row], b = beta[row];
  w += off, v += off, vp += off, u += off;
  A acc = A(0);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    // Same operation order as the plain version: (w - a*v) - b*vp.
    const A ui = to_acc<A>(w[i]) - a * to_acc<A>(v[i]) - b * to_acc<A>(vp[i]);
    store(&u[i], ui);
    acc += ui * ui;
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[row * gridDim.x + blockIdx.x] = acc;
}

template <typename T, typename A>
struct LanczosUpdate {
  static int run(const void* w, const void* v, const void* vp, const void* alpha,
                 const void* beta, void* u, void* partials, void* nrm, long long n, int rows,
                 cudaStream_t stream) {
    const long long blocks = update_blocks(n);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
    lanczos_update_kernel<T, A><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(w), static_cast<const T*>(v), static_cast<const T*>(vp),
        static_cast<const A*>(alpha), static_cast<const A*>(beta), static_cast<T*>(u),
        static_cast<A*>(partials), n);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    return launch_reduce_partials<A>(static_cast<const A*>(partials), blocks,
                                     static_cast<A*>(nrm), stream, rows);
  }
};

}  // namespace

// rows: 1 for the solo launch, else the number of starts B, at most 65,535
// (the grid's y limit; the wrapper checks it).  partials holds
// rows * repro_update_blocks(n).
extern "C" int repro_lanczos_update(int tdt, int adt, const void* w, const void* v, const void* vp,
                                    const void* alpha, const void* beta, void* u, void* partials,
                                    void* nrm, long long n, int rows, void* stream) {
  return dispatch_pair<LanczosUpdate>(tdt, adt, w, v, vp, alpha, beta, u, partials, nrm, n, rows,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" long long repro_update_blocks(long long n) { return update_blocks(n); }

#define LANCZOS_UPDATE_KERNELS(X)                                                        \
  X(lanczos_update_kernel<float, float>) X(lanczos_update_kernel<float, double>)          \
  X(lanczos_update_kernel<double, double>) X(lanczos_update_kernel<__nv_bfloat16, float>) \
  X(lanczos_update_kernel<__half, float>) X(reduce_partials_kernel<float>)                \
  X(reduce_partials_kernel<double>)
REPRO_KERNEL_TABLE(repro_kernels_lanczos_update, LANCZOS_UPDATE_KERNELS)
