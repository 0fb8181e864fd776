// mixed_dot: sum_i a[i] * b[i] in A over tiles of `block` elements, the
// tile totals summed in tile order with an optional Neumaier compensation
// term; writes out = (sum, comp), the caller's dot being sum + comp.
//
// Replaces the TPU kernel src/repro/kernels/mixed_dot.py:
// mixed_dot_kernel_call.  There the grid ran over 4096-element tiles in
// order on one core and carried the running sum and its compensation in the
// output block from one step to the next.  Blocks on the card run in no
// order, so the two halves split: pass 1 gives each tile one block, which
// sums its products in a fixed order (strided lanes, then the block tree)
// and writes one partial; pass 2 is one thread that runs the TPU grid's
// recurrence over the partials, in tile order.  No float atomics: the same
// inputs give the same bits on every run.
//
// Bound on the card: bytes (two element reads for two flops).  Pass 2 is
// serial over n / block partials, 1,024 steps at n = 4M: a few
// microseconds, against about 10 us for pass 1 at that length in f32.
#include "common.cuh"

namespace {

template <typename A>
__device__ __forceinline__ A magnitude(A v) {
  return v < A(0) ? -v : v;
}

template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    tile_dot_kernel(const S* __restrict__ a, const S* __restrict__ b, A* __restrict__ partials,
                    long long n, int block) {
  __shared__ A scratch[kThreads / 32];
  const long long lo = static_cast<long long>(blockIdx.x) * block;
  const long long hi = lo + block < n ? lo + block : n;
  A acc = A(0);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) acc += to_acc<A>(a[i]) * to_acc<A>(b[i]);
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// The TPU grid's recurrence (mixed_dot.py:_kernel): tile 0 sets the sum,
// every later tile adds in, and with compensation the rounding error of
// each add is collected in `comp` (Neumaier: the larger operand decides).
template <typename A>
__global__ void tile_sum_kernel(const A* __restrict__ partials, long long tiles, int compensated,
                                A* __restrict__ out) {
  A s = partials[0];
  A comp = A(0);
  for (long long i = 1; i < tiles; ++i) {
    const A p = partials[i];
    if (compensated) {
      const A t = s + p;
      comp = comp + (magnitude(s) >= magnitude(p) ? (s - t) + p : (p - t) + s);
      s = t;
    } else {
      s = s + p;
    }
  }
  out[0] = s;
  out[1] = comp;
}

template <typename S, typename A>
int run_mixed_dot(const void* a, const void* b, void* partials, void* out, long long n, int block,
                  int compensated, cudaStream_t stream) {
  const long long tiles = ceil_div(n, block);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  tile_dot_kernel<S, A><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const S*>(a), static_cast<const S*>(b), static_cast<A*>(partials), n, block);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  tile_sum_kernel<A><<<1, 1, 0, stream>>>(static_cast<const A*>(partials), tiles, compensated,
                                          static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int by_storage(int sdt, const void* a, const void* b, void* partials, void* out, long long n,
               int block, int compensated, cudaStream_t stream) {
  if (sdt == DT_F32) return run_mixed_dot<float, A>(a, b, partials, out, n, block, compensated, stream);
  if (sdt == DT_F64) return run_mixed_dot<double, A>(a, b, partials, out, n, block, compensated, stream);
  if (sdt == DT_F16) return run_mixed_dot<__half, A>(a, b, partials, out, n, block, compensated, stream);
  if (sdt == DT_BF16)
    return run_mixed_dot<__nv_bfloat16, A>(a, b, partials, out, n, block, compensated, stream);
  return ERR_UNSUPPORTED_DTYPES;
}

}  // namespace

extern "C" int repro_mixed_dot(int sdt, int adt, const void* a, const void* b, void* partials,
                               void* out, long long n, int block, int compensated, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adt == DT_F32) return by_storage<float>(sdt, a, b, partials, out, n, block, compensated, s);
  if (adt == DT_F64) return by_storage<double>(sdt, a, b, partials, out, n, block, compensated, s);
  return ERR_UNSUPPORTED_DTYPES;
}
