// Shared helpers of the repro_torch Hopper kernels (sm_90a).
//
// Every kernel is templated on (S, A): S is the dtype the arrays are stored
// in, A the dtype products are accumulated in.  The C entry points take the
// pair as two dtype codes (DT_* below, mirrored in kernels/build.py) and
// return a cudaError_t as int: 0 on success, the launch error otherwise, and
// ERR_UNSUPPORTED_DTYPES for a pair that is not instantiated.
//
// Everything here has internal linkage (anonymous namespace), so the four
// translation units link into one shared library without sharing kernel
// symbols.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

enum DType : int {
  DT_F32 = 0,
  DT_F64 = 1,
  DT_F16 = 2,
  DT_BF16 = 3,
  DT_FP8_E4M3 = 4,  // packed chunk values (spmv_ell_packed)
  DT_I16 = 5,       // delta-encoded columns (spmv_ell_packed)
  DT_I32 = 6,
};
constexpr int ERR_UNSUPPORTED_DTYPES = -1;

// Threads per block of every launch: a multiple of 32, so row groups never
// straddle a warp and the block reduction sees whole warps.
constexpr int kThreads = 256;

// ---------------------------------------------------------------- casts
template <typename A> __device__ __forceinline__ A to_acc(float v) { return static_cast<A>(v); }
template <typename A> __device__ __forceinline__ A to_acc(double v) { return static_cast<A>(v); }
template <typename A> __device__ __forceinline__ A to_acc(__half v) {
  return static_cast<A>(__half2float(v));
}
template <typename A> __device__ __forceinline__ A to_acc(__nv_bfloat16 v) {
  return static_cast<A>(__bfloat162float(v));
}
// fp8 e4m3 -> float is exact; so is float -> double.
template <typename A> __device__ __forceinline__ A to_acc(__nv_fp8_e4m3 v) {
  return static_cast<A>(static_cast<float>(v));
}

// Round an accumulator value to the storage dtype (round to nearest even).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(float* p, double v) { *p = __double2float_rn(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ------------------------------------------------------------ reductions
// Sum over the lanes of an aligned group of `group` lanes (a power of two
// <= 32); the total lands in the group's first lane.  Every lane of the
// warp must call it.  Fixed butterfly order: the same bits on every run.
template <typename A>
__device__ __forceinline__ A group_sum(A v, int group) {
  for (int off = group / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off, group);
  return v;
}

// Sum over the whole block (blockDim.x == kThreads); the total is valid in
// thread 0.  `scratch` holds kThreads / 32 values.  Fixed order: warp
// shuffles, then warp 0 over the per-warp sums.
template <typename A>
__device__ __forceinline__ A block_sum(A v, A* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = group_sum(v, 32);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? scratch[lane] : A(0);
    v = group_sum(v, 32);
  }
  return v;
}

// Second pass of every cross-block reduction: one block sums the per-block
// partials in a fixed order (each thread a strided run, then the block
// tree) and writes out[0].  No float atomics anywhere.
template <typename A>
__global__ void __launch_bounds__(kThreads) reduce_partials_kernel(const A* __restrict__ partials,
                                                                   long long count,
                                                                   A* __restrict__ out) {
  __shared__ A scratch[kThreads / 32];
  A acc = A(0);
  for (long long i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename A>
int launch_reduce_partials(const A* partials, long long count, A* out, cudaStream_t stream) {
  reduce_partials_kernel<A><<<1, kThreads, 0, stream>>>(partials, count, out);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- dispatch
// Calls F<S, A>::run(args...) for the (storage, accum) pairs the seven
// precision policies use.
template <template <typename, typename> class F, typename... Args>
int dispatch_pair(int sdt, int adt, Args... args) {
  if (sdt == DT_F32 && adt == DT_F32) return F<float, float>::run(args...);
  if (sdt == DT_F32 && adt == DT_F64) return F<float, double>::run(args...);
  if (sdt == DT_F64 && adt == DT_F64) return F<double, double>::run(args...);
  if (sdt == DT_BF16 && adt == DT_F32) return F<__nv_bfloat16, float>::run(args...);
  if (sdt == DT_F16 && adt == DT_F32) return F<__half, float>::run(args...);
  return ERR_UNSUPPORTED_DTYPES;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// ------------------------------------------------------- kernel tables
// Every source lists its kernel instantiations, LIST(X) calling X once per
// instantiation, and REPRO_KERNEL_TABLE(fn, LIST) exports
//   extern "C" int fn(const char* const** names, const void* const** fns)
// returning how many there are: their names and host-stub addresses, which
// attrs.cu hands to cudaFuncGetAttributes for the resource report.
#define REPRO_KERNEL_NAME(...) #__VA_ARGS__,
#define REPRO_KERNEL_FN(...) reinterpret_cast<const void*>(&__VA_ARGS__),
#define REPRO_KERNEL_TABLE(fn, LIST)                                              \
  extern "C" int fn(const char* const** names, const void* const** fns) {        \
    static const char* const kNames[] = {LIST(REPRO_KERNEL_NAME)};                \
    static const void* const kFns[] = {LIST(REPRO_KERNEL_FN)};                    \
    *names = kNames;                                                              \
    *fns = kFns;                                                                  \
    return static_cast<int>(sizeof(kFns) / sizeof(kFns[0]));                      \
  }
