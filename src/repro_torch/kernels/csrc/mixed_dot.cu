// mixed_dot: sum_i a[i] * b[i] in A over tiles of `block` elements, the
// tile totals summed in tile order with an optional Neumaier compensation
// term; writes out = (sum, comp), the caller's dot being sum + comp.
//
// Replaces the TPU kernel src/repro/kernels/mixed_dot.py:
// mixed_dot_kernel_call.  There the grid ran over 4096-element tiles in
// order on one core and carried the running sum and its compensation in the
// output block from one step to the next.
//
// Bound on the card: bytes (two element reads for two flops), plus the
// recurrence over the tile totals, which the reference's semantics make
// serial: tile i's rounding depends on the running sum of tiles 0..i-1.
//
// Design:
// - One block per tile, the tiles taken in the order the blocks start (an
//   integer ticket), so they finish about in tile order.  Each thread reads
//   16 B vectors of a and b (read-only path), kChunks of each in flight
//   before any arithmetic, and sums its elements in element order; the
//   block tree then sums the threads in a fixed order.  The last tile may
//   be ragged: its lanes past n read zeros, and since s + 0 == s exactly,
//   the result equals a call on operands zero-padded to whole tiles, bit for
//   bit.  Operands whose base (or tile start) is not 16-byte aligned take
//   scalar loads in the same element-to-lane order: the same bits.
// - The block with ticket 0 walks the tile totals while the others compute
//   them: it waits for each total (its bits are its ready flag), stages
//   kStage totals at a time in shared memory, and runs the recurrence there
//   (see walk_tiles), so the serial chain of adds overlaps the streaming
//   pass instead of following it, and no step waits on a global load.
// No float atomics: the same inputs give the same bits on every run.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// at phase 8's Gram shape (n = 14,077,504, f32 -> f64) 0.045 ms a call
// uncompensated and 0.051 compensated, against 0.220 and 0.273 for the
// two-pass design this replaces; `torch.dot` takes 0.041.
//
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py phase 1): 48 registers and
// 3,884 B of static shared memory under f32 accumulation; 48-56 registers
// and 7,764 B under f64; no stack frame, no spills.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kChunks = 4;   // 16 B vectors in flight per thread and operand
constexpr int kStage = kThreads - 64;  // totals per round of the walk: one a thread of warps 2..
constexpr int kBatch = 16;             // totals in registers ahead of a chain of adds
constexpr long long kSpinCycles = 20000000000LL;  // about 10 s: the walker's wait for a total

template <typename S> __device__ __forceinline__ S zero_of() { return S(0); }
template <> __device__ __forceinline__ __half zero_of<__half>() { return __float2half_rn(0.0f); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

template <typename T, int N>
__device__ __forceinline__ void load_ro(const T* p, T (&out)[N]) {
  static_assert(sizeof(T) * N == 16, "one 16-byte vector");
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  memcpy(out, &u, 16);
}

template <typename A>
__device__ __forceinline__ A magnitude(A v) {
  return v < A(0) ? -v : v;
}

// This thread's share of one tile [lo, lo + len): 16 B chunks t, t + kThreads,
// ... in order, each chunk's elements in order.
template <typename S, typename A>
__device__ __forceinline__ A tile_share(const S* __restrict__ a, const S* __restrict__ b,
                                        long long lo, long long len, bool vec_ok) {
  constexpr int V = 16 / sizeof(S);
  const long long chunks = (len + V - 1) / V;
  A acc = A(0);
  for (long long c0 = threadIdx.x; c0 < chunks; c0 += static_cast<long long>(kChunks) * kThreads) {
    S va[kChunks][V], vb[kChunks][V];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const long long e = (c0 + static_cast<long long>(u) * kThreads) * V;
      if (vec_ok && e + V <= len) {
        load_ro(a + lo + e, va[u]);
        load_ro(b + lo + e, vb[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const bool in = e + j < len;
          va[u][j] = in ? a[lo + e + j] : zero_of<S>();
          vb[u][j] = in ? b[lo + e + j] : zero_of<S>();
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) acc += to_acc<A>(va[u][j]) * to_acc<A>(vb[u][j]);
  }
  return acc;
}

// A chain of dependent adds over p[i..m): s = s + p[i], in order, with each
// running sum kept in keep[i] when kKeep.  kBatch totals are read from shared
// memory into registers ahead of their adds, so a step costs one add's
// latency and not a load's.
template <typename A, bool kKeep>
__device__ __forceinline__ A chain(const A* p, A* keep, int i, int m, A s) {
  for (; i + kBatch <= m; i += kBatch) {
    A q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) q[u] = p[i + u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      s = s + q[u];
      if constexpr (kKeep) keep[i + u] = s;
    }
  }
  for (; i < m; ++i) {
    s = s + p[i];
    if constexpr (kKeep) keep[i] = s;
  }
  return s;
}

// An unpublished tile total holds all-ones bits (the C entry's 0xFF memset):
// a NaN that publish() never writes, since it stores every NaN as the
// canonical one.  So a total is its own ready flag: one aligned store by its
// block, one load by the walker, no fences.
__device__ __forceinline__ bool unset(float v) { return __float_as_uint(v) == 0xFFFFFFFFu; }
__device__ __forceinline__ bool unset(double v) { return __double_as_longlong(v) == -1LL; }
__device__ __forceinline__ float canonical_nan(float) { return __uint_as_float(0x7FC00000u); }
__device__ __forceinline__ double canonical_nan(double) {
  return __longlong_as_double(0x7FF8000000000000LL);
}

template <typename A>
__device__ __forceinline__ void publish(A* p, A v) {
  *reinterpret_cast<volatile A*>(p) = v != v ? canonical_nan(v) : v;
}

// Wait for a tile's total.  A total that never comes (a fault elsewhere)
// traps after about ten seconds instead of hanging.
template <typename A>
__device__ __forceinline__ A await_total(const A* p) {
  const long long t0 = clock64();
  A v;
  while (unset(v = *reinterpret_cast<const volatile A*>(p))) {
    __nanosleep(32);
    if (clock64() - t0 > kSpinCycles) __trap();
  }
  return v;
}

// The walker: the TPU grid's recurrence (mixed_dot.py:_kernel) over the tile
// totals, as the tiles finish.  Tile 0 sets the sum, every later tile i
// adds in (t = s + p_i), and with compensation the rounding error of each
// add, e_i = |s| >= |p_i| ? (s - t) + p_i : (p_i - t) + s (Neumaier: the
// larger operand decides), is summed in tile order into comp.  The running
// sums do not depend on comp, so the work splits three ways, one round of
// kStage tiles apart: warps 2.. wait for round k + 1's totals (one a
// thread) and stage them in shared memory, thread 0 runs the chain of sums over round k (keeping
// each t for the compensation), and warp 1 turns round k - 1 into its e_i
// in parallel, in place, then its lane 0 runs the chain comp += e_i.  The
// bits are those of the one-thread recurrence.
template <typename A>
__device__ void walk_tiles(const A* __restrict__ partials, long long tiles, int compensated,
                           A* __restrict__ out) {
  __shared__ A part[3][kStage];  // round k's totals in part[k % 3]; warp 1 rewrites them as e_i
  __shared__ A sums[2][kStage];  // round k's running sums (compensated only)
  __shared__ A before[2];        // the running sum before round k
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long rounds = (tiles + kStage - 1) / kStage;
  auto count = [&](long long k) {
    return static_cast<int>(tiles - k * kStage < kStage ? tiles - k * kStage : kStage);
  };
  auto stage = [&](long long k) {  // by warps 2..: one total each
    const int i = threadIdx.x - 64;
    if (i < count(k)) part[k % 3][i] = await_total(partials + k * kStage + i);
  };
  if (warp >= 2) stage(0);
  __syncthreads();
  A s = A(0), comp = A(0);
  for (long long k = 0; k <= rounds; ++k) {
    if (warp >= 2) {
      if (k + 1 < rounds) stage(k + 1);
    } else if (threadIdx.x == 0) {
      if (k < rounds) {
        const A* p = part[k % 3];
        A* t = sums[k & 1];
        int i = 0;
        if (k == 0) {
          s = t[0] = p[0];
          i = 1;
        }
        before[k & 1] = s;
        s = compensated ? chain<A, true>(p, t, i, count(k), s)
                        : chain<A, false>(p, t, i, count(k), s);
      }
    } else if (warp == 1 && compensated && k >= 1) {
      const long long j = k - 1;  // the round whose sums thread 0 ran last round
      A* e = part[j % 3];
      const A* t = sums[j & 1];
      const int m = count(j);
      for (int i = lane; i < m; i += 32) {
        if (j == 0 && i == 0) {
          e[0] = A(0);  // tile 0 sets the sum: no add, no error
          continue;
        }
        const A prev = i ? t[i - 1] : before[j & 1];
        const A p = e[i];
        e[i] = magnitude(prev) >= magnitude(p) ? (prev - t[i]) + p : (p - t[i]) + prev;
      }
      __syncwarp();
      if (lane == 0) comp = chain<A, false>(e, nullptr, 0, m, comp);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s;
  if (threadIdx.x == 32) out[1] = comp;
}

// The first block to take a ticket walks; the others take tiles in ticket
// order (so the tiles finish about in the order the walk needs them), each
// publishing its total.  The ticket counter starts at all ones, so the
// first ticket is 0.
template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    mixed_dot_kernel(const S* __restrict__ a, const S* __restrict__ b, A* __restrict__ partials,
                     unsigned* __restrict__ counter, A* __restrict__ out, long long n, int block,
                     int compensated, int vec_ok) {
  __shared__ A scratch[kThreads / 32];
  __shared__ unsigned ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u) + 1u;
  __syncthreads();
  const long long tiles = static_cast<long long>(gridDim.x) - 1;
  if (ticket == 0) {
    walk_tiles(partials, tiles, compensated, out);
    return;
  }
  const long long tile = ticket - 1;
  const long long lo = tile * block;
  const long long len = n - lo < block ? n - lo : block;
  A acc = tile_share<S, A>(a, b, lo, len, vec_ok);
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) publish(partials + tile, acc);
}

// partials holds `tiles` totals and, right after them, one slot of A for the
// ticket counter: one memset readies both.
template <typename S, typename A>
int run_mixed_dot(const void* a, const void* b, void* out, void* partials, long long n, int block,
                  int compensated, cudaStream_t stream) {
  if (n < 1 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ceil_div(n, block);
  if (tiles >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(S);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  const int vec_ok = (bases & 15) == 0 && (tiles == 1 || block % V == 0);
  const int err =
      static_cast<int>(cudaMemsetAsync(partials, 0xFF, sizeof(A) * (tiles + 1), stream));
  if (err) return err;
  A* totals = static_cast<A*>(partials);
  mixed_dot_kernel<S, A><<<static_cast<unsigned>(tiles + 1), kThreads, 0, stream>>>(
      static_cast<const S*>(a), static_cast<const S*>(b), totals,
      reinterpret_cast<unsigned*>(totals + tiles), static_cast<A*>(out), n, block, compensated,
      vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int by_storage(int sdt, const void* a, const void* b, void* out, void* partials, long long n,
               int block, int compensated, cudaStream_t stream) {
  if (sdt == DT_F32)
    return run_mixed_dot<float, A>(a, b, out, partials, n, block, compensated, stream);
  if (sdt == DT_F64)
    return run_mixed_dot<double, A>(a, b, out, partials, n, block, compensated, stream);
  if (sdt == DT_F16)
    return run_mixed_dot<__half, A>(a, b, out, partials, n, block, compensated, stream);
  if (sdt == DT_BF16)
    return run_mixed_dot<__nv_bfloat16, A>(a, b, out, partials, n, block, compensated, stream);
  return ERR_UNSUPPORTED_DTYPES;
}

}  // namespace

extern "C" int repro_mixed_dot(int sdt, int adt, const void* a, const void* b, void* out,
                               void* partials, long long n, int block, int compensated,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adt == DT_F32)
    return by_storage<float>(sdt, a, b, out, partials, n, block, compensated, s);
  if (adt == DT_F64)
    return by_storage<double>(sdt, a, b, out, partials, n, block, compensated, s);
  return ERR_UNSUPPORTED_DTYPES;
}

#define MIXED_DOT_KERNELS(X)                 \
  X(mixed_dot_kernel<float, float>)          \
  X(mixed_dot_kernel<float, double>)         \
  X(mixed_dot_kernel<double, float>)         \
  X(mixed_dot_kernel<double, double>)        \
  X(mixed_dot_kernel<__half, float>)         \
  X(mixed_dot_kernel<__half, double>)        \
  X(mixed_dot_kernel<__nv_bfloat16, float>)  \
  X(mixed_dot_kernel<__nv_bfloat16, double>)
REPRO_KERNEL_TABLE(repro_kernels_mixed_dot, MIXED_DOT_KERNELS)
