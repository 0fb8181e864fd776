// spmv_bsr: for each block-row i, y_i = sum_s val[i, s] @ x[bcol[i, s]*BS : +BS].
//
// Replaces the TPU kernel src/repro/kernels/spmv_bsr.py:spmv_bsr_kernel_call,
// which ran one small matvec per (block-row, slot) step on the MXU and
// summed across the sequential slot axis.
//
// Bound on the card: bytes.  A matrix-vector product does 2 flops for each
// 4-byte f32 value (0.5 flop/B), far below the card's ridge, so tensor cores
// buy nothing; the kernel has to read val at the memory's rate.  A
// block-row's slots * BS * BS values lie contiguous in val, and the design
// follows that layout:
//
// - kLanes lanes own a block-row (a power of two per element size and BS,
//   kBsrPlan) and walk its values as 16-byte vectors (4 f32, 2 f64, 8
//   bf16/f16): lane l reads vectors l, l + kLanes, ... of each block, so
//   neighbouring lanes read neighbouring addresses and one instruction
//   reads every sector it touches whole.  (One thread a row, as before,
//   read rows BS values apart: 32 sectors a warp load at BS 16, each
//   replayed through L1 for every value.)
// - kLanes vectors span whole block rows, so a lane keeps one column group
//   of every block (kXw columns) and serves kVecs * kRowsPerVec rows of it.
//   It loads that group's slice of x once a slot (8 or 16 bytes through the
//   read-only path), widens it once and uses it for all those rows.  Under
//   FDF (f32 -> f64) a block costs BS*BS conversions of val plus
//   kLanes * kXw of x, against 2*BS*BS when each product widened both
//   operands: 80 of 128 at BS 8 (4 lanes), 320 of 512 at BS 16 (16 lanes),
//   and 32 of 32 at BS 4, where each of the 4 lanes serves one row (2 lanes
//   would make it 24, but read 32 contiguous bytes an instruction against
//   64 and measured 6% slower: bench_torch/bsr_plans.py).
// - kUnroll slots a step: a lane issues all of a step's val vectors and x
//   slices, and the next step's bcol, before its first multiply-add.  The
//   plans are the fastest of bench_torch/bsr_plans.py's sweep for f32 (the
//   FDF storage); f64 and 16-bit values take the plan of the same bytes.
// - The lanes that share a row (its BS / kXw column groups, adjacent lanes)
//   add their partial sums in one fixed shuffle tree (group_sum): no shared
//   memory, no atomics.
//
// - x's dtype X is a template parameter of its own: S, or the accum dtype A
//   where S is not A (kernels/ops.py widens a foreign x to A once, the
//   value each product would have widened it to).  The plan stays S's (it
//   tiles val); a lane's x slice is kXw values of X, one or two 16-byte
//   loads (kernels/spmv_bsr.py:bsr_x_bytes gives the alignment).
//
// Deterministic: a lane sums its slots in storage order and the tree is
// fixed by the dtype and BS, so a row's bits depend only on its own
// block-row's stored slots: not on the grid, on zero slots appended, or on
// which range of block-rows a launch covers.
#include "common.cuh"

namespace {

constexpr int ERR_UNSUPPORTED_BLOCK = -2;

// The launch plan of each instantiation: {element bytes, BS, lanes a
// block-row, slots a step}.  kernels/spmv_bsr.py:BSR_PLAN mirrors it (K001).
constexpr int kBsrPlan[9][4] = {
    {4, 4, 4, 2}, {4, 8, 4, 4}, {4, 16, 16, 2},
    {8, 4, 4, 2}, {8, 8, 8, 2}, {8, 16, 16, 1},
    {2, 4, 2, 4}, {2, 8, 4, 2}, {2, 16, 8, 2},
};

constexpr int bsr_plan(int size, int bs, int field) {
  for (const auto& p : kBsrPlan)
    if (p[0] == size && p[1] == bs) return p[field];
  return 0;
}

template <typename S, int BS>
struct BsrShape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(S));  // values a vector of val
  static constexpr int kXw = kVec < BS ? kVec : BS;  // columns a lane serves of a block
  static constexpr int kRowsPerVec = kVec / kXw;     // block rows a vector spans: 2 at BS 4 in 16-bit types
  static constexpr int kGroups = BS / kXw;           // lanes that share a row
  static constexpr int kLanes = bsr_plan(sizeof(S), BS, 2);
  static constexpr int kUnroll = bsr_plan(sizeof(S), BS, 3);
  static constexpr int kVecs = BS * BS / kVec / (kLanes > 0 ? kLanes : 1);  // a lane's vectors a block
  static constexpr int kRowStep = kLanes * kVec / BS;  // block rows between them
  static_assert(kLanes >= kGroups && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "lanes: a power of two within a warp, whole column groups");
  static_assert(kVecs >= 1 && kVecs * kLanes * kVec == BS * BS, "the lanes' vectors tile a block");
  static_assert(kUnroll >= 1, "a plan for every instantiation");
};

// bcol of slots [s, s + U) of a block-row (0 past its last slot).
template <int U>
__device__ __forceinline__ void load_cols(const int* __restrict__ cols, int s, int slots,
                                          int (&c)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) c[u] = s + u < slots ? __ldcs(cols + s + u) : 0;
}

template <typename S, typename X, typename A, int BS>
__global__ void __launch_bounds__(kThreads)
    spmv_bsr_kernel(const S* __restrict__ val, const int* __restrict__ bcol,
                    const X* __restrict__ x, A* __restrict__ y, long long nbr, int slots) {
  using P = BsrShape<S, BS>;
  constexpr int U = P::kUnroll;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = t / P::kLanes;  // this group's block-row
  const int lane = threadIdx.x & (P::kLanes - 1);
  const int row0 = lane * P::kVec / BS, col0 = lane * P::kVec % BS;
  A acc[P::kVecs][P::kRowsPerVec] = {};
  if (i < nbr) {  // the whole group agrees; every lane stays for the shuffles
    const long long first = i * slots;
    const int* cols = bcol + first;
    const S* blocks = val + first * (BS * BS) + lane * P::kVec;
    int c[U];
    load_cols(cols, 0, slots, c);
    for (int s0 = 0; s0 < slots; s0 += U, blocks += U * BS * BS) {
      S v[U][P::kVecs][P::kVec];
      X xs[U][P::kXw];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u < slots) {
#pragma unroll
          for (int k = 0; k < P::kVecs; ++k)
            load_stream(blocks + u * BS * BS + k * P::kLanes * P::kVec, v[u][k]);
          load_ro(x + static_cast<long long>(c[u]) * BS + col0, xs[u]);
        }
      }
      load_cols(cols, s0 + U, slots, c);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u < slots) {
          A xa[P::kXw];  // this slot's x slice, widened once for all the lane's rows
#pragma unroll
          for (int e = 0; e < P::kXw; ++e) xa[e] = to_acc<A>(xs[u][e]);
#pragma unroll
          for (int k = 0; k < P::kVecs; ++k)
#pragma unroll
            for (int e = 0; e < P::kVec; ++e)
              acc[k][e / P::kXw] += to_acc<A>(v[u][k][e]) * xa[e % P::kXw];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < P::kVecs; ++k)
#pragma unroll
    for (int r = 0; r < P::kRowsPerVec; ++r) acc[k][r] = group_sum(acc[k][r], P::kGroups);
  if (i < nbr && col0 == 0) {
#pragma unroll
    for (int k = 0; k < P::kVecs; ++k)
#pragma unroll
      for (int r = 0; r < P::kRowsPerVec; ++r) y[i * BS + row0 + k * P::kRowStep + r] = acc[k][r];
  }
}

template <typename S, typename X, typename A, int BS>
int launch_bsr(const void* val, const void* bcol, const void* x, void* y, long long nbr, int slots,
               cudaStream_t stream) {
  const long long blocks = ceil_div(nbr * BsrShape<S, BS>::kLanes, kThreads);
  spmv_bsr_kernel<S, X, A, BS><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const S*>(val), static_cast<const int*>(bcol), static_cast<const X*>(x),
      static_cast<A*>(y), nbr, slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename X, typename A>
struct SpmvBsr {
  static int run(const void* val, const void* bcol, const void* x, void* y, long long nbr,
                 int slots, int bs, cudaStream_t stream) {
    if (nbr == 0) return 0;
    switch (bs) {
      case 4: return launch_bsr<S, X, A, 4>(val, bcol, x, y, nbr, slots, stream);
      case 8: return launch_bsr<S, X, A, 8>(val, bcol, x, y, nbr, slots, stream);
      case 16: return launch_bsr<S, X, A, 16>(val, bcol, x, y, nbr, slots, stream);
      default: return ERR_UNSUPPORTED_BLOCK;
    }
  }
};

}  // namespace

// xdt: x's dtype, the storage dtype sdt or the accum dtype adt (dispatch_gather).
extern "C" int repro_spmv_bsr(int sdt, int xdt, int adt, const void* val, const void* bcol,
                              const void* x, void* y, long long nbr, int slots, int bs,
                              void* stream) {
  return dispatch_gather<SpmvBsr>(sdt, xdt, adt, val, bcol, x, y, nbr, slots, bs,
                                  static_cast<cudaStream_t>(stream));
}

#define SPMV_BSR_KERNELS(K)                                    \
  K(spmv_bsr_kernel<float, float, float, 4>)                   \
  K(spmv_bsr_kernel<float, float, float, 8>)                   \
  K(spmv_bsr_kernel<float, float, float, 16>)                  \
  K(spmv_bsr_kernel<float, float, double, 4>)                  \
  K(spmv_bsr_kernel<float, float, double, 8>)                  \
  K(spmv_bsr_kernel<float, float, double, 16>)                 \
  K(spmv_bsr_kernel<double, double, double, 4>)                \
  K(spmv_bsr_kernel<double, double, double, 8>)                \
  K(spmv_bsr_kernel<double, double, double, 16>)               \
  K(spmv_bsr_kernel<__nv_bfloat16, __nv_bfloat16, float, 4>)   \
  K(spmv_bsr_kernel<__nv_bfloat16, __nv_bfloat16, float, 8>)   \
  K(spmv_bsr_kernel<__nv_bfloat16, __nv_bfloat16, float, 16>)  \
  K(spmv_bsr_kernel<__half, __half, float, 4>)                 \
  K(spmv_bsr_kernel<__half, __half, float, 8>)                 \
  K(spmv_bsr_kernel<__half, __half, float, 16>)                \
  K(spmv_bsr_kernel<float, double, double, 4>)                 \
  K(spmv_bsr_kernel<float, double, double, 8>)                 \
  K(spmv_bsr_kernel<float, double, double, 16>)                \
  K(spmv_bsr_kernel<__nv_bfloat16, float, float, 4>)           \
  K(spmv_bsr_kernel<__nv_bfloat16, float, float, 8>)           \
  K(spmv_bsr_kernel<__nv_bfloat16, float, float, 16>)          \
  K(spmv_bsr_kernel<__half, float, float, 4>)                  \
  K(spmv_bsr_kernel<__half, float, float, 8>)                  \
  K(spmv_bsr_kernel<__half, float, float, 16>)
REPRO_KERNEL_TABLE(repro_kernels_spmv_bsr, SPMV_BSR_KERNELS)
