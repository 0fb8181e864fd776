// spmv_ell_packed: the SpMV of one packed (compressed-staging) ELL chunk,
//   col[r, s] = base[r] + sum_{t <= s} dcol[r, t]
//   y[r]      = sum_s (val[r, s] * scale[r]) * x[col[r, s]]      (all in A)
// with val in bf16 or fp8 e4m3, scale f32, base int32, dcol int16 or int32.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell_packed.py:
// spmv_ell_packed_kernel_call.  There one grid step held a (block_r, width)
// tile and the whole of x in VMEM, and ran jnp.cumsum along the rows.  Here
// an aligned group of `group` lanes takes one row, as in spmv_ell, and walks
// it in tiles of `group` consecutive slots: lane l reads slot t * group + l
// (neighbouring lanes, neighbouring bytes), an inclusive shuffle scan of the
// tile's deltas across the group (fixed order) plus the carry of the tiles
// before gives each slot its absolute column, and the group's last lane
// hands the tile total on as the next carry.  A width-8 row is one tile of
// three shuffle steps; the one-row hub chunk of a power-law graph (width =
// the hub's nnz) is width / 32 tiles of one warp, never a serial scan.  All
// lanes run the same number of tiles (the width is uniform), so the
// full-mask shuffles are safe for the padding rows past the last one too.
//
// Bound on the card: bytes.  A slot costs 1-2 value bytes and 2-4 delta
// bytes (8 for the f32 ELL of spmv_ell), a row 8 bytes of scale and base,
// plus the gather of x through L2.  The packing exists to shrink the
// host->device copy of each staged chunk; the kernel's part is to undo it
// in registers, so the card never holds the unpacked chunk.
//
// Each product is rounded in A before it is added (the build passes
// --fmad=false), in the plain version's order: (val * scale) * x.  Padding
// slots hold value 0 and delta 0 (after the one delta that returns the
// column to 0), so they add 0.
#include "ell_row.cuh"

namespace {

template <typename V, typename I, typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_packed_kernel(const V* __restrict__ val, const float* __restrict__ scale,
                           const int* __restrict__ base, const I* __restrict__ dcol,
                           const S* __restrict__ x, A* __restrict__ y, long long rows, int width,
                           int group) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long r = t / group;
  const int lane = threadIdx.x & (group - 1);
  const bool live = r < rows;
  const long long row = live ? r : 0;
  const V* vr = val + row * width;
  const I* dr = dcol + row * width;
  const A sc = live ? to_acc<A>(scale[row]) : A(0);
  int carry = live ? base[row] : 0;
  A acc = A(0);
  for (int s0 = 0; s0 < width; s0 += group) {
    const int s = s0 + lane;
    const bool in = live && s < width;
    int d = in ? static_cast<int>(dr[s]) : 0;
    for (int off = 1; off < group; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, d, off, group);
      if (lane >= off) d += up;
    }
    if (in) acc += (to_acc<A>(vr[s]) * sc) * to_acc<A>(x[carry + d]);
    carry += __shfl_sync(0xffffffffu, d, group - 1, group);
  }
  acc = group_sum(acc, group);
  if (lane == 0 && live) y[r] = acc;
}

template <typename V, typename I, typename S, typename A>
struct SpmvEllPacked {
  static int run(const void* val, const void* scale, const void* base, const void* dcol,
                 const void* x, void* y, long long rows, int width, int group,
                 cudaStream_t stream) {
    if (rows == 0) return 0;
    spmv_ell_packed_kernel<V, I, S, A>
        <<<static_cast<unsigned>(ell_blocks(rows, group)), kThreads, 0, stream>>>(
            static_cast<const V*>(val), static_cast<const float*>(scale),
            static_cast<const int*>(base), static_cast<const I*>(dcol), static_cast<const S*>(x),
            static_cast<A*>(y), rows, width, group);
    return static_cast<int>(cudaGetLastError());
  }
};

// (value, delta) dtypes as alias templates over the (x storage, accum) pair,
// so dispatch_pair instantiates the pairs the policies use for each.
template <typename S, typename A>
using PackedBf16I16 = SpmvEllPacked<__nv_bfloat16, short, S, A>;
template <typename S, typename A>
using PackedBf16I32 = SpmvEllPacked<__nv_bfloat16, int, S, A>;
template <typename S, typename A>
using PackedFp8I16 = SpmvEllPacked<__nv_fp8_e4m3, short, S, A>;
template <typename S, typename A>
using PackedFp8I32 = SpmvEllPacked<__nv_fp8_e4m3, int, S, A>;

}  // namespace

extern "C" int repro_spmv_ell_packed(int vdt, int idt, int sdt, int adt, const void* val,
                                     const void* scale, const void* base, const void* dcol,
                                     const void* x, void* y, long long rows, int width, int group,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vdt == DT_BF16 && idt == DT_I16)
    return dispatch_pair<PackedBf16I16>(sdt, adt, val, scale, base, dcol, x, y, rows, width, group, s);
  if (vdt == DT_BF16 && idt == DT_I32)
    return dispatch_pair<PackedBf16I32>(sdt, adt, val, scale, base, dcol, x, y, rows, width, group, s);
  if (vdt == DT_FP8_E4M3 && idt == DT_I16)
    return dispatch_pair<PackedFp8I16>(sdt, adt, val, scale, base, dcol, x, y, rows, width, group, s);
  if (vdt == DT_FP8_E4M3 && idt == DT_I32)
    return dispatch_pair<PackedFp8I32>(sdt, adt, val, scale, base, dcol, x, y, rows, width, group, s);
  return ERR_UNSUPPORTED_DTYPES;
}
