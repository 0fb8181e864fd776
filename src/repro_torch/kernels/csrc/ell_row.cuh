// One ELL row's dot product, computed by an aligned group of lanes.
//
// Row-major ELL (rows_pad, width): a group of `group` lanes (a power of two
// <= 32, about the padded width) takes one row; lane l sums slots l,
// l + group, ...  Neighbouring lanes read neighbouring slots, so a warp
// reads 32 consecutive values and column indices per step.  The x gather
// goes through L2 and the read-only path (the whole of x at 4.2M rows is
// 17 MB in f32, inside the 50 MB L2).
#pragma once

#include "common.cuh"

namespace {

// Partial sum of row r held by one lane (0 when r is past the last row).
template <typename S, typename A>
__device__ __forceinline__ A ell_row_partial(const S* __restrict__ val, const int* __restrict__ col,
                                             const S* __restrict__ x, long long r, long long rows,
                                             int width, int lane, int group) {
  A acc = A(0);
  if (r < rows) {
    const S* vr = val + r * width;
    const int* cr = col + r * width;
    for (int s = lane; s < width; s += group) acc += to_acc<A>(vr[s]) * to_acc<A>(x[cr[s]]);
  }
  return acc;
}

// Blocks of one ELL launch (kThreads lanes each, `group` lanes a row).
inline long long ell_blocks(long long rows, int group) {
  return ceil_div(rows * group, kThreads);
}

}  // namespace
