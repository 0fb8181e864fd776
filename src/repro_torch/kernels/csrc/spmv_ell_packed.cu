// spmv_ell_packed: the SpMV of one packed (compressed-staging) ELL chunk,
//   col[r, s] = base[r] + sum_{t <= s} dcol[r, t]
//   y[r]      = sum_s (val[r, s] * scale[r]) * x[col[r, s]]      (all in A)
// with val in bf16 or fp8 e4m3, scale f32, base int32, dcol int16 or int32.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell_packed.py:
// spmv_ell_packed_kernel_call.  There one grid step held a (block_r, width)
// tile and the whole of x in VMEM, and ran jnp.cumsum along the rows.
//
// Bound on the card: bytes.  A slot costs 1-2 value bytes and 2-4 delta
// bytes (8 for the f32 ELL of spmv_ell), a row 8 bytes of scale and base,
// plus the gather of x through L2.  The packing exists to shrink the
// host->device copy of each staged chunk; the kernel's part is to undo it
// in registers, so the card never holds the unpacked chunk.  A chunk is
// small (262K rows x 8, 17.8 MB, at chunk_nnz = 1 << 20): the time is one
// wave of loads, a gather and a store, so what counts is how many of them
// are in flight at once.
//
// Design: spmv_ell's vector design (ell_row.cuh) on the packed operands,
// with four paths picked by the wrapper from the width, the rows, the SM
// count and the alignment (kernels/spmv_ell_packed.py:packed_launch_plan)
// and checked here:
// - vector: a lane takes kSlots = 8 consecutive slots of one row as whole
//   vectors (__ldcs): 16 B of bf16 values or 8 B of fp8, 16 B of int16
//   deltas or 2 x 16 B of int32.  It scans its 8 deltas in registers, and
//   the lanes of a row (width / 8 of them, rounded up to a power of two;
//   one lane for a row of 8) combine their totals in an inclusive shuffle
//   scan that starts from base[r] in lane 0, which gives each lane its
//   first column.  Integer adds are exact: no order changes a bit.  Each
//   thread keeps kPackedRows rows in flight: all value, delta, scale and base
//   loads first (scale and base once a row, by lane 0), then the scans,
//   then all gathers of x (__ldg), then the arithmetic.  The grid is SMs x
//   occupancy, walked with a grid stride.
// - wide (more than 32 vectors a row, and no split): a warp walks the row
//   32 x 8 slots at a time, carrying the scan total from step to step.
// - split (more than 128 vectors a row, under 4 rows a SM: the hub chunks
//   of power-law graphs, the top chunks of a graph ordered by degree).
//   Bound by bytes, as the others: 3-6 B a slot of values and deltas, read
//   once (8 x 1,047,672 slots of bf16 + int32 are 50 MB, 15 us at 3.35
//   TB/s).  The wide path ran such a chunk as 8 warps of ~4,100 dependent
//   steps each, 0.5% of that bound.  Here the row is cut into segments of
//   32 lanes x seg_vecs vectors, a warp a segment (its own kernel,
//   spmv_ell_packed_split_kernel, so the other paths keep their
//   registers).  A block takes a tile of 8 consecutive segments by an
//   atomic ticket, in row order, so every tile a block waits on has
//   started (a ticket a segment put every warp of the card on one address:
//   about 4 ns each, serialized).  Each warp issues all its value and
//   delta vectors, scans its deltas in registers into columns from its
//   segment's start, and leaves its total in shared memory; warp 0 then
//   publishes the tile's status word (its total, or at once its inclusive
//   column where a row starts in the tile) and, for a tile that goes on
//   with a row, walks back over the earlier tiles' words (a decoupled
//   look-back, 32 tiles a step) to the nearest inclusive one: the column
//   before the tile.  Integer sums: exact in any order.  Then the gathers,
//   the arithmetic and the segment's partial in a (rows, segs) scratch
//   array; a second launch (common.cuh: reduce_partials_kernel, a block a
//   row) sums each row's partials in a fixed order.  One memset a launch
//   zeroes the ticket and the status words.  What the design does not
//   hide: a tile waits for the loads of every earlier tile of its row in
//   flight, so the look-back costs about a quarter of the hub chunk's time
//   (bench_torch/split_variants.py, PERF.md).
// Every lane sums its slots in slot order and the lanes of a row combine
// in one fixed order (an xor butterfly; the scalar path's shfl_down tree):
// the same bits on every run.  y is written with a streaming store.
//
// Each product is rounded in A before it is added (the build passes
// --fmad=false), in the plain version's order: (val * scale) * x.  Padding
// slots hold value 0 and delta 0 (after the one delta that returns the
// column to 0), so they add 0.
#include "ell_row.cuh"

namespace {

constexpr int kSlots = 8;       // slots a lane reads as vectors (kernels/spmv_ell_packed.py)
// Rows in flight per thread on the vector path: two rows are 16 gathers, as
// spmv_ell's four f32 rows are, in 80 registers (bf16 + int32, f32 -> f64);
// four rows took 156, one block an SM, and ran 15% slower (PERF.md).
constexpr int kPackedRows = 2;

// One lane's kSlots deltas as running columns from 0; returns their total.
template <typename I>
__device__ __forceinline__ int scan_slots(const I (&d)[kSlots], bool live, int (&cols)[kSlots]) {
  int run = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    run += live ? static_cast<int>(d[s]) : 0;
    cols[s] = run;
  }
  return run;
}

// Inclusive sum of `v` over the lanes of an aligned group of `lanes` lanes.
__device__ __forceinline__ int lane_scan(int v, int lane, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, off, lanes);
    if (lane >= off) v += up;
  }
  return v;
}

template <typename V, typename I, typename S, typename A>
__device__ __forceinline__ void packed_vector_rows(const V* __restrict__ val,
                                                   const float* __restrict__ scale,
                                                   const int* __restrict__ base,
                                                   const I* __restrict__ dcol,
                                                   const S* __restrict__ x, A* __restrict__ y,
                                                   long long rows, int width, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int sub = threadIdx.x / lanes;  // this group's row within a block step
  const int step = kThreads / lanes;    // rows per block step
  const long long tile_rows = static_cast<long long>(kPackedRows) * step;
  const bool has_vec = lane < width / kSlots;
  for (long long t0 = blockIdx.x * tile_rows; t0 < rows; t0 += gridDim.x * tile_rows) {
    const long long r0 = t0 + sub;
    V v[kPackedRows][kSlots];
    I d[kPackedRows][kSlots];
    float sc[kPackedRows];
    int start[kPackedRows];
    bool live[kPackedRows];
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j) {
      const long long r = r0 + static_cast<long long>(j) * step;
      live[j] = has_vec && r < rows;
      if (live[j]) {
        const long long off = r * width + static_cast<long long>(lane) * kSlots;
        load_stream(val + off, v[j]);
        load_stream(dcol + off, d[j]);
      }
      sc[j] = 0.0f;
      start[j] = 0;
      if (lane == 0 && r < rows) {
        sc[j] = __ldcs(scale + r);
        start[j] = __ldcs(base + r);
      }
    }
    int cols[kPackedRows][kSlots];
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j) {
      const int run = scan_slots(d[j], live[j], cols[j]);
      // base[r] enters through lane 0: each lane's first column is base plus
      // the deltas of the lanes before it.
      const int first = lane_scan(run + start[j], lane, lanes) - run;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) cols[j][s] += first;
      if (lanes > 1) sc[j] = __shfl_sync(0xffffffffu, sc[j], 0, lanes);
    }
    S xs[kPackedRows][kSlots];
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j)
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (live[j]) xs[j][s] = gather(x, cols[j][s]);
#pragma unroll
    for (int j = 0; j < kPackedRows; ++j) {
      A acc = A(0);
      if (live[j]) {
        const A a_sc = to_acc<A>(sc[j]);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) acc += (to_acc<A>(v[j][s]) * a_sc) * to_acc<A>(xs[j][s]);
      }
      acc = butterfly(acc, lanes);
      const long long r = r0 + static_cast<long long>(j) * step;
      if (lane == 0 && r < rows) __stcs(y + r, acc);
    }
  }
}

template <typename V, typename I, typename S, typename A>
__device__ __forceinline__ void packed_wide_rows(const V* __restrict__ val,
                                                 const float* __restrict__ scale,
                                                 const int* __restrict__ base,
                                                 const I* __restrict__ dcol,
                                                 const S* __restrict__ x, A* __restrict__ y,
                                                 long long rows, int width) {
  const int lane = threadIdx.x & 31;
  const int nvec = width / kSlots;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  for (long long r = first; r < rows; r += warps) {
    const V* vr = val + r * width;
    const I* dr = dcol + r * width;
    const A sc = to_acc<A>(__shfl_sync(0xffffffffu, lane == 0 ? __ldcs(scale + r) : 0.0f, 0));
    int carry = __shfl_sync(0xffffffffu, lane == 0 ? __ldcs(base + r) : 0, 0);
    A acc = A(0);
    for (int q0 = 0; q0 < nvec; q0 += 32) {  // the same steps in every lane
      const int q = q0 + lane;
      const bool in = q < nvec;
      V v[kSlots];
      I d[kSlots];
      if (in) {
        load_stream(vr + static_cast<long long>(q) * kSlots, v);
        load_stream(dr + static_cast<long long>(q) * kSlots, d);
      }
      int cols[kSlots];
      const int run = scan_slots(d, in, cols);
      const int incl = lane_scan(run, lane, 32);
      const int col0 = carry + incl - run;
      S xs[kSlots];
      if (in) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) xs[s] = gather(x, col0 + cols[s]);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) acc += (to_acc<A>(v[s]) * sc) * to_acc<A>(xs[s]);
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    acc = butterfly(acc, 32);
    if (lane == 0) __stcs(y + r, acc);
  }
}

template <typename V, typename I, typename S, typename A>
__device__ __forceinline__ void packed_scalar_rows(const V* __restrict__ val,
                                                   const float* __restrict__ scale,
                                                   const int* __restrict__ base,
                                                   const I* __restrict__ dcol,
                                                   const S* __restrict__ x, A* __restrict__ y,
                                                   long long rows, int width, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int step = kThreads / lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * step; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * step) {
    const long long r = r0 + threadIdx.x / lanes;
    const bool live = r < rows;
    const long long row = live ? r : 0;
    const V* vr = val + row * width;
    const I* dr = dcol + row * width;
    const A sc = live ? to_acc<A>(scale[row]) : A(0);
    int carry = live ? base[row] : 0;
    A acc = A(0);
    for (int s0 = 0; s0 < width; s0 += lanes) {  // the same tiles in every lane
      const int s = s0 + lane;
      const bool in = live && s < width;
      const int d = lane_scan(in ? static_cast<int>(dr[s]) : 0, lane, lanes);
      if (in) acc += (to_acc<A>(vr[s]) * sc) * to_acc<A>(gather(x, carry + d));
      carry += __shfl_sync(0xffffffffu, d, lanes - 1, lanes);
    }
    acc = group_sum(acc, lanes);
    if (lane == 0 && live) __stcs(y + r, acc);
  }
}

// A block takes a tile of kTileSegs consecutive segments (in row order, a
// warp each) by an atomic ticket.  A tile's status word: a flag in the high
// half, a 32-bit integer in the low half, written and read whole (so the
// value travels with its flag); zero: not yet published.  kAggregate: the
// sum of the deltas of the tile's segments (a tile inside one row, which
// started in an earlier tile); kInclusive: the column at the end of the
// tile, in the row it ends in.  A tile in which a row starts knows that
// column at once.
constexpr unsigned long long kAggregate = 1ULL << 32;
constexpr unsigned long long kInclusive = 2ULL << 32;
constexpr int kTileSegs = 8;  // kernels/spmv_ell_packed.py: SPLIT_TILE
static_assert(kTileSegs == kThreads / 32, "a tile is a block: a segment a warp");

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(p) = word;
}

__device__ __forceinline__ unsigned word_value(unsigned long long w) {
  return static_cast<unsigned>(w & 0xffffffffULL);
}

// The column at the end of tile `tile - 1`, in the row that tile ends in (a
// row that goes on into `tile`): the decoupled look-back over the tiles
// before it, lane l reading tile - 1 - l (32 tiles a step; a hub row of
// 1,047,672 slots is 128 tiles of 8 x 1,024), their aggregates summed back
// to the nearest inclusive word.  The tile where the row starts is
// inclusive, so the walk ends.  Integer sums, wrapping: only the total is
// a column, and it is exact in any order.  One whole warp calls it; every
// lane gets the column.  (Four words a lane, 128 tiles a step, ran slower
// on the hub chunk: bench_torch/wide_rows.py, PERF.md.)
__device__ __forceinline__ unsigned tile_prefix(const unsigned long long* status, long long tile,
                                                int lane) {
  unsigned excl = 0;
  long long j = tile - 1;  // the nearest tile not summed yet
  while (true) {
    const long long k = j - lane;
    unsigned long long w = kInclusive;  // before tile 0: never summed
    if (k >= 0) w = *reinterpret_cast<const volatile unsigned long long*>(status + k);
    const unsigned with_incl = __ballot_sync(0xffffffffu, (w & ~0xffffffffULL) == kInclusive);
    const int stop = with_incl ? __ffs(with_incl) - 1 : 31;  // the nearest inclusive lane
    const bool mine = lane <= stop;
    if (!__all_sync(0xffffffffu, !mine || w != 0ULL)) {
      __nanosleep(64);
      continue;  // a tile before has not published: read the window again
    }
    excl += __reduce_add_sync(0xffffffffu, mine ? word_value(w) : 0u);
    if (with_incl) return excl;
    j -= 32;
  }
}

// The split path.  Scratch: the first word is the ticket, word 1 + T the
// status of tile T (zeroed by the launch's memset); partials[r * segs + s]
// the partial sum of segment s of row r.
// Two blocks an SM (128 registers) but where x is f64, whose gathers would
// spill at that cap.
template <typename V, typename I, typename S, typename A>
__global__ void __launch_bounds__(kThreads, sizeof(S) == 8 ? 1 : 2)
    spmv_ell_packed_split_kernel(const V* __restrict__ val, const float* __restrict__ scale,
                                 const int* __restrict__ base, const I* __restrict__ dcol,
                                 const S* __restrict__ x, A* __restrict__ partials,
                                 unsigned long long* __restrict__ words, long long rows,
                                 int width, int seg_vecs) {
  __shared__ unsigned long long block_ticket;
  // Double-buffered by the tile's parity: a warp may write the next tile's
  // while another still reads this one's (no barrier between them).
  __shared__ int s_agg[2][kTileSegs];   // each segment's delta total
  __shared__ int s_base[2][kTileSegs];  // base[r] of a segment that starts row r
  __shared__ unsigned s_prefix[2];      // the column before the tile, in its first row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int nvec = width / kSlots;
  const int segs = static_cast<int>(split_segs(width, kSlots, seg_vecs));
  const long long units = rows * segs;
  unsigned long long* status = words + 1;
  if (threadIdx.x == 0) block_ticket = atomicAdd(words, 1ULL);
  __syncthreads();
  for (int par = 0;; par ^= 1) {
    const long long tile = static_cast<long long>(block_ticket);
    const long long t0 = tile * kTileSegs;
    if (t0 >= units) break;  // the same ticket in every thread
    // The tile's segments by row: one division a tile.  Its row starts fall
    // at first_start, first_start + segs, ... (none past `last`).
    const long long r0 = t0 / segs;
    const int seg0 = static_cast<int>(t0 - r0 * segs);
    const int last = static_cast<int>(units - 1 - t0 < kTileSegs - 1 ? units - 1 - t0
                                                                    : kTileSegs - 1);
    const int first_start = seg0 == 0 ? 0 : segs - seg0;
    const int last_start = first_start <= last ? first_start + (last - first_start) / segs * segs
                                               : -1;
    const long long t = t0 + warp;
    const bool has = warp <= last;
    const long long r = r0 + (seg0 + warp) / segs;
    const int seg = (seg0 + warp) % segs;
    const V* vr = val + r * width;
    const I* dr = dcol + r * width;
    const long long q0 = static_cast<long long>(seg) * 32 * seg_vecs + lane;
    V v[kSplitVecs][kSlots];
    I d[kSplitVecs][kSlots];
    bool live[kSplitVecs];
#pragma unroll
    for (int w = 0; w < kSplitVecs; ++w) {
      const long long q = q0 + 32 * w;
      live[w] = has && w < seg_vecs && q < nvec;
      if (live[w]) {
        load_stream(vr + q * kSlots, v[w]);
        load_stream(dr + q * kSlots, d[w]);
      }
    }
    const float sc_r = has && lane == 0 ? __ldcs(scale + r) : 0.0f;
    if (has && seg == 0 && lane == 0) s_base[par][warp] = __ldcs(base + r);
    // Columns from the segment's start: vector q of the segment sits after
    // the strips w' < w and the lanes before it in strip w.
    int cols[kSplitVecs][kSlots];
    int carry = 0;
#pragma unroll
    for (int w = 0; w < kSplitVecs; ++w) {
      const int run = scan_slots(d[w], live[w], cols[w]);
      const int incl = lane_scan(run, lane, 32);
      const int first_col = carry + incl - run;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) cols[w][s] += first_col;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_agg[par][warp] = carry;
    __syncthreads();
    // The next tile's ticket, taken while this one finishes (every thread
    // has read this one): its predecessor is this tile, published below.
    if (threadIdx.x == 0) block_ticket = atomicAdd(words, 1ULL);
    if (warp == 0) {
      unsigned end = last_start >= 0 ? static_cast<unsigned>(s_base[par][last_start]) : 0u;
      for (int i = last_start >= 0 ? last_start : 0; i <= last; ++i)
        end += static_cast<unsigned>(s_agg[par][i]);
      if (lane == 0) publish(status + tile, (last_start >= 0 ? kInclusive : kAggregate) | end);
      if (first_start > 0) {  // the tile's first segment goes on with a row from before
        const unsigned before = tile_prefix(status, tile, lane);
        if (lane == 0) {
          s_prefix[par] = before;
          if (last_start < 0) publish(status + tile, kInclusive | (before + end));
        }
      }
    }
    __syncthreads();
    if (has) {
      // This segment's first column: its row's base or the tile's prefix,
      // plus the totals of the tile's segments of that row before it.
      const int from = warp < first_start ? -1
                                          : first_start + (warp - first_start) / segs * segs;
      unsigned start = from >= 0 ? static_cast<unsigned>(s_base[par][from]) : s_prefix[par];
      for (int i = from >= 0 ? from : 0; i < warp; ++i)
        start += static_cast<unsigned>(s_agg[par][i]);
      const A sc = to_acc<A>(__shfl_sync(0xffffffffu, sc_r, 0));
      // The gathers in two halves of the strips (each half's all at once),
      // which keeps the kernel in 128 registers.
      A acc = A(0);
#pragma unroll
      for (int h = 0; h < kSplitVecs; h += kSplitVecs / 2) {
        S xs[kSplitVecs / 2][kSlots];
#pragma unroll
        for (int w = 0; w < kSplitVecs / 2; ++w)
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            if (live[h + w]) xs[w][s] = gather(x, static_cast<int>(start) + cols[h + w][s]);
#pragma unroll
        for (int w = 0; w < kSplitVecs / 2; ++w)
          if (live[h + w])
#pragma unroll
            for (int s = 0; s < kSlots; ++s)
              acc += (to_acc<A>(v[h + w][s]) * sc) * to_acc<A>(xs[w][s]);
      }
      acc = butterfly(acc, 32);
      if (lane == 0) partials[t] = acc;
    }
  }
}

template <typename V, typename I, typename S, typename A>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_packed_kernel(const V* __restrict__ val, const float* __restrict__ scale,
                           const int* __restrict__ base, const I* __restrict__ dcol,
                           const S* __restrict__ x, A* __restrict__ y, long long rows, int width,
                           int lanes, int path) {
  if (path == kVector)
    packed_vector_rows<V, I, S, A>(val, scale, base, dcol, x, y, rows, width, lanes);
  else if (path == kWide)
    packed_wide_rows<V, I, S, A>(val, scale, base, dcol, x, y, rows, width);
  else
    packed_scalar_rows<V, I, S, A>(val, scale, base, dcol, x, y, rows, width, lanes);
}

template <typename V, typename I, typename S, typename A>
struct SpmvEllPacked {
  static int run(const void* val, const void* scale, const void* base, const void* dcol,
                 const void* x, void* y, void* partials, void* words, long long rows, int width,
                 int lanes, int path, int seg_vecs, int sms, cudaStream_t stream) {
    if (rows == 0) return 0;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(dcol);
    if (!ell_plan_ok(width, kSlots, bases, lanes, path, sms, seg_vecs))
      return static_cast<int>(cudaErrorInvalidValue);
    if (path == kSplit) {
      const long long segs = split_segs(width, kSlots, seg_vecs);
      // the ticket and the tiles' status words
      const long long tiles = ceil_div(rows * segs, kTileSegs);
      int err = static_cast<int>(
          cudaMemsetAsync(words, 0, (1 + tiles) * sizeof(unsigned long long), stream));
      if (err) return err;
      static const int split_per_sm = blocks_per_sm(spmv_ell_packed_split_kernel<V, I, S, A>);
      const long long blocks = ell_grid(rows * segs, lanes, path, sms, split_per_sm);
      spmv_ell_packed_split_kernel<V, I, S, A>
          <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
              static_cast<const V*>(val), static_cast<const float*>(scale),
              static_cast<const int*>(base), static_cast<const I*>(dcol),
              static_cast<const S*>(x), static_cast<A*>(partials),
              static_cast<unsigned long long*>(words), rows, width, seg_vecs);
      err = static_cast<int>(cudaGetLastError());
      if (err) return err;
      // each row's partials, in a fixed order, into y: a block a row
      return launch_reduce_partials<A>(static_cast<const A*>(partials), segs, static_cast<A*>(y),
                                       stream, static_cast<int>(rows));
    }
    static const int per_sm = blocks_per_sm(spmv_ell_packed_kernel<V, I, S, A>);
    const long long blocks = ell_grid(rows, lanes, path, sms, per_sm, kPackedRows);
    spmv_ell_packed_kernel<V, I, S, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const V*>(val), static_cast<const float*>(scale),
        static_cast<const int*>(base), static_cast<const I*>(dcol), static_cast<const S*>(x),
        static_cast<A*>(y), rows, width, lanes, path);
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

// partials (rows x segs in the accum dtype) and words (1 + the tiles of 8
// segments, unsigned long longs) are the split path's scratch, from the
// wrapper; unused (may be null) on the other paths.
extern "C" int repro_spmv_ell_packed(int vdt, int idt, int sdt, int adt, const void* val,
                                     const void* scale, const void* base, const void* dcol,
                                     const void* x, void* y, void* partials, void* words,
                                     long long rows, int width, int lanes, int path,
                                     int seg_vecs, int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vdt == DT_BF16 && idt == DT_I16)
    return dispatch_pair<PackedBf16I16>(sdt, adt, val, scale, base, dcol, x, y, partials, words,
                                        rows, width, lanes, path, seg_vecs, sms, s);
  if (vdt == DT_BF16 && idt == DT_I32)
    return dispatch_pair<PackedBf16I32>(sdt, adt, val, scale, base, dcol, x, y, partials, words,
                                        rows, width, lanes, path, seg_vecs, sms, s);
  if (vdt == DT_FP8_E4M3 && idt == DT_I16)
    return dispatch_pair<PackedFp8I16>(sdt, adt, val, scale, base, dcol, x, y, partials, words,
                                       rows, width, lanes, path, seg_vecs, sms, s);
  if (vdt == DT_FP8_E4M3 && idt == DT_I32)
    return dispatch_pair<PackedFp8I32>(sdt, adt, val, scale, base, dcol, x, y, partials, words,
                                       rows, width, lanes, path, seg_vecs, sms, s);
  return ERR_UNSUPPORTED_DTYPES;
}

#define SPMV_ELL_PACKED_KERNELS(X)                                             \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, float, float>)                \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, float, double>)               \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, double, double>)              \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, __nv_bfloat16, float>)        \
  X(spmv_ell_packed_kernel<__nv_bfloat16, short, __half, float>)               \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, float, float>)                  \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, float, double>)                 \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, double, double>)                \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, __nv_bfloat16, float>)          \
  X(spmv_ell_packed_kernel<__nv_bfloat16, int, __half, float>)                 \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, float, float>)                \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, float, double>)               \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, double, double>)              \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, __nv_bfloat16, float>)        \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, short, __half, float>)               \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, float, float>)                  \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, float, double>)                 \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, double, double>)                \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, __nv_bfloat16, float>)          \
  X(spmv_ell_packed_kernel<__nv_fp8_e4m3, int, __half, float>)                 \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, short, float, float>)          \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, short, float, double>)         \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, short, double, double>)        \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, short, __nv_bfloat16, float>)  \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, short, __half, float>)         \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, int, float, float>)            \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, int, float, double>)           \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, int, double, double>)          \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, int, __nv_bfloat16, float>)    \
  X(spmv_ell_packed_split_kernel<__nv_bfloat16, int, __half, float>)           \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, short, float, float>)          \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, short, float, double>)         \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, short, double, double>)        \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, short, __nv_bfloat16, float>)  \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, short, __half, float>)         \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, int, float, float>)            \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, int, float, double>)           \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, int, double, double>)          \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, int, __nv_bfloat16, float>)    \
  X(spmv_ell_packed_split_kernel<__nv_fp8_e4m3, int, __half, float>)
REPRO_KERNEL_TABLE(repro_kernels_spmv_ell_packed, SPMV_ELL_PACKED_KERNELS)
