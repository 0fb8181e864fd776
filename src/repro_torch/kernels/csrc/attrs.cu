// The resource report of the library: for every kernel instantiation of
// the six sources, what cudaFuncGetAttributes reads (registers, static
// shared memory, local memory, the most threads a block may have) and how
// many blocks of kThreads one SM holds at once.  Read on the card by
// repro_torch/analysis/kernel_check.py (rule K003).
//
// Each source exports its table (REPRO_KERNEL_TABLE in common.cuh); this
// file walks them in order.
#include "common.cuh"

#define REPRO_TABLES(X)                                                                  \
  X(repro_kernels_spmv_ell) X(repro_kernels_lanczos_update) X(repro_kernels_spmv_ell_alpha) \
  X(repro_kernels_spmv_bsr) X(repro_kernels_spmv_ell_packed) X(repro_kernels_mixed_dot)

#define REPRO_DECLARE_TABLE(fn) extern "C" int fn(const char* const** names, const void* const** fns);
REPRO_TABLES(REPRO_DECLARE_TABLE)

namespace {

using TableFn = int (*)(const char* const**, const void* const**);
#define REPRO_TABLE_ENTRY(fn) fn,
const TableFn kTables[] = {REPRO_TABLES(REPRO_TABLE_ENTRY)};

}  // namespace

// How many kernel instantiations the library holds.
extern "C" int repro_kernel_count() {
  int total = 0;
  for (TableFn table : kTables) {
    const char* const* names;
    const void* const* fns;
    total += table(&names, &fns);
  }
  return total;
}

// Instantiation i: its name, and out[0..5] = registers a thread, static
// shared bytes, local bytes a thread, max threads a block, blocks of
// kThreads an SM holds, constant bytes.  Returns a cudaError_t as int.
extern "C" int repro_kernel_attrs(int i, const char** name, long long* out) {
  for (TableFn table : kTables) {
    const char* const* names;
    const void* const* fns;
    const int n = table(&names, &fns);
    if (i >= n) {
      i -= n;
      continue;
    }
    *name = names[i];
    cudaFuncAttributes attr;
    int err = static_cast<int>(cudaFuncGetAttributes(&attr, fns[i]));
    if (err) return err;
    int blocks = 0;
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i], kThreads, 0));
    if (err) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<long long>(attr.sharedSizeBytes);
    out[2] = static_cast<long long>(attr.localSizeBytes);
    out[3] = attr.maxThreadsPerBlock;
    out[4] = blocks;
    out[5] = static_cast<long long>(attr.constSizeBytes);
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
