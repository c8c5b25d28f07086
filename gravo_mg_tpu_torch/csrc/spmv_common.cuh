// Shared launch constants for the slot-layout SpMV kernels
// (shuffle_spmv.cu, diag_spmv.cu).  Both kernels run one thread per output
// row and accumulate up to kCols right-hand-side columns per thread; wider
// right-hand sides are split over gridDim.y.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gravomg {

constexpr int kThreads = 256;  // two 128-row groups per block
constexpr int kCols = 4;       // right-hand-side columns per thread

inline dim3 spmv_grid(int64_t nrows, int64_t d) {
  return dim3(static_cast<unsigned>((nrows + kThreads - 1) / kThreads),
              static_cast<unsigned>((d + kCols - 1) / kCols));
}

}  // namespace gravomg
