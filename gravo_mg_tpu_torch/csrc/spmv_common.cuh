// Shared launch constants for the SpMV kernels (shuffle_spmv.cu,
// diag_spmv.cu, sliced_spmv.cu with its halo_spmv kernel,
// sliced_diag_spmv.cu): blocks of kThreads threads, each thread
// accumulating up to kCols right-hand-side columns; wider right-hand sides
// are split over gridDim.y.  shuffle_spmv, diag_spmv and sliced_diag_spmv
// run one thread per output row; sliced_spmv and halo_spmv one or more
// (their TPR).
//
// The epilogues of sliced_spmv, sliced_diag_spmv and halo_spmv: what the
// row's owning thread does with its sum s = (A x)[row, j] before it stores
// (in halo_spmv, s = y[row, j] + the halo sum, the interior's raw sum plus
// the halo part's, one rounded add), so that one launch computes a whole
// operation of the multigrid cycle (the part the JAX program hands to XLA's
// fusion around the Pallas call):
//
//   kPlain     y = s
//   kResidual  y = b - s                     (the residual b - A x)
//   kAdd       y = b + s                     (x + U e; b holds x)
//   kCheb      r = b - s;  d = c1 d + (c2 dinv) r  (first step: d = (c2 dinv) r);
//              y = x + d, and d stored where it is kept
//
// A masked launch (the interior part of a row-partitioned operator,
// parallel/halo.py) takes a row mask, one uint32 per 32-row slice, bit r of
// word s set when row 32 s + r also has a halo part: such a row stores its
// raw sum s (and leaves d unread and unwritten), and the halo_spmv launch
// after it adds the halo sum and applies the epilogue there.  Every other
// row applies the epilogue as an unmasked launch does.
//
// Each operation is rounded as the port's torch expression rounds it
// (solver/smoothers.py, solver/multigrid.py): one IEEE-rounded add,
// subtract or multiply per torch kernel, in that kernel order, never a
// contracted FMA, so that a fused launch equals the plain SpMV followed by
// the torch ops bit for bit.  c1 and c2 arrive as T, rounded from the
// host's doubles as torch rounds a Python scalar for a tensor of type T.
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

enum class Mode : int { kPlain = 0, kResidual = 1, kAdd = 2, kCheb = 3 };

// The epilogue's operands; y and these are (nrows, d) row-major, dinv
// (nrows,).  Unused fields are null.
template <typename T>
struct Epilogue {
  const T* b;     // kResidual, kCheb: the right-hand side; kAdd: the addend
  const T* dinv;  // kCheb: the inverse diagonal
  const T* x;     // kCheb: the iterate (the SpMV's own input; halo_spmv's
                  // input is the halo buffer)
  T* d;           // kCheb: the step, read unless `first`, written unless null
  T c1, c2;       // kCheb
  int first;      // kCheb: no c1 d term (and d is not read)
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Output element i = row * d + j from the row's sum s.
template <Mode M, typename T>
__device__ __forceinline__ T epilogue(const Epilogue<T>& ep, int64_t i,
                                      int64_t row, T s) {
  if constexpr (M == Mode::kPlain) {
    return s;
  } else if constexpr (M == Mode::kResidual) {
    return sub_rn(ep.b[i], s);
  } else if constexpr (M == Mode::kAdd) {
    return add_rn(ep.b[i], s);
  } else {
    const T r = sub_rn(ep.b[i], s);
    T step = mul_rn(mul_rn(ep.c2, ep.dinv[row]), r);
    if (!ep.first) step = add_rn(mul_rn(ep.c1, ep.d[i]), step);
    if (ep.d != nullptr) ep.d[i] = step;
    return add_rn(ep.x[i], step);
  }
}

// Row `row`'s columns j0 .. j0 + nj - 1 of y, through the epilogue.
template <Mode M, typename T, int NC>
__device__ __forceinline__ void store_row(T* __restrict__ y,
                                          const Epilogue<T>& ep, int64_t row,
                                          int64_t d, int64_t j0, int64_t nj,
                                          const T (&acc)[NC]) {
  const int64_t i0 = row * d + j0;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (j < nj) y[i0 + j] = epilogue<M>(ep, i0 + j, row, acc[j]);
}

// store_row for the interior launch: with kMasked, a row whose bit is set
// in mask (one word per 32-row slice) stores its raw sum, the rest go
// through the epilogue.  Without kMasked this is store_row<M>.
template <Mode M, typename T, int NC, bool kMasked>
__device__ __forceinline__ void store_interior_row(
    T* __restrict__ y, const Epilogue<T>& ep, const uint32_t* __restrict__ mask,
    int64_t row, int64_t d, int64_t j0, int64_t nj, const T (&acc)[NC]) {
  if constexpr (kMasked) {
    if ((__ldg(mask + (row >> 5)) >> (row & 31)) & 1u) {
      store_row<Mode::kPlain, T, NC>(y, ep, row, d, j0, nj, acc);
      return;
    }
  }
  store_row<M, T, NC>(y, ep, row, d, j0, nj, acc);
}

// The operands of the kResidual / kAdd epilogues (b or the addend) and of
// kCheb, from the C entries' untyped pointers.
template <typename T>
inline Epilogue<T> vector_epilogue(const void* b) {
  return {static_cast<const T*>(b), nullptr, nullptr, nullptr, T(0), T(0), 1};
}

template <typename T>
inline Epilogue<T> cheb_epilogue(const void* b, const void* dinv, const void* x,
                                 void* dstep, int64_t first, double c1, double c2) {
  return {static_cast<const T*>(b), static_cast<const T*>(dinv),
          static_cast<const T*>(x), static_cast<T*>(dstep), static_cast<T>(c1),
          static_cast<T>(c2), static_cast<int>(first)};
}

}  // namespace gravomg
