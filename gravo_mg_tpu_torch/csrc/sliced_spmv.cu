// SlicedEll SpMV for Hopper (sm_90a):
//
//   y[32 s + lane, j] = sum_{k < w_s} val[e] * x[col[e], j],
//   e = slice_ptr[s] + 32 k + lane,  w_s = (slice_ptr[s+1] - slice_ptr[s]) / 32
//
// Computes the function of the TPU kernel
// gravo_mg_tpu/ops/shuffle_spmv.py::lane_shuffle_fma together with the XLA
// row gather that feeds it (gravo_mg_tpu/sparse.py shuffle_spmv_1d), on a
// layout made for this card.  The TPU layout pads every 128-row group to
// one 128-aligned x block per slot, because a TPU core gathers only by
// lane shuffles within a block; a Hopper thread loads any address, so that
// padding (17x the nonzeros for the finest restriction of the 1M case) buys
// nothing here.  The sliced layout pads each 32-row slice only to its own
// longest row (1.0-1.6x the nonzeros on the solver's operators).
//
// halo_spmv_kernel is the same loop over the halo part of a row-partitioned
// operator (parallel/halo.py), which holds only the rows that have an entry
// outside their partition: its row i is output row out_row[i], and the sum
// is added to the y that the interior part's launch wrote before it on the
// same stream,
//
//   y[out_row[i], j] = epilogue(y[out_row[i], j] + sum_k val[e] * halo[col[e], j]),
//
// so interior launch + halo launch compute the JAX package's _dist_spmv
// (gravo_mg_tpu/parallel/halo.py: lane_shuffle_fma over its interior and
// halo parts, then their sum) in the same order: interior sum first, halo
// sum added to it.  With an epilogue (residual, add, Chebyshev step) the
// interior launch is masked: it applies the epilogue on the rows without a
// halo part and stores the raw sum on the boundary rows, and the halo
// launch finishes those with the same epilogue, indexed by the output row
// (b, dinv, x and d are read at out_row[i]).  That is the add and the torch
// ops the JAX program leaves to XLA's fusion around its two Pallas calls,
// in their order, so the bits are the plain composition's.  out_row is
// unique, so each output row has one writer and no atomics are needed.
// The TPU layout padded the halo part to KPH slots
// over every row group of a partition (16.25M slot lanes for 12043 entries
// on the 1M case's finest restriction); the compact part stores a slice per
// 32 boundary rows.
//
// What bounds it: the stream of (col int32, val T) per stored entry,
// nnz * (4 + sizeof(T)) bytes plus x and y once.  x is at most a few MB at
// the sizes the solver runs (4 MB at 1M rows in f32), so the gathers from x
// hit the H100's 50 MB L2 and no shared-memory staging is needed.  A halo
// part is a few thousand rows: one or two waves of warps, bound by the
// latency of a launch and a few dependent loads, not by bytes.
//
// Design.  A warp owns whole slices, so each slot's column and value loads
// are contiguous across the warp's lanes:
//  * TPR == 1 (thread per row; operators with many rows): a warp is one
//    slice, lane = row, and each slot is one 128-byte coalesced load of
//    columns and one of values;
//  * TPR in {2..32} (operators with few, long rows: the coarse levels and
//    their restrictions, where one thread per row leaves most of the card
//    idle and serialises 40-240 dependent loads): a warp covers 32/TPR rows
//    times TPR slots, lane = sub * (32/TPR) + row, thread `sub` sums slots
//    sub, sub + TPR, ..., and a __shfl_xor_sync butterfly over the lanes of
//    a row finishes the sum.
// The summation order is fixed for a given TPR.  Up to kCols right-hand-side
// columns per thread, wider right-hand sides over gridDim.y.  Offsets are
// 64-bit.  The row owner (sub == 0) applies the launch's epilogue
// (spmv_common.cuh: plain, residual, add or the Chebyshev step) to the
// finished sum before it stores: sliced_spmv_kernel to its sum (in a masked
// launch only on the rows whose mask bit is clear), halo_spmv_kernel to
// y[out_row] plus its sum.

#include "spmv_common.cuh"

namespace gravomg {

constexpr int kSlice = 32;

// The rows of one slice: y[row] = epilogue(sum) (kScatter false; with
// kMasked the raw sum on the rows whose mask bit is set), or
// y[out_row[row]] = epilogue(y[out_row[row]] + sum) (kScatter true).
template <Mode M, typename T, int TPR, bool kScatter, bool kMasked>
__device__ __forceinline__ void sliced_rows(
    const int64_t* __restrict__ slice_ptr, const int32_t* __restrict__ col,
    const T* __restrict__ val, const int32_t* __restrict__ out_row,
    const uint32_t* __restrict__ mask, const T* __restrict__ x,
    T* __restrict__ y, const Epilogue<T>& ep, int64_t nrows, int64_t d) {
  constexpr int kRows = kSlice / TPR;   // rows per warp
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kSlice;
  const int lane = threadIdx.x % kSlice;
  const int64_t s = warp / TPR;          // warp-uniform: whole warps leave
  if (s * kSlice >= nrows) return;
  const int rr = static_cast<int>(warp % TPR) * kRows + lane % kRows;
  const int sub = lane / kRows;
  const int64_t row = s * kSlice + rr;
  const int64_t lo = slice_ptr[s];
  const int64_t w = (slice_ptr[s + 1] - lo) / kSlice;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int64_t nj = d - j0 < kCols ? d - j0 : kCols;
  const int32_t* c = col + lo + rr;
  const T* v = val + lo + rr;
  T acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = T(0);
#pragma unroll 4
  for (int64_t k = sub; k < w; k += TPR) {
    const int64_t e = k * kSlice;
    const T a = v[e];
    const T* xc = x + static_cast<int64_t>(c[e]) * d + j0;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < nj) acc[j] += a * __ldg(xc + j);
  }
  if constexpr (TPR > 1) {
#pragma unroll
    for (int off = kSlice / 2; off >= kRows; off /= 2) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
  }
  if (sub == 0 && row < nrows) {
    if constexpr (kScatter) {
      const int64_t o = out_row[row];
      const int64_t i0 = o * d + j0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nj) y[i0 + j] = epilogue<M>(ep, i0 + j, o, add_rn(y[i0 + j], acc[j]));
    } else {
      store_interior_row<M, T, kCols, kMasked>(y, ep, mask, row, d, j0, nj, acc);
    }
  }
}

template <Mode M, typename T, int TPR, bool kMasked>
__global__ void __launch_bounds__(kThreads)
sliced_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                   const int32_t* __restrict__ col, const T* __restrict__ val,
                   const uint32_t* __restrict__ mask, const T* __restrict__ x,
                   T* __restrict__ y, const Epilogue<T> ep, int64_t nrows,
                   int64_t d) {
  sliced_rows<M, T, TPR, false, kMasked>(slice_ptr, col, val, nullptr, mask, x, y,
                                         ep, nrows, d);
}

template <Mode M, typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
halo_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                 const int32_t* __restrict__ col, const T* __restrict__ val,
                 const int32_t* __restrict__ out_row,
                 const T* __restrict__ halo, T* __restrict__ y,
                 const Epilogue<T> ep, int64_t nrows, int64_t d) {
  sliced_rows<M, T, TPR, true, false>(slice_ptr, col, val, out_row, nullptr, halo,
                                      y, ep, nrows, d);
}

// out_row given: halo_spmv_kernel; else sliced_spmv_kernel, masked where a
// mask is given (never in plain mode, where a masked row stores what every
// row does).
template <Mode M, typename T, int TPR>
void launch_tpr(const int64_t* slice_ptr, const int32_t* col, const T* val,
                const int32_t* out_row, const uint32_t* mask, const T* x, T* y,
                const Epilogue<T>& ep, int64_t nrows, int64_t d,
                cudaStream_t stream) {
  const int64_t slices = (nrows + kSlice - 1) / kSlice;
  const int64_t threads = slices * TPR * kSlice;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((d + kCols - 1) / kCols));
  if (out_row != nullptr) {
    halo_spmv_kernel<M, T, TPR><<<grid, kThreads, 0, stream>>>(
        slice_ptr, col, val, out_row, x, y, ep, nrows, d);
    return;
  }
  if constexpr (M != Mode::kPlain) {
    if (mask != nullptr) {
      sliced_spmv_kernel<M, T, TPR, true><<<grid, kThreads, 0, stream>>>(
          slice_ptr, col, val, mask, x, y, ep, nrows, d);
      return;
    }
  }
  sliced_spmv_kernel<M, T, TPR, false><<<grid, kThreads, 0, stream>>>(
      slice_ptr, col, val, nullptr, x, y, ep, nrows, d);
}

template <Mode M, typename T>
int launch(const void* slice_ptr, const void* col, const void* val,
           const void* out_row, const void* mask, const void* x, void* y,
           const Epilogue<T>& ep, int64_t nrows, int64_t d, int64_t tpr,
           void* stream) {
  if (nrows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int64_t*>(slice_ptr);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* v = static_cast<const T*>(val);
  const auto* o = static_cast<const int32_t*>(out_row);
  const auto* m = static_cast<const uint32_t*>(mask);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (tpr) {
    case 1: launch_tpr<M, T, 1>(p, c, v, o, m, xx, yy, ep, nrows, d, st); break;
    case 2: launch_tpr<M, T, 2>(p, c, v, o, m, xx, yy, ep, nrows, d, st); break;
    case 4: launch_tpr<M, T, 4>(p, c, v, o, m, xx, yy, ep, nrows, d, st); break;
    case 8: launch_tpr<M, T, 8>(p, c, v, o, m, xx, yy, ep, nrows, d, st); break;
    case 16: launch_tpr<M, T, 16>(p, c, v, o, m, xx, yy, ep, nrows, d, st); break;
    case 32: launch_tpr<M, T, 32>(p, c, v, o, m, xx, yy, ep, nrows, d, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gravomg

// One entry per (kernel, epilogue, dtype): the layout's arguments (and
// halo_spmv's out_row), the SpMV's input (halo_spmv: the halo buffer) and
// the output (x_out for the Chebyshev step; halo_spmv: y, updated at
// out_row), the epilogue's vectors (halo_spmv's Chebyshev step: the
// iterate x first), and for sliced_spmv's epilogues the row mask (null:
// unmasked).

#define GRAVOMG_SLICED(T, MODE, EP, X, Y, MASK)                               \
  gravomg::launch<gravomg::Mode::MODE, T>(slice_ptr, col, val, nullptr, MASK, \
                                          X, Y, EP, nrows, d, tpr, stream)
#define GRAVOMG_HALO(T, MODE, EP)                                             \
  gravomg::launch<gravomg::Mode::MODE, T>(slice_ptr, col, val, out_row,       \
                                          nullptr, halo, y, EP, nrows, d, tpr, \
                                          stream)

extern "C" {

int gravomg_sliced_spmv_f32(const void* slice_ptr, const void* col,
                            const void* val, const void* x, void* y,
                            int64_t nrows, int64_t d, int64_t tpr,
                            void* stream) {
  return GRAVOMG_SLICED(float, kPlain, gravomg::vector_epilogue<float>(nullptr),
                        x, y, nullptr);
}

int gravomg_sliced_spmv_f64(const void* slice_ptr, const void* col,
                            const void* val, const void* x, void* y,
                            int64_t nrows, int64_t d, int64_t tpr,
                            void* stream) {
  return GRAVOMG_SLICED(double, kPlain, gravomg::vector_epilogue<double>(nullptr),
                        x, y, nullptr);
}

int gravomg_sliced_spmv_residual_f32(const void* slice_ptr, const void* col,
                                     const void* val, const void* x, void* y,
                                     const void* b, const void* mask,
                                     int64_t nrows, int64_t d, int64_t tpr,
                                     void* stream) {
  return GRAVOMG_SLICED(float, kResidual, gravomg::vector_epilogue<float>(b), x,
                        y, mask);
}

int gravomg_sliced_spmv_residual_f64(const void* slice_ptr, const void* col,
                                     const void* val, const void* x, void* y,
                                     const void* b, const void* mask,
                                     int64_t nrows, int64_t d, int64_t tpr,
                                     void* stream) {
  return GRAVOMG_SLICED(double, kResidual, gravomg::vector_epilogue<double>(b), x,
                        y, mask);
}

int gravomg_sliced_spmv_add_f32(const void* slice_ptr, const void* col,
                                const void* val, const void* x, void* y,
                                const void* z, const void* mask, int64_t nrows,
                                int64_t d, int64_t tpr, void* stream) {
  return GRAVOMG_SLICED(float, kAdd, gravomg::vector_epilogue<float>(z), x, y,
                        mask);
}

int gravomg_sliced_spmv_add_f64(const void* slice_ptr, const void* col,
                                const void* val, const void* x, void* y,
                                const void* z, const void* mask, int64_t nrows,
                                int64_t d, int64_t tpr, void* stream) {
  return GRAVOMG_SLICED(double, kAdd, gravomg::vector_epilogue<double>(z), x, y,
                        mask);
}

int gravomg_sliced_spmv_cheb_f32(const void* slice_ptr, const void* col,
                                 const void* val, const void* x, void* x_out,
                                 const void* b, const void* dinv, void* dstep,
                                 const void* mask, int64_t nrows, int64_t d,
                                 int64_t tpr, int64_t first, double c1,
                                 double c2, void* stream) {
  return GRAVOMG_SLICED(
      float, kCheb, gravomg::cheb_epilogue<float>(b, dinv, x, dstep, first, c1, c2),
      x, x_out, mask);
}

int gravomg_sliced_spmv_cheb_f64(const void* slice_ptr, const void* col,
                                 const void* val, const void* x, void* x_out,
                                 const void* b, const void* dinv, void* dstep,
                                 const void* mask, int64_t nrows, int64_t d,
                                 int64_t tpr, int64_t first, double c1,
                                 double c2, void* stream) {
  return GRAVOMG_SLICED(
      double, kCheb, gravomg::cheb_epilogue<double>(b, dinv, x, dstep, first, c1, c2),
      x, x_out, mask);
}

int gravomg_halo_spmv_f32(const void* slice_ptr, const void* col,
                          const void* val, const void* out_row,
                          const void* halo, void* y, int64_t nrows, int64_t d,
                          int64_t tpr, void* stream) {
  return GRAVOMG_HALO(float, kPlain, gravomg::vector_epilogue<float>(nullptr));
}

int gravomg_halo_spmv_f64(const void* slice_ptr, const void* col,
                          const void* val, const void* out_row,
                          const void* halo, void* y, int64_t nrows, int64_t d,
                          int64_t tpr, void* stream) {
  return GRAVOMG_HALO(double, kPlain, gravomg::vector_epilogue<double>(nullptr));
}

int gravomg_halo_spmv_residual_f32(const void* slice_ptr, const void* col,
                                   const void* val, const void* out_row,
                                   const void* halo, void* y, const void* b,
                                   int64_t nrows, int64_t d, int64_t tpr,
                                   void* stream) {
  return GRAVOMG_HALO(float, kResidual, gravomg::vector_epilogue<float>(b));
}

int gravomg_halo_spmv_residual_f64(const void* slice_ptr, const void* col,
                                   const void* val, const void* out_row,
                                   const void* halo, void* y, const void* b,
                                   int64_t nrows, int64_t d, int64_t tpr,
                                   void* stream) {
  return GRAVOMG_HALO(double, kResidual, gravomg::vector_epilogue<double>(b));
}

int gravomg_halo_spmv_add_f32(const void* slice_ptr, const void* col,
                              const void* val, const void* out_row,
                              const void* halo, void* y, const void* z,
                              int64_t nrows, int64_t d, int64_t tpr,
                              void* stream) {
  return GRAVOMG_HALO(float, kAdd, gravomg::vector_epilogue<float>(z));
}

int gravomg_halo_spmv_add_f64(const void* slice_ptr, const void* col,
                              const void* val, const void* out_row,
                              const void* halo, void* y, const void* z,
                              int64_t nrows, int64_t d, int64_t tpr,
                              void* stream) {
  return GRAVOMG_HALO(double, kAdd, gravomg::vector_epilogue<double>(z));
}

int gravomg_halo_spmv_cheb_f32(const void* slice_ptr, const void* col,
                               const void* val, const void* out_row,
                               const void* halo, void* y, const void* x,
                               const void* b, const void* dinv, void* dstep,
                               int64_t nrows, int64_t d, int64_t tpr,
                               int64_t first, double c1, double c2,
                               void* stream) {
  return GRAVOMG_HALO(float, kCheb, gravomg::cheb_epilogue<float>(
                                        b, dinv, x, dstep, first, c1, c2));
}

int gravomg_halo_spmv_cheb_f64(const void* slice_ptr, const void* col,
                               const void* val, const void* out_row,
                               const void* halo, void* y, const void* x,
                               const void* b, const void* dinv, void* dstep,
                               int64_t nrows, int64_t d, int64_t tpr,
                               int64_t first, double c1, double c2,
                               void* stream) {
  return GRAVOMG_HALO(double, kCheb, gravomg::cheb_epilogue<double>(
                                         b, dinv, x, dstep, first, c1, c2));
}

}  // extern "C"
