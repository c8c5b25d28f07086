// SlicedDiag SpMV for Hopper (sm_90a):
//
//   col(e) = 32 s + lane + base[slice_ptr[s] / 32 + k] + delta[e]   (delta slice)
//          = wide_col[wide_ptr[s] + e - slice_ptr[s]]                 (wide slice)
//   y[32 s + lane, j] = sum_{k < w_s} val[e] * x[col(e), j],
//   e = slice_ptr[s] + 32 k + lane,  w_s = (slice_ptr[s+1] - slice_ptr[s]) / 32
//
// Replaces the TPU kernel gravo_mg_tpu/ops/diag_spmv.py::_diag_spmv_pallas,
// the diagonal-run SpMV of the finest level operator, on a layout made for
// this card (sparse.SlicedDiag).  The TPU kernel's idea is that a slot's
// column is implied by the row: a run of rows reads one diagonal, so no
// column index is stored beside the lane.  The TPU layout carries that idea
// in (tile of 512 x 128 rows, block diagonal) slots, because a TPU core DMAs
// one contiguous x slice per slot; each slot is as deep as the diagonal's
// largest (group, lane) multiplicity, which for the 1M torus Laplacian is 20
// slots per row for 7 nonzeros.  Here a run is one warp's 32 rows: the slices
// of SELL-32 (each as wide as its longest row, 1.00x the nonzeros there),
// one int32 base per (slice, slot) and one int8 delta per entry, col = row +
// base + delta.  A slice whose deltas do not fit int8 stores int32 columns
// (the slices that hold the torus's wrap-around rows).
//
// What bounds it: the bytes it streams.  Per apply, sizeof(T) + 1 bytes per
// stored entry of a delta slice plus 4 bytes per slot, sizeof(T) + 4 per
// entry of a wide slice, 16 bytes per slice, and x and y once: 47.85 MB for
// the 1M A0 in f32 (2052 of its 32768 slices wide), 14.28 us at 3.35 TB/s.
// The format-neutral bound (an int32 column and a value per nonzero, x and
// y once) is 67.11 MB, 20.03 us.
// An SpMV does 0.25 FLOP per byte, so tensor cores have no role.
//
// Design, against the two faults of the one-thread-per-row DiagEll kernel
// (csrc/diag_spmv.cu): its layout streamed 2.2x the bytes (above), and each
// thread walked its slots with every x load waiting on the lane load before
// it, in 64-bit index arithmetic behind a bounds branch.  Here a warp owns
// a slice, one thread per row; the slice width, and the branch between a
// delta and a wide slice, are warp-uniform.  Per slot the warp makes one
// 32-byte delta load, one 128-byte value load, one broadcast base load and
// an x load over one or two 128-byte lines (32 consecutive rows plus one
// base give near-consecutive columns, served from the 50 MB L2, the
// counterpart of the TPU kernel's contiguous x slice).  Slots go in chunks
// of kUnroll: every value, delta and base load of a chunk is issued, then
// every x load, then the FMAs in slot order, so a thread keeps 2 x kUnroll
// loads in flight instead of one.  Row, base and delta add in int32;
// padding has weight 0 and a column in range, so no bounds branch.  Values,
// deltas and wide columns are read with streaming loads (__ldcs, evict
// first) so that x stays in L2; each warp streams its slice's values and
// deltas straight from device memory (staging them in shared memory with
// TMA bulk copies measured slower at every shape, PERF.md).
// Summation follows slot order (CSR column order).  Up to kCols
// right-hand-side columns per thread (one where d = 1), wider right-hand
// sides over gridDim.y.  The row's thread applies the launch's epilogue
// (spmv_common.cuh: plain, residual or the Chebyshev step) to its sum
// before it stores; in a masked launch (the halo path's stacked level-0
// interior) only where the row's mask bit is clear, storing the raw sum on
// the boundary rows for the halo_spmv launch that follows
// (csrc/sliced_spmv.cu).

#include "spmv_common.cuh"

namespace gravomg {
namespace {

constexpr int kSlice = 32;
constexpr int kWarps = kThreads / kSlice;
constexpr int kUnroll = 8;  // slots whose loads go out together

// One thread's sum over its row's slots: val_at(k) and col_at(k) load slot
// k's value and column.
template <typename T, int NC, typename ValAt, typename ColAt>
__device__ __forceinline__ void sum_slots(int w, ValAt val_at, ColAt col_at,
                                          const T* __restrict__ x, int d,
                                          int j0, int nj, T (&acc)[NC]) {
  for (int k0 = 0; k0 < w; k0 += kUnroll) {
    T a[kUnroll];
    int c[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      a[i] = T(0);
      c[i] = 0;
      if (k0 + i < w) {
        a[i] = val_at(k0 + i);
        c[i] = col_at(k0 + i);
      }
    }
    T xv[kUnroll][NC];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const T* xc = x + static_cast<int64_t>(c[i]) * d + j0;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        xv[i][j] = (k0 + i < w && j < nj) ? __ldg(xc + j) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (k0 + i < w) acc[j] += a[i] * xv[i][j];
    }
  }
}

template <Mode M, typename T, int NC, bool kMasked>
__global__ void __launch_bounds__(kThreads)
sliced_diag_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                        const int32_t* __restrict__ base,
                        const int8_t* __restrict__ delta,
                        const T* __restrict__ val,
                        const int64_t* __restrict__ wide_ptr,
                        const int32_t* __restrict__ wide_col,
                        const uint32_t* __restrict__ mask,
                        const T* __restrict__ x, T* __restrict__ y,
                        const Epilogue<T> ep, int nrows, int d) {
  const int s = static_cast<int>(blockIdx.x) * kWarps + threadIdx.x / kSlice;
  const int lane = threadIdx.x % kSlice;
  if (s * kSlice >= nrows) return;  // warp-uniform: whole warps leave
  const int row = s * kSlice + lane;
  const int64_t lo = slice_ptr[s];
  const int w = static_cast<int>((slice_ptr[s + 1] - lo) / kSlice);
  const int64_t wp = wide_ptr[s];
  const int j0 = static_cast<int>(blockIdx.y) * NC;
  const int nj = d - j0 < NC ? d - j0 : NC;
  const T* v = val + lo + lane;
  auto val_at = [&](int k) { return __ldcs(v + k * kSlice); };
  T acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = T(0);
  if (wp < 0) {
    const int8_t* dl = delta + lo + lane;
    const int32_t* b = base + lo / kSlice;
    sum_slots<T, NC>(
        w, val_at,
        [&](int k) {
          return row + __ldg(b + k) + static_cast<int>(__ldcs(dl + k * kSlice));
        },
        x, d, j0, nj, acc);
  } else {
    const int32_t* wc = wide_col + wp + lane;
    sum_slots<T, NC>(
        w, val_at, [&](int k) { return __ldcs(wc + k * kSlice); }, x, d, j0, nj,
        acc);
  }
  if (row < nrows)
    store_interior_row<M, T, NC, kMasked>(y, ep, mask, row, d, j0, nj, acc);
}

// Masked where a mask is given (never in plain mode).
template <Mode M, typename T, int NC>
int launch_nc(const int64_t* p, const int32_t* b, const int8_t* dl, const T* v,
              const int64_t* wp, const int32_t* wc, const uint32_t* m,
              const T* x, T* y, const Epilogue<T>& ep, int nrows, int d,
              cudaStream_t st) {
  const int slices = (nrows + kSlice - 1) / kSlice;
  const dim3 grid(static_cast<unsigned>((slices + kWarps - 1) / kWarps),
                  static_cast<unsigned>((d + NC - 1) / NC));
  if constexpr (M != Mode::kPlain) {
    if (m != nullptr) {
      sliced_diag_spmv_kernel<M, T, NC, true><<<grid, kThreads, 0, st>>>(
          p, b, dl, v, wp, wc, m, x, y, ep, nrows, d);
      return static_cast<int>(cudaGetLastError());
    }
  }
  sliced_diag_spmv_kernel<M, T, NC, false><<<grid, kThreads, 0, st>>>(
      p, b, dl, v, wp, wc, nullptr, x, y, ep, nrows, d);
  return static_cast<int>(cudaGetLastError());
}

template <Mode M, typename T>
int launch(const void* slice_ptr, const void* base, const void* delta,
           const void* val, const void* wide_ptr, const void* wide_col,
           const void* mask, const void* x, void* y, const Epilogue<T>& ep,
           int64_t nrows, int64_t d, void* stream) {
  if (nrows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int64_t*>(slice_ptr);
  const auto* b = static_cast<const int32_t*>(base);
  const auto* dl = static_cast<const int8_t*>(delta);
  const auto* v = static_cast<const T*>(val);
  const auto* wp = static_cast<const int64_t*>(wide_ptr);
  const auto* wc = static_cast<const int32_t*>(wide_col);
  const auto* m = static_cast<const uint32_t*>(mask);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nrows);
  const int dd = static_cast<int>(d);
  if (d == 1)
    return launch_nc<M, T, 1>(p, b, dl, v, wp, wc, m, xx, yy, ep, n, dd, st);
  return launch_nc<M, T, kCols>(p, b, dl, v, wp, wc, m, xx, yy, ep, n, dd, st);
}

}  // namespace
}  // namespace gravomg

// One entry per (epilogue, dtype).  The layout's arguments come first,
// then x and the output (x_out for the Chebyshev step), then the
// epilogue's vectors and the row mask (null: unmasked).

#define GRAVOMG_LAYOUT_ARGS                                                   \
  const void *slice_ptr, const void *base, const void *delta, const void *val, \
      const void *wide_ptr, const void *wide_col
#define GRAVOMG_LAYOUT slice_ptr, base, delta, val, wide_ptr, wide_col

extern "C" {

int gravomg_sliced_diag_spmv_f32(GRAVOMG_LAYOUT_ARGS, const void* x, void* y,
                                 int64_t nrows, int64_t d, void* stream) {
  return gravomg::launch<gravomg::Mode::kPlain, float>(
      GRAVOMG_LAYOUT, nullptr, x, y, gravomg::vector_epilogue<float>(nullptr),
      nrows, d, stream);
}

int gravomg_sliced_diag_spmv_f64(GRAVOMG_LAYOUT_ARGS, const void* x, void* y,
                                 int64_t nrows, int64_t d, void* stream) {
  return gravomg::launch<gravomg::Mode::kPlain, double>(
      GRAVOMG_LAYOUT, nullptr, x, y, gravomg::vector_epilogue<double>(nullptr),
      nrows, d, stream);
}

int gravomg_sliced_diag_spmv_residual_f32(GRAVOMG_LAYOUT_ARGS, const void* x,
                                          void* y, const void* b,
                                          const void* mask, int64_t nrows,
                                          int64_t d, void* stream) {
  return gravomg::launch<gravomg::Mode::kResidual, float>(
      GRAVOMG_LAYOUT, mask, x, y, gravomg::vector_epilogue<float>(b), nrows, d,
      stream);
}

int gravomg_sliced_diag_spmv_residual_f64(GRAVOMG_LAYOUT_ARGS, const void* x,
                                          void* y, const void* b,
                                          const void* mask, int64_t nrows,
                                          int64_t d, void* stream) {
  return gravomg::launch<gravomg::Mode::kResidual, double>(
      GRAVOMG_LAYOUT, mask, x, y, gravomg::vector_epilogue<double>(b), nrows, d,
      stream);
}

int gravomg_sliced_diag_spmv_cheb_f32(GRAVOMG_LAYOUT_ARGS, const void* x,
                                      void* x_out, const void* b,
                                      const void* dinv, void* dstep,
                                      const void* mask, int64_t nrows,
                                      int64_t d, int64_t first, double c1,
                                      double c2, void* stream) {
  return gravomg::launch<gravomg::Mode::kCheb, float>(
      GRAVOMG_LAYOUT, mask, x, x_out,
      gravomg::cheb_epilogue<float>(b, dinv, x, dstep, first, c1, c2), nrows, d,
      stream);
}

int gravomg_sliced_diag_spmv_cheb_f64(GRAVOMG_LAYOUT_ARGS, const void* x,
                                      void* x_out, const void* b,
                                      const void* dinv, void* dstep,
                                      const void* mask, int64_t nrows,
                                      int64_t d, int64_t first, double c1,
                                      double c2, void* stream) {
  return gravomg::launch<gravomg::Mode::kCheb, double>(
      GRAVOMG_LAYOUT, mask, x, x_out,
      gravomg::cheb_epilogue<double>(b, dinv, x, dstep, first, c1, c2), nrows, d,
      stream);
}

}  // extern "C"
