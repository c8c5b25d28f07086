// DiagEll SpMV for Hopper (sm_90a):
//
//   blk = start[g / tg, k] - tg + g % tg          (g = row / 128)
//   y[row, j] = sum_k v[k, g, row % 128] * x[blk*128 + r[k, g, row % 128], j]
//
// Replaces the TPU kernel gravo_mg_tpu/ops/diag_spmv.py::_diag_spmv_pallas.
// The layout (sparse._diag_layout) guarantees that within a tile of tg row
// groups slot k reads consecutive x blocks, so the source block comes from
// the (n_tiles, KP) start table and no per-group q table is read.  The
// start table stores g0 + d + tg, the row offset into the TPU kernel's
// zero-padded xb_pad; the kernel subtracts the pad instead of building
// xb_pad on every apply.
//
// What bounds it: the stream of v (sizeof(T) bytes) and r (1 byte) per slot
// lane.  The TPU kernel DMAs (tg, 128) slices of x into VMEM, double
// buffered, because VMEM is the only memory its vector unit can gather
// from.  Here x (4 MB at 1M rows in f32) sits in the H100's 50 MB L2, so the
// kernel has no shared-memory staging and keeps the reference's layout,
// tg = 512 included: one thread per output row, a broadcast load of the
// start entry, contiguous v/r loads, slots summed in ascending k order.
//
// A source block outside [0, NB) only occurs where v == 0 (an occupied slot
// has a real entry in range; gravo_mg_tpu/ops/diag_spmv.py:24-26), so the
// kernel bounds-checks the column instead of reading zero padding.

#include "spmv_common.cuh"

namespace gravomg {

template <typename T>
__global__ void __launch_bounds__(kThreads)
diag_spmv_kernel(const int32_t* __restrict__ start,
                 const int8_t* __restrict__ r, const T* __restrict__ v,
                 const T* __restrict__ x, T* __restrict__ y, int64_t kp,
                 int64_t s_pad, int64_t tg, int64_t nrows, int64_t ncols,
                 int64_t d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nrows) return;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int64_t nj = d - j0 < kCols ? d - j0 : kCols;
  const int64_t g = row >> 7;
  const int64_t tile = g / tg;
  const int64_t blk_off = (g - tile * tg) - tg;  // s_in minus the xb_pad pad
  const int64_t slot_stride = s_pad * 128;
  const int32_t* st = start + tile * kp;
  const int8_t* rk = r + row;
  const T* vk = v + row;
  T acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = T(0);
#pragma unroll 4
  for (int64_t k = 0; k < kp; ++k) {
    const T val = vk[0];
    const int64_t col = (static_cast<int64_t>(st[k]) + blk_off) * 128 +
                        static_cast<int64_t>(rk[0]);  // int8 lane, widened
    if (col >= 0 && col < ncols) {
      const T* xc = x + col * d + j0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nj) acc[j] += val * xc[j];
    }
    rk += slot_stride;
    vk += slot_stride;
  }
  T* yr = y + row * d + j0;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (j < nj) yr[j] = acc[j];
}

template <typename T>
int launch_diag_spmv(const void* start, const void* r, const void* v,
                     const void* x, void* y, int64_t kp, int64_t s_pad,
                     int64_t tg, int64_t nrows, int64_t ncols, int64_t d,
                     void* stream) {
  if (nrows > 0 && d > 0) {
    diag_spmv_kernel<T><<<spmv_grid(nrows, d), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(start), static_cast<const int8_t*>(r),
        static_cast<const T*>(v), static_cast<const T*>(x),
        static_cast<T*>(y), kp, s_pad, tg, nrows, ncols, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gravomg

extern "C" {

int gravomg_diag_spmv_f32(const void* start, const void* r, const void* v,
                          const void* x, void* y, int64_t kp, int64_t s_pad,
                          int64_t tg, int64_t nrows, int64_t ncols, int64_t d,
                          void* stream) {
  return gravomg::launch_diag_spmv<float>(start, r, v, x, y, kp, s_pad, tg,
                                          nrows, ncols, d, stream);
}

int gravomg_diag_spmv_f64(const void* start, const void* r, const void* v,
                          const void* x, void* y, int64_t kp, int64_t s_pad,
                          int64_t tg, int64_t nrows, int64_t ncols, int64_t d,
                          void* stream) {
  return gravomg::launch_diag_spmv<double>(start, r, v, x, y, kp, s_pad, tg,
                                           nrows, ncols, d, stream);
}

}  // extern "C"
