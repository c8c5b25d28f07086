// ShuffleEll SpMV for Hopper (sm_90a):
//
//   y[s*128 + l, j] = sum_k v[k, s, l] * x[q[k, s]*128 + r[k, s, l], j]
//
// Replaces the TPU kernel gravo_mg_tpu/ops/shuffle_spmv.py::lane_shuffle_fma
// together with the XLA row gather that feeds it (gravo_mg_tpu/sparse.py
// shuffle_spmv_1d).  On the TPU the SpMV is split in two because Mosaic has
// no vectorized arbitrary gather: the row gather writes z = x[q] (KP, S, 128)
// to HBM and the Pallas kernel reads it back for the in-register lane
// shuffle.  A Hopper thread can load any address, so this kernel reads x
// directly and z never exists; that saves a write and a read of
// KP*S*128*sizeof(T) bytes per apply.
//
// What bounds it: the stream of v (sizeof(T) bytes) and r (1 byte) per slot
// lane.  x is at most a few MB at the sizes the solver runs (4 MB at 1M rows
// in f32), so the lane gathers from x hit the H100's 50 MB L2.  Hence no shared
// memory staging: one thread per output row, the 128 threads of a row group
// read the same q[k, s] (a broadcast load), and the v/r loads of a warp are
// contiguous.  Slots are summed in ascending k order.
//
// A lane whose column lies past ncols (the zero-padded tail of the last
// x block on the TPU) only occurs in padding slots, where v == 0; the
// kernel bounds-checks the column instead of padding x.

#include "spmv_common.cuh"

namespace gravomg {

template <typename T>
__global__ void __launch_bounds__(kThreads)
shuffle_spmv_kernel(const int32_t* __restrict__ q, const int8_t* __restrict__ r,
                    const T* __restrict__ v, const T* __restrict__ x,
                    T* __restrict__ y, int64_t kp, int64_t s, int64_t nrows,
                    int64_t ncols, int64_t d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nrows) return;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int64_t nj = d - j0 < kCols ? d - j0 : kCols;
  const int64_t slot_stride = s * 128;  // elements between slots k and k+1
  const int32_t* qk = q + (row >> 7);
  const int8_t* rk = r + row;
  const T* vk = v + row;
  T acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = T(0);
#pragma unroll 4
  for (int64_t k = 0; k < kp; ++k) {
    const T val = vk[0];
    const int64_t col = static_cast<int64_t>(qk[0]) * 128 +
                        static_cast<int64_t>(rk[0]);  // int8 lane, widened
    if (col >= 0 && col < ncols) {
      const T* xc = x + col * d + j0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nj) acc[j] += val * xc[j];
    }
    qk += s;
    rk += slot_stride;
    vk += slot_stride;
  }
  T* yr = y + row * d + j0;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (j < nj) yr[j] = acc[j];
}

template <typename T>
int launch_shuffle_spmv(const void* q, const void* r, const void* v,
                        const void* x, void* y, int64_t kp, int64_t s,
                        int64_t nrows, int64_t ncols, int64_t d, void* stream) {
  if (nrows > 0 && d > 0) {
    shuffle_spmv_kernel<T><<<spmv_grid(nrows, d), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(q), static_cast<const int8_t*>(r),
        static_cast<const T*>(v), static_cast<const T*>(x),
        static_cast<T*>(y), kp, s, nrows, ncols, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gravomg

extern "C" {

int gravomg_shuffle_spmv_f32(const void* q, const void* r, const void* v,
                             const void* x, void* y, int64_t kp, int64_t s,
                             int64_t nrows, int64_t ncols, int64_t d,
                             void* stream) {
  return gravomg::launch_shuffle_spmv<float>(q, r, v, x, y, kp, s, nrows,
                                             ncols, d, stream);
}

int gravomg_shuffle_spmv_f64(const void* q, const void* r, const void* v,
                             const void* x, void* y, int64_t kp, int64_t s,
                             int64_t nrows, int64_t ncols, int64_t d,
                             void* stream) {
  return gravomg::launch_shuffle_spmv<double>(q, r, v, x, y, kp, s, nrows,
                                              ncols, d, stream);
}

const char* gravomg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
