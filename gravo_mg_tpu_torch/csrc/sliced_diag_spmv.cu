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
// first) so that x stays in L2.  Two variants, both built:
//  * direct: each warp streams its slice's values and deltas from device
//    memory;
//  * staged: the TPU kernel's double-buffered DMA moved onto the matrix
//    stream.  A persistent grid; each block takes blocks of `sb` slices, and
//    one thread copies the values and deltas of the block kStages - 1 ahead
//    into shared memory with cp.async.bulk (the TMA's 1-D bulk copy)
//    completing on an mbarrier, while the block's warps sum the current one.
// Summation follows slot order (CSR column order) in both.  Up to kCols
// right-hand-side columns per thread (one where d = 1), wider right-hand
// sides over gridDim.y.

#include "spmv_common.cuh"

namespace gravomg {
namespace {

constexpr int kSlice = 32;
constexpr int kWarps = kThreads / kSlice;
constexpr int kUnroll = 8;                 // slots whose loads go out together
constexpr int kStages = 3;                 // staged: shared-memory ring depth
constexpr int kStageBytes = 16 * 1024;     // staged: target bytes per stage
constexpr int kMaxStageBytes = 72 * 1024;  // staged: one slice at most

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

template <typename T, int NC>
__device__ __forceinline__ void store_row(T* __restrict__ y, int row, int nrows,
                                          int d, int j0, int nj,
                                          const T (&acc)[NC]) {
  if (row >= nrows) return;
  T* yr = y + static_cast<int64_t>(row) * d + j0;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (j < nj) yr[j] = acc[j];
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
sliced_diag_spmv_kernel_direct(const int64_t* __restrict__ slice_ptr,
                               const int32_t* __restrict__ base,
                               const int8_t* __restrict__ delta,
                               const T* __restrict__ val,
                               const int64_t* __restrict__ wide_ptr,
                               const int32_t* __restrict__ wide_col,
                               const T* __restrict__ x, T* __restrict__ y,
                               int nrows, int d) {
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
  store_row<T, NC>(y, row, nrows, d, j0, nj, acc);
}

// ---- staged: TMA bulk copies into a shared-memory ring ---------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar,
                                                     uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte
// aligned; completes `bytes` of the barrier's expected transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
sliced_diag_spmv_kernel_staged(const int64_t* __restrict__ slice_ptr,
                               const int32_t* __restrict__ base,
                               const int8_t* __restrict__ delta,
                               const T* __restrict__ val,
                               const int64_t* __restrict__ wide_ptr,
                               const int32_t* __restrict__ wide_col,
                               const T* __restrict__ x, T* __restrict__ y,
                               int nrows, int d, int sb, int stage_entries,
                               int n_blocks) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int stage_bytes = stage_entries * static_cast<int>(sizeof(T) + 1);
  const int n_slices = (nrows + kSlice - 1) / kSlice;
  const int warp = threadIdx.x / kSlice;
  const int lane = threadIdx.x % kSlice;
  const int j0 = static_cast<int>(blockIdx.y) * NC;
  const int nj = d - j0 < NC ? d - j0 : NC;
  const int grid = static_cast<int>(gridDim.x);

  // Values then deltas of block `blk` into stage `stage` (one thread).
  auto fill = [&](int blk, int stage) {
    const int s0 = blk * sb;
    const int s1 = s0 + sb < n_slices ? s0 + sb : n_slices;
    const int64_t lo = slice_ptr[s0];
    const uint32_t n = static_cast<uint32_t>(slice_ptr[s1] - lo);
    if (n == 0) {
      bar_arrive(&bars[stage]);
      return;
    }
    unsigned char* buf = ring + stage * stage_bytes;
    bar_arrive_expect_tx(&bars[stage], n * static_cast<uint32_t>(sizeof(T) + 1));
    bulk_copy(buf, val + lo, n * static_cast<uint32_t>(sizeof(T)), &bars[stage]);
    bulk_copy(buf + stage_entries * sizeof(T), delta + lo, n, &bars[stage]);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      const int blk = static_cast<int>(blockIdx.x) + i * grid;
      if (blk < n_blocks) fill(blk, i);
    }
  }
  int it = 0;
  for (int blk = blockIdx.x; blk < n_blocks; blk += grid, ++it) {
    const int stage = it % kStages;
    bar_wait(&bars[stage], static_cast<uint32_t>((it / kStages) & 1));
    const T* sv = reinterpret_cast<const T*>(ring + stage * stage_bytes);
    const int8_t* sd = reinterpret_cast<const int8_t*>(
        ring + stage * stage_bytes + stage_entries * sizeof(T));
    const int s0 = blk * sb;
    const int s1 = s0 + sb < n_slices ? s0 + sb : n_slices;
    const int64_t block_lo = slice_ptr[s0];
    for (int s = s0 + warp; s < s1; s += kWarps) {
      const int row = s * kSlice + lane;
      const int64_t lo = slice_ptr[s];
      const int w = static_cast<int>((slice_ptr[s + 1] - lo) / kSlice);
      const int64_t wp = wide_ptr[s];
      const int off = static_cast<int>(lo - block_lo) + lane;
      auto val_at = [&](int k) { return sv[off + k * kSlice]; };
      T acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = T(0);
      if (wp < 0) {
        const int32_t* b = base + lo / kSlice;
        sum_slots<T, NC>(
            w, val_at,
            [&](int k) {
              return row + __ldg(b + k) + static_cast<int>(sd[off + k * kSlice]);
            },
            x, d, j0, nj, acc);
      } else {
        const int32_t* wc = wide_col + wp + lane;
        sum_slots<T, NC>(
            w, val_at, [&](int k) { return __ldcs(wc + k * kSlice); }, x, d, j0,
            nj, acc);
      }
      store_row<T, NC>(y, row, nrows, d, j0, nj, acc);
    }
    __syncthreads();  // every warp is done with this stage: refill it
    if (threadIdx.x == 0) {
      const int next = blk + kStages * grid;
      if (next < n_blocks) fill(next, stage);
    }
  }
}

template <typename T, int NC>
int launch_direct(const int64_t* p, const int32_t* b, const int8_t* dl,
                  const T* v, const int64_t* wp, const int32_t* wc, const T* x,
                  T* y, int nrows, int d, cudaStream_t st) {
  const int slices = (nrows + kSlice - 1) / kSlice;
  const dim3 grid(static_cast<unsigned>((slices + kWarps - 1) / kWarps),
                  static_cast<unsigned>((d + NC - 1) / NC));
  sliced_diag_spmv_kernel_direct<T, NC><<<grid, kThreads, 0, st>>>(
      p, b, dl, v, wp, wc, x, y, nrows, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int launch_staged(const int64_t* p, const int32_t* b, const int8_t* dl,
                  const T* v, const int64_t* wp, const int32_t* wc, const T* x,
                  T* y, int nrows, int d, int64_t wmax, cudaStream_t st) {
  const int slices = (nrows + kSlice - 1) / kSlice;
  const int64_t slice_bytes = wmax * kSlice * static_cast<int64_t>(sizeof(T) + 1);
  if (slice_bytes > kMaxStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  int sb = slice_bytes > 0 ? static_cast<int>(kStageBytes / slice_bytes) : 64;
  sb = sb < 1 ? 1 : (sb > 64 ? 64 : sb);
  if (sb >= kWarps) sb -= sb % kWarps;  // whole rounds of the block's warps
  int stage_entries = static_cast<int>(sb * wmax) * kSlice;
  stage_entries = ((stage_entries + 127) / 128) * 128;
  if (stage_entries == 0) stage_entries = 128;
  const size_t smem = static_cast<size_t>(kStages) * stage_entries * (sizeof(T) + 1);
  auto kernel = sliced_diag_spmv_kernel_staged<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int n_blocks = (slices + sb - 1) / sb;
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const dim3 grid(static_cast<unsigned>(n_blocks < resident ? n_blocks : resident),
                  static_cast<unsigned>((d + NC - 1) / NC));
  kernel<<<grid, kThreads, smem, st>>>(p, b, dl, v, wp, wc, x, y, nrows, d, sb,
                                       stage_entries, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int launch_variant(const int64_t* p, const int32_t* b, const int8_t* dl,
                   const T* v, const int64_t* wp, const int32_t* wc, const T* x,
                   T* y, int nrows, int d, int64_t wmax, int64_t variant,
                   cudaStream_t st) {
  switch (variant) {
    case 0: return launch_direct<T, NC>(p, b, dl, v, wp, wc, x, y, nrows, d, st);
    case 1:
      return launch_staged<T, NC>(p, b, dl, v, wp, wc, x, y, nrows, d, wmax, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_sliced_diag_spmv(const void* slice_ptr, const void* base,
                            const void* delta, const void* val,
                            const void* wide_ptr, const void* wide_col,
                            const void* x, void* y, int64_t nrows, int64_t d,
                            int64_t wmax, int64_t variant, void* stream) {
  if (nrows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* p = static_cast<const int64_t*>(slice_ptr);
  const auto* b = static_cast<const int32_t*>(base);
  const auto* dl = static_cast<const int8_t*>(delta);
  const auto* v = static_cast<const T*>(val);
  const auto* wp = static_cast<const int64_t*>(wide_ptr);
  const auto* wc = static_cast<const int32_t*>(wide_col);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nrows);
  const int dd = static_cast<int>(d);
  if (d == 1)
    return launch_variant<T, 1>(p, b, dl, v, wp, wc, xx, yy, n, dd, wmax, variant, st);
  return launch_variant<T, kCols>(p, b, dl, v, wp, wc, xx, yy, n, dd, wmax, variant,
                                  st);
}

}  // namespace
}  // namespace gravomg

extern "C" {

int gravomg_sliced_diag_spmv_f32(const void* slice_ptr, const void* base,
                                 const void* delta, const void* val,
                                 const void* wide_ptr, const void* wide_col,
                                 const void* x, void* y, int64_t nrows,
                                 int64_t d, int64_t wmax, int64_t variant,
                                 void* stream) {
  return gravomg::launch_sliced_diag_spmv<float>(
      slice_ptr, base, delta, val, wide_ptr, wide_col, x, y, nrows, d, wmax,
      variant, stream);
}

int gravomg_sliced_diag_spmv_f64(const void* slice_ptr, const void* base,
                                 const void* delta, const void* val,
                                 const void* wide_ptr, const void* wide_col,
                                 const void* x, void* y, int64_t nrows,
                                 int64_t d, int64_t wmax, int64_t variant,
                                 void* stream) {
  return gravomg::launch_sliced_diag_spmv<double>(
      slice_ptr, base, delta, val, wide_ptr, wide_col, x, y, nrows, d, wmax,
      variant, stream);
}

}  // extern "C"
