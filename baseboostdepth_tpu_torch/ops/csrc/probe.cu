// The capability probes of tools/pallas_probe.py as four CUDA kernels for
// Hopper (sm_90a): a scale, a gather along rows, a gather along columns and
// a dynamic row slice.
//
// Replaces the seven pl.pallas_call kernels of tools/pallas_probe.py:
//   probe_scale        <- trivial (y = 2x)
//   probe_gather_rows  <- sublane_gather, sublane_gather_same
//                         (jnp.take_along_axis(src, idx, axis=0))
//   probe_gather_cols  <- lane_gather, lane_gather_wide
//                         (jnp.take_along_axis(src, idx, axis=1)), and
//                         gather_2d_flat (the same on the [1, H*W] view of
//                         the source, broadcast over the index rows: a
//                         source row stride of 0)
//   probe_row_slice    <- dyn_slice (src[s : s + rows, :], s read from a
//                         device scalar)
//
// What the Pallas probes stage in VMEM or SMEM (whole arrays) has no CUDA
// counterpart to copy: these kernels compute the functions. One thread per
// output element.
//
// Gather semantics are jnp.take_along_axis's on the CPU: an index in [-n, 0)
// wraps to idx + n, and any other index outside [0, n) yields NaN; no thread
// reads out of bounds. The slice start follows jax.lax.dynamic_slice: a
// negative start counts from the end (s + rows_src), then the start is
// clamped to [0, rows_src - rows].
//
// Bound: bytes, and at the probes' shapes (at most 0.5 MiB per array) the
// launch itself: a few microseconds against a bytes bound under half a
// microsecond. Nothing here is worth tiling; the index and output accesses
// are coalesced across a warp, the source reads are scattered by design.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gather_or_nan(const float* __restrict__ row, int32_t i,
                                               int n, int64_t stride) {
  const int64_t w = i < 0 ? (int64_t)i + n : (int64_t)i;
  return (w >= 0 && w < n) ? __ldg(row + w * stride) : __int_as_float(0x7fc00000);
}

__global__ void probe_scale_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) y[t] = x[t] * 2.0f;
}

// out[r, c] = src[idx[r, c], c]; src [n, cols], idx and out [rows, cols]
__global__ void probe_gather_rows_kernel(const float* __restrict__ src,
                                         const int32_t* __restrict__ idx,
                                         float* __restrict__ out, int n, int cols,
                                         int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % cols);
  out[t] = gather_or_nan(src + c, idx[t], n, cols);
}

// out[r, c] = src[r * row_stride + idx[r, c]]; src rows of n elements
// (row_stride n, or 0 to broadcast one row), idx and out [rows, cols]
__global__ void probe_gather_cols_kernel(const float* __restrict__ src,
                                         const int32_t* __restrict__ idx,
                                         float* __restrict__ out, int n, int64_t row_stride,
                                         int cols, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t r = t / cols;
  out[t] = gather_or_nan(src + r * row_stride, idx[t], n, 1);
}

// out[r, c] = src[s + r, c], s = clamp(start < 0 ? start + rows_src : start,
// 0, rows_src - rows); src [rows_src, cols], out [rows, cols]
__global__ void probe_row_slice_kernel(const float* __restrict__ src,
                                       const int32_t* __restrict__ start,
                                       float* __restrict__ out, int rows_src, int rows, int cols,
                                       int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int64_t s = __ldg(start);
  if (s < 0) s += rows_src;
  const int64_t last = rows_src - rows;
  s = s < 0 ? 0 : (s > last ? last : s);
  out[t] = __ldg(src + s * cols + t);
}

int blocks_for(int64_t total, unsigned* blocks) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  if (b > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)b;
  return (int)cudaSuccess;
}

}  // namespace

// Each launcher takes contiguous float32 / int32 buffers on one device,
// launches on `stream`, and returns the launch's cudaError_t (0 on
// success); none synchronises.

// x, y: float32 [total].
extern "C" int bbd_probe_scale(const void* x, void* y, long long total, void* stream) {
  if (!x || !y || total < 0) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  unsigned blocks;
  const int err = blocks_for(total, &blocks);
  if (err != (int)cudaSuccess) return err;
  probe_scale_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, total);
  return (int)cudaGetLastError();
}

// src: float32 [n, cols]; idx: int32 [rows, cols]; out: float32 [rows, cols].
extern "C" int bbd_probe_gather_rows(const void* src, const void* idx, void* out, int n,
                                     int rows, int cols, void* stream) {
  if (!src || !idx || !out || n <= 0 || rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)rows * cols;
  if (total == 0) return (int)cudaSuccess;
  unsigned blocks;
  const int err = blocks_for(total, &blocks);
  if (err != (int)cudaSuccess) return err;
  probe_gather_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)idx, (float*)out, n, cols, total);
  return (int)cudaGetLastError();
}

// src: float32 rows of n elements, row r at r * row_stride (row_stride n for
// [rows, n], 0 for one row broadcast); idx: int32 [rows, cols]; out: float32
// [rows, cols].
extern "C" int bbd_probe_gather_cols(const void* src, const void* idx, void* out, int n,
                                     long long row_stride, int rows, int cols, void* stream) {
  if (!src || !idx || !out || n <= 0 || row_stride < 0 || rows < 0 || cols < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)rows * cols;
  if (total == 0) return (int)cudaSuccess;
  unsigned blocks;
  const int err = blocks_for(total, &blocks);
  if (err != (int)cudaSuccess) return err;
  probe_gather_cols_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)idx, (float*)out, n, row_stride, cols, total);
  return (int)cudaGetLastError();
}

// src: float32 [rows_src, cols]; start: int32 [1] on the device; out:
// float32 [rows, cols], rows <= rows_src.
extern "C" int bbd_probe_row_slice(const void* src, const void* start, void* out, int rows_src,
                                   int rows, int cols, void* stream) {
  if (!src || !start || !out || rows < 0 || rows > rows_src || cols < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)rows * cols;
  if (total == 0) return (int)cudaSuccess;
  unsigned blocks;
  const int err = blocks_for(total, &blocks);
  if (err != (int)cudaSuccess) return err;
  probe_row_slice_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)start, (float*)out, rows_src, rows, cols, total);
  return (int)cudaGetLastError();
}
