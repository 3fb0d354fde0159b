// Corner-plane gather of the bilinear warp, for Hopper (sm_90a).
//
// Replaces the TPU kernel baseboostdepth_tpu/ops/warp_pallas.py::_corner_kernel
// (pallas_call in _corner_sweep). For every output pixel (n, i, j) it reads the
// clamped pixel coordinates px, py, takes x0 = floor(px), y0 = floor(py), and
// writes the four bilinear corner texels v00, v01, v10, v11 of frame n as packed
// RGB words (R | G << 8 | B << 16) to out[n, 0..3, i, j].
//
// The TPU kernel sweeps (8-row band) x (128-column block) source tiles because
// Mosaic cannot gather across (8 x 128) tiles. A GPU thread can load any
// address, so none of that is carried over: one thread per output pixel.
//
// Edge padding without a padded copy: the TPU path edge-pads the packed source
// by one row and column and reads x0 + 1 / y0 + 1 there. Coordinates arrive
// clamped to [0, W-1] x [0, H-1], so reading at min(x0 + 1, W - 1) and
// min(y0 + 1, H - 1) gives the same texels bit for bit. x0 and y0 are clamped
// too, which changes nothing for clamped input and keeps every read in bounds
// for any input.
//
// Packing: the kernel reads the uint8 [N, H, W, 3] frames directly and packs
// each texel in registers, so no separate packing pass runs.
//
// Bound: bytes. Per output pixel 8 B of coordinates are read and 16 B of
// corners written; each source texel is needed about once (3 B). Coordinate
// loads and corner stores are coalesced across a warp; the twelve byte loads of
// a pixel's texels hit L1/L2 lines that neighbouring threads share, since a
// warp's 32 pixels sample neighbouring texels.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "rgb_texel.cuh"

namespace {

using bbd::load_rgb;

__global__ void corner_sweep_u8_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py,
                                       int32_t* __restrict__ out,
                                       int64_t total, int H, int W, int64_t hw_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t n = t / hw_out;
  const int64_t r = t - n * hw_out;

  int x0 = (int)floorf(px[t]);
  int y0 = (int)floorf(py[t]);
  x0 = min(max(x0, 0), W - 1);
  y0 = min(max(y0, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);

  const uint8_t* img = frames + n * (int64_t)H * W * 3;
  const int64_t row0 = (int64_t)y0 * W;
  const int64_t row1 = (int64_t)y1 * W;
  int32_t* o = out + n * 4 * hw_out + r;
  o[0] = load_rgb(img, row0 + x0);
  o[hw_out] = load_rgb(img, row0 + x1);
  o[2 * hw_out] = load_rgb(img, row1 + x0);
  o[3 * hw_out] = load_rgb(img, row1 + x1);
}

}  // namespace

// frames: uint8 [N, H, W, 3]; px, py: float32 [N, Ho, Wo]; out: int32
// [N, 4, Ho, Wo]. All contiguous, on one device. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int bbd_corner_sweep_u8(const void* frames, const void* px, const void* py,
                                   void* out, long long N, int H, int W, int Ho, int Wo,
                                   void* stream) {
  if (!frames || !px || !py || !out || N < 0 || H <= 0 || W <= 0 || Ho < 0 || Wo < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t hw_out = (int64_t)Ho * Wo;
  const int64_t total = (int64_t)N * hw_out;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  corner_sweep_u8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)px, (const float*)py, (int32_t*)out,
      total, H, W, hw_out);
  return (int)cudaGetLastError();
}
