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
// address, so none of that is carried over. Edge padding without a padded
// copy: see rgb_texel.cuh::gather_corners. Packing: the kernel reads the uint8
// [N, H, W, 3] frames directly and packs each texel in registers, so no
// separate packing pass runs.
//
// Bound: bytes. Per output pixel 8 B of coordinates are read and 16 B of
// corners written; each source texel is needed about once (3 B). What held the
// first version (one pixel a thread) back was the texel gather: twelve
// single-byte loads a pixel, each an L1 request of its own, and on a rough grid
// the 32 threads of a warp name about 32 cache lines a load. The design:
//   - a 3-D grid over (128-column tiles, 8-row bands, images): n and i come
//     from blockIdx, with no 64-bit division;
//   - four adjacent output pixels a thread: one 16-byte load of px and of py,
//     one 16-byte store per corner plane (scalar code for a width
//     that is not a multiple of 4 or coordinates off 16-byte alignment);
//   - each row's texel pair (x0, x0 + 1) from one or two aligned 8-byte loads
//     (rgb_texel.cuh::load_rgb_pair): 3-4 loads a pixel instead of 12.

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_chunks.cuh"
#include "rgb_texel.cuh"

namespace {

using bbd::gather_corners;

constexpr int kCols = 128;  // output columns of a block: 32 threads x 4
constexpr int kRows = 8;    // output rows of a block

template <bool kVec>
__global__ void __launch_bounds__(32 * kRows)
    corner_sweep_u8_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ px,
                           const float* __restrict__ py, int32_t* __restrict__ out, int H, int W,
                           int Ho, int Wo, const uint8_t* __restrict__ frames_end) {
  const int n = blockIdx.z;
  const int i = blockIdx.y * kRows + threadIdx.y;
  const int j = blockIdx.x * kCols + threadIdx.x * 4;
  if (i >= Ho || j >= Wo) return;
  const int count = min(4, Wo - j);
  const int64_t plane = (int64_t)Ho * Wo;
  const int64_t at = (int64_t)n * plane + (int64_t)i * Wo + j;
  const uint8_t* img = frames + (int64_t)n * H * W * 3;

  float fx[4], fy[4];
  if (kVec) {
    const float4 x4 = __ldg(reinterpret_cast<const float4*>(px + at));
    const float4 y4 = __ldg(reinterpret_cast<const float4*>(py + at));
    fx[0] = x4.x; fx[1] = x4.y; fx[2] = x4.z; fx[3] = x4.w;
    fy[0] = y4.x; fy[1] = y4.y; fy[2] = y4.z; fy[3] = y4.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fx[k] = k < count ? px[at + k] : 0.0f;
      fy[k] = k < count ? py[at + k] : 0.0f;
    }
  }
  int32_t c[4][4];  // [corner][pixel]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (kVec || k < count)
      gather_corners(img, fx[k], fy[k], H, W, frames, frames_end, c[0][k], c[1][k], c[2][k],
                     c[3][k]);
  }
  int32_t* o = out + (int64_t)n * 3 * plane + at;  // out[n, 0, i, j]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (kVec) {
      *reinterpret_cast<int4*>(o + q * plane) = make_int4(c[q][0], c[q][1], c[q][2], c[q][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < count) o[q * plane + k] = c[q][k];
    }
  }
}

}  // namespace

// frames: uint8 [N, H, W, 3]; px, py: float32 [N, Ho, Wo]; out: int32
// [N, 4, Ho, Wo]. All contiguous, on one device; frames may start at any
// byte. Any N; Ho up to 524,280 rows ((Ho + 7) / 8 <= 65,535 bands on the
// grid's y axis). Launches on `stream`, once per chunk of at most 65,535
// images (image_chunks.cuh), and returns the first launch's cudaError_t that
// is not 0 (0 on success); does not synchronise.
//
// The 16-byte path is chosen once, on the whole tensors: it needs Wo % 4 == 0
// and px, py, out 16-byte aligned, and then every chunk's start keeps that
// alignment (a chunk of px or py is 65,535 Ho Wo floats, one of out four times
// that: multiples of 4 floats). A chunk of frames (65,535 H W 3 bytes) may
// start at any byte: the texel fetch aligns on absolute addresses and reads
// byte by byte where a word would leave the chunk.
extern "C" int bbd_corner_sweep_u8(const void* frames, const void* px, const void* py,
                                   void* out, long long N, int H, int W, int Ho, int Wo,
                                   void* stream) {
  if (!frames || !px || !py || !out || N < 0 || H <= 0 || W <= 0 || Ho < 0 || Wo < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || Ho == 0 || Wo == 0) return (int)cudaSuccess;
  if ((Ho + kRows - 1) / kRows > 65535) return (int)cudaErrorInvalidConfiguration;
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* x = static_cast<const float*>(px);
  const auto* y = static_cast<const float*>(py);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = Wo % 4 == 0 && ((uintptr_t)px | (uintptr_t)py | (uintptr_t)out) % 16 == 0;
  const int64_t frame = (int64_t)H * W * 3;
  const int64_t plane = (int64_t)Ho * Wo;
  const dim3 block(32, kRows);
  return bbd::launch_image_chunks(N, [&](long long n0, unsigned count) {
    const dim3 grid((Wo + kCols - 1) / kCols, (Ho + kRows - 1) / kRows, count);
    const uint8_t* fc = f + n0 * frame;
    const float* xc = x + n0 * plane;
    const float* yc = y + n0 * plane;
    int32_t* oc = o + n0 * 4 * plane;
    if (vec)
      corner_sweep_u8_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          fc, xc, yc, oc, H, W, Ho, Wo, fc + count * frame);
    else
      corner_sweep_u8_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          fc, xc, yc, oc, H, W, Ho, Wo, fc + count * frame);
  });
}
