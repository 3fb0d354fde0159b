// Packed-uint8 bilinear warp, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels baseboostdepth_tpu/ops/warp_pallas.py::
// _fwd_kernel_packed (pallas_call in _warp_packed_fwd) and
// ::_bwd_kernel_packed (pallas_call in _warp_packed_bwd), the custom-VJP pair
// behind bilinear_sample_pallas_u8.
//
// Forward: for every output pixel (n, i, j) it reads the clamped pixel
// coordinates px, py, gathers the four bilinear corner texels of frame n and
// writes the blended RGB value, float32 in [0, 1], to out[n, i, j, 0..2].
// Backward: from the same corners and the output cotangent g[n, i, j, 0..2] it
// writes the coordinate gradients, summed over the three channels here rather
// than in a second pass:
//   gpx = sum_c g_c ((1 - wy)(v01 - v00) + wy (v11 - v10))
//   gpy = sum_c g_c ((1 - wx)(v10 - v00) + wx (v11 - v01))
// The frames are training data and get no gradient.
//
// Design. The TPU kernels sweep (8-row band) x (128-column block) tiles of a
// packed, edge-padded copy of the frames because Mosaic cannot gather across
// (8 x 128) tiles; a GPU thread loads any address, so one thread per output
// pixel reads its four texels directly from the uint8 [N, H, W, 3] frames
// (rgb_texel.cuh), with no packing pass and no padded copy: coordinates arrive
// clamped, so min(x0 + 1, W - 1) and min(y0 + 1, H - 1) give the padded copy's
// texels (see corner_sweep.cu). The output keeps the public layout
// [N, Ho, Wo, 3]; the TPU's planar [N, 3, Ho, Wo] would cost a transpose pass.
// The blend is the TPU kernel's expression in its order (top, bot,
// top + (bot - top) * wy); with FMA contraction off (cuda_build.py) it equals
// the plain PyTorch version bit for bit.
//
// Bound: bytes. Forward per output pixel: 8 B of coordinates and 12 B of
// output, plus about 3 B of source texels (each needed about once);
// backward: 8 B of coordinates, 12 B of cotangent, 8 B of gradients, plus the
// texels. The coordinate, cotangent and gradient accesses are coalesced
// across a warp; the texel bytes come from L1/L2 lines that neighbouring
// pixels share. Flat offsets are 64-bit (156 x 192 x 640 outputs at the late
// stage).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "rgb_texel.cuh"

namespace {

using bbd::load_rgb;
using bbd::unpack_channel;

struct Corners {
  int32_t c00, c01, c10, c11;
  float wx, wy;
};

__device__ __forceinline__ Corners gather_corners(const uint8_t* __restrict__ frames, float fx,
                                                  float fy, int64_t n, int H, int W) {
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  Corners k;
  k.wx = fx - x0f;
  k.wy = fy - y0f;
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const uint8_t* img = frames + n * (int64_t)H * W * 3;
  const int64_t row0 = (int64_t)y0 * W;
  const int64_t row1 = (int64_t)y1 * W;
  k.c00 = load_rgb(img, row0 + x0);
  k.c01 = load_rgb(img, row0 + x1);
  k.c10 = load_rgb(img, row1 + x0);
  k.c11 = load_rgb(img, row1 + x1);
  return k;
}

__global__ void warp_packed_fwd_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py,
                                       float* __restrict__ out,
                                       int64_t total, int H, int W, int64_t hw_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Corners k = gather_corners(frames, px[t], py[t], t / hw_out, H, W);
  float* o = out + t * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = unpack_channel(k.c00, c);
    const float v01 = unpack_channel(k.c01, c);
    const float v10 = unpack_channel(k.c10, c);
    const float v11 = unpack_channel(k.c11, c);
    const float top = v00 + (v01 - v00) * k.wx;
    const float bot = v10 + (v11 - v10) * k.wx;
    o[c] = top + (bot - top) * k.wy;
  }
}

__global__ void warp_packed_bwd_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py,
                                       const float* __restrict__ g,
                                       float* __restrict__ gpx,
                                       float* __restrict__ gpy,
                                       int64_t total, int H, int W, int64_t hw_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Corners k = gather_corners(frames, px[t], py[t], t / hw_out, H, W);
  const float* gt = g + t * 3;
  float ax = 0.0f;
  float ay = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = unpack_channel(k.c00, c);
    const float v01 = unpack_channel(k.c01, c);
    const float v10 = unpack_channel(k.c10, c);
    const float v11 = unpack_channel(k.c11, c);
    const float gc = gt[c];
    ax = ax + gc * ((1.0f - k.wy) * (v01 - v00) + k.wy * (v11 - v10));
    ay = ay + gc * ((1.0f - k.wx) * (v10 - v00) + k.wx * (v11 - v01));
  }
  gpx[t] = ax;
  gpy[t] = ay;
}

int launch_config(long long N, int H, int W, int Ho, int Wo, int64_t* total, int64_t* hw_out,
                  unsigned* blocks, int threads) {
  if (N < 0 || H <= 0 || W <= 0 || Ho < 0 || Wo < 0) return (int)cudaErrorInvalidValue;
  *hw_out = (int64_t)Ho * Wo;
  *total = (int64_t)N * *hw_out;
  const int64_t b = (*total + threads - 1) / threads;
  if (b > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)b;
  return (int)cudaSuccess;
}

constexpr int kThreads = 256;

}  // namespace

// frames: uint8 [N, H, W, 3]; px, py: float32 [N, Ho, Wo]; out: float32
// [N, Ho, Wo, 3]. All contiguous, on one device. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int bbd_warp_packed_fwd(const void* frames, const void* px, const void* py, void* out,
                                   long long N, int H, int W, int Ho, int Wo, void* stream) {
  if (!frames || !px || !py || !out) return (int)cudaErrorInvalidValue;
  int64_t total, hw_out;
  unsigned blocks;
  const int err = launch_config(N, H, W, Ho, Wo, &total, &hw_out, &blocks, kThreads);
  if (err != (int)cudaSuccess || total == 0) return err;
  warp_packed_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)px, (const float*)py, (float*)out, total, H, W,
      hw_out);
  return (int)cudaGetLastError();
}

// frames, px, py as above; g: float32 [N, Ho, Wo, 3]; gpx, gpy: float32
// [N, Ho, Wo]. Same contract as bbd_warp_packed_fwd.
extern "C" int bbd_warp_packed_bwd(const void* frames, const void* px, const void* py,
                                   const void* g, void* gpx, void* gpy, long long N, int H, int W,
                                   int Ho, int Wo, void* stream) {
  if (!frames || !px || !py || !g || !gpx || !gpy) return (int)cudaErrorInvalidValue;
  int64_t total, hw_out;
  unsigned blocks;
  const int err = launch_config(N, H, W, Ho, Wo, &total, &hw_out, &blocks, kThreads);
  if (err != (int)cudaSuccess || total == 0) return err;
  warp_packed_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)px, (const float*)py, (const float*)g, (float*)gpx,
      (float*)gpy, total, H, W, hw_out);
  return (int)cudaGetLastError();
}
