// Bilinear warp of float images, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels baseboostdepth_tpu/ops/warp_pallas.py::_fwd_kernel
// (pallas_call in _warp_planes_fwd) and ::_bwd_kernel (pallas_call in
// _warp_planes_bwd), the custom-VJP pair behind bilinear_sample_pallas: the
// warp of float sources (any channel count C), with one pair of pixel
// coordinates shared by the C channels of an image.
//
// Forward: for every output pixel (n, i, j) it reads the clamped pixel
// coordinates px, py, gathers the four bilinear corner texels of image n and
// writes the blended value of each channel to out[n, i, j, 0..C-1].
// Backward: from the same corners and the output cotangent g[n, i, j, 0..C-1]
// it writes the coordinate gradients, summed over the channels in channel
// order here rather than in a second pass (the TPU kernel writes one gradient
// plane per channel and _warp_planes_bwd sums them):
//   gpx = sum_c g_c ((1 - wy)(v01 - v00) + wy (v11 - v10))
//   gpy = sum_c g_c ((1 - wx)(v10 - v00) + wx (v11 - v01))
// The images get no gradient, as from the TPU kernel (its VJP returns None
// for the planes).
//
// Design. The TPU kernels take planar, edge-padded [N*C, Hp, Wp] copies
// (Hp >= H + 1, Wp >= W + 1) and sweep (8-row band) x (128-column block)
// tiles of them, because Mosaic cannot gather across (8 x 128) tiles. A GPU
// thread loads any address, so one thread per output pixel reads its four
// texels straight from the float32 [N, H, W, C] images: no transpose and no
// padded copy. Coordinates arrive clamped into [0, W-1] x [0, H-1], so
// min(x0 + 1, W - 1) and min(y0 + 1, H - 1) read what the edge-padded copy
// holds at x0 + 1 and y0 + 1. The blend is the TPU kernel's expression in its
// order (top, bot, top + (bot - top) * wy); with FMA contraction off
// (cuda_build.py) it equals the plain PyTorch version bit for bit.
//
// Bound: bytes. Forward per output pixel: 8 B of coordinates and 4C B of
// output, plus about 4C B of source texels (each needed about once);
// backward: 8 B of coordinates, 4C B of cotangent, 8 B of gradients, plus
// the texels. The coordinate, cotangent, gradient and output accesses are
// coalesced across a warp; the texel bytes come from L1/L2 lines that
// neighbouring pixels share. Flat offsets are 64-bit (156 x 192 x 640 x 3
// outputs at the late stage).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

struct Corners {
  const float* p00;
  const float* p01;
  const float* p10;
  const float* p11;
  float wx, wy;
};

__device__ __forceinline__ Corners locate_corners(const float* __restrict__ src, float fx,
                                                  float fy, int64_t n, int H, int W, int C) {
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  Corners k;
  k.wx = fx - x0f;
  k.wy = fy - y0f;
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const float* img = src + n * (int64_t)H * W * C;
  const int64_t row0 = (int64_t)y0 * W;
  const int64_t row1 = (int64_t)y1 * W;
  k.p00 = img + (row0 + x0) * C;
  k.p01 = img + (row0 + x1) * C;
  k.p10 = img + (row1 + x0) * C;
  k.p11 = img + (row1 + x1) * C;
  return k;
}

__global__ void warp_planes_fwd_kernel(const float* __restrict__ src,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py,
                                       float* __restrict__ out,
                                       int64_t total, int H, int W, int C, int64_t hw_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Corners k = locate_corners(src, px[t], py[t], t / hw_out, H, W, C);
  float* o = out + t * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(k.p00 + c);
    const float v01 = __ldg(k.p01 + c);
    const float v10 = __ldg(k.p10 + c);
    const float v11 = __ldg(k.p11 + c);
    const float top = v00 + (v01 - v00) * k.wx;
    const float bot = v10 + (v11 - v10) * k.wx;
    o[c] = top + (bot - top) * k.wy;
  }
}

__global__ void warp_planes_bwd_kernel(const float* __restrict__ src,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py,
                                       const float* __restrict__ g,
                                       float* __restrict__ gpx,
                                       float* __restrict__ gpy,
                                       int64_t total, int H, int W, int C, int64_t hw_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Corners k = locate_corners(src, px[t], py[t], t / hw_out, H, W, C);
  const float* gt = g + t * C;
  float ax = 0.0f;
  float ay = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(k.p00 + c);
    const float v01 = __ldg(k.p01 + c);
    const float v10 = __ldg(k.p10 + c);
    const float v11 = __ldg(k.p11 + c);
    const float gc = gt[c];
    ax = ax + gc * ((1.0f - k.wy) * (v01 - v00) + k.wy * (v11 - v10));
    ay = ay + gc * ((1.0f - k.wx) * (v10 - v00) + k.wx * (v11 - v01));
  }
  gpx[t] = ax;
  gpy[t] = ay;
}

int launch_config(long long N, int H, int W, int C, int Ho, int Wo, int64_t* total,
                  int64_t* hw_out, unsigned* blocks, int threads) {
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || Ho < 0 || Wo < 0) return (int)cudaErrorInvalidValue;
  *hw_out = (int64_t)Ho * Wo;
  *total = (int64_t)N * *hw_out;
  const int64_t b = (*total + threads - 1) / threads;
  if (b > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)b;
  return (int)cudaSuccess;
}

constexpr int kThreads = 256;

}  // namespace

// src: float32 [N, H, W, C]; px, py: float32 [N, Ho, Wo], clamped into the
// image; out: float32 [N, Ho, Wo, C]. All contiguous, on one device. Launches
// on `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int bbd_warp_planes_fwd(const void* src, const void* px, const void* py, void* out,
                                   long long N, int H, int W, int C, int Ho, int Wo,
                                   void* stream) {
  if (!src || !px || !py || !out) return (int)cudaErrorInvalidValue;
  int64_t total, hw_out;
  unsigned blocks;
  const int err = launch_config(N, H, W, C, Ho, Wo, &total, &hw_out, &blocks, kThreads);
  if (err != (int)cudaSuccess || total == 0) return err;
  warp_planes_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)px, (const float*)py, (float*)out, total, H, W, C, hw_out);
  return (int)cudaGetLastError();
}

// src, px, py as above; g: float32 [N, Ho, Wo, C]; gpx, gpy: float32
// [N, Ho, Wo]. Same contract as bbd_warp_planes_fwd.
extern "C" int bbd_warp_planes_bwd(const void* src, const void* px, const void* py,
                                   const void* g, void* gpx, void* gpy, long long N, int H, int W,
                                   int C, int Ho, int Wo, void* stream) {
  if (!src || !px || !py || !g || !gpx || !gpy) return (int)cudaErrorInvalidValue;
  int64_t total, hw_out;
  unsigned blocks;
  const int err = launch_config(N, H, W, C, Ho, Wo, &total, &hw_out, &blocks, kThreads);
  if (err != (int)cudaSuccess || total == 0) return err;
  warp_planes_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)px, (const float*)py, (const float*)g, (float*)gpx,
      (float*)gpy, total, H, W, C, hw_out);
  return (int)cudaGetLastError();
}
