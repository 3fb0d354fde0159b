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
// (8 x 128) tiles; a GPU thread loads any address, so the kernels read the
// four texels of a pixel directly from the uint8 [N, H, W, 3] frames
// (rgb_texel.cuh::gather_corners), with no packing pass and no padded copy.
// The output keeps the public layout [N, Ho, Wo, 3]; the TPU's planar
// [N, 3, Ho, Wo] would cost a transpose pass. The blend is the TPU kernel's
// expression in its order (top, bot, top + (bot - top) * wy); with FMA
// contraction off (cuda_build.py) it equals the plain PyTorch version bit for
// bit.
//
// Bound: bytes. Forward per output pixel: 8 B of coordinates and 12 B of
// output, plus about 3 B of source texels (each needed about once);
// backward: 8 B of coordinates, 12 B of cotangent, 8 B of gradients, plus the
// texels. The forward is laid out as corner_sweep.cu is, for the same reason
// (its texel gather, twelve byte loads a pixel, held the first version back):
// a 3-D grid over (128-column tiles, 8-row bands, images), four adjacent
// output pixels a thread with 16-byte coordinate loads and three 16-byte
// stores of their 12 floats, and each row's texel pair from one or
// two aligned 8-byte loads. The backward keeps one pixel a thread on a flat
// grid (it reaches about half its bound) and shares that texel fetch. Flat
// offsets are 64-bit (156 x 192 x 640 outputs at the late stage).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "image_chunks.cuh"
#include "rgb_texel.cuh"

namespace {

using bbd::gather_corners;
using bbd::unpack_channel;

constexpr int kCols = 128;  // forward: output columns of a block, 32 threads x 4
constexpr int kRows = 8;    // forward: output rows of a block

// The TPU kernel's blend of one channel: top, bot, top + (bot - top) * wy.
__device__ __forceinline__ float blend(int32_t c00, int32_t c01, int32_t c10, int32_t c11,
                                       float wx, float wy, int c) {
  const float v00 = unpack_channel(c00, c);
  const float v01 = unpack_channel(c01, c);
  const float v10 = unpack_channel(c10, c);
  const float v11 = unpack_channel(c11, c);
  const float top = v00 + (v01 - v00) * wx;
  const float bot = v10 + (v11 - v10) * wx;
  return top + (bot - top) * wy;
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kRows)
    warp_packed_fwd_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ px,
                           const float* __restrict__ py, float* __restrict__ out, int H, int W,
                           int Ho, int Wo, const uint8_t* __restrict__ frames_end) {
  const int n = blockIdx.z;
  const int i = blockIdx.y * kRows + threadIdx.y;
  const int j = blockIdx.x * kCols + threadIdx.x * 4;
  if (i >= Ho || j >= Wo) return;
  const int count = min(4, Wo - j);
  const int64_t at = ((int64_t)n * Ho + i) * Wo + j;
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
  float v[12];  // the four pixels' RGB, in output order
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (kVec || k < count) {
      int32_t c00, c01, c10, c11;
      gather_corners(img, fx[k], fy[k], H, W, frames, frames_end, c00, c01, c10, c11);
      const float wx = fx[k] - floorf(fx[k]);
      const float wy = fy[k] - floorf(fy[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * k + c] = blend(c00, c01, c10, c11, wx, wy, c);
    }
  }
  float* o = out + at * 3;
  if (kVec) {
    float4* o4 = reinterpret_cast<float4*>(o);
    o4[0] = make_float4(v[0], v[1], v[2], v[3]);
    o4[1] = make_float4(v[4], v[5], v[6], v[7]);
    o4[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
#pragma unroll
    for (int e = 0; e < 12; ++e)
      if (e < 3 * count) o[e] = v[e];
  }
}

__global__ void warp_packed_bwd_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ px,
                                       const float* __restrict__ py,
                                       const float* __restrict__ g,
                                       float* __restrict__ gpx,
                                       float* __restrict__ gpy,
                                       int64_t total, int H, int W, int64_t hw_out,
                                       const uint8_t* __restrict__ frames_end) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const float fx = px[t];
  const float fy = py[t];
  int32_t c00, c01, c10, c11;
  gather_corners(frames + (t / hw_out) * (int64_t)H * W * 3, fx, fy, H, W, frames, frames_end,
                 c00, c01, c10, c11);
  const float wx = fx - floorf(fx);
  const float wy = fy - floorf(fy);
  const float* gt = g + t * 3;
  float ax = 0.0f;
  float ay = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = unpack_channel(c00, c);
    const float v01 = unpack_channel(c01, c);
    const float v10 = unpack_channel(c10, c);
    const float v11 = unpack_channel(c11, c);
    const float gc = gt[c];
    ax = ax + gc * ((1.0f - wy) * (v01 - v00) + wy * (v11 - v10));
    ay = ay + gc * ((1.0f - wx) * (v10 - v00) + wx * (v11 - v01));
  }
  gpx[t] = ax;
  gpy[t] = ay;
}

bool valid_shape(long long N, int H, int W, int Ho, int Wo) {
  return N >= 0 && H > 0 && W > 0 && Ho >= 0 && Wo >= 0;
}

constexpr int kThreads = 256;  // backward

}  // namespace

// frames: uint8 [N, H, W, 3]; px, py: float32 [N, Ho, Wo]; out: float32
// [N, Ho, Wo, 3]. All contiguous, on one device; frames may start at any
// byte. Any N; Ho up to 524,280 rows ((Ho + 7) / 8 <= 65,535 bands on the
// grid's y axis). Launches on `stream`, once per chunk of at most 65,535
// images (image_chunks.cuh), and returns the first launch's cudaError_t that
// is not 0 (0 on success); does not synchronise. The 16-byte path is chosen
// once, on the whole tensors, and holds for every chunk's start, as in
// corner_sweep.cu (a chunk of px, py or out is a multiple of 4 floats when
// Wo % 4 == 0; frames may start at any byte).
extern "C" int bbd_warp_packed_fwd(const void* frames, const void* px, const void* py, void* out,
                                   long long N, int H, int W, int Ho, int Wo, void* stream) {
  if (!frames || !px || !py || !out || !valid_shape(N, H, W, Ho, Wo))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || Ho == 0 || Wo == 0) return (int)cudaSuccess;
  if ((Ho + kRows - 1) / kRows > 65535) return (int)cudaErrorInvalidConfiguration;
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* x = static_cast<const float*>(px);
  const auto* y = static_cast<const float*>(py);
  auto* o = static_cast<float*>(out);
  const bool vec = Wo % 4 == 0 && ((uintptr_t)px | (uintptr_t)py | (uintptr_t)out) % 16 == 0;
  const int64_t frame = (int64_t)H * W * 3;
  const int64_t plane = (int64_t)Ho * Wo;
  const dim3 block(32, kRows);
  return bbd::launch_image_chunks(N, [&](long long n0, unsigned count) {
    const dim3 grid((Wo + kCols - 1) / kCols, (Ho + kRows - 1) / kRows, count);
    const uint8_t* fc = f + n0 * frame;
    const float* xc = x + n0 * plane;
    const float* yc = y + n0 * plane;
    float* oc = o + n0 * plane * 3;
    if (vec)
      warp_packed_fwd_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          fc, xc, yc, oc, H, W, Ho, Wo, fc + count * frame);
    else
      warp_packed_fwd_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          fc, xc, yc, oc, H, W, Ho, Wo, fc + count * frame);
  });
}

// frames, px, py as above; g: float32 [N, Ho, Wo, 3]; gpx, gpy: float32
// [N, Ho, Wo]. Same contract as bbd_warp_packed_fwd.
extern "C" int bbd_warp_packed_bwd(const void* frames, const void* px, const void* py,
                                   const void* g, void* gpx, void* gpy, long long N, int H, int W,
                                   int Ho, int Wo, void* stream) {
  if (!frames || !px || !py || !g || !gpx || !gpy || !valid_shape(N, H, W, Ho, Wo))
    return (int)cudaErrorInvalidValue;
  const int64_t hw_out = (int64_t)Ho * Wo;
  const int64_t total = (int64_t)N * hw_out;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const auto* f = static_cast<const uint8_t*>(frames);
  warp_packed_bwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      f, (const float*)px, (const float*)py, (const float*)g, (float*)gpx, (float*)gpy, total, H,
      W, hw_out, f + N * H * W * 3);
  return (int)cudaGetLastError();
}
