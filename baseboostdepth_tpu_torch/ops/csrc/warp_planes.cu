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
// The TPU kernels take planar, edge-padded [N*C, Hp, Wp] copies and sweep
// (8-row band) x (128-column block) tiles of them, because Mosaic cannot
// gather across (8 x 128) tiles. A GPU thread loads any address, so the
// kernels read the texels straight from the float32 [N, H, W, C] images: no
// transpose and no padded copy. Coordinates arrive clamped into
// [0, W-1] x [0, H-1], so min(x0 + 1, W - 1) and min(y0 + 1, H - 1) read what
// the edge-padded copy holds at x0 + 1 and y0 + 1. The blend is the TPU
// kernel's expression in its order (top, bot, top + (bot - top) * wy); with
// FMA contraction off (cuda_build.py) both kernels equal their plain PyTorch
// versions bit for bit.
//
// Bound: bytes. Forward per output pixel: 8 B of coordinates and 4C B of
// output, plus the distinct source texels the grid names (4C B each, about
// one a pixel on a rough grid); backward: 8 B of coordinates, 4C B of
// cotangent and 8 B of gradients, plus the texels. The first version (one
// pixel a thread on a flat grid) reached a third to a half of that: each
// pixel issued 4C scalar texel loads, and on a rough grid the 32 threads of
// a warp name about 32 cache lines per load, so L1 requests, not bytes, set
// the pace (as for the uint8 pair, corner_sweep.cu). The design, that of
// corner_sweep.cu and warp_packed.cu:
//   - a 3-D grid over (128-column tiles, row bands, images): n and i come
//     from blockIdx, with no 64-bit division; images beyond 65,535 go to
//     further launches (image_chunks.cuh). Bands are 16 rows in the forward
//     and 8 in the backward. A float texel is 12 B, so on a rough grid the
//     lines a block names (its rows plus the vertical reach, times its
//     columns plus the horizontal reach) fill L1 before the bytes bound: a
//     taller block shares the reach over more rows. On the step grids, whose
//     pixels read near their own position, the shorter block is a little
//     faster (more blocks in flight); 16 rows suit the forward and 8 the
//     backward across the grids timed (PERF.md, §6);
//   - four adjacent output pixels a thread. For C = 3 (RGB) with Wo % 4 == 0
//     and 16-byte aligned coordinates and outputs: one 16-byte load each of
//     px and py, three 16-byte stores of the 12 output floats (forward) or
//     three 16-byte loads of the cotangent and one 16-byte store each of
//     gpx and gpy (backward);
//   - for C = 3, each row's texel pair (x0, x0 + 1), 24 contiguous bytes,
//     from aligned words (load_rgb_pair): two 16-byte loads when the pair
//     starts at float 0-2 of its 16-byte word, three at float 3, spliced
//     with selects; 4.5 loads a pixel on average instead of 12. The words
//     align on the absolute address, so an image off 16-byte alignment takes
//     the same path; where a word would leave the chunk of images (x0 = W-1
//     on the last row of the last image, or a start off alignment), the
//     pair is read with scalar loads. 8-byte words (three or four a row)
//     were timed too and were slower on every grid (PERF.md, §6);
//   - every other case (C != 3, Wo % 4 != 0, coordinates, outputs or
//     cotangent off 16-byte alignment) runs the same kernel's scalar
//     instantiation: runtime C, one coordinate, texel and output access per
//     element, four pixels a thread.
// Each pixel is fetched and blended in turn, so the registers hold one
// pixel's texels at a time (ptxas: see chip_smoke.py's build report).

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_chunks.cuh"

namespace {

constexpr int kCols = 128;    // output columns of a block: 32 threads x 4
constexpr int kFwdRows = 16;  // output rows of a forward block
constexpr int kBwdRows = 8;   // output rows of a backward block

// One output pixel's corners: the float offsets in its image of texels
// (y0, x0) and (y1, x0), whether x1 == x0 (x0 at the last column), and the
// weights. x0 = floor(fx), y0 = floor(fy), clamped into the image, which
// changes nothing for clamped coordinates and keeps every read in bounds.
struct Corners {
  int64_t row0, row1;
  bool same;
  float wx, wy;
};

__device__ __forceinline__ Corners locate(float fx, float fy, int H, int W, int C) {
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  Corners k;
  k.wx = fx - x0f;
  k.wy = fy - y0f;
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int y1 = min(y0 + 1, H - 1);
  k.same = x0 == W - 1;
  k.row0 = ((int64_t)y0 * W + x0) * C;
  k.row1 = ((int64_t)y1 * W + x0) * C;
  return k;
}

// The RGB texels at p (x0) and p + 3 (x0 + 1) into a and b, or the texel at
// p twice when `same`. [begin, end) are the floats of the launch's chunk of
// images; where the aligned words would reach outside it, scalar loads.
__device__ __forceinline__ void load_rgb_pair(const float* p, bool same,
                                              const float* __restrict__ begin,
                                              const float* __restrict__ end, float (&a)[3],
                                              float (&b)[3]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uintptr_t word = addr & ~static_cast<uintptr_t>(15);
  const unsigned s = static_cast<unsigned>(addr >> 2) & 3;  // float phase in the word
  const uintptr_t bytes = s == 3 ? 48 : 32;
  if (word < reinterpret_cast<uintptr_t>(begin) ||
      word + bytes > reinterpret_cast<uintptr_t>(end)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = __ldg(p + c);
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c] = same ? a[c] : __ldg(p + 3 + c);
    return;
  }
  float f[6];  // floats p[0 .. 5]
  const float4* w = reinterpret_cast<const float4*>(word);
  const float4 w0 = __ldg(w);
  const float4 w1 = __ldg(w + 1);
  const float4 w2 = s == 3 ? __ldg(w + 2) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float e[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
  float h[8];  // e shifted by 2 (s & 2), then by 1 (s & 1)
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = (s & 2) ? e[q + 2] : e[q];
#pragma unroll
  for (int q = 0; q < 6; ++q) f[q] = (s & 1) ? h[q + 1] : h[q];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = f[c];
    b[c] = same ? f[c] : f[3 + c];
  }
}

// The four RGB corner texels of one pixel of image `img`; row y1 is read
// only when it is not row y0 (y0 at the last row).
__device__ __forceinline__ void load_rgb_corners(const float* img, const Corners& q,
                                                 const float* __restrict__ begin,
                                                 const float* __restrict__ end, float (&v00)[3],
                                                 float (&v01)[3], float (&v10)[3],
                                                 float (&v11)[3]) {
  load_rgb_pair(img + q.row0, q.same, begin, end, v00, v01);
  if (q.row1 != q.row0) {
    load_rgb_pair(img + q.row1, q.same, begin, end, v10, v11);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v10[c] = v00[c];
      v11[c] = v01[c];
    }
  }
}

// The four pixels' coordinates at flat output index `at`: one 16-byte load
// each on the RGB path, else `count` scalar loads (0 past the row's end).
template <bool kRgb>
__device__ __forceinline__ void load_coords(const float* __restrict__ px,
                                            const float* __restrict__ py, int64_t at, int count,
                                            float (&fx)[4], float (&fy)[4]) {
  if (kRgb) {
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
}

// The TPU kernel's blend of one channel: top, bot, top + (bot - top) * wy.
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11, float wx,
                                       float wy) {
  const float top = v00 + (v01 - v00) * wx;
  const float bot = v10 + (v11 - v10) * wx;
  return top + (bot - top) * wy;
}

// kRgb: C == 3 with 16-byte coordinate and output accesses; else runtime C.
template <bool kRgb>
__global__ void __launch_bounds__(32 * kFwdRows)
    warp_planes_fwd_kernel(const float* __restrict__ src, const float* __restrict__ px,
                           const float* __restrict__ py, float* __restrict__ out, int H, int W,
                           int C, int Ho, int Wo, const float* __restrict__ src_end) {
  const int n = blockIdx.z;
  const int i = blockIdx.y * kFwdRows + threadIdx.y;
  const int j = blockIdx.x * kCols + threadIdx.x * 4;
  if (i >= Ho || j >= Wo) return;
  const int count = min(4, Wo - j);
  const int64_t at = ((int64_t)n * Ho + i) * Wo + j;
  float fx[4], fy[4];
  load_coords<kRgb>(px, py, at, count, fx, fy);
  if (kRgb) {
    const float* img = src + (int64_t)n * H * W * 3;
    float v[12];  // the four pixels' RGB, in output order
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Corners q = locate(fx[k], fy[k], H, W, 3);
      float v00[3], v01[3], v10[3], v11[3];
      load_rgb_corners(img, q, src, src_end, v00, v01, v10, v11);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * k + c] = blend(v00[c], v01[c], v10[c], v11[c], q.wx, q.wy);
    }
    float4* o4 = reinterpret_cast<float4*>(out + at * 3);
    o4[0] = make_float4(v[0], v[1], v[2], v[3]);
    o4[1] = make_float4(v[4], v[5], v[6], v[7]);
    o4[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
    const float* img = src + (int64_t)n * H * W * C;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= count) break;
      const Corners q = locate(fx[k], fy[k], H, W, C);
      const float* p0 = img + q.row0;
      const float* p1 = img + q.row1;
      const int dx = q.same ? 0 : C;
      float* o = out + (at + k) * C;
      for (int c = 0; c < C; ++c)
        o[c] = blend(__ldg(p0 + c), __ldg(p0 + dx + c), __ldg(p1 + c), __ldg(p1 + dx + c), q.wx,
                     q.wy);
    }
  }
}

template <bool kRgb>
__global__ void __launch_bounds__(32 * kBwdRows)
    warp_planes_bwd_kernel(const float* __restrict__ src, const float* __restrict__ px,
                           const float* __restrict__ py, const float* __restrict__ g,
                           float* __restrict__ gpx, float* __restrict__ gpy, int H, int W, int C,
                           int Ho, int Wo, const float* __restrict__ src_end) {
  const int n = blockIdx.z;
  const int i = blockIdx.y * kBwdRows + threadIdx.y;
  const int j = blockIdx.x * kCols + threadIdx.x * 4;
  if (i >= Ho || j >= Wo) return;
  const int count = min(4, Wo - j);
  const int64_t at = ((int64_t)n * Ho + i) * Wo + j;
  float fx[4], fy[4];
  load_coords<kRgb>(px, py, at, count, fx, fy);
  if (kRgb) {
    const float* img = src + (int64_t)n * H * W * 3;
    float ax[4], ay[4];
    const float4* g4 = reinterpret_cast<const float4*>(g + at * 3);
    const float4 ga = __ldg(g4), gb = __ldg(g4 + 1), gc = __ldg(g4 + 2);
    const float gv[12] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w, gc.x, gc.y, gc.z, gc.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Corners q = locate(fx[k], fy[k], H, W, 3);
      float v00[3], v01[3], v10[3], v11[3];
      load_rgb_corners(img, q, src, src_end, v00, v01, v10, v11);
      float sx = 0.0f;
      float sy = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gk = gv[3 * k + c];
        sx = sx + gk * ((1.0f - q.wy) * (v01[c] - v00[c]) + q.wy * (v11[c] - v10[c]));
        sy = sy + gk * ((1.0f - q.wx) * (v10[c] - v00[c]) + q.wx * (v11[c] - v01[c]));
      }
      ax[k] = sx;
      ay[k] = sy;
    }
    *reinterpret_cast<float4*>(gpx + at) = make_float4(ax[0], ax[1], ax[2], ax[3]);
    *reinterpret_cast<float4*>(gpy + at) = make_float4(ay[0], ay[1], ay[2], ay[3]);
  } else {
    const float* img = src + (int64_t)n * H * W * C;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= count) break;
      const Corners q = locate(fx[k], fy[k], H, W, C);
      const float* p0 = img + q.row0;
      const float* p1 = img + q.row1;
      const int dx = q.same ? 0 : C;
      const float* gt = g + (at + k) * C;
      float sx = 0.0f;
      float sy = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float v00 = __ldg(p0 + c);
        const float v01 = __ldg(p0 + dx + c);
        const float v10 = __ldg(p1 + c);
        const float v11 = __ldg(p1 + dx + c);
        const float gk = gt[c];
        sx = sx + gk * ((1.0f - q.wy) * (v01 - v00) + q.wy * (v11 - v10));
        sy = sy + gk * ((1.0f - q.wx) * (v10 - v00) + q.wx * (v11 - v01));
      }
      gpx[at + k] = sx;
      gpy[at + k] = sy;
    }
  }
}

bool valid_shape(long long N, int H, int W, int C, int Ho, int Wo) {
  return N >= 0 && H > 0 && W > 0 && C > 0 && Ho >= 0 && Wo >= 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// src: float32 [N, H, W, C]; px, py: float32 [N, Ho, Wo], clamped into the
// image; out: float32 [N, Ho, Wo, C]. All contiguous, on one device. Any N;
// Ho up to 1,048,560 rows ((Ho + 15) / 16 <= 65,535 bands on the grid's y
// axis; the backward's 8-row bands allow 524,280). Launches on `stream`,
// once per chunk of at most 65,535 images (image_chunks.cuh), and returns the
// first launch's cudaError_t that is not 0 (0 on success); does not
// synchronise.
//
// The RGB path is chosen once, on the whole tensors: C == 3, Wo % 4 == 0 and
// px, py, out 16-byte aligned. It then holds for every chunk's start (a chunk
// of px or py is 65,535 Ho Wo floats, one of out three times that: multiples
// of 4 floats). A chunk of src (65,535 H W 3 floats) may start off 16-byte
// alignment: the texel fetch aligns on absolute addresses and falls back to
// scalar loads at the chunk's ends.
extern "C" int bbd_warp_planes_fwd(const void* src, const void* px, const void* py, void* out,
                                   long long N, int H, int W, int C, int Ho, int Wo,
                                   void* stream) {
  if (!src || !px || !py || !out || !valid_shape(N, H, W, C, Ho, Wo))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || Ho == 0 || Wo == 0) return (int)cudaSuccess;
  if ((Ho + kFwdRows - 1) / kFwdRows > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool rgb = C == 3 && Wo % 4 == 0 && aligned16(px) && aligned16(py) && aligned16(out);
  const int64_t image = (int64_t)H * W * C;
  const int64_t plane = (int64_t)Ho * Wo;
  const dim3 block(32, kFwdRows);
  return bbd::launch_image_chunks(N, [&](long long n0, unsigned count) {
    const dim3 grid((Wo + kCols - 1) / kCols, (Ho + kFwdRows - 1) / kFwdRows, count);
    const float* s = static_cast<const float*>(src) + n0 * image;
    const float* x = static_cast<const float*>(px) + n0 * plane;
    const float* y = static_cast<const float*>(py) + n0 * plane;
    float* o = static_cast<float*>(out) + n0 * plane * C;
    if (rgb)
      warp_planes_fwd_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          s, x, y, o, H, W, C, Ho, Wo, s + count * image);
    else
      warp_planes_fwd_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          s, x, y, o, H, W, C, Ho, Wo, s + count * image);
  });
}

// src, px, py as above; g: float32 [N, Ho, Wo, C]; gpx, gpy: float32
// [N, Ho, Wo]. Same contract as bbd_warp_planes_fwd; the RGB path also needs
// g, gpx and gpy 16-byte aligned.
extern "C" int bbd_warp_planes_bwd(const void* src, const void* px, const void* py,
                                   const void* g, void* gpx, void* gpy, long long N, int H, int W,
                                   int C, int Ho, int Wo, void* stream) {
  if (!src || !px || !py || !g || !gpx || !gpy || !valid_shape(N, H, W, C, Ho, Wo))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || Ho == 0 || Wo == 0) return (int)cudaSuccess;
  if ((Ho + kBwdRows - 1) / kBwdRows > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool rgb = C == 3 && Wo % 4 == 0 && aligned16(px) && aligned16(py) && aligned16(g) &&
                   aligned16(gpx) && aligned16(gpy);
  const int64_t image = (int64_t)H * W * C;
  const int64_t plane = (int64_t)Ho * Wo;
  const dim3 block(32, kBwdRows);
  return bbd::launch_image_chunks(N, [&](long long n0, unsigned count) {
    const dim3 grid((Wo + kCols - 1) / kCols, (Ho + kBwdRows - 1) / kBwdRows, count);
    const float* s = static_cast<const float*>(src) + n0 * image;
    const float* x = static_cast<const float*>(px) + n0 * plane;
    const float* y = static_cast<const float*>(py) + n0 * plane;
    const float* gc = static_cast<const float*>(g) + n0 * plane * C;
    float* ox = static_cast<float*>(gpx) + n0 * plane;
    float* oy = static_cast<float*>(gpy) + n0 * plane;
    if (rgb)
      warp_planes_bwd_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          s, x, y, gc, ox, oy, H, W, C, Ho, Wo, s + count * image);
    else
      warp_planes_bwd_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          s, x, y, gc, ox, oy, H, W, C, Ho, Wo, s + count * image);
  });
}
