// Texel access shared by the uint8 RGB warp kernels (corner_sweep.cu,
// warp_packed.cu): the two horizontally adjacent RGB texels a bilinear row
// needs, each as a packed word R | G << 8 | B << 16 (the layout of the JAX
// package's pack_rgb), and one channel of such a word as a float in [0, 1].

#pragma once

#include <stdint.h>

namespace bbd {

// The texels at p (x0) and p + 3 (x0 + 1) of a uint8 [H, W, 3] frame, or the
// texel at p twice when `same` (x0 + 1 clamped back onto x0 at the last
// column). The six bytes p .. p + 5 lie in one or two aligned 8-byte words:
// one 8-byte load when p sits at byte 0-2 of its word, two otherwise (3-4
// loads a bilinear pixel instead of 12 byte loads), spliced with funnel
// shifts. [begin, end) are the bytes of the whole frames tensor: where the
// aligned words would reach outside it (its first or last bytes, or a data
// pointer off alignment), the texels are read byte by byte instead, so no
// read leaves the tensor.
__device__ __forceinline__ void load_rgb_pair(const uint8_t* p, bool same,
                                              const uint8_t* __restrict__ begin,
                                              const uint8_t* __restrict__ end, int32_t& t0,
                                              int32_t& t1) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uintptr_t word = addr & ~static_cast<uintptr_t>(7);
  const unsigned s = static_cast<unsigned>(addr & 7);
  const bool two = s >= 3;
  if (word < reinterpret_cast<uintptr_t>(begin) ||
      word + (two ? 16 : 8) > reinterpret_cast<uintptr_t>(end)) {
    t0 = (int32_t)__ldg(p) | ((int32_t)__ldg(p + 1) << 8) | ((int32_t)__ldg(p + 2) << 16);
    t1 = same ? t0
              : (int32_t)__ldg(p + 3) | ((int32_t)__ldg(p + 4) << 8) |
                    ((int32_t)__ldg(p + 5) << 16);
    return;
  }
  const uint2 lo = __ldg(reinterpret_cast<const uint2*>(word));
  const uint2 hi = two ? __ldg(reinterpret_cast<const uint2*>(word + 8)) : make_uint2(0u, 0u);
  // bytes s .. s + 7 of the 16 as two words
  const bool upper = s >= 4;
  const uint32_t a = upper ? lo.y : lo.x;
  const uint32_t b = upper ? hi.x : lo.y;
  const uint32_t c = upper ? hi.y : hi.x;
  const unsigned shift = 8 * (s & 3);
  const uint32_t f0 = __funnelshift_r(a, b, shift);
  const uint32_t f1 = __funnelshift_r(b, c, shift);
  t0 = (int32_t)(f0 & 0xFFFFFFu);
  t1 = same ? t0 : (int32_t)((f0 >> 24) | ((f1 & 0xFFFFu) << 8));
}

// The four bilinear corner texels of frame `img` (H x W) at the clamped
// pixel coordinates fx, fy: v00 = (y0, x0), v01 = (y0, x1), v10 = (y1, x0),
// v11 = (y1, x1) with x0 = floor(fx), x1 = min(x0 + 1, W - 1) (and so for
// y), x0 and y0 clamped into the frame. Coordinates arrive clamped to
// [0, W-1] x [0, H-1], so min(x0 + 1, W - 1) reads the texel the TPU
// kernels' edge-padded copy holds there; the clamp of x0, y0 changes
// nothing for such input and keeps every read in bounds for any input.
__device__ __forceinline__ void gather_corners(const uint8_t* img, float fx, float fy, int H,
                                               int W, const uint8_t* __restrict__ begin,
                                               const uint8_t* __restrict__ end, int32_t& c00,
                                               int32_t& c01, int32_t& c10, int32_t& c11) {
  const int x0 = min(max((int)floorf(fx), 0), W - 1);
  const int y0 = min(max((int)floorf(fy), 0), H - 1);
  const bool same = x0 == W - 1;
  load_rgb_pair(img + ((int64_t)y0 * W + x0) * 3, same, begin, end, c00, c01);
  if (y0 < H - 1) {
    load_rgb_pair(img + ((int64_t)(y0 + 1) * W + x0) * 3, same, begin, end, c10, c11);
  } else {
    c10 = c00;
    c11 = c01;
  }
}

// (v >> 8c) & 0xFF scaled by float32(1 / 255), as the JAX package's _unpack
// multiplies (it does not divide).
__device__ __forceinline__ float unpack_channel(int32_t v, int c) {
  return (float)((v >> (8 * c)) & 0xFF) * (float)(1.0 / 255.0);
}

}  // namespace bbd
