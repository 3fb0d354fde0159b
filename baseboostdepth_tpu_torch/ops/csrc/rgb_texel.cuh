// Texel access shared by the uint8 RGB warp kernels (corner_sweep.cu,
// warp_packed.cu): one RGB texel of a uint8 [H, W, 3] frame as a packed word
// R | G << 8 | B << 16, the layout of the JAX package's pack_rgb, and one
// channel of such a word as a float in [0, 1].

#pragma once

#include <stdint.h>

namespace bbd {

__device__ __forceinline__ int32_t load_rgb(const uint8_t* __restrict__ img, int64_t pix) {
  const uint8_t* p = img + pix * 3;
  return (int32_t)__ldg(p) | ((int32_t)__ldg(p + 1) << 8) | ((int32_t)__ldg(p + 2) << 16);
}

// (v >> 8c) & 0xFF scaled by float32(1 / 255), as the JAX package's _unpack
// multiplies (it does not divide).
__device__ __forceinline__ float unpack_channel(int32_t v, int c) {
  return (float)((v >> (8 * c)) & 0xFF) * (float)(1.0 / 255.0);
}

}  // namespace bbd
