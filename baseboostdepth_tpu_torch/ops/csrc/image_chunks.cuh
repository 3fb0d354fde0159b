// Launch helper of the kernels whose grid puts the images on its z axis
// (corner_sweep.cu, warp_packed.cu's forward, ssim_fused.cu, warp_planes.cu).
// A grid's z extent holds at most 65,535 blocks, and the JAX functions these
// kernels port take any number of images, so a launcher calls its kernel once
// per chunk of at most that many images, each chunk with its own base
// pointers (offset in 64 bits by the caller's lambda).

#pragma once

#include <cuda_runtime.h>

namespace bbd {

constexpr long long kMaxGridZ = 65535;

// Calls launch(n0, count) for consecutive chunks [n0, n0 + count) of the N
// images, count <= kMaxGridZ, and checks each launch: returns the first
// cudaError_t other than cudaSuccess, or cudaSuccess.
template <typename Launch>
int launch_image_chunks(long long N, Launch launch) {
  for (long long n0 = 0; n0 < N; n0 += kMaxGridZ) {
    const long long left = N - n0;
    launch(n0, static_cast<unsigned>(left < kMaxGridZ ? left : kMaxGridZ));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace bbd
