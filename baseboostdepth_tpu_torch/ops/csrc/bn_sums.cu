// Per-channel sums of a BatchNorm input, for Hopper (sm_90a).
//
// No TPU kernel: the JAX package's BatchNorm is flax's nn.BatchNorm, whose
// statistics XLA fuses (use_fast_variance=True: mean = E[x], var = E[x^2] -
// E[x]^2, reduced in float32, or float64 for a float64 input). This kernel
// computes the two sums that formula needs, sum(x) and sum(x^2) per channel,
// from one read of x, for models/resnet.py::BatchNorm2d's train-mode
// autograd Function (ops/batch_norm.py); torch has no single call that does
// (torch.batch_norm_stats is Welford's update: the two-pass variance, another
// function of x).
//
// x is a [outer, C, inner] view: an NCHW tensor is outer = N, inner = H*W; a
// channels-last one (NHWC in memory, as the port's networks run on the card)
// is outer = N*H*W, inner = 1. out[c] = sum(x[:, c, :]), out[C + c] =
// sum(x[:, c, :]^2), in float64, or rounded once to the accumulation type
// (float32 for a bf16 or float32 x, float64 for a float64 x).
//
// Accuracy: x and x * x are taken in the accumulation type, as flax takes
// them, every partial sum is kept in float64, and only the result is rounded
// to out's type. A data-parallel step asks for float64 sums, all-reduces
// them in float64 and rounds the global sums once, so its statistics are
// those of one process on the global batch, not a function of how the rows
// are split over the ranks. The fast variance E[x^2] - E[x]^2 magnifies the
// sums' relative error by E[x^2] / var, and a channel of the pose network's
// first BN holds 216 x 96 x 320 = 6.6 M values: float32 partial sums of a
// few thousand terms a thread were measured 3.3e-6 off in sum(x^2) on the
// card, where a float64 accumulation is exact to float32's rounding. The
// kernel stays bound by bytes: 3 float64 operations an element against
// 2-8 bytes read.
//
// Bound: bytes. Each element of x is read once (2-8 B) for three operations;
// out is 2C values. The design:
//   - channels-last (inner == 1): a block is 32 adjacent channels x 8 rows,
//     so a warp reads 32 adjacent elements of a row; each thread walks its
//     rows with a stride of the grid's rows, 8 loads in flight before it adds
//     them (the order of its additions is that of the rows);
//   - NCHW (inner > 1): a block is one channel and a slice of the H*W plane
//     of every image, 256 adjacent elements a step;
//   - the grid's y axis (G blocks) splits the rows or the plane so that
//     ~1,000 blocks fill the card's 132 SMs; each block writes its float64
//     partial sums to partial[k * G + y], and a second grid adds the G
//     partials of each of the 2C sums, one warp each, in a fixed order. With
//     G == 1 the first grid writes out directly. No atomics: the sums are the same from
//     run to run, which keeps the replicas of a data-parallel run equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;    // channels of a channels-last block
constexpr int kRows = 8;     // rows of a channels-last block
constexpr int kUnroll = 8;   // loads in flight a thread (channels-last)
constexpr int kThreads = 256;

// x in its accumulation type (float32 for bf16 and float32, float64 for
// float64): x and x * x are taken there, as flax takes them, and summed in
// float64 (`add`)
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename A>
__device__ __forceinline__ void add(double& s, double& ss, A v) {
  s += (double)v;
  ss += (double)(v * v);
}

// dst: float64 partial sums, or the float32 / float64 result when G == 1
template <typename T, typename Out>
__global__ void __launch_bounds__(kCols * kRows)
    bn_sums_rows_kernel(const T* __restrict__ x, long long rows, int C, Out* __restrict__ dst) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  double s = 0, ss = 0;
  if (c < C) {
    const long long step = (long long)gridDim.y * kRows;
    long long r = (long long)blockIdx.y * kRows + threadIdx.y;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      T v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) v[k] = x[(r + k * step) * C + c];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) add(s, ss, to_acc(v[k]));
    }
    for (; r < rows; r += step) add(s, ss, to_acc(x[r * C + c]));
  }
  __shared__ double sh[2][kRows][kCols];
  sh[0][threadIdx.y][threadIdx.x] = s;
  sh[1][threadIdx.y][threadIdx.x] = ss;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    double a = sh[0][0][threadIdx.x], b = sh[1][0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kRows; ++k) {
      a += sh[0][k][threadIdx.x];
      b += sh[1][k][threadIdx.x];
    }
    dst[(long long)c * gridDim.y + blockIdx.y] = (Out)a;
    dst[(long long)(C + c) * gridDim.y + blockIdx.y] = (Out)b;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename Out>
__global__ void __launch_bounds__(kThreads)
    bn_sums_planes_kernel(const T* __restrict__ x, long long outer, int C, long long inner,
                          Out* __restrict__ dst) {
  const int c = blockIdx.x;
  double s = 0, ss = 0;
  const long long step = (long long)gridDim.y * kThreads;
  for (long long n = 0; n < outer; ++n) {
    const T* p = x + (n * C + c) * inner;
    for (long long i = (long long)blockIdx.y * kThreads + threadIdx.x; i < inner; i += step)
      add(s, ss, to_acc(p[i]));
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  __shared__ double sh[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = s;
    sh[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = sh[0][0], b = sh[1][0];
#pragma unroll
    for (int k = 1; k < kThreads / 32; ++k) {
      a += sh[0][k];
      b += sh[1][k];
    }
    dst[(long long)c * gridDim.y + blockIdx.y] = (Out)a;
    dst[(long long)(C + c) * gridDim.y + blockIdx.y] = (Out)b;
  }
}

// out[k] = sum over g of partial[k * G + g], k < K: one warp a k, lanes over g.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
    bn_sums_combine_kernel(const double* __restrict__ partial, int G, int K,
                           Out* __restrict__ out) {
  const int k = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (k >= K) return;  // uniform over the warp
  double a = 0;
  for (int g = lane; g < G; g += 32) a += partial[(long long)k * G + g];
  a = warp_sum(a);
  if (lane == 0) out[k] = (Out)a;
}

template <typename T, typename Dst>
void launch_first(const T* x, long long outer, int C, long long inner, int G, Dst* dst,
                  cudaStream_t stream) {
  if (inner == 1) {
    const dim3 grid((C + kCols - 1) / kCols, G);
    bn_sums_rows_kernel<T, Dst><<<grid, dim3(kCols, kRows), 0, stream>>>(x, outer, C, dst);
  } else {
    bn_sums_planes_kernel<T, Dst><<<dim3(C, G), kThreads, 0, stream>>>(x, outer, C, inner, dst);
  }
}

template <typename T, typename Out>
int launch_sums(const void* x, void* out, void* partial, long long outer, int C, long long inner,
                int G, cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  if (G == 1) {
    launch_first(xt, outer, C, inner, G, static_cast<Out*>(out), stream);
    return (int)cudaGetLastError();
  }
  launch_first(xt, outer, C, inner, G, static_cast<double*>(partial), stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int K = 2 * C;
  const int per_block = kThreads / 32;
  bn_sums_combine_kernel<Out><<<(K + per_block - 1) / per_block, kThreads, 0, stream>>>(
      static_cast<const double*>(partial), G, K, static_cast<Out*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Sums of x viewed as [outer, C, inner] (contiguous) per channel: out[c] =
// sum(x), out[C + c] = sum(x^2). dtype: 0 float32, 1 float64, 2 bfloat16;
// out (2C values) is float64 when out_f64 is 1 or x is float64, else float32;
// partial (2C * G float64 values, unused when G == 1). G (1-65,535) is the
// number of blocks along a channel. Launches on `stream` (one grid, two when
// G > 1) and returns the first cudaError_t that is not 0 (0 on success); does
// not synchronise.
extern "C" int bbd_bn_sums(const void* x, void* out, void* partial, long long outer, int C,
                           long long inner, int dtype, int out_f64, int G, void* stream) {
  if (!x || !out || outer <= 0 || C <= 0 || inner <= 0 || G <= 0 || G > 65535 ||
      (G > 1 && !partial) || C > (1 << 30) || (out_f64 != 0 && out_f64 != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return out_f64 ? launch_sums<float, double>(x, out, partial, outer, C, inner, G, s)
                     : launch_sums<float, float>(x, out, partial, outer, C, inner, G, s);
    case 1:
      return launch_sums<double, double>(x, out, partial, outer, C, inner, G, s);
    case 2:
      return out_f64
                 ? launch_sums<__nv_bfloat16, double>(x, out, partial, outer, C, inner, G, s)
                 : launch_sums<__nv_bfloat16, float>(x, out, partial, outer, C, inner, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
