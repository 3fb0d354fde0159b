// Fused SSIM + L1 reprojection loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels baseboostdepth_tpu/ops/ssim_pallas.py::_fwd_kernel
// (pallas_call in _call_fwd) and ::_bwd_kernel (pallas_call in _call_bwd).
//
// Forward, per pixel (n, i, j) of pred and target float32 [N, H, W, 3]:
//   out[n, i, j] = sum_c (0.85 clip((1 - SSIM_c) / 2, 0, 1) + 0.15 |x_c - y_c|) / 3
// with SSIM over 3x3 windows of the reflect-padded images (padded index -1
// reads 1, H reads H - 2), C1 = 0.01^2, C2 = 0.03^2.
// Backward: the gradient into pred only, the hand-derived formula of
// _bwd_kernel. Per window centre, with u = g * active * (-0.5 * 0.85 / 3),
// active = (0 < q < 1) for q = (1 - n/d) / 2, A = u / d, B = -u n / d^2:
//   M = 2 mu_y A (n2 - n1) + 2 mu_x B (d2 - d1),  S1 = 2 A n1,  S2 = B d1,
//   gx = adj(M) + y adj(S1) + 2 x adj(S2) + 0.05 g sign(x - y),
// where adj is the adjoint of (reflect pad + 3x3 mean): a pixel collects the
// values of every window centre whose padded window covers it, so centres
// i - 1, i, i + 1 per axis, and centre 0 once more for i = 1 and centre H - 1
// once more for i = H - 2 (the reflected rows). The mask is strict, so a clip
// bound passes 0 (autodiff of jnp.clip passes 0.5), and sign(0) = 0 (jnp.abs
// passes +1): the Pallas kernel's subgradients, which this kernel keeps.
//
// Design. The TPU kernels take planar, reflect-padded [N, 3, H + 2, W + 2]
// copies because W must lie on the 128-lane axis; here each block loads its
// tile of the NHWC images with the halo it needs straight into shared memory,
// mapping halo indices through the reflection, so no padded copy and no
// transpose exist. One block covers 8 x 32 pixels of one image:
//   forward:  x, y tile with a 1-pixel halo, then one thread per pixel;
//   backward: x, y tile with a 2-pixel halo and g with a 1-pixel halo; the
//             block computes M, S1, S2 once per window centre of the tile and
//             its 1-centre halo (zero outside the image), then each thread
//             sums the centres that cover its pixel. Every centre a pixel
//             needs, the reflected ones included, lies within one of it, so
//             the halo holds them all.
// Window sums follow the TPU kernel's order (three-tap row sums, then the
// three rows), and FMA contraction is off (cuda_build.py), so the forward
// equals the plain PyTorch version bit for bit; the backward sums its centres
// in another order than the plain version's padded box sums.
//
// Bound: bytes. Forward: 24 B of inputs and 4 B of output per pixel;
// backward: 24 B of inputs, 4 B of cotangent and 12 B of gradient. The tile
// loads are coalesced (a tile row is contiguous in NHWC); the halo is re-read
// by neighbouring blocks from L2. Flat offsets are 64-bit (84 images of
// 192 x 640 x 3 at the late stage).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // tile width (threadIdx.x)
constexpr int TY = 8;   // tile height (threadIdx.y)
constexpr int kThreads = TX * TY;

constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);
constexpr float kNinth = (float)(1.0 / 9.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kWSsim = (float)0.85;
constexpr float kWL1 = (float)0.15;
constexpr float kUScale = (float)(-0.5 * 0.85 / 3.0);
constexpr float kL1Grad = (float)(0.15 / 3.0);

// reflect padding of 1 (torch / jnp "reflect"): -1 -> 1, n -> n - 2. Halo
// entries further out belong to no window; clamping keeps their reads in
// bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// Loads rows i0 - HALO .. i0 + TY - 1 + HALO and columns j0 - HALO ..
// j0 + TX - 1 + HALO of the NHWC image `img` (all three channels) into
// s[row][col * 3 + c], through the reflection.
template <int HALO>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          float (*s)[(TX + 2 * HALO) * 3], int i0, int j0,
                                          int H, int W, int tid) {
  constexpr int kRow = (TX + 2 * HALO) * 3;
  for (int k = tid; k < (TY + 2 * HALO) * kRow; k += kThreads) {
    const int li = k / kRow;
    const int r = k - li * kRow;
    const int lj = r / 3;
    const int c = r - lj * 3;
    const int64_t pix = (int64_t)reflect(i0 - HALO + li, H) * W + reflect(j0 - HALO + lj, W);
    s[li][r] = __ldg(img + pix * 3 + c);
  }
}

struct Moments {
  float mu_x, mu_y, sxx, syy, sxy;
};

// The five window moments of channel c at the window whose top-left tap is
// s[li][lj] (3x3 taps), summed as the TPU kernel's _box3: three-tap row sums,
// then the three rows.
template <int ROW>
__device__ __forceinline__ Moments moments(const float (*sx)[ROW], const float (*sy)[ROW], int li,
                                           int lj, int c) {
  float bx[3], by[3], bxx[3], byy[3], bxy[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x0 = sx[li + a][(lj + 0) * 3 + c];
    const float x1 = sx[li + a][(lj + 1) * 3 + c];
    const float x2 = sx[li + a][(lj + 2) * 3 + c];
    const float y0 = sy[li + a][(lj + 0) * 3 + c];
    const float y1 = sy[li + a][(lj + 1) * 3 + c];
    const float y2 = sy[li + a][(lj + 2) * 3 + c];
    bx[a] = x0 + x1 + x2;
    by[a] = y0 + y1 + y2;
    bxx[a] = x0 * x0 + x1 * x1 + x2 * x2;
    byy[a] = y0 * y0 + y1 * y1 + y2 * y2;
    bxy[a] = x0 * y0 + x1 * y1 + x2 * y2;
  }
  Moments m;
  m.mu_x = (bx[0] + bx[1] + bx[2]) * kNinth;
  m.mu_y = (by[0] + by[1] + by[2]) * kNinth;
  const float exx = (bxx[0] + bxx[1] + bxx[2]) * kNinth;
  const float eyy = (byy[0] + byy[1] + byy[2]) * kNinth;
  const float exy = (bxy[0] + bxy[1] + bxy[2]) * kNinth;
  m.sxx = exx - m.mu_x * m.mu_x;
  m.syy = eyy - m.mu_y * m.mu_y;
  m.sxy = exy - m.mu_x * m.mu_y;
  return m;
}

__global__ void __launch_bounds__(kThreads)
    ssim_fused_fwd_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                          float* __restrict__ out, int H, int W) {
  constexpr int kRow = (TX + 2) * 3;
  __shared__ float sx[TY + 2][kRow];
  __shared__ float sy[TY + 2][kRow];

  const int64_t base = (int64_t)blockIdx.z * H * W;  // first pixel of image n
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX;
  const int ti = threadIdx.y;
  const int tj = threadIdx.x;
  const int tid = ti * TX + tj;
  load_tile<1>(pred + base * 3, sx, i0, j0, H, W, tid);
  load_tile<1>(target + base * 3, sy, i0, j0, H, W, tid);
  __syncthreads();

  const int i = i0 + ti;
  const int j = j0 + tj;
  if (i >= H || j >= W) return;
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Moments m = moments<kRow>(sx, sy, ti, tj, c);
    const float n = (2.0f * m.mu_x * m.mu_y + kC1) * (2.0f * m.sxy + kC2);
    const float d = (m.mu_x * m.mu_x + m.mu_y * m.mu_y + kC1) * (m.sxx + m.syy + kC2);
    const float s = fminf(fmaxf((1.0f - n / d) * 0.5f, 0.0f), 1.0f);
    const float l1 = fabsf(sx[ti + 1][(tj + 1) * 3 + c] - sy[ti + 1][(tj + 1) * 3 + c]);
    const float term = (kWSsim * s + kWL1 * l1) * kThird;
    acc = c == 0 ? term : acc + term;
  }
  out[base + (int64_t)i * W + j] = acc;
}

__global__ void __launch_bounds__(kThreads)
    ssim_fused_bwd_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                          const float* __restrict__ g, float* __restrict__ gx, int H, int W) {
  constexpr int kRow = (TX + 4) * 3;           // x, y: 2-pixel halo
  constexpr int kCH = TY + 2, kCW = TX + 2;    // window centres: 1-centre halo
  __shared__ float sx[TY + 4][kRow];
  __shared__ float sy[TY + 4][kRow];
  __shared__ float sg[kCH][kCW];
  __shared__ float sM[3][kCH][kCW];
  __shared__ float sS1[3][kCH][kCW];
  __shared__ float sS2[3][kCH][kCW];

  const int64_t base = (int64_t)blockIdx.z * H * W;
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX;
  const int ti = threadIdx.y;
  const int tj = threadIdx.x;
  const int tid = ti * TX + tj;
  load_tile<2>(pred + base * 3, sx, i0, j0, H, W, tid);
  load_tile<2>(target + base * 3, sy, i0, j0, H, W, tid);
  for (int k = tid; k < kCH * kCW; k += kThreads) {
    const int li = k / kCW;
    const int lj = k - li * kCW;
    const int ci = i0 - 1 + li;
    const int cj = j0 - 1 + lj;
    const bool inside = ci >= 0 && ci < H && cj >= 0 && cj < W;
    sg[li][lj] = inside ? __ldg(g + base + (int64_t)ci * W + cj) : 0.0f;
  }
  __syncthreads();

  // per window centre (local li, lj = global i0 - 1 + li, j0 - 1 + lj) and
  // channel: M, S1, S2, zero for centres outside the image
  for (int k = tid; k < 3 * kCH * kCW; k += kThreads) {
    const int c = k / (kCH * kCW);
    const int r = k - c * (kCH * kCW);
    const int li = r / kCW;
    const int lj = r - li * kCW;
    const int ci = i0 - 1 + li;
    const int cj = j0 - 1 + lj;
    float M = 0.0f, S1 = 0.0f, S2 = 0.0f;
    if (ci >= 0 && ci < H && cj >= 0 && cj < W) {
      // the window of centre li starts at x-tile row li (x row 0 = i0 - 2)
      const Moments m = moments<kRow>(sx, sy, li, lj, c);
      const float n1 = 2.0f * m.mu_x * m.mu_y + kC1;
      const float n2 = 2.0f * m.sxy + kC2;
      const float d1 = m.mu_x * m.mu_x + m.mu_y * m.mu_y + kC1;
      const float d2 = m.sxx + m.syy + kC2;
      const float n = n1 * n2;
      const float d = d1 * d2;
      const float q = (1.0f - n / d) * 0.5f;
      const float active = (q > 0.0f && q < 1.0f) ? 1.0f : 0.0f;
      const float u = sg[li][lj] * active * kUScale;
      const float A = u / d;
      const float Bc = -(u * n) / (d * d);
      S1 = 2.0f * A * n1;
      S2 = Bc * d1;
      M = 2.0f * m.mu_y * A * (n2 - n1) + 2.0f * m.mu_x * Bc * (d2 - d1);
    }
    sM[c][li][lj] = M;
    sS1[c][li][lj] = S1;
    sS2[c][li][lj] = S2;
  }
  __syncthreads();

  const int i = i0 + ti;
  const int j = j0 + tj;
  if (i >= H || j >= W) return;
  // centres i - 1, i, i + 1 sit at local rows ti .. ti + 2; the reflected
  // rows add centre 0 (= i - 1) again for i = 1 and centre H - 1 (= i + 1)
  // again for i = H - 2; the same for columns
  const float wr[3] = {i == 1 ? 2.0f : 1.0f, 1.0f, i == H - 2 ? 2.0f : 1.0f};
  const float wc[3] = {j == 1 ? 2.0f : 1.0f, 1.0f, j == W - 2 ? 2.0f : 1.0f};
  const float gp = sg[ti + 1][tj + 1];
  float* o = gx + (base + (int64_t)i * W + j) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float aM = 0.0f, aS1 = 0.0f, aS2 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float rM = 0.0f, rS1 = 0.0f, rS2 = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        rM = rM + wc[b] * sM[c][ti + a][tj + b];
        rS1 = rS1 + wc[b] * sS1[c][ti + a][tj + b];
        rS2 = rS2 + wc[b] * sS2[c][ti + a][tj + b];
      }
      aM = aM + wr[a] * rM;
      aS1 = aS1 + wr[a] * rS1;
      aS2 = aS2 + wr[a] * rS2;
    }
    const float xc = sx[ti + 2][(tj + 2) * 3 + c];
    const float yc = sy[ti + 2][(tj + 2) * 3 + c];
    const float diff = xc - yc;
    const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
    o[c] = aM * kNinth + yc * (aS1 * kNinth) + 2.0f * xc * (aS2 * kNinth) + kL1Grad * gp * sgn;
  }
}

bool grid_for(long long N, int H, int W, dim3* grid) {
  if (N <= 0 || N > 65535 || H < 2 || W < 2) return false;
  *grid = dim3((unsigned)((W + TX - 1) / TX), (unsigned)((H + TY - 1) / TY), (unsigned)N);
  return true;
}

}  // namespace

// pred, target: float32 [N, H, W, 3]; out: float32 [N, H, W]. All contiguous,
// on one device; H, W >= 2 (reflect padding), 1 <= N <= 65535. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int bbd_ssim_fused_fwd(const void* pred, const void* target, void* out, long long N,
                                  int H, int W, void* stream) {
  dim3 grid;
  if (!pred || !target || !out || !grid_for(N, H, W, &grid)) return (int)cudaErrorInvalidValue;
  ssim_fused_fwd_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)target, (float*)out, H, W);
  return (int)cudaGetLastError();
}

// pred, target as above; g: float32 [N, H, W], the cotangent of the loss map;
// gx: float32 [N, H, W, 3], the gradient into pred. Same contract as the
// forward.
extern "C" int bbd_ssim_fused_bwd(const void* pred, const void* target, const void* g, void* gx,
                                  long long N, int H, int W, void* stream) {
  dim3 grid;
  if (!pred || !target || !g || !gx || !grid_for(N, H, W, &grid))
    return (int)cudaErrorInvalidValue;
  ssim_fused_bwd_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)target, (const float*)g, (float*)gx, H, W);
  return (int)cudaGetLastError();
}
