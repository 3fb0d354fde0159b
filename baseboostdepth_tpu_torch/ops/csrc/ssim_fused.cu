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
// Bound: bytes. Forward: 24 B of inputs and 4 B of output per pixel;
// backward: 24 B of inputs, 4 B of cotangent and 12 B of gradient. With
// FMA contraction off, the float32 arithmetic (about 250 instructions per
// pixel forward, 600 backward) comes close behind the forward's bytes and
// ahead of the backward's: on an H100 the backward is bound by instruction
// issue at the occupancy its registers allow. So the design moves each byte
// once and spends as few instructions per pixel as it can.
//
// Design: tall strips with sliding row sums. A block covers a strip of rows
// and a tile of columns of one image; each thread owns one column (all
// three channels) and walks down the strip, one input row per step:
//   - Rows arrive in a ring of shared-memory slots, a few rows ahead of the
//     one being computed. One warp per array issues a row: its lane 0 copies
//     the row's 16-byte-aligned body with one TMA bulk copy that completes on
//     the slot's mbarrier; a few lanes copy the ragged ends (W % 4 != 0, or
//     a data pointer off 16-byte alignment) and, in the blocks at the left
//     and right edges, the reflected halo columns -1 <- 1 and W <- W - 2,
//     with 4-byte cp.async. A slot keeps its row's 16-byte phase. Rows past
//     the top and bottom are reflected by the choice of source row. So no
//     thread spends an instruction per element on addresses, division or
//     reflect().
//   - Each thread forms the three-tap row sums of x, y, x^2, y^2, xy of its
//     column once per row and channel and keeps (row i - 1 + row i) and row
//     i + 1 in registers: a window sum is one more add, in the plain
//     version's order ((x0 + x1) + x2 per row, then (r0 + r1) + r2).
// Forward: 128 threads, 128 output columns and 32 rows per block; warps 0
// and 1 copy x and y; one barrier per row.
// Backward: 224 threads, one per window-centre column (j0 - 1 .. j0 + 222),
// for 222 output columns (three tiles span 640) and 48 rows per block, so
// every centre an output pixel needs, the reflected ones included, is
// computed in the block, once. Warps 0-2 copy x, y and g; warps 3-6 write
// the gradient rows. Each step computes M, S1, S2 of one centre row into
// shared memory; after a barrier each thread sums the three centres of its
// pixel's columns with the column weights of the reflect fold, keeps those
// sums for the last three centre rows in registers and applies the row
// weights, reading x, y and g of the output row back from the ring. The
// gradient row (12 B per pixel, NHWC) is staged in shared memory and
// written with 16-byte stores. 128 registers: two blocks (14 warps) per SM.
//
// Rounding. FMA contraction is off (cuda_build.py). The forward repeats the
// plain PyTorch version's float32 expressions in its order, so the two are
// equal bit for bit. The backward computes the moments, n, d and the mask q
// exactly as the plain version (IEEE division), so no mask flips; after the
// mask it takes A = u / d with the fast reciprocal (__fdividef), B = -A (n /
// d) from the quotient the mask used, sums the adjoint in another order and
// uses explicit fmaf in the adjoint and the final combination: within 1e-4
// of the largest gradient entry, and exactly 0 where every window covering
// a pixel has pred == target (q = 0 there, so u = 0).
//
// Flat offsets are 64-bit (84 images of 192 x 640 x 3 at the late stage).

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_chunks.cuh"

namespace {

constexpr int kFwdCols = 128;            // forward threads: one per column, three channels
constexpr int kBwdCols = 224;            // backward threads: one per window-centre column
constexpr int kFwdTile = kFwdCols;       // output columns of a forward block
constexpr int kBwdTile = kBwdCols - 2;   // output columns of a backward block (3 per 640)
constexpr int kFwdStrip = 32;            // output rows of a block
constexpr int kBwdStrip = 48;
constexpr int kFwdAhead = 4;             // input rows in flight
constexpr int kBwdAhead = 2;
constexpr int kFwdSlots = kFwdAhead + 1;  // ring: rows k .. k + ahead
constexpr int kBwdSlots = kBwdAhead + 3;  // ring: rows k - 2 .. k + ahead

// floats of a slot: up to 3 of phase, then the pixels, rounded up to 16 B
constexpr int slot_floats(int pixels, int ch) { return (3 + pixels * ch + 3) / 4 * 4; }
constexpr int kFwdRow = slot_floats(kFwdTile + 2, 3);
constexpr int kBwdRow = slot_floats(kBwdCols + 2, 3);
constexpr int kBwdG = slot_floats(kBwdCols, 1);
constexpr int kOutRow = slot_floats(kBwdTile, 3);

constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);
constexpr float kNinth = (float)(1.0 / 9.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kWSsim = (float)0.85;
constexpr float kWL1 = (float)0.15;
constexpr float kUScale = (float)(-0.5 * 0.85 / 3.0);
constexpr float kL1Grad = (float)(0.15 / 3.0);

// reflect padding of 1 (torch / jnp "reflect"): -1 -> 1, n -> n - 2. Rows
// further out belong to no window the kernel keeps; clamping keeps their
// reads in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---- 4-byte cp.async (the ragged ends of a row), per-thread groups
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- TMA bulk copies and their mbarriers
__device__ __forceinline__ void bar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(float* s, const float* g, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(s)),
      "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- row placement
// A row's pixels [c_lo, c_hi) sit in a slot from float `slot_pad` on, so
// that slot and row floats share their address mod 16.
template <int C>
__device__ __forceinline__ int slot_pad(const float* row, int c_lo) {
  return ((int)(((uintptr_t)row >> 2) & 3) + c_lo * C) & 3;
}

// The 16-byte-aligned part [a, b) of row floats [fa, fb) (row = the row's
// first float); a = b = fb when it holds no 16-byte chunk. Then each end
// outside [a, b) holds at most 3 floats, or the whole range at most 6.
__device__ __forceinline__ void aligned_part(const float* row, int fa, int fb, int* a, int* b) {
  const int m = (int)(((uintptr_t)row >> 2) & 3);
  *a = fa + ((4 - ((m + fa) & 3)) & 3);
  *b = fb - ((m + fb) & 3);
  if (*a > *b) *a = *b = fb;
}

// Issued by the 32 lanes of one warp: copies pixels [c_lo, c_hi) of the image
// row `row` (W pixels of C floats) into `slot`, pixel c, channel ch at
// *pad + (c - c_lo) C + ch. Lane 0 copies the 16-byte-aligned body with one
// TMA bulk copy that completes on `bar` (adding its bytes to the barrier's
// expected count first) and stores the pad; lanes 0-5 copy the ragged ends
// and lanes 16-18 / 24-26 the reflected halo columns -1 <- 1 and
// W <- W - 2 where the range meets them, with 4-byte cp.async. Other
// columns outside [0, W) stay unset: they feed only window centres outside
// the image, which no result reads.
template <int C>
__device__ __forceinline__ void issue_row(float* slot, int* pad, const float* row, int c_lo,
                                          int c_hi, int W, int lane, uint64_t* bar) {
  const int p = slot_pad<C>(row, c_lo);
  float* s = slot + p - c_lo * C;  // s[f] <- row[f]
  const int fa = max(c_lo, 0) * C;
  const int fb = min(c_hi, W) * C;
  int a, b;
  aligned_part(row, fa, fb, &a, &b);
  if (lane == 0) {
    *pad = p;
    if (b > a) {
      bar_expect(bar, (b - a) * 4);
      bulk_load(s + a, row + a, (b - a) * 4, bar);
    }
  }
  const int nh = a - fa;
  if (lane < nh + (fb - b)) {
    const int f = lane < nh ? fa + lane : b + (lane - nh);
    cp_async4(s + f, row + f);
  }
  if (c_lo < 0 && lane >= 16 && lane < 16 + C) cp_async4(s - C + (lane - 16), row + C + (lane - 16));
  if (c_hi > W && lane >= 24 && lane < 24 + C)
    cp_async4(s + W * C + (lane - 24), row + (W - 2) * C + (lane - 24));
}

// Threads i of `n` write pixels [c_lo, c_hi) (inside
// [0, W)) of the 3-channel row `row` from `staged`, laid out as issue_row
// lays out a slot: 16-byte stores for the aligned body, 4-byte ones for the
// ends.
__device__ __forceinline__ void store_row(float* row, const float* staged, int c_lo, int c_hi,
                                          int i, int n) {
  const float* s = staged + slot_pad<3>(row, c_lo) - c_lo * 3;
  const int fa = c_lo * 3;
  const int fb = c_hi * 3;
  int a, b;
  aligned_part(row, fa, fb, &a, &b);
  for (int f = a + 4 * i; f < b; f += 4 * n)
    *reinterpret_cast<float4*>(row + f) = *reinterpret_cast<const float4*>(s + f);
  const int nh = a - fa;
  if (i < nh + (fb - b)) {
    const int f = i < nh ? fa + i : b + (i - nh);
    row[f] = s[f];
  }
}

// Three-tap row sums of x, y, x^2, y^2, xy of one channel at one column,
// from the taps px[0], px[3], px[6] (and py): (v0 + v1) + v2.
__device__ __forceinline__ void row_sums(const float* px, const float* py, float* r) {
  const float x0 = px[0], x1 = px[3], x2 = px[6];
  const float y0 = py[0], y1 = py[3], y2 = py[6];
  r[0] = x0 + x1 + x2;
  r[1] = y0 + y1 + y2;
  r[2] = x0 * x0 + x1 * x1 + x2 * x2;
  r[3] = y0 * y0 + y1 * y1 + y2 * y2;
  r[4] = x0 * y0 + x1 * y1 + x2 * y2;
}

struct Moments {
  float mu_x, mu_y, sxx, syy, sxy;
};

// The window moments from pair = row sums (i - 1) + (i) and cur = row sums
// (i + 1), five each: the plain version's (r0 + r1) + r2, then / 9.
__device__ __forceinline__ Moments window(const float* pair, const float* cur) {
  Moments m;
  m.mu_x = (pair[0] + cur[0]) * kNinth;
  m.mu_y = (pair[1] + cur[1]) * kNinth;
  const float exx = (pair[2] + cur[2]) * kNinth;
  const float eyy = (pair[3] + cur[3]) * kNinth;
  const float exy = (pair[4] + cur[4]) * kNinth;
  m.sxx = exx - m.mu_x * m.mu_x;
  m.syy = eyy - m.mu_y * m.mu_y;
  m.sxy = exy - m.mu_x * m.mu_y;
  return m;
}

// Each slot's barrier completes a phase when the `arrivals` issuing warps
// have arrived and their bulk copies have landed.
template <int R>
__device__ __forceinline__ void init_bars(uint64_t (&bar)[R], int arrivals) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) bar_init(&bar[s], arrivals);
    bar_init_fence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kFwdCols, 4)
    ssim_fused_fwd_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                          float* __restrict__ out, int H, int W) {
  __shared__ __align__(16) float sx[kFwdSlots][kFwdRow];
  __shared__ __align__(16) float sy[kFwdSlots][kFwdRow];
  __shared__ int spad[kFwdSlots][2];
  __shared__ __align__(8) uint64_t bar[kFwdSlots];

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kFwdTile;
  const int i0 = blockIdx.y * kFwdStrip;
  const int64_t image = (int64_t)blockIdx.z * H * W;  // first pixel of image n
  const float* xs = pred + image * 3;
  const float* ys = target + image * 3;
  float* o = out + image;
  const int r0 = i0 - 1;  // input rows r0 .. r0 + rows - 1
  const int rows = min(i0 + kFwdStrip, H) + 1 - r0;
  const int c_lo = j0 - 1, c_hi = j0 + kFwdTile + 1;
  init_bars(bar, 2);

  const int warp = t >> 5, lane = t & 31;
  auto issue = [&](int k) {  // warp 0 copies x, warp 1 y
    if (k < rows) {
      const int s = k % kFwdSlots;
      const int64_t off = (int64_t)reflect(r0 + k, H) * W * 3;
      if (warp == 0)
        issue_row<3>(sx[s], &spad[s][0], xs + off, c_lo, c_hi, W, lane, &bar[s]);
      else
        issue_row<3>(sy[s], &spad[s][1], ys + off, c_lo, c_hi, W, lane, &bar[s]);
      if (lane == 0) bar_arrive(&bar[s]);
    }
    cp_async_commit();
  };
  if (warp < 2) {
#pragma unroll
    for (int k = 0; k < kFwdAhead; ++k) issue(k);
  }

  const int j = j0 + t;
  const bool live = j < W;
  float pair[15], prev[15];  // per channel c: [5 c + 0..4] = x, y, x^2, y^2, xy
  float xc[3], yc[3];        // x, y at (r - 1, j), for the L1 term
#pragma unroll
  for (int q = 0; q < 15; ++q) prev[q] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) xc[c] = yc[c] = 0.0f;

  int slot = 0;
  unsigned phase = 0;
  for (int k = 0; k < rows; ++k) {
    bar_wait(&bar[slot], phase);
    cp_async_wait<kFwdAhead - 1>();
    __syncthreads();  // row k has landed; row k - 1's slot is free
    if (warp < 2) issue(k + kFwdAhead);
    if (live) {
      const float* px = sx[slot] + spad[slot][0] + 3 * t;
      const float* py = sy[slot] + spad[slot][1] + 3 * t;
      float cur[15];
#pragma unroll
      for (int c = 0; c < 3; ++c) row_sums(px + c, py + c, cur + 5 * c);
      if (k >= 2) {  // window centre row r0 + k - 1
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const Moments m = window(pair + 5 * c, cur + 5 * c);
          const float n = (2.0f * m.mu_x * m.mu_y + kC1) * (2.0f * m.sxy + kC2);
          const float d = (m.mu_x * m.mu_x + m.mu_y * m.mu_y + kC1) * (m.sxx + m.syy + kC2);
          const float s = fminf(fmaxf((1.0f - n / d) * 0.5f, 0.0f), 1.0f);
          const float l1 = fabsf(xc[c] - yc[c]);
          const float term = (kWSsim * s + kWL1 * l1) * kThird;
          acc = c == 0 ? term : acc + term;
        }
        o[(int64_t)(r0 + k - 1) * W + j] = acc;
      }
#pragma unroll
      for (int q = 0; q < 15; ++q) {
        pair[q] = prev[q] + cur[q];
        prev[q] = cur[q];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xc[c] = px[3 + c];
        yc[c] = py[3 + c];
      }
    }
    if (++slot == kFwdSlots) {
      slot = 0;
      phase ^= 1;
    }
  }
}

__global__ void __launch_bounds__(kBwdCols, 2)
    ssim_fused_bwd_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                          const float* __restrict__ g, float* __restrict__ gx, int H, int W) {
  __shared__ __align__(16) float sx[kBwdSlots][kBwdRow];
  __shared__ __align__(16) float sy[kBwdSlots][kBwdRow];
  __shared__ __align__(16) float sg[kBwdSlots][kBwdG];
  __shared__ float sc[9][kBwdCols];            // M, S1, S2 x channel of one centre row
  __shared__ __align__(16) float so[kOutRow];  // one gradient row, staged
  __shared__ int spad[kBwdSlots][3];
  __shared__ __align__(8) uint64_t bar[kBwdSlots];

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kBwdTile;
  const int i0 = blockIdx.y * kBwdStrip;
  const int64_t image = (int64_t)blockIdx.z * H * W;
  const float* xs = pred + image * 3;
  const float* ys = target + image * 3;
  const float* gs = g + image;
  float* go = gx + image * 3;
  const int r0 = i0 - 2;  // input rows r0 .. r0 + rows - 1
  const int rows = min(i0 + kBwdStrip, H) + 2 - r0;
  const int c_lo = j0 - 2, c_hi = j0 + kBwdCols;  // x, y: 2-pixel halo
  const int g_lo = j0 - 1;                        // g: the block's centre columns
  const int o_hi = min(j0 + kBwdTile, W);
  init_bars(bar, 3);

  const int warp = t >> 5, lane = t & 31;
  auto issue = [&](int k) {  // warp 0 copies x, warp 1 y, warp 2 g
    if (k < rows) {
      const int s = k % kBwdSlots;
      const int64_t off = (int64_t)reflect(r0 + k, H) * W;
      if (warp == 0)
        issue_row<3>(sx[s], &spad[s][0], xs + off * 3, c_lo, c_hi, W, lane, &bar[s]);
      else if (warp == 1)
        issue_row<3>(sy[s], &spad[s][1], ys + off * 3, c_lo, c_hi, W, lane, &bar[s]);
      else
        issue_row<1>(sg[s], &spad[s][2], gs + off, g_lo, g_lo + kBwdCols, W, lane, &bar[s]);
      if (lane == 0) bar_arrive(&bar[s]);
    }
    cp_async_commit();
  };
  if (warp < 3) {
#pragma unroll
    for (int k = 0; k < kBwdAhead; ++k) issue(k);
  }

  const int cj = j0 - 1 + t;  // this thread's window centre column
  const bool col_in = cj >= 0 && cj < W;
  const int j = j0 + t;  // this thread's output column (= cj + 1)
  const bool out_col = t < kBwdTile && j < W;
  const float wl = j == 1 ? 2.0f : 1.0f;  // column weights of the reflect fold
  const float wr = j == W - 2 ? 2.0f : 1.0f;
  float pair[15], prev[15];          // per channel c: [5 c + 0..4] = x, y, x^2, y^2, xy
  float h1[9], h2[9];                // column sums of centre rows ci - 1, ci - 2
#pragma unroll
  for (int q = 0; q < 15; ++q) prev[q] = pair[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 9; ++q) h1[q] = h2[q] = 0.0f;

  int slot = 0, last = kBwdSlots - 1, last2 = kBwdSlots - 2;  // ring slots of rows k, k - 1, k - 2
  unsigned phase = 0;
  for (int k = 0; k < rows; ++k) {  // input row r = r0 + k
    bar_wait(&bar[slot], phase);
    cp_async_wait<kBwdAhead - 1>();
    __syncthreads();  // row k has landed; row k - 3's slot and sc are free, so is full
    if (warp < 3)
      issue(k + kBwdAhead);
    else if (k >= 5)  // warps 3 and up: the previous step's gradient row
      store_row(go + (int64_t)(r0 + k - 3) * W * 3, so, j0, o_hi, t - 96, kBwdCols - 96);
    const float* px = sx[slot] + spad[slot][0] + 3 * t;  // taps at columns cj - 1 .. cj + 1
    const float* py = sy[slot] + spad[slot][1] + 3 * t;
    float cur[15];
    if (col_in) {
#pragma unroll
      for (int c = 0; c < 3; ++c) row_sums(px + c, py + c, cur + 5 * c);
    }
    if (k >= 2) {  // window centre row ci = r - 1
      const int ci = r0 + k - 1;
      float v[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) v[q] = 0.0f;
      const float* pg = sg[last] + spad[last][2] + t;
      if (col_in && ci >= 0 && ci < H) {
        const float gc = pg[0];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const Moments m = window(pair + 5 * c, cur + 5 * c);
          const float n1 = 2.0f * m.mu_x * m.mu_y + kC1;
          const float n2 = 2.0f * m.sxy + kC2;
          const float d1 = m.mu_x * m.mu_x + m.mu_y * m.mu_y + kC1;
          const float d2 = m.sxx + m.syy + kC2;
          const float n = n1 * n2;
          const float d = d1 * d2;
          const float nd = n / d;
          const float q = (1.0f - nd) * 0.5f;
          const float active = (q > 0.0f && q < 1.0f) ? 1.0f : 0.0f;
          const float u = gc * active * kUScale;
          const float A = __fdividef(u, d);
          const float Bc = -(A * nd);  // -(u n) / d^2
          v[c] = __fmaf_rn(2.0f * m.mu_y * A, n2 - n1, 2.0f * m.mu_x * Bc * (d2 - d1));  // M
          v[3 + c] = 2.0f * A * n1;                                                       // S1
          v[6 + c] = Bc * d1;                                                             // S2
        }
      }
#pragma unroll
      for (int q = 0; q < 9; ++q) sc[q][t] = v[q];
      __syncthreads();  // the centre row is in sc; so has been stored
      if (out_col) {
        float h0[9];  // centres j - 1, j, j + 1 of row ci, with the column fold
#pragma unroll
        for (int q = 0; q < 9; ++q)
          h0[q] = __fmaf_rn(wr, sc[q][t + 2], __fmaf_rn(wl, sc[q][t], sc[q][t + 1]));
        if (k >= 4) {  // output row oi = ci - 1: centres ci - 2, ci - 1, ci
          const int oi = ci - 1;
          const float vt = oi == 1 ? 2.0f : 1.0f;  // row weights of the reflect fold
          const float vb = oi == H - 2 ? 2.0f : 1.0f;
          const float* ox = sx[last2] + spad[last2][0] + 3 * t + 6;  // pixel (oi, j)
          const float* oy = sy[last2] + spad[last2][1] + 3 * t + 6;
          const float gp = sg[last2][spad[last2][2] + t + 1];
          float* ps = so + slot_pad<3>(go + (int64_t)oi * W * 3, j0) + 3 * t;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float aM = __fmaf_rn(vb, h0[c], __fmaf_rn(vt, h2[c], h1[c]));
            const float aS1 = __fmaf_rn(vb, h0[3 + c], __fmaf_rn(vt, h2[3 + c], h1[3 + c]));
            const float aS2 = __fmaf_rn(vb, h0[6 + c], __fmaf_rn(vt, h2[6 + c], h1[6 + c]));
            const float diff = ox[c] - oy[c];
            const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
            const float sum = __fmaf_rn(2.0f * ox[c], aS2, __fmaf_rn(oy[c], aS1, aM));
            ps[c] = __fmaf_rn(sum, kNinth, kL1Grad * gp * sgn);
          }
        }
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          h2[q] = h1[q];
          h1[q] = h0[q];
        }
      }
    }
    if (col_in) {
#pragma unroll
      for (int q = 0; q < 15; ++q) {
        pair[q] = prev[q] + cur[q];
        prev[q] = cur[q];
      }
    }
    last2 = last;
    last = slot;
    if (++slot == kBwdSlots) {
      slot = 0;
      phase ^= 1;
    }
  }
  __syncthreads();
  if (warp >= 3)
    store_row(go + (int64_t)(r0 + rows - 3) * W * 3, so, j0, o_hi, t - 96, kBwdCols - 96);
}

// The shape check of both launchers: H, W >= 2 (reflect padding), N >= 1,
// and at most 65,535 strips on the grid's y axis (H up to 65,535 strips of
// the block's height; no image has that many rows).
bool valid_shape(long long N, int H, int W, int strip) {
  return N >= 1 && H >= 2 && W >= 2 && (H + strip - 1) / strip <= 65535;
}

bool float_aligned(const void* p) { return p && ((uintptr_t)p & 3) == 0; }

}  // namespace

// pred, target: float32 [N, H, W, 3]; out: float32 [N, H, W]. All contiguous,
// on one device, 4-byte aligned (16-byte alignment is not needed); H, W >= 2
// (reflect padding), any N >= 1. Launches on `stream`, once per chunk of at
// most 65,535 images (image_chunks.cuh), and returns the first launch's
// cudaError_t that is not 0 (0 on success); does not synchronise. A chunk's
// base pointers (65,535 H W 3 or 65,535 H W floats in) stay 4-byte aligned,
// and the kernels take each row's 16-byte phase from its own address, so
// every chunk takes the same path as the whole.
extern "C" int bbd_ssim_fused_fwd(const void* pred, const void* target, void* out, long long N,
                                  int H, int W, void* stream) {
  if (!float_aligned(pred) || !float_aligned(target) || !float_aligned(out) ||
      !valid_shape(N, H, W, kFwdStrip))
    return (int)cudaErrorInvalidValue;
  const int64_t image = (int64_t)H * W;
  return bbd::launch_image_chunks(N, [&](long long n0, unsigned count) {
    const dim3 grid((W + kFwdTile - 1) / kFwdTile, (H + kFwdStrip - 1) / kFwdStrip, count);
    ssim_fused_fwd_kernel<<<grid, kFwdCols, 0, (cudaStream_t)stream>>>(
        (const float*)pred + n0 * image * 3, (const float*)target + n0 * image * 3,
        (float*)out + n0 * image, H, W);
  });
}

// pred, target as above; g: float32 [N, H, W], the cotangent of the loss map;
// gx: float32 [N, H, W, 3], the gradient into pred. Same contract as the
// forward.
extern "C" int bbd_ssim_fused_bwd(const void* pred, const void* target, const void* g, void* gx,
                                  long long N, int H, int W, void* stream) {
  if (!float_aligned(pred) || !float_aligned(target) || !float_aligned(g) ||
      !float_aligned(gx) || !valid_shape(N, H, W, kBwdStrip))
    return (int)cudaErrorInvalidValue;
  const int64_t image = (int64_t)H * W;
  return bbd::launch_image_chunks(N, [&](long long n0, unsigned count) {
    const dim3 grid((W + kBwdTile - 1) / kBwdTile, (H + kBwdStrip - 1) / kBwdStrip, count);
    ssim_fused_bwd_kernel<<<grid, kBwdCols, 0, (cudaStream_t)stream>>>(
        (const float*)pred + n0 * image * 3, (const float*)target + n0 * image * 3,
        (const float*)g + n0 * image, (float*)gx + n0 * image * 3, H, W);
  });
}
