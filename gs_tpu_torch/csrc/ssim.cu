// SSIM of the training loss, forward and backward, for Hopper (sm_90a): the
// mean SSIM of two [C, H, W] float32 images with the 11x11 Gaussian window
// (sigma 1.5), same-padded with zeros, C1 = 0.01^2, C2 = 0.03^2, and its
// gradient in the first image.
//
// Replaces no TPU kernel: gs_tpu's SSIM is jnp (gs_tpu/ops/ssim.py), which
// XLA fuses into a few stencil passes. Run eagerly in PyTorch the same
// arithmetic is some forty elementwise passes over a stacked [15, H, W]
// tensor (11 shifted multiply-adds per axis and a pad), which autograd
// mirrors in the backward. That code stays in gs_tpu_torch/ops/ssim.py as
// the forward's twin (ssim_plain, which autograd differentiates on the CPU),
// beside ssim_backward_plain, the backward kernel's twin.
//
// Bound on the H100. Operations: the benchmark counts 245 FP32 operations a
// pixel and channel for the forward and twice that for the backward, 2.4
// GFLOP at 1297x840x3, 0.04 ms at 67 TFLOP/s. Bytes: the forward reads both
// images and writes three maps, the backward reads the maps and both images
// and writes the gradient: 11 x 4 B a pixel and channel, 0.14 GB, 0.04 ms at
// 3.35 TB/s. The work is a stencil, so the time goes to shared memory and
// the halo, not to either bound.
//
// Design. The forward's block takes a tile of kTH x kTW output pixels of one
// channel. It loads the tile with a kR-pixel halo of both images into shared
// memory, zero outside the image (the twin's padding, so a ragged edge such
// as 1297 columns is masked, never padded in memory), runs the 11-tap pass
// along H over every loaded column for the five quantities x, y, x^2, y^2,
// xy (products formed on the fly) into shared memory, then the pass along W
// into registers, and forms the SSIM map. The passes go in the twin's order
// (H first, then W) so that each blurred value, and so the map, is the
// twin's bit for bit. Each block writes the sum of its map as one partial; a
// second kernel of one block adds the partials in a fixed order, in double,
// and divides by C x H x W. No atomics anywhere: the value is the same bits
// from run to run. When a gradient is wanted the forward also writes three
// per-pixel maps, as the reference's fused-ssim does: with m the map and
// A = 2 mu1 mu2 + C1, B = 2 sigma12 + C2, Cc = mu1^2 + mu2^2 + C1,
// D = sigma1^2 + sigma2^2 + C2,
//   ds11 = dm/dsigma1^2 = -m / D,
//   ds12 = dm/dsigma12 = 2 A / (Cc D),
//   dmu = dm/dmu1 - 2 mu1 ds11 - mu2 ds12, dm/dmu1 = 2 mu2 B / (Cc D)
//         - 2 mu1 m / Cc (the sigma terms folded in, since
//         sigma1^2 = blur(x^2) - mu1^2 and sigma12 = blur(xy) - mu1 mu2).
// The backward gives g / N (blur(dmu) + 2 x blur(ds11) + y blur(ds12)), the
// gradient in x alone; the zero-padded symmetric window is its own
// transpose, so it is the same tiled two-pass stencil over the three maps.
// The maps are saved rather than recomputed in the backward: saving costs
// writing and reading 3 x 4 B a pixel and channel (0.02 ms at garden's
// frame), while recomputing them would run the forward's five-quantity
// stencil again over a tile with twice the halo, more arithmetic than the
// whole backward.
//
// The rules of the twin. FP32, no fast math: products, sums and quotients
// through __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc never
// contracts into an FMA, in the twin's order of operations; the taps and
// C1, C2 are the float32 values PyTorch uses (the taps passed in from
// ops/ssim.py). The map is the twin's bit for bit; the mean differs from
// torch.mean's by the order of the sum. The derivative maps and the
// gradient are ssim_backward_plain's operations in its order.
#include "common.cuh"

namespace {

constexpr int kTaps = 11;
constexpr int kR = kTaps / 2;             // the window's radius
constexpr int kTW = 32;                   // a tile's output columns: a warp a row
constexpr int kTH = 16;                   // a tile's output rows
constexpr int kInW = kTW + 2 * kR;        // the loaded columns
constexpr int kInH = kTH + 2 * kR;        // the loaded rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 512;

// gs_tpu_torch/ops/ssim.py: C1 and C2, as PyTorch converts the Python doubles
constexpr float kC1 = static_cast<float>(0.01 * 0.01);
constexpr float kC2 = static_cast<float>(0.03 * 0.03);

struct Taps {
  float w[kTaps];
};

struct FwdArgs {
  const float* x;       // [C, H, W] the first image
  const float* y;       // [C, H, W] the second
  float* dmu;           // [C, H, W] each, or all null: no gradient wanted
  float* ds11;
  float* ds12;
  float* partial;       // [C x tiles] each block's sum of the map
  int h, w;
  Taps taps;
};

struct BwdArgs {
  const float* grad;    // [] the cotangent of the mean
  const float* x;
  const float* y;
  const float* dmu;
  const float* ds11;
  const float* ds12;
  float* out;           // [C, H, W] the gradient in x
  float n;              // C x H x W as float32
  int h, w;
  Taps taps;
};

// rows [r0 - kR, r0 + kTH + kR) x columns [c0 - kR, c0 + kTW + kR) of one
// channel plane into dst, zero outside the image
__device__ __forceinline__ void load_tile(float (*dst)[kInW], const float* src,
                                          int r0, int c0, int h, int w) {
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int rr = i / kInW;
    const int cc = i - rr * kInW;
    const int gr = r0 - kR + rr;
    const int gc = c0 - kR + cc;
    const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
    dst[rr][cc] = in ? src[static_cast<long long>(gr) * w + gc] : 0.0f;
  }
}

// one tap of a pass: the twin's `out = term` for the first, `out + term` after
__device__ __forceinline__ void tap(float& acc, float wk, float v, int k) {
  const float t = __fmul_rn(wk, v);
  acc = k == 0 ? t : __fadd_rn(acc, t);
}

// The SSIM map and, with `grads`, the three derivative maps, in the twin's
// order (ssim_plain's map, ssim_backward_plain's _derivatives).
__device__ __forceinline__ float ssim_map(float mu1, float mu2, float s11,
                                          float s22, float s12, bool grads,
                                          float& dmu, float& ds11,
                                          float& ds12) {
  const float mu1_sq = __fmul_rn(mu1, mu1);
  const float mu2_sq = __fmul_rn(mu2, mu2);
  const float mu1_mu2 = __fmul_rn(mu1, mu2);
  const float sigma1_sq = __fsub_rn(s11, mu1_sq);
  const float sigma2_sq = __fsub_rn(s22, mu2_sq);
  const float sigma12 = __fsub_rn(s12, mu1_mu2);
  const float a = __fadd_rn(__fmul_rn(2.0f, mu1_mu2), kC1);
  const float b = __fadd_rn(__fmul_rn(2.0f, sigma12), kC2);
  const float c = __fadd_rn(__fadd_rn(mu1_sq, mu2_sq), kC1);
  const float d = __fadd_rn(__fadd_rn(sigma1_sq, sigma2_sq), kC2);
  const float cd = __fmul_rn(c, d);
  const float m = __fdiv_rn(__fmul_rn(a, b), cd);
  if (grads) {
    ds11 = __fdiv_rn(-m, d);
    ds12 = __fdiv_rn(__fmul_rn(2.0f, a), cd);
    const float t1 = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, mu2), b), cd);
    const float t2 = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, mu1), m), c);
    dmu = __fsub_rn(__fsub_rn(__fsub_rn(t1, t2),
                              __fmul_rn(__fmul_rn(2.0f, mu1), ds11)),
                    __fmul_rn(mu2, ds12));
  }
  return m;
}

__global__ void __launch_bounds__(kThreads) ssim_fwd_kernel(const FwdArgs a) {
  __shared__ float sx[kInH][kInW];
  __shared__ float sy[kInH][kInW];
  __shared__ float sv[5][kTH][kInW];     // after the pass along H
  __shared__ float warp_sum[kWarps];
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const long long plane = static_cast<long long>(blockIdx.z) * a.h * a.w;
  load_tile(sx, a.x + plane, r0, c0, a.h, a.w);
  load_tile(sy, a.y + plane, r0, c0, a.h, a.w);
  __syncthreads();

  // the pass along H, over every loaded column (the halo's columns too)
  for (int i = threadIdx.x; i < kTH * kInW; i += kThreads) {
    const int r = i / kInW;
    const int cc = i - r * kInW;
    float v[5];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float xv = sx[r + k][cc];
      const float yv = sy[r + k][cc];
      const float wk = a.taps.w[k];
      tap(v[0], wk, xv, k);
      tap(v[1], wk, yv, k);
      tap(v[2], wk, __fmul_rn(xv, xv), k);
      tap(v[3], wk, __fmul_rn(yv, yv), k);
      tap(v[4], wk, __fmul_rn(xv, yv), k);
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) sv[q][r][cc] = v[q];
  }
  __syncthreads();

  // the pass along W and the map, a warp a row of the tile
  const bool grads = a.dmu != nullptr;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int r = i / kTW;
    const int cc = i - r * kTW;
    const int gr = r0 + r;
    const int gc = c0 + cc;
    if (gr >= a.h || gc >= a.w) continue;
    float v[5];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float wk = a.taps.w[k];
#pragma unroll
      for (int q = 0; q < 5; ++q) tap(v[q], wk, sv[q][r][cc + k], k);
    }
    float dmu, ds11, ds12;
    sum += ssim_map(v[0], v[1], v[2], v[3], v[4], grads, dmu, ds11, ds12);
    if (grads) {
      const long long at = plane + static_cast<long long>(gr) * a.w + gc;
      a.dmu[at] = dmu;
      a.ds11[at] = ds11;
      a.ds12[at] = ds12;
    }
  }

  // the block's sum, in a fixed order: each warp by shuffles, then warp 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = warp_sum[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += warp_sum[k];
    a.partial[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
                  gridDim.x + blockIdx.x] = s;
  }
}

// The mean: one block adds the partials in double, each thread a fixed
// stride of them, then a tree in shared memory.
__global__ void __launch_bounds__(kReduceThreads) ssim_mean_kernel(
    const float* partial, int n, double count, float* value) {
  __shared__ double s[kReduceThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += partial[i];
  s[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *value = static_cast<float>(s[0] / count);
}

__global__ void __launch_bounds__(kThreads) ssim_bwd_kernel(const BwdArgs a) {
  __shared__ float sm[3][kInH][kInW];
  __shared__ float sv[3][kTH][kInW];     // after the pass along H
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const long long plane = static_cast<long long>(blockIdx.z) * a.h * a.w;
  load_tile(sm[0], a.dmu + plane, r0, c0, a.h, a.w);
  load_tile(sm[1], a.ds11 + plane, r0, c0, a.h, a.w);
  load_tile(sm[2], a.ds12 + plane, r0, c0, a.h, a.w);
  __syncthreads();

  for (int i = threadIdx.x; i < kTH * kInW; i += kThreads) {
    const int r = i / kInW;
    const int cc = i - r * kInW;
    float v[3];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float wk = a.taps.w[k];
#pragma unroll
      for (int q = 0; q < 3; ++q) tap(v[q], wk, sm[q][r + k][cc], k);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) sv[q][r][cc] = v[q];
  }
  __syncthreads();

  // ssim_backward_plain: (g / N) * (b_mu + 2 x b11 + y b12)
  const float scale = __fdiv_rn(*a.grad, a.n);
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int r = i / kTW;
    const int cc = i - r * kTW;
    const int gr = r0 + r;
    const int gc = c0 + cc;
    if (gr >= a.h || gc >= a.w) continue;
    float v[3];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float wk = a.taps.w[k];
#pragma unroll
      for (int q = 0; q < 3; ++q) tap(v[q], wk, sv[q][r][cc + k], k);
    }
    const long long at = plane + static_cast<long long>(gr) * a.w + gc;
    const float xv = a.x[at];
    const float yv = a.y[at];
    const float sum = __fadd_rn(
        __fadd_rn(v[0], __fmul_rn(__fmul_rn(2.0f, xv), v[1])),
        __fmul_rn(yv, v[2]));
    a.out[at] = __fmul_rn(scale, sum);
  }
}

dim3 tiles(int c, int h, int w) {
  return dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, c);
}

bool bad_shape(int c, int h, int w) {
  return c <= 0 || c > 65535 || h <= 0 || w <= 0 ||
         (h + kTH - 1) / kTH > 65535 ||
         static_cast<long long>(c) * h * w >= (1LL << 31);
}

Taps taps_of(const float* taps) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.w[k] = taps[k];
  return t;
}

}  // namespace

// The partials the forward writes for a [c, h, w] image: one a tile of
// kTH x kTW pixels of a channel. 0 for a shape the kernels refuse.
extern "C" int gs_ssim_partials(int c, int h, int w) {
  if (bad_shape(c, h, w)) return 0;
  const dim3 g = tiles(c, h, w);
  return static_cast<int>(g.x * g.y * g.z);
}

// The forward: x, y [c, h, w] contiguous float32; partial [gs_ssim_partials]
// and value [] float32, written; dmu, ds11, ds12 [c, h, w] written, or all
// null. taps: 11 float32 on the host, the window. Launches on `stream`,
// returns cudaGetLastError().
extern "C" int gs_ssim_fwd(const float* x, const float* y, float* dmu,
                           float* ds11, float* ds12, float* partial,
                           float* value, const float* taps, int c, int h,
                           int w, int device, void* stream) {
  const bool some = dmu != nullptr || ds11 != nullptr || ds12 != nullptr;
  const bool all = dmu != nullptr && ds11 != nullptr && ds12 != nullptr;
  if (bad_shape(c, h, w) || x == nullptr || y == nullptr ||
      partial == nullptr || value == nullptr || taps == nullptr ||
      some != all) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tiles(c, h, w);
  const FwdArgs a{x, y, dmu, ds11, ds12, partial, h, w, taps_of(taps)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssim_fwd_kernel<<<grid, kThreads, 0, s>>>(a);
  const int n = static_cast<int>(grid.x * grid.y * grid.z);
  ssim_mean_kernel<<<1, kReduceThreads, 0, s>>>(
      partial, n, static_cast<double>(c) * h * w, value);
  return static_cast<int>(cudaGetLastError());
}

// The backward: grad [] float32 on the device; x, y, dmu, ds11, ds12 [c, h, w]
// contiguous float32 (the maps the forward wrote); out [c, h, w] written.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int gs_ssim_bwd(const float* grad, const float* x, const float* y,
                           const float* dmu, const float* ds11,
                           const float* ds12, float* out, const float* taps,
                           float n, int c, int h, int w, int device,
                           void* stream) {
  if (bad_shape(c, h, w) || grad == nullptr || x == nullptr ||
      y == nullptr || dmu == nullptr || ds11 == nullptr || ds12 == nullptr ||
      out == nullptr || taps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{grad, x, y, dmu, ds11, ds12, out, n, h, w, taps_of(taps)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssim_bwd_kernel<<<tiles(c, h, w), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler made of the kernels (common.cuh::kernel_attributes):
// attrs[0..4] the forward's, attrs[5..9] the backward's.
extern "C" int gs_ssim_kernel_attributes(int device, int* attrs) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int err = kernel_attributes(
      reinterpret_cast<const void*>(ssim_fwd_kernel), kThreads, attrs);
  if (err != 0) return err;
  return kernel_attributes(reinterpret_cast<const void*>(ssim_bwd_kernel),
                           kThreads, attrs + 5);
}
