// The preprocess of the packed block, forward and backward, for Hopper
// (sm_90a): each slot's projection, EWA splat, opacity-aware cull radii and
// SH shading, read straight from the channel-major [R, C] parameter block.
//
// Replaces no TPU kernel: gs_tpu's preprocess is jnp (gs_tpu/core/project.py),
// which XLA fuses into one pass over the block's channel rows. Run eagerly
// in PyTorch the same arithmetic is a chain of elementwise passes over every
// slot, dead ones included, that autograd mirrors in the backward. That chain
// stays in gs_tpu_torch/core/project.py as these kernels' twin: it runs on the
// CPU and wherever override_color or cov3d_precomp is given, and the tests
// hold these kernels to it.
//
// Bound on the H100: bytes. At SH degree 3 the block has R = 64 rows (59
// real) of float32. The forward reads an alive slot's rows and writes the
// Projected fields (53 bytes a slot); the backward reads the 10 float
// cotangents and an alive slot's rows again, and writes every row of the
// [R, C] gradient, which Adam reads whole. A few hundred FP32 operations a
// slot are nothing against 67 TFLOP/s. Design: one thread per column
// (slot), so a warp's load or store of one row is one coalesced 128-byte
// line. The forward keeps nothing for the backward, which recomputes what it
// needs from the block. A dead slot reads none of its rows: the forward
// writes an invisible slot's outputs (zeros, radius 0, not visible) and the
// backward a zero column, as it does for a column whose cotangents are all
// zero, whose gradient is exactly zero. Each column is written by one thread
// with no atomics, so a result is the same bits from run to run.
//
// The rules of the twin. FP32 throughout, no fast math. The forward makes
// the twin's operations in the twin's order, each rounded as PyTorch's
// elementwise kernels round it: products and sums through __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA; IEEE
// division and sqrtf; the library's expf and logf; each constant converted
// from the twin's Python double as PyTorch converts a scalar operand. So its
// outputs are the twin's bit for bit on the card, and radius, radius_cull and
// visible, which come from ceil and comparisons that one rounding could move,
// are the twin's. Its guards are the twin's: the near cull at view z 0.2,
// the 1e-7 of the perspective division, the 1e-18 guard on the view
// direction, the 0.1 clamp of the eigenvalue discriminant, AA_DET_CLAMP and
// the 1/255 alpha of the cull radii; clamp_min, maximum and minimum pass a
// NaN on as PyTorch's do. The backward is the twin's autograd gradient
// written out (clamps pass a gradient where autograd's do, ties of maximum
// and minimum split it in halves), in FP32, in an order of its own.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDegree = 3;

constexpr float kNearCullZ = static_cast<float>(0.2);
constexpr float kLowpass = static_cast<float>(0.3);
constexpr float kAaDetClamp = static_cast<float>(0.000025);
constexpr float kProjGuard = static_cast<float>(1e-7);
constexpr float kDirGuard = static_cast<float>(1e-18);
constexpr float kDiscClamp = static_cast<float>(0.1);
constexpr float kFovClamp = static_cast<float>(1.3);
constexpr float kLogClamp = static_cast<float>(1e-12);

// the real SH basis constants (gs_tpu_torch/core/sh.py)
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC2_0 = static_cast<float>(1.0925484305920792);
constexpr float kC2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_2 = static_cast<float>(0.31539156525252005);
constexpr float kC2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_4 = static_cast<float>(0.5462742152960396);
constexpr float kC3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kC3_1 = static_cast<float>(2.890611442640554);
constexpr float kC3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_3 = static_cast<float>(0.3731763325901154);
constexpr float kC3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_5 = static_cast<float>(1.445305721320277);
constexpr float kC3_6 = static_cast<float>(-0.5900435899266435);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// PyTorch's clamp_min, maximum and minimum: a NaN operand is the result
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return isnan(a) ? a : fmaxf(a, lo);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// The autograd gradients of maximum(a, b) and minimum(a, b) with respect to
// a, for b constant: all of it where a wins, half on a tie.
__device__ __forceinline__ float maximum_grad(float g, float a, float b) {
  return a == b ? 0.5f * g : (a < b ? 0.0f : g);
}
__device__ __forceinline__ float minimum_grad(float g, float a, float b) {
  return a == b ? 0.5f * g : (a > b ? 0.0f : g);
}

struct Inputs {
  const float* block;          // [R, stride] rows, columns [0, n) read
  long long stride;            // elements between two rows
  int n;
  int sh_degree;               // the block's layout (core/packed.py)
  int antialiasing;
  const unsigned char* alive;  // [n] bool, or null: every slot alive
  const float* world_view;     // [4, 4]
  const float* full_proj;      // [4, 4]
  const float* camera_center;  // [3]
  const float* tan_fovx;       // []
  const float* tan_fovy;       // []
  int width, height;
  const long long* mask_degree;     // [] the SH ramp's degree
  const float* scaling_modifier;    // []
};

struct Outputs {
  float* mean2d;        // [n, 2]
  float* conic;         // [n, 3]
  float* depth;         // [n]
  int* radius;          // [n]
  float* rgb;           // [n, 3]
  float* opacity;       // [n]
  unsigned char* visible;  // [n] bool
  int* radius_cull;     // [n, 2]
};

// each may be null (a zero cotangent); a row stride each
struct Cotangents {
  const float* mean2d; long long mean2d_stride;
  const float* conic; long long conic_stride;
  const float* depth; long long depth_stride;
  const float* rgb; long long rgb_stride;
  const float* opacity; long long opacity_stride;
};

// the block's rows for SH degree d: xyz, DC and rest (band k colour c at
// 3 + 3k + c), log-scale, quaternion, opacity logit
__host__ __device__ constexpr int sh_terms(int d) { return (d + 1) * (d + 1); }
__host__ __device__ constexpr int row_log_scale(int d) { return 3 + 3 * sh_terms(d); }
__host__ __device__ constexpr int row_quat(int d) { return row_log_scale(d) + 3; }
__host__ __device__ constexpr int row_opacity(int d) { return row_quat(d) + 4; }
__host__ __device__ constexpr int channels(int d) { return row_opacity(d) + 1; }
__host__ __device__ constexpr int rows_of(int d) { return (channels(d) + 7) / 8 * 8; }

struct Camera {
  float v[3][4];   // world_view rows 0-2
  float p[3][4];   // full_proj rows 0, 1 and 3
  float c[3];
  float lim_x, lim_y, fx, fy, w, h;
};

__device__ __forceinline__ Camera load_camera(const Inputs& in) {
  Camera k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 3; ++r) k.v[r][i] = __ldg(in.world_view + 4 * r + i);
    k.p[0][i] = __ldg(in.full_proj + i);
    k.p[1][i] = __ldg(in.full_proj + 4 + i);
    k.p[2][i] = __ldg(in.full_proj + 12 + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) k.c[i] = __ldg(in.camera_center + i);
  const float tx = __ldg(in.tan_fovx), ty = __ldg(in.tan_fovy);
  k.lim_x = mul(kFovClamp, tx);
  k.lim_y = mul(kFovClamp, ty);
  // Camera.focal_x = width / (2 tan): Tensor.__rtruediv__, a reciprocal then
  // a product
  k.fx = mul(1.0f / mul(2.0f, tx), static_cast<float>(in.width));
  k.fy = mul(1.0f / mul(2.0f, ty), static_cast<float>(in.height));
  k.w = static_cast<float>(in.width);
  k.h = static_cast<float>(in.height);
  return k;
}

// One slot's geometry, as the twin computes it (_project_channels,
// _cov3d_channels, _cov2d_channels), and the intermediates the backward
// reads.
struct Slot {
  float x, y, z, ls[3], q[4], lop;
  float vx, vy, vz, hx, hy, pw, pix_x, pix_y;
  float qn, qh[4], R[3][3], e[3], s[3], a[3];
  float xx, xy, xz, yy, yz, zz;
  float vzc, txtz, tytz, clx, cly, tx, ty, inv_z, inv_z2, j00, j02, j11, j12;
  float u[3], v[3], su[3], sv[3];
  float cxx0, cxy, cyy0, det0, cxx, cyy, det;
};

__device__ __forceinline__ float row3(const float (&m)[4], float x, float y,
                                      float z) {
  return add(add(add(mul(m[0], x), mul(m[1], y)), mul(m[2], z)), m[3]);
}

__device__ __forceinline__ void load_slot(const Inputs& in, int j, int d,
                                          Slot& s) {
  const float* col = in.block + j;
  const long long st = in.stride;
  s.x = __ldg(col);
  s.y = __ldg(col + st);
  s.z = __ldg(col + 2 * st);
#pragma unroll
  for (int i = 0; i < 3; ++i) s.ls[i] = __ldg(col + (row_log_scale(d) + i) * st);
#pragma unroll
  for (int i = 0; i < 4; ++i) s.q[i] = __ldg(col + (row_quat(d) + i) * st);
  s.lop = __ldg(col + row_opacity(d) * st);
}

__device__ __forceinline__ void geometry(const Camera& k, float sm, Slot& s) {
  // _project_channels
  s.vx = row3(k.v[0], s.x, s.y, s.z);
  s.vy = row3(k.v[1], s.x, s.y, s.z);
  s.vz = row3(k.v[2], s.x, s.y, s.z);
  s.hx = row3(k.p[0], s.x, s.y, s.z);
  s.hy = row3(k.p[1], s.x, s.y, s.z);
  s.pw = 1.0f / add(row3(k.p[2], s.x, s.y, s.z), kProjGuard);
  s.pix_x = mul(sub(mul(add(mul(s.hx, s.pw), 1.0f), k.w), 1.0f), 0.5f);
  s.pix_y = mul(sub(mul(add(mul(s.hy, s.pw), 1.0f), k.h), 1.0f), 0.5f);

  // _cov3d_channels: Sigma = R diag(s^2) R^T
  s.qn = sqrtf(add(add(add(mul(s.q[0], s.q[0]), mul(s.q[1], s.q[1])),
                       mul(s.q[2], s.q[2])), mul(s.q[3], s.q[3])));
#pragma unroll
  for (int i = 0; i < 4; ++i) s.qh[i] = s.q[i] / s.qn;
  const float r = s.qh[0], qx = s.qh[1], qy = s.qh[2], qz = s.qh[3];
  s.R[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  s.R[0][1] = mul(2.0f, sub(mul(qx, qy), mul(r, qz)));
  s.R[0][2] = mul(2.0f, add(mul(qx, qz), mul(r, qy)));
  s.R[1][0] = mul(2.0f, add(mul(qx, qy), mul(r, qz)));
  s.R[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  s.R[1][2] = mul(2.0f, sub(mul(qy, qz), mul(r, qx)));
  s.R[2][0] = mul(2.0f, sub(mul(qx, qz), mul(r, qy)));
  s.R[2][1] = mul(2.0f, add(mul(qy, qz), mul(r, qx)));
  s.R[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.e[i] = expf(s.ls[i]);
    s.s[i] = mul(sm, s.e[i]);
    s.a[i] = mul(s.s[i], s.s[i]);
  }
  auto entry = [&](int i, int j) {
    return add(add(mul(mul(s.a[0], s.R[i][0]), s.R[j][0]),
                   mul(mul(s.a[1], s.R[i][1]), s.R[j][1])),
               mul(mul(s.a[2], s.R[i][2]), s.R[j][2]));
  };
  s.xx = entry(0, 0);
  s.xy = entry(0, 1);
  s.xz = entry(0, 2);
  s.yy = entry(1, 1);
  s.yz = entry(1, 2);
  s.zz = entry(2, 2);

  // _cov2d_channels: cov2d = (J W) Sigma (J W)^T, + the low-pass
  s.vzc = clamp_min(s.vz, kNearCullZ);
  s.txtz = s.vx / s.vzc;
  s.tytz = s.vy / s.vzc;
  s.clx = minimum(maximum(s.txtz, -k.lim_x), k.lim_x);
  s.cly = minimum(maximum(s.tytz, -k.lim_y), k.lim_y);
  s.tx = mul(s.clx, s.vzc);
  s.ty = mul(s.cly, s.vzc);
  s.inv_z = 1.0f / s.vzc;
  s.inv_z2 = mul(s.inv_z, s.inv_z);
  s.j00 = mul(k.fx, s.inv_z);
  s.j02 = mul(mul(-k.fx, s.tx), s.inv_z2);
  s.j11 = mul(k.fy, s.inv_z);
  s.j12 = mul(mul(-k.fy, s.ty), s.inv_z2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.u[i] = add(mul(s.j00, k.v[0][i]), mul(s.j02, k.v[2][i]));
    s.v[i] = add(mul(s.j11, k.v[1][i]), mul(s.j12, k.v[2][i]));
  }
  auto sig = [&](const float (&w)[3], float (&out)[3]) {
    out[0] = add(add(mul(s.xx, w[0]), mul(s.xy, w[1])), mul(s.xz, w[2]));
    out[1] = add(add(mul(s.xy, w[0]), mul(s.yy, w[1])), mul(s.yz, w[2]));
    out[2] = add(add(mul(s.xz, w[0]), mul(s.yz, w[1])), mul(s.zz, w[2]));
  };
  sig(s.u, s.su);
  sig(s.v, s.sv);
  auto dot = [](const float (&a)[3], const float (&b)[3]) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
  };
  s.cxx0 = dot(s.u, s.su);
  s.cxy = dot(s.v, s.su);
  s.cyy0 = dot(s.v, s.sv);
  s.det0 = sub(mul(s.cxx0, s.cyy0), mul(s.cxy, s.cxy));
  s.cxx = add(s.cxx0, kLowpass);
  s.cyy = add(s.cyy0, kLowpass);
  s.det = sub(mul(s.cxx, s.cyy), mul(s.cxy, s.cxy));
}

// The unit view direction and the products the SH basis shares.
struct Dir {
  float x, y, z, xx, yy, zz, xy, yz, xz;
};

// Basis function k of eval_sh_channels at `d`, the factor the twin
// multiplies coefficient k by, with the twin's roundings (the bands it
// subtracts, 1 and 3, negated: r - t and r + (-t) round alike).
__device__ __forceinline__ float sh_basis(int k, const Dir& d) {
  switch (k) {
    case 0: return kC0;
    case 1: return -mul(kC1, d.y);
    case 2: return mul(kC1, d.z);
    case 3: return -mul(kC1, d.x);
    case 4: return mul(kC2_0, d.xy);
    case 5: return mul(kC2_1, d.yz);
    case 6: return mul(kC2_2, sub(sub(mul(2.0f, d.zz), d.xx), d.yy));
    case 7: return mul(kC2_3, d.xz);
    case 8: return mul(kC2_4, sub(d.xx, d.yy));
    case 9: return mul(mul(kC3_0, d.y), sub(mul(3.0f, d.xx), d.yy));
    case 10: return mul(mul(kC3_1, d.xy), d.z);
    case 11: return mul(mul(kC3_2, d.y), sub(sub(mul(4.0f, d.zz), d.xx), d.yy));
    case 12: return mul(mul(kC3_3, d.z),
                        sub(sub(mul(2.0f, d.zz), mul(3.0f, d.xx)), mul(3.0f, d.yy)));
    case 13: return mul(mul(kC3_4, d.x), sub(sub(mul(4.0f, d.zz), d.xx), d.yy));
    case 14: return mul(mul(kC3_5, d.z), sub(d.xx, d.yy));
    default: return mul(mul(kC3_6, d.x), sub(d.xx, mul(3.0f, d.yy)));
  }
}

// The gradient of basis function k with respect to the unit direction.
__device__ __forceinline__ void sh_basis_grad(int k, const Dir& d, float& gx,
                                              float& gy, float& gz) {
  switch (k) {
    case 0: gx = 0.0f; gy = 0.0f; gz = 0.0f; break;
    case 1: gx = 0.0f; gy = -kC1; gz = 0.0f; break;
    case 2: gx = 0.0f; gy = 0.0f; gz = kC1; break;
    case 3: gx = -kC1; gy = 0.0f; gz = 0.0f; break;
    case 4: gx = kC2_0 * d.y; gy = kC2_0 * d.x; gz = 0.0f; break;
    case 5: gx = 0.0f; gy = kC2_1 * d.z; gz = kC2_1 * d.y; break;
    case 6: gx = -2.0f * kC2_2 * d.x; gy = -2.0f * kC2_2 * d.y;
            gz = 4.0f * kC2_2 * d.z; break;
    case 7: gx = kC2_3 * d.z; gy = 0.0f; gz = kC2_3 * d.x; break;
    case 8: gx = 2.0f * kC2_4 * d.x; gy = -2.0f * kC2_4 * d.y; gz = 0.0f; break;
    case 9: gx = kC3_0 * 6.0f * d.xy; gy = kC3_0 * (3.0f * d.xx - 3.0f * d.yy);
            gz = 0.0f; break;
    case 10: gx = kC3_1 * d.yz; gy = kC3_1 * d.xz; gz = kC3_1 * d.xy; break;
    case 11: gx = kC3_2 * -2.0f * d.xy;
             gy = kC3_2 * (4.0f * d.zz - d.xx - 3.0f * d.yy);
             gz = kC3_2 * 8.0f * d.yz; break;
    case 12: gx = kC3_3 * -6.0f * d.xz; gy = kC3_3 * -6.0f * d.yz;
             gz = kC3_3 * (6.0f * d.zz - 3.0f * d.xx - 3.0f * d.yy); break;
    case 13: gx = kC3_4 * (4.0f * d.zz - 3.0f * d.xx - d.yy);
             gy = kC3_4 * -2.0f * d.xy; gz = kC3_4 * 8.0f * d.xz; break;
    case 14: gx = kC3_5 * 2.0f * d.xz; gy = kC3_5 * -2.0f * d.yz;
             gz = kC3_5 * (d.xx - d.yy); break;
    default: gx = kC3_6 * (3.0f * d.xx - 3.0f * d.yy); gy = kC3_6 * -6.0f * d.xy;
             gz = 0.0f; break;
  }
}

// The view direction of the twin: (xyz - centre) / max(|.|^2, 1e-18)^0.5.
// Returns the squared norm; `inv_n` the reciprocal of its guarded root.
__device__ __forceinline__ float direction(const Camera& k, const Slot& s,
                                           float (&dd)[3], float& inv_n,
                                           Dir& d) {
  dd[0] = sub(s.x, k.c[0]);
  dd[1] = sub(s.y, k.c[1]);
  dd[2] = sub(s.z, k.c[2]);
  const float sq = add(add(mul(dd[0], dd[0]), mul(dd[1], dd[1])),
                       mul(dd[2], dd[2]));
  inv_n = 1.0f / sqrtf(clamp_min(sq, kDirGuard));
  d.x = mul(dd[0], inv_n);
  d.y = mul(dd[1], inv_n);
  d.z = mul(dd[2], inv_n);
  d.xx = mul(d.x, d.x);
  d.yy = mul(d.y, d.y);
  d.zz = mul(d.z, d.z);
  d.xy = mul(d.x, d.y);
  d.yz = mul(d.y, d.z);
  d.xz = mul(d.x, d.z);
  return sq;
}

// The SH coefficients of basis function k at or above this many are the
// ramp's masked ones: they read as zero.
__device__ __forceinline__ int kept_terms(const Inputs& in) {
  const long long m = __ldg(in.mask_degree);
  return m < 0 ? 0 : (m >= kMaxDegree ? sh_terms(kMaxDegree)
                                      : static_cast<int>((m + 1) * (m + 1)));
}

// rgb before the twin's + 0.5 and clamp: the sum over the first (E + 1)^2
// basis functions in the twin's order; with kGrad also, per colour, the
// gradient of that sum with respect to the unit direction.
template <int E, bool kGrad>
__device__ __forceinline__ void shade(const Inputs& in, int j, int kept,
                                      const Dir& d, float (&res)[3],
                                      float (&gdir)[3][3]) {
  const float* col = in.block + j;
  const long long st = in.stride;
#pragma unroll
  for (int k = 0; k < sh_terms(E); ++k) {
    const float b = sh_basis(k, d);
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    if (kGrad) sh_basis_grad(k, d, gx, gy, gz);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float coef = k < kept ? __ldg(col + (3 + 3 * k + c) * st) : 0.0f;
      res[c] = k == 0 ? mul(b, coef) : add(res[c], mul(b, coef));
      if (kGrad) {
        gdir[c][0] += coef * gx;
        gdir[c][1] += coef * gy;
        gdir[c][2] += coef * gz;
      }
    }
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads)
preprocess_fwd_kernel(const Inputs in, const Outputs out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= in.n) return;
  if (in.alive != nullptr && !in.alive[j]) {
    out.mean2d[2 * j] = 0.0f;
    out.mean2d[2 * j + 1] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out.conic[3 * j + c] = 0.0f;
      out.rgb[3 * j + c] = 0.0f;
    }
    out.depth[j] = 0.0f;
    out.radius[j] = 0;
    out.opacity[j] = 0.0f;
    out.visible[j] = 0;
    out.radius_cull[2 * j] = 0;
    out.radius_cull[2 * j + 1] = 0;
    return;
  }
  const int d = in.sh_degree;
  const Camera k = load_camera(in);
  Slot s;
  load_slot(in, j, d, s);
  const float sm = __ldg(in.scaling_modifier);
  geometry(k, sm, s);

  const bool det_ok = s.det != 0.0f;
  const float inv_det = det_ok ? 1.0f / s.det : 0.0f;
  const float mid = mul(0.5f, add(s.cxx, s.cyy));
  const float disc = sqrtf(clamp_min(sub(mul(mid, mid), s.det), kDiscClamp));
  const float radius_f =
      ceilf(mul(3.0f, sqrtf(maximum(add(mid, disc), sub(mid, disc)))));
  float opacity = 1.0f / add(1.0f, expf(-s.lop));
  if (in.antialiasing) {
    opacity = mul(opacity, sqrtf(clamp_min(s.det0 / s.det, kAaDetClamp)));
  }
  const int radius = (s.vz > kNearCullZ && det_ok)
                         ? static_cast<int>(radius_f) : 0;
  const bool visible = radius > 0;
  // opacity-aware cull radii: alpha >= 1/255 only where
  // d^T Sigma^-1 d <= 2 ln(255 op)
  const float log_term = logf(clamp_min(mul(255.0f, opacity), kLogClamp));
  const float two_l = mul(2.0f, clamp_min(log_term, 0.0f));
  const float rcx = add(ceilf(sqrtf(mul(two_l, clamp_min(s.cxx, 0.0f)))), 1.0f);
  const float rcy = add(ceilf(sqrtf(mul(two_l, clamp_min(s.cyy, 0.0f)))), 1.0f);
  const bool keep = visible && log_term > 0.0f;

  float dd[3], inv_n;
  Dir dir;
  direction(k, s, dd, inv_n, dir);
  float res[3], unused[3][3];
  shade<E, false>(in, j, kept_terms(in), dir, res, unused);

  out.mean2d[2 * j] = s.pix_x;
  out.mean2d[2 * j + 1] = s.pix_y;
  out.conic[3 * j] = mul(s.cyy, inv_det);
  out.conic[3 * j + 1] = mul(-s.cxy, inv_det);
  out.conic[3 * j + 2] = mul(s.cxx, inv_det);
  out.depth[j] = s.vz;
  out.radius[j] = radius;
#pragma unroll
  for (int c = 0; c < 3; ++c) out.rgb[3 * j + c] = clamp_min(add(res[c], 0.5f), 0.0f);
  out.opacity[j] = opacity;
  out.visible[j] = visible;
  out.radius_cull[2 * j] = keep ? static_cast<int>(minimum(rcx, radius_f)) : 0;
  out.radius_cull[2 * j + 1] = keep ? static_cast<int>(minimum(rcy, radius_f)) : 0;
}

__device__ __forceinline__ float cotangent(const float* p, long long stride,
                                           int j, int c) {
  return p != nullptr ? __ldg(p + j * stride + c) : 0.0f;
}

template <int E>
__global__ void __launch_bounds__(kThreads)
preprocess_bwd_kernel(const Inputs in, const Cotangents ct, float* grad,
                      int rows) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= in.n) return;
  float* g = grad + j;
  const int n = in.n;
  float gm[2] = {0.0f, 0.0f}, gc[3] = {0.0f, 0.0f, 0.0f};
  float gr[3] = {0.0f, 0.0f, 0.0f}, gd = 0.0f, go = 0.0f;
  bool any = false;
  if (in.alive == nullptr || in.alive[j]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < 2) gm[c] = cotangent(ct.mean2d, ct.mean2d_stride, j, c);
      gc[c] = cotangent(ct.conic, ct.conic_stride, j, c);
      gr[c] = cotangent(ct.rgb, ct.rgb_stride, j, c);
    }
    gd = cotangent(ct.depth, ct.depth_stride, j, 0);
    go = cotangent(ct.opacity, ct.opacity_stride, j, 0);
    any = gm[0] != 0.0f || gm[1] != 0.0f || gc[0] != 0.0f || gc[1] != 0.0f ||
          gc[2] != 0.0f || gr[0] != 0.0f || gr[1] != 0.0f || gr[2] != 0.0f ||
          gd != 0.0f || go != 0.0f;
  }
  if (!any) {
    // a dead slot's outputs are constants; a zero cotangent gives zero
    for (int r = 0; r < rows; ++r) g[static_cast<long long>(r) * n] = 0.0f;
    return;
  }
  const int d = in.sh_degree;
  const Camera k = load_camera(in);
  Slot s;
  load_slot(in, j, d, s);
  const float sm = __ldg(in.scaling_modifier);
  geometry(k, sm, s);

  // SH shading: the clamp passes a colour's cotangent where rgb + 0.5 >= 0
  float dd[3], inv_n;
  Dir dir;
  const float sq = direction(k, s, dd, inv_n, dir);
  const int kept = kept_terms(in);
  float res[3], gdir[3][3] = {};
  shade<E, true>(in, j, kept, dir, res, gdir);
  float g_dir[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gr[c] = add(res[c], 0.5f) >= 0.0f ? gr[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) g_dir[i] += gr[c] * gdir[c][i];
  }
  // unit direction = dd * inv_n, inv_n = 1 / sqrt(max(sq, 1e-18))
  float g_pos[3];
  float g_inv_n = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_pos[i] = g_dir[i] * inv_n;
    g_inv_n += g_dir[i] * dd[i];
  }
  if (sq >= kDirGuard) {
    // d(1/r)/dr = -1/r^2 = -inv_n^2; dr/dsq = 1 / (2 r) = inv_n / 2
    const float g_sq = -g_inv_n * inv_n * inv_n * (0.5f * inv_n);
#pragma unroll
    for (int i = 0; i < 3; ++i) g_pos[i] += 2.0f * dd[i] * g_sq;
  }

  // opacity: sigmoid, times the antialiasing scale
  const float sig = 1.0f / add(1.0f, expf(-s.lop));
  float g_sig = go, g_det0 = 0.0f, g_det = 0.0f;
  if (in.antialiasing) {
    const float ratio = s.det0 / s.det;
    const float h = sqrtf(clamp_min(ratio, kAaDetClamp));
    g_sig = go * h;
    // the clamp passes nothing below its floor; the quotient's backward
    // then divides that zero by det, a NaN at det 0 as autograd's is
    const float g_ratio = ratio >= kAaDetClamp ? go * sig / (2.0f * h) : 0.0f;
    g_det0 = g_ratio / s.det;
    g_det = -g_ratio * (ratio / s.det);
  }
  const float g_lop = g_sig * (1.0f - sig) * sig;

  // conic = (cyy, -cxy, cxx) / det on det != 0
  const bool det_ok = s.det != 0.0f;
  const float inv_det = det_ok ? 1.0f / s.det : 0.0f;
  float g_cxx = gc[2] * inv_det, g_cyy = gc[0] * inv_det;
  float g_cxy = -gc[1] * inv_det;
  if (det_ok) {
    const float g_inv = gc[0] * s.cyy - gc[1] * s.cxy + gc[2] * s.cxx;
    g_det += -g_inv * inv_det * inv_det;
  }
  g_cxx += g_det * s.cyy + g_det0 * s.cyy0;
  g_cyy += g_det * s.cxx + g_det0 * s.cxx0;
  g_cxy -= 2.0f * (g_det + g_det0) * s.cxy;

  // cxx = u.Su, cxy = v.Su, cyy = v.Sv
  float g_u[3], g_v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_u[i] = 2.0f * g_cxx * s.su[i] + g_cxy * s.sv[i];
    g_v[i] = g_cxy * s.su[i] + 2.0f * g_cyy * s.sv[i];
  }
  // Sigma's six channels
  const float* u = s.u;
  const float* v = s.v;
  auto g_sig6 = [&](int a, int b) {
    if (a == b) return g_cxx * u[a] * u[a] + g_cxy * v[a] * u[a] +
                       g_cyy * v[a] * v[a];
    return 2.0f * g_cxx * u[a] * u[b] + g_cxy * (v[a] * u[b] + v[b] * u[a]) +
           2.0f * g_cyy * v[a] * v[b];
  };
  // the symmetric M with M_ii = dSigma_ii and M_ij = dSigma_ij / 2
  float M[3][3];
  M[0][0] = g_sig6(0, 0);
  M[1][1] = g_sig6(1, 1);
  M[2][2] = g_sig6(2, 2);
  M[0][1] = M[1][0] = 0.5f * g_sig6(0, 1);
  M[0][2] = M[2][0] = 0.5f * g_sig6(0, 2);
  M[1][2] = M[2][1] = 0.5f * g_sig6(1, 2);

  // u = j00 W0 + j02 W2, v = j11 W1 + j12 W2 (W = world_view's rotation)
  float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_j00 += g_u[i] * k.v[0][i];
    g_j02 += g_u[i] * k.v[2][i];
    g_j11 += g_v[i] * k.v[1][i];
    g_j12 += g_v[i] * k.v[2][i];
  }
  // j00 = fx / z, j02 = -fx tx / z^2, j11 = fy / z, j12 = -fy ty / z^2
  const float g_inv_z2 = g_j02 * (-k.fx * s.tx) + g_j12 * (-k.fy * s.ty);
  const float g_inv_z = k.fx * g_j00 + k.fy * g_j11 + 2.0f * s.inv_z * g_inv_z2;
  const float g_tx = g_j02 * -k.fx * s.inv_z2;
  const float g_ty = g_j12 * -k.fy * s.inv_z2;
  float g_vzc = -g_inv_z * s.inv_z * s.inv_z;
  // tx = clamp(vx / z) z
  g_vzc += g_tx * s.clx + g_ty * s.cly;
  const float g_txtz = maximum_grad(minimum_grad(g_tx * s.vzc,
      maximum(s.txtz, -k.lim_x), k.lim_x), s.txtz, -k.lim_x);
  const float g_tytz = maximum_grad(minimum_grad(g_ty * s.vzc,
      maximum(s.tytz, -k.lim_y), k.lim_y), s.tytz, -k.lim_y);
  const float g_vx = g_txtz / s.vzc;
  const float g_vy = g_tytz / s.vzc;
  g_vzc -= (g_txtz * s.vx + g_tytz * s.vy) / (s.vzc * s.vzc);
  const float g_vz = gd + (s.vz >= kNearCullZ ? g_vzc : 0.0f);

  // pix = ((h * pw + 1) * size - 1) / 2, pw = 1 / (hw + 1e-7)
  const float g_hpx = gm[0] * 0.5f * k.w;
  const float g_hpy = gm[1] * 0.5f * k.h;
  const float g_pw = g_hpx * s.hx + g_hpy * s.hy;
  const float g_hx = g_hpx * s.pw;
  const float g_hy = g_hpy * s.pw;
  const float g_hw = -g_pw * s.pw * s.pw;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_pos[i] += k.v[0][i] * g_vx + k.v[1][i] * g_vy + k.v[2][i] * g_vz +
                k.p[0][i] * g_hx + k.p[1][i] * g_hy + k.p[2][i] * g_hw;
  }

  // Sigma = R diag(a) R^T: da_k = sum_ij M_ij R_ik R_jk, dR = 2 M R diag(a)
  float g_R[3][3], g_ls[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float g_a = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float mr = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) mr += M[i][jj] * s.R[jj][c];
      g_a += mr * s.R[i][c];
      g_R[i][c] = 2.0f * mr * s.a[c];
    }
    // a = s^2, s = modifier e^ls
    g_ls[c] = 2.0f * g_a * s.s[c] * sm * s.e[c];
  }
  // R of the unit quaternion (w, x, y, z)
  const float w = s.qh[0], x = s.qh[1], y = s.qh[2], z = s.qh[3];
  float g_qh[4];
  g_qh[0] = 2.0f * (-z * g_R[0][1] + y * g_R[0][2] + z * g_R[1][0] -
                    x * g_R[1][2] - y * g_R[2][0] + x * g_R[2][1]);
  g_qh[1] = 2.0f * (y * g_R[0][1] + z * g_R[0][2] + y * g_R[1][0] -
                    2.0f * x * g_R[1][1] - w * g_R[1][2] + z * g_R[2][0] +
                    w * g_R[2][1] - 2.0f * x * g_R[2][2]);
  g_qh[2] = 2.0f * (-2.0f * y * g_R[0][0] + x * g_R[0][1] + w * g_R[0][2] +
                    x * g_R[1][0] + z * g_R[1][2] - w * g_R[2][0] +
                    z * g_R[2][1] - 2.0f * y * g_R[2][2]);
  g_qh[3] = 2.0f * (-2.0f * z * g_R[0][0] - w * g_R[0][1] + x * g_R[0][2] +
                    w * g_R[1][0] - 2.0f * z * g_R[1][1] + y * g_R[1][2] +
                    x * g_R[2][0] + y * g_R[2][1]);
  // qh = q / |q|
  float qdot = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) qdot += g_qh[i] * s.q[i];
  const float qn3 = s.qn * s.qn * s.qn;

  // every row of the column
  const long long st = n;
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i * st] = g_pos[i];
#pragma unroll
  for (int kk = 0; kk < sh_terms(E); ++kk) {
    const float b = kk < kept ? sh_basis(kk, dir) : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) g[(3 + 3 * kk + c) * st] = gr[c] * b;
  }
  for (int r = 3 + 3 * sh_terms(E); r < row_log_scale(d); ++r) g[r * st] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) g[(row_log_scale(d) + i) * st] = g_ls[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[(row_quat(d) + i) * st] = g_qh[i] / s.qn - s.q[i] * qdot / qn3;
  }
  g[row_opacity(d) * st] = g_lop;
  for (int r = channels(d); r < rows; ++r) g[r * st] = 0.0f;
}

template <int E>
int launch(const Inputs& in, const Outputs* out, const Cotangents* ct,
           float* grad, int rows, cudaStream_t stream) {
  const int blocks = (in.n + kThreads - 1) / kThreads;
  if (out != nullptr) {
    preprocess_fwd_kernel<E><<<blocks, kThreads, 0, stream>>>(in, *out);
  } else {
    preprocess_bwd_kernel<E><<<blocks, kThreads, 0, stream>>>(in, *ct, grad,
                                                              rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Inputs& in, int eval_degree, const Outputs* out,
             const Cotangents* ct, float* grad, int rows, int device,
             void* stream) {
  if (in.n <= 0 || in.sh_degree < 0 || in.sh_degree > kMaxDegree ||
      eval_degree < 0 || eval_degree > in.sh_degree ||
      in.mask_degree == nullptr || in.scaling_modifier == nullptr ||
      (out == nullptr && rows != rows_of(in.sh_degree))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (eval_degree) {
    case 0: return launch<0>(in, out, ct, grad, rows, s);
    case 1: return launch<1>(in, out, ct, grad, rows, s);
    case 2: return launch<2>(in, out, ct, grad, rows, s);
    default: return launch<3>(in, out, ct, grad, rows, s);
  }
}

Inputs inputs(const float* block, long long stride, int n, int sh_degree,
              int antialiasing, const unsigned char* alive,
              const float* world_view, const float* full_proj,
              const float* camera_center, const float* tan_fovx,
              const float* tan_fovy, int width, int height,
              const long long* mask_degree, const float* scaling_modifier) {
  return Inputs{block, stride, n, sh_degree, antialiasing, alive, world_view,
                full_proj, camera_center, tan_fovx, tan_fovy, width, height,
                mask_degree, scaling_modifier};
}

}  // namespace

// The forward: block [rows, >= n] float32 with row stride `stride` (a column
// slice of a wider block is fine), its columns [0, n) the slots; alive [n]
// bool or null; the camera's tensors (world_view and full_proj [4, 4],
// camera_center [3], tan_fovx and tan_fovy []); the SH ramp's degree, a []
// int64, and scaling_modifier, a [] float32, both on the device. Evaluates
// SH to `eval_degree` <= sh_degree <= 3. Writes mean2d [n, 2], conic
// [n, 3], depth [n], radius [n] int32, rgb [n, 3], opacity [n], visible [n]
// bool, radius_cull [n, 2] int32, all contiguous. Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError()
// (cudaErrorInvalidValue for n <= 0, a degree out of range or a null mask
// degree or scaling modifier).
extern "C" int gs_preprocess_fwd(
    const float* block, long long stride, int n, int sh_degree,
    int eval_degree, int antialiasing, const unsigned char* alive,
    const float* world_view, const float* full_proj,
    const float* camera_center, const float* tan_fovx, const float* tan_fovy,
    int width, int height, const long long* mask_degree,
    const float* scaling_modifier, float* mean2d,
    float* conic, float* depth, int* radius, float* rgb, float* opacity,
    unsigned char* visible, int* radius_cull, int device, void* stream) {
  const Inputs in = inputs(block, stride, n, sh_degree, antialiasing, alive,
                           world_view, full_proj, camera_center, tan_fovx,
                           tan_fovy, width, height, mask_degree,
                           scaling_modifier);
  const Outputs out{mean2d, conic, depth, radius, rgb, opacity, visible,
                    radius_cull};
  return dispatch(in, eval_degree, &out, nullptr, nullptr, 0, device, stream);
}

// The backward: the forward's inputs, the cotangents of mean2d [n, 2], conic
// [n, 3], depth [n], rgb [n, 3] and opacity [n] (each null for zero, each
// with its row stride; a row's entries contiguous), and grad [rows, n]
// float32, contiguous, rows the layout's padded count: every row written.
extern "C" int gs_preprocess_bwd(
    const float* block, long long stride, int n, int sh_degree,
    int eval_degree, int antialiasing, const unsigned char* alive,
    const float* world_view, const float* full_proj,
    const float* camera_center, const float* tan_fovx, const float* tan_fovy,
    int width, int height, const long long* mask_degree,
    const float* scaling_modifier,
    const float* g_mean2d, long long s_mean2d, const float* g_conic,
    long long s_conic, const float* g_depth, long long s_depth,
    const float* g_rgb, long long s_rgb, const float* g_opacity,
    long long s_opacity, float* grad, int rows, int device, void* stream) {
  const Inputs in = inputs(block, stride, n, sh_degree, antialiasing, alive,
                           world_view, full_proj, camera_center, tan_fovx,
                           tan_fovy, width, height, mask_degree,
                           scaling_modifier);
  const Cotangents ct{g_mean2d, s_mean2d, g_conic, s_conic, g_depth, s_depth,
                      g_rgb, s_rgb, g_opacity, s_opacity};
  return dispatch(in, eval_degree, nullptr, &ct, grad, rows, device, stream);
}

// What the compiler made of the SH degree 3 kernels: attrs[0..4] of the
// forward, attrs[5..9] of the backward (common.cuh's kernel_attributes).
extern "C" int gs_preprocess_kernel_attributes(int device, int* attrs) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int err = kernel_attributes(
      reinterpret_cast<const void*>(preprocess_fwd_kernel<3>), kThreads,
      attrs);
  if (err != 0) return err;
  return kernel_attributes(
      reinterpret_cast<const void*>(preprocess_bwd_kernel<3>), kThreads,
      attrs + 5);
}
