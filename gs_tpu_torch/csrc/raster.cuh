// Shared by the forward (K1) and backward (K3) tile rasterizers: the tile
// geometry, the compositing constants, the per-(entry, pixel) alpha, the
// packed shared-memory entry and the two conservative skips.
//
// K3 walks a pixel's entries back to front and recovers the transmittance
// in front of each entry by dividing by the same (1 - alpha) that K1
// multiplied by, so both kernels must compute alpha from one definition and
// drop the same pairs: this header is that definition. Both skips below
// only ever drop pairs whose alpha is below 1/255, which both kernels would
// drop anyway, so they change no result, only the work.
#pragma once

#include "common.cuh"

namespace gs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kFeat = 10;   // x, y, conic a/b/c, opacity, r, g, b, invdepth
constexpr int kChunk = 128;
constexpr int kOut = 5;     // r, g, b, invdepth, final T
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// The tile's 256 pixels form eight 8x4 blocks, 2 across and 4 down: block
// b at (8 (b % 2), 4 (b / 2)). A warp works on whole blocks, so its 32
// lanes' pixels are compact and it can skip an entry that misses a block.
// Lane l holds pixel (l % 8, l / 8) of a block; the [tiles, 5, 256] and
// [tiles, 256] layouts keep pixel (x, y) at y*16+x.
constexpr int kBlockW = 8;
constexpr int kBlockH = 4;

struct Pixel {
  int index;      // y * 16 + x inside the tile
  float px, py;   // image coordinates
  int x0, y0;     // the block's first pixel, image coordinates
};

// The global tile row of tile t. Tiles come in local rows of gx; a band of
// a multi-GPU render owns a set of the image's tile rows, and row_map
// [tiles / gx] gives the global row of each local one (the TPU kernel's
// rowp input, gs_tpu/ops/rasterize_pallas.py:70-76). A full frame passes
// no map: local row = global row. Outputs stay in local tile order.
__device__ __forceinline__ int tile_row(const int* __restrict__ row_map,
                                        int t, int gx) {
  return row_map ? __ldg(row_map + t / gx) : t / gx;
}

__device__ __forceinline__ Pixel pixel_of(int t, int gx, int trow, int block,
                                          int lane) {
  const int bx = (block & 1) * kBlockW, by = (block >> 1) * kBlockH;
  const int x = bx + (lane & (kBlockW - 1)), y = by + lane / kBlockW;
  const int tx = (t % gx) * kTile, ty = trow * kTile;
  return {y * kTile + x, static_cast<float>(tx + x),
          static_cast<float>(ty + y), tx + bx, ty + by};
}

// Tile t's entry window [start, limit): the tile's range cut at
// max_chunks 128-entry chunks from start rounded down to 128 (the TPU
// kernel's chunk window, kept so every version reads the same entries).
struct Window {
  int start;
  int limit;
};

__device__ __forceinline__ Window tile_window(const int* tile_start,
                                              const int* tile_end, int t,
                                              int max_chunks) {
  const int start = tile_start[t];
  const int base = (start / kChunk) * kChunk;
  return {start, min(tile_end[t], base + max_chunks * kChunk)};
}

// The Gaussian exponent of an entry at pixel offset (dx, dy) = mean - pixel:
// -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy, rounded step by step in the
// order the plain PyTorch version (ops/composite.py::splat_power) evaluates
// it. The _rn intrinsics are never contracted into FMAs, so on the card
// the kernels and the plain versions compute the same exponent bit for bit,
// then the same expf (libdevice's, which PyTorch's exp also calls) and the
// same alpha: an (entry, pixel) pair at the alpha >= 1/255 cut falls on
// the same side in both. With contracted FMAs a few hundred of the 1080p
// bench frame's 669 M pairs fell on the other side, and each moved its
// entry's opacity gradient by up to dalpha * exp(power) ~ 0.04 dalpha.
__device__ __forceinline__ float splat_power(float dx, float dy, float ca,
                                             float cb, float cc) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                            __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// min and max that return NaN when either operand is NaN, as torch.minimum
// and torch.maximum do (fminf/fmaxf drop the NaN).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An entry packed for shared memory as three 16-byte words, so that a
// pair reads it with at most three 128-bit broadcasts:
//   w0 = (x, y, conic a, conic b)   w1 = (conic c, opacity, r, g)
//   w2 = (b, invdepth, cut, 0)
// cut is the entry's confident-miss limit on q = -2 * power, computed once
// when the entry is staged (ops/rasterize.py::entry_cut, the same rounding):
//   two_l = 2 ln(max(255 opacity, 1)),  cut = two_l (1 + 1e-4) + 1e-3,
// two_l being the q at which opacity * exp(-q / 2) = 1/255 (the limit the
// binning's exact tile cull uses, ops/binning.py::quad_limit), with the
// binning's margin for rounding. A NaN opacity gives a NaN cut, which no
// comparison below passes: such an entry is never skipped.
constexpr int kWords = 3;

__device__ __forceinline__ float entry_cut(float opacity) {
  float s = __fmul_rn(255.0f, opacity);
  s = s < 1.0f ? 1.0f : s;
  const float two_l = __fmul_rn(2.0f, logf(s));
  return __fadd_rn(__fmul_rn(two_l, static_cast<float>(1.0 + 1e-4)), 1e-3f);
}

// Entry e of the [10, d] rows into registers, then packed into slot j of
// `words` (laid out [kWords][batch]).
__device__ __forceinline__ void load_entry(const float* __restrict__ feats,
                                           int d, int e, float v[kFeat]) {
#pragma unroll
  for (int f = 0; f < kFeat; ++f)
    v[f] = __ldg(feats + static_cast<size_t>(f) * d + e);
}

__device__ __forceinline__ void store_entry(float4* words, int batch, int j,
                                            const float v[kFeat]) {
  words[j] = make_float4(v[0], v[1], v[2], v[3]);
  words[batch + j] = make_float4(v[4], v[5], v[6], v[7]);
  words[2 * batch + j] = make_float4(v[8], v[9], entry_cut(v[5]), 0.0f);
}

// The minimum over the rectangle [x_lo, x_hi] x [y_lo, y_hi] of
// q = ca dx^2 + 2 cb dx dy + cc dy^2, (dx, dy) = point - mean: 0 when the
// mean is inside, else on an edge at the clamped 1-D minimiser. Rounded as
// ops/binning.py::quad_min_rect (the binning's exact tile cull) rounds it,
// NaN propagated as there.
__device__ __forceinline__ float quad_min_rect(float ex, float ey, float ca,
                                               float cb, float cc, float x_lo,
                                               float x_hi, float y_lo,
                                               float y_hi) {
  ca = __fadd_rn(ca, 1e-20f);
  cc = __fadd_rn(cc, 1e-20f);
  const float dx0 = __fsub_rn(x_lo, ex), dx1 = __fsub_rn(x_hi, ex);
  const float dy0 = __fsub_rn(y_lo, ey), dy1 = __fsub_rn(y_hi, ey);
  const float nb = -cb, b2 = __fmul_rn(2.0f, cb);
  auto clip = [](float v, float lo, float hi) {
    return min_nan(max_nan(v, lo), hi);
  };
  auto q = [&](float dx, float dy) {
    return __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                  __fmul_rn(__fmul_rn(b2, dx), dy)),
        __fmul_rn(__fmul_rn(cc, dy), dy));
  };
  const float cx0 = clip(__fdiv_rn(__fmul_rn(nb, dy0), ca), dx0, dx1);
  const float cx1 = clip(__fdiv_rn(__fmul_rn(nb, dy1), ca), dx0, dx1);
  const float cy0 = clip(__fdiv_rn(__fmul_rn(nb, dx0), cc), dy0, dy1);
  const float cy1 = clip(__fdiv_rn(__fmul_rn(nb, dx1), cc), dy0, dy1);
  const float qmin = min_nan(min_nan(q(cx0, dy0), q(cx1, dy1)),
                             min_nan(q(dx0, cy0), q(dx1, cy1)));
  const bool inside = dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
  return inside ? 0.0f : qmin;
}

// The warp-uniform skip: true when no pixel of the 8x4 block at (x0, y0)
// can composite the entry, i.e. when q's minimum over the rectangle of
// the block's pixel centres exceeds the entry's cut by more than 1e-5 of
// the largest term q can have there, which bounds the rounding of both
// q's. Only a conic with positive diagonal is skipped: then each edge's
// restriction is convex and the edge minima are exact. A NaN anywhere
// keeps the entry. ops/rasterize.py::block_misses is this test in
// PyTorch, rounding for rounding.
__device__ __forceinline__ bool block_misses(float4 w0, float4 w1, float4 w2,
                                             int x0, int y0) {
  const float ex = w0.x, ey = w0.y, ca = w0.z, cb = w0.w, cc = w1.x;
  const float x_lo = static_cast<float>(x0);
  const float x_hi = static_cast<float>(x0 + kBlockW - 1);
  const float y_lo = static_cast<float>(y0);
  const float y_hi = static_cast<float>(y0 + kBlockH - 1);
  const float qmin = quad_min_rect(ex, ey, ca, cb, cc, x_lo, x_hi, y_lo, y_hi);
  const float mx = max_nan(fabsf(__fsub_rn(x_lo, ex)), fabsf(__fsub_rn(x_hi, ex)));
  const float my = max_nan(fabsf(__fsub_rn(y_lo, ey)), fabsf(__fsub_rn(y_hi, ey)));
  const float ab = fabsf(cb);
  const float mag = __fadd_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(fabsf(ca), ab), mx), mx),
      __fmul_rn(__fmul_rn(__fadd_rn(fabsf(cc), ab), my), my));
  return ca > 0.0f && cc > 0.0f && qmin > __fadd_rn(w2.z, __fmul_rn(1e-5f, mag));
}

// The per-pair pre-filter, before expf: a pair whose q = -2 power exceeds
// the entry's cut has op * exp(power) < 1/255 by a margin larger than the
// rounding of expf and of the product, so it is faint.
__device__ __forceinline__ bool faint_by_power(float power, float cut) {
  return __fmul_rn(-2.0f, power) > cut;
}

}  // namespace gs
