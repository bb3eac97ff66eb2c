// Shared by the forward (K1) and backward (K3) tile rasterizers: the tile
// geometry, the compositing constants and the per-(entry, pixel) alpha.
// K3 walks a pixel's entries back to front and recovers the transmittance
// in front of each entry by dividing by the same (1 - alpha) that K1
// multiplied by, so both kernels must compute alpha from one definition:
// this header is that definition.
#pragma once

#include "common.cuh"

namespace gs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // one thread per pixel of a 16x16 tile
constexpr int kWarps = kPix / 32;
constexpr int kFeat = 10;   // x, y, conic a/b/c, opacity, r, g, b, invdepth
constexpr int kChunk = 128;
constexpr int kOut = 5;     // r, g, b, invdepth, final T
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

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

}  // namespace gs
