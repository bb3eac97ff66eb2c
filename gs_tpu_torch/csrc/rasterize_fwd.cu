// K1 — forward tile rasterizer (no-grad), for Hopper (sm_90a).
//
// Replaces gs_tpu/ops/rasterize_pallas.py::_fwd_kernel (:125-225, called
// from _raster_tiles_fwd :559) in its save_ustore=False form. Per 16x16
// tile, front-to-back alpha compositing of the tile's depth-sorted entries
// [start, min(end, base + max_chunks * 128)), base = start rounded down to
// 128 (the TPU kernel's chunk window, kept so both read the same entries).
// Per pixel: alpha = min(0.99, op * exp(power)), skipped when power > 0 or
// alpha < 1/255; the pixel stops before the contribution that would take
// T below 1e-4 and keeps the last T >= 1e-4 as its final T (the frozen-T
// rule of gs_tpu/ops/composite.py).
//
// feats is [10, D] float32 rows (x, y, conic a/b/c, opacity, r, g, b,
// invdepth); out is [tiles, 5, 256] float32 rows (r, g, b, invdepth,
// final T), pixel p of a tile at (p % 16, p / 16).
//
// Bound on the H100: at the 1080p bench scene it reads ~120 MB of entry
// features and writes 42 MB, against 16 FP32 operations for an (entry,
// pixel) pair dropped at the alpha test and 28 for one composited
// (K1_OPS in ops/rasterize.py); chip_smoke.py works out which bound is
// larger from each run's data. Design: one CTA per tile, one thread per pixel, as the
// reference CUDA rasterizer does. A batch of 256 entries is staged in
// shared memory (10 coalesced row loads, 10 KB), then every pixel walks it
// with its own T. The TPU kernel's log1p/cumsum/exp formulation and its
// triangular matmul exist because a TPU core has no per-pixel control
// flow; here each thread keeps a sequential product and stops on its own,
// and the block leaves the batch loop once all 256 pixels are done
// (__syncthreads_count), which replaces the TPU kernel's per-chunk
// max-T test.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kBatch = 256;
constexpr int kFeat = 10;
constexpr int kChunk = 128;
constexpr int kOut = 5;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
raster_fwd_kernel(const float* __restrict__ feats, int d,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int gx, int max_chunks,
                  float* __restrict__ out) {
  __shared__ float sf[kFeat][kBatch];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % gx) * kTile + p % kTile);
  const float py = static_cast<float>((t / gx) * kTile + p / kTile);
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int base = (start / kChunk) * kChunk;
  const int limit = min(end, base + max_chunks * kChunk);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int done = 0;
  for (int b0 = start; b0 < limit; b0 += kBatch) {
    const int cnt = min(kBatch, limit - b0);
    if (p < cnt) {
#pragma unroll
      for (int f = 0; f < kFeat; ++f)
        sf[f][p] = __ldg(feats + static_cast<size_t>(f) * d + b0 + p);
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < cnt; ++j) {
        const float dx = sf[0][j] - px;
        const float dy = sf[1][j] - py;
        const float power = -0.5f * (sf[2][j] * dx * dx + sf[4][j] * dy * dy)
                            - sf[3][j] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaMax, sf[5][j] * expf(power));
        if (alpha < kAlphaMin) continue;
        const float test_t = T * (1.0f - alpha);
        if (test_t < kTEps) {
          done = 1;
          break;
        }
        const float w = alpha * T;
        cr += w * sf[6][j];
        cg += w * sf[7][j];
        cb += w * sf[8][j];
        cd += w * sf[9][j];
        T = test_t;
      }
    }
    // also the barrier before the next batch overwrites sf
    if (__syncthreads_count(done) == kPix) break;
  }
  float* o = out + static_cast<size_t>(t) * kOut * kPix + p;
  o[0 * kPix] = cr;
  o[1 * kPix] = cg;
  o[2 * kPix] = cb;
  o[3 * kPix] = cd;
  o[4 * kPix] = T;
}

}  // namespace

// feats [10, d] float32, tile_start/tile_end [num_tiles] int32, out
// [num_tiles, 5, 256] float32: all contiguous on `device`. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError().
extern "C" int gs_raster_tiles_fwd(const float* feats, int d,
                                   const int* tile_start, const int* tile_end,
                                   int num_tiles, int gx, int max_chunks,
                                   float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_fwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, d, tile_start, tile_end, gx, max_chunks, out);
  return static_cast<int>(cudaGetLastError());
}
