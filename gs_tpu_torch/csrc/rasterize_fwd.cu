// K1 — forward tile rasterizer, for Hopper (sm_90a), in two variants.
//
// Replaces gs_tpu/ops/rasterize_pallas.py::_fwd_kernel (:125-225, called
// from _raster_tiles_fwd :559): the no-grad variant its save_ustore=False
// form, the grad variant (K1g) its save_ustore=True form. Per 16x16
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
// The grad variant also writes last [tiles, 256] int32: one past the
// global index of the last entry the pixel composited (the tile's start
// when it composited none). That is the reference CUDA rasterizer's
// n_contrib, and K3 (rasterize_bwd.cu) walks back from it, recovering the
// T in front of each entry from the final T by dividing by the same
// (1 - alpha) this kernel multiplied by. The TPU kernel instead
// checkpoints T at every 128-entry chunk ([tiles, max_chunks, 256], 67 MB
// at max_per_tile 1024) because its log-space cumsum cannot be undone
// exactly; here each division undoes one rounded product to within an
// ulp, so the error grows by one rounding per entry, as the forward's did,
// and the residual is 256 int32 per tile (8 MB at 1080p). Both variants
// are one template: the image of the grad variant is bitwise the no-grad
// variant's.
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
#include "raster.cuh"

namespace {

using namespace gs;

constexpr int kBatch = 256;

template <bool kSave>
__global__ void __launch_bounds__(kPix)
raster_fwd_kernel(const float* __restrict__ feats, int d,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int gx, int max_chunks,
                  float* __restrict__ out, int* __restrict__ last) {
  __shared__ float sf[kFeat][kBatch];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % gx) * kTile + p % kTile);
  const float py = static_cast<float>((t / gx) * kTile + p / kTile);
  const Window win = tile_window(tile_start, tile_end, t, max_chunks);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int done = 0;
  int last_j = win.start;
  for (int b0 = win.start; b0 < win.limit; b0 += kBatch) {
    const int cnt = min(kBatch, win.limit - b0);
    if (p < cnt) {
#pragma unroll
      for (int f = 0; f < kFeat; ++f)
        sf[f][p] = __ldg(feats + static_cast<size_t>(f) * d + b0 + p);
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < cnt; ++j) {
        const float power = splat_power(sf[0][j] - px, sf[1][j] - py,
                                        sf[2][j], sf[3][j], sf[4][j]);
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
        if (kSave) last_j = b0 + j + 1;
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
  if (kSave) last[static_cast<size_t>(t) * kPix + p] = last_j;
}

template <bool kSave>
int launch(const float* feats, int d, const int* tile_start,
           const int* tile_end, int num_tiles, int gx, int max_chunks,
           float* out, int* last, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_fwd_kernel<kSave>
      <<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
          feats, d, tile_start, tile_end, gx, max_chunks, out, last);
  return static_cast<int>(cudaGetLastError());
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
  return launch<false>(feats, d, tile_start, tile_end, num_tiles, gx,
                       max_chunks, out, nullptr, device, stream);
}

// The grad variant (K1g): the same, plus last [num_tiles, 256] int32.
extern "C" int gs_raster_tiles_fwd_save(const float* feats, int d,
                                        const int* tile_start,
                                        const int* tile_end, int num_tiles,
                                        int gx, int max_chunks, float* out,
                                        int* last, int device, void* stream) {
  return launch<true>(feats, d, tile_start, tile_end, num_tiles, gx,
                      max_chunks, out, last, device, stream);
}
