// K3 — backward tile rasterizer, for Hopper (sm_90a).
//
// Replaces gs_tpu/ops/rasterize_pallas.py::_bwd_kernel (:243-487, called
// from _raster_tiles_bwd :620). For every depth-sorted entry of every
// tile's window it returns the gradients of the 10 entry features (x, y,
// conic a/b/c, opacity, r, g, b, invdepth) from the upstream gradients of
// K1's outputs dout [tiles, 5, 256] (dL/dr, dL/dg, dL/db, dL/dinvdepth,
// dL/dT_final per pixel; the last row already holds bg . dL/dimage from
// the background blend).
//
// Per pixel, walking its composited entries back to front (last index from
// K1g), with T the transmittance behind the entry (T_final at the start)
// and S the sum of w_h * cdot_h over the entries behind it:
//   T_excl = T / (1 - alpha)        (undoes K1's rounded product exactly)
//   w      = alpha * T_excl,  cdot = c . dL/dC + invd * dL/dI
//   dalpha = cdot * T_excl - (S + dL/dT_final * T_final) / (1 - alpha)
// which is the TPU kernel's suffix form (:341-347) with its live mask
// implied: only composited pairs are visited. alpha's gradient reaches
// op * exp(power) only below the 0.99 clamp (the TPU kernel's gate, :115),
// and from there the opacity and, through the exponent, the mean and the
// conic (the per-pair form of :368-383).
//
// Design: one CTA per tile and one thread per pixel, mirroring K1. Entries
// are staged in shared memory 128 at a time from the back; every thread
// walks the batch in the same order, so for each entry the 256 pixels'
// 10 contributions are summed inside the block: a warp-shuffle tree, then
// the 8 warps' partials added in warp order by one thread per (feature,
// entry), and written once. Every entry belongs to one tile, so each
// output value has exactly one writer: no atomics, and the result is the
// same from run to run. A warp whose 32 pixels all skip an entry skips its
// shuffles. Entries no pixel reaches, the exact-cull and padding tail, and
// entries past the window are never written: the wrapper hands in zeros.
// The TPU kernel's PEND write protocol, pixel-moment expansion, head
// prefetch and triangular matmuls exist for the TPU's sequential grid and
// lack of per-lane control flow, and are not carried over.
//
// Bound on the H100: operations. Each composited (entry, pixel) pair costs
// 68 FP32 operations (K3_OPS in ops/rasterize.py, with the 10 adds that
// fold it into its entry's sums), against ~40 B per entry read and
// ~28 B per pixel; chip_smoke.py computes both bounds from the run's data.
#include "raster.cuh"

namespace {

using namespace gs;

constexpr int kBatch = 128;

__global__ void __launch_bounds__(kPix)
raster_bwd_kernel(const float* __restrict__ feats, int d,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int gx, int max_chunks,
                  const float* __restrict__ out_fwd,
                  const int* __restrict__ last,
                  const float* __restrict__ dout,
                  float* __restrict__ dfeats) {
  __shared__ float sf[kFeat][kBatch];
  __shared__ float part[kWarps][kFeat][kBatch];   // 40 KB
  __shared__ int s_end;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = static_cast<float>((t % gx) * kTile + p % kTile);
  const float py = static_cast<float>((t / gx) * kTile + p / kTile);
  const Window win = tile_window(tile_start, tile_end, t, max_chunks);

  const size_t pix = static_cast<size_t>(t) * kPix + p;
  const int my_last = last[pix];
  const size_t row0 = static_cast<size_t>(t) * kOut * kPix + p;
  const float T_final = out_fwd[row0 + 4 * kPix];
  const float dr = dout[row0];
  const float dg = dout[row0 + kPix];
  const float db = dout[row0 + 2 * kPix];
  const float di = dout[row0 + 3 * kPix];
  const float dT_term = dout[row0 + 4 * kPix] * T_final;

  // the block walks back from the last entry any of its pixels composited
  if (p == 0) s_end = win.start;
  __syncthreads();
  atomicMax(&s_end, my_last);
  __syncthreads();
  const int end = min(s_end, win.limit);

  float T = T_final;
  float S = 0.0f;
  for (int b1 = end; b1 > win.start; b1 -= kBatch) {
    const int b0 = max(win.start, b1 - kBatch);
    const int cnt = b1 - b0;
    if (p < cnt) {
#pragma unroll
      for (int f = 0; f < kFeat; ++f)
        sf[f][p] = __ldg(feats + static_cast<size_t>(f) * d + b0 + p);
    }
    __syncthreads();
    for (int jj = cnt - 1; jj >= 0; --jj) {
      float v[kFeat];
#pragma unroll
      for (int f = 0; f < kFeat; ++f) v[f] = 0.0f;
      bool hit = false;
      if (b0 + jj < my_last) {
        const float dx = sf[0][jj] - px;
        const float dy = sf[1][jj] - py;
        const float ca = sf[2][jj];
        const float cb = sf[3][jj];
        const float cc = sf[4][jj];
        const float power = splat_power(dx, dy, ca, cb, cc);
        if (power <= 0.0f) {
          const float g = expf(power);
          const float opg = sf[5][jj] * g;
          const float alpha = fminf(kAlphaMax, opg);
          if (alpha >= kAlphaMin) {
            hit = true;
            const float one_m = 1.0f - alpha;
            const float T_excl = T / one_m;
            const float w = alpha * T_excl;
            const float cdot = sf[6][jj] * dr + sf[7][jj] * dg +
                               sf[8][jj] * db + sf[9][jj] * di;
            const float dalpha = cdot * T_excl - (S + dT_term) / one_m;
            S += w * cdot;
            T = T_excl;
            v[6] = w * dr;
            v[7] = w * dg;
            v[8] = w * db;
            v[9] = w * di;
            if (opg < kAlphaMax) {
              const float dpower = dalpha * opg;
              v[0] = -(ca * dx + cb * dy) * dpower;
              v[1] = -(cc * dy + cb * dx) * dpower;
              v[2] = -0.5f * dx * dx * dpower;
              v[3] = -dx * dy * dpower;
              v[4] = -0.5f * dy * dy * dpower;
              v[5] = dalpha * g;
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int f = 0; f < kFeat; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kFeat; ++f) part[warp][f][jj] = v[f];
      }
    }
    __syncthreads();
    for (int i = p; i < kFeat * cnt; i += kPix) {
      const int f = i / cnt;
      const int jj = i - f * cnt;
      float s = part[0][f][jj];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[w][f][jj];
      dfeats[static_cast<size_t>(f) * d + b0 + jj] = s;
    }
    // the next batch overwrites sf and part
    __syncthreads();
  }
}

}  // namespace

// feats [10, d] float32, tile_start/tile_end [num_tiles] int32, out_fwd
// [num_tiles, 5, 256] float32 and last [num_tiles, 256] int32 from the grad
// variant of K1, dout [num_tiles, 5, 256] float32, dfeats [10, d] float32
// holding zeros: all contiguous on `device`. Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int gs_raster_tiles_bwd(const float* feats, int d,
                                   const int* tile_start, const int* tile_end,
                                   int num_tiles, int gx, int max_chunks,
                                   const float* out_fwd, const int* last,
                                   const float* dout, float* dfeats,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_bwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, d, tile_start, tile_end, gx, max_chunks, out_fwd, last, dout,
      dfeats);
  return static_cast<int>(cudaGetLastError());
}
