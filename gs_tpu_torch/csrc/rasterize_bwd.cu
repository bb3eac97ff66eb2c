// K3 — backward tile rasterizer, for Hopper (sm_90a).
//
// Replaces gs_tpu/ops/rasterize_pallas.py::_bwd_kernel (:243-487, called
// from _raster_tiles_bwd :620). For every depth-sorted entry of every
// tile's window it returns the gradients of the 10 entry features (x, y,
// conic a/b/c, opacity, r, g, b, invdepth) from the upstream gradients of
// K1's outputs dout [tiles, 5, 256] (dL/dr, dL/dg, dL/db, dL/dinvdepth,
// dL/dT_final per pixel; the last row already holds bg . dL/dimage from
// the background blend), as one 40-byte row at the entry's position before
// the tile sort, dest[e]: there the expansion laid each Gaussian's entries
// out as one run, which the fold K4 reads as one stream. A band of a
// multi-GPU render passes K1's row_map (the global tile row of each local
// one, the TPU kernel's rowp, :308); a full frame passes none.
//
// Per pixel, walking its composited entries back to front (last index from
// K1g), with T the transmittance behind the entry (T_final at the start)
// and S the sum of w_h * cdot_h over the entries behind it:
//   r      = 1 / (1 - alpha),  T_excl = T * r   (undoes K1's product)
//   w      = alpha * T_excl,  cdot = c . dL/dC + invd * dL/dI
//   dalpha = cdot * T_excl - (S + dL/dT_final * T_final) * r
// which is the TPU kernel's suffix form (:341-347) with its live mask
// implied: only composited pairs are visited. alpha's gradient reaches
// op * exp(power) only below the 0.99 clamp (the TPU kernel's gate, :115),
// and from there the opacity and, through the exponent, the mean and the
// conic (the per-pair form of :368-383). One correctly rounded reciprocal
// replaces the two divisions by (1 - alpha): T_excl carries one more
// rounding per entry, which moves no visit (the walk's pairs are set by
// `last` and alpha, not by T) and keeps the gradients far inside the 2e-4
// rule.
//
// Bound on the H100: operations. Each composited (entry, pixel) pair costs
// 68 FP32 operations (K3_OPS in ops/rasterize.py, with the 10 adds that
// fold it into its entry's sums), against ~40 B per entry read and
// ~28 B per pixel; chip_smoke.py computes both bounds from the run's data.
//
// Design: one CTA of 128 threads per tile, each thread two pixels, with
// K1's packed entries, warp squares of two 8x4 blocks, per-block skip and
// pre-filter (raster.cuh, rasterize_fwd.cu). Entries are staged 64 at a
// time from the back; every warp walks the batch in the same order, so for
// each entry the 256 pixels' 10 contributions are summed inside the block
// and written once. Every entry belongs to one tile, so each output value
// has one writer: no atomics, and the result is the same from run to run.
// The first version (one thread per pixel) summed each of the 10 values
// over the warp with its own 5-step shuffle tree (50 shuffles per entry a
// warp touched) and had lane 0 store 10 partials per warp and entry,
// touched or not; that was most of its time. Now:
// - a warp skips an entry that both its blocks miss or that lies past
//   every pixel's `last`, and one no pixel composites;
// - a thread adds its two pixels' contributions in registers, and a
//   reduce-scatter sums the 10 values over the warp in 12 shuffles
//   (recursive halving: lanes 0-15 keep features 0-4 and lanes 16-31
//   features 5-9, and so on), leaving each sum on one lane, which stores
//   it: 12 shuffles per 64 pixels instead of 50 per 32;
// - a per-(warp, entry) mask records which warps wrote, and one thread per
//   (feature, entry) adds only those partials, in warp order.
// - the partials are kept entry by entry, 10 features side by side, so the
//   final pass maps 10 neighbouring threads to one entry's features: they
//   read neighbouring words and write the entry's row at dest[e] as one
//   40-byte piece.
// 10 KB of partials and 3 KB of entries per CTA (the first version: 46 KB).
// Entries no pixel reaches, the exact-cull and padding tail, and entries
// past the window are never written: the wrapper hands in zeros. The TPU
// kernel's PEND write protocol, pixel-moment expansion, head prefetch and
// triangular matmuls exist for the TPU's sequential grid and lack of
// per-lane control flow, and are not carried over.
#include "raster.cuh"

namespace {

using namespace gs;

constexpr int kBatch = 64;
constexpr int kThreads = 128;           // two pixels a thread
constexpr int kBwdWarps = kThreads / 32;

// The feature whose warp sum reduce_scatter leaves on `lane`, or -1 for
// the lanes that hold a padding slot or the second copy of a sum.
__device__ __forceinline__ int feature_of(int lane) {
  const int upper = (lane >> 4) & 1, s2 = (lane >> 3) & 1;
  const int k = ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  if ((lane & 1) || k >= (s2 ? 2 : 3)) return -1;
  return upper * 5 + s2 * 3 + k;
}

// Sums v[0..9] over the warp by recursive halving: at each step a lane
// keeps half of its slots, sends the other half to the lane `offset` away
// and adds what that lane sent for the kept half. 10 -> 5 (offset 16),
// 5 (+1 pad) -> 3 (8), 3 (+1 pad) -> 2 (4), 2 -> 1 (2), then both lanes
// of a pair add each other's (1): 12 shuffles. The sum of feature
// feature_of(lane) is returned on that lane, in a fixed order.
__device__ __forceinline__ float reduce_scatter(const float v[kFeat],
                                                int lane) {
  const bool upper = lane & 16;
  float a[6];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float send = upper ? v[k] : v[5 + k];
    a[k] = (upper ? v[5 + k] : v[k]) + __shfl_xor_sync(kFull, send, 16);
  }
  a[5] = 0.0f;
  const bool s2 = lane & 8;
  float b[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float send = s2 ? a[k] : a[3 + k];
    b[k] = (s2 ? a[3 + k] : a[k]) + __shfl_xor_sync(kFull, send, 8);
  }
  b[3] = 0.0f;
  const bool s3 = lane & 4;
  float c[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = s3 ? b[k] : b[2 + k];
    c[k] = (s3 ? b[2 + k] : b[k]) + __shfl_xor_sync(kFull, send, 4);
  }
  const bool s4 = lane & 2;
  const float e = (s4 ? c[1] : c[0]) +
                  __shfl_xor_sync(kFull, s4 ? c[0] : c[1], 2);
  return e + __shfl_xor_sync(kFull, e, 1);
}

// One pixel's side of the walk: its residual, upstream gradients and the
// running T and S.
struct PixelState {
  float px, py;
  int last;
  float dr, dg, db, di, dT_term;
  float T, S;
};

__device__ __forceinline__ PixelState load_pixel(const Pixel& pix, int t,
                                                 const float* __restrict__ out_fwd,
                                                 const int* __restrict__ last,
                                                 const float* __restrict__ dout) {
  const size_t row0 = static_cast<size_t>(t) * kOut * kPix + pix.index;
  const float T_final = out_fwd[row0 + 4 * kPix];
  return {pix.px, pix.py, last[static_cast<size_t>(t) * kPix + pix.index],
          dout[row0], dout[row0 + kPix], dout[row0 + 2 * kPix],
          dout[row0 + 3 * kPix], dout[row0 + 4 * kPix] * T_final,
          T_final, 0.0f};
}

// One (entry, pixel) pair of the back-to-front walk: false when the pair
// is skipped as K1 skips it; else updates T and S and adds the pair's 10
// contributions to v.
__device__ __forceinline__ bool contribution(float4 w0, float4 w1, float4 w2,
                                             PixelState& s, float v[kFeat]) {
  const float dx = w0.x - s.px;
  const float dy = w0.y - s.py;
  const float ca = w0.z, cb = w0.w, cc = w1.x;
  const float power = splat_power(dx, dy, ca, cb, cc);
  if (power > 0.0f || faint_by_power(power, w2.z)) return false;
  const float gauss = expf(power);
  const float opg = w1.y * gauss;
  const float alpha = fminf(kAlphaMax, opg);
  if (alpha < kAlphaMin) return false;
  const float r = __frcp_rn(1.0f - alpha);
  const float T_excl = s.T * r;
  const float w = alpha * T_excl;
  const float cdot = w1.z * s.dr + w1.w * s.dg + w2.x * s.db + w2.y * s.di;
  const float dalpha = cdot * T_excl - (s.S + s.dT_term) * r;
  s.S += w * cdot;
  s.T = T_excl;
  v[6] += w * s.dr;
  v[7] += w * s.dg;
  v[8] += w * s.db;
  v[9] += w * s.di;
  if (opg < kAlphaMax) {
    const float dpower = dalpha * opg;
    v[0] += -(ca * dx + cb * dy) * dpower;
    v[1] += -(cc * dy + cb * dx) * dpower;
    v[2] += -0.5f * dx * dx * dpower;
    v[3] += -dx * dy * dpower;
    v[4] += -0.5f * dy * dy * dpower;
    v[5] += dalpha * gauss;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const float* __restrict__ feats, int d,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int gx, int max_chunks,
                  const int* __restrict__ row_map,
                  const float* __restrict__ out_fwd,
                  const int* __restrict__ last,
                  const float* __restrict__ dout,
                  const int* __restrict__ dest,
                  float* __restrict__ dfeats) {
  __shared__ float4 words[kWords * kBatch];
  __shared__ float part[kBwdWarps][kBatch][kFeat];
  __shared__ unsigned wrote[kBatch / 32][kBwdWarps];
  __shared__ int s_dest[kBatch];
  __shared__ int s_end;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  // warp w: blocks a = 4 (w / 2) + w % 2 and a + 2 below it, an 8x8 square
  const int block_a = 4 * (warp >> 1) + (warp & 1);
  const int trow = tile_row(row_map, t, gx);
  const Pixel pa = pixel_of(t, gx, trow, block_a, lane);
  const Pixel pb = pixel_of(t, gx, trow, block_a + 2, lane);
  const Window win = tile_window(tile_start, tile_end, t, max_chunks);
  PixelState sa = load_pixel(pa, t, out_fwd, last, dout);
  PixelState sb = load_pixel(pb, t, out_fwd, last, dout);
  const int feat = feature_of(lane);

  // the block walks back from the last entry any of its pixels composited,
  // each 8x4 block from the last any of its pixels did
  const int last_a = __reduce_max_sync(kFull, sa.last);
  const int last_b = __reduce_max_sync(kFull, sb.last);
  if (p == 0) s_end = win.start;
  __syncthreads();
  if (lane == 0) atomicMax(&s_end, max(last_a, last_b));
  __syncthreads();
  const int end = min(s_end, win.limit);

  for (int b1 = end; b1 > win.start; b1 -= kBatch) {
    const int b0 = max(win.start, b1 - kBatch);
    const int cnt = b1 - b0;
    if (p < cnt) {
      float v[kFeat];
      load_entry(feats, d, b0 + p, v);
      store_entry(words, kBatch, p, v);
      s_dest[p] = dest[b0 + p];
    }
    __syncthreads();
    for (int g = (cnt - 1) & ~31; g >= 0; g -= 32) {
      const int jl = g + lane;
      const float4 c0 = words[jl], c1 = words[kBatch + jl],
                   c2 = words[2 * kBatch + jl];
      const bool in = jl < cnt;
      const unsigned ma = __ballot_sync(
          kFull, in && b0 + jl < last_a &&
                     !block_misses(c0, c1, c2, pa.x0, pa.y0));
      const unsigned mb = __ballot_sync(
          kFull, in && b0 + jl < last_b &&
                     !block_misses(c0, c1, c2, pb.x0, pb.y0));
      unsigned written = 0;
      for (unsigned m = ma | mb; m;) {
        const int jb = 31 - __clz(m);
        const unsigned bit = 1u << jb;
        m ^= bit;
        const int j = g + jb;
        const float4 w0 = words[j], w1 = words[kBatch + j],
                     w2 = words[2 * kBatch + j];
        float v[kFeat];
#pragma unroll
        for (int f = 0; f < kFeat; ++f) v[f] = 0.0f;
        bool hit = false;
        if ((ma & bit) && b0 + j < sa.last && contribution(w0, w1, w2, sa, v))
          hit = true;
        if ((mb & bit) && b0 + j < sb.last && contribution(w0, w1, w2, sb, v))
          hit = true;
        if (__any_sync(kFull, hit)) {
          const float sum = reduce_scatter(v, lane);
          if (feat >= 0) part[warp][j][feat] = sum;
          written |= bit;
        }
      }
      if (lane == 0) wrote[g >> 5][warp] = written;
    }
    __syncthreads();
    for (int i = p; i < kFeat * cnt; i += kThreads) {
      const int j = i / kFeat;
      const int f = i - j * kFeat;
      float sum = 0.0f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) {
        if ((wrote[j >> 5][w] >> (j & 31)) & 1u) {
          sum += part[w][j][f];
          any = true;
        }
      }
      if (any) dfeats[static_cast<size_t>(s_dest[j]) * kFeat + f] = sum;
    }
    // the next batch overwrites words, part, wrote and s_dest
    __syncthreads();
  }
}

}  // namespace

// feats [10, d] float32, tile_start/tile_end [num_tiles] int32, row_map
// [num_tiles / gx] int32 or null (a full frame), out_fwd [num_tiles, 5,
// 256] float32 and last [num_tiles, 256] int32 from the grad variant of K1,
// dout [num_tiles, 5, 256] float32, dest [d] int32 (a permutation of
// [0, d)), dfeats [d, 10] float32 holding zeros: all contiguous on
// `device`. Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError().
extern "C" int gs_raster_tiles_bwd(const float* feats, int d,
                                   const int* tile_start, const int* tile_end,
                                   int num_tiles, int gx, int max_chunks,
                                   const int* row_map, const float* out_fwd,
                                   const int* last, const float* dout,
                                   const int* dest, float* dfeats, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_bwd_kernel<<<num_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      feats, d, tile_start, tile_end, gx, max_chunks, row_map, out_fwd, last,
      dout, dest, dfeats);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler made of the kernel: see common.cuh::kernel_attributes.
extern "C" int gs_raster_tiles_bwd_attributes(int device, int* attrs) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_attributes(reinterpret_cast<const void*>(raster_bwd_kernel),
                           kThreads, attrs);
}
