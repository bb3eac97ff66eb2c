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
// final T), pixel p of a tile at (p % 16, p / 16). A band of a multi-GPU
// render passes row_map [tiles / gx] int32, the global tile row of each
// local one (the TPU kernel's rowp input, :70-76): pixel coordinates, the
// block skip and the splat use the global row; a full frame passes none.
//
// The grad variant also writes last [tiles, 256] int32: one past the
// global index of the last entry the pixel composited (the tile's start
// when it composited none). That is the reference CUDA rasterizer's
// n_contrib, and K3 (rasterize_bwd.cu) walks back from it, recovering the
// T in front of each entry from the final T by dividing by the same
// (1 - alpha) this kernel multiplied by. The TPU kernel instead
// checkpoints T at every 128-entry chunk ([tiles, max_chunks, 256], 67 MB
// at max_per_tile 1024) because its log-space cumsum cannot be undone
// exactly; here the residual is 256 int32 per tile (8 MB at 1080p). Both
// variants are one template: the image of the grad variant is bitwise the
// no-grad variant's.
//
// Bound on the H100: operations. At the 1080p bench scene it reads ~100 MB
// of entry features and writes 42 MB, against 16 FP32 operations for an
// (entry, pixel) pair dropped at the alpha test and 28 for one composited
// (K1_OPS in ops/rasterize.py); chip_smoke.py works out both bounds from
// each run's data.
//
// Design: one CTA of 128 threads per tile, each thread two pixels with
// their own sequential T, as the reference CUDA rasterizer keeps one; the
// TPU kernel's log1p/cumsum/exp formulation and its triangular matmul
// exist only because a TPU core has no per-pixel control flow. On the
// bench frame two thirds of the pairs are faint, and the first version
// (one thread per pixel, 16x2 warp strips, entries as 10 scalar rows in
// shared memory) was bound by its instruction count per pair. Now:
// - entries are staged as three packed 16-byte words (raster.cuh), so a
//   pair reads at most three 128-bit broadcasts, shared by a thread's two
//   pixels;
// - warp w owns the 8x8 square of 8x4 blocks 4 (w / 2) + w % 2 and the
//   one below it (raster.cuh::pixel_of); per 32 entries each lane tests
//   one entry against both blocks (raster.cuh::block_misses) and two
//   ballots leave the entries each block can reach, so the warp skips the
//   rest, per block, without a load or an expf;
// - a pair whose exponent is past the entry's cut is dropped before expf
//   (raster.cuh::faint_by_power);
// - batches of 128 entries are double-buffered: each thread loads its
//   entry of the next batch into registers before the walk of this one and
//   stores it, packed, into the other buffer after it.
// The block leaves the batch loop once all 256 pixels are done
// (__syncthreads_count), which replaces the TPU kernel's per-chunk max-T
// test. The skips only drop pairs whose alpha is below 1/255, so the image
// and `last` are what the unskipped walk gives.
#include "raster.cuh"

namespace {

using namespace gs;

constexpr int kBatch = 128;
constexpr int kThreads = 128;           // two pixels a thread

// One pixel's compositing state.
struct Accum {
  float px, py;
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int done = 0;
  int last;
};

template <bool kSave>
__device__ __forceinline__ void composite(float4 w0, float4 w1, float4 w2,
                                          Accum& a, int e) {
  const float power = splat_power(w0.x - a.px, w0.y - a.py, w0.z, w0.w, w1.x);
  if (power > 0.0f || faint_by_power(power, w2.z)) return;
  const float alpha = fminf(kAlphaMax, w1.y * expf(power));
  if (alpha < kAlphaMin) return;
  const float test_t = a.T * (1.0f - alpha);
  if (test_t < kTEps) {
    a.done = 1;
    return;
  }
  const float w = alpha * a.T;
  a.cr += w * w1.z;
  a.cg += w * w1.w;
  a.cb += w * w2.x;
  a.cd += w * w2.y;
  a.T = test_t;
  if (kSave) a.last = e + 1;
}

template <bool kSave>
__device__ __forceinline__ void write_pixel(const Accum& a, const Pixel& pix,
                                            int t, float* __restrict__ out,
                                            int* __restrict__ last) {
  float* o = out + static_cast<size_t>(t) * kOut * kPix + pix.index;
  o[0 * kPix] = a.cr;
  o[1 * kPix] = a.cg;
  o[2 * kPix] = a.cb;
  o[3 * kPix] = a.cd;
  o[4 * kPix] = a.T;
  if (kSave) last[static_cast<size_t>(t) * kPix + pix.index] = a.last;
}

template <bool kSave>
__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ feats, int d,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int gx, int max_chunks,
                  const int* __restrict__ row_map,
                  float* __restrict__ out, int* __restrict__ last) {
  __shared__ float4 words[2][kWords * kBatch];     // 12 KB
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

  float v[kFeat];
  if (p < win.limit - win.start) {
    load_entry(feats, d, win.start + p, v);
    store_entry(words[0], kBatch, p, v);
  }
  __syncthreads();

  Accum a, b;
  a.px = pa.px, a.py = pa.py, a.last = win.start;
  b.px = pb.px, b.py = pb.py, b.last = win.start;
  int cur = 0;
  for (int b0 = win.start; b0 < win.limit; b0 += kBatch) {
    const int cnt = min(kBatch, win.limit - b0);
    const int next = min(kBatch, win.limit - b0 - kBatch);   // may be <= 0
    if (p < next) load_entry(feats, d, b0 + kBatch + p, v);
    const float4* w = words[cur];
    for (int g = 0; g < cnt && !__all_sync(kFull, a.done && b.done); g += 32) {
      const int jl = g + lane;
      const float4 c0 = w[jl], c1 = w[kBatch + jl], c2 = w[2 * kBatch + jl];
      const bool in = jl < cnt;
      const unsigned ma = __ballot_sync(
          kFull, in && !block_misses(c0, c1, c2, pa.x0, pa.y0));
      const unsigned mb = __ballot_sync(
          kFull, in && !block_misses(c0, c1, c2, pb.x0, pb.y0));
      for (unsigned m = ma | mb; m; m &= m - 1) {
        const int jb = __ffs(m) - 1;
        const int j = g + jb;
        const float4 w0 = w[j], w1 = w[kBatch + j], w2 = w[2 * kBatch + j];
        if (((ma >> jb) & 1) && !a.done) composite<kSave>(w0, w1, w2, a, b0 + j);
        if (((mb >> jb) & 1) && !b.done) composite<kSave>(w0, w1, w2, b, b0 + j);
      }
    }
    if (p < next) store_entry(words[cur ^ 1], kBatch, p, v);
    // also the barrier between this walk and the next batch's stores
    if (__syncthreads_count(a.done && b.done) == kThreads) break;
    cur ^= 1;
  }
  write_pixel<kSave>(a, pa, t, out, last);
  write_pixel<kSave>(b, pb, t, out, last);
}

template <bool kSave>
int launch(const float* feats, int d, const int* tile_start,
           const int* tile_end, int num_tiles, int gx, int max_chunks,
           const int* row_map, float* out, int* last, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_fwd_kernel<kSave>
      <<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          feats, d, tile_start, tile_end, gx, max_chunks, row_map, out, last);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [10, d] float32, tile_start/tile_end [num_tiles] int32, row_map
// [num_tiles / gx] int32 or null (a full frame), out [num_tiles, 5, 256]
// float32: all contiguous on `device`. Launches on `stream`, allocates
// nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int gs_raster_tiles_fwd(const float* feats, int d,
                                   const int* tile_start, const int* tile_end,
                                   int num_tiles, int gx, int max_chunks,
                                   const int* row_map, float* out, int device,
                                   void* stream) {
  return launch<false>(feats, d, tile_start, tile_end, num_tiles, gx,
                       max_chunks, row_map, out, nullptr, device, stream);
}

// The grad variant (K1g): the same, plus last [num_tiles, 256] int32.
extern "C" int gs_raster_tiles_fwd_save(const float* feats, int d,
                                        const int* tile_start,
                                        const int* tile_end, int num_tiles,
                                        int gx, int max_chunks,
                                        const int* row_map, float* out,
                                        int* last, int device, void* stream) {
  return launch<true>(feats, d, tile_start, tile_end, num_tiles, gx,
                      max_chunks, row_map, out, last, device, stream);
}

// What the compiler made of either variant (save 0: K1, 1: K1g): see
// common.cuh::kernel_attributes.
extern "C" int gs_raster_tiles_fwd_attributes(int save, int device,
                                              int* attrs) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = save ? reinterpret_cast<const void*>(raster_fwd_kernel<true>)
                        : reinterpret_cast<const void*>(raster_fwd_kernel<false>);
  return kernel_attributes(fn, kThreads, attrs);
}
