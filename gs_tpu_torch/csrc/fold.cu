// K4 — gradient fold: per-Gaussian sums of contiguous runs of entry rows,
// for Hopper (sm_90a).
//
// Replaces gs_tpu/ops/fold_pallas.py::_fold_kernel (:50, called from
// fold_rows :140). Run i is the rows [offsets[i], offsets[i] + counts[i])
// of data [n_entries, R] (entry-major), cut at n_entries; its sum goes to
// out[gid[i]], gid a permutation of [0, n). The render's backward hands in
// K3's rows at each entry's position before the tile sort, where the
// expansion laid each Gaussian's entries out as one run, and the runs in
// depth order, the order the expansion wrote them in: consecutive runs are
// neighbouring memory, and the whole fold is one pass over the rows.
//
// Bound on the H100: bytes. The function reads each row of a run once
// (40 B for R = 10), 12 B of offset, count and gid per run, and writes the
// run's R sums once; it does one add per value read.
//
// Design: a CTA takes 128 consecutive runs, one per thread. Their rows
// form one window [least start, greatest end), contiguous when the runs
// are (the render's case; other runs stay correct, the window then holds
// rows no run of the CTA reads). The CTA streams the window through shared
// memory in stages of 5,120 floats (512 rows of 10) with 16-byte cp.async
// copies, two stages deep, so that the next stage's copy overlaps the
// current sums; a window larger than a stage (a splat covering the 1080p
// screen is a run of 8,160 rows) takes as many stages as it needs. A CTA
// mostly waits on its window's latency (128 runs of the bench frame span
// ~900 rows, two stages), so an SM holds several: 5, as many as shared
// memory allows, which caps a thread at 102 registers. Each thread adds its run's rows in entry order,
// 8 bytes a shared load, in float64 and rounds once: one order of
// additions, so the sums are the same from run to run and within float32
// rounding of the exact ones however long the run. No atomics: the
// window's bounds are warp reductions, read back in warp order. The sums
// leave through shared memory, R neighbouring threads writing one output
// row. The copies are plain 16-byte cp.async pieces spread over the
// threads; the bulk copy (cp.async.bulk and an mbarrier) was not tried.
// The TPU kernel's one-hot matmul over 512-entry windows exists because a
// TPU lane cannot gather; a thread here reads its run straight.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRuns = 128;                    // runs (threads) per CTA
constexpr int kStageFloats = 5120;            // rows a stage holds, times R
constexpr int kStageAlloc = kStageFloats + 4; // + the 16-byte alignment slack
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRuns % 32 == 0, "a CTA is whole warps");

__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every copy group of this thread but the newest.
__device__ __forceinline__ void wait_copies_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of data's floats [f0, f1) into stage; f0 a multiple of 4.
// A 16-byte piece that would pass the array's end is copied float by float.
__device__ __forceinline__ void stage_floats(const float* __restrict__ data,
                                             long long n_floats, int f0,
                                             int f1, float* stage) {
  const int pieces = (f1 - f0 + 3) >> 2;
  for (int q = threadIdx.x; q < pieces; q += kRuns) {
    const long long g = static_cast<long long>(f0) + 4 * q;
    if (g + 4 <= n_floats) {
      copy16(stage + 4 * q, data + g);
    } else {
      for (int k = 0; k < 4; ++k)
        if (g + k < n_floats) stage[4 * q + k] = data[g + k];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kRuns, 5)  // shared memory allows 5
fold_rows_kernel(const float* __restrict__ data, int n_entries,
                 const int* __restrict__ offsets,
                 const int* __restrict__ counts,
                 const int* __restrict__ gid, int n,
                 float* __restrict__ out) {
  constexpr int kStageRows = kStageFloats / R;
  __shared__ __align__(16) float stage[2][kStageAlloc];
  __shared__ int s_gid[kRuns];
  __shared__ int s_lo[kRuns / 32], s_hi[kRuns / 32];
  const int p = threadIdx.x;
  const int i = blockIdx.x * kRuns + p;
  int lo = 0, hi = 0;
  if (i < n) {
    const long long off = offsets[i];
    const long long end = static_cast<long long>(n_entries);
    lo = static_cast<int>(min(max(off, 0LL), end));
    hi = static_cast<int>(min(max(off + counts[i], static_cast<long long>(lo)),
                              end));
    s_gid[p] = gid[i];
  }
  const bool empty = hi <= lo;
  const int warp_lo = __reduce_min_sync(kFull, empty ? INT_MAX : lo);
  const int warp_hi = __reduce_max_sync(kFull, empty ? 0 : hi);
  if ((p & 31) == 0) {
    s_lo[p >> 5] = warp_lo;
    s_hi[p >> 5] = warp_hi;
  }
  __syncthreads();
  int w0 = INT_MAX, w1 = 0;  // the window; empty when every run is
#pragma unroll
  for (int w = 0; w < kRuns / 32; ++w) {
    w0 = min(w0, s_lo[w]);
    w1 = max(w1, s_hi[w]);
  }
  const long long n_floats = static_cast<long long>(n_entries) * R;

  double acc[R];
#pragma unroll
  for (int f = 0; f < R; ++f) acc[f] = 0.0;
  if (w0 < w1)
    stage_floats(data, n_floats, (w0 * R) & ~3, min(w0 + kStageRows, w1) * R,
                 stage[0]);
  commit_copies();
  int k = 0;
  for (int c0 = w0; c0 < w1; c0 += kStageRows, ++k) {
    const int c1 = min(c0 + kStageRows, w1);
    if (c1 < w1)
      stage_floats(data, n_floats, (c1 * R) & ~3,
                   min(c1 + kStageRows, w1) * R, stage[(k + 1) & 1]);
    commit_copies();           // possibly empty: the wait below counts it
    wait_copies_but_newest();  // this stage's copies have landed
    __syncthreads();           // ... everyone's
    const float* rows = stage[k & 1];
    const int base = (c0 * R) & ~3;
    const int e1 = min(hi, c1);
    for (int e = max(lo, c0); e < e1; ++e) {
      const float* row = rows + (e * R - base);
      if constexpr (R % 2 == 0) {  // row starts on 8 bytes: base is on 16
#pragma unroll
        for (int f = 0; f < R; f += 2) {
          const float2 w = *reinterpret_cast<const float2*>(row + f);
          acc[f] += static_cast<double>(w.x);
          acc[f + 1] += static_cast<double>(w.y);
        }
      } else {
#pragma unroll
        for (int f = 0; f < R; ++f) acc[f] += static_cast<double>(row[f]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites the other stage
  }

  float* sums = stage[0];
#pragma unroll
  for (int f = 0; f < R; ++f) sums[p * R + f] = static_cast<float>(acc[f]);
  __syncthreads();
  const int runs = min(kRuns, n - static_cast<int>(blockIdx.x) * kRuns);
  for (int j = p; j < runs * R; j += kRuns) {
    const int r = j / R;
    out[static_cast<size_t>(s_gid[r]) * R + (j - r * R)] = sums[j];
  }
}

}  // namespace

// data [n_entries, rows] float32 starting on a 16-byte boundary,
// offsets/counts/gid [n] int32 (gid a permutation of [0, n)), out [n, rows]
// float32: all contiguous on `device`, 1 <= rows <= 16, n_entries * rows <
// 2^31. Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError().
extern "C" int gs_fold_rows(const float* data, int n_entries, int rows,
                            const int* offsets, const int* counts,
                            const int* gid, int n, float* out, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRuns - 1) / kRuns;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
#define GS_FOLD_ROWS(r)                                                     \
  case r:                                                                   \
    fold_rows_kernel<r><<<blocks, kRuns, 0, s>>>(data, n_entries, offsets, \
                                                 counts, gid, n, out);      \
    break;
    GS_FOLD_ROWS(1) GS_FOLD_ROWS(2) GS_FOLD_ROWS(3) GS_FOLD_ROWS(4)
    GS_FOLD_ROWS(5) GS_FOLD_ROWS(6) GS_FOLD_ROWS(7) GS_FOLD_ROWS(8)
    GS_FOLD_ROWS(9) GS_FOLD_ROWS(10) GS_FOLD_ROWS(11) GS_FOLD_ROWS(12)
    GS_FOLD_ROWS(13) GS_FOLD_ROWS(14) GS_FOLD_ROWS(15) GS_FOLD_ROWS(16)
#undef GS_FOLD_ROWS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the compiler made of the kernel the render's backward launches (10
// rows): see common.cuh::kernel_attributes.
extern "C" int gs_fold_rows_attributes(int device, int* attrs) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_attributes(reinterpret_cast<const void*>(fold_rows_kernel<10>),
                           kRuns, attrs);
}
