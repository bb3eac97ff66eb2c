// K4 — gradient fold: per-Gaussian sums of contiguous runs of entry rows,
// for Hopper (sm_90a).
//
// Replaces gs_tpu/ops/fold_pallas.py::_fold_kernel (:50, called from
// fold_rows :140). Run i is the rows [offsets[i], offsets[i] + counts[i])
// of data [n_entries, R] (entry-major), cut at n_entries; its sum goes to
// out[gid[i]], gid a permutation of [0, n). Runs may come in any order,
// overlap, leave gaps or be empty. The render's backward hands in K3's rows
// at each entry's position before the tile sort, where the expansion laid
// each Gaussian's entries out as one run, and the runs in depth order:
// consecutive runs are neighbouring memory, and the whole fold is one pass
// over the rows.
//
// Bound on the H100: bytes. The function reads each row of a run once
// (40 B for R = 10), 12 B of offset, count and gid per run, and writes the
// run's R sums once; it does one add per value read.
//
// Design: two kernels on the caller's stream, after a 16-byte memset of
// the scratch header; the second is the first's programmatic dependent.
// Runs of at most short_max rows (the bench frame's average 5.6 and reach
// 121) get a thread each; a longer run (a splat covering the 1080p screen
// is 8,160 rows; the RAIN-GS init's 23 visible Gaussians are 172,860 rows
// in one CTA's runs) would chain thousands of adds on one thread, so it is
// cut into pieces that warps all over the card add at once.
//
// The short kernel gives a thread to each run and 128 consecutive runs to
// a CTA. The CTA streams the rows its short runs need through shared
// memory in stages of 5,120 floats (512 rows of 10) with 16-byte cp.async
// copies, two stages deep, so that the next stage's copy overlaps the
// current sums. A stage starts at the first row a short run of the CTA
// still needs, so rows no short run reads (a long run's, a gap) are
// skipped: the start of the stage after next is a warp minimum taken in
// the current stage and read after its barrier. A CTA mostly waits on its
// rows' latency (128 runs of the bench frame span ~900 rows, two stages),
// so an SM holds several: 5, as many as shared memory allows, which caps
// a thread at 102 registers. Each thread adds its run's rows in entry
// order, 8 bytes a shared load, in float64, and rounds once. The sums
// leave through shared memory, R neighbouring threads writing one output
// row. A long run's thread instead claims ceil(len / piece_rows)
// consecutive piece slots of the scratch with one 64-bit atomicAdd and
// writes the run's index into each.
//
// The long kernel, a grid of 2 CTAs of 256 threads per SM, gives one warp
// to each slot: the lanes add rows piece_start + lane, + 32, ... in order
// in float64 (4 rows' loads in flight a lane) and a fixed warp tree of
// shuffles sums the lanes. Lane 0 stores the piece's R partials in its
// slot and counts the piece done on the run's counter; the warp that
// counts the last piece brings the run's partials from L2 32 pieces at a
// time, one a lane, through shared memory, adds them in piece order, lane
// f taking column f, and rounds once. The claims' order varies from run to
// run, but a slot holds the same piece of the same run whichever slot it
// is, and a run's pieces are added in piece order whichever warp finishes
// last: the sums are the same bits from run to run. No float atomics.
//
// Scratch (the wrapper's, one torch.empty): a header (piece slots
// claimed, as an unsigned 64-bit count; runs past the slots), partials
// ([cap, R] float64), each long run's first slot and the list of runs past
// the slots ([N] int32 each), each slot's run and done count ([cap] int32
// each). cap = ceil(E / piece_rows) + E / (short_max + 1) + 1 slots hold
// every piece of runs that do not overlap; where overlapping runs claim
// more, a run whose claim does not fit is listed, and one warp of the long
// kernel adds its pieces one after another by the same code, in the same
// order, to the same bits. The long kernel reads the header first, so when
// no run is long its CTAs exit at once.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRuns = 128;                    // runs (threads) per short CTA
constexpr int kWarps = kRuns / 32;
constexpr int kStageFloats = 5120;            // rows a stage holds, times R
constexpr int kStageAlloc = kStageFloats + 4; // + the 16-byte alignment slack
constexpr int kLongThreads = 256;             // threads per long CTA
constexpr int kLongCtasPerSm = 2;
constexpr int kUnroll = 4;                    // rows in flight per lane
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRuns % 32 == 0, "a CTA is whole warps");

// The scratch, laid out by gs_fold_rows over the wrapper's buffer.
struct Scratch {
  unsigned long long* claimed;  // piece slots claimed (may pass cap)
  int* n_over;                  // runs whose claim did not fit
  int* run_base;                // [n] a long run's first slot
  int* over;                    // [n] the runs whose claim did not fit
  int* slot_run;                // [cap] the run of each slot, -1 if unused
  int* done;                    // [cap] pieces done, at a run's first slot
  double* partials;             // [cap, R]
  long long cap;
};

__device__ __forceinline__ void run_rows(int offset, int count, int n_entries,
                                         int& lo, int& hi) {
  const long long off = offset;
  const long long end = n_entries;
  lo = static_cast<int>(min(max(off, 0LL), end));
  hi = static_cast<int>(min(max(off + count, static_cast<long long>(lo)), end));
}

__device__ __forceinline__ int pieces_of(int lo, int hi, int piece_rows) {
  return (hi - lo + piece_rows - 1) / piece_rows;
}

// A long run's thread: claim its pieces' slots and mark each with the run.
__device__ void claim_pieces(int i, int lo, int hi, int piece_rows,
                             const Scratch& s) {
  const long long np = pieces_of(lo, hi, piece_rows);
  const long long base = static_cast<long long>(
      atomicAdd(s.claimed, static_cast<unsigned long long>(np)));
  if (base + np <= s.cap) {
    s.run_base[i] = static_cast<int>(base);
    s.done[base] = 0;
    for (long long k = base; k < base + np; ++k) s.slot_run[k] = i;
  } else {
    for (long long k = base; k < s.cap; ++k) s.slot_run[k] = -1;
    s.over[atomicAdd(s.n_over, 1)] = i;
  }
}

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

// acc += the R floats at row, in column order.
template <int R>
__device__ __forceinline__ void add_row(const float* row, double (&acc)[R]) {
  if constexpr (R % 2 == 0) {  // a row starts on 8 bytes
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

template <int R>
__global__ void __launch_bounds__(kRuns, 5)  // shared memory allows 5
fold_short_kernel(const float* __restrict__ data, int n_entries,
                  const int* __restrict__ offsets,
                  const int* __restrict__ counts,
                  const int* __restrict__ gid, int n, int short_max,
                  int piece_rows, Scratch scratch, float* __restrict__ out) {
  constexpr int kStageRows = kStageFloats / R;
  __shared__ __align__(16) float stage[2][kStageAlloc];
  __shared__ int s_gid[kRuns];  // -1: a long run, the long kernel's
  __shared__ int s_lo[kWarps], s_hi[kWarps], s_next[2][kWarps];
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int i = blockIdx.x * kRuns + p;
  int lo = 0, hi = 0;
  if (i < n) {
    run_rows(offsets[i], counts[i], n_entries, lo, hi);
    if (hi - lo > short_max) {
      claim_pieces(i, lo, hi, piece_rows, scratch);
      lo = hi = 0;
      s_gid[p] = -1;
    } else {
      s_gid[p] = gid[i];
    }
  }
  // the first row at or after c that this thread's run adds; INT_MAX if none
  auto need = [lo, hi](int c) {
    const int m = max(lo, c);
    return m < hi ? m : INT_MAX;
  };
  const int lane_lo = __reduce_min_sync(kFull, need(0));
  const int lane_hi = __reduce_max_sync(kFull, hi > lo ? hi : 0);
  if (lane == 0) {
    s_lo[warp] = lane_lo;
    s_hi[warp] = lane_hi;
  }
  __syncthreads();
  int c0 = INT_MAX, w1 = 0;  // the first stage's start; the rows' end
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c0 = min(c0, s_lo[w]);
    w1 = max(w1, s_hi[w]);
  }
  const long long n_floats = static_cast<long long>(n_entries) * R;
  auto stage_end = [w1](int start) {
    return start < w1 ? min(start, w1 - kStageRows) + kStageRows : w1;
  };

  // stage k is the rows [c0, c1) in stage[k & 1]; the next starts at nxt
  int c1 = stage_end(c0);
  const int next_lane = __reduce_min_sync(kFull, need(c1));
  if (lane == 0) s_next[0][warp] = next_lane;
  if (c0 < w1) stage_floats(data, n_floats, (c0 * R) & ~3, c1 * R, stage[0]);
  commit_copies();
  __syncthreads();
  int nxt = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) nxt = min(nxt, s_next[0][w]);

  double acc[R];
#pragma unroll
  for (int f = 0; f < R; ++f) acc[f] = 0.0;
  for (int k = 0; c0 < w1; ++k) {
    const int d1 = stage_end(nxt);
    if (nxt < w1)
      stage_floats(data, n_floats, (nxt * R) & ~3, d1 * R, stage[(k + 1) & 1]);
    commit_copies();           // possibly empty: the wait below counts it
    const int after_lane = __reduce_min_sync(kFull, need(d1));
    if (lane == 0) s_next[(k + 1) & 1][warp] = after_lane;
    wait_copies_but_newest();  // this stage's copies have landed
    __syncthreads();           // ... everyone's, and s_next
    int after = INT_MAX;       // the start of the stage after next
#pragma unroll
    for (int w = 0; w < kWarps; ++w) after = min(after, s_next[(k + 1) & 1][w]);
    const float* rows = stage[k & 1];
    const int base = (c0 * R) & ~3;
    const int e1 = min(hi, c1);
    for (int e = max(lo, c0); e < e1; ++e)
      add_row<R>(rows + (e * R - base), acc);
    __syncthreads();  // the next iteration's copy overwrites the other stage
    c0 = nxt;
    c1 = d1;
    nxt = after;
  }

  float* sums = stage[0];
#pragma unroll
  for (int f = 0; f < R; ++f) sums[p * R + f] = static_cast<float>(acc[f]);
  __syncthreads();
  const int runs = min(kRuns, n - static_cast<int>(blockIdx.x) * kRuns);
  for (int j = p; j < runs * R; j += kRuns) {
    const int r = j / R;
    if (s_gid[r] >= 0)
      out[static_cast<size_t>(s_gid[r]) * R + (j - r * R)] = sums[j];
  }
}

// The sum of rows [r0, r1) by one warp: lane l adds rows r0 + l, + 32, ...
// in order, then a fixed shuffle tree; lane 0 holds the sum.
template <int R>
__device__ __forceinline__ void warp_rows_sum(const float* __restrict__ data,
                                              int r0, int r1,
                                              double (&acc)[R]) {
#pragma unroll
  for (int f = 0; f < R; ++f) acc[f] = 0.0;
  int e = r0 + static_cast<int>(threadIdx.x & 31);
  for (; e + 32 * (kUnroll - 1) < r1; e += 32 * kUnroll) {
    float v[kUnroll][R];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* row = data + static_cast<size_t>(e + 32 * u) * R;
      if constexpr (R % 2 == 0) {
#pragma unroll
        for (int f = 0; f < R; f += 2) {
          const float2 w = *reinterpret_cast<const float2*>(row + f);
          v[u][f] = w.x;
          v[u][f + 1] = w.y;
        }
      } else {
#pragma unroll
        for (int f = 0; f < R; ++f) v[u][f] = row[f];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int f = 0; f < R; ++f) acc[f] += static_cast<double>(v[u][f]);
  }
  for (; e < r1; e += 32) add_row<R>(data + static_cast<size_t>(e) * R, acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int f = 0; f < R; ++f) acc[f] += __shfl_down_sync(kFull, acc[f], off);
}

template <int R>
__global__ void __launch_bounds__(kLongThreads)
fold_long_kernel(const float* __restrict__ data, int n_entries,
                 const int* __restrict__ offsets,
                 const int* __restrict__ counts,
                 const int* __restrict__ gid, int piece_rows, Scratch s,
                 float* __restrict__ out) {
  // launched as the short kernel's programmatic dependent: wait for its
  // grid to finish and its claims to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int slots = static_cast<int>(
      min(*s.claimed, static_cast<unsigned long long>(s.cap)));
  const int items = slots + *s.n_over;
  // a warp's view of 32 pieces' partials at a time, for the run's sum
  __shared__ double s_part[kLongThreads / 32][32][R];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kLongThreads / 32);
  double(&part)[32][R] = s_part[threadIdx.x / 32];
  double acc[R];
  for (int item = blockIdx.x * (kLongThreads / 32) + threadIdx.x / 32;
       item < items; item += warps) {  // warp-uniform
    if (item < slots) {
      const int i = s.slot_run[item];
      if (i < 0) continue;
      int lo, hi;
      run_rows(offsets[i], counts[i], n_entries, lo, hi);
      const int base = s.run_base[i];
      const int np = pieces_of(lo, hi, piece_rows);
      const int r0 = lo + (item - base) * piece_rows;
      warp_rows_sum<R>(data, r0, min(r0, hi - piece_rows) + piece_rows, acc);
      int last = 0;
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < R; ++f)
          s.partials[static_cast<size_t>(item) * R + f] = acc[f];
        __threadfence();  // the partials before the count
        last = atomicAdd(s.done + base, 1) == np - 1;
      }
      if (!__shfl_sync(kFull, last, 0)) continue;
      __threadfence();  // every piece's partials are in L2: read them there
      double sum = 0.0;  // lane f < R: column f, in piece order
      for (int q0 = 0; q0 < np; q0 += 32) {
        if (q0 + lane < np) {  // lane l brings piece q0 + l's partials
          const double* row =
              s.partials + static_cast<size_t>(base + q0 + lane) * R;
#pragma unroll
          for (int f = 0; f < R; ++f) part[lane][f] = __ldcg(row + f);
        }
        __syncwarp();
        if (lane < R)
          for (int q = 0; q < min(32, np - q0); ++q) sum += part[q][lane];
        __syncwarp();
      }
      if (lane < R)
        out[static_cast<size_t>(gid[i]) * R + lane] = static_cast<float>(sum);
    } else {  // a run whose claim did not fit: its pieces one by one
      const int i = s.over[item - slots];
      int lo, hi;
      run_rows(offsets[i], counts[i], n_entries, lo, hi);
      double sum[R];
#pragma unroll
      for (int f = 0; f < R; ++f) sum[f] = 0.0;
      for (int r0 = lo; r0 < hi; r0 += piece_rows) {
        warp_rows_sum<R>(data, r0, min(r0, hi - piece_rows) + piece_rows, acc);
#pragma unroll
        for (int f = 0; f < R; ++f) sum[f] += acc[f];
      }
      if (lane == 0)
#pragma unroll
        for (int f = 0; f < R; ++f)
          out[static_cast<size_t>(gid[i]) * R + f] = static_cast<float>(sum[f]);
    }
  }
}

}  // namespace

// data [n_entries, rows] float32 starting on a 16-byte boundary,
// offsets/counts/gid [n] int32 (gid a permutation of [0, n)), out [n, rows]
// float32: all contiguous on `device`, 1 <= rows <= 16, n_entries * rows <
// 2^31. Runs of more than short_max rows go to the long kernel in pieces
// of piece_rows. scratch: 16 + 8 cap rows + 4 (2 n + 2 cap) bytes on
// 16-byte alignment, uninitialised. Launches on `stream`, allocates
// nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int gs_fold_rows(const float* data, int n_entries, int rows,
                            const int* offsets, const int* counts,
                            const int* gid, int n, int short_max,
                            int piece_rows, int cap, void* scratch_bytes,
                            float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (short_max < 0 || piece_rows < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms_of[64];  // the device's SM count, asked once
  int sms = device < 64 ? sms_of[device] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) sms_of[device] = sms;
  }
  // [16 B header | partials [cap, rows] f64 | run_base, over [n] |
  //  slot_run, done [cap]]
  char* bytes = static_cast<char*>(scratch_bytes);
  int* ints = reinterpret_cast<int*>(bytes + 16 + 8LL * cap * rows);
  const Scratch scratch{reinterpret_cast<unsigned long long*>(bytes),
                        reinterpret_cast<int*>(bytes + 8),
                        ints,
                        ints + n,
                        ints + 2 * static_cast<size_t>(n),
                        ints + 2 * static_cast<size_t>(n) + cap,
                        reinterpret_cast<double*>(bytes + 16),
                        cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(bytes, 0, 16, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRuns - 1) / kRuns;
  // the long kernel may be scheduled as the short kernel's CTAs exit
  // (programmatic dependent launch): its launch overlaps their tail
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t long_cfg = {};
  long_cfg.gridDim = dim3(kLongCtasPerSm * sms);
  long_cfg.blockDim = dim3(kLongThreads);
  long_cfg.stream = s;
  long_cfg.attrs = &overlap;
  long_cfg.numAttrs = 1;
  switch (rows) {
#define GS_FOLD_ROWS(r)                                                      \
  case r:                                                                    \
    fold_short_kernel<r><<<blocks, kRuns, 0, s>>>(                           \
        data, n_entries, offsets, counts, gid, n, short_max, piece_rows,     \
        scratch, out);                                                       \
    err = cudaLaunchKernelEx(&long_cfg, fold_long_kernel<r>, data,           \
                             n_entries, offsets, counts, gid, piece_rows,    \
                             scratch, out);                                  \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
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

// What the compiler made of the kernels the render's backward launches (10
// rows): which 0 the short kernel, 1 the long one; see
// common.cuh::kernel_attributes.
extern "C" int gs_fold_rows_attributes(int which, int device, int* attrs) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (which == 0)
    return kernel_attributes(
        reinterpret_cast<const void*>(fold_short_kernel<10>), kRuns, attrs);
  return kernel_attributes(reinterpret_cast<const void*>(fold_long_kernel<10>),
                           kLongThreads, attrs);
}
