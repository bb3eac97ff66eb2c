// Stage stamps and counters of gs_tpu_torch's step and view, for Hopper
// (sm_90a). Replaces no TPU kernel: the JAX package reads its stages from
// XLA's profiler, which names the ops of a jitted program; a CUDA-graph
// replay carries kernels and nothing else, so a stage boundary inside one is
// a kernel (gs_tpu_torch/utils/spans.py).
//
// Each stamp is one thread that reads the device's nanosecond clock
// (%globaltimer) and writes (stage id, time) at slot cursor mod capacity of a
// ring of int64 pairs, taking its slot by atomicAdd on a 64-bit cursor that
// only grows. Every stage has a kernel of its own, named gs_stage_<stage>, so
// a profiler trace shows which stamp it is between the stage's kernels. A
// counter writes n int64 values, each with its own tag, in one thread. Bound
// on the H100: the launch; a few ns of work and 16 bytes a value. The ring is
// allocated once per device and never moves, so graphs keep its pointer.
#include "common.cuh"

// the stages in the order of spans.py's STAGES, whose ids they are
#define GS_STAGES(X)                                                        \
  X(step) X(preprocess) X(binning) X(raster) X(loss) X(loss_bwd)            \
  X(raster_bwd) X(preprocess_bwd) X(update) X(end) X(frame) X(exchange)     \
  X(exchange_bwd) X(densify) X(reset_opacity) X(depth) X(exposure)

namespace {

#define GS_STAGE_ID(name) kStage_##name,
enum StageId { GS_STAGES(GS_STAGE_ID) kStages };
#undef GS_STAGE_ID

__device__ __forceinline__ void put(unsigned long long* ring,
                                    unsigned long long* cursor,
                                    unsigned long long capacity,
                                    long long tag, long long value) {
  const unsigned long long k = atomicAdd(cursor, 1ULL) % capacity;
  ring[2 * k] = static_cast<unsigned long long>(tag);
  ring[2 * k + 1] = static_cast<unsigned long long>(value);
}

__device__ __forceinline__ void stamp(unsigned long long* ring,
                                      unsigned long long* cursor,
                                      unsigned long long capacity, int id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  put(ring, cursor, capacity, id, static_cast<long long>(t));
}

}  // namespace

// one kernel per stage, at global scope so that its name reads plainly
#define GS_STAGE_KERNEL(name)                                               \
  __global__ void gs_stage_##name(unsigned long long* ring,                 \
                                  unsigned long long* cursor,               \
                                  unsigned long long capacity) {            \
    stamp(ring, cursor, capacity, kStage_##name);                           \
  }
GS_STAGES(GS_STAGE_KERNEL)
#undef GS_STAGE_KERNEL

__global__ void gs_counter(unsigned long long* ring,
                           unsigned long long* cursor,
                           unsigned long long capacity, long long tag0,
                           const long long* __restrict__ values,
                           long long stride, int n) {
  for (int i = 0; i < n; ++i) {
    put(ring, cursor, capacity, tag0 + i, values[i * stride]);
  }
}

#define GS_STAGE_NAME(name) #name ","
// the stage names, comma-terminated, in id order: the Python side checks
// them against its own list once, when it first loads this library
extern "C" const char* gs_stage_names() { return GS_STAGES(GS_STAGE_NAME); }
#undef GS_STAGE_NAME

// ring [capacity, 2] int64 and cursor [1] int64 on `device`. Launches the
// stamp of stage `stage` on `stream`; does not synchronise. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown stage.
extern "C" int gs_stage_stamp(int stage, void* ring, void* cursor,
                              long long capacity, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* r = static_cast<unsigned long long*>(ring);
  auto* c = static_cast<unsigned long long*>(cursor);
  const auto cap = static_cast<unsigned long long>(capacity);
  auto s = static_cast<cudaStream_t>(stream);
  switch (stage) {
#define GS_STAGE_CASE(name)                                                 \
    case kStage_##name: gs_stage_##name<<<1, 1, 0, s>>>(r, c, cap); break;
    GS_STAGES(GS_STAGE_CASE)
#undef GS_STAGE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The n int64 values at values[0], values[stride], ... into the ring, tagged
// tag0, tag0 + 1, ...; as gs_stage_stamp otherwise.
extern "C" int gs_counter_write(long long tag0, const void* values,
                                long long stride, int n, void* ring,
                                void* cursor, long long capacity, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gs_counter<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring),
      static_cast<unsigned long long*>(cursor),
      static_cast<unsigned long long>(capacity), tag0,
      static_cast<const long long*>(values), stride, n);
  return static_cast<int>(cudaGetLastError());
}
