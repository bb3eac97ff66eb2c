// Adam over the packed block, for Hopper (sm_90a): one pass that reads a
// column of the parameters, the gradient and both moments and writes the
// parameters and both moments, for every row of the channel-major [R, C]
// block.
//
// Replaces no TPU kernel: gs_tpu's adam_update_packed is jnp
// (gs_tpu/models/packed_state.py), which XLA fuses into one pass. Run eagerly
// in PyTorch the same arithmetic is some fifteen elementwise passes over the
// [R, C] block, each reading and writing a whole [R, C] float32 tensor, with
// the column mask's selects on top. That PyTorch code stays
// in gs_tpu_torch/models/packed_state.py as this kernel's twin
// (adam_update_packed_plain): it runs on the CPU, and the tests hold this
// kernel to it bit for bit.
//
// Bound on the H100: bytes. The kernel reads the block, m, v and the
// gradient and writes the block, m and v: 7 x 4 B x R x C, 7.5 GB at R = 64
// and C = 4,194,304, 2.24 ms at 3.35 TB/s. Some twenty FP32 operations an
// element are nothing against 67 TFLOP/s. Design: one block row per
// blockIdx.y, so a block reads its row's learning rate once; along the row a
// grid-stride loop over 16-byte vectors (float4 of each tensor, a uchar4 of
// the column mask), then a grid-stride loop over single columns for what the
// vectors leave: a row's last n mod 4 columns, or every column of a call
// whose rows do not all start on 16 bytes. That happens where a process's
// block is not a multiple of 4 columns wide, as when three ranks split a
// capacity (4,194,304 slots pad to 4,194,306, 1,398,102 a rank), for the
// new outputs of such a width, and for a column slice at an odd offset. The
// grid holds the blocks the SMs keep resident at once, shared out over the
// rows, so no block waits for a second wave. Nothing is kept in device
// memory between the reads and the writes. On the card the kernel moves its
// bytes at about 2.75 TB/s; streaming cache hints, 128 or 512 threads a
// block and two or four vectors in flight a thread measured the same or
// slower.
//
// What the call passes in chooses the behaviour, as in the twin: a column
// mask (sparse Adam) leaves an unmasked column's parameters and moments as
// they were; in place the outputs are the inputs and every element is
// written back by the thread that read it.
// The step count and the bias corrections 1 - B1^t and 1 - B2^t are the
// twin's own torch expressions: the kernel reads bc1 and bc2 from the device,
// so a captured graph replays it with a new step.
//
// The rules of the twin. FP32, no fast math: products, sums and quotients
// through __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn and the square root
// through __fsqrt_rn, which nvcc never contracts into an FMA, in the twin's
// order of operations; each constant the float32 that PyTorch converts the
// twin's Python double to. So every output is the twin's bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// gs_tpu_torch/models/gaussian_model.py: ADAM_B1, ADAM_B2, ADAM_EPS and the
// twin's (1 - ADAM_B1) and (1 - ADAM_B2), computed in double as Python does
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-15);

struct Args {
  const float* p;              // [rows, stride] parameters, columns [0, n)
  const float* m;              // first moment
  const float* v;              // second moment
  const float* g;              // gradient
  float* p_out;                // the outputs: the inputs themselves in place
  float* m_out;
  float* v_out;
  long long p_stride, m_stride, v_stride, g_stride;
  long long po_stride, mo_stride, vo_stride;
  const float* lr;             // [rows] the rows' rates
  const float* bc1;            // [] 1 - B1^t
  const float* bc2;            // [] 1 - B2^t
  const unsigned char* mask;   // [n] bool, or null: every column
  int vec;                     // every row of every tensor starts on 16
                               // bytes, the mask on 4
  int n;
};

// One element: the twin's m, v and parameter, or the old ones where `on` is
// false (the twin's torch.where).
__device__ __forceinline__ void adam(float& p, float& m, float& v, float g,
                                     bool on, float lr, float bc1, float bc2) {
  const float m1 = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
  const float v1 = __fadd_rn(__fmul_rn(kB2, v),
                             __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  const float step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m1, bc1)),
                               __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), kEps));
  const float p1 = __fsub_rn(p, step);
  if (on) {
    p = p1;
    m = m1;
    v = v1;
  }
}

// A block's view of its row: each tensor's row, the row's rate and the
// bias corrections.
struct Row {
  const float* p;
  const float* m;
  const float* v;
  const float* g;
  float* p_out;
  float* m_out;
  float* v_out;
  float lr, bc1, bc2;
};

__device__ __forceinline__ void column(const Row& r, int col, bool on) {
  float p = r.p[col];
  float m = r.m[col];
  float v = r.v[col];
  adam(p, m, v, r.g[col], on, r.lr, r.bc1, r.bc2);
  r.p_out[col] = p;
  r.m_out[col] = m;
  r.v_out[col] = v;
}

__global__ void __launch_bounds__(kThreads) adam_packed_kernel(const Args a) {
  const long long row = blockIdx.y;
  const Row r{a.p + row * a.p_stride, a.m + row * a.m_stride,
              a.v + row * a.v_stride, a.g + row * a.g_stride,
              a.p_out + row * a.po_stride, a.m_out + row * a.mo_stride,
              a.v_out + row * a.vo_stride, a.lr[row], *a.bc1, *a.bc2};
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const unsigned char* mask = a.mask;
  const int quads = a.vec ? a.n >> 2 : 0;
  for (int q = first; q < quads; q += stride) {
    float4 p = reinterpret_cast<const float4*>(r.p)[q];
    float4 m = reinterpret_cast<const float4*>(r.m)[q];
    float4 v = reinterpret_cast<const float4*>(r.v)[q];
    const float4 g = reinterpret_cast<const float4*>(r.g)[q];
    const uchar4 on = mask == nullptr
                          ? make_uchar4(1, 1, 1, 1)
                          : reinterpret_cast<const uchar4*>(mask)[q];
    adam(p.x, m.x, v.x, g.x, on.x != 0, r.lr, r.bc1, r.bc2);
    adam(p.y, m.y, v.y, g.y, on.y != 0, r.lr, r.bc1, r.bc2);
    adam(p.z, m.z, v.z, g.z, on.z != 0, r.lr, r.bc1, r.bc2);
    adam(p.w, m.w, v.w, g.w, on.w != 0, r.lr, r.bc1, r.bc2);
    reinterpret_cast<float4*>(r.p_out)[q] = p;
    reinterpret_cast<float4*>(r.m_out)[q] = m;
    reinterpret_cast<float4*>(r.v_out)[q] = v;
  }
  // the columns the vectors leave, one a thread
  for (int col = 4 * quads + first; col < a.n; col += stride) {
    column(r, col, mask == nullptr || mask[col] != 0);
  }
}

bool aligned(const void* ptr, long long stride, int bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0 &&
         stride % (bytes / 4) == 0;
}

// Blocks a row gets: the blocks the card keeps resident, shared out over the
// rows (rounded down, so that every block runs in the one wave and they end
// together), and no more than the row has work for. Asked once a device.
int blocks_per_row(int device, int rows, int items) {
  static int resident[kMaxDevices] = {0};
  int& r = resident[device];
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adam_packed_kernel, kThreads, 0);
    r = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int want = (items + kThreads - 1) / kThreads;
  const int share = r / rows > 1 ? r / rows : 1;
  return want < 1 ? 1 : (want < share ? want : share);
}

}  // namespace

// One Adam step of a [rows, n] block: p, m, v, g and the outputs each
// [rows, >= n] float32 with its own row stride (a column slice of a wider
// block is fine), a row's columns contiguous; in place the outputs are p, m
// and v themselves. lr: [rows] float32, the rows' rates. bc1, bc2: []
// float32 on the device. mask: [n] bool or null.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int gs_adam_packed(
    const float* p, long long p_stride, const float* m, long long m_stride,
    const float* v, long long v_stride, const float* g, long long g_stride,
    float* p_out, long long po_stride, float* m_out, long long mo_stride,
    float* v_out, long long vo_stride, const float* lr, const float* bc1,
    const float* bc2, const unsigned char* mask, int rows, int n,
    int device, void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || device < 0 ||
      device >= kMaxDevices || lr == nullptr || bc1 == nullptr ||
      bc2 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned(p, p_stride, 16) && aligned(m, m_stride, 16) &&
                   aligned(v, v_stride, 16) && aligned(g, g_stride, 16) &&
                   aligned(p_out, po_stride, 16) &&
                   aligned(m_out, mo_stride, 16) &&
                   aligned(v_out, vo_stride, 16) &&
                   (mask == nullptr || aligned(mask, 0, 4));
  const Args a{p, m, v, g, p_out, m_out, v_out, p_stride, m_stride, v_stride,
               g_stride, po_stride, mo_stride, vo_stride, lr, bc1, bc2, mask,
               vec, n};
  const int items = vec ? (n >> 2 > 0 ? n >> 2 : 1) : n;
  const dim3 grid(blocks_per_row(device, rows, items), rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adam_packed_kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler made of the kernel: common.cuh::kernel_attributes.
extern "C" int gs_adam_packed_attributes(int device, int* attrs) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return kernel_attributes(reinterpret_cast<const void*>(adam_packed_kernel),
                           kThreads, attrs);
}
