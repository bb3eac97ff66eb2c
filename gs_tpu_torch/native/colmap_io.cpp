// Fast COLMAP binary sparse-model readers (cameras.bin / images.bin /
// points3D.bin) exposed via a C ABI for ctypes — the port's own copy of the
// JAX package's native/colmap_io.cpp (one change: every buffer is allocated
// one element larger, so an empty model is not a failed malloc(0)).
//
// Native equivalent of the framework's data-loader hot path: the reference
// parses these files with per-record Python struct loops
// (ref: scene/colmap_loader.py:125-242), which takes tens of seconds on
// multi-million-point reconstructions; this parser is I/O bound.
//
// Layouts (little-endian, as written by COLMAP):
//   points3D.bin: u64 count; per point: u64 id, 3xf64 xyz, 3xu8 rgb,
//                 f64 error, u64 track_len, track_len x (u32 image_id,
//                 u32 point2d_idx)
//   images.bin:   u64 count; per image: i32 id, 4xf64 qvec, 3xf64 tvec,
//                 i32 camera_id, cstring name, u64 n2d,
//                 n2d x (f64 x, f64 y, i64 point3d_id)
//   cameras.bin:  u64 count; per camera: i32 id, i32 model_id, u64 w, u64 h,
//                 num_params(model) x f64
//
// Build: gs_tpu_torch/native/__init__.py (g++ -O2 -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buf {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  template <typename T>
  T get() {
    if (off + sizeof(T) > n) { ok = false; return T{}; }
    T v;
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }
  bool skip(size_t k) {
    if (off + k > n) { ok = false; return false; }
    off += k;
    return true;
  }
  // reads a NUL-terminated string, returns length (without NUL)
  size_t cstring(size_t* start) {
    *start = off;
    while (off < n && p[off] != 0) off++;
    if (off >= n) { ok = false; return 0; }
    size_t len = off - *start;
    off++;  // NUL
    return len;
  }
};

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> data;
  FILE* f = std::fopen(path, "rb");
  if (!f) return data;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size > 0) {
    data.resize(static_cast<size_t>(size));
    if (std::fread(data.data(), 1, data.size(), f) != data.size())
      data.clear();
  }
  std::fclose(f);
  return data;
}

int camera_model_num_params(int model_id) {
  // ref: scene/colmap_loader.py:24-36 (11 camera models)
  switch (model_id) {
    case 0: return 3;   // SIMPLE_PINHOLE
    case 1: return 4;   // PINHOLE
    case 2: return 4;   // SIMPLE_RADIAL
    case 3: return 5;   // RADIAL
    case 4: return 8;   // OPENCV
    case 5: return 8;   // OPENCV_FISHEYE
    case 6: return 12;  // FULL_OPENCV
    case 7: return 5;   // FOV
    case 8: return 4;   // SIMPLE_RADIAL_FISHEYE
    case 9: return 5;   // RADIAL_FISHEYE
    case 10: return 12; // THIN_PRISM_FISHEYE
    default: return -1;
  }
}

}  // namespace

extern "C" {

void gs_free(void* ptr) { std::free(ptr); }

// Returns 0 on success. Outputs are malloc'd; caller frees via gs_free.
int gs_read_points3d_bin(const char* path, int64_t* out_n, double** out_xyz,
                         uint8_t** out_rgb, double** out_err) {
  std::vector<uint8_t> data = read_file(path);
  if (data.empty()) return 1;
  Buf b{data.data(), data.size()};
  uint64_t count = b.get<uint64_t>();
  if (!b.ok) return 2;
  double* xyz = static_cast<double*>(std::malloc((count + 1) * 3 * sizeof(double)));
  uint8_t* rgb = static_cast<uint8_t*>(std::malloc((count + 1) * 3));
  double* err = static_cast<double*>(std::malloc((count + 1) * sizeof(double)));
  if (!xyz || !rgb || !err) return 3;
  for (uint64_t i = 0; i < count; i++) {
    b.skip(8);  // point id
    xyz[i * 3 + 0] = b.get<double>();
    xyz[i * 3 + 1] = b.get<double>();
    xyz[i * 3 + 2] = b.get<double>();
    rgb[i * 3 + 0] = b.get<uint8_t>();
    rgb[i * 3 + 1] = b.get<uint8_t>();
    rgb[i * 3 + 2] = b.get<uint8_t>();
    err[i] = b.get<double>();
    uint64_t track = b.get<uint64_t>();
    b.skip(track * 8);
    if (!b.ok) { std::free(xyz); std::free(rgb); std::free(err); return 2; }
  }
  *out_n = static_cast<int64_t>(count);
  *out_xyz = xyz;
  *out_rgb = rgb;
  *out_err = err;
  return 0;
}

// images.bin -> parallel arrays. Names are returned as one NUL-joined blob
// plus offsets. 2D observations are skipped (the loaders never use them,
// ref: scene/dataset_readers.py:75-112).
int gs_read_images_bin(const char* path, int64_t* out_n, int32_t** out_ids,
                       double** out_qvecs, double** out_tvecs,
                       int32_t** out_camera_ids, char** out_names,
                       int64_t** out_name_offsets, int64_t* out_names_len) {
  std::vector<uint8_t> data = read_file(path);
  if (data.empty()) return 1;
  Buf b{data.data(), data.size()};
  uint64_t count = b.get<uint64_t>();
  if (!b.ok) return 2;
  int32_t* ids = static_cast<int32_t*>(std::malloc((count + 1) * sizeof(int32_t)));
  double* qvecs = static_cast<double*>(std::malloc((count + 1) * 4 * sizeof(double)));
  double* tvecs = static_cast<double*>(std::malloc((count + 1) * 3 * sizeof(double)));
  int32_t* cam_ids = static_cast<int32_t*>(std::malloc((count + 1) * sizeof(int32_t)));
  int64_t* name_off = static_cast<int64_t*>(std::malloc((count + 1) * sizeof(int64_t)));
  std::vector<char> names;
  names.reserve(count * 32);
  if (!ids || !qvecs || !tvecs || !cam_ids || !name_off) return 3;
  for (uint64_t i = 0; i < count; i++) {
    ids[i] = b.get<int32_t>();
    for (int k = 0; k < 4; k++) qvecs[i * 4 + k] = b.get<double>();
    for (int k = 0; k < 3; k++) tvecs[i * 3 + k] = b.get<double>();
    cam_ids[i] = b.get<int32_t>();
    size_t start, len;
    len = b.cstring(&start);
    name_off[i] = static_cast<int64_t>(names.size());
    names.insert(names.end(),
                 reinterpret_cast<const char*>(data.data() + start),
                 reinterpret_cast<const char*>(data.data() + start + len));
    uint64_t n2d = b.get<uint64_t>();
    b.skip(n2d * 24);
    if (!b.ok) {
      std::free(ids); std::free(qvecs); std::free(tvecs);
      std::free(cam_ids); std::free(name_off);
      return 2;
    }
  }
  name_off[count] = static_cast<int64_t>(names.size());
  char* names_blob = static_cast<char*>(std::malloc(names.size() + 1));
  if (!names_blob) return 3;
  std::memcpy(names_blob, names.data(), names.size());
  names_blob[names.size()] = 0;
  *out_n = static_cast<int64_t>(count);
  *out_ids = ids;
  *out_qvecs = qvecs;
  *out_tvecs = tvecs;
  *out_camera_ids = cam_ids;
  *out_names = names_blob;
  *out_name_offsets = name_off;
  *out_names_len = static_cast<int64_t>(names.size());
  return 0;
}

int gs_read_cameras_bin(const char* path, int64_t* out_n, int32_t** out_ids,
                        int32_t** out_model_ids, int64_t** out_wh,
                        double** out_params, int32_t** out_param_counts) {
  std::vector<uint8_t> data = read_file(path);
  if (data.empty()) return 1;
  Buf b{data.data(), data.size()};
  uint64_t count = b.get<uint64_t>();
  if (!b.ok) return 2;
  int32_t* ids = static_cast<int32_t*>(std::malloc((count + 1) * sizeof(int32_t)));
  int32_t* models = static_cast<int32_t*>(std::malloc((count + 1) * sizeof(int32_t)));
  int64_t* wh = static_cast<int64_t*>(std::malloc((count + 1) * 2 * sizeof(int64_t)));
  int32_t* pcounts = static_cast<int32_t*>(std::malloc((count + 1) * sizeof(int32_t)));
  std::vector<double> params;
  if (!ids || !models || !wh || !pcounts) return 3;
  for (uint64_t i = 0; i < count; i++) {
    ids[i] = b.get<int32_t>();
    models[i] = b.get<int32_t>();
    wh[i * 2 + 0] = static_cast<int64_t>(b.get<uint64_t>());
    wh[i * 2 + 1] = static_cast<int64_t>(b.get<uint64_t>());
    int np = camera_model_num_params(models[i]);
    if (np < 0 || !b.ok) return 2;
    pcounts[i] = np;
    for (int k = 0; k < np; k++) params.push_back(b.get<double>());
  }
  double* pblob = static_cast<double*>(std::malloc((params.size() + 1) * sizeof(double)));
  if (!pblob) return 3;
  std::memcpy(pblob, params.data(), params.size() * sizeof(double));
  *out_n = static_cast<int64_t>(count);
  *out_ids = ids;
  *out_model_ids = models;
  *out_wh = wh;
  *out_params = pblob;
  *out_param_counts = pcounts;
  return 0;
}

}  // extern "C"
