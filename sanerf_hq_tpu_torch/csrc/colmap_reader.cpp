// COLMAP binary sparse-model reader, host C++ (not a kernel): the port's own
// copy of the repository's csrc/colmap_reader.cpp.
//
// Parses the public COLMAP binary format
// (https://colmap.github.io/format.html) into flat arrays that
// sanerf_hq_tpu_torch/data/colmap_native.py reads through ctypes.  Every
// function returns a negative value on a missing, short or malformed file.
//
// Built at first use: g++ -O3 -shared -fPIC -std=c++17 into build/.

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
  T read() {
    T v{};
    if (off + sizeof(T) > n) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }

  bool read_bytes(void* dst, size_t len) {
    if (off + len > n) {
      ok = false;
      return false;
    }
    std::memcpy(dst, p + off, len);
    off += len;
    return true;
  }
};

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> data;
  FILE* f = std::fopen(path, "rb");
  if (!f) return data;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz <= 0) {
    std::fclose(f);
    return data;
  }
  data.resize(sz);
  if (std::fread(data.data(), 1, sz, f) != static_cast<size_t>(sz)) data.clear();
  std::fclose(f);
  return data;
}

int num_params_for_model(int model_id) {
  static const int table[] = {3, 4, 4, 5, 8, 8, 12, 5, 4, 5, 12};
  if (model_id < 0 || model_id > 10) return -1;
  return table[model_id];
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// cameras.bin -> (ids[i], model_ids[i], widths[i], heights[i],
//                 params flattened + param_offsets)
// Returns number of cameras, or -1 on error.  Caller provides capacities.
// ---------------------------------------------------------------------------
long long read_cameras_bin(const char* path, long long cap_cams,
                           long long cap_params, int32_t* ids,
                           int32_t* model_ids, int64_t* widths,
                           int64_t* heights, double* params,
                           int64_t* param_offsets) {
  auto data = read_file(path);
  if (data.empty()) return -1;
  Buf b{data.data(), data.size()};
  uint64_t n = b.read<uint64_t>();
  if (!b.ok || static_cast<long long>(n) > cap_cams) return -1;
  int64_t poff = 0;
  for (uint64_t i = 0; i < n; ++i) {
    ids[i] = b.read<int32_t>();
    model_ids[i] = b.read<int32_t>();
    widths[i] = static_cast<int64_t>(b.read<uint64_t>());
    heights[i] = static_cast<int64_t>(b.read<uint64_t>());
    int np = num_params_for_model(model_ids[i]);
    if (np < 0 || poff + np > cap_params) return -1;
    param_offsets[i] = poff;
    if (!b.read_bytes(params + poff, np * sizeof(double))) return -1;
    poff += np;
  }
  param_offsets[n] = poff;
  return b.ok ? static_cast<long long>(n) : -1;
}

// ---------------------------------------------------------------------------
// images.bin, pass 1: count images and total 2D points.
// out[0] = num images, out[1] = total 2D points.  Returns 0 on success.
// ---------------------------------------------------------------------------
int probe_images_bin(const char* path, int64_t* out) {
  auto data = read_file(path);
  if (data.empty()) return -1;
  Buf b{data.data(), data.size()};
  uint64_t n = b.read<uint64_t>();
  uint64_t total2d = 0;
  for (uint64_t i = 0; i < n && b.ok; ++i) {
    b.off += 4 + 4 * 8 + 3 * 8 + 4;  // id, qvec, tvec, camera_id
    while (b.off < b.n && data[b.off] != 0) ++b.off;  // name
    ++b.off;
    uint64_t n2d = b.read<uint64_t>();
    total2d += n2d;
    b.off += n2d * 24;
  }
  if (!b.ok) return -1;
  out[0] = static_cast<int64_t>(n);
  out[1] = static_cast<int64_t>(total2d);
  return 0;
}

// ---------------------------------------------------------------------------
// images.bin, pass 2: fill flat arrays.
//   ids[i], qvecs[4i..], tvecs[3i..], camera_ids[i],
//   names: cap_name bytes per image (null-terminated; a longer name
//   returns -2),
//   p2d_offsets[i]: start of image i's 2D points (and [n] = total),
//   xys[2k..], point3d_ids[k]
// ---------------------------------------------------------------------------
long long read_images_bin(const char* path, long long cap_imgs,
                          long long cap_p2d, int32_t cap_name, int32_t* ids,
                          double* qvecs, double* tvecs, int32_t* camera_ids,
                          char* names, int64_t* p2d_offsets, double* xys,
                          int64_t* point3d_ids) {
  auto data = read_file(path);
  if (data.empty()) return -1;
  Buf b{data.data(), data.size()};
  uint64_t n = b.read<uint64_t>();
  if (!b.ok || static_cast<long long>(n) > cap_imgs) return -1;
  int64_t k = 0;
  for (uint64_t i = 0; i < n; ++i) {
    ids[i] = b.read<int32_t>();
    b.read_bytes(qvecs + 4 * i, 4 * sizeof(double));
    b.read_bytes(tvecs + 3 * i, 3 * sizeof(double));
    camera_ids[i] = b.read<int32_t>();
    // name
    int32_t w = 0;
    char* dst = names + static_cast<int64_t>(i) * cap_name;
    while (b.off < b.n && data[b.off] != 0) {
      if (w >= cap_name - 1) return -2;  // a name longer than cap_name - 1
      dst[w++] = static_cast<char>(data[b.off]);
      ++b.off;
    }
    dst[w] = 0;
    ++b.off;
    uint64_t n2d = b.read<uint64_t>();
    if (k + static_cast<int64_t>(n2d) > cap_p2d) return -1;
    p2d_offsets[i] = k;
    for (uint64_t j = 0; j < n2d; ++j) {
      xys[2 * k] = b.read<double>();
      xys[2 * k + 1] = b.read<double>();
      point3d_ids[k] = b.read<int64_t>();
      ++k;
    }
  }
  p2d_offsets[n] = k;
  return b.ok ? static_cast<long long>(n) : -1;
}

// ---------------------------------------------------------------------------
// points3D.bin, pass 1: count points and total track length.
// ---------------------------------------------------------------------------
int probe_points3d_bin(const char* path, int64_t* out) {
  auto data = read_file(path);
  if (data.empty()) return -1;
  Buf b{data.data(), data.size()};
  uint64_t n = b.read<uint64_t>();
  uint64_t total_track = 0;
  for (uint64_t i = 0; i < n && b.ok; ++i) {
    b.off += 8 + 3 * 8 + 3 + 8;  // id, xyz, rgb, error
    uint64_t tl = b.read<uint64_t>();
    total_track += tl;
    b.off += tl * 8;
  }
  if (!b.ok) return -1;
  out[0] = static_cast<int64_t>(n);
  out[1] = static_cast<int64_t>(total_track);
  return 0;
}

// ---------------------------------------------------------------------------
// points3D.bin, pass 2.
// ---------------------------------------------------------------------------
long long read_points3d_bin(const char* path, long long cap_pts,
                            long long cap_track, int64_t* ids, double* xyzs,
                            uint8_t* rgbs, double* errors,
                            int64_t* track_offsets, int32_t* track_image_ids,
                            int32_t* track_p2d_idxs) {
  auto data = read_file(path);
  if (data.empty()) return -1;
  Buf b{data.data(), data.size()};
  uint64_t n = b.read<uint64_t>();
  if (!b.ok || static_cast<long long>(n) > cap_pts) return -1;
  int64_t k = 0;
  for (uint64_t i = 0; i < n; ++i) {
    ids[i] = static_cast<int64_t>(b.read<uint64_t>());
    b.read_bytes(xyzs + 3 * i, 3 * sizeof(double));
    b.read_bytes(rgbs + 3 * i, 3);
    errors[i] = b.read<double>();
    uint64_t tl = b.read<uint64_t>();
    if (k + static_cast<int64_t>(tl) > cap_track) return -1;
    track_offsets[i] = k;
    for (uint64_t j = 0; j < tl; ++j) {
      track_image_ids[k] = b.read<int32_t>();
      track_p2d_idxs[k] = b.read<int32_t>();
      ++k;
    }
  }
  track_offsets[n] = k;
  return b.ok ? static_cast<long long>(n) : -1;
}

}  // extern "C"
