// slamio — native dataset-ingest runtime for monocular_slam_tpu.
//
// The reference's data loader is C++ over OpenCV imread + dirent
// (`src/FrameLoader.cpp:36-95`). This is its equivalent here: a
// dependency-free PNG decoder (zlib inflate + scanline unfiltering) plus a
// std::thread batch loader, so dataset ingestion can saturate host cores
// while the device computes. Exposed via a C ABI for ctypes (no pybind11 in
// the image).
//
// Supported PNG subset: bit depth 8/16, color types 0 (gray), 2 (RGB),
// 4 (gray+alpha), 6 (RGBA), no interlacing — covers TUM rgb/depth (8-bit
// RGB + 16-bit gray) and KITTI (8-bit gray) entirely.
//
// Build: g++ -O3 -shared -fPIC slamio.cpp -o libslamio.so -lz -pthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct PngInfo {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, channels = 0;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

int channels_for(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0;
  }
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Parse chunks, inflate IDAT, unfilter. Returns 0 on success.
int decode_png_impl(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
                    PngInfo& info) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || std::memcmp(data, magic, 8) != 0) return -1;

  std::vector<uint8_t> idat;
  size_t pos = 8;
  bool seen_ihdr = false;
  while (pos + 8 <= len) {
    uint32_t clen = be32(data + pos);
    const uint8_t* ctype = data + pos + 4;
    const uint8_t* cdata = data + pos + 8;
    if (pos + 12 + clen > len) return -2;
    if (std::memcmp(ctype, "IHDR", 4) == 0) {
      if (clen < 13) return -3;
      info.width = be32(cdata);
      info.height = be32(cdata + 4);
      info.bit_depth = cdata[8];
      info.color_type = cdata[9];
      int interlace = cdata[12];
      info.channels = channels_for(info.color_type);
      if (info.channels == 0) return -4;               // palette unsupported
      if (info.bit_depth != 8 && info.bit_depth != 16) return -5;
      if (interlace != 0) return -6;                   // Adam7 unsupported
      seen_ihdr = true;
    } else if (std::memcmp(ctype, "IDAT", 4) == 0) {
      idat.insert(idat.end(), cdata, cdata + clen);
    } else if (std::memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + clen;
  }
  if (!seen_ihdr || idat.empty()) return -7;

  const size_t bpp = size_t(info.channels) * (info.bit_depth / 8);  // bytes/pixel
  const size_t stride = bpp * info.width;
  const size_t raw_size = (stride + 1) * info.height;
  std::vector<uint8_t> raw(raw_size);

  uLongf dst_len = raw_size;
  int zrc = uncompress(raw.data(), &dst_len, idat.data(), idat.size());
  if (zrc != Z_OK || dst_len != raw_size) return -8;

  out.resize(stride * info.height);
  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < info.height; ++y) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = out.data() + y * stride;
    switch (filter) {
      case 0:
        std::memcpy(dst, line, stride);
        break;
      case 1:  // Sub
        for (size_t x = 0; x < stride; ++x)
          dst[x] = line[x] + (x >= bpp ? dst[x - bpp] : 0);
        break;
      case 2:  // Up
        for (size_t x = 0; x < stride; ++x) dst[x] = line[x] + prev[x];
        break;
      case 3:  // Average
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          dst[x] = line[x] + uint8_t((a + prev[x]) / 2);
        }
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int c = x >= bpp ? prev[x - bpp] : 0;
          dst[x] = line[x] + uint8_t(paeth(a, prev[x], c));
        }
        break;
      default:
        return -9;
    }
    std::memcpy(prev.data(), dst, stride);
  }
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(size_t(n));
  size_t got = std::fread(buf.data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n) ? 0 : -2;
}

// Decode + convert to float32 grayscale [0, 255] (or depth-scaled), the
// layout the frontend consumes. 16-bit values are big-endian per PNG.
int decode_to_f32_gray(const uint8_t* bytes, size_t len, float* out_f32,
                       int out_capacity, int* w, int* h, float scale16) {
  PngInfo info;
  std::vector<uint8_t> pix;
  int rc = decode_png_impl(bytes, len, pix, info);
  if (rc != 0) return rc;
  if (int(info.width * info.height) > out_capacity) return -10;
  *w = int(info.width);
  *h = int(info.height);
  const size_t n = size_t(info.width) * info.height;
  const int ch = info.channels;
  if (info.bit_depth == 8) {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = pix.data() + i * ch;
      float v;
      if (ch >= 3)
        v = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      else
        v = float(p[0]);
      out_f32[i] = v;
    }
  } else {  // 16-bit (TUM depth maps: gray16, scale to meters via scale16)
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = pix.data() + i * ch * 2;
      uint16_t v = (uint16_t(p[0]) << 8) | p[1];
      out_f32[i] = float(v) * scale16;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode a PNG file to float32 grayscale. scale16 applies to 16-bit images
// (use 1/5000 for TUM depth, 1/256 to view as 8-bit-like). Returns 0 on
// success, negative error codes otherwise.
int slamio_load_png_f32(const char* path, float* out, int out_capacity,
                        int* w, int* h, float scale16) {
  std::vector<uint8_t> buf;
  if (read_file(path, buf) != 0) return -100;
  return decode_to_f32_gray(buf.data(), buf.size(), out, out_capacity, w, h,
                            scale16);
}

// Probe width/height without full decode.
int slamio_png_size(const char* path, int* w, int* h) {
  std::vector<uint8_t> buf;
  if (read_file(path, buf) != 0) return -100;
  if (buf.size() < 33) return -1;
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(buf.data(), magic, 8) != 0) return -1;
  *w = int(be32(buf.data() + 16));
  *h = int(be32(buf.data() + 20));
  return 0;
}

// Threaded batch load: n images, each decoded into out + i*capacity floats.
// whs receives interleaved (w0, h0, w1, h1, ...). rcs receives per-image
// return codes. n_threads <= 0 selects hardware concurrency.
void slamio_load_batch_f32(const char** paths, int n, float* out,
                           int capacity, int* whs, int* rcs, float scale16,
                           int n_threads) {
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  std::vector<int> next(1, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      rcs[i] = slamio_load_png_f32(paths[i], out + size_t(i) * capacity,
                                   capacity, &whs[2 * i], &whs[2 * i + 1],
                                   scale16);
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& th : workers) th.join();
}

// Fast TUM-style list file parser: lines "timestamp path". Returns number of
// rows parsed; timestamps into ts (capacity max_rows), path offsets are not
// returned (python slices the text) — this exists for the hot groundtruth
// parse: "ts tx ty tz qx qy qz qw" rows into out (max_rows x 8).
int slamio_parse_trajectory(const char* path, double* out, int max_rows) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[1024];
  int rows = 0;
  while (std::fgets(line, sizeof line, f) && rows < max_rows) {
    if (line[0] == '#' || line[0] == '\n') continue;
    double v[8];
    int got = std::sscanf(line, "%lf %lf %lf %lf %lf %lf %lf %lf", &v[0],
                          &v[1], &v[2], &v[3], &v[4], &v[5], &v[6], &v[7]);
    if (got == 8) {
      std::memcpy(out + rows * 8, v, sizeof v);
      ++rows;
    }
  }
  std::fclose(f);
  return rows;
}

}  // extern "C"
