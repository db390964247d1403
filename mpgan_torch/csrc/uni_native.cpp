// Native .uni volume codec of the PyTorch port: the port's own copy of
// native/uni_native.cpp, the JAX package's codec.
//
// The pure-Python decoder (mpgan_torch/io/uni.py) is correct but
// single-threaded and allocation-heavy for dataset-scale loads. This library
// provides the hot path: header probe + payload decode straight into a
// caller-provided buffer, with no Python-level copies. Calls release the GIL
// (plain ctypes), so a Python ThreadPoolExecutor over files gives genuinely
// parallel decode.
//
// Format (matching the tempoGAN-family Python tooling; see uni.py):
//   gzip stream of: 4-byte magic ("MNT2"/"MNT3") + 288-byte packed header +
//   raw little-endian int32/float32 grid data, C order (Z, Y, X, C).
//
// Build: g++ -O3 -shared -fPIC uni_native.cpp -o libuni_native.so -lz, at
// first use into mpgan_torch/_build/ (mpgan_torch/_build.py build_host;
// the ctypes bindings are mpgan_torch/io/native.py).

#include <zlib.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kHeaderBytes = 288;

struct HeaderFields {
  int32_t dim_x, dim_y, dim_z;
  int32_t grid_type, element_type, bytes_per_element;
  int32_t dim_t;
  int64_t timestamp;
};

// Parse the 288-byte header region given the magic. MNT2 lays out
// iiiiii 256s Q; MNT3 lays out iiiiii 252s i Q (tempoGAN tooling layout).
bool parse_header(const unsigned char* buf, bool mnt3, HeaderFields* out) {
  std::memcpy(&out->dim_x, buf + 0, 4);
  std::memcpy(&out->dim_y, buf + 4, 4);
  std::memcpy(&out->dim_z, buf + 8, 4);
  std::memcpy(&out->grid_type, buf + 12, 4);
  std::memcpy(&out->element_type, buf + 16, 4);
  std::memcpy(&out->bytes_per_element, buf + 20, 4);
  if (mnt3) {
    std::memcpy(&out->dim_t, buf + 24 + 252, 4);
    std::memcpy(&out->timestamp, buf + 24 + 252 + 4, 8);
  } else {
    out->dim_t = 0;
    std::memcpy(&out->timestamp, buf + 24 + 256, 8);
  }
  return true;
}

// Open + read magic and header. Returns the gzFile positioned at the payload,
// or nullptr on failure.
gzFile open_at_payload(const char* path, HeaderFields* hf) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  unsigned char magic[4];
  if (gzread(f, magic, 4) != 4) { gzclose(f); return nullptr; }
  bool mnt3;
  if (std::memcmp(magic, "MNT3", 4) == 0) mnt3 = true;
  else if (std::memcmp(magic, "MNT2", 4) == 0) mnt3 = false;
  else { gzclose(f); return nullptr; }
  unsigned char hdr[kHeaderBytes];
  if (gzread(f, hdr, kHeaderBytes) != kHeaderBytes) { gzclose(f); return nullptr; }
  parse_header(hdr, mnt3, hf);
  return f;
}

}  // namespace

extern "C" {

// dims_out: [dimZ, dimY, dimX, channels, elementType, dimT, gridType].
// gridType rides along so callers gating on header bits (MAC recentering)
// need no second Python-side gzip decode per file. Returns 0 on success,
// negative error code otherwise.
int uni_read_header(const char* path, int32_t* dims_out) {
  HeaderFields hf;
  gzFile f = open_at_payload(path, &hf);
  if (!f) return -1;
  gzclose(f);
  dims_out[0] = hf.dim_z;
  dims_out[1] = hf.dim_y;
  dims_out[2] = hf.dim_x;
  dims_out[3] = hf.element_type == 2 ? 3 : 1;
  dims_out[4] = hf.element_type;
  dims_out[5] = hf.dim_t;
  dims_out[6] = hf.grid_type;
  return 0;
}

// Decode the full payload into out (caller-allocated, out_bytes long).
// Returns bytes written, or a negative error code.
int64_t uni_read_data(const char* path, void* out, int64_t out_bytes) {
  HeaderFields hf;
  gzFile f = open_at_payload(path, &hf);
  if (!f) return -1;
  int64_t want =
      static_cast<int64_t>(hf.dim_x) * hf.dim_y * hf.dim_z *
      (hf.dim_t > 1 ? hf.dim_t : 1) * hf.bytes_per_element;
  if (want > out_bytes) { gzclose(f); return -2; }
  int64_t got = 0;
  unsigned char* dst = static_cast<unsigned char*>(out);
  while (got < want) {
    // gzread caps at INT_MAX per call; chunk at 256 MB
    int chunk = static_cast<int>(want - got > (1 << 28) ? (1 << 28) : want - got);
    int n = gzread(f, dst + got, chunk);
    if (n <= 0) { gzclose(f); return -3; }
    got += n;
  }
  gzclose(f);
  return got;
}

// Encode (Z,Y,X,C) float32/int32 data as an MNT3 .uni file. info may be
// null. Returns 0 on success.
int uni_write(const char* path, const int32_t* dims /*z,y,x,c*/,
              int32_t grid_type, int32_t element_type, const void* data,
              int64_t data_bytes, const char* info, int64_t timestamp,
              int level) {
  gzFile f = gzopen(path, level == 1 ? "wb1" : "wb6");
  if (!f) return -1;
  unsigned char hdr[4 + kHeaderBytes];
  std::memset(hdr, 0, sizeof(hdr));
  std::memcpy(hdr, "MNT3", 4);
  int32_t vals[6] = {dims[2], dims[1], dims[0], grid_type, element_type,
                     element_type == 2 ? 12 : 4};
  std::memcpy(hdr + 4, vals, 24);
  if (info) std::strncpy(reinterpret_cast<char*>(hdr + 4 + 24), info, 251);
  int32_t dim_t = 0;
  std::memcpy(hdr + 4 + 24 + 252, &dim_t, 4);
  std::memcpy(hdr + 4 + 24 + 252 + 4, &timestamp, 8);
  if (gzwrite(f, hdr, sizeof(hdr)) != static_cast<int>(sizeof(hdr))) {
    gzclose(f);
    return -2;
  }
  int64_t put = 0;
  const unsigned char* src = static_cast<const unsigned char*>(data);
  while (put < data_bytes) {
    int chunk = static_cast<int>(
        data_bytes - put > (1 << 28) ? (1 << 28) : data_bytes - put);
    int n = gzwrite(f, src + put, chunk);
    if (n <= 0) { gzclose(f); return -3; }
    put += n;
  }
  gzclose(f);
  return 0;
}

}  // extern "C"
