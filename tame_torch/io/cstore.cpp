// tamestore: fast host-side tensor snapshot store (C++ native layer).
//
// The reference has no native components (it pickles whole Python objects,
// reference experiments/utils.py:72-143).  This framework's training-state
// checkpoints are large dense arrays (X_mean, X_cov at n=2000/T=50/d=10 is
// ~40 MB+) written every few seconds during long fits, so the hot snapshot
// path is native: a single-pass streaming write with CRC32 integrity and a
// fixed binary header, no Python-object serialization on the critical path.
//
// File format (little-endian):
//   u32 magic 'TAME' (0x454d4154)  u32 version
//   u32 dtype_code                 u32 ndim
//   i64 shape[ndim]
//   u32 crc32(data)                u32 reserved
//   data bytes
//
// dtype codes: 0=f32 1=f64 2=i32 3=i64 4=u8 5=bf16 6=f16
//
// Exposed as a plain C ABI for ctypes binding (tame_torch/io/native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0x454d4154u;  // 'TAME'
constexpr uint32_t kVersion = 1u;
constexpr int kMaxDims = 16;

uint32_t crc32_table[256];
bool crc32_ready = false;

void crc32_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1u) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc32_ready = true;
}

uint32_t crc32_run(const uint8_t* data, int64_t n) {
  if (!crc32_ready) crc32_init();
  uint32_t c = 0xffffffffu;
  for (int64_t i = 0; i < n; ++i)
    c = crc32_table[(c ^ data[i]) & 0xffu] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

}  // namespace

extern "C" {

// CRC32 of a buffer (exposed for tests / manifest checks).
uint32_t tamestore_crc32(const void* data, int64_t nbytes) {
  return crc32_run(static_cast<const uint8_t*>(data), nbytes);
}

// Write one tensor. Returns 0 on success, negative error code otherwise.
int64_t tamestore_write(const char* path, const void* data, int64_t nbytes,
                        const int64_t* shape, int32_t ndim,
                        int32_t dtype_code) {
  if (ndim < 0 || ndim > kMaxDims) return -2;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;

  uint32_t header32[4] = {kMagic, kVersion,
                          static_cast<uint32_t>(dtype_code),
                          static_cast<uint32_t>(ndim)};
  uint32_t crc = crc32_run(static_cast<const uint8_t*>(data), nbytes);
  uint32_t tail32[2] = {crc, 0u};

  bool ok = std::fwrite(header32, sizeof(header32), 1, f) == 1;
  if (ok && ndim > 0)
    ok = std::fwrite(shape, sizeof(int64_t), ndim, f) ==
         static_cast<size_t>(ndim);
  ok = ok && std::fwrite(tail32, sizeof(tail32), 1, f) == 1;
  if (ok && nbytes > 0)
    ok = std::fwrite(data, 1, nbytes, f) == static_cast<size_t>(nbytes);
  ok = std::fclose(f) == 0 && ok;
  return ok ? 0 : -3;
}

// Read the header: fills shape_out (capacity >= 16), ndim_out, dtype_out,
// crc_out. Returns payload nbytes, or negative error code.
int64_t tamestore_header(const char* path, int64_t* shape_out,
                         int32_t* ndim_out, int32_t* dtype_out,
                         uint32_t* crc_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint32_t header32[4];
  if (std::fread(header32, sizeof(header32), 1, f) != 1 ||
      header32[0] != kMagic || header32[1] != kVersion) {
    std::fclose(f);
    return -4;
  }
  int32_t ndim = static_cast<int32_t>(header32[3]);
  if (ndim < 0 || ndim > kMaxDims) {
    std::fclose(f);
    return -2;
  }
  int64_t shape[kMaxDims];
  if (ndim > 0 &&
      std::fread(shape, sizeof(int64_t), ndim, f) !=
          static_cast<size_t>(ndim)) {
    std::fclose(f);
    return -3;
  }
  uint32_t tail32[2];
  if (std::fread(tail32, sizeof(tail32), 1, f) != 1) {
    std::fclose(f);
    return -3;
  }
  static const int64_t dtype_sizes[] = {4, 8, 4, 8, 1, 2, 2};
  int32_t dtype = static_cast<int32_t>(header32[2]);
  if (dtype < 0 || dtype > 6) {
    std::fclose(f);
    return -5;
  }
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) {
    shape_out[i] = shape[i];
    count *= shape[i];
  }
  *ndim_out = ndim;
  *dtype_out = dtype;
  *crc_out = tail32[0];
  std::fclose(f);
  return count * dtype_sizes[dtype];
}

// Read payload into caller-allocated buffer (nbytes from tamestore_header).
// Returns 0 on success (including CRC match), negative error otherwise.
int64_t tamestore_read(const char* path, void* out, int64_t nbytes) {
  int64_t shape[kMaxDims];
  int32_t ndim, dtype;
  uint32_t crc_expect;
  int64_t want = tamestore_header(path, shape, &ndim, &dtype, &crc_expect);
  if (want < 0) return want;
  if (want != nbytes) return -6;

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long offset = 16 + 8 * ndim + 8;
  if (std::fseek(f, offset, SEEK_SET) != 0) {
    std::fclose(f);
    return -3;
  }
  bool ok = nbytes == 0 ||
            std::fread(out, 1, nbytes, f) == static_cast<size_t>(nbytes);
  std::fclose(f);
  if (!ok) return -3;
  uint32_t crc = crc32_run(static_cast<const uint8_t*>(out), nbytes);
  return crc == crc_expect ? 0 : -7;
}

}  // extern "C"
