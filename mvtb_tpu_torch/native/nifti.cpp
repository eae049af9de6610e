// Native NIfTI-1 decoder: gzip inflate + header parse + one-pass voxel
// convert, for the host data path.
//
// The reference loads NIfTI via nibabel inside MONAI's LoadImaged
// (reference: source_code/baseline.py:116-130); that stack materializes the
// full decompressed byte buffer, then casts. Here the gzip stream is decoded
// in fixed-size chunks and each chunk is converted (dtype -> float32, with
// scl_slope/scl_inter applied) straight into the caller's output buffer, so
// a BraTS volume costs one pass and no intermediate allocation. zlib's
// gzopen transparently reads uncompressed .nii as well, so one code path
// serves both layouts.
//
// Little-endian NIfTI-1 only (matches mvtb_tpu_torch.data.nifti.read_nifti).

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr int64_t kChunkBytes = 1 << 20;  // 1 MiB decode buffer

struct Header {
  int64_t dims[8];  // dims[0] = ndim
  int32_t datatype;
  int64_t vox_offset;
  double scl_slope;
  double scl_inter;
  double srow[12];  // rows x of the 3x4 voxel->world map
};

template <typename T>
int64_t convert(const unsigned char* src, int64_t nbytes, float* dst,
                double slope, double inter, bool scale) {
  const int64_t n = nbytes / static_cast<int64_t>(sizeof(T));
  T v;
  if (scale) {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(&v, src + i * sizeof(T), sizeof(T));
      dst[i] = static_cast<float>(static_cast<double>(v) * slope + inter);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(&v, src + i * sizeof(T), sizeof(T));
      dst[i] = static_cast<float>(v);
    }
  }
  return n;
}

int64_t element_size(int32_t datatype) {
  switch (datatype) {
    case 2:  // uint8
    case 256: return 1;  // int8
    case 4:  // int16
    case 512: return 2;  // uint16
    case 8:  // int32
    case 16:  // float32
    case 768: return 4;  // uint32
    case 64: return 8;  // float64
    default: return 0;
  }
}

int64_t convert_chunk(int32_t datatype, const unsigned char* src,
                      int64_t nbytes, float* dst, double slope, double inter,
                      bool scale) {
  switch (datatype) {
    case 2: return convert<uint8_t>(src, nbytes, dst, slope, inter, scale);
    case 4: return convert<int16_t>(src, nbytes, dst, slope, inter, scale);
    case 8: return convert<int32_t>(src, nbytes, dst, slope, inter, scale);
    case 16: return convert<float>(src, nbytes, dst, slope, inter, scale);
    case 64: return convert<double>(src, nbytes, dst, slope, inter, scale);
    case 256: return convert<int8_t>(src, nbytes, dst, slope, inter, scale);
    case 512: return convert<uint16_t>(src, nbytes, dst, slope, inter, scale);
    case 768: return convert<uint32_t>(src, nbytes, dst, slope, inter, scale);
    default: return -1;
  }
}

template <typename T>
T read_le(const unsigned char* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));  // build targets are little-endian
  return v;
}

// Reads and validates the 348-byte header. Returns 0 on success.
int parse_header(gzFile f, Header* out) {
  unsigned char raw[348];
  if (gzread(f, raw, 348) != 348) return -2;         // truncated
  if (read_le<int32_t>(raw) != 348) return -3;       // not LE NIfTI-1
  out->dims[0] = read_le<int16_t>(raw + 40);
  if (out->dims[0] < 1 || out->dims[0] > 7) return -3;
  for (int i = 1; i < 8; ++i)
    out->dims[i] = read_le<int16_t>(raw + 40 + 2 * i);
  out->datatype = read_le<int16_t>(raw + 70);
  out->vox_offset = static_cast<int64_t>(read_le<float>(raw + 108));
  out->scl_slope = read_le<float>(raw + 112);
  out->scl_inter = read_le<float>(raw + 116);
  for (int i = 0; i < 12; ++i)
    out->srow[i] = read_le<float>(raw + 280 + 4 * i);
  if (element_size(out->datatype) == 0) return -4;   // unsupported dtype
  if (out->vox_offset < 348) return -5;
  return 0;
}

}  // namespace

extern "C" {

// Parse the header of a .nii / .nii.gz file into the 23-double layout
// consumed by the ctypes binding:
//   [0..7] dims (ndim first), [8] datatype, [9] vox_offset,
//   [10] scl_slope, [11] scl_inter, [12..23] srow rows.
// Returns 0 on success, a negative code otherwise.
int nifti_read_header(const char* path, double* out23) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = parse_header(f, &h);
  gzclose(f);
  if (rc != 0) return rc;
  for (int i = 0; i < 8; ++i) out23[i] = static_cast<double>(h.dims[i]);
  out23[8] = h.datatype;
  out23[9] = static_cast<double>(h.vox_offset);
  out23[10] = h.scl_slope;
  out23[11] = h.scl_inter;
  for (int i = 0; i < 12; ++i) out23[12 + i] = h.srow[i];
  return 0;
}

// Decode n voxels into out (float32, raw file order == Fortran order over
// the dims). scl scaling is applied iff the header slope is neither 0 nor 1
// (same rule as the Python reader). Returns 0 on success.
int nifti_read_f32(const char* path, float* out, int64_t n) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  gzbuffer(f, 1 << 18);
  Header h;
  int rc = parse_header(f, &h);
  if (rc != 0) { gzclose(f); return rc; }
  const int64_t esz = element_size(h.datatype);
  const bool scale = (h.scl_slope != 0.0) && (h.scl_slope != 1.0);

  // Skip the gap between the header and vox_offset (gzseek on a compressed
  // stream decompresses forward, which is exactly this read loop anyway).
  std::vector<unsigned char> storage(kChunkBytes);
  unsigned char* buf = storage.data();
  int64_t skip = h.vox_offset - 348;
  while (skip > 0) {
    int got = gzread(f, buf, static_cast<unsigned>(
        skip < kChunkBytes ? skip : kChunkBytes));
    if (got <= 0) { gzclose(f); return -6; }
    skip -= got;
  }

  int64_t remaining = n * esz;
  if (h.datatype == 16 && !scale) {
    // float32 without scaling: inflate straight into the caller's buffer.
    unsigned char* raw = reinterpret_cast<unsigned char*>(out);
    while (remaining > 0) {
      const int64_t want = remaining < (1 << 24) ? remaining : (1 << 24);
      const int got = gzread(f, raw, static_cast<unsigned>(want));
      if (got <= 0) { gzclose(f); return -6; }
      raw += got;
      remaining -= got;
    }
    gzclose(f);
    return 0;
  }
  float* dst = out;
  int64_t carry = 0;  // bytes of a split element carried between chunks
  while (remaining > 0) {
    const int64_t want =
        (remaining < kChunkBytes - carry) ? remaining : kChunkBytes - carry;
    const int got = gzread(f, buf + carry, static_cast<unsigned>(want));
    if (got <= 0) { gzclose(f); return -6; }  // truncated voxel stream
    remaining -= got;
    const int64_t have = carry + got;
    const int64_t usable = (have / esz) * esz;
    const int64_t done = convert_chunk(h.datatype, buf, usable, dst,
                                       h.scl_slope, h.scl_inter, scale);
    if (done < 0) { gzclose(f); return -4; }
    dst += done;
    carry = have - usable;
    if (carry > 0) std::memmove(buf, buf + usable, carry);
  }
  gzclose(f);
  return carry == 0 ? 0 : -6;
}

}  // extern "C"
