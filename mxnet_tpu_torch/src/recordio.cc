// Native RecordIO scanner/bulk reader (the reference keeps this hot path in
// C++: dmlc-core recordio + src/io/iter_image_recordio_2.cc).  Exposed as a
// tiny C ABI consumed via ctypes (mxnet_tpu_torch/native.py) — no pybind11 in the
// build environment, and a C ABI keeps the boundary language-portable like
// the reference's C API seam.
//
// Format (byte-compatible with dmlc recordio / mxnet_tpu_torch/recordio.py):
//   [magic u32 = 0xced7230a][lrec u32 = cflag<<29 | length][payload][pad to 4]
// cflag != 0 marks split continuation records (dmlc multi-chunk records);
// this scanner handles cflag==0 whole records (what im2rec/MXRecordIO emit)
// and reports a distinct error if it meets a split record.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {
constexpr uint32_t kMagic = 0xced7230au;
constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrSplitRecord = -3;
constexpr int kErrIo = -4;
constexpr int kErrCapacity = -5;
constexpr int kErrOom = -6;

struct File {
  FILE* f;
  explicit File(const char* path, const char* mode)
      : f(std::fopen(path, mode)) {}
  ~File() { if (f) std::fclose(f); }
};
}  // namespace

extern "C" {

// Scan the whole file; on success *offsets/*lengths are malloc'd arrays of
// *count payload positions/sizes.  Caller frees both with rio_free.
int rio_index(const char* path, uint64_t** offsets, uint64_t** lengths,
              uint64_t* count) {
  File fp(path, "rb");
  if (!fp.f) return kErrOpen;
  // file size up front: fseek happily lands past EOF, so a truncated
  // trailing payload would otherwise be indexed at its full claimed
  // length and misread as a clean end on the next fread
  if (std::fseek(fp.f, 0, SEEK_END) != 0) return kErrIo;
  const uint64_t fsize = static_cast<uint64_t>(std::ftell(fp.f));
  if (std::fseek(fp.f, 0, SEEK_SET) != 0) return kErrIo;
  std::vector<uint64_t> offs, lens;
  uint64_t pos = 0;
  for (;;) {
    uint32_t head[2];
    size_t got = std::fread(head, sizeof(uint32_t), 2, fp.f);
    if (got == 0) break;              // clean EOF
    if (got != 2) return kErrFormat;  // truncated header
    if (head[0] != kMagic) return kErrFormat;
    uint32_t cflag = head[1] >> 29;
    uint64_t len = head[1] & ((1u << 29) - 1);
    if (cflag != 0) return kErrSplitRecord;
    pos += 8;
    uint64_t skip = len + ((4 - len % 4) % 4);
    if (pos + len > fsize) return kErrFormat;  // truncated payload
    offs.push_back(pos);
    lens.push_back(len);
    if (std::fseek(fp.f, static_cast<long>(skip), SEEK_CUR) != 0)
      return kErrIo;
    pos += skip;
  }
  *count = offs.size();
  *offsets = static_cast<uint64_t*>(std::malloc(offs.size() * 8));
  *lengths = static_cast<uint64_t*>(std::malloc(lens.size() * 8));
  if ((offs.size() && !*offsets) || (lens.size() && !*lengths)) {
    std::free(*offsets);  // free(nullptr) is a no-op
    std::free(*lengths);
    *offsets = *lengths = nullptr;
    return kErrOom;
  }
  std::memcpy(*offsets, offs.data(), offs.size() * 8);
  std::memcpy(*lengths, lens.data(), lens.size() * 8);
  return kOk;
}

// Read n records (given payload offsets/lengths) back-to-back into out
// (capacity out_cap bytes).  Total bytes written returned via *written.
int rio_read_batch(const char* path, const uint64_t* offsets,
                   const uint64_t* lengths, uint64_t n, uint8_t* out,
                   uint64_t out_cap, uint64_t* written) {
  File fp(path, "rb");
  if (!fp.f) return kErrOpen;
  uint64_t w = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (w + lengths[i] > out_cap) return kErrCapacity;
    if (std::fseek(fp.f, static_cast<long>(offsets[i]), SEEK_SET) != 0)
      return kErrIo;
    if (std::fread(out + w, 1, lengths[i], fp.f) != lengths[i])
      return kErrIo;
    w += lengths[i];
  }
  *written = w;
  return kOk;
}

void rio_free(void* p) { std::free(p); }

}  // extern "C"
