// Baseline JPEG decoder and encoder with no library, for the port's image
// pipeline (mxnet_tpu_torch/native.py binds it with ctypes).
//
// Decode: sequential 8-bit Huffman JPEG (SOF0/SOF1), 1 or 3 components at
// any integral sampling factors, restart intervals, byte stuffing, JFIF and
// Adobe APP14 colour transforms, sizes that are not a multiple of the MCU.
// It follows libjpeg's published algorithms so that its output matches a
// libjpeg-turbo decode with the default settings:
//   - the "islow" integer IDCT (jidctint.c), with its range-limit table;
//   - "fancy" triangle upsampling for 2x1, 1x2 and 2x2 chroma (jdsample.c
//     h2v1/h1v2/h2v2, with their rounding biases), box replication for
//     other ratios;
//   - the fixed-point YCbCr->RGB tables (jdcolor.c); a grayscale decode of
//     a YCbCr file is the Y plane, of an RGB file the rgb_gray formula.
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and CMYK
// files are refused with an error that names what is unsupported.
//
// Encode: baseline JPEG, Annex K tables scaled by the IJG quality formula,
// 4:2:0 for colour (libjpeg's default), libjpeg's islow forward DCT.
//
// C ABI only; every entry point returns 0 or a negative code, and
// mxc_last_error() describes the last failure of the calling thread.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrCorrupt = -1;
constexpr int kErrUnsupported = -2;
constexpr int kErrArgs = -3;
constexpr int kErrCrop = -4;
constexpr int kErrOom = -5;

thread_local char g_error[256];

int fail(int code, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(g_error, sizeof(g_error), fmt, ap);
  va_end(ap);
  return code;
}

// zigzag position -> natural (row-major) position; the 16 extra entries
// keep a corrupt run-length inside the block, as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// islow IDCT (jidctint.c) and its range limit
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// libjpeg's post-IDCT table: range_limit[x & 1023] = clamp(x + 128, 0, 255)
// for |x| < 512, wrapping beyond as libjpeg's masked lookup does
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;
      if (i >= 512 && i < 896) x = -1000;   // libjpeg's zero segment
      t[i] = static_cast<uint8_t>(std::min(std::max(x + 128, 0), 255));
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int32_t dc = (in[0] * static_cast<int32_t>(qp[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int32_t z2 = in[16] * static_cast<int32_t>(qp[16]);
    int32_t z3 = in[48] * static_cast<int32_t>(qp[48]);
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * static_cast<int32_t>(qp[0]);
    z3 = in[32] * static_cast<int32_t>(qp[32]);
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * static_cast<int32_t>(qp[56]);
    tmp1 = in[40] * static_cast<int32_t>(qp[40]);
    tmp2 = in[24] * static_cast<int32_t>(qp[24]);
    tmp3 = in[8] * static_cast<int32_t>(qp[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------------------------
// colour conversion tables (jdcolor.c)
// ---------------------------------------------------------------------------

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t fix(double x) {
  return static_cast<int32_t>(x * (1L << kScaleBits) + 0.5);
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  int32_t r_y[256], g_y[256], b_y[256];
  ColorTables() {
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kOneHalf) >> kScaleBits;
      cb_b[i] = (fix(1.77200) * x + kOneHalf) >> kScaleBits;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + kOneHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// Huffman decoding (jdhuff.c's derived tables with a 9-bit lookahead)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];   // (length << 8) | value, 0 = longer code

  bool build(const uint8_t* bits /* [17], bits[0] unused */) {
    uint8_t size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) {
        if (p >= 256) return false;
        size[p++] = static_cast<uint8_t>(l);
      }
    size[p] = 0;
    const int n = p;
    uint32_t c = 0;
    int si = n ? size[0] : 0;
    p = 0;
    while (p < n) {
      while (p < n && size[p] == si) code[p++] = c++;
      if (c > (1u << si)) return false;   // over-subscribed code lengths
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l)
      for (int i = 0; i < bits[l]; ++i, ++p) {
        uint32_t lb = code[p] << (kLookBits - l);
        for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
          look[lb + k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    defined = true;
    return true;
  }
};

// Entropy-coded-segment bit reader: byte stuffing, fill bytes, and zeros
// after a marker or the end of the data (libjpeg's behaviour on a short
// segment).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;    // next bits left-aligned
  int n = 0;
  int marker = 0;      // marker met in the data, 0 = none
  const uint8_t* marker_pos = nullptr;   // just after the marker

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (!marker && p < end) {
        b = *p++;
        if (b == 0xFF) {
          while (p < end && *p == 0xFF) ++p;
          if (p < end && *p == 0x00) {
            ++p;
          } else {
            marker = p < end ? *p : 0xD9;
            marker_pos = p < end ? p + 1 : end;
            b = 0;
          }
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  inline uint32_t bits(int k) {
    if (n < k) fill();
    uint32_t v = static_cast<uint32_t>(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  inline int decode(const HuffTable& t) {
    if (n < 16) fill();
    uint32_t e = t.look[acc >> (64 - kLookBits)];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      n -= l;
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(acc >> (64 - l));
      if (code <= t.maxcode[l]) {
        acc <<= l;
        n -= l;
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    acc <<= 16;   // bad code: libjpeg warns and decodes a zero
    n -= 16;
    return 0;
  }
  void reset() {
    acc = 0;
    n = 0;
  }
};

inline int extend(uint32_t v, int s) {
  return static_cast<int>(v) < (1 << (s - 1))
             ? static_cast<int>(v) - (1 << s) + 1
             : static_cast<int>(v);
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;            // downsampled width/height (real samples)
  int stride = 0, rows = 0;      // the padded sample plane
  int pred = 0;
  std::vector<uint8_t> plane;
  // block range whose IDCT is needed (crop): [bx0, bx1) x [by0, by1)
  int bx0 = 0, bx1 = 0, by0 = 0, by1 = 0;
};

enum ColorSpace { kGray, kYCbCr, kRGB };

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  mutable std::vector<int> colsum_;   // h2v2 column sums of one row

  Decoder(const uint8_t* buf, uint64_t len)
      : data(buf), end(buf + len), p(buf) {}

  int u16(const uint8_t* q) const { return (q[0] << 8) | q[1]; }

  // next marker code at p (skipping fill bytes and garbage), or 0 at end
  int next_marker() {
    while (p < end) {
      if (*p == 0xFF) {
        while (p < end && *p == 0xFF) ++p;
        if (p >= end) return 0;
        int m = *p++;
        if (m != 0) return m;
      } else {
        ++p;
      }
    }
    return 0;
  }

  int segment(const uint8_t** seg, int* len) {
    if (end - p < 2) return fail(kErrCorrupt, "truncated JPEG marker segment");
    int l = u16(p);
    if (l < 2 || end - p < l)
      return fail(kErrCorrupt, "truncated JPEG marker segment");
    *seg = p + 2;
    *len = l - 2;
    p += l;
    return kOk;
  }

  int sof(const uint8_t* s, int len) {
    if (len < 6) return fail(kErrCorrupt, "short SOF segment");
    if (s[0] != 8)
      return fail(kErrUnsupported,
                  "%d-bit JPEG samples are not supported (8-bit only)", s[0]);
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = s[5];
    if (height == 0)
      return fail(kErrUnsupported,
                  "JPEG with a DNL-defined height is not supported");
    if (width == 0) return fail(kErrCorrupt, "JPEG width 0");
    if (ncomp == 4)
      return fail(kErrUnsupported,
                  "4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      return fail(kErrUnsupported,
                  "%d-component JPEG is not supported (1 or 3 only)", ncomp);
    if (len < 6 + 3 * ncomp) return fail(kErrCorrupt, "short SOF segment");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return fail(kErrCorrupt, "bad JPEG component sampling/table");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        return fail(kErrUnsupported,
                    "non-integral JPEG sampling ratios are not supported");
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) /
                              hmax);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) /
                              vmax);
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
      c.bx0 = 0;
      c.by0 = 0;
      c.bx1 = mcux * c.h;
      c.by1 = mcuy * c.v;
    }
    frame = true;
    return kOk;
  }

  // parse markers up to (and including) the frame header
  int header() {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
      return fail(kErrCorrupt, "not a JPEG (no SOI marker)");
    p += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0 || m == 0xD9)
        return fail(kErrCorrupt, "JPEG ends before its frame header");
      int rc = marker(m);
      if (rc) return rc;
      if (frame) return kOk;
    }
  }

  int marker(int m) {
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return kOk;
    const uint8_t* s;
    int len;
    int rc = segment(&s, &len);
    if (rc) return rc;
    switch (m) {
      case 0xC0:
      case 0xC1:
        if (frame) return fail(kErrCorrupt, "JPEG with two frame headers");
        return sof(s, len);
      case 0xC2:
        return fail(kErrUnsupported,
                    "progressive JPEG (SOF2) is not supported");
      case 0xC3:
        return fail(kErrUnsupported, "lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        return fail(kErrUnsupported,
                    "hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return fail(kErrUnsupported,
                    "arithmetic-coded JPEG (SOF%d) is not supported",
                    m - 0xC0);
      case 0xCC:
        return fail(kErrUnsupported,
                    "arithmetic-coded JPEG (DAC) is not supported");
      case 0xC4:
        return dht(s, len);
      case 0xDB:
        return dqt(s, len);
      case 0xDD:
        if (len < 2) return fail(kErrCorrupt, "short DRI segment");
        restart_interval = u16(s);
        return kOk;
      case 0xE0:
        if (len >= 5 && !std::memcmp(s, "JFIF\0", 5)) jfif = true;
        return kOk;
      case 0xEE:
        if (len >= 12 && !std::memcmp(s, "Adobe", 5)) {
          adobe = true;
          adobe_transform = s[11];
        }
        return kOk;
      default:
        return kOk;   // APPn, COM, DNL, ...
    }
  }

  int dht(const uint8_t* s, int len) {
    while (len > 0) {
      if (len < 17) return fail(kErrCorrupt, "short DHT segment");
      int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) return fail(kErrCorrupt, "bad DHT table id");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = s[i];
        count += s[i];
      }
      if (count > 256 || len < 17 + count)
        return fail(kErrCorrupt, "bad DHT table");
      HuffTable& t = tc ? ac[th] : dc[th];
      std::memcpy(t.vals, s + 17, count);
      if (!t.build(bits)) return fail(kErrCorrupt, "bad Huffman table");
      s += 17 + count;
      len -= 17 + count;
    }
    return kOk;
  }

  int dqt(const uint8_t* s, int len) {
    while (len > 0) {
      int pq = s[0] >> 4, tq = s[0] & 15;
      if (tq > 3 || pq > 1) return fail(kErrCorrupt, "bad DQT table id");
      int need = 1 + 64 * (pq + 1);
      if (len < need) return fail(kErrCorrupt, "short DQT segment");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = static_cast<uint16_t>(
            pq ? u16(s + 1 + 2 * k) : s[1 + k]);
      qt_defined[tq] = true;
      s += need;
      len -= need;
    }
    return kOk;
  }

  ColorSpace color_space() const {
    if (ncomp == 1) return kGray;
    if (jfif) return kYCbCr;
    if (adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
      return kRGB;
    return kYCbCr;
  }

  // restrict the IDCT of component ci to the blocks that the output window
  // [x0, x0+w) x [y0, y0+h) reads, with one sample of upsampling context
  void crop_blocks(int ci, int x0, int y0, int w, int h) {
    Component& c = comp[ci];
    const int fh = hmax / c.h, fv = vmax / c.v;
    int sx0 = std::max(x0 / fh - 1, 0);
    int sx1 = std::min((x0 + w - 1) / fh + 1, c.dw - 1);
    int sy0 = std::max(y0 / fv - 1, 0);
    int sy1 = std::min((y0 + h - 1) / fv + 1, c.dh - 1);
    c.bx0 = sx0 / 8;
    c.bx1 = sx1 / 8 + 1;
    c.by0 = sy0 / 8;
    c.by1 = sy1 / 8 + 1;
  }

  void skip_component(int ci) {
    Component& c = comp[ci];
    c.bx0 = c.bx1 = c.by0 = c.by1 = 0;
  }

  inline void block(BitReader& br, Component& c, int bx, int by) {
    alignas(16) int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const HuffTable& d = dc[c.td];
    const HuffTable& a = ac[c.ta];
    int s = br.decode(d);
    int diff = s ? extend(br.bits(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(a);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    if (bx >= c.bx0 && bx < c.bx1 && by >= c.by0 && by < c.by1)
      idct_islow(coef, qt[c.tq],
                 c.plane.data() + static_cast<size_t>(by) * 8 * c.stride +
                     bx * 8,
                 c.stride);
  }

  void restart(BitReader& br, Component** sc, int ns) {
    br.reset();
    if (!br.marker) {
      // find the marker that should follow
      const uint8_t* q = br.p;
      while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF)) ++q;
      if (q + 1 < end) {
        br.marker = q[1];
        br.marker_pos = q + 2;
      }
    }
    if (br.marker >= 0xD0 && br.marker <= 0xD7) {
      br.p = br.marker_pos;
      br.marker = 0;
    }
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
  }

  int scan(const uint8_t* s, int len) {
    if (!frame) return fail(kErrCorrupt, "JPEG scan before its frame header");
    if (len < 1) return fail(kErrCorrupt, "short SOS segment");
    int ns = s[0];
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns)
      return fail(kErrCorrupt, "bad SOS segment");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i], t = s[2 + 2 * i];
      Component* c = nullptr;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == id) c = &comp[k];
      if (!c) return fail(kErrCorrupt, "SOS names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined)
        return fail(kErrCorrupt, "JPEG scan uses an undefined Huffman table");
      if (!qt_defined[c->tq])
        return fail(kErrCorrupt, "JPEG uses an undefined quantization table");
      c->pred = 0;
      sc[i] = c;
    }
    for (int i = 0; i < ns; ++i)
      if (sc[i]->plane.empty())
        sc[i]->plane.assign(static_cast<size_t>(sc[i]->stride) * sc[i]->rows,
                            0);
    BitReader br;
    br.p = p;
    br.end = end;
    int mcus = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      const int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          if (restart_interval && mcus && mcus % restart_interval == 0)
            restart(br, sc, ns);
          block(br, c, bx, by);
          ++mcus;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && mcus && mcus % restart_interval == 0)
            restart(br, sc, ns);
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                block(br, c, mx * c.h + h, my * c.v + v);
          }
          ++mcus;
        }
    }
    // resume marker parsing where the entropy-coded data stopped
    if (br.marker) {
      p = br.marker_pos - 2;
    } else {
      p = br.p;
    }
    return kOk;
  }

  // decode every scan; components with an empty block range skip the IDCT
  int body() {
    for (;;) {
      int m = next_marker();
      if (m == 0 || m == 0xD9) break;   // EOI (or a truncated file)
      if (m == 0xDA) {
        const uint8_t* s;
        int len;
        int rc = segment(&s, &len);
        if (rc) return rc;
        rc = scan(s, len);
        if (rc) return rc;
        continue;
      }
      int rc = marker(m);
      if (rc) return rc;
    }
    for (int i = 0; i < ncomp; ++i)
      if (comp[i].plane.empty() && comp[i].bx1 > comp[i].bx0)
        return fail(kErrCorrupt, "JPEG has no scan for component %d", i);
    return kOk;
  }

  // upsampled row Y of component c over output columns [x0, x0 + w)
  void row(const Component& c, int Y, int x0, int w, uint8_t* out) const {
    const int fh = hmax / c.h, fv = vmax / c.v;
    auto line = [&](int y) {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
      return c.plane.data() + static_cast<size_t>(y) * c.stride;
    };
    if (fh == 1 && fv == 1) {
      std::memcpy(out, line(Y) + x0, w);
      return;
    }
    const int last = c.dw - 1;
    if (fh == 2 && fv == 1 && c.dw > 2) {   // h2v1_fancy_upsample
      const uint8_t* in = line(Y);
      for (int i = 0; i < w; ++i) {
        const int X = x0 + i, j = X >> 1, s = in[j];
        if (X & 1)
          out[i] = static_cast<uint8_t>(
              j == last ? s : (s * 3 + in[j + 1] + 2) >> 2);
        else
          out[i] = static_cast<uint8_t>(
              j == 0 ? s : (s * 3 + in[j - 1] + 1) >> 2);
      }
      return;
    }
    if (fh == 1 && fv == 2) {                // h1v2_fancy_upsample
      const uint8_t* near = line(Y >> 1);
      const uint8_t* far = line((Y & 1) ? (Y >> 1) + 1 : (Y >> 1) - 1);
      const int bias = (Y & 1) ? 2 : 1;
      for (int i = 0; i < w; ++i)
        out[i] = static_cast<uint8_t>(
            (near[x0 + i] * 3 + far[x0 + i] + bias) >> 2);
      return;
    }
    if (fh == 2 && fv == 2 && c.dw > 2) {    // h2v2_fancy_upsample
      const uint8_t* near = line(Y >> 1);
      const uint8_t* far = line((Y & 1) ? (Y >> 1) + 1 : (Y >> 1) - 1);
      // column sums 3 near + far over [a, b], the columns the window reads
      const int a = std::max((x0 >> 1) - 1, 0);
      const int b = std::min(((x0 + w - 1) >> 1) + 1, last);
      colsum_.resize(b - a + 1);
      int* cs = colsum_.data() - a;
      for (int j = a; j <= b; ++j) cs[j] = near[j] * 3 + far[j];
      for (int i = 0; i < w; ++i) {
        const int X = x0 + i, j = X >> 1, t = cs[j];
        if (X & 1)
          out[i] = static_cast<uint8_t>(
              j == last ? (t * 4 + 7) >> 4 : (t * 3 + cs[j + 1] + 7) >> 4);
        else
          out[i] = static_cast<uint8_t>(
              j == 0 ? (t * 4 + 8) >> 4 : (t * 3 + cs[j - 1] + 8) >> 4);
      }
      return;
    }
    const uint8_t* in = line(Y / fv);        // box replication
    for (int i = 0; i < w; ++i)
      out[i] = in[std::min((x0 + i) / fh, last)];
  }

  // call fn(y_index, r, g, b rows) for every output row of the window
  template <typename Fn>
  void rgb_rows(int x0, int y0, int w, int h, Fn fn) const {
    std::vector<uint8_t> buf(static_cast<size_t>(w) * 6);
    uint8_t* r = buf.data();
    uint8_t* g = r + w;
    uint8_t* b = g + w;
    uint8_t* c0 = b + w;
    uint8_t* c1 = c0 + w;
    uint8_t* c2 = c1 + w;
    const ColorSpace cs = color_space();
    for (int y = 0; y < h; ++y) {
      const int Y = y0 + y;
      if (cs == kGray) {
        row(comp[0], Y, x0, w, r);
        fn(y, r, r, r);
        continue;
      }
      row(comp[0], Y, x0, w, c0);
      row(comp[1], Y, x0, w, c1);
      row(comp[2], Y, x0, w, c2);
      if (cs == kRGB) {
        fn(y, c0, c1, c2);
        continue;
      }
      for (int i = 0; i < w; ++i) {
        int yy = c0[i], cb = c1[i], cr = c2[i];
        r[i] = clamp255(yy + kColor.cr_r[cr]);
        g[i] = clamp255(yy + static_cast<int>((kColor.cb_g[cb] +
                                                kColor.cr_g[cr]) >>
                                               kScaleBits));
        b[i] = clamp255(yy + kColor.cb_b[cb]);
      }
      fn(y, r, g, b);
    }
  }
};

// ---------------------------------------------------------------------------
// the encoder (jcparam.c tables, jfdctint.c forward DCT, jchuff.c coding)
// ---------------------------------------------------------------------------

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        code[vals[p]] = static_cast<uint16_t>(c++);
        size[vals[p]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int k) {
    acc = (acc << k) | (v & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  void flush() {
    if (n > 0) put(0x7F, 7);   // pad with 1 bits, as libjpeg does
    n = 0;
    acc = 0;
  }
};

void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int k = 0; k < 8; ++k) {
      int32_t* x = d + k * next;
      int32_t tmp0 = x[0] + x[7 * step], tmp7 = x[0] - x[7 * step];
      int32_t tmp1 = x[step] + x[6 * step], tmp6 = x[step] - x[6 * step];
      int32_t tmp2 = x[2 * step] + x[5 * step];
      int32_t tmp5 = x[2 * step] - x[5 * step];
      int32_t tmp3 = x[3 * step] + x[4 * step];
      int32_t tmp4 = x[3 * step] - x[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        x[0] = descale(tmp10 + tmp11, kPass1Bits);
        x[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      } else {
        x[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        x[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      x[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, sh);
      x[6 * step] = descale(z1 + tmp12 * (-FIX_1_847759065), sh);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      x[7 * step] = descale(tmp4 + z1 + z3, sh);
      x[5 * step] = descale(tmp5 + z2 + z4, sh);
      x[3 * step] = descale(tmp6 + z2 + z3, sh);
      x[step] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

int nbits(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

struct Encoder {
  int w, h, nc;
  uint16_t q[2][64];   // natural order
  EncTable dc[2], ac[2];
  std::vector<uint8_t> out;

  void scale_tables(int quality) {
    quality = std::min(std::max(quality, 1), 100);
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
      long a = (static_cast<long>(kStdLumaQ[i]) * scale + 50) / 100;
      long b = (static_cast<long>(kStdChromaQ[i]) * scale + 50) / 100;
      q[0][i] = static_cast<uint16_t>(std::min(std::max(a, 1L), 255L));
      q[1][i] = static_cast<uint16_t>(std::min(std::max(b, 1L), 255L));
    }
  }

  void u16(int v) {
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v & 255));
  }

  void headers() {
    const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F',
                                'I',  'F',  0,    1,    1, 0,  0,   1,
                                0,    1,    0,    0};
    out.insert(out.end(), soi_app0, soi_app0 + sizeof(soi_app0));
    for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
      out.push_back(0xFF);
      out.push_back(0xDB);
      u16(67);
      out.push_back(static_cast<uint8_t>(t));
      for (int k = 0; k < 64; ++k)
        out.push_back(static_cast<uint8_t>(q[t][kNatural[k]]));
    }
    out.push_back(0xFF);
    out.push_back(0xC0);
    u16(8 + 3 * nc);
    out.push_back(8);
    u16(h);
    u16(w);
    out.push_back(static_cast<uint8_t>(nc));
    for (int i = 0; i < nc; ++i) {
      out.push_back(static_cast<uint8_t>(i + 1));
      out.push_back(nc == 3 && i == 0 ? 0x22 : 0x11);
      out.push_back(i == 0 ? 0 : 1);
    }
    struct {
      int cls, id;
      const uint8_t *bits, *vals;
    } tabs[4] = {{0, 0, kDcLumaBits, kDcVals},
                 {1, 0, kAcLumaBits, kAcLumaVals},
                 {0, 1, kDcChromaBits, kDcVals},
                 {1, 1, kAcChromaBits, kAcChromaVals}};
    for (int t = 0; t < (nc == 3 ? 4 : 2); ++t) {
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += tabs[t].bits[l];
      out.push_back(0xFF);
      out.push_back(0xC4);
      u16(2 + 1 + 16 + count);
      out.push_back(static_cast<uint8_t>((tabs[t].cls << 4) | tabs[t].id));
      out.insert(out.end(), tabs[t].bits + 1, tabs[t].bits + 17);
      out.insert(out.end(), tabs[t].vals, tabs[t].vals + count);
    }
    dc[0].build(kDcLumaBits, kDcVals);
    ac[0].build(kAcLumaBits, kAcLumaVals);
    dc[1].build(kDcChromaBits, kDcVals);
    ac[1].build(kAcChromaBits, kAcChromaVals);
    out.push_back(0xFF);
    out.push_back(0xDA);
    u16(6 + 2 * nc);
    out.push_back(static_cast<uint8_t>(nc));
    for (int i = 0; i < nc; ++i) {
      out.push_back(static_cast<uint8_t>(i + 1));
      out.push_back(i == 0 ? 0x00 : 0x11);
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);
  }

  // one 8x8 block of samples (row stride `stride`) -> Huffman bits
  void block(BitWriter& bw, const uint8_t* px, int stride, int t, int* pred) {
    int32_t d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) d[y * 8 + x] = px[y * stride + x] - 128;
    fdct_islow(d);
    int coef[64];
    for (int i = 0; i < 64; ++i) {
      int32_t div = q[t][i] * 8;
      int32_t v = d[i];
      if (v < 0) {
        v = (-v + (div >> 1)) / div;
        v = -v;
      } else {
        v = (v + (div >> 1)) / div;
      }
      coef[i] = v;
    }
    int diff = coef[0] - *pred;
    *pred = coef[0];
    int s = nbits(diff);
    bw.put(dc[t].code[s], dc[t].size[s]);
    if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = coef[kNatural[k]];
      if (!v) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
        run -= 16;
      }
      s = nbits(v);
      int rs = (run << 4) | s;
      bw.put(ac[t].code[rs], ac[t].size[rs]);
      bw.put(v < 0 ? v - 1 : v, s);
      run = 0;
    }
    if (run) bw.put(ac[t].code[0], ac[t].size[0]);
  }
};

}  // namespace

extern "C" {

const char* mxc_last_error() { return g_error; }

void mxc_free(void* p) { std::free(p); }

// Width, height and component count from the JPEG header.
int mxc_jpeg_info(const uint8_t* buf, uint64_t len, int* w, int* h,
                  int* ncomp) {
  if (!buf || !w || !h || !ncomp) return fail(kErrArgs, "null argument");
  Decoder d(buf, len);
  int rc = d.header();
  if (rc) return rc;
  *w = d.width;
  *h = d.height;
  *ncomp = d.ncomp;
  return kOk;
}

// Full decode into out (HWC uint8): mode 0 = one channel (the Y plane of a
// YCbCr file, rgb_gray of an RGB file), 1 = RGB, 2 = BGR.  out holds
// width * height * (mode ? 3 : 1) bytes.
int mxc_jpeg_decode(const uint8_t* buf, uint64_t len, int mode, uint8_t* out,
                    uint64_t cap) {
  if (!buf || !out || mode < 0 || mode > 2)
    return fail(kErrArgs, "bad argument");
  Decoder d(buf, len);
  int rc = d.header();
  if (rc) return rc;
  const int W = d.width, H = d.height;
  const int ch = mode ? 3 : 1;
  if (cap < static_cast<uint64_t>(W) * H * ch)
    return fail(kErrArgs, "output buffer too small");
  const ColorSpace cs = d.color_space();
  const bool y_only = mode == 0 && cs != kRGB;
  if (y_only)
    for (int i = 1; i < d.ncomp; ++i) d.skip_component(i);
  rc = d.body();
  if (rc) return rc;
  if (y_only) {
    std::vector<uint8_t> r(W);
    for (int y = 0; y < H; ++y) {
      d.row(d.comp[0], y, 0, W, r.data());
      std::memcpy(out + static_cast<size_t>(y) * W, r.data(), W);
    }
    return kOk;
  }
  d.rgb_rows(0, 0, W, H, [&](int y, const uint8_t* r, const uint8_t* g,
                             const uint8_t* b) {
    uint8_t* o = out + static_cast<size_t>(y) * W * ch;
    if (mode == 0) {
      for (int x = 0; x < W; ++x)
        o[x] = static_cast<uint8_t>(
            (kColor.r_y[r[x]] + kColor.g_y[g[x]] + kColor.b_y[b[x]]) >>
            kScaleBits);
      return;
    }
    const uint8_t* c0 = mode == 1 ? r : b;
    const uint8_t* c2 = mode == 1 ? b : r;
    for (int x = 0; x < W; ++x) {
      o[3 * x] = c0[x];
      o[3 * x + 1] = g[x];
      o[3 * x + 2] = c2[x];
    }
  });
  return kOk;
}

// Decode the crop [crop_x, crop_x + crop_w) x [crop_y, crop_y + crop_h)
// (crop_x/crop_y < 0: centred; clamped into the image), mirror it
// horizontally if asked, and write (rgb - mean) * std_inv as float32 CHW
// into out.  Blocks wholly outside the crop (and its upsampling context)
// skip the IDCT; the result is that of a full decode.
int mxc_jpeg_decode_crop_norm(const uint8_t* buf, uint64_t len, int crop_w,
                              int crop_h, int crop_x, int crop_y, int mirror,
                              const float* mean, const float* std_inv,
                              float* out) {
  if (!buf || !out || !mean || !std_inv || crop_w <= 0 || crop_h <= 0)
    return fail(kErrArgs, "bad argument");
  Decoder d(buf, len);
  int rc = d.header();
  if (rc) return rc;
  const int W = d.width, H = d.height;
  if (W < crop_w || H < crop_h)
    return fail(kErrCrop, "JPEG %dx%d is smaller than the crop %dx%d", W, H,
                crop_w, crop_h);
  int x0 = crop_x >= 0 ? crop_x : (W - crop_w) / 2;
  int y0 = crop_y >= 0 ? crop_y : (H - crop_h) / 2;
  x0 = std::min(std::max(x0, 0), W - crop_w);
  y0 = std::min(std::max(y0, 0), H - crop_h);
  for (int i = 0; i < d.ncomp; ++i) d.crop_blocks(i, x0, y0, crop_w, crop_h);
  rc = d.body();
  if (rc) return rc;
  const size_t plane = static_cast<size_t>(crop_w) * crop_h;
  d.rgb_rows(x0, y0, crop_w, crop_h, [&](int y, const uint8_t* r,
                                         const uint8_t* g,
                                         const uint8_t* b) {
    float* ro = out + static_cast<size_t>(y) * crop_w;
    float* go = ro + plane;
    float* bo = go + plane;
    for (int x = 0; x < crop_w; ++x) {
      const int s = mirror ? crop_w - 1 - x : x;
      ro[x] = (r[s] - mean[0]) * std_inv[0];
      go[x] = (g[s] - mean[1]) * std_inv[1];
      bo[x] = (b[s] - mean[2]) * std_inv[2];
    }
  });
  return kOk;
}

// Encode HWC uint8 pixels (channels 1, or 3 in RGB order, or BGR when bgr
// is set) as a baseline JPEG at the IJG quality; *out is malloc'd (free it
// with mxc_free).
int mxc_jpeg_encode(const uint8_t* px, int w, int h, int channels, int bgr,
                    int quality, uint8_t** out, uint64_t* out_len) {
  if (!px || !out || !out_len || w <= 0 || h <= 0 || w > 65535 ||
      h > 65535 || (channels != 1 && channels != 3))
    return fail(kErrArgs, "bad argument");
  Encoder e;
  e.w = w;
  e.h = h;
  e.nc = channels;
  e.scale_tables(quality);
  e.headers();
  BitWriter bw(e.out);
  int pred[3] = {0, 0, 0};
  if (channels == 1) {
    const int pw = (w + 7) / 8 * 8, ph = (h + 7) / 8 * 8;
    std::vector<uint8_t> g(static_cast<size_t>(pw) * ph);
    for (int y = 0; y < ph; ++y)
      for (int x = 0; x < pw; ++x)
        g[static_cast<size_t>(y) * pw + x] =
            px[static_cast<size_t>(std::min(y, h - 1)) * w + std::min(x, w - 1)];
    for (int by = 0; by < ph; by += 8)
      for (int bx = 0; bx < pw; bx += 8)
        e.block(bw, g.data() + static_cast<size_t>(by) * pw + bx, pw, 0,
                pred);
  } else {
    // 4:2:0: Y at full size padded to 16, Cb/Cr downsampled 2x2 with
    // libjpeg's alternating 1, 2 bias (h2v2_downsample)
    const int pw = (w + 15) / 16 * 16, ph = (h + 15) / 16 * 16;
    std::vector<uint8_t> Y(static_cast<size_t>(pw) * ph),
        Cb(static_cast<size_t>(pw) * ph), Cr(static_cast<size_t>(pw) * ph);
    const int32_t off = 128 << kScaleBits;
    for (int y = 0; y < ph; ++y)
      for (int x = 0; x < pw; ++x) {
        const uint8_t* s = px + (static_cast<size_t>(std::min(y, h - 1)) * w +
                                 std::min(x, w - 1)) * 3;
        int32_t r = bgr ? s[2] : s[0], g = s[1], b = bgr ? s[0] : s[2];
        size_t i = static_cast<size_t>(y) * pw + x;
        Y[i] = static_cast<uint8_t>(
            (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b +
             kOneHalf) >> kScaleBits);
        Cb[i] = static_cast<uint8_t>(
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off +
             kOneHalf - 1) >> kScaleBits);
        Cr[i] = static_cast<uint8_t>(
            (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off +
             kOneHalf - 1) >> kScaleBits);
      }
    const int cw = pw / 2, chh = ph / 2;
    std::vector<uint8_t> cb(static_cast<size_t>(cw) * chh),
        cr(static_cast<size_t>(cw) * chh);
    for (int y = 0; y < chh; ++y) {
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        size_t i0 = static_cast<size_t>(2 * y) * pw + 2 * x, i1 = i0 + pw;
        cb[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (Cb[i0] + Cb[i0 + 1] + Cb[i1] + Cb[i1 + 1] + bias) >> 2);
        cr[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (Cr[i0] + Cr[i0 + 1] + Cr[i1] + Cr[i1 + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int my = 0; my < ph / 16; ++my)
      for (int mx = 0; mx < pw / 16; ++mx) {
        for (int v = 0; v < 2; ++v)
          for (int u = 0; u < 2; ++u)
            e.block(bw,
                    Y.data() + static_cast<size_t>(my * 16 + v * 8) * pw +
                        mx * 16 + u * 8,
                    pw, 0, &pred[0]);
        e.block(bw, cb.data() + static_cast<size_t>(my * 8) * cw + mx * 8,
                cw, 1, &pred[1]);
        e.block(bw, cr.data() + static_cast<size_t>(my * 8) * cw + mx * 8,
                cw, 1, &pred[2]);
      }
  }
  bw.flush();
  e.out.push_back(0xFF);
  e.out.push_back(0xD9);
  uint8_t* mem = static_cast<uint8_t*>(std::malloc(e.out.size()));
  if (!mem) return fail(kErrOom, "out of memory");
  std::memcpy(mem, e.out.data(), e.out.size());
  *out = mem;
  *out_len = e.out.size();
  return kOk;
}

}  // extern "C"
