// Host-side hot loops of the port's input pipeline, with a plain C interface
// for ctypes (built by ops/_build.py with the system's C++ compiler).
//
//   udal_crc32c        CRC32C (Castagnoli) of a buffer, 8 bytes a step
//                      (the TFRecord framing's checksum).
//   udal_png_unfilter  PNG scanline reconstruction: filter types 0-4 (None,
//                      Sub, Up, Average, Paeth) of a decompressed stream.
//   udal_jpeg_scan     the entropy-coded segment of one baseline JPEG scan
//                      (sequential, Huffman): DC prediction, restart
//                      markers, byte stuffing; quantised coefficients out,
//                      de-zigzagged, one int16[64] a block.
//   udal_jpeg_idct     libjpeg's islow integer IDCT (6b's constants and
//                      rounding) of dequantised blocks, with its range limit.
//   udal_jpeg_ycc_rgb  libjpeg's fixed-point YCbCr -> RGB tables.
//
// Each has a numpy / Python twin in data/tfrecord.py and data/image_codec.py
// that the tests hold it against.

#include <cstdint>
#include <cstring>

namespace {

uint32_t kCrcTable[8][256];

void CrcInit() {
  const uint32_t poly = 0x82f63b78u;  // reflected CRC32C polynomial
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? poly ^ (c >> 1) : c >> 1;
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = kCrcTable[0][i];
    for (int t = 1; t < 8; t++) {
      c = kCrcTable[0][c & 0xff] ^ (c >> 8);
      kCrcTable[t][i] = c;
    }
  }
}

struct CrcInitOnLoad {
  CrcInitOnLoad() { CrcInit(); }
} crc_init_on_load;  // filled once when the library loads, before any thread calls in

const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

// One Huffman table: a 9-bit lookahead for short codes, then the canonical
// maxcode / valoffset walk (JPEG spec F.2.2.3) for the longer ones.
struct Huff {
  uint16_t look[1 << kLookBits];  // (length << 8) | value; length 0: longer code
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// False for a table that libjpeg refuses as a bogus Huffman table: more
// than 256 codes, a length whose codes overflow it (an over-subscribed table,
// or one with an all-ones code), or a DC table with a size above 15.
bool BuildHuff(const uint8_t* bits, const uint8_t* vals, bool dc, Huff* h) {
  int nvals = 0;
  int32_t code = 0;
  for (int l = 1; l <= 16; l++) {
    nvals += bits[l - 1];
    code += bits[l - 1];
    if (code >= (1 << l)) return false;
    code <<= 1;
  }
  if (nvals > 256) return false;
  for (int i = 0; dc && i < nvals; i++)
    if (vals[i] > 15) return false;
  memcpy(h->vals, vals, 256);
  memset(h->look, 0, sizeof(h->look));
  code = 0;
  int k = 0;
  for (int l = 1; l <= 16; l++) {
    int n = bits[l - 1];
    if (n) {
      h->valoffset[l] = k - code;
      for (int i = 0; i < n; i++, k++, code++) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); j++)
            h->look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      h->maxcode[l] = code - 1;
    } else {
      h->maxcode[l] = -1;
      h->valoffset[l] = 0;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;  // sentinel: no code is longer than 16 bits
  return true;
}

// MSB-first bit reader over the entropy-coded segment. It never reads past
// a marker (0xFF followed by anything but 0x00): past one it shifts in
// zeros, as libjpeg does at a premature end of data.
struct Bits {
  const uint8_t* d;
  int64_t len;
  int64_t pos;
  uint64_t buf;
  int nbits;
  bool at_marker;

  void Fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos < len) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 < len && d[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      buf |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t Peek(int n) {
    if (nbits < n) Fill();
    return (uint32_t)(buf >> (64 - n));
  }
  void Skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  uint32_t Get(int n) {
    if (n == 0) return 0;
    uint32_t v = Peek(n);
    Skip(n);
    return v;
  }
};

int Decode(Bits* br, const Huff* h) {
  uint32_t look = br->Peek(kLookBits);
  uint16_t e = h->look[look];
  if (e >> 8) {
    br->Skip(e >> 8);
    return e & 0xff;
  }
  uint32_t code = br->Peek(16);
  for (int l = kLookBits + 1; l <= 16; l++) {
    int32_t c = (int32_t)(code >> (16 - l));
    if (c <= h->maxcode[l]) {
      br->Skip(l);
      return h->vals[(h->valoffset[l] + c) & 0xff];
    }
  }
  return -1;  // no code of 16 bits or fewer matches: corrupt data
}

inline int Extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

// One islow pass over 8 values in[0], in[stride], ... ; out likewise.
inline void IslowPass(const int64_t* in, int64_t stride, int64_t* out, int64_t ostride,
                      int shift) {
  int64_t z2 = in[2 * stride], z3 = in[6 * stride];
  int64_t z1 = (z2 + z3) * 4433;
  int64_t tmp2 = z1 + z3 * -15137;
  int64_t tmp3 = z1 + z2 * 6270;
  int64_t tmp0 = (in[0] + in[4 * stride]) * (1 << kConstBits);
  int64_t tmp1 = (in[0] - in[4 * stride]) * (1 << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7 * stride];
  tmp1 = in[5 * stride];
  tmp2 = in[3 * stride];
  tmp3 = in[1 * stride];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * 9633;
  tmp0 *= 2446;
  tmp1 *= 16819;
  tmp2 *= 25172;
  tmp3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  const int64_t r = (int64_t)1 << (shift - 1);
  out[0] = (tmp10 + tmp3 + r) >> shift;
  out[7 * ostride] = (tmp10 - tmp3 + r) >> shift;
  out[1 * ostride] = (tmp11 + tmp2 + r) >> shift;
  out[6 * ostride] = (tmp11 - tmp2 + r) >> shift;
  out[2 * ostride] = (tmp12 + tmp1 + r) >> shift;
  out[5 * ostride] = (tmp12 - tmp1 + r) >> shift;
  out[3 * ostride] = (tmp13 + tmp0 + r) >> shift;
  out[4 * ostride] = (tmp13 - tmp0 + r) >> shift;
}

inline uint8_t Clamp255(int64_t v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

}  // namespace

extern "C" {

uint32_t udal_crc32c(const uint8_t* data, int64_t n) {
  uint32_t crc = 0xffffffffu;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    word ^= crc;
    crc = kCrcTable[7][word & 0xff] ^ kCrcTable[6][(word >> 8) & 0xff] ^
          kCrcTable[5][(word >> 16) & 0xff] ^ kCrcTable[4][(word >> 24) & 0xff] ^
          kCrcTable[3][(word >> 32) & 0xff] ^ kCrcTable[2][(word >> 40) & 0xff] ^
          kCrcTable[1][(word >> 48) & 0xff] ^ kCrcTable[0][(word >> 56) & 0xff];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = kCrcTable[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xffffffffu;
}

// raw: height rows of (1 filter byte + row_bytes); out: height * row_bytes.
// bpp: bytes a pixel (the filters' left neighbour distance). Returns 0, or
// -1 - row for an unknown filter type.
int udal_png_unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes, int bpp,
                      uint8_t* out) {
  for (int64_t y = 0; y < height; y++) {
    const uint8_t* src = raw + y * (row_bytes + 1);
    uint8_t ft = *src++;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* prev = y ? cur - row_bytes : nullptr;
    switch (ft) {
      case 0:
        memcpy(cur, src, row_bytes);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; i++)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; i++)
          cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; i++) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return (int)(-1 - y);
    }
  }
  return 0;
}

// One baseline scan. data[pos:] is the first byte after the SOS header.
//   comps: ncomp rows of 8 int32: h, v, dc table, ac table, block columns
//     and rows of the coefficient array, and the blocks a row / column the
//     component has (ceil of its size / 8; used when ncomp == 1);
//   coefs: ncomp pointers to int16 [rows][cols][64];
//   tables: 8 tables (DC 0-3, AC 0-3) of 16 code counts + 256 values;
//   mcux, mcuy: MCUs a row / column of an interleaved scan;
//   restart: the restart interval in MCUs (0: none).
// Returns the byte offset where the scan's data ends (at or before the
// marker that follows it), or -1 (bad code), -2 (bad restart marker), -3
// (bad Huffman table, or a bad component count or table index).
int64_t udal_jpeg_scan(const uint8_t* data, int64_t len, int64_t pos, int ncomp,
                       const int32_t* comps, int16_t** coefs, const uint8_t* tables,
                       int mcux, int mcuy, int restart) {
  static thread_local Huff huff[8];
  if (ncomp < 1 || ncomp > 4) return -3;
  for (int c = 0; c < ncomp; c++) {
    for (int which = 0; which < 2; which++) {
      int idx = comps[c * 8 + 2 + which];
      if (idx < 0 || idx > 3) return -3;
      int t = 4 * which + idx;
      const uint8_t* tab = tables + t * (16 + 256);
      if (!BuildHuff(tab, tab + 16, which == 0, &huff[t])) return -3;
    }
  }
  Bits br{data, len, pos, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  int64_t total, per_row;
  if (ncomp == 1) {
    per_row = comps[6];
    total = (int64_t)comps[6] * comps[7];
  } else {
    per_row = mcux;
    total = (int64_t)mcux * mcuy;
  }
  int64_t todo = restart;
  for (int64_t m = 0; m < total; m++) {
    if (restart && todo == 0) {
      // byte-align, expect RSTn at the stop position, skip it
      br.buf = 0;
      br.nbits = 0;
      int64_t p = br.pos;
      while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7))
        p++;
      if (p + 1 >= len) return -2;
      br.pos = p + 2;
      br.at_marker = false;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      todo = restart;
    }
    int64_t my = m / per_row, mx = m % per_row;
    for (int c = 0; c < ncomp; c++) {
      const int32_t* ci = comps + c * 8;
      int h = ncomp == 1 ? 1 : ci[0], v = ncomp == 1 ? 1 : ci[1];
      const Huff* dc = &huff[ci[2]];
      const Huff* ac = &huff[4 + ci[3]];
      for (int by = 0; by < v; by++) {
        for (int bx = 0; bx < h; bx++) {
          int64_t row = my * v + by, col = mx * h + bx;
          int16_t* blk = coefs[c] + (row * ci[4] + col) * 64;
          memset(blk, 0, 64 * sizeof(int16_t));
          int s = Decode(&br, dc);
          if (s < 0 || s > 15) return -1;
          int diff = Extend(br.Get(s), s);
          pred[c] += diff;
          blk[0] = (int16_t)pred[c];
          for (int k = 1; k < 64;) {
            int rs = Decode(&br, ac);
            if (rs < 0) return -1;
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              if (k > 63) break;
              blk[kNaturalOrder[k]] = (int16_t)Extend(br.Get(sz), sz);
              k++;
            } else {
              if (r != 15) break;  // EOB
              k += 16;
            }
          }
        }
      }
    }
    if (restart) todo--;
  }
  return br.pos;
}

// coefs: n blocks of 64 quantised coefficients (natural order, [v][u]);
// quant: 64 entries, natural order; out: n blocks of 8x8 samples.
void udal_jpeg_idct(const int16_t* coefs, const int32_t* quant, int64_t n, uint8_t* out) {
  // the post-IDCT range limit of x & 1023, x centred on 0
  uint8_t limit[1024];
  for (int i = 0; i < 1024; i++) limit[i] = Clamp255((i < 512 ? i : i - 1024) + 128);
  int64_t in[64], ws[64], res[64];
  for (int64_t b = 0; b < n; b++) {
    const int16_t* c = coefs + b * 64;
    for (int k = 0; k < 64; k++) in[k] = (int64_t)c[k] * quant[k];
    for (int col = 0; col < 8; col++)
      IslowPass(in + col, 8, ws + col, 8, kConstBits - kPass1Bits);
    for (int row = 0; row < 8; row++)
      IslowPass(ws + row * 8, 1, res + row * 8, 1, kConstBits + kPass1Bits + 3);
    uint8_t* o = out + b * 64;
    for (int k = 0; k < 64; k++) o[k] = limit[res[k] & 1023];
  }
}

// y, cb, cr: n samples each; out: n RGB triples.
void udal_jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n,
                       uint8_t* out) {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  const int64_t one_half = (int64_t)1 << 15;
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = (int32_t)((91881 * x + one_half) >> 16);     // FIX(1.40200)
    cb_b[i] = (int32_t)((116130 * x + one_half) >> 16);    // FIX(1.77200)
    cr_g[i] = (int32_t)(-46802 * x);                       // -FIX(0.71414)
    cb_g[i] = (int32_t)(-22554 * x + one_half);            // -FIX(0.34414)
  }
  for (int64_t i = 0; i < n; i++) {
    int v = y[i], b = cb[i], r = cr[i];
    out[3 * i] = Clamp255(v + cr_r[r]);
    out[3 * i + 1] = Clamp255(v + ((cb_g[b] + cr_g[r]) >> 16));
    out[3 * i + 2] = Clamp255(v + cb_b[b]);
  }
}

}  // extern "C"
