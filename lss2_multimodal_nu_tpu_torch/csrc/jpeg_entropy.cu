// Baseline JPEG entropy decoding on the host: Huffman-coded scan -> quantised
// DCT coefficients. Host code only (no kernel), built by the same nvcc step as
// the kernels and called through ctypes, which releases the GIL, so that the
// loader's worker threads decode in parallel.
//
// No TPU kernel stands behind it: the JAX package decodes with PIL on the
// host. It is the host stage of the port's JPEG decode; kernel 6
// (`jpeg_idct.cu`) does the rest on the card. Its plain version is
// `data/jpeg.py::_entropy_decode_plain`, and `data/jpeg.py::parse` reads the
// markers for both: this file sees only the scan.
//
// What bounds it: one core's serial bit parsing, a few ns a code. Codes are
// looked up 9 bits at a time (a table per Huffman table, 512 entries), longer
// codes by the canonical-code walk of the JPEG specification (F.2.2.3); the
// bit buffer holds up to 64 bits and is refilled a byte at a time, skipping
// the 0x00 after a stuffed 0xFF. Restart markers cut the scan into segments;
// each starts byte-aligned with the DC predictions at 0. Past the end of a
// segment the reader supplies zero bits, as libjpeg does, and a block that
// ends beyond the segment's data is an error.
//
// Output: int16 blocks of 64 in natural order, components one after another,
// each's blocks row by row over whole MCUs (dummy blocks included), as
// `data/jpeg.py::Coefficients` lays them out.

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLookBits = 9;

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum Error {
  kOk = 0,
  kBadTable = 1,
  kBadCode = 2,
  kOverrun = 3,
  kBadRun = 4,
  kTooFewSegments = 5,
  kOutputSize = 6,
  kBadDc = 7,
};

struct Huffman {
  // lookahead: (length << 8) | symbol for codes of at most kLookBits bits, 0 else
  uint16_t look[1 << kLookBits];
  int32_t maxcode[18];  // largest code of each length, -1 if none; [17] sentinel
  int32_t valptr[17];   // index in vals of the first code of each length
  int32_t mincode[17];
  uint8_t vals[256];
};

int build(const uint8_t* bits /* [1..16] at bits[1] */, const uint8_t* vals, Huffman* h) {
  memset(h->look, 0, sizeof(h->look));
  memcpy(h->vals, vals, 256);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h->valptr[len] = k;
    h->mincode[len] = code;
    for (int i = 0; i < bits[len]; ++i, ++k, ++code) {
      if (k >= 256 || code >= (1 << len)) return kBadTable;
      if (len <= kLookBits) {
        const int lo = code << (kLookBits - len);
        for (int j = 0; j < (1 << (kLookBits - len)); ++j)
          h->look[lo + j] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    }
    h->maxcode[len] = bits[len] ? code - 1 : -1;
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  return kOk;
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // bits left-aligned at bit 63
  int nbits = 0;
  long long consumed = 0;  // bits taken from the data (not from the zero fill)
  long long available = 0;

  void fill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (p < end) {
        byte = *p++;
        if (byte == 0xFF && p < end && *p == 0x00) ++p;  // stuffing
        available += 8;
      }
      buf |= byte << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
    consumed += n;
  }
  int bits(int n) {  // n in 1..16
    const int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
};

inline int decode(Reader& r, const Huffman& h, int* sym) {
  const uint32_t look = r.peek(kLookBits);
  const uint16_t e = h.look[look];
  if (e) {
    r.skip(e >> 8);
    *sym = e & 0xFF;
    return kOk;
  }
  uint32_t code = r.peek(16);
  for (int len = kLookBits + 1; len <= 16; ++len) {
    const int c = static_cast<int>(code >> (16 - len));
    if (h.maxcode[len] >= 0 && c <= h.maxcode[len]) {
      r.skip(len);
      *sym = h.vals[h.valptr[len] + c - h.mincode[len]];
      return kOk;
    }
  }
  return kBadCode;
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// The end of the restart segment that starts at p: its restart marker, or
// the end of the scan.
const uint8_t* segment_end(const uint8_t* p, const uint8_t* end) {
  for (; p + 1 < end; ++p)
    if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) return p;
  return end;
}

}  // namespace

extern "C" {

// Decodes the scan `data` (n bytes: the entropy-coded data after the SOS
// header, stuffing and restart markers in place) into `out`.
// tables: 4 x 273 bytes, each [unused, bits[1..16], vals[256]];
// comp: ncomp x 6 int32 (h, v, DC table slot, AC table slot, blocks across,
//   first block); MCUs across x down; restart interval in MCUs (0: none);
// out: out_len int16. Returns 0 or an error code (lss_jpeg_error_string).
int lss_jpeg_entropy_decode(const uint8_t* data, long long n, const uint8_t* tables,
                            const int32_t* comp, int ncomp, int mcux, int mcuy, int restart,
                            int16_t* out, long long out_len) {
  Huffman huff[4];
  for (int t = 0; t < 4; ++t) {  // an unused slot is all zeros: no code matches
    const uint8_t* tb = tables + t * 273;
    if (int e = build(tb, tb + 17, &huff[t])) return e;
  }
  long long need = 0;  // values up to the end of the last component's blocks
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* cp = comp + 6 * c;
    const long long last = (cp[5] + (long long)mcuy * cp[1] * cp[4]) * 64;
    if (last > need) need = last;
  }
  if (need > out_len) return kOutputSize;
  memset(out, 0, sizeof(int16_t) * need);

  const uint8_t* p = data;
  const uint8_t* end = data + n;
  const long long total_mcus = (long long)mcux * mcuy;
  const long long interval = restart > 0 ? restart : total_mcus;
  Reader r{};
  int pred[4] = {0, 0, 0, 0};
  for (long long mcu = 0; mcu < total_mcus; ++mcu) {
    if (mcu % interval == 0) {
      if (mcu) {
        // the previous segment ends at a restart marker: step over it
        if (p + 1 >= end) return kTooFewSegments;
        p += 2;
      }
      r = Reader{};
      r.p = p;
      r.end = p = segment_end(p, end);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    const int my = static_cast<int>(mcu / mcux), mx = static_cast<int>(mcu % mcux);
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* cp = comp + 6 * c;
      const Huffman& dc = huff[cp[2]];
      const Huffman& ac = huff[cp[3]];
      for (int dy = 0; dy < cp[1]; ++dy) {
        for (int dx = 0; dx < cp[0]; ++dx) {
          int16_t* blk = out + ((long long)cp[5] + (long long)(my * cp[1] + dy) * cp[4] +
                                mx * cp[0] + dx) * 64;
          int s;
          if (int e = decode(r, dc, &s)) return e;
          if (s > 11) return kBadDc;
          if (s) pred[c] += extend(r.bits(s), s);
          if (pred[c] > 32767 || pred[c] < -32768) return kBadDc;
          blk[0] = static_cast<int16_t>(pred[c]);
          for (int k = 1; k < 64;) {
            int rs;
            if (int e = decode(r, ac, &rs)) return e;
            const int run = rs >> 4, size = rs & 15;
            if (size) {
              k += run;
              if (k > 63) return kBadRun;
              blk[kZigzag[k]] = static_cast<int16_t>(extend(r.bits(size), size));
              ++k;
            } else if (run == 15) {
              k += 16;
            } else {
              break;
            }
          }
          if (r.consumed > r.available) return kOverrun;
        }
      }
    }
  }
  return kOk;
}

const char* lss_jpeg_error_string(int code) {
  switch (code) {
    case kOk: return "no error";
    case kBadTable: return "bad Huffman table";
    case kBadCode: return "no Huffman code matches";
    case kOverrun: return "the scan ends inside an MCU";
    case kBadRun: return "AC run past the block";
    case kTooFewSegments: return "fewer restart intervals than the image needs";
    case kOutputSize: return "output buffer too small";
    case kBadDc: return "DC value out of range";
    default: return "unknown error";
  }
}

// _build.library binds this in every library of the port.
const char* lss_error_string(int code) { return lss_jpeg_error_string(code); }

}  // extern "C"
