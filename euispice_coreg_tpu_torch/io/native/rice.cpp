// RICE_1 codec for FITS tiled image compression.
//
// Implements the Rice coding scheme specified by the FITS Tiled Image
// Compression Convention (Pence, Seaman & White 2013; FITS 4.0 standard,
// section 10.4.2):
//   * the first pixel of each tile is stored verbatim (bytepix*8 bits),
//   * successive differences are zigzag-mapped to non-negative integers,
//   * each block of `blocksize` mapped differences is Golomb-Rice coded
//     with a per-block split level fs: quotient in unary (fs zeros, then a
//     one bit), remainder in fs binary bits,
//   * block code 0 = all differences zero; code fsmax+1 = verbatim values.
//
// This plays the role cfitsio's compiled RICE codec plays underneath
// astropy's CompImageHDU in the reference stack (the reference opens
// RICE-compressed SIDC EUI files via astropy, e.g. alignment.py:299-300).
//
// Fresh implementation from the published specification (no cfitsio code).

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
  uint8_t* out;
  long cap;
  long pos;       // byte position
  int bitbuf;     // bits accumulated in current byte
  int nbits;      // number of bits in bitbuf
  bool overflow;

  BitWriter(uint8_t* o, long c) : out(o), cap(c), pos(0), bitbuf(0), nbits(0), overflow(false) {}

  inline void put_bits(uint32_t value, int n) {
    // write n bits, MSB first
    for (int i = n - 1; i >= 0; --i) {
      bitbuf = (bitbuf << 1) | ((value >> i) & 1u);
      if (++nbits == 8) {
        if (pos < cap) out[pos] = (uint8_t)bitbuf; else overflow = true;
        ++pos;
        bitbuf = 0;
        nbits = 0;
      }
    }
  }

  inline void put_zeros(uint32_t n) {
    for (uint32_t i = 0; i < n; ++i) put_bits(0u, 1);
  }

  long finish() {
    if (nbits > 0) {
      bitbuf <<= (8 - nbits);
      if (pos < cap) out[pos] = (uint8_t)bitbuf; else overflow = true;
      ++pos;
      bitbuf = 0;
      nbits = 0;
    }
    return overflow ? -1 : pos;
  }
};

struct BitReader {
  const uint8_t* in;
  long len;
  long pos;
  int bitpos;   // 0..7, next bit index (MSB first)
  bool past_end;  // a read ran beyond the stream: input was truncated

  BitReader(const uint8_t* i, long l)
      : in(i), len(l), pos(0), bitpos(0), past_end(false) {}

  inline int get_bit() {
    if (pos >= len) {
      past_end = true;  // well-formed streams never read past the pad byte
      return 0;
    }
    int b = (in[pos] >> (7 - bitpos)) & 1;
    if (++bitpos == 8) {
      bitpos = 0;
      ++pos;
    }
    return b;
  }

  inline uint32_t get_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | (uint32_t)get_bit();
    return v;
  }

  inline uint32_t get_unary() {
    uint32_t n = 0;
    while (get_bit() == 0) {
      if (past_end) return n;  // truncated unary run
      ++n;
    }
    return n;
  }
};

inline void fs_params(int bytepix, int& fsbits, int& fsmax, int& bbits) {
  switch (bytepix) {
    case 1: fsbits = 3; fsmax = 6; bbits = 8; break;
    case 2: fsbits = 4; fsmax = 14; bbits = 16; break;
    default: fsbits = 5; fsmax = 25; bbits = 32; break;
  }
}

}  // namespace

extern "C" {

// Encode npix int32 pixels. Returns compressed size in bytes, or -1 if the
// output buffer is too small.
long euicoreg_rice_encode(const int32_t* a, long npix, uint8_t* out, long cap,
                          int blocksize, int bytepix) {
  if (npix <= 0) return 0;
  int fsbits, fsmax, bbits;
  fs_params(bytepix, fsbits, fsmax, bbits);

  BitWriter w(out, cap);
  // first pixel verbatim (big-endian, bytepix bytes)
  w.put_bits((uint32_t)a[0], bbits);

  int32_t lastpix = a[0];
  for (long i = 0; i < npix; i += blocksize) {
    long nb = (npix - i < blocksize) ? (npix - i) : blocksize;
    // zigzag-map differences (mod 2^32, so extreme swings stay well-defined)
    uint32_t mapped[1024];
    double sum = 0.0;
    for (long j = 0; j < nb; ++j) {
      int32_t d = (int32_t)((uint32_t)a[i + j] - (uint32_t)lastpix);
      lastpix = a[i + j];
      uint32_t m = (d >= 0)
          ? ((uint32_t)d << 1)
          : (uint32_t)(((uint64_t)(-(int64_t)d) << 1) - 1u);
      mapped[j] = m;
      sum += (double)m;
    }
    // choose split level: fs ~ log2(mean)
    double mean = (sum - (double)nb / 2.0 - 1.0) / (double)nb;
    if (mean < 0.0) mean = 0.0;
    uint64_t im = (uint64_t)mean;
    int fs = 0;
    while (im > 0) {
      im >>= 1;
      ++fs;
    }

    if (sum == 0.0) {
      w.put_bits(0u, fsbits);  // all-zero block
    } else if (fs >= fsmax) {
      w.put_bits((uint32_t)(fsmax + 1), fsbits);  // verbatim block
      for (long j = 0; j < nb; ++j) w.put_bits(mapped[j], bbits);
    } else {
      w.put_bits((uint32_t)(fs + 1), fsbits);
      for (long j = 0; j < nb; ++j) {
        uint32_t v = mapped[j];
        uint32_t top = v >> fs;
        w.put_zeros(top);
        w.put_bits(1u, 1);
        if (fs > 0) w.put_bits(v & ((1u << fs) - 1u), fs);
      }
    }
  }
  return w.finish();
}

// Decode to npix int32 pixels. Returns 0 on success.
int euicoreg_rice_decode(const uint8_t* in, long nin, int32_t* out, long npix,
                         int blocksize, int bytepix) {
  if (npix <= 0) return 0;
  int fsbits, fsmax, bbits;
  fs_params(bytepix, fsbits, fsmax, bbits);

  BitReader r(in, nin);
  uint32_t first = r.get_bits(bbits);
  // sign-extend for narrow types
  int32_t lastpix;
  if (bytepix == 1) lastpix = (int32_t)(uint8_t)first;
  else if (bytepix == 2) lastpix = (int32_t)(int16_t)(uint16_t)first;
  else lastpix = (int32_t)first;

  for (long i = 0; i < npix; i += blocksize) {
    long nb = (npix - i < blocksize) ? (npix - i) : blocksize;
    uint32_t code = r.get_bits(fsbits);
    if (code == 0) {
      for (long j = 0; j < nb; ++j) out[i + j] = lastpix;
    } else if ((int)code == fsmax + 1) {
      for (long j = 0; j < nb; ++j) {
        uint32_t m = r.get_bits(bbits);
        int32_t d = (m & 1u) ? (int32_t)(int64_t)(-(int64_t)(((uint64_t)m + 1u) >> 1))
                             : (int32_t)(m >> 1);
        lastpix = (int32_t)((uint32_t)lastpix + (uint32_t)d);
        out[i + j] = lastpix;
      }
    } else {
      int fs = (int)code - 1;
      for (long j = 0; j < nb; ++j) {
        uint32_t top = r.get_unary();
        uint32_t m = (top << fs) | (fs > 0 ? r.get_bits(fs) : 0u);
        int32_t d = (m & 1u) ? (int32_t)(int64_t)(-(int64_t)(((uint64_t)m + 1u) >> 1))
                             : (int32_t)(m >> 1);
        lastpix = (int32_t)((uint32_t)lastpix + (uint32_t)d);
        out[i + j] = lastpix;
      }
    }
  }
  // truncated/corrupt input: bits were consumed past the stream end (the
  // encoder always pads to a byte boundary, so legitimate decodes stay
  // within the buffer) -> let the caller raise instead of returning garbage
  return r.past_end ? 2 : 0;
}

}  // extern "C"
