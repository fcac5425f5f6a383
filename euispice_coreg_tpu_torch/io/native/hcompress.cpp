// HCOMPRESS_1 codec for tile-compressed FITS (decode + encode).
//
// Implements the hcompress algorithm (R. White 1992, "High-performance
// compression of astronomical images") exactly as specified by the FITS
// Tiled Image Compression Convention: H-transform (lossless integer Haar
// variant with bit-redistribution), optional scale digitization, bitplane
// quadtree coding with the fixed Huffman nybble code, MSB-first bit
// packing, and byte-aligned trailing sign bits.  Fills the role cfitsio's
// fits_hcompress/fits_hdecompress play under astropy's CompImageHDU in the
// reference stack (the reference opens arbitrary Solar Orbiter files,
// euispice_coreg/hdrshift/alignment.py:299-300).
//
// Stream layout (all big-endian):
//   magic 0xDD 0x99 | nx i32 | ny i32 | scale i32 | a[0] i64 |
//   nbitplanes u8[3] | qtree-coded bitplanes (4 quadrant sets) |
//   EOF nybble 0 | pad to byte | sign bits (1 per nonzero coefficient)
//
// The array is indexed a[i*ny + j] (ny fastest); quadrant splits at
// nx2=(nx+1)/2, ny2=(ny+1)/2.  (nx, ny) = tile (rows, cols): encoded
// streams are byte-identical to the ones genuine cfitsio-written FITS
// files carry, square and non-square tiles alike (cross-validated against
// libcfitsio in tests/test_fits_io.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// bit I/O (MSB first within bytes)
// ---------------------------------------------------------------------

struct BitReader {
    const uint8_t* buf;
    long n;
    long pos = 0;
    int buffer = 0;
    int bits_to_go = 0;
    bool fail = false;

    int bit() {
        if (bits_to_go == 0) {
            if (pos >= n) { fail = true; return 0; }
            buffer = buf[pos++];
            bits_to_go = 8;
        }
        bits_to_go--;
        return (buffer >> bits_to_go) & 1;
    }
    int nbits(int k) {
        if (bits_to_go < k) {
            if (pos >= n) { fail = true; return 0; }
            buffer = (buffer << 8) | buf[pos++];
            bits_to_go += 8;
        }
        bits_to_go -= k;
        return (buffer >> bits_to_go) & ((1 << k) - 1);
    }
    int nybble() { return nbits(4); }
    void realign() { bits_to_go = 0; }  // discard to byte boundary
};

struct BitWriter {
    std::vector<uint8_t>& out;
    int buffer = 0;
    int bits_to_go = 8;

    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

    void bit(int b) {
        buffer = (buffer << 1) | (b & 1);
        if (--bits_to_go == 0) {
            out.push_back((uint8_t)(buffer & 0xff));
            buffer = 0;
            bits_to_go = 8;
        }
    }
    void nbits(int bits, int k) {
        for (int i = k - 1; i >= 0; i--) bit((bits >> i) & 1);
    }
    void nybble(int v) { nbits(v, 4); }
    void flush() {  // pad current byte with zeros
        if (bits_to_go < 8) {
            out.push_back((uint8_t)((buffer << bits_to_go) & 0xff));
            buffer = 0;
            bits_to_go = 8;
        }
    }
};

// fixed Huffman code for 4-bit values (canonical hcompress table)
const int kCode[16] = {0x3e, 0x00, 0x01, 0x08, 0x02, 0x09, 0x1a, 0x1b,
                       0x03, 0x1c, 0x0a, 0x1d, 0x0b, 0x1e, 0x3f, 0x0c};
const int kNCode[16] = {6, 3, 3, 4, 3, 4, 5, 5, 3, 5, 4, 5, 4, 5, 6, 4};

int input_huffman(BitReader& in) {
    int c = in.nbits(3);
    if (c < 4) return 1 << c;
    c = in.bit() | (c << 1);
    if (c < 13) {
        switch (c) {
            case 8: return 3;
            case 9: return 5;
            case 10: return 10;
            case 11: return 12;
            case 12: return 15;
        }
    }
    c = in.bit() | (c << 1);
    if (c < 31) {
        switch (c) {
            case 26: return 6;
            case 27: return 7;
            case 28: return 9;
            case 29: return 11;
            case 30: return 13;
        }
    }
    c = in.bit() | (c << 1);
    return (c == 62) ? 0 : 14;
}

int log2ceil(int v) {
    int l = 0;
    while ((1 << l) < v) l++;
    return l;
}

// ---------------------------------------------------------------------
// shuffle / unshuffle along one dimension with stride n2
// ---------------------------------------------------------------------

void shuffle(int* a, int n, int n2, int* tmp) {
    int* pt = tmp;
    int* p1 = a + n2;
    for (int i = 1; i < n; i += 2) { *pt++ = *p1; p1 += 2 * n2; }
    p1 = a + n2;
    int* p2 = a + 2 * n2;
    for (int i = 2; i < n; i += 2) { *p1 = *p2; p1 += n2; p2 += 2 * n2; }
    pt = tmp;
    for (int i = 1; i < n; i += 2) { *p1 = *pt++; p1 += n2; }
}

void unshuffle(int* a, int n, int n2, int* tmp) {
    int nhalf = (n + 1) >> 1;
    int* pt = tmp;
    int* p1 = a + (long)n2 * nhalf;
    for (int i = nhalf; i < n; i++) { *pt++ = *p1; p1 += n2; }
    int* p2 = a + (long)n2 * (nhalf - 1);
    p1 = a + 2L * n2 * (nhalf - 1);
    for (int i = nhalf - 1; i >= 0; i--) { *p1 = *p2; p2 -= n2; p1 -= 2 * n2; }
    pt = tmp;
    p1 = a + n2;
    for (int i = 1; i < n; i += 2) { *p1 = *pt++; p1 += 2 * n2; }
}

// ---------------------------------------------------------------------
// forward H-transform (lossless: low bits thrown here are reconstructed
// by hinv's bit-redistribution)
// ---------------------------------------------------------------------

void htrans(int* a, int nx, int ny) {
    int nmax = (nx > ny) ? nx : ny;
    int log2n = log2ceil(nmax);
    std::vector<int> tmp((nmax + 1) / 2);

    int shift = 0;
    int mask = -2, mask2 = mask << 1;
    int prnd = 1, prnd2 = prnd << 1, nrnd2 = prnd2 - 1;
    int nxtop = nx, nytop = ny;

    for (int k = 0; k < log2n; k++) {
        int oddx = nxtop % 2, oddy = nytop % 2;
        int i;
        for (i = 0; i < nxtop - oddx; i += 2) {
            long s00 = (long)i * ny;
            long s10 = s00 + ny;
            for (int j = 0; j < nytop - oddy; j += 2) {
                int h0 = (a[s10 + 1] + a[s10] + a[s00 + 1] + a[s00]) >> shift;
                int hx = (a[s10 + 1] + a[s10] - a[s00 + 1] - a[s00]) >> shift;
                int hy = (a[s10 + 1] - a[s10] + a[s00 + 1] - a[s00]) >> shift;
                int hc = (a[s10 + 1] - a[s10] - a[s00 + 1] + a[s00]) >> shift;
                a[s10 + 1] = hc;
                a[s10] = ((hx >= 0) ? (hx + prnd) : hx) & mask;
                a[s00 + 1] = ((hy >= 0) ? (hy + prnd) : hy) & mask;
                a[s00] = ((h0 >= 0) ? (h0 + prnd2) : (h0 + nrnd2)) & mask2;
                s00 += 2;
                s10 += 2;
            }
            if (oddy) {
                int h0 = (a[s10] + a[s00]) << (1 - shift);
                int hx = (a[s10] - a[s00]) << (1 - shift);
                a[s10] = ((hx >= 0) ? (hx + prnd) : hx) & mask;
                a[s00] = ((h0 >= 0) ? (h0 + prnd2) : (h0 + nrnd2)) & mask2;
            }
        }
        if (oddx) {
            long s00 = (long)i * ny;
            int j;
            for (j = 0; j < nytop - oddy; j += 2) {
                int h0 = (a[s00 + 1] + a[s00]) << (1 - shift);
                int hy = (a[s00 + 1] - a[s00]) << (1 - shift);
                a[s00 + 1] = ((hy >= 0) ? (hy + prnd) : hy) & mask;
                a[s00] = ((h0 >= 0) ? (h0 + prnd2) : (h0 + nrnd2)) & mask2;
                s00 += 2;
            }
            if (oddy) {
                int h0 = a[s00] << (2 - shift);
                a[s00] = ((h0 >= 0) ? (h0 + prnd2) : (h0 + nrnd2)) & mask2;
            }
        }
        for (int i2 = 0; i2 < nxtop; i2++)
            shuffle(a + (long)ny * i2, nytop, 1, tmp.data());
        for (int j2 = 0; j2 < nytop; j2++)
            shuffle(a + j2, nxtop, ny, tmp.data());
        nxtop = (nxtop + 1) >> 1;
        nytop = (nytop + 1) >> 1;
        shift = 1;
        mask = mask2;
        prnd = prnd2;
        mask2 <<= 1;
        prnd2 <<= 1;
        nrnd2 = prnd2 - 1;
    }
}

// ---------------------------------------------------------------------
// inverse H-transform (smooth=0: exact lossless inverse of htrans)
// ---------------------------------------------------------------------

void hinv(int* a, int nx, int ny) {
    int nmax = (nx > ny) ? nx : ny;
    int log2n = log2ceil(nmax);
    if (log2n == 0) return;
    std::vector<int> tmp((nmax + 1) / 2);

    int shift = 1;
    int bit0 = 1 << (log2n - 1);
    int bit1 = bit0 << 1;
    int bit2 = bit0 << 2;
    int mask0 = -bit0, mask1 = mask0 << 1, mask2 = mask0 << 2;
    int prnd0 = bit0 >> 1, prnd1 = bit1 >> 1, prnd2 = bit2 >> 1;
    int nrnd0 = prnd0 - 1, nrnd1 = prnd1 - 1, nrnd2 = prnd2 - 1;

    a[0] = (a[0] + ((a[0] >= 0) ? prnd2 : nrnd2)) & mask2;

    int nxtop = 1, nytop = 1, nxf = nx, nyf = ny;
    int c = 1 << log2n;
    for (int k = log2n - 1; k >= 0; k--) {
        c >>= 1;
        nxtop <<= 1;
        nytop <<= 1;
        if (nxf <= c) nxtop -= 1; else nxf -= c;
        if (nyf <= c) nytop -= 1; else nyf -= c;
        if (k == 0) { nrnd0 = 0; shift = 2; }

        for (int i2 = 0; i2 < nxtop; i2++)
            unshuffle(a + (long)ny * i2, nytop, 1, tmp.data());
        for (int j2 = 0; j2 < nytop; j2++)
            unshuffle(a + j2, nxtop, ny, tmp.data());

        int oddx = nxtop % 2, oddy = nytop % 2;
        int i;
        for (i = 0; i < nxtop - oddx; i += 2) {
            long s00 = (long)ny * i;
            long s10 = s00 + ny;
            for (int j = 0; j < nytop - oddy; j += 2) {
                int h0 = a[s00], hx = a[s10], hy = a[s00 + 1], hc = a[s10 + 1];
                hx = (hx + ((hx >= 0) ? prnd1 : nrnd1)) & mask1;
                hy = (hy + ((hy >= 0) ? prnd1 : nrnd1)) & mask1;
                hc = (hc + ((hc >= 0) ? prnd0 : nrnd0)) & mask0;
                int lowbit0 = hc & bit0;
                hx = (hx >= 0) ? (hx - lowbit0) : (hx + lowbit0);
                hy = (hy >= 0) ? (hy - lowbit0) : (hy + lowbit0);
                int lowbit1 = (hc ^ hx ^ hy) & bit1;
                h0 = (h0 >= 0)
                    ? (h0 + lowbit0 - lowbit1)
                    : (h0 + ((lowbit0 == 0) ? lowbit1 : (lowbit0 - lowbit1)));
                a[s10 + 1] = (h0 + hx + hy + hc) >> shift;
                a[s10] = (h0 + hx - hy - hc) >> shift;
                a[s00 + 1] = (h0 - hx + hy - hc) >> shift;
                a[s00] = (h0 - hx - hy + hc) >> shift;
                s00 += 2;
                s10 += 2;
            }
            if (oddy) {
                int h0 = a[s00], hx = a[s10];
                hx = ((hx >= 0) ? (hx + prnd1) : (hx + nrnd1)) & mask1;
                int lowbit1 = hx & bit1;
                h0 = (h0 >= 0) ? (h0 - lowbit1) : (h0 + lowbit1);
                a[s10] = (h0 + hx) >> shift;
                a[s00] = (h0 - hx) >> shift;
            }
        }
        if (oddx) {
            long s00 = (long)ny * i;
            int j;
            for (j = 0; j < nytop - oddy; j += 2) {
                int h0 = a[s00], hy = a[s00 + 1];
                hy = ((hy >= 0) ? (hy + prnd1) : (hy + nrnd1)) & mask1;
                int lowbit1 = hy & bit1;
                h0 = (h0 >= 0) ? (h0 - lowbit1) : (h0 + lowbit1);
                a[s00 + 1] = (h0 + hy) >> shift;
                a[s00] = (h0 - hy) >> shift;
                s00 += 2;
            }
            if (oddy) a[s00] = a[s00] >> shift;
        }
        bit2 = bit1;
        bit1 = bit0;
        bit0 >>= 1;
        mask1 = mask0;
        mask0 >>= 1;
        prnd1 = prnd0;
        prnd0 >>= 1;
        nrnd1 = nrnd0;
        nrnd0 = prnd0 - 1;
    }
}

// ---------------------------------------------------------------------
// quadtree bitplane helpers (a is int[n-stride], scratch u8 nybbles)
// ---------------------------------------------------------------------

void qtree_onebit(const int* a, int n, int nx, int ny, uint8_t* b, int bit) {
    long k = 0;
    int i;
    for (i = 0; i < nx - 1; i += 2) {
        long s00 = (long)n * i;
        long s10 = s00 + n;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            b[k++] = (uint8_t)((((a[s10 + 1] >> bit) & 1))
                               | (((a[s10] >> bit) & 1) << 1)
                               | (((a[s00 + 1] >> bit) & 1) << 2)
                               | (((a[s00] >> bit) & 1) << 3));
            s00 += 2;
            s10 += 2;
        }
        if (j < ny) {
            b[k++] = (uint8_t)((((a[s10] >> bit) & 1) << 1)
                               | (((a[s00] >> bit) & 1) << 3));
        }
    }
    if (i < nx) {
        long s00 = (long)n * i;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            b[k++] = (uint8_t)((((a[s00 + 1] >> bit) & 1) << 2)
                               | (((a[s00] >> bit) & 1) << 3));
            s00 += 2;
        }
        if (j < ny) b[k++] = (uint8_t)(((a[s00] >> bit) & 1) << 3);
    }
}

void qtree_reduce(const uint8_t* a, int n, int nx, int ny, uint8_t* b) {
    long k = 0;
    int i;
    for (i = 0; i < nx - 1; i += 2) {
        long s00 = (long)n * i;
        long s10 = s00 + n;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            b[k++] = (uint8_t)((a[s10 + 1] != 0) | ((a[s10] != 0) << 1)
                               | ((a[s00 + 1] != 0) << 2)
                               | ((a[s00] != 0) << 3));
            s00 += 2;
            s10 += 2;
        }
        if (j < ny) {
            b[k++] = (uint8_t)(((a[s10] != 0) << 1) | ((a[s00] != 0) << 3));
        }
    }
    if (i < nx) {
        long s00 = (long)n * i;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            b[k++] = (uint8_t)(((a[s00 + 1] != 0) << 2) | ((a[s00] != 0) << 3));
            s00 += 2;
        }
        if (j < ny) b[k++] = (uint8_t)((a[s00] != 0) << 3);
    }
}

void qtree_copy(const uint8_t* a, int nx, int ny, uint8_t* b, int n) {
    int nx2 = (nx + 1) / 2, ny2 = (ny + 1) / 2;
    long k = (long)ny2 * (nx2 - 1) + ny2 - 1;
    for (int i = nx2 - 1; i >= 0; i--) {
        long s00 = 2 * ((long)n * i + ny2 - 1);
        for (int j = ny2 - 1; j >= 0; j--) {
            b[s00] = a[k--];
            s00 -= 2;
        }
    }
    int i;
    for (i = 0; i < nx - 1; i += 2) {
        long s00 = (long)n * i;
        long s10 = s00 + n;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            uint8_t v = b[s00];
            b[s10 + 1] = v & 1;
            b[s10] = (v >> 1) & 1;
            b[s00 + 1] = (v >> 2) & 1;
            b[s00] = (v >> 3) & 1;
            s00 += 2;
            s10 += 2;
        }
        if (j < ny) {
            uint8_t v = b[s00];
            b[s10] = (v >> 1) & 1;
            b[s00] = (v >> 3) & 1;
        }
    }
    if (i < nx) {
        long s00 = (long)n * i;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            uint8_t v = b[s00];
            b[s00 + 1] = (v >> 2) & 1;
            b[s00] = (v >> 3) & 1;
            s00 += 2;
        }
        if (j < ny) b[s00] = (b[s00] >> 3) & 1;
    }
}

void qtree_bitins(const uint8_t* a, int nx, int ny, int* b, int n, int bit) {
    int plane = 1 << bit;
    long k = 0;
    int i;
    for (i = 0; i < nx - 1; i += 2) {
        long s00 = (long)n * i;
        long s10 = s00 + n;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            uint8_t v = a[k++];
            if (v & 1) b[s10 + 1] |= plane;
            if (v & 2) b[s10] |= plane;
            if (v & 4) b[s00 + 1] |= plane;
            if (v & 8) b[s00] |= plane;
            s00 += 2;
            s10 += 2;
        }
        if (j < ny) {
            uint8_t v = a[k++];
            if (v & 2) b[s10] |= plane;
            if (v & 8) b[s00] |= plane;
        }
    }
    if (i < nx) {
        long s00 = (long)n * i;
        int j;
        for (j = 0; j < ny - 1; j += 2) {
            uint8_t v = a[k++];
            if (v & 4) b[s00 + 1] |= plane;
            if (v & 8) b[s00] |= plane;
            s00 += 2;
        }
        if (j < ny) {
            if (a[k++] & 8) b[s00] |= plane;
        }
    }
}

// ---------------------------------------------------------------------
// qtree decode / encode of one quadrant set
// ---------------------------------------------------------------------

int qtree_decode(BitReader& in, int* a, int n, int nqx, int nqy,
                 int nbitplanes) {
    int nqmax = (nqx > nqy) ? nqx : nqy;
    int log2n = log2ceil(nqmax);
    int nqx2 = (nqx + 1) / 2, nqy2 = (nqy + 1) / 2;
    std::vector<uint8_t> scratch((size_t)nqx2 * nqy2 + 1);

    for (int bit = nbitplanes - 1; bit >= 0; bit--) {
        int b = in.nybble();
        if (in.fail) return -1;
        if (b == 0) {
            // direct bitmap: ((nqx+1)/2)*((nqy+1)/2) nybbles
            long nn = (long)nqx2 * nqy2;
            for (long q = 0; q < nn; q++) scratch[q] = (uint8_t)in.nybble();
            if (in.fail) return -1;
            qtree_bitins(scratch.data(), nqx, nqy, a, n, bit);
        } else if (b != 0xf) {
            return -2;  // bad format code
        } else {
            scratch[0] = (uint8_t)input_huffman(in);
            int nx = 1, ny = 1, nfx = nqx, nfy = nqy;
            int c = 1 << log2n;
            for (int k = 1; k < log2n; k++) {
                c >>= 1;
                nx <<= 1;
                ny <<= 1;
                if (nfx <= c) nx -= 1; else nfx -= c;
                if (nfy <= c) ny -= 1; else nfy -= c;
                // expand: spread each nybble to 2x2 bits, then replace
                // nonzero cells with freshly-read codes
                qtree_copy(scratch.data(), nx, ny, scratch.data(), ny);
                for (long q = (long)nx * ny - 1; q >= 0; q--)
                    if (scratch[q]) scratch[q] = (uint8_t)input_huffman(in);
                if (in.fail) return -1;
            }
            qtree_bitins(scratch.data(), nqx, nqy, a, n, bit);
        }
    }
    return 0;
}

// append Huffman codes for nonzero nybbles, LSB-first packing into bytes
// (bytes written out in reverse at the end — the canonical hcompress trick
// that makes the stream read MSB-first coarse-to-fine)
struct RevBuf {
    std::vector<uint8_t> bytes;
    uint32_t bitbuffer = 0;
    int bits = 0;
    bool overflow = false;
    size_t bmax;

    explicit RevBuf(size_t bmax_) : bmax(bmax_) {}

    void add(const uint8_t* a, long n) {
        for (long i = 0; i < n; i++) {
            if (a[i] != 0) {
                bitbuffer |= (uint32_t)kCode[a[i]] << bits;
                bits += kNCode[a[i]];
                while (bits >= 8) {
                    bytes.push_back((uint8_t)(bitbuffer & 0xff));
                    if (bytes.size() >= bmax) { overflow = true; return; }
                    bitbuffer >>= 8;
                    bits -= 8;
                }
            }
        }
    }
};

void write_bdirect(BitWriter& out, const int* a, int n, int nqx, int nqy,
                   uint8_t* scratch, int bit) {
    out.nybble(0);
    qtree_onebit(a, n, nqx, nqy, scratch, bit);
    long nn = ((long)(nqx + 1) / 2) * ((nqy + 1) / 2);
    for (long q = 0; q < nn; q++) out.nybble(scratch[q]);
}

int qtree_encode(BitWriter& out, const int* a, int n, int nqx, int nqy,
                 int nbitplanes) {
    int nqmax = (nqx > nqy) ? nqx : nqy;
    int log2n = log2ceil(nqmax);
    int nqx2 = (nqx + 1) / 2, nqy2 = (nqy + 1) / 2;
    size_t bmax = ((size_t)nqx2 * nqy2 + 1) / 2;
    std::vector<uint8_t> scratch((size_t)nqx2 * nqy2 + 4);

    for (int bit = nbitplanes - 1; bit >= 0; bit--) {
        RevBuf buf(bmax);
        qtree_onebit(a, n, nqx, nqy, scratch.data(), bit);
        int nx = (nqx + 1) >> 1;
        int ny = (nqy + 1) >> 1;
        buf.add(scratch.data(), (long)nx * ny);
        if (!buf.overflow) {
            for (int k = 1; k < log2n; k++) {
                qtree_reduce(scratch.data(), ny, nx, ny, scratch.data());
                nx = (nx + 1) >> 1;
                ny = (ny + 1) >> 1;
                buf.add(scratch.data(), (long)nx * ny);
                if (buf.overflow) break;
            }
        }
        if (buf.overflow) {
            write_bdirect(out, a, n, nqx, nqy, scratch.data(), bit);
            continue;
        }
        out.nybble(0xF);
        if (buf.bytes.empty() && buf.bits == 0) {
            // no 1s anywhere: emit the code for value 0
            out.nbits(kCode[0], kNCode[0]);
        } else {
            if (buf.bits > 0)
                out.nbits((int)(buf.bitbuffer & ((1u << buf.bits) - 1)),
                          buf.bits);
            for (long i = (long)buf.bytes.size() - 1; i >= 0; i--)
                out.nbits(buf.bytes[i], 8);
        }
    }
    return 0;
}

void put_i32(std::vector<uint8_t>& v, int32_t x) {
    v.push_back((uint8_t)((x >> 24) & 0xff));
    v.push_back((uint8_t)((x >> 16) & 0xff));
    v.push_back((uint8_t)((x >> 8) & 0xff));
    v.push_back((uint8_t)(x & 0xff));
}

void put_i64(std::vector<uint8_t>& v, int64_t x) {
    for (int s = 56; s >= 0; s -= 8) v.push_back((uint8_t)((x >> s) & 0xff));
}

int32_t get_i32(const uint8_t* p) {
    return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | (uint32_t)p[3]);
}

int64_t get_i64(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return (int64_t)v;
}

}  // namespace

extern "C" {

// Probe the stream header: writes nx, ny, scale. Returns 0 or <0 on error.
int euicoreg_hcomp_info(const uint8_t* in, long nin, int* nx, int* ny,
                        int* scale) {
    if (nin < 22) return -1;
    if (in[0] != 0xDD || in[1] != 0x99) return -2;
    *nx = get_i32(in + 2);
    *ny = get_i32(in + 6);
    *scale = get_i32(in + 10);
    if (*nx <= 0 || *ny <= 0) return -3;
    return 0;
}

// Decode a full hcompress stream into out[nx*ny] (row-major, ny fastest).
// cap is the out capacity in pixels. Returns 0 on success.
int euicoreg_hcomp_decode(const uint8_t* in, long nin, int32_t* out,
                          long cap) {
    if (nin < 25) return -1;  // full header: magic 2 + 3*i32 + i64 + 3
    int nx, ny, scale;
    int rc = euicoreg_hcomp_info(in, nin, &nx, &ny, &scale);
    if (rc != 0) return rc;
    long nel = (long)nx * ny;
    if (nel > cap) return -4;

    int64_t sumall = get_i64(in + 14);
    uint8_t nbitplanes[3] = {in[22], in[23], in[24]};
    // header is 25 bytes: magic 2 + 3*i32 + i64 + 3
    BitReader br{in + 25, nin - 25};

    std::memset(out, 0, nel * sizeof(int32_t));
    int nx2 = (nx + 1) / 2, ny2 = (ny + 1) / 2;

    rc = qtree_decode(br, out, ny, nx2, ny2, nbitplanes[0]);
    if (rc == 0)
        rc = qtree_decode(br, out + ny2, ny, nx2, ny / 2, nbitplanes[1]);
    if (rc == 0)
        rc = qtree_decode(br, out + (long)ny * nx2, ny, nx / 2, ny2,
                          nbitplanes[1]);
    if (rc == 0)
        rc = qtree_decode(br, out + (long)ny * nx2 + ny2, ny, nx / 2, ny / 2,
                          nbitplanes[2]);
    if (rc != 0) return rc;
    if (br.nybble() != 0 || br.fail) return -5;  // EOF symbol

    // sign bits: byte-aligned, one bit per nonzero coefficient
    br.realign();
    for (long i = 0; i < nel; i++) {
        if (out[i]) {
            if (br.bit()) out[i] = -out[i];
            if (br.fail) return -6;
        }
    }
    out[0] = (int32_t)sumall;

    if (scale > 1)
        for (long i = 0; i < nel; i++) out[i] *= scale;
    hinv(out, nx, ny);
    return 0;
}

// Encode in[nx*ny] (ny fastest). Returns byte count, or <0 on error.
long euicoreg_hcomp_encode(const int32_t* in, int nx, int ny, int scale,
                           uint8_t* outbuf, long cap) {
    long nel = (long)nx * ny;
    std::vector<int> a(in, in + nel);
    htrans(a.data(), nx, ny);
    if (scale > 1) {
        int d = (scale + 1) / 2 - 1;
        for (long i = 0; i < nel; i++)
            a[i] = ((a[i] > 0) ? (a[i] + d) : (a[i] - d)) / scale;
    }

    std::vector<uint8_t> out;
    out.reserve(nel / 2 + 64);
    out.push_back(0xDD);
    out.push_back(0x99);
    put_i32(out, nx);
    put_i32(out, ny);
    put_i32(out, scale);
    put_i64(out, (int64_t)a[0]);
    a[0] = 0;

    // collect sign bits (and fold to absolute values)
    std::vector<uint8_t> signbits((nel + 7) / 8, 0);
    long nsign = 0;
    int bits_left = 8;
    for (long i = 0; i < nel; i++) {
        if (a[i] > 0) {
            signbits[nsign] <<= 1;
            bits_left--;
        } else if (a[i] < 0) {
            signbits[nsign] = (uint8_t)((signbits[nsign] << 1) | 1);
            bits_left--;
            a[i] = -a[i];
        }
        if (bits_left == 0) {
            bits_left = 8;
            nsign++;
        }
    }
    if (bits_left != 8) {
        signbits[nsign] <<= bits_left;
        nsign++;
    }

    // bitplane counts per quadrant class (0: LL, 1: LH/HL, 2: HH)
    int nx2 = (nx + 1) / 2, ny2 = (ny + 1) / 2;
    int vmax[3] = {0, 0, 0};
    {
        long i = 0;
        for (int k = 0; k < nx; k++)
            for (int j = 0; j < ny; j++, i++) {
                int q = (j >= ny2) + (k >= nx2);
                if (vmax[q] < a[i]) vmax[q] = a[i];
            }
    }
    uint8_t nbit[3];
    for (int q = 0; q < 3; q++) {
        int nb = 0, v = vmax[q];
        while (v > 0) { v >>= 1; nb++; }
        nbit[q] = (uint8_t)nb;
    }
    out.push_back(nbit[0]);
    out.push_back(nbit[1]);
    out.push_back(nbit[2]);

    BitWriter bw(out);
    qtree_encode(bw, a.data(), ny, nx2, ny2, nbit[0]);
    qtree_encode(bw, a.data() + ny2, ny, nx2, ny / 2, nbit[1]);
    qtree_encode(bw, a.data() + (long)ny * nx2, ny, nx / 2, ny2, nbit[1]);
    qtree_encode(bw, a.data() + (long)ny * nx2 + ny2, ny, nx / 2, ny / 2,
                 nbit[2]);
    bw.nybble(0);  // EOF symbol
    bw.flush();

    out.insert(out.end(), signbits.begin(), signbits.begin() + nsign);

    if ((long)out.size() > cap) return -1;
    std::memcpy(outbuf, out.data(), out.size());
    return (long)out.size();
}

}  // extern "C"
