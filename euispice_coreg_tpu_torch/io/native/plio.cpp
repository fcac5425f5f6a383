// PLIO_1 (IRAF pixel-list) codec for tile-compressed FITS mask images.
//
// Role parity: cfitsio's pliocomp.c (pl_p2li / pl_l2pi), which astropy's
// CompImageHDU uses for ZCMPTYPE='PLIO_1' under the reference's
// fits.open of arbitrary Solar Orbiter files
// (euispice_coreg/hdrshift/alignment.py:299-300).
// Ground-up implementation from the published IRAF line-list format,
// validated empirically against libcfitsio's own encoder/decoder (see
// the PLIO cases in tests/test_fits_io.py).
//
// Stream layout (16-bit signed words, big-endian on disk):
//   header: [0, 7, -100, len & 0x7fff, len >> 15, 0, 0]   (len incl. header)
//   body:   words with opcode in bits 12..15, data in bits 0..11.
//     ZN=0: emit <data> zeros            SH=1: hi = next_word<<12 | data
//     IH=2: hi += data                   DH=3: hi -= data
//     HN=4: emit <data> copies of hi     PN=5: emit <data>-1 zeros, then hi
//     IS=6: hi += data, emit hi once     DS=7: hi -= data, emit hi once
//   The hi register starts at 1.  Valid pixel range is 0 .. 2^24-1
//   (the cfitsio-documented limit; SH physically reaches 2^27-1).

#include <cstdint>

extern "C" {

// Encode npix int32 pixels into 16-bit line-list words.
// Returns the number of shorts written, -1 if out lacks capacity,
// -2 if a pixel is outside the PLIO range [0, 2^24 - 1].
long euicoreg_plio_encode(const int32_t* pix, long npix,
                          int16_t* out, long cap) {
    const int32_t kMax = (1 << 24) - 1;
    long n = 0;
    if (cap < 7) return -1;
    // header patched at the end once the length is known
    for (int i = 0; i < 7; ++i) out[n++] = 0;

    int32_t hi = 1;
    long i = 0;
    while (i < npix) {
        int32_t v = pix[i];
        if (v < 0 || v > kMax) return -2;
        long run = i + 1;
        while (run < npix && pix[run] == v) ++run;
        long count = run - i;
        if (v == 0) {
            while (count > 0) {
                long chunk = count > 4095 ? 4095 : count;
                if (n >= cap) return -1;
                out[n++] = (int16_t)(0x0000 | chunk);  // ZN
                count -= chunk;
            }
        } else {
            int32_t delta = v - hi;
            if (delta != 0) {
                if (delta >= 1 && delta <= 4095) {
                    if (n >= cap) return -1;
                    if (count == 1) {       // IS: bump and emit in one word
                        out[n++] = (int16_t)(0x6000 | delta);
                        hi = v;
                        i = run;
                        continue;
                    }
                    out[n++] = (int16_t)(0x2000 | delta);  // IH
                } else if (delta <= -1 && delta >= -4095) {
                    if (n >= cap) return -1;
                    if (count == 1) {       // DS
                        out[n++] = (int16_t)(0x7000 | (-delta));
                        hi = v;
                        i = run;
                        continue;
                    }
                    out[n++] = (int16_t)(0x3000 | (-delta));  // DH
                } else {
                    if (n + 1 >= cap) return -1;
                    out[n++] = (int16_t)(0x1000 | (v & 0xfff));  // SH
                    out[n++] = (int16_t)(v >> 12);
                }
                hi = v;
            }
            while (count > 0) {
                long chunk = count > 4095 ? 4095 : count;
                if (n >= cap) return -1;
                out[n++] = (int16_t)(0x4000 | chunk);  // HN
                count -= chunk;
            }
        }
        i = run;
    }
    out[1] = 7;
    out[2] = -100;
    out[3] = (int16_t)(n & 0x7fff);
    out[4] = (int16_t)(n >> 15);
    return n;
}

// Decode nll line-list shorts into exactly npix int32 pixels.
// Returns 0 on success; -1 truncated stream; -2 pixel overflow (stream
// describes more than npix pixels); -3 malformed header.
int euicoreg_plio_decode(const int16_t* ll, long nll,
                         int32_t* out, long npix) {
    if (nll < 3) return -3;
    long hdr = (uint16_t)ll[1];
    if (hdr < 2 || hdr > nll) return -3;
    int32_t hi = 1;
    long emitted = 0;
    for (long i = hdr; i < nll; ++i) {
        uint16_t w = (uint16_t)ll[i];
        int op = w >> 12;
        int32_t data = w & 0xfff;
        switch (op) {
            case 0:  // ZN
                if (emitted + data > npix) return -2;
                for (int32_t k = 0; k < data; ++k) out[emitted++] = 0;
                break;
            case 1:  // SH (two words)
                if (i + 1 >= nll) return -1;
                hi = ((int32_t)(uint16_t)ll[++i] << 12) | data;
                break;
            case 2: hi += data; break;            // IH
            case 3: hi -= data; break;            // DH
            case 4:  // HN
                if (emitted + data > npix) return -2;
                for (int32_t k = 0; k < data; ++k) out[emitted++] = hi;
                break;
            case 5:  // PN
                if (emitted + data > npix) return -2;
                for (int32_t k = 0; k < data - 1; ++k) out[emitted++] = 0;
                if (data > 0) out[emitted++] = hi;
                break;
            case 6:  // IS
                hi += data;
                if (emitted >= npix) return -2;
                out[emitted++] = hi;
                break;
            case 7:  // DS
                hi -= data;
                if (emitted >= npix) return -2;
                out[emitted++] = hi;
                break;
            default:
                return -3;  // sign bit set: not a valid PLIO word
        }
        if (emitted == npix) return 0;
    }
    // trailing zeros are implicit in some writers' streams
    while (emitted < npix) out[emitted++] = 0;
    return 0;
}

}  // extern "C"
