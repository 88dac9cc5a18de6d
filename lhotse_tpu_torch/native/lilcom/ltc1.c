/*
 * Native LTC1 codec — bitstream-identical to the numpy implementation in
 * lhotse_tpu/codecs/lilcom_codec.py (quantize to multiples of 2^tick_power,
 * delta along axis 0, zigzag, width-selected little-endian ints, zlib-4).
 *
 * Exposed C ABI (ctypes):
 *   ltc1_compress(data_f32, shape, ndim, tick_power, out, out_cap) -> nbytes | <0
 *   ltc1_parse_header(in, size, shape_out[8], &ndim, &tick_power) -> 0 | <0
 *   ltc1_decompress(in, size, out_f32, max_elems) -> num_elems | <0
 */
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <zlib.h>

#if defined(__AVX512F__) && defined(__AVX2__)
#include <immintrin.h>
#define LTC1_SIMD 1
#endif

#define LTC1_MAGIC "LTC1"
#define MAX_NDIM 8

long long ltc1_compress(const float *data, const uint32_t *shape, int ndim,
                        int tick_power, uint8_t *out, size_t out_cap) {
    if (ndim < 1 || ndim > MAX_NDIM) return -1;
    long long elems = 1;
    for (int d = 0; d < ndim; d++) elems *= (long long)shape[d];
    long long rows = (long long)shape[0];
    long long inner = rows ? elems / rows : 0;

    const double scale = ldexp(1.0, -tick_power); /* 2^-tick_power */

    int64_t *ticks = (int64_t *)malloc(sizeof(int64_t) * (size_t)elems);
    uint64_t *zz = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)elems);
    if (!ticks || !zz) { free(ticks); free(zz); return -2; }

    for (long long i = 0; i < elems; i++) {
        double t = nearbyint((double)data[i] * scale); /* round-half-even, like np.rint */
        if (t > 2147483646.0) t = 2147483646.0;
        if (t < -2147483646.0) t = -2147483646.0;
        ticks[i] = (int64_t)t;
    }

    /* Delta along axis 0 (row stride = inner), zigzag, track max. */
    uint64_t maxv = 0;
    if (rows > 1) {
        for (long long r = rows - 1; r >= 1; r--) {
            int64_t *cur = ticks + r * inner;
            int64_t *prev = ticks + (r - 1) * inner;
            uint64_t *z = zz + r * inner;
            for (long long c = 0; c < inner; c++) {
                int64_t v = cur[c] - prev[c];
                uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
                z[c] = u;
                if (u > maxv) maxv = u;
            }
        }
    }
    for (long long c = 0; c < inner; c++) {
        int64_t v = ticks[c];
        uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
        zz[c] = u;
        if (u > maxv) maxv = u;
    }
    free(ticks);

    int itemsize = maxv < (1u << 8) ? 1 : maxv < (1u << 16) ? 2 : 4;

    /* Serialize to the chosen width (little-endian; x86/ARM LE assumed). */
    size_t raw_size = (size_t)elems * itemsize;
    uint8_t *raw = (uint8_t *)malloc(raw_size ? raw_size : 1);
    if (!raw) { free(zz); return -3; }
    if (itemsize == 1) {
        for (long long i = 0; i < elems; i++) raw[i] = (uint8_t)zz[i];
    } else if (itemsize == 2) {
        uint16_t *p = (uint16_t *)raw;
        for (long long i = 0; i < elems; i++) p[i] = (uint16_t)zz[i];
    } else {
        uint32_t *p = (uint32_t *)raw;
        for (long long i = 0; i < elems; i++) p[i] = (uint32_t)zz[i];
    }
    free(zz);

    size_t header_size = 8 + 4 * (size_t)ndim;
    uLongf comp_cap = compressBound((uLong)raw_size);
    if (out_cap < header_size + comp_cap) { free(raw); return -4; }

    memcpy(out, LTC1_MAGIC, 4);
    out[4] = 0; /* method */
    out[5] = (uint8_t)(int8_t)tick_power;
    out[6] = (uint8_t)ndim;
    out[7] = (uint8_t)itemsize;
    for (int d = 0; d < ndim; d++) {
        uint32_t s = shape[d];
        memcpy(out + 8 + 4 * d, &s, 4);
    }

    uLongf comp_size = comp_cap;
    int rc = compress2(out + header_size, &comp_size, raw, (uLong)raw_size, 4);
    free(raw);
    if (rc != Z_OK) return -5;
    return (long long)(header_size + comp_size);
}

long long ltc1_compress_bound(const uint32_t *shape, int ndim) {
    long long elems = 1;
    for (int d = 0; d < ndim; d++) elems *= (long long)shape[d];
    /* Covers both methods: deflate's compressBound(4*elems) and rowpack's
     * worst case of 33 bits/value + 1 width byte per row. */
    return 8 + 4 * (long long)ndim + 6 * elems + 1024;
}

/* ---------------- method 1: per-row bit-packed residuals ----------------
 *
 * Same quantize/delta/zigzag transform as method 0, but instead of deflate,
 * each axis-0 row stores: u8 bit-width w, then ceil(inner*w/8) bytes of
 * LSB-first w-bit packed values. ~10-20x faster than zlib at a similar
 * ratio for smooth feature matrices (residuals have ~10 significant bits).
 */

static int bit_width_u64(uint64_t v) {
    int w = 0;
    while (v) { w++; v >>= 1; }
    return w;
}

long long ltc1_compress_rowpack(const float *data, const uint32_t *shape, int ndim,
                                int tick_power, uint8_t *out, size_t out_cap) {
    if (ndim < 1 || ndim > MAX_NDIM) return -1;
    long long elems = 1;
    for (int d = 0; d < ndim; d++) elems *= (long long)shape[d];
    long long rows = (long long)shape[0];
    long long inner = rows ? elems / rows : 0;
    if (rows == 0 || inner == 0) return -1;

    const double scale = ldexp(1.0, -tick_power);

    int64_t *ticks = (int64_t *)malloc(sizeof(int64_t) * (size_t)elems);
    uint64_t *zz = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)elems);
    if (!ticks || !zz) { free(ticks); free(zz); return -2; }

    for (long long i = 0; i < elems; i++) {
        double t = nearbyint((double)data[i] * scale);
        if (t > 2147483646.0) t = 2147483646.0;
        if (t < -2147483646.0) t = -2147483646.0;
        ticks[i] = (int64_t)t;
    }
    for (long long r = rows - 1; r >= 1; r--) {
        int64_t *cur = ticks + r * inner;
        int64_t *prev = ticks + (r - 1) * inner;
        uint64_t *z = zz + r * inner;
        for (long long c = 0; c < inner; c++) {
            int64_t v = cur[c] - prev[c];
            z[c] = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
        }
    }
    for (long long c = 0; c < inner; c++) {
        int64_t v = ticks[c];
        zz[c] = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    }
    free(ticks);

    size_t header_size = 8 + 4 * (size_t)ndim;
    if (out_cap < header_size) { free(zz); return -4; }
    memcpy(out, LTC1_MAGIC, 4);
    out[4] = 1; /* method 1: rowpack */
    out[5] = (uint8_t)(int8_t)tick_power;
    out[6] = (uint8_t)ndim;
    out[7] = 0; /* itemsize unused */
    for (int d = 0; d < ndim; d++) memcpy(out + 8 + 4 * d, &shape[d], 4);

    size_t pos = header_size;
    for (long long r = 0; r < rows; r++) {
        const uint64_t *z = zz + r * inner;
        uint64_t rowmax = 0;
        for (long long c = 0; c < inner; c++)
            if (z[c] > rowmax) rowmax = z[c];
        int w = bit_width_u64(rowmax);
        size_t packed = ((size_t)inner * w + 7) / 8;
        if (pos + 1 + packed > out_cap) { free(zz); return -4; }
        out[pos++] = (uint8_t)w;
        if (w == 0) continue;
        uint64_t acc = 0;
        int nbits = 0;
        size_t start = pos;
        for (long long c = 0; c < inner; c++) {
            acc |= z[c] << nbits;
            nbits += w;
            while (nbits >= 8) {
                out[pos++] = (uint8_t)(acc & 0xFF);
                acc >>= 8;
                nbits -= 8;
            }
        }
        if (nbits > 0) out[pos++] = (uint8_t)(acc & 0xFF);
        (void)start;
    }
    free(zz);
    return (long long)pos;
}

int ltc1_parse_header(const uint8_t *in, size_t size, uint32_t *shape_out,
                      int *ndim_out, int *tick_power_out) {
    if (size < 8 || memcmp(in, LTC1_MAGIC, 4) != 0) return -1;
    if (in[4] != 0 && in[4] != 1) return -2; /* unsupported method */
    int ndim = in[6];
    if (ndim < 1 || ndim > MAX_NDIM || size < 8 + 4 * (size_t)ndim) return -3;
    *tick_power_out = (int)(int8_t)in[5];
    *ndim_out = ndim;
    for (int d = 0; d < ndim; d++) memcpy(shape_out + d, in + 8 + 4 * d, 4);
    return 0;
}

long long ltc1_decompress(const uint8_t *in, size_t size, float *out,
                          long long max_elems) {
    uint32_t shape[MAX_NDIM];
    int ndim, tick_power;
    if (ltc1_parse_header(in, size, shape, &ndim, &tick_power) != 0) return -1;
    int method = in[4];

    long long elems = 1;
    for (int d = 0; d < ndim; d++) elems *= (long long)shape[d];
    if (elems > max_elems) return -3;
    long long rows = (long long)shape[0];
    long long inner = rows ? elems / rows : 0;

    size_t header_size = 8 + 4 * (size_t)ndim;
    const float tick = (float)ldexp(1.0, tick_power);

    /* Fused decode: per-column running sums ("carry") turn residual decode +
     * axis-0 cumsum + tick scaling into ONE pass that touches each output
     * element once.  Carries are int32 with wraparound arithmetic: the
     * encoder clips ticks to int32, residual decode and cumsum mod 2^32 are
     * a ring homomorphism, and the true sums fit — so the truncated result
     * is exact even for 33-bit zigzag residuals. */
    int32_t *carry = (int32_t *)calloc((size_t)(inner ? inner : 1), sizeof(int32_t));
    if (!carry) return -4;

    if (method == 1) { /* rowpack */
        size_t pos = header_size;
        for (long long r = 0; r < rows; r++) {
            if (pos >= size) { free(carry); return -5; }
            int w = in[pos++];
            float *orow = out + r * inner;
            if (w == 0) {
                for (long long c = 0; c < inner; c++)
                    orow[c] = (float)carry[c] * tick;
                continue;
            }
            if (w > 33) { free(carry); return -6; }
            size_t packed = ((size_t)inner * w + 7) / 8;
            if (pos + packed > size) { free(carry); return -5; }
            const uint64_t mask = (1ull << w) - 1ull;
            const size_t row_bit0 = pos * 8;
            /* Branchless unpack: each value is fetched with one unaligned
             * 8-byte little-endian load at its bit offset (w <= 33, so
             * shift + w <= 40 always fits the 64-bit window).  Valid while
             * the load stays inside the buffer: row_bit0 + c*w <= (size-8)*8
             * + 7.  The last few values of the final chunk use a bounded
             * byte-accumulate tail instead of reading past the end. */
            long long n_fast = 0;
            if (size >= 8) {
                long long avail = (long long)(size - 8) * 8 + 7 - (long long)row_bit0;
                if (avail >= 0) {
                    n_fast = avail / w + 1;
                    if (n_fast > inner) n_fast = inner;
                }
            }
            long long c = 0;
#ifdef LTC1_SIMD
            /* 8 values per step: gather eight 64-bit windows, variable-shift
             * to each value's bit offset, mask, zigzag-decode (>>1 done in
             * 64-bit BEFORE the 32-bit truncation so 33-bit values stay
             * correct), then 8-lane int32 cumsum + float conversion. */
            if (n_fast >= 8) {
                int64_t bp0[8];
                for (int k = 0; k < 8; k++)
                    bp0[k] = (int64_t)row_bit0 + (int64_t)k * w;
                __m512i vbp = _mm512_loadu_si512(bp0);
                const __m512i vstep = _mm512_set1_epi64(8 * (int64_t)w);
                const __m512i vmask64 = _mm512_set1_epi64((long long)mask);
                const __m512i vseven = _mm512_set1_epi64(7);
                const __m512i vone = _mm512_set1_epi64(1);
                const __m256 vtick = _mm256_set1_ps(tick);
                for (; c + 8 <= n_fast; c += 8) {
                    __m512i vbyte = _mm512_srli_epi64(vbp, 3);
                    __m512i vsh = _mm512_and_epi64(vbp, vseven);
                    __m512i win = _mm512_i64gather_epi64(vbyte, (const void *)in, 1);
                    win = _mm512_and_epi64(_mm512_srlv_epi64(win, vsh), vmask64);
                    __m256i h32 = _mm512_cvtepi64_epi32(_mm512_srli_epi64(win, 1));
                    __m256i o32 = _mm512_cvtepi64_epi32(_mm512_and_epi64(win, vone));
                    __m256i res = _mm256_xor_si256(
                        h32, _mm256_sub_epi32(_mm256_setzero_si256(), o32));
                    __m256i cr = _mm256_loadu_si256((const __m256i *)(carry + c));
                    cr = _mm256_add_epi32(cr, res);
                    _mm256_storeu_si256((__m256i *)(carry + c), cr);
                    _mm256_storeu_ps(orow + c,
                                     _mm256_mul_ps(_mm256_cvtepi32_ps(cr), vtick));
                    vbp = _mm512_add_epi64(vbp, vstep);
                }
            }
#endif
            for (; c < n_fast; c++) {
                size_t bp = row_bit0 + (size_t)c * (size_t)w;
                uint64_t window;
                memcpy(&window, in + (bp >> 3), 8);
                uint64_t u = (window >> (bp & 7)) & mask;
                uint32_t res = (uint32_t)(u >> 1) ^ (uint32_t)(0 - (u & 1));
                int32_t t = (int32_t)((uint32_t)carry[c] + res);
                carry[c] = t;
                orow[c] = (float)t * tick;
            }
            for (; c < inner; c++) {
                size_t bp = row_bit0 + (size_t)c * (size_t)w;
                size_t byi = bp >> 3;
                int shift = (int)(bp & 7);
                int nb = (shift + w + 7) / 8;
                uint64_t window = 0;
                for (int k = 0; k < nb && byi + (size_t)k < size; k++)
                    window |= (uint64_t)in[byi + (size_t)k] << (8 * k);
                uint64_t u = (window >> shift) & mask;
                uint32_t res = (uint32_t)(u >> 1) ^ (uint32_t)(0 - (u & 1));
                int32_t t = (int32_t)((uint32_t)carry[c] + res);
                carry[c] = t;
                orow[c] = (float)t * tick;
            }
            pos += packed;
        }
        free(carry);
        return elems;
    }

    int itemsize = in[7];
    if (itemsize != 1 && itemsize != 2 && itemsize != 4) {
        free(carry);
        return -2;
    }
    size_t raw_size = (size_t)elems * itemsize;
    uint8_t *raw = (uint8_t *)malloc(raw_size ? raw_size : 1);
    if (!raw) { free(carry); return -4; }

    uLongf dest_len = (uLongf)raw_size;
    int rc = uncompress(raw, &dest_len, in + header_size, (uLong)(size - header_size));
    if (rc != Z_OK || dest_len != raw_size) { free(raw); free(carry); return -5; }

    for (long long r = 0; r < rows; r++) {
        float *orow = out + r * inner;
        if (itemsize == 1) {
            const uint8_t *p = raw + r * inner;
            for (long long c = 0; c < inner; c++) {
                uint64_t u = p[c];
                uint32_t res = (uint32_t)(u >> 1) ^ (uint32_t)(0 - (u & 1));
                int32_t t = (int32_t)((uint32_t)carry[c] + res);
                carry[c] = t;
                orow[c] = (float)t * tick;
            }
        } else if (itemsize == 2) {
            const uint16_t *p = (const uint16_t *)raw + r * inner;
            for (long long c = 0; c < inner; c++) {
                uint64_t u = p[c];
                uint32_t res = (uint32_t)(u >> 1) ^ (uint32_t)(0 - (u & 1));
                int32_t t = (int32_t)((uint32_t)carry[c] + res);
                carry[c] = t;
                orow[c] = (float)t * tick;
            }
        } else {
            const uint32_t *p = (const uint32_t *)raw + r * inner;
            for (long long c = 0; c < inner; c++) {
                uint64_t u = p[c];
                uint32_t res = (uint32_t)(u >> 1) ^ (uint32_t)(0 - (u & 1));
                int32_t t = (int32_t)((uint32_t)carry[c] + res);
                carry[c] = t;
                orow[c] = (float)t * tick;
            }
        }
    }
    free(raw);
    free(carry);
    return elems;
}

/*
 * Decode ``nchunks`` back-to-back LTC1 streams (a contiguous .lca chunk
 * range: lhotse_tpu/features/io.py LilcomChunkyReader) into one output
 * buffer with a single call — one ctypes round trip per cut read instead
 * of one per 500-frame chunk, and no per-chunk numpy buffers to
 * concatenate. ``chunk_sizes`` are the individual compressed sizes.
 * Returns total decoded elements, or <0 on any chunk failure.
 */
long long ltc1_decompress_concat(const uint8_t *in, const int64_t *chunk_sizes,
                                 int nchunks, float *out, long long max_elems) {
    long long total = 0;
    size_t pos = 0;
    for (int i = 0; i < nchunks; i++) {
        long long n = ltc1_decompress(
            in + pos, (size_t)chunk_sizes[i], out + total, max_elems - total);
        if (n < 0) return n;
        total += n;
        pos += (size_t)chunk_sizes[i];
    }
    return total;
}
