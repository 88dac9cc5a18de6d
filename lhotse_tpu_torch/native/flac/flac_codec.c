/*
 * Self-contained FLAC decoder + encoder.
 *
 * Decoder: full subset support — CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32)
 * subframes, 4- and 5-bit Rice partitions with escape codes, wasted bits,
 * left-side / right-side / mid-side channel decorrelation, UTF-8 coded
 * frame/sample numbers. CRCs are skipped on read (tolerant decoder).
 *
 * Encoder: fixed-blocksize (4096) frames, independent channels, per-channel
 * best-of fixed predictors (orders 0-2) with single-partition Rice residuals,
 * verbatim fallback; correct CRC-8 (poly 0x07) and CRC-16 (poly 0x8005) so
 * the output is readable by any standard decoder.
 *
 * Exposed C ABI (used from Python via ctypes in lhotse_tpu/audio/flacio.py):
 *   flac_parse_info(data, size, &channels, &sample_rate, &bps, &total)
 *   flac_decode(data, size, out_interleaved_i32, max_frames) -> frames or <0
 *   flac_encode(pcm_interleaved_i32, frames, channels, rate, bps,
 *               out, out_cap) -> bytes or <0
 */
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------- bit reader ------------------------------ */

/*
 * 64-bit cached bit reader: refills up to 7 bytes at a time into an
 * MSB-aligned accumulator, extracts multi-bit fields with one shift, and
 * decodes unary (Rice quotient) runs with count-leading-zeros. This is the
 * decode hot loop — every Rice-coded residual sample passes through
 * br_read_unary + br_read — and the cached design is ~5x the naive
 * bit-at-a-time reader.
 */
typedef struct {
    const uint8_t *data;
    size_t size;
    size_t pos;      /* next byte not yet loaded into the cache */
    uint64_t cache;  /* unconsumed bits, MSB-aligned */
    int ncached;     /* number of valid bits in cache */
    int error;
} BitReader;

static void br_init(BitReader *br, const uint8_t *data, size_t size, size_t pos) {
    br->data = data;
    br->size = size;
    br->pos = pos;
    br->cache = 0;
    br->ncached = 0;
    br->error = 0;
}

static inline void br_refill(BitReader *br) {
    if (br->ncached <= 0 && br->pos + 8 <= br->size) {
        uint64_t v;
        memcpy(&v, br->data + br->pos, 8); /* bulk load; bswap to big-endian */
        br->cache = __builtin_bswap64(v);
        br->ncached = 64;
        br->pos += 8;
        return;
    }
    while (br->ncached <= 56 && br->pos < br->size) {
        br->cache |= (uint64_t)br->data[br->pos++] << (56 - br->ncached);
        br->ncached += 8;
    }
}

/* Total unread bits (cache + bytes not yet loaded). */
static inline size_t br_remaining_bits(const BitReader *br) {
    return (br->size - br->pos) * 8 + (size_t)br->ncached;
}

static inline uint32_t br_read(BitReader *br, int nbits) {
    if (nbits <= 0) return 0;
    if (br->ncached < nbits) {
        br_refill(br);
        if (br->ncached < nbits) { br->error = 1; return 0; }
    }
    uint32_t out = (uint32_t)(br->cache >> (64 - nbits));
    br->cache <<= nbits;
    br->ncached -= nbits;
    return out;
}

static int64_t br_read64(BitReader *br, int nbits) {
    int64_t out = 0;
    while (nbits > 32) {
        out = (out << 32) | (int64_t)br_read(br, 32);
        nbits -= 32;
    }
    out = (out << nbits) | (int64_t)br_read(br, nbits);
    return out;
}

static int32_t br_read_signed(BitReader *br, int nbits) {
    uint32_t v = br_read(br, nbits);
    /* sign-extend */
    if (nbits > 0 && nbits < 32 && (v & (1u << (nbits - 1))))
        v |= ~((1u << nbits) - 1u);
    return (int32_t)v;
}

static inline uint32_t br_read_unary(BitReader *br) {
    uint32_t n = 0;
    for (;;) {
        if (br->ncached == 0) {
            br_refill(br);
            if (br->ncached == 0) { br->error = 1; return n; }
        }
        if (br->cache == 0) { /* every cached bit is a zero: keep counting */
            n += (uint32_t)br->ncached;
            br->ncached = 0;
            if (n > 1u << 24) { br->error = 1; return n; } /* corrupt guard */
            continue;
        }
        int z = __builtin_clzll(br->cache);
        if (z >= br->ncached) { /* zeros run past the valid region */
            n += (uint32_t)br->ncached;
            br->cache = 0;
            br->ncached = 0;
            continue;
        }
        br->cache <<= z + 1; /* z zeros + the terminating one */
        br->ncached -= z + 1;
        return n + (uint32_t)z;
    }
}

static void br_align(BitReader *br) {
    int drop = br->ncached & 7;
    br->cache <<= drop;
    br->ncached -= drop;
}

/* UTF-8-style coded number used for frame/sample numbers (up to 56 bits). */
static int64_t br_read_utf8(BitReader *br) {
    uint32_t b0 = br_read(br, 8);
    if (b0 < 0x80) return (int64_t)b0;
    int n = 0;
    uint32_t mask = 0x80;
    while (b0 & mask) { n++; mask >>= 1; }
    if (n < 2 || n > 7) { br->error = 1; return -1; }
    int64_t v = b0 & (0x7F >> n);
    for (int i = 1; i < n; i++) {
        uint32_t b = br_read(br, 8);
        if ((b & 0xC0) != 0x80) { br->error = 1; return -1; }
        v = (v << 6) | (b & 0x3F);
    }
    return v;
}

/* ------------------------------ stream header ---------------------------- */

typedef struct {
    int channels;
    int sample_rate;
    int bps;
    long long total_samples;
    size_t audio_offset; /* byte offset of the first audio frame */
} StreamInfo;

static int parse_streaminfo(const uint8_t *data, size_t size, StreamInfo *si) {
    if (size < 4 || memcmp(data, "fLaC", 4) != 0) return -1;
    size_t pos = 4;
    int got_streaminfo = 0;
    for (;;) {
        if (pos + 4 > size) return -2;
        int last = data[pos] >> 7;
        int type = data[pos] & 0x7F;
        size_t len = ((size_t)data[pos + 1] << 16) | ((size_t)data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
        if (pos + len > size) return -3;
        if (type == 0 && len >= 34) {
            const uint8_t *p = data + pos;
            /* min/max blocksize (16+16), min/max framesize (24+24) = 10 bytes */
            si->sample_rate = ((int)p[10] << 12) | ((int)p[11] << 4) | (p[12] >> 4);
            si->channels = ((p[12] >> 1) & 0x7) + 1;
            si->bps = (((p[12] & 0x1) << 4) | (p[13] >> 4)) + 1;
            si->total_samples = (((long long)(p[13] & 0x0F)) << 32)
                | ((long long)p[14] << 24) | ((long long)p[15] << 16)
                | ((long long)p[16] << 8) | (long long)p[17];
            got_streaminfo = 1;
        }
        pos += len;
        if (last) break;
    }
    if (!got_streaminfo) return -4;
    si->audio_offset = pos;
    return 0;
}

int flac_parse_info(const uint8_t *data, size_t size,
                    int *channels, int *sample_rate, int *bps,
                    long long *total_samples) {
    StreamInfo si;
    int rc = parse_streaminfo(data, size, &si);
    if (rc != 0) return rc;
    *channels = si.channels;
    *sample_rate = si.sample_rate;
    *bps = si.bps;
    *total_samples = si.total_samples;
    return 0;
}

/* ------------------------------ frame decoding --------------------------- */

#define MAX_CHANNELS 8
#define MAX_BLOCK 65535
#define MAX_ORDER 32

/*
 * Rice-decode `count` residuals with the bit cache held in registers and a
 * bulk byte-granular refill amortized over ~4-6 samples (the per-sample
 * br_read_unary/br_read pair re-checks and re-fills through memory every
 * call — this loop is the whole-stream decode hot path). Long unary runs or
 * end-of-buffer fall back to the checked per-sample reader.
 */
static void decode_rice_run(BitReader *br, int32_t *res, int count, int param) {
    uint64_t cache = br->cache;
    int nc = br->ncached;
    const uint8_t *data = br->data;
    size_t pos = br->pos, size = br->size;
    int i = 0;
    while (i < count) {
        if (nc <= 32) {
            if (pos + 8 <= size) {
                uint64_t v;
                memcpy(&v, data + pos, 8);
                cache |= __builtin_bswap64(v) >> nc;
                int nbytes = (64 - nc) >> 3;
                pos += (size_t)nbytes;
                nc += nbytes << 3;
            } else {
                while (nc <= 56 && pos < size) {
                    cache |= (uint64_t)data[pos++] << (56 - nc);
                    nc += 8;
                }
                if (nc <= 0) break; /* exhausted: slow path reports error */
            }
        }
        int z = cache ? __builtin_clzll(cache) : 64;
        if (z + 1 + param > nc) {
            /* Unary run crosses the cache (or trailing partial): commit and
             * take the checked reader for this one sample. */
            br->cache = cache;
            br->ncached = nc;
            br->pos = pos;
            uint32_t q = br_read_unary(br);
            uint32_t r = param ? br_read(br, param) : 0;
            if (br->error) return;
            uint32_t u = (q << param) | r;
            res[i++] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
            cache = br->cache;
            nc = br->ncached;
            pos = br->pos;
            continue;
        }
        cache <<= z + 1;
        uint32_t r = param ? (uint32_t)(cache >> (64 - param)) : 0;
        cache <<= param;
        nc -= z + 1 + param;
        uint32_t u = ((uint32_t)z << param) | r;
        res[i++] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
    }
    br->cache = cache;
    br->ncached = nc;
    br->pos = pos;
    if (i < count) br->error = 1;
}

static int decode_residual(BitReader *br, int32_t *res, int blocksize, int order) {
    int method = (int)br_read(br, 2);
    if (method > 1) return -1;
    int plen = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0xF : 0x1F;
    int porder = (int)br_read(br, 4);
    int parts = 1 << porder;
    int idx = 0;
    for (int p = 0; p < parts; p++) {
        int count = (blocksize >> porder) - (p == 0 ? order : 0);
        if (count < 0) return -2;
        int param = (int)br_read(br, plen);
        if (param == escape) {
            int rawbits = (int)br_read(br, 5);
            for (int i = 0; i < count; i++)
                res[idx++] = rawbits ? br_read_signed(br, rawbits) : 0;
        } else {
            decode_rice_run(br, res + idx, count, param);
            idx += count;
        }
        if (br->error) return -3;
    }
    return 0;
}

static void restore_fixed(int32_t *buf, int blocksize, int order) {
    switch (order) {
    case 0: break;
    case 1:
        for (int i = order; i < blocksize; i++) buf[i] += buf[i - 1];
        break;
    case 2:
        for (int i = order; i < blocksize; i++) buf[i] += 2 * buf[i - 1] - buf[i - 2];
        break;
    case 3:
        for (int i = order; i < blocksize; i++)
            buf[i] += 3 * buf[i - 1] - 3 * buf[i - 2] + buf[i - 3];
        break;
    case 4:
        for (int i = order; i < blocksize; i++)
            buf[i] += 4 * buf[i - 1] - 6 * buf[i - 2] + 4 * buf[i - 3] - buf[i - 4];
        break;
    }
}

static int decode_subframe(BitReader *br, int32_t *buf, int blocksize, int bps) {
    if (br_read(br, 1) != 0) return -1; /* padding bit */
    int type = (int)br_read(br, 6);
    int wasted = 0;
    if (br_read(br, 1)) wasted = (int)br_read_unary(br) + 1;
    bps -= wasted;

    if (type == 0) { /* CONSTANT */
        int32_t v = br_read_signed(br, bps);
        for (int i = 0; i < blocksize; i++) buf[i] = v;
    } else if (type == 1) { /* VERBATIM */
        for (int i = 0; i < blocksize; i++) buf[i] = br_read_signed(br, bps);
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) { /* FIXED */
        int order = type & 0x07;
        for (int i = 0; i < order; i++) buf[i] = br_read_signed(br, bps);
        if (decode_residual(br, buf + order, blocksize, order) != 0) return -2;
        restore_fixed(buf, blocksize, order);
    } else if (type & 0x20) { /* LPC */
        int order = (type & 0x1F) + 1;
        int32_t coefs[MAX_ORDER];
        for (int i = 0; i < order; i++) buf[i] = br_read_signed(br, bps);
        int precision = (int)br_read(br, 4) + 1;
        if (precision == 16) return -3; /* invalid (1111) */
        int shift = br_read_signed(br, 5);
        if (shift < 0) return -4;
        for (int i = 0; i < order; i++) coefs[i] = br_read_signed(br, precision);
        if (decode_residual(br, buf + order, blocksize, order) != 0) return -5;
        for (int i = order; i < blocksize; i++) {
            int64_t acc = 0;
            for (int j = 0; j < order; j++)
                acc += (int64_t)coefs[j] * (int64_t)buf[i - 1 - j];
            buf[i] += (int32_t)(acc >> shift);
        }
    } else {
        return -6;
    }
    if (wasted)
        for (int i = 0; i < blocksize; i++) buf[i] = (int32_t)((uint32_t)buf[i] << wasted);
    return br->error ? -7 : 0;
}

/* Decode the whole stream into interleaved int32. Returns frames decoded. */
long long flac_decode(const uint8_t *data, size_t size, int32_t *out,
                      long long max_frames) {
    StreamInfo si;
    if (parse_streaminfo(data, size, &si) != 0) return -1;
    if (si.channels > MAX_CHANNELS) return -2;

    static const int BLOCKSIZES[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                       256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
    static const int RATES[16] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                                  24000, 32000, 44100, 48000, 96000, -1, -2, -3, 0};

    BitReader br;
    br_init(&br, data, size, si.audio_offset);
    long long written = 0;
    /* heap channel buffers: ctypes releases the GIL, so decode must be
     * thread-safe (no static state) */
    int32_t *chan_mem = (int32_t *)malloc(sizeof(int32_t) * MAX_CHANNELS * MAX_BLOCK);
    if (chan_mem == NULL) return -8;
    int32_t *chan[MAX_CHANNELS];
    for (int c = 0; c < MAX_CHANNELS; c++) chan[c] = chan_mem + (size_t)c * MAX_BLOCK;
#define FLAC_DECODE_RET(v) do { free(chan_mem); return (v); } while (0)

    while (written < max_frames) {
        /* locate frame sync; frames are contiguous, but be tolerant */
        br_align(&br);
        if (br_remaining_bits(&br) < 16) break;
        uint32_t sync = br_read(&br, 14);
        if (br.error) break;
        if (sync != 0x3FFE) FLAC_DECODE_RET(written > 0 ? written : -3);
        br_read(&br, 1); /* reserved */
        br_read(&br, 1); /* blocking strategy */
        int bs_code = (int)br_read(&br, 4);
        int sr_code = (int)br_read(&br, 4);
        int ch_assign = (int)br_read(&br, 4);
        int ss_code = (int)br_read(&br, 3);
        br_read(&br, 1); /* reserved */
        br_read_utf8(&br); /* frame or sample number */

        int blocksize;
        if (bs_code == 6) blocksize = (int)br_read(&br, 8) + 1;
        else if (bs_code == 7) blocksize = (int)br_read(&br, 16) + 1;
        else blocksize = BLOCKSIZES[bs_code];
        if (blocksize <= 0 || blocksize > MAX_BLOCK) FLAC_DECODE_RET(-4);

        if (sr_code == 12) br_read(&br, 8);
        else if (sr_code == 13 || sr_code == 14) br_read(&br, 16);
        (void)RATES;

        static const int SS_BITS[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        int bps = ss_code == 0 ? si.bps : SS_BITS[ss_code];
        if (bps == 0) bps = si.bps;

        br_read(&br, 8); /* CRC-8 (unchecked) */

        int nch;
        if (ch_assign < 8) nch = ch_assign + 1;
        else nch = 2;
        if (nch != si.channels) FLAC_DECODE_RET(-5);

        for (int c = 0; c < nch; c++) {
            int sub_bps = bps;
            if ((ch_assign == 8 && c == 1) || (ch_assign == 9 && c == 0) ||
                (ch_assign == 10 && c == 1))
                sub_bps += 1; /* side channel carries one extra bit */
            if (decode_subframe(&br, chan[c], blocksize, sub_bps) != 0)
                FLAC_DECODE_RET(written > 0 ? written : -6);
        }
        br_align(&br);
        br_read(&br, 16); /* CRC-16 (unchecked) */
        if (br.error) FLAC_DECODE_RET(written > 0 ? written : -7);

        /* channel de-correlation */
        if (ch_assign == 8) { /* left/side: right = left - side */
            for (int i = 0; i < blocksize; i++) chan[1][i] = chan[0][i] - chan[1][i];
        } else if (ch_assign == 9) { /* right/side: left = side + right */
            for (int i = 0; i < blocksize; i++) chan[0][i] = chan[0][i] + chan[1][i];
        } else if (ch_assign == 10) { /* mid/side */
            for (int i = 0; i < blocksize; i++) {
                int32_t side = chan[1][i];
                int32_t mid = ((int32_t)((uint32_t)chan[0][i] << 1)) | (side & 1);
                chan[0][i] = (mid + side) >> 1;
                chan[1][i] = (mid - side) >> 1;
            }
        }

        long long take = blocksize;
        if (written + take > max_frames) take = max_frames - written;
        for (long long i = 0; i < take; i++)
            for (int c = 0; c < nch; c++)
                out[(written + i) * nch + c] = chan[c][i];
        written += take;
        if (br_remaining_bits(&br) == 0) break;
    }
    FLAC_DECODE_RET(written);
#undef FLAC_DECODE_RET
}

/* ------------------------------- bit writer ------------------------------ */

typedef struct {
    uint8_t *data;
    size_t cap;
    size_t pos;
    int bit;
    int error;
} BitWriter;

static void bw_init(BitWriter *bw, uint8_t *data, size_t cap) {
    bw->data = data; bw->cap = cap; bw->pos = 0; bw->bit = 0; bw->error = 0;
    if (cap) data[0] = 0;
}

static void bw_write(BitWriter *bw, uint32_t value, int nbits) {
    while (nbits > 0) {
        if (bw->pos >= bw->cap) { bw->error = 1; return; }
        int avail = 8 - bw->bit;
        int put = nbits < avail ? nbits : avail;
        uint32_t chunk = (value >> (nbits - put)) & ((1u << put) - 1u);
        bw->data[bw->pos] |= (uint8_t)(chunk << (avail - put));
        bw->bit += put;
        if (bw->bit == 8) {
            bw->bit = 0; bw->pos++;
            if (bw->pos < bw->cap) bw->data[bw->pos] = 0;
        }
        nbits -= put;
    }
}

static void bw_write64(BitWriter *bw, uint64_t value, int nbits) {
    if (nbits > 32) {
        bw_write(bw, (uint32_t)(value >> 32), nbits - 32);
        nbits = 32;
    }
    bw_write(bw, (uint32_t)(value & 0xFFFFFFFFu), nbits);
}

static void bw_write_unary(BitWriter *bw, uint32_t q) {
    while (q >= 32) { bw_write(bw, 0, 32); q -= 32; }
    bw_write(bw, 1, (int)q + 1);
}

static void bw_align(BitWriter *bw) {
    if (bw->bit != 0) { bw->bit = 0; bw->pos++; if (bw->pos < bw->cap) bw->data[bw->pos] = 0; }
}

/* ---------------------------------- CRCs --------------------------------- */

static uint8_t crc8(const uint8_t *data, size_t len) {
    uint8_t crc = 0;
    for (size_t i = 0; i < len; i++) {
        crc ^= data[i];
        for (int b = 0; b < 8; b++)
            crc = (uint8_t)((crc & 0x80) ? (crc << 1) ^ 0x07 : crc << 1);
    }
    return crc;
}

static uint16_t crc16(const uint8_t *data, size_t len) {
    uint16_t crc = 0;
    for (size_t i = 0; i < len; i++) {
        crc ^= (uint16_t)data[i] << 8;
        for (int b = 0; b < 8; b++)
            crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
    }
    return crc;
}

/* ------------------------------- encoding -------------------------------- */

static void utf8_encode(BitWriter *bw, uint64_t v) {
    if (v < 0x80) { bw_write(bw, (uint32_t)v, 8); return; }
    int nbytes = 2;
    while (v >= (1ull << (5 * nbytes + 1)) && nbytes < 7) nbytes++;
    static const uint32_t LEAD[8] = {0, 0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE};
    bw_write(bw, LEAD[nbytes] | (uint32_t)(v >> (6 * (nbytes - 1))), 8);
    for (int i = nbytes - 2; i >= 0; i--)
        bw_write(bw, 0x80 | (uint32_t)((v >> (6 * i)) & 0x3F), 8);
}

static int best_rice_param(const int32_t *res, int n) {
    if (n == 0) return 0;
    uint64_t total = 0;
    for (int i = 0; i < n; i++) {
        int64_t v = res[i];
        total += (uint64_t)(v < 0 ? (-(int64_t)v * 2 - 1) : v * 2);
    }
    uint64_t mean = total / (uint64_t)n;
    int k = 0;
    while ((1ull << (k + 1)) < mean + 1 && k < 14) k++;
    return k;
}

static uint64_t rice_cost_bits(const int32_t *res, int n, int k) {
    uint64_t bits = 0;
    for (int i = 0; i < n; i++) {
        int64_t v = res[i];
        uint64_t u = (uint64_t)(v < 0 ? (-(int64_t)v * 2 - 1) : v * 2);
        bits += (u >> k) + 1 + (uint64_t)k;
    }
    return bits;
}

static void write_rice(BitWriter *bw, const int32_t *res, int n, int k) {
    for (int i = 0; i < n; i++) {
        int64_t v = res[i];
        uint64_t u = (uint64_t)(v < 0 ? (-(int64_t)v * 2 - 1) : v * 2);
        bw_write_unary(bw, (uint32_t)(u >> k));
        if (k) bw_write(bw, (uint32_t)(u & ((1u << k) - 1u)), k);
    }
}

/* Encode one channel's block as the cheapest of fixed orders 0..2 or
 * verbatim. `scratch` must hold >= blocksize ints. */
static void encode_subframe(BitWriter *bw, const int32_t *x, int n, int bps,
                            int32_t *scratch) {
    /* constant? */
    int all_same = 1;
    for (int i = 1; i < n; i++) if (x[i] != x[0]) { all_same = 0; break; }
    if (all_same) {
        bw_write(bw, 0, 1); bw_write(bw, 0, 6); bw_write(bw, 0, 1);
        bw_write(bw, (uint32_t)x[0] & ((bps < 32) ? ((1u << bps) - 1u) : 0xFFFFFFFFu), bps);
        return;
    }

    int best_order = -1; /* -1 = verbatim */
    int best_k = 0;
    uint64_t best_bits = (uint64_t)n * (uint64_t)bps; /* verbatim cost */

    for (int order = 0; order <= 2 && order < n; order++) {
        /* compute fixed-predictor residuals into scratch */
        for (int i = order; i < n; i++) {
            int64_t pred = 0;
            if (order == 1) pred = x[i - 1];
            else if (order == 2) pred = 2 * (int64_t)x[i - 1] - x[i - 2];
            scratch[i - order] = (int32_t)(x[i] - pred);
        }
        int m = n - order;
        int k = best_rice_param(scratch, m);
        uint64_t bits = rice_cost_bits(scratch, m, k)
            + (uint64_t)order * (uint64_t)bps + 2 + 4 + 4;
        if (bits < best_bits) { best_bits = bits; best_order = order; best_k = k; }
    }

    if (best_order < 0) { /* verbatim */
        bw_write(bw, 0, 1); bw_write(bw, 1, 6); bw_write(bw, 0, 1);
        for (int i = 0; i < n; i++)
            bw_write(bw, (uint32_t)x[i] & ((bps < 32) ? ((1u << bps) - 1u) : 0xFFFFFFFFu), bps);
        return;
    }

    int order = best_order;
    bw_write(bw, 0, 1);
    bw_write(bw, 0x08 | (uint32_t)order, 6);
    bw_write(bw, 0, 1);
    for (int i = 0; i < order; i++)
        bw_write(bw, (uint32_t)x[i] & ((bps < 32) ? ((1u << bps) - 1u) : 0xFFFFFFFFu), bps);
    /* recompute residuals (scratch was for the best order already unless a
     * later order was tried; just redo) */
    for (int i = order; i < n; i++) {
        int64_t pred = 0;
        if (order == 1) pred = x[i - 1];
        else if (order == 2) pred = 2 * (int64_t)x[i - 1] - x[i - 2];
        scratch[i - order] = (int32_t)(x[i] - pred);
    }
    /* residual coding: method 0 (4-bit rice), partition order 0 */
    bw_write(bw, 0, 2);
    bw_write(bw, 0, 4);
    bw_write(bw, (uint32_t)best_k, 4);
    write_rice(bw, scratch, n - order, best_k);
}

long long flac_encode(const int32_t *pcm, long long frames, int channels,
                      int sample_rate, int bps, uint8_t *out, size_t out_cap) {
    if (channels < 1 || channels > MAX_CHANNELS) return -1;
    if (bps < 8 || bps > 24) return -2;
    if (out_cap < 64) return -3;

    const int BLOCK = 4096;

    /* fLaC + STREAMINFO */
    BitWriter bw;
    bw_init(&bw, out, out_cap);
    bw_write(&bw, 0x664C6143u, 32); /* "fLaC" */
    bw_write(&bw, 0x80, 8);  /* last block flag + type 0 */
    bw_write(&bw, 34, 24);   /* STREAMINFO length */
    bw_write(&bw, BLOCK, 16);  /* min blocksize */
    bw_write(&bw, BLOCK, 16);  /* max blocksize */
    bw_write(&bw, 0, 24);      /* min framesize: unknown */
    bw_write(&bw, 0, 24);      /* max framesize: unknown */
    bw_write(&bw, (uint32_t)sample_rate, 20);
    bw_write(&bw, (uint32_t)(channels - 1), 3);
    bw_write(&bw, (uint32_t)(bps - 1), 5);
    bw_write64(&bw, (uint64_t)frames, 36);
    for (int i = 0; i < 16; i++) bw_write(&bw, 0, 8); /* md5: unset */

    static int32_t chan[MAX_CHANNELS][4096];
    static int32_t scratch[4096];

    long long done = 0;
    uint64_t frame_no = 0;
    while (done < frames) {
        int n = (int)((frames - done) < BLOCK ? (frames - done) : BLOCK);
        for (int c = 0; c < channels; c++)
            for (int i = 0; i < n; i++)
                chan[c][i] = pcm[(done + i) * channels + c];

        size_t frame_start = bw.pos;
        if (bw.bit != 0) return -4; /* frames are byte-aligned */

        /* frame header */
        bw_write(&bw, 0x3FFE, 14);
        bw_write(&bw, 0, 1); /* reserved */
        bw_write(&bw, 0, 1); /* fixed blocksize strategy */
        int bs_code = (n == BLOCK) ? 12 /* 4096 */ : 7 /* 16-bit get */;
        bw_write(&bw, (uint32_t)bs_code, 4);
        bw_write(&bw, 0, 4); /* sample rate: from STREAMINFO */
        bw_write(&bw, (uint32_t)(channels - 1), 4); /* independent channels */
        int ss_code = bps == 8 ? 1 : bps == 12 ? 2 : bps == 16 ? 4 :
                      bps == 20 ? 5 : bps == 24 ? 6 : 0;
        bw_write(&bw, (uint32_t)ss_code, 3);
        bw_write(&bw, 0, 1); /* reserved */
        utf8_encode(&bw, frame_no);
        if (bs_code == 7) bw_write(&bw, (uint32_t)(n - 1), 16);
        if (bw.error) return -5;
        bw_write(&bw, crc8(out + frame_start, bw.pos - frame_start), 8);

        for (int c = 0; c < channels; c++)
            encode_subframe(&bw, chan[c], n, bps, scratch);
        bw_align(&bw);
        if (bw.error) return -6;
        bw_write(&bw, crc16(out + frame_start, bw.pos - frame_start), 16);
        if (bw.error) return -7;

        done += n;
        frame_no++;
    }
    bw_align(&bw);
    return (long long)bw.pos;
}
