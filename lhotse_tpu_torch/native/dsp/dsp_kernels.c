/*
 * Fused host-side DSP kernels for the data pipeline.
 *
 * frame_prep: framing + DC removal + pre-emphasis + window + f32->f64 widen
 * in a single pass per frame. This feeds the pocketfft rFFT in the numpy
 * extractor path (lhotse_tpu/features/kaldi/extractors.py). Doing these
 * steps separately in numpy costs ~6 read/write passes over a (T, n_fft)
 * float64 buffer — the dominant memory traffic of host featurization; the
 * fused loop touches each output element exactly once.
 *
 * Semantics mirror the reference Kaldi framing contract
 * (lhotse/features/kaldi/layers.py:727-772): mean computed over the raw
 * frame, energy measured after DC removal, pre-emphasis x[i] -= c*x[i-1]
 * with x[0] pre-emphasized against itself, window applied last.
 *
 * scale_i32_to_f32: PCM int32 -> float32 normalization in one pass
 * (decoders hand back int32; numpy's astype-then-divide is two).
 *
 * C ABI (ctypes, see lhotse_tpu/ops/host_dsp.py):
 *   frame_prep(x, n_samples, length, shift, n_frames, window, coeff,
 *              remove_dc, want_energy, energy_floor_log, out, fft_len,
 *              log_energy_or_null)
 *   scale_i32_to_f32(src, n, scale, dst)
 */
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

void frame_prep(const float *x, long long n_samples, int length, int shift,
                long long n_frames, const double *window, double coeff,
                int remove_dc, int want_energy, double energy_floor_log,
                double *out, int fft_len, double *log_energy) {
    (void)n_samples;
    for (long long f = 0; f < n_frames; f++) {
        const float *src = x + f * (long long)shift;
        double *dst = out + f * (long long)fft_len;

        double mean = 0.0;
        if (remove_dc || want_energy) {
            double acc = 0.0;
            for (int i = 0; i < length; i++) acc += (double)src[i];
            mean = acc / (double)length;
        }
        if (want_energy) {
            double e = 0.0;
            for (int i = 0; i < length; i++) {
                double v = (double)src[i] - mean;
                e += v * v;
            }
            double le = log(e + 1e-15);
            if (energy_floor_log > -HUGE_VAL && le < energy_floor_log)
                le = energy_floor_log;
            log_energy[f] = le;
        }
        double dc = remove_dc ? mean : 0.0;
        if (coeff != 0.0) {
            double first = (double)src[0] - dc;
            dst[0] = (first - coeff * first) * window[0];
            for (int i = 1; i < length; i++) {
                double cur = (double)src[i] - dc;
                double prev = (double)src[i - 1] - dc;
                dst[i] = (cur - coeff * prev) * window[i];
            }
        } else {
            for (int i = 0; i < length; i++)
                dst[i] = ((double)src[i] - dc) * window[i];
        }
        for (int i = length; i < fft_len; i++) dst[i] = 0.0;
    }
}

/*
 * float32 output variant of frame_prep: same per-frame semantics (mean and
 * energy still accumulate in double), but the windowed frames are emitted as
 * float32 for the f32 pocketfft path — half the memory traffic and a ~2-6x
 * faster FFT; the added noise matches the (float32) reference's own floor.
 */
void frame_prep_f32(const float *x, long long n_samples, int length, int shift,
                    long long n_frames, const float *window, double coeff,
                    int remove_dc, int want_energy, double energy_floor_log,
                    float *out, int fft_len, double *log_energy) {
    (void)n_samples;
    for (long long f = 0; f < n_frames; f++) {
        const float *src = x + f * (long long)shift;
        float *dst = out + f * (long long)fft_len;

        double mean = 0.0;
        if (remove_dc || want_energy) {
            double acc = 0.0;
            for (int i = 0; i < length; i++) acc += (double)src[i];
            mean = acc / (double)length;
        }
        if (want_energy) {
            double e = 0.0;
            for (int i = 0; i < length; i++) {
                double v = (double)src[i] - mean;
                e += v * v;
            }
            double le = log(e + 1e-15);
            if (energy_floor_log > -HUGE_VAL && le < energy_floor_log)
                le = energy_floor_log;
            log_energy[f] = le;
        }
        float dc = remove_dc ? (float)mean : 0.0f;
        float c = (float)coeff;
        if (c != 0.0f) {
            float first = src[0] - dc;
            dst[0] = (first - c * first) * window[0];
            for (int i = 1; i < length; i++) {
                float cur = src[i] - dc;
                float prev = src[i - 1] - dc;
                dst[i] = (cur - c * prev) * window[i];
            }
        } else {
            for (int i = 0; i < length; i++)
                dst[i] = (src[i] - dc) * window[i];
        }
        for (int i = length; i < fft_len; i++) dst[i] = 0.0f;
    }
}

void scale_i32_to_f32(const int32_t *src, long long n, float scale, float *dst) {
    for (long long i = 0; i < n; i++) dst[i] = (float)src[i] * scale;
}

/* |X|^2 over interleaved (re, im) float64 pairs — one pass, no temps. */
void power_spectrum_c128(const double *spec, long long n, double *out) {
    for (long long i = 0; i < n; i++) {
        double re = spec[2 * i], im = spec[2 * i + 1];
        out[i] = re * re + im * im;
    }
}

/* |X| over interleaved (re, im) float64 pairs. */
void magnitude_c128(const double *spec, long long n, double *out) {
    for (long long i = 0; i < n; i++) {
        double re = spec[2 * i], im = spec[2 * i + 1];
        out[i] = sqrt(re * re + im * im);
    }
}

/* complex64 variants for the float32 FFT path. */
void power_spectrum_c64(const float *spec, long long n, float *out) {
    for (long long i = 0; i < n; i++) {
        float re = spec[2 * i], im = spec[2 * i + 1];
        out[i] = re * re + im * im;
    }
}

void magnitude_c64(const float *spec, long long n, float *out) {
    for (long long i = 0; i < n; i++) {
        float re = spec[2 * i], im = spec[2 * i + 1];
        out[i] = sqrtf(re * re + im * im);
    }
}

/*
 * Polyphase windowed-sinc resampling for one waveform
 * (lhotse_tpu/augmentation/resample.py builds the kernel; the math matches
 * the reference's tensor resampler, lhotse/augmentation/resample.py:186-315).
 *
 * x is the already-padded input (width zeros left, width + orig right);
 * block t, phase j computes dot(x[t*orig .. +K], kernel[j]). Output is
 * written interleaved as out[t*phases + j] — the natural output sample
 * order — and the caller trims to the exact target length.
 */
void sinc_resample_f32(const float *x, long long num_blocks, const float *kernel,
                       int phases, int K, int orig, float *out) {
    /*
     * Typical speed-perturb ratios give a SMALL kernel (e.g. 1.1x @16 kHz:
     * 11 phases x 24 taps) — per-phase dot products drown in loop overhead.
     * When the whole phase set fits a few SIMD registers, vectorize ACROSS
     * phases instead: transpose the kernel once to kt[i][j] (phases padded
     * to 16) and emit each block's outputs with K broadcast-FMA steps over
     * a register accumulator tile (f32 reassociation vs the serial dot is
     * ~1e-6, inside the resampler parity tolerance).
     */
    if (phases >= 4 && phases <= 32 && K <= 256) {
        int P = (phases + 15) & ~15; /* 16 or 32 lanes */
        /* GCC/clang vector extensions: the auto-vectorizer refuses this
         * shape (short trip counts, accumulator array), so spell out the
         * register tile explicitly. */
        typedef float v16sf __attribute__((vector_size(64), aligned(64)));
        static const v16sf VZERO;
        float kt[256 * 32] __attribute__((aligned(64)));
        for (int i = 0; i < K; i++) {
            for (int j = 0; j < phases; j++)
                kt[(size_t)i * P + j] = kernel[(size_t)j * K + i];
            for (int j = phases; j < P; j++) kt[(size_t)i * P + j] = 0.0f;
        }
        float tmp[64] __attribute__((aligned(64)));
        if (P == 16) {
            /* 4 blocks per sweep: each kernel row is loaded once and feeds
             * 4 accumulator tiles (base pointers orig floats apart) — the
             * short K loop is otherwise bound on kt loads + loop overhead. */
            long long t = 0;
            for (; t + 4 <= num_blocks; t += 4) {
                const float *restrict base = x + t * (long long)orig;
                v16sf a0 = VZERO, a1 = VZERO, a2 = VZERO, a3 = VZERO;
                const float *kr = kt;
                for (int i = 0; i < K; i++, kr += 16) {
                    v16sf kv = *(const v16sf *)kr;
                    a0 += kv * base[i];
                    a1 += kv * base[i + orig];
                    a2 += kv * base[i + 2 * orig];
                    a3 += kv * base[i + 3 * orig];
                }
                *(v16sf *)tmp = a0;
                *(v16sf *)(tmp + 16) = a1;
                *(v16sf *)(tmp + 32) = a2;
                *(v16sf *)(tmp + 48) = a3;
                float *dst = out + t * (long long)phases;
                for (int b = 0; b < 4; b++)
                    for (int j = 0; j < phases; j++)
                        dst[b * phases + j] = tmp[b * 16 + j];
            }
            for (; t < num_blocks; t++) {
                const float *restrict base = x + t * (long long)orig;
                v16sf a0 = VZERO;
                const float *kr = kt;
                for (int i = 0; i < K; i++, kr += 16)
                    a0 += *(const v16sf *)kr * base[i];
                *(v16sf *)tmp = a0;
                float *dst = out + t * (long long)phases;
                for (int j = 0; j < phases; j++) dst[j] = tmp[j];
            }
        } else {
            for (long long t = 0; t < num_blocks; t++) {
                const float *restrict base = x + t * (long long)orig;
                v16sf a0 = VZERO, a1 = VZERO;
                const float *kr = kt;
                for (int i = 0; i < K; i++, kr += 32) {
                    float b = base[i];
                    a0 += *(const v16sf *)kr * b;
                    a1 += *(const v16sf *)(kr + 16) * b;
                }
                *(v16sf *)tmp = a0;
                *(v16sf *)(tmp + 16) = a1;
                float *dst = out + t * (long long)phases;
                for (int j = 0; j < phases; j++) dst[j] = tmp[j];
            }
        }
        return;
    }
    for (long long t = 0; t < num_blocks; t++) {
        const float *base = x + t * (long long)orig;
        float *dst = out + t * (long long)phases;
        for (int j = 0; j < phases; j++) {
            const float *k = kernel + (size_t)j * K;
            /* 8 independent accumulators: the strict-FP serial add chain
             * otherwise blocks vectorization of the dot product. */
            float acc[8] = {0};
            int i = 0;
            for (; i + 8 <= K; i += 8)
                for (int u = 0; u < 8; u++) acc[u] += base[i + u] * k[i + u];
            float s = 0.0f;
            for (int u = 0; u < 8; u++) s += acc[u];
            for (; i < K; i++) s += base[i] * k[i];
            dst[j] = s;
        }
    }
}

/* ========================================================================
 * Fully fused log-mel filterbank (the host featurization hot loop).
 *
 * One pass per tile of FBV frames: framing + DC removal + pre-emphasis +
 * window (same per-frame contract as frame_prep above, i.e. reference
 * lhotse/features/kaldi/layers.py:727-772) -> real FFT -> |X|^2 (or |X|)
 * -> sparse triangular mel projection -> clamp -> log. The FFT is a
 * radix-2 complex FFT of fft_len/2 points vectorized ACROSS the FBV
 * frames of the tile (every butterfly is a vertical SIMD op over the lane
 * axis; the half-size-complex trick recovers the real spectrum), so the
 * whole tile - zre/zim/power buffers - stays L1/L2-resident from the
 * waveform read to the (n_frames, n_mels) output write. The separate
 * numpy path materializes ~5 (T, n_fft) intermediates through DRAM; this
 * touches DRAM once for the input and once for the output.
 *
 * The log uses an atanh-series polynomial (|rel err| < 1e-6, far inside
 * the 1e-4 feature-parity budget; goldens pin it). Mel rows are visited
 * through per-row [lo, hi) support bounds supplied by the caller, since
 * Kaldi triangular filters give each FFT bin at most two owners.
 *
 * Returns 0 on success; 1 when fft_len is not a supported power of two
 * (caller falls back to the numpy path).
 * ====================================================================== */

#ifndef FBV
#define FBV 64 /* frames per tile: 4 AVX-512 zmms of f32 per vector op — wide
                  enough to amortize butterfly/loop overheads (measured best
                  among 4/8/16/32/64/128 on a 48K-L1/2M-L2 host), small
                  enough that tail-tile waste stays a few %% per item. */
#endif

static inline float fbank_fast_logf(float x) {
    /* ln(x) for x > 0 via exponent split + atanh series on [sqrt(.5), sqrt(2)). */
    union { float f; uint32_t u; } v;
    v.f = x;
    int e = (int)(v.u >> 23) - 127;
    v.u = (v.u & 0x007FFFFFu) | 0x3F800000u; /* mantissa in [1, 2) */
    float m = v.f;
    int adj = m > 1.41421356f;
    m = adj ? m * 0.5f : m;
    e += adj;
    float t = (m - 1.0f) / (m + 1.0f);
    float t2 = t * t;
    float p = 2.0f * t *
              (1.0f + t2 * (0.33333334f +
                            t2 * (0.19999999f +
                                  t2 * (0.14285715f + t2 * 0.11111111f))));
    return p + 0.69314718f * (float)e;
}

int fbank_fused_f32(const float *x, long long n_samples, long long pad_left,
                    int length, int shift, long long n_frames,
                    const float *window, double coeff, int remove_dc,
                    int fft_len, int use_mag, const float *mel_t,
                    const int32_t *mel_lo, const int32_t *mel_hi, int n_mels,
                    float log_floor, int want_energy, double energy_floor_log,
                    float *out, double *log_energy) {
    int n2 = fft_len >> 1;
    if (n2 < 4 || (n2 & (n2 - 1)) != 0 || fft_len > 4096 || length > fft_len)
        return 1;
    /* Virtual snip_edges=False edge padding (reference layers.py:744-764):
     * frame f covers padded positions [f*shift, f*shift+length), where
     * padded = reverse(x[:pad_left]) + x + reverse(tail). Interior frames
     * read x directly; only boundary frames materialize the reflect map.
     * Requires at least one full frame of real samples; shorter items (or
     * deeper pads) must be padded by the caller (pad_left == 0 then). */
    if (pad_left > 0 && (pad_left >= n_samples || length > n_samples))
        return 1;
    int stages = 0;
    while ((1 << stages) < n2) stages++;
    int n_bins = n2 + 1;

    /* Scratch: twiddles + unpack twiddles + bitrev + lane buffers. */
    size_t floats = (size_t)(n2 / 2) * 2   /* twr, twi */
                  + (size_t)(n_bins) * 2   /* ur, ui */
                  + (size_t)n2 * FBV * 2   /* zre, zim */
                  + (size_t)n_bins * FBV   /* pw */
                  + (size_t)n_mels * FBV   /* mbuf */
                  + (size_t)length * FBV;  /* bfr (boundary frames) */
    float *mem = (float *)malloc(floats * sizeof(float) + (size_t)n2 * sizeof(int32_t));
    if (!mem) return 2;
    float *twr = mem, *twi = twr + n2 / 2;
    float *ur = twi + n2 / 2, *ui = ur + n_bins;
    float *zre = ui + n_bins, *zim = zre + (size_t)n2 * FBV;
    float *pw = zim + (size_t)n2 * FBV;
    float *mbuf = pw + (size_t)n_bins * FBV;
    float *bfr = mbuf + (size_t)n_mels * FBV;
    int32_t *bitrev = (int32_t *)(bfr + (size_t)length * FBV);

    for (int t = 0; t < n2 / 2; t++) {
        double a = -2.0 * 3.14159265358979323846 * (double)t / (double)n2;
        twr[t] = (float)cos(a);
        twi[t] = (float)sin(a);
    }
    for (int k = 0; k < n_bins; k++) {
        double a = -3.14159265358979323846 * (double)k / (double)n2;
        ur[k] = (float)cos(a);
        ui[k] = (float)sin(a);
    }
    for (int i = 0; i < n2; i++) {
        int r = 0;
        for (int b = 0; b < stages; b++) r = (r << 1) | ((i >> b) & 1);
        bitrev[i] = r;
    }

    float c = (float)coeff;
    for (long long f0 = 0; f0 < n_frames; f0 += FBV) {
        int nv = (int)((n_frames - f0 < FBV) ? (n_frames - f0) : FBV);
        const float *src[FBV];
        float dc[FBV];
        for (int v = 0; v < FBV; v++) {
            /* Clamp tail lanes to the last frame: harmless recompute. */
            long long f = f0 + ((v < nv) ? v : (nv - 1));
            long long start = f * (long long)shift - pad_left;
            if (start >= 0 && start + length <= n_samples) {
                src[v] = x + start;
            } else {
                /* Boundary frame: materialize the reflect map once. */
                float *b = bfr + (size_t)v * length;
                for (int i = 0; i < length; i++) {
                    long long p = start + i;
                    if (p < 0) p = -1 - p;
                    else if (p >= n_samples) p = 2 * n_samples - 1 - p;
                    b[i] = x[p];
                }
                src[v] = b;
            }
        }
        for (int v = 0; v < FBV; v++) {
            double mean = 0.0;
            if (remove_dc || want_energy) {
                /* 8 independent accumulators: breaks the serial f64 add
                 * chain so the reduction vectorizes; f64 keeps long-frame
                 * drift out (order change vs a linear sum is ~1e-16). */
                double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                const float *s = src[v];
                int i = 0;
                for (; i + 8 <= length; i += 8)
                    for (int u = 0; u < 8; u++) acc[u] += (double)s[i + u];
                for (int u = 0; u < 8; u++) mean += acc[u];
                for (; i < length; i++) mean += (double)s[i];
                mean /= (double)length;
            }
            if (want_energy && v < nv) {
                double eacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                const float *s = src[v];
                int i = 0;
                for (; i + 8 <= length; i += 8)
                    for (int u = 0; u < 8; u++) {
                        double d = (double)s[i + u] - mean;
                        eacc[u] += d * d;
                    }
                double e = 0.0;
                for (int u = 0; u < 8; u++) e += eacc[u];
                for (; i < length; i++) {
                    double d = (double)s[i] - mean;
                    e += d * d;
                }
                double le = log(e + 1e-15);
                if (energy_floor_log > -HUGE_VAL && le < energy_floor_log)
                    le = energy_floor_log;
                log_energy[f0 + v] = le;
            }
            dc[v] = remove_dc ? (float)mean : 0.0f;
        }

        /* Bit-reversed load with framing/DC/pre-emphasis/window fused in:
         * complex point i takes samples (2j, 2j+1), j = bitrev[i]. */
        for (int i = 0; i < n2; i++) {
            int j = bitrev[i];
            for (int half = 0; half < 2; half++) {
                int p = 2 * j + half;
                float *restrict dst = (half ? zim : zre) + (size_t)i * FBV;
                if (p >= length) {
                    for (int v = 0; v < FBV; v++) dst[v] = 0.0f;
                    continue;
                }
                float wv = window[p];
                int pp = p ? p - 1 : p;
                for (int v = 0; v < FBV; v++) {
                    const float *s = src[v];
                    float cur = s[p] - dc[v];
                    float prev = s[pp] - dc[v];
                    dst[v] = (cur - c * prev) * wv;
                }
            }
        }

        /* Radix-2 DIT complex FFT of n2 points, vector over lanes.
         * Stage 1 (twiddle == 1) is a pure add/sub sweep over the whole
         * tile buffer - one contiguous vectorized pass. */
        for (int k0 = 0; k0 < n2; k0 += 2) {
            float *restrict are = zre + (size_t)k0 * FBV;
            float *restrict aim = zim + (size_t)k0 * FBV;
            for (int v = 0; v < FBV; v++) {
                float tr = are[FBV + v], ti = aim[FBV + v];
                are[FBV + v] = are[v] - tr;
                aim[FBV + v] = aim[v] - ti;
                are[v] = are[v] + tr;
                aim[v] = aim[v] + ti;
            }
        }
        for (int s = 2; s <= stages; s++) {
            int m = 1 << s, mh = m >> 1;
            int tstep = n2 >> s;
            for (int k0 = 0; k0 < n2; k0 += m) {
                for (int j = 0; j < mh; j++) {
                    float wr = twr[j * tstep], wi = twi[j * tstep];
                    float *restrict are = zre + (size_t)(k0 + j) * FBV;
                    float *restrict aim = zim + (size_t)(k0 + j) * FBV;
                    float *restrict bre = zre + (size_t)(k0 + j + mh) * FBV;
                    float *restrict bim = zim + (size_t)(k0 + j + mh) * FBV;
                    for (int v = 0; v < FBV; v++) {
                        float tr = wr * bre[v] - wi * bim[v];
                        float ti = wr * bim[v] + wi * bre[v];
                        bre[v] = are[v] - tr;
                        bim[v] = aim[v] - ti;
                        are[v] = are[v] + tr;
                        aim[v] = aim[v] + ti;
                    }
                }
            }
        }

        /* Real-spectrum unpack + |X|^2 (or |X|):
         * X[k] = Fe[k] + e^{-i pi k / n2} Fo[k],
         * Fe = (Z[k]+conj(Z[n2-k]))/2, Fo = -i(Z[k]-conj(Z[n2-k]))/2. */
        int mask = n2 - 1;
        for (int k = 0; k < n_bins; k++) {
            int k1 = k & mask, k2 = (n2 - k) & mask;
            float cr = ur[k], ci = ui[k];
            const float *restrict zr1 = zre + (size_t)k1 * FBV;
            const float *restrict zi1 = zim + (size_t)k1 * FBV;
            const float *restrict zr2 = zre + (size_t)k2 * FBV;
            const float *restrict zi2 = zim + (size_t)k2 * FBV;
            float *restrict pk = pw + (size_t)k * FBV;
            for (int v = 0; v < FBV; v++) {
                float fer = 0.5f * (zr1[v] + zr2[v]);
                float fei = 0.5f * (zi1[v] - zi2[v]);
                float for_ = 0.5f * (zi1[v] + zi2[v]);
                float foi = 0.5f * (zr2[v] - zr1[v]);
                float xr = fer + cr * for_ - ci * foi;
                float xi = fei + cr * foi + ci * for_;
                pk[v] = xr * xr + xi * xi;
            }
        }
        if (use_mag) {
            for (int k = 0; k < n_bins; k++) {
                float *restrict pk = pw + (size_t)k * FBV;
                for (int v = 0; v < FBV; v++) pk[v] = sqrtf(pk[v]);
            }
        }

        /* Sparse mel projection into the lane-major tile buffer... */
        for (int m_ = 0; m_ < n_mels; m_++) {
            const float *restrict wrow = mel_t + (size_t)m_ * n_bins;
            int lo = mel_lo[m_], hi = mel_hi[m_];
            float *restrict acc = mbuf + (size_t)m_ * FBV;
            for (int v = 0; v < FBV; v++) acc[v] = 0.0f;
            for (int k = lo; k < hi; k++) {
                float w = wrow[k];
                const float *restrict pk = pw + (size_t)k * FBV;
                for (int v = 0; v < FBV; v++) acc[v] += w * pk[v];
            }
        }
        /* ...one flat clamp+log pass (contiguous, branchless select)... */
        for (int i = 0; i < n_mels * FBV; i++) {
            float a = mbuf[i] < log_floor ? log_floor : mbuf[i];
            mbuf[i] = fbank_fast_logf(a);
        }
        /* ...then the frame-major transpose write (contiguous per lane). */
        for (int v = 0; v < nv; v++) {
            float *restrict dst = out + (size_t)(f0 + v) * n_mels;
            for (int m_ = 0; m_ < n_mels; m_++) dst[m_] = mbuf[(size_t)m_ * FBV + v];
        }
    }
    free(mem);
    return 0;
}

/* ------------------------------------------------------------------------- */
/* Wire-format encoders (ops/wire.py host side).                             */
/*                                                                           */
/* adpcm4_encode_f32 mirrors the numpy reference encoder in ops/wire.py      */
/* BIT-EXACTLY (same rint quantization, same integer update path), so the    */
/* two paths are interchangeable and the device decoder sees identical       */
/* bitstreams either way. 64-sample independent blocks, 4-byte header        */
/* (pred0 int16 LE + step index + reserved), low-nibble-first packing.       */
/* ------------------------------------------------------------------------- */

static const int ima_steps[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};
static const int ima_index[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

void adpcm4_encode_f32(const float *x, long long n_rows, long long T,
                       unsigned char *out) {
    const long long nb = T / 64;
    const long long W = nb * 4 + T / 2;
    /* Tile 16 blocks: the t-loop body is branchless int32 ops across the
     * k (block) lanes, so the compiler vectorizes it (AVX2/AVX-512). */
    enum { TILE = 16 };
    for (long long r = 0; r < n_rows; ++r) {
        const float *row = x + r * T;
        unsigned char *orow = out + r * W;
        for (long long b0 = 0; b0 < nb; b0 += TILE) {
            const int w = (int)(nb - b0 < TILE ? nb - b0 : TILE);
            int sq[64][TILE]; /* transposed quantized samples */
            for (int k = 0; k < w; ++k) {
                const float *blk = row + (b0 + k) * 64;
                for (int t = 0; t < 64; ++t) {
                    /* np.rint == round-half-to-even == lrintf default. */
                    long q = lrintf(blk[t] * 32768.0f);
                    if (q < -32768) q = -32768;
                    else if (q > 32767) q = 32767;
                    sq[t][k] = (int)q;
                }
            }
            int pred[TILE], idx[TILE];
            for (int k = 0; k < w; ++k) {
                long long dsum = 0;
                for (int t = 1; t < 64; ++t) {
                    int d = sq[t][k] - sq[t - 1][k];
                    dsum += d < 0 ? -d : d;
                }
                const double dmean = (double)dsum / 63.0;
                int i = 0; /* searchsorted-left over the step table */
                while (i < 89 && (double)ima_steps[i] < dmean) i++;
                idx[k] = i > 88 ? 88 : i;
                pred[k] = sq[0][k];
                unsigned char *hdr = orow + (b0 + k) * 4;
                hdr[0] = (unsigned char)(pred[k] & 0xFF);
                hdr[1] = (unsigned char)((pred[k] >> 8) & 0xFF);
                hdr[2] = (unsigned char)idx[k];
                hdr[3] = 0;
            }
            unsigned char codes[64][TILE];
            for (int t = 0; t < 64; ++t) {
                for (int k = 0; k < w; ++k) { /* branchless lanes */
                    const int step = ima_steps[idx[k]];
                    int diff = sq[t][k] - pred[k];
                    const int sgn = diff < 0;
                    diff = sgn ? -diff : diff;
                    const int b4 = diff >= step;
                    diff -= step & -b4;
                    const int half = step >> 1;
                    const int b2 = diff >= half;
                    diff -= half & -b2;
                    const int b1 = diff >= (step >> 2);
                    const int mag = (b4 << 2) | (b2 << 1) | b1;
                    const int diffq = (step >> 3) + (step & -b4) +
                                      (half & -b2) + ((step >> 2) & -b1);
                    int p = pred[k] + (sgn ? -diffq : diffq);
                    if (p < -32768) p = -32768;
                    else if (p > 32767) p = 32767;
                    pred[k] = p;
                    int i = idx[k] + ima_index[mag];
                    if (i < 0) i = 0;
                    else if (i > 88) i = 88;
                    idx[k] = i;
                    codes[t][k] = (unsigned char)((sgn << 3) | mag);
                }
            }
            for (int k = 0; k < w; ++k) {
                unsigned char *pk = orow + nb * 4 + (b0 + k) * 32;
                for (int t = 0; t < 64; t += 2)
                    pk[t >> 1] =
                        (unsigned char)(codes[t][k] | (codes[t + 1][k] << 4));
            }
        }
    }
}

/* Quantize to the int16 grid and look the mu-law byte up in a table the
 * caller built with the exact continuous-formula encoder (ops/wire.py). */
void mulaw_encode_lut_f32(const float *x, long long n,
                          const unsigned char *lut, unsigned char *out) {
    for (long long i = 0; i < n; ++i) {
        long q = lrintf(x[i] * 32768.0f);
        if (q < -32768) q = -32768;
        else if (q > 32767) q = 32767;
        out[i] = lut[q + 32768];
    }
}
