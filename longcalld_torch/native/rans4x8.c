/* rANS 4x8 codec (CRAM 3.0 block compression method 4).
 *
 * Implements the byte-oriented 4-way interleaved range-ANS coder defined by
 * the CRAM 3.0 specification (frequencies normalised to 4096, renorm bound
 * 1<<23, order-0 and order-1 contexts).  Independent implementation written
 * against the format description; used by longcalld_torch.io.cram via ctypes.
 *
 * Build: gcc -O2 -shared -fPIC rans4x8.c -o _rans4x8.so
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define TF_SHIFT 12
#define TOTFREQ (1u << TF_SHIFT)
#define RANS_L (1u << 23)

/* ---------------- frequency table helpers ---------------- */

/* read one frequency (1 byte if <128 else 2 bytes with top bit set) */
static inline uint32_t get_freq(const uint8_t **cp) {
    uint32_t f = *(*cp)++;
    if (f >= 128) {
        f = ((f & 127) << 8) | *(*cp)++;
    }
    return f;
}

static inline void put_freq(uint8_t **cp, uint32_t f) {
    if (f < 128) {
        *(*cp)++ = f;
    } else {
        *(*cp)++ = 128 | (f >> 8);
        *(*cp)++ = f & 0xff;
    }
}

/* Symbol-RLE frequency table walk (per the spec's decoder): j = first
 * symbol; loop { read freq; if in a run, j++; else if next byte == j+1 it
 * starts a run (symbol byte + run-length byte); else j = next symbol byte
 * (0 terminates) }. */
static int read_freq_table2(const uint8_t **cp, uint32_t *freq,
                            uint32_t *cum) {
    memset(freq, 0, 256 * sizeof(*freq));
    int j = *(*cp)++, rle = 0;
    do {
        freq[j] = get_freq(cp);
        if (!rle && j + 1 == **cp) {
            j = *(*cp)++;
            rle = *(*cp)++;
        } else if (rle) {
            rle--;
            j++;
        } else {
            j = *(*cp)++;
        }
    } while (j);
    uint32_t c = 0;
    for (int i = 0; i < 256; i++) {
        cum[i] = c;
        c += freq[i];
    }
    cum[256] = c;
    return c <= TOTFREQ ? 0 : -1;
}

/* Write table in the same RLE format. */
static void write_freq_table(uint8_t **cp, const uint32_t *freq) {
    int rle = 0;
    for (int x = 0; x < 256; x++) {
        if (!freq[x]) continue;
        if (rle) {
            rle--;
        } else {
            *(*cp)++ = x;
            if (x && freq[x - 1]) {
                for (rle = x + 1; rle < 256 && freq[rle]; rle++)
                    ;
                rle -= x + 1;
                *(*cp)++ = rle;
            }
        }
        put_freq(cp, freq[x]);
    }
    *(*cp)++ = 0;
}

static void normalise(uint32_t *freq, uint64_t total) {
    if (total == 0) return;
    uint32_t max_i = 0, sum = 0;
    for (int i = 0; i < 256; i++) {
        if (freq[i] == 0) continue;
        uint64_t f = (uint64_t)freq[i] * (TOTFREQ - 256) / total + 1;
        freq[i] = (uint32_t)f;
        sum += freq[i];
        if (freq[i] > freq[max_i]) max_i = i;
    }
    /* fix rounding so the total is exactly TOTFREQ */
    int32_t adjust = (int32_t)TOTFREQ - (int32_t)sum;
    freq[max_i] += adjust;
}

/* ---------------- order-0 ---------------- */

typedef struct {
    uint32_t state;
} rans_t;

static inline void renorm_dec(uint32_t *R, const uint8_t **ptr,
                              const uint8_t *end) {
    while (*R < RANS_L && *ptr < end) *R = (*R << 8) | *(*ptr)++;
}

/* decode order-0: in -> out (caller sizes from the rans header).
 * in points at the freq table (after order/sizes header). */
int rans_decode0(const uint8_t *in, int64_t in_sz, uint8_t *out,
                 int64_t out_sz) {
    uint32_t freq[256], cum[257];
    const uint8_t *cp = in, *end = in + in_sz;
    if (read_freq_table2(&cp, freq, cum) != 0) return -1;
    uint8_t s_of[TOTFREQ];
    for (int s = 0; s < 256; s++)
        for (uint32_t k = cum[s]; k < cum[s] + freq[s] && k < TOTFREQ; k++)
            s_of[k] = (uint8_t)s;
    uint32_t R[4];
    for (int j = 0; j < 4; j++) {
        if (cp + 4 > end) return -1;
        R[j] = (uint32_t)cp[0] | ((uint32_t)cp[1] << 8) |
               ((uint32_t)cp[2] << 16) | ((uint32_t)cp[3] << 24);
        cp += 4;
    }
    for (int64_t i = 0; i < out_sz; i++) {
        int j = i & 3;
        uint32_t m = R[j] & (TOTFREQ - 1);
        uint8_t s = s_of[m];
        out[i] = s;
        R[j] = freq[s] * (R[j] >> TF_SHIFT) + m - cum[s];
        renorm_dec(&R[j], &cp, end);
    }
    return 0;
}

/* encode order-0; out must have room (worst case ~ in_sz*2 + 1024).
 * Writes only the table+stream (no 9-byte rans header).  Returns size. */
int64_t rans_encode0(const uint8_t *in, int64_t in_sz, uint8_t *out) {
    uint32_t freq[256];
    memset(freq, 0, sizeof(freq));
    for (int64_t i = 0; i < in_sz; i++) freq[in[i]]++;
    if (in_sz == 0) {
        uint8_t *cp = out;
        /* empty: table with single symbol 0 freq TOTFREQ */
        freq[0] = TOTFREQ;
        write_freq_table(&cp, freq);
        for (int j = 0; j < 4; j++) {
            uint32_t R = RANS_L;
            *cp++ = R & 0xff; *cp++ = (R >> 8) & 0xff;
            *cp++ = (R >> 16) & 0xff; *cp++ = (R >> 24) & 0xff;
        }
        return cp - out;
    }
    normalise(freq, (uint64_t)in_sz);
    uint32_t cum[257], c = 0;
    for (int i = 0; i < 256; i++) {
        cum[i] = c;
        c += freq[i];
    }
    cum[256] = c;
    uint8_t *cp = out;
    write_freq_table(&cp, freq);
    /* encode backwards into a scratch buffer */
    int64_t cap = in_sz + 1024;
    uint8_t *buf = (uint8_t *)malloc(cap);
    uint8_t *bp = buf + cap;
    uint32_t R[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
    for (int64_t i = in_sz - 1; i >= 0; i--) {
        int j = i & 3;
        uint8_t s = in[i];
        uint32_t f = freq[s];
        /* renorm */
        uint32_t x_max = ((RANS_L >> TF_SHIFT) << 8) * f;
        while (R[j] >= x_max) {
            *--bp = R[j] & 0xff;
            R[j] >>= 8;
        }
        R[j] = ((R[j] / f) << TF_SHIFT) + (R[j] % f) + cum[s];
    }
    for (int j = 3; j >= 0; j--) {
        *--bp = (R[j] >> 24) & 0xff;
        *--bp = (R[j] >> 16) & 0xff;
        *--bp = (R[j] >> 8) & 0xff;
        *--bp = R[j] & 0xff;
    }
    int64_t n = buf + cap - bp;
    memcpy(cp, bp, n);
    free(buf);
    return (cp - out) + n;
}

/* ---------------- order-1 ---------------- */

/* encode order-1 (4 states over contiguous quarters, context = previous
 * byte, context 0 at each quarter start).  Returns output size. */
int64_t rans_encode1(const uint8_t *in, int64_t in_sz, uint8_t *out) {
    if (in_sz < 4) return -1; /* caller should use order-0 */
    uint32_t (*freq)[256] = calloc(256, sizeof(*freq));
    uint64_t *tot = calloc(256, sizeof(*tot));
    uint32_t (*cum)[257] = calloc(256, sizeof(*cum));
    if (!freq || !tot || !cum) { free(freq); free(tot); free(cum); return -1; }
    int64_t isz4 = in_sz >> 2;
    uint8_t last = 0;
    for (int64_t i = 0; i < in_sz; i++) {
        freq[last][in[i]]++;
        tot[last]++;
        last = in[i];
    }
    for (int j = 1; j < 4; j++) { /* quarter starts decode with context 0 */
        freq[0][in[j * isz4]]++;
        tot[0]++;
    }
    for (int c = 0; c < 256; c++) {
        if (!tot[c]) continue;
        normalise(freq[c], tot[c]);
        uint32_t s = 0;
        for (int i = 0; i < 256; i++) {
            cum[c][i] = s;
            s += freq[c][i];
        }
        cum[c][256] = s;
    }
    /* serialize context tables (outer symbol-RLE over contexts) */
    uint8_t *cp = out;
    int rle_i = 0;
    for (int c = 0; c < 256; c++) {
        if (!tot[c]) continue;
        if (rle_i) {
            rle_i--;
        } else {
            *cp++ = c;
            if (c && tot[c - 1]) {
                for (rle_i = c + 1; rle_i < 256 && tot[rle_i]; rle_i++)
                    ;
                rle_i -= c + 1;
                *cp++ = rle_i;
            }
        }
        write_freq_table(&cp, freq[c]);
    }
    *cp++ = 0;
    /* encode backwards; emission order must be the exact reverse of the
     * decoder's (k ascending, j ascending; state-3 tail decoded last) */
    int64_t cap = in_sz * 2 + 4096;
    uint8_t *buf = malloc(cap);
    uint8_t *bp = buf + cap;
    uint32_t R[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
    int64_t iN[4];
    for (int j = 0; j < 4; j++) iN[j] = (j + 1) * isz4 - 1;
    iN[3] = in_sz - 1;
    /* state-3 remainder (bytes beyond 4*isz4) */
    while (iN[3] > 4 * isz4 - 1) {
        uint8_t s = in[iN[3]];
        uint8_t c = (iN[3] > 3 * isz4) ? in[iN[3] - 1] : 0;
        uint32_t f = freq[c][s];
        uint32_t x_max = ((RANS_L >> TF_SHIFT) << 8) * f;
        while (R[3] >= x_max) { *--bp = R[3] & 0xff; R[3] >>= 8; }
        R[3] = ((R[3] / f) << TF_SHIFT) + (R[3] % f) + cum[c][s];
        iN[3]--;
    }
    for (int64_t k = isz4 - 1; k >= 0; k--) {
        for (int j = 3; j >= 0; j--) {
            uint8_t s = in[iN[j]];
            uint8_t c = (iN[j] > j * isz4) ? in[iN[j] - 1] : 0;
            uint32_t f = freq[c][s];
            uint32_t x_max = ((RANS_L >> TF_SHIFT) << 8) * f;
            while (R[j] >= x_max) { *--bp = R[j] & 0xff; R[j] >>= 8; }
            R[j] = ((R[j] / f) << TF_SHIFT) + (R[j] % f) + cum[c][s];
            iN[j]--;
        }
    }
    for (int j = 3; j >= 0; j--) {
        *--bp = (R[j] >> 24) & 0xff;
        *--bp = (R[j] >> 16) & 0xff;
        *--bp = (R[j] >> 8) & 0xff;
        *--bp = R[j] & 0xff;
    }
    int64_t n = buf + cap - bp;
    memcpy(cp, bp, n);
    int64_t total = (cp - out) + n;
    free(buf); free(freq); free(tot); free(cum);
    return total;
}

int rans_decode1(const uint8_t *in, int64_t in_sz, uint8_t *out,
                 int64_t out_sz) {
    /* context tables: outer symbol-RLE over contexts, inner full tables */
    uint32_t (*freq)[256] = calloc(256, sizeof(*freq));
    uint32_t (*cum)[257] = calloc(256, sizeof(*cum));
    uint8_t (*s_of)[TOTFREQ] = malloc(256 * TOTFREQ);
    if (!freq || !cum || !s_of) { free(freq); free(cum); free(s_of); return -1; }
    const uint8_t *cp = in, *end = in + in_sz;
    int i = *cp++, rle_i = 0;
    do {
        if (read_freq_table2(&cp, freq[i], cum[i]) != 0) goto err;
        for (int s = 0; s < 256; s++)
            for (uint32_t k = cum[i][s];
                 k < cum[i][s] + freq[i][s] && k < TOTFREQ; k++)
                s_of[i][k] = (uint8_t)s;
        if (!rle_i && i + 1 == *cp) {
            i = *cp++;
            rle_i = *cp++;
        } else if (rle_i) {
            rle_i--;
            i++;
        } else {
            i = *cp++;
        }
    } while (i);

    {
        uint32_t R[4];
        for (int j = 0; j < 4; j++) {
            if (cp + 4 > end) goto err;
            R[j] = (uint32_t)cp[0] | ((uint32_t)cp[1] << 8) |
                   ((uint32_t)cp[2] << 16) | ((uint32_t)cp[3] << 24);
            cp += 4;
        }
        int64_t isz4 = out_sz >> 2;
        int64_t i4[4] = {0, isz4, 2 * isz4, 3 * isz4};
        uint8_t last[4] = {0, 0, 0, 0};
        for (int64_t k = 0; k < isz4; k++) {
            for (int j = 0; j < 4; j++) {
                uint32_t m = R[j] & (TOTFREQ - 1);
                uint8_t c8 = s_of[last[j]][m];
                out[i4[j]] = c8;
                R[j] = freq[last[j]][c8] * (R[j] >> TF_SHIFT) + m -
                       cum[last[j]][c8];
                renorm_dec(&R[j], &cp, end);
                last[j] = c8;
                i4[j]++;
            }
        }
        /* remainder with state 3 */
        for (; i4[3] < out_sz; i4[3]++) {
            uint32_t m = R[3] & (TOTFREQ - 1);
            uint8_t c8 = s_of[last[3]][m];
            out[i4[3]] = c8;
            R[3] = freq[last[3]][c8] * (R[3] >> TF_SHIFT) + m -
                   cum[last[3]][c8];
            renorm_dec(&R[3], &cp, end);
            last[3] = c8;
        }
    }
    free(freq); free(cum); free(s_of);
    return 0;
err:
    free(freq); free(cum); free(s_of);
    return -1;
}
