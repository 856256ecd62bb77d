/* rANS Nx16 codec (CRAM 3.1 block compression method 5).
 *
 * Independent implementation of the rANS Nx16 format from the CRAM
 * compression-codecs specification: 32-bit states with 16-bit
 * renormalisation, 4- or 32-way interleave, order-0/1 contexts
 * (order-1 with a 10- or 12-bit frequency shift and optionally
 * compressed tables), and the PACK / RLE / CAT / STRIPE / NOSZ
 * byte-stream transforms.  Decode supports every flag combination;
 * encode covers ORDER 0/1, N32, PACK and CAT (what our writer emits).
 * Used by longcalld_torch.io.cram via ctypes (the htslib role of
 * rANS_static4x16pr).
 *
 * Build: gcc -O2 -shared -fPIC ransnx16.c -o _ransnx16.so
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define RNX_ORDER1 0x01
#define RNX_N32    0x04
#define RNX_STRIPE 0x08
#define RNX_NOSZ   0x10
#define RNX_CAT    0x20
#define RNX_RLE    0x40
#define RNX_PACK   0x80

#define RANS_L (1u << 15)      /* lower renorm bound; 16-bit chunks */

/* ---------------- varint (uint7: 7 bits per byte, MSB-first) ----------- */

static int64_t get_u7(const uint8_t **cp, const uint8_t *end) {
    int64_t v = 0;
    for (int i = 0; i < 9; i++) {
        if (*cp >= end) return -1;
        uint8_t b = *(*cp)++;
        v = (v << 7) | (b & 0x7f);
        if (!(b & 0x80)) return v;
    }
    return -1;
}

static void put_u7(uint8_t **cp, uint64_t v) {
    uint8_t tmp[10];
    int n = 0;
    do {
        tmp[n++] = v & 0x7f;
        v >>= 7;
    } while (v);
    while (n > 1) *(*cp)++ = tmp[--n] | 0x80;
    *(*cp)++ = tmp[0];
}

/* ---------------- alphabet (symbol-RLE walk, as in rANS 4x8) ----------- */

static int read_alphabet(const uint8_t **cp, const uint8_t *end,
                         uint8_t *A, int *n_sym) {
    int n = 0, rle = 0;
    if (*cp >= end) return -1;
    int sym = *(*cp)++, last = -2;
    do {
        if (n >= 256) return -1;
        A[n++] = (uint8_t)sym;
        if (rle > 0) {
            rle--;
            last = sym;
            sym++;
        } else {
            last = sym;
            if (*cp >= end) return -1;
            sym = *(*cp)++;
            if (sym == last + 1) {
                if (*cp >= end) return -1;
                rle = *(*cp)++;
            }
        }
    } while (sym != 0);
    *n_sym = n;
    return 0;
}

static void write_alphabet(uint8_t **cp, const uint32_t *present) {
    int rle = 0;
    for (int x = 0; x < 256; x++) {
        if (!present[x]) continue;
        if (rle) {
            rle--;
        } else {
            *(*cp)++ = (uint8_t)x;
            if (x && present[x - 1]) {
                for (rle = x + 1; rle < 256 && present[rle]; rle++)
                    ;
                rle -= x + 1;
                *(*cp)++ = (uint8_t)rle;
            }
        }
    }
    *(*cp)++ = 0;
}

/* scale freqs (over the A alphabet) so they sum exactly to 1<<bits */
static void normalise(uint32_t *F, const uint8_t *A, int n_sym, int bits) {
    uint64_t tot = 0;
    uint32_t target = 1u << bits;
    for (int i = 0; i < n_sym; i++) tot += F[A[i]];
    if (tot == 0 || tot == target) return;
    int max_i = -1;
    uint64_t sum = 0;
    for (int i = 0; i < n_sym; i++) {
        uint8_t s = A[i];
        if (!F[s]) continue;
        uint64_t f = (uint64_t)F[s] * (target - n_sym) / tot + 1;
        F[s] = (uint32_t)f;
        sum += f;
        if (max_i < 0 || F[s] > F[A[max_i]]) max_i = i;
    }
    F[A[max_i]] += (uint32_t)(target - sum);
}

/* ---------------- rANS core ---------------- */

static inline void dec_renorm(uint32_t *R, const uint8_t **cp,
                              const uint8_t *end) {
    if (*R < RANS_L && *cp + 1 < end + 1) {
        if (*cp + 2 <= end) {
            *R = (*R << 16) | ((uint32_t)(*cp)[0] | ((uint32_t)(*cp)[1] << 8));
            *cp += 2;
        }
    }
}

static inline void enc_put(uint32_t *R, uint8_t **bp, uint32_t freq,
                           uint32_t cum, int shift) {
    uint32_t x_max = ((RANS_L >> shift) << 16) * freq;
    while (*R >= x_max) {
        *--(*bp) = (*R >> 8) & 0xff;
        *--(*bp) = *R & 0xff;
        *R >>= 16;
    }
    *R = ((*R / freq) << shift) + (*R % freq) + cum;
}

/* ---------------- order-0 ---------------- */

#define O0_SHIFT 12

static int rnx_decode_o0(const uint8_t **cpp, const uint8_t *end,
                         uint8_t *out, int64_t out_sz, int N) {
    const uint8_t *cp = *cpp;
    uint8_t A[256];
    int n_sym = 0;
    uint32_t F[256], C[257];
    memset(F, 0, sizeof(F));
    if (read_alphabet(&cp, end, A, &n_sym) != 0) return -1;
    for (int i = 0; i < n_sym; i++) {
        int64_t f = get_u7(&cp, end);
        if (f < 0) return -1;
        F[A[i]] = (uint32_t)f;
    }
    normalise(F, A, n_sym, O0_SHIFT);
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
        C[s] = c;
        c += F[s];
    }
    C[256] = c;
    if (c > (1u << O0_SHIFT)) return -1;
    static const int TOT = 1 << O0_SHIFT;
    uint8_t *s_of = (uint8_t *)malloc(TOT);
    if (!s_of) return -1;
    for (int s = 0; s < 256; s++)
        for (uint32_t k = C[s]; k < C[s] + F[s] && k < (uint32_t)TOT; k++)
            s_of[k] = (uint8_t)s;
    uint32_t R[32];
    for (int j = 0; j < N; j++) {
        if (cp + 4 > end) { free(s_of); return -1; }
        R[j] = (uint32_t)cp[0] | ((uint32_t)cp[1] << 8) |
               ((uint32_t)cp[2] << 16) | ((uint32_t)cp[3] << 24);
        cp += 4;
    }
    for (int64_t i = 0; i < out_sz; i++) {
        int j = (int)(i % N);
        uint32_t m = R[j] & ((1u << O0_SHIFT) - 1);
        uint8_t s = s_of[m];
        out[i] = s;
        R[j] = F[s] * (R[j] >> O0_SHIFT) + m - C[s];
        dec_renorm(&R[j], &cp, end);
    }
    free(s_of);
    *cpp = cp;
    return 0;
}

static int64_t rnx_encode_o0(const uint8_t *in, int64_t in_sz,
                             uint8_t *out, int N) {
    uint32_t F[256], C[257];
    memset(F, 0, sizeof(F));
    for (int64_t i = 0; i < in_sz; i++) F[in[i]]++;
    uint8_t A[256];
    int n_sym = 0;
    if (in_sz == 0) F[0] = 1;          /* degenerate one-symbol table */
    for (int s = 0; s < 256; s++)
        if (F[s]) A[n_sym++] = (uint8_t)s;
    normalise(F, A, n_sym, O0_SHIFT);
    uint8_t *cp = out;
    uint32_t present[256];
    for (int s = 0; s < 256; s++) present[s] = F[s] != 0;
    write_alphabet(&cp, present);
    for (int i = 0; i < n_sym; i++) put_u7(&cp, F[A[i]]);
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
        C[s] = c;
        c += F[s];
    }
    int64_t cap = in_sz * 2 + 4096;
    uint8_t *buf = (uint8_t *)malloc(cap);
    if (!buf) return -1;
    uint8_t *bp = buf + cap;
    uint32_t R[32];
    for (int j = 0; j < N; j++) R[j] = RANS_L;
    for (int64_t i = in_sz - 1; i >= 0; i--) {
        int j = (int)(i % N);
        enc_put(&R[j], &bp, F[in[i]], C[in[i]], O0_SHIFT);
    }
    for (int j = N - 1; j >= 0; j--) {
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

static int rnx_decode_o1(const uint8_t **cpp, const uint8_t *end,
                         uint8_t *out, int64_t out_sz, int N) {
    const uint8_t *cp = *cpp;
    if (cp >= end) return -1;
    int comp = *cp++;
    int shift = comp >> 4;
    if (shift < 1 || shift > 16) return -1;
    const uint8_t *tp, *tend;
    uint8_t *tbuf = NULL;
    if (comp & 1) {
        /* tables themselves compressed with plain order-0 (no flags) */
        int64_t u_sz = get_u7(&cp, end);
        int64_t c_sz = get_u7(&cp, end);
        if (u_sz < 0 || c_sz < 0 || cp + c_sz > end) return -1;
        tbuf = (uint8_t *)malloc(u_sz ? u_sz : 1);
        if (!tbuf) return -1;
        const uint8_t *tc = cp;
        if (rnx_decode_o0(&tc, cp + c_sz, tbuf, u_sz, 4) != 0) {
            free(tbuf);
            return -1;
        }
        cp += c_sz;
        tp = tbuf;
        tend = tbuf + u_sz;
    } else {
        tp = cp;
        tend = end;
    }
    uint8_t A[256];
    int n_sym = 0;
    if (read_alphabet(&tp, tend, A, &n_sym) != 0) { free(tbuf); return -1; }
    uint32_t (*F)[256] = calloc(256, sizeof(*F));
    uint32_t (*C)[257] = calloc(256, sizeof(*C));
    uint8_t *s_of = malloc(256 * (1 << shift));
    if (!F || !C || !s_of) goto err;
    for (int ii = 0; ii < n_sym; ii++) {
        int i = A[ii];
        int rep = 0;
        for (int jj = 0; jj < n_sym; jj++) {
            int j = A[jj];
            if (rep > 0) {
                rep--;
                F[i][j] = 0;
                continue;
            }
            int64_t f = get_u7(&tp, tend);
            if (f < 0) goto err;
            F[i][j] = (uint32_t)f;
            if (f == 0) {
                if (tp >= tend) goto err;
                rep = *tp++;
            }
        }
        normalise(F[i], A, n_sym, shift);
        uint32_t c = 0;
        for (int s = 0; s < 256; s++) {
            C[i][s] = c;
            c += F[i][s];
        }
        C[i][256] = c;
        if (c > (1u << shift)) goto err;
        for (int s = 0; s < 256; s++)
            for (uint32_t k = C[i][s];
                 k < C[i][s] + F[i][s] && k < (1u << shift); k++)
                s_of[((size_t)i << shift) + k] = (uint8_t)s;
    }
    if (comp & 1) { free(tbuf); tbuf = NULL; }
    else cp = tp;

    {
        uint32_t R[32];
        for (int j = 0; j < N; j++) {
            if (cp + 4 > end) goto err;
            R[j] = (uint32_t)cp[0] | ((uint32_t)cp[1] << 8) |
                   ((uint32_t)cp[2] << 16) | ((uint32_t)cp[3] << 24);
            cp += 4;
        }
        int64_t isz = out_sz / N;
        int64_t iN[32];
        uint8_t last[32];
        for (int j = 0; j < N; j++) {
            iN[j] = j * isz;
            last[j] = 0;
        }
        uint32_t mask = (1u << shift) - 1;
        for (int64_t k = 0; k < isz; k++) {
            for (int j = 0; j < N; j++) {
                uint32_t m = R[j] & mask;
                uint8_t s = s_of[((size_t)last[j] << shift) + m];
                out[iN[j]] = s;
                R[j] = F[last[j]][s] * (R[j] >> shift) + m - C[last[j]][s];
                dec_renorm(&R[j], &cp, end);
                last[j] = s;
                iN[j]++;
            }
        }
        /* the final state decodes the remainder */
        for (int64_t i = N * isz; i < out_sz; i++) {
            uint32_t m = R[N - 1] & mask;
            uint8_t s = s_of[((size_t)last[N - 1] << shift) + m];
            out[i] = s;
            R[N - 1] = F[last[N - 1]][s] * (R[N - 1] >> shift) + m -
                       C[last[N - 1]][s];
            dec_renorm(&R[N - 1], &cp, end);
            last[N - 1] = s;
        }
    }
    free(F); free(C); free(s_of);
    *cpp = cp;
    return 0;
err:
    free(tbuf); free(F); free(C); free(s_of);
    return -1;
}

static int64_t rnx_encode_o1(const uint8_t *in, int64_t in_sz,
                             uint8_t *out, int N) {
    if (in_sz < N * 4) return -1;      /* caller falls back to order-0 */
    int shift = in_sz > 100000 ? 12 : 10;
    uint32_t (*F)[256] = calloc(256, sizeof(*F));
    uint64_t *tot = calloc(256, sizeof(*tot));
    uint32_t (*C)[257] = calloc(256, sizeof(*C));
    if (!F || !tot || !C) { free(F); free(tot); free(C); return -1; }
    int64_t isz = in_sz / N;
    uint8_t last = 0;
    uint32_t sym_present[256];
    memset(sym_present, 0, sizeof(sym_present));
    sym_present[0] = 1;                /* context 0 seeds every fraction */
    for (int64_t i = 0; i < in_sz; i++) {
        F[last][in[i]]++;
        tot[last]++;
        sym_present[in[i]] = 1;
        last = in[i];
    }
    for (int j = 1; j < N; j++) {      /* fraction starts: context 0 */
        F[0][in[j * isz]]++;
        tot[0]++;
    }
    uint8_t A[256];
    int n_sym = 0;
    for (int s = 0; s < 256; s++)
        if (sym_present[s]) A[n_sym++] = (uint8_t)s;
    for (int c = 0; c < 256; c++) {
        if (!tot[c]) continue;
        normalise(F[c], A, n_sym, shift);
        uint32_t s = 0;
        for (int i = 0; i < 256; i++) {
            C[c][i] = s;
            s += F[c][i];
        }
        C[c][256] = s;
    }
    uint8_t *cp = out;
    *cp++ = (uint8_t)(shift << 4);     /* uncompressed tables */
    write_alphabet(&cp, sym_present);
    for (int ii = 0; ii < n_sym; ii++) {
        int i = A[ii];
        if (!tot[i]) {
            /* context never seen: all-zero row, stored as one 0 + run */
            put_u7(&cp, 0);
            *cp++ = (uint8_t)(n_sym - 1);
            continue;
        }
        int rep = 0;
        for (int jj = 0; jj < n_sym; jj++) {
            int j = A[jj];
            if (rep > 0) { rep--; continue; }
            put_u7(&cp, F[i][j]);
            if (F[i][j] == 0) {
                int z = 0;
                while (jj + 1 + z < n_sym && F[i][A[jj + 1 + z]] == 0 &&
                       z < 255)
                    z++;
                *cp++ = (uint8_t)z;
                rep = z;
            }
        }
    }
    int64_t cap = in_sz * 2 + 65536;
    uint8_t *buf = malloc(cap);
    if (!buf) { free(F); free(tot); free(C); return -1; }
    uint8_t *bp = buf + cap;
    uint32_t R[32];
    int64_t iN[32];
    for (int j = 0; j < N; j++) {
        R[j] = RANS_L;
        iN[j] = (j + 1) * isz - 1;
    }
    iN[N - 1] = in_sz - 1;
    while (iN[N - 1] > N * isz - 1) {  /* tail, final state */
        uint8_t s = in[iN[N - 1]];
        uint8_t c = iN[N - 1] > (N - 1) * isz ? in[iN[N - 1] - 1] : 0;
        enc_put(&R[N - 1], &bp, F[c][s], C[c][s], shift);
        iN[N - 1]--;
    }
    for (int64_t k = isz - 1; k >= 0; k--) {
        for (int j = N - 1; j >= 0; j--) {
            uint8_t s = in[iN[j]];
            uint8_t c = iN[j] > j * isz ? in[iN[j] - 1] : 0;
            enc_put(&R[j], &bp, F[c][s], C[c][s], shift);
            iN[j]--;
        }
    }
    for (int j = N - 1; j >= 0; j--) {
        *--bp = (R[j] >> 24) & 0xff;
        *--bp = (R[j] >> 16) & 0xff;
        *--bp = (R[j] >> 8) & 0xff;
        *--bp = R[j] & 0xff;
    }
    int64_t n = buf + cap - bp;
    memcpy(cp, bp, n);
    int64_t total = (cp - out) + n;
    free(buf); free(F); free(tot); free(C);
    return total;
}

/* ---------------- PACK / RLE transforms ---------------- */

static int64_t unpack_bits(const uint8_t *in, int64_t packed_len,
                           const uint8_t *P, int n_sym, uint8_t *out,
                           int64_t out_sz) {
    if (n_sym <= 1) {
        memset(out, n_sym ? P[0] : 0, out_sz);
        return out_sz;
    }
    if (n_sym <= 2) {
        for (int64_t i = 0; i < out_sz; i++)
            out[i] = P[(in[i >> 3] >> (i & 7)) & 1];
    } else if (n_sym <= 4) {
        for (int64_t i = 0; i < out_sz; i++)
            out[i] = P[(in[i >> 2] >> ((i & 3) << 1)) & 3];
    } else if (n_sym <= 16) {
        for (int64_t i = 0; i < out_sz; i++)
            out[i] = P[(in[i >> 1] >> ((i & 1) << 2)) & 15];
    } else {
        return -1;
    }
    (void)packed_len;
    return out_sz;
}

/* ---------------- top-level ---------------- */

int64_t ransnx16_decode(const uint8_t *in, int64_t in_sz, uint8_t *out,
                        int64_t out_cap, int64_t nosz_len);

static int64_t decode_stripe(const uint8_t *cp, const uint8_t *end,
                             uint8_t *out, int64_t out_sz) {
    if (cp >= end) return -1;
    int N = *cp++;
    if (N <= 0 || N > 255) return -1;
    int64_t clen[256];
    for (int j = 0; j < N; j++) {
        clen[j] = get_u7(&cp, end);
        if (clen[j] < 0) return -1;
    }
    uint8_t *sub = malloc(out_sz + N);
    if (!sub) return -1;
    int64_t off = 0;
    int64_t ulen0 = -1;
    int64_t offs[256];
    int64_t ulens[256];
    for (int j = 0; j < N; j++) {
        int64_t ulen = (out_sz - j + N - 1) / N;
        if (cp + clen[j] > end) { free(sub); return -1; }
        offs[j] = off;
        ulens[j] = ulen;
        int64_t got = ransnx16_decode(cp, clen[j], sub + off, ulen, ulen);
        if (got != ulen) { free(sub); return -1; }
        cp += clen[j];
        off += ulen;
        (void)ulen0;
    }
    for (int j = 0; j < N; j++)
        for (int64_t i = 0; i < ulens[j]; i++)
            out[i * N + j] = sub[offs[j] + i];
    free(sub);
    return out_sz;
}

/* Decode one rANS Nx16 stream.  nosz_len: the decoded size to use when
 * the stream has the NOSZ flag (pass -1 when unknown — then NOSZ input
 * is an error).  Returns decoded length or -1. */
int64_t ransnx16_decode(const uint8_t *in, int64_t in_sz, uint8_t *out,
                        int64_t out_cap, int64_t nosz_len) {
    const uint8_t *cp = in, *end = in + in_sz;
    if (cp >= end) return in_sz == 0 ? 0 : -1;
    int flags = *cp++;
    int64_t len;
    if (flags & RNX_NOSZ) {
        len = nosz_len;
        if (len < 0) return -1;
    } else {
        len = get_u7(&cp, end);
        if (len < 0) return -1;
    }
    if (len > out_cap) return -1;
    if (flags & RNX_STRIPE)
        return decode_stripe(cp, end, out, len);
    int N = (flags & RNX_N32) ? 32 : 4;

    int64_t pack_len = 0, n_pack = -1;
    uint8_t P[16];
    if (flags & RNX_PACK) {
        pack_len = len;
        if (cp >= end) return -1;
        n_pack = *cp++;
        if (n_pack > 16) return -1;
        for (int i = 0; i < n_pack; i++) {
            if (cp >= end) return -1;
            P[i] = *cp++;
        }
        len = get_u7(&cp, end);
        if (len < 0) return -1;
    }

    int64_t rle_len = 0;
    uint8_t *rle_meta = NULL;
    int64_t rle_meta_sz = 0;
    if (flags & RNX_RLE) {
        rle_len = len;
        int64_t m = get_u7(&cp, end);
        len = get_u7(&cp, end);
        if (m < 0 || len < 0) return -1;
        rle_meta_sz = m >> 1;
        rle_meta = malloc(rle_meta_sz ? rle_meta_sz : 1);
        if (!rle_meta) return -1;
        if (m & 1) {
            if (cp + rle_meta_sz > end) { free(rle_meta); return -1; }
            memcpy(rle_meta, cp, rle_meta_sz);
            cp += rle_meta_sz;
        } else {
            int64_t c_sz = get_u7(&cp, end);
            if (c_sz < 0 || cp + c_sz > end) { free(rle_meta); return -1; }
            const uint8_t *mc = cp;
            if (rnx_decode_o0(&mc, cp + c_sz, rle_meta, rle_meta_sz, 4)
                != 0) {
                free(rle_meta);
                return -1;
            }
            cp += c_sz;
        }
    }

    /* entropy stage output (possibly an intermediate buffer) */
    int64_t out_len = (flags & RNX_PACK) || (flags & RNX_RLE)
        ? len : len;
    uint8_t *stage = out;
    uint8_t *tmp = NULL;
    if ((flags & RNX_PACK) || (flags & RNX_RLE)) {
        tmp = malloc((len > rle_len ? len : rle_len) + 64);
        if (!tmp) { free(rle_meta); return -1; }
        stage = tmp;
    }
    int rc;
    if (flags & RNX_CAT) {
        if (cp + len > end) rc = -1;
        else { memcpy(stage, cp, len); cp += len; rc = 0; }
    } else if (flags & RNX_ORDER1) {
        rc = rnx_decode_o1(&cp, end, stage, len, N);
    } else {
        rc = rnx_decode_o0(&cp, end, stage, len, N);
    }
    if (rc != 0) { free(rle_meta); free(tmp); return -1; }

    if (flags & RNX_RLE) {
        /* rle_meta: n (0 => 256) + symbol list + run-length uint7s */
        const uint8_t *mp = rle_meta, *mend = rle_meta + rle_meta_sz;
        if (mp >= mend) { free(rle_meta); free(tmp); return -1; }
        int n = *mp++;
        if (n == 0) n = 256;
        uint8_t use[256];
        memset(use, 0, sizeof(use));
        for (int i = 0; i < n; i++) {
            if (mp >= mend) { free(rle_meta); free(tmp); return -1; }
            use[*mp++] = 1;
        }
        uint8_t *dst = (flags & RNX_PACK) ? tmp : out;
        uint8_t *src = stage;
        /* in-place expand not possible; run through a second buffer */
        uint8_t *rbuf = malloc(rle_len + 64);
        if (!rbuf) { free(rle_meta); free(tmp); return -1; }
        int64_t o = 0;
        for (int64_t i = 0; i < len && o < rle_len; i++) {
            uint8_t b = src[i];
            rbuf[o++] = b;
            if (use[b]) {
                int64_t run = get_u7(&mp, mend);
                if (run < 0 || o + run > rle_len) {
                    free(rbuf); free(rle_meta); free(tmp);
                    return -1;
                }
                memset(rbuf + o, b, run);
                o += run;
            }
        }
        if (o != rle_len) { free(rbuf); free(rle_meta); free(tmp); return -1; }
        memcpy(dst, rbuf, rle_len);
        free(rbuf);
        len = rle_len;
        stage = dst;
        free(rle_meta);
        rle_meta = NULL;
    }

    if (flags & RNX_PACK) {
        if (unpack_bits(stage, len, P, (int)n_pack, out, pack_len) < 0) {
            free(tmp);
            return -1;
        }
        len = pack_len;
    }
    free(rle_meta);
    free(tmp);
    (void)out_len;
    return len;
}

/* Encode with the given flags (supported: ORDER1, N32, PACK, CAT, NOSZ).
 * PACK is dropped silently if >16 distinct symbols.  Returns size, -1 on
 * error. */
int64_t ransnx16_encode(const uint8_t *in, int64_t in_sz, uint8_t *out,
                        int flags) {
    uint8_t *cp;
    const uint8_t *payload = in;
    int64_t payload_sz = in_sz;
    uint8_t *packed = NULL;
    uint8_t P[17];
    int n_pack = 0;
    if (flags & (RNX_STRIPE | RNX_RLE)) return -1;
    if (flags & RNX_PACK) {
        uint32_t seen[256];
        memset(seen, 0, sizeof(seen));
        for (int64_t i = 0; i < in_sz; i++) seen[in[i]] = 1;
        for (int s = 0; s < 256 && n_pack <= 16; s++)
            if (seen[s]) P[n_pack++] = (uint8_t)s;
        if (n_pack > 16 || in_sz == 0) {
            flags &= ~RNX_PACK;
        } else {
            uint8_t inv[256];
            for (int i = 0; i < n_pack; i++) inv[P[i]] = (uint8_t)i;
            int64_t plen = n_pack <= 1 ? 0
                : n_pack <= 2 ? (in_sz + 7) / 8
                : n_pack <= 4 ? (in_sz + 3) / 4
                : (in_sz + 1) / 2;
            packed = calloc(plen ? plen : 1, 1);
            if (!packed) return -1;
            for (int64_t i = 0; i < in_sz; i++) {
                uint8_t v = inv[in[i]];
                if (n_pack <= 1) break;
                if (n_pack <= 2) packed[i >> 3] |= v << (i & 7);
                else if (n_pack <= 4) packed[i >> 2] |= v << ((i & 3) << 1);
                else packed[i >> 1] |= v << ((i & 1) << 2);
            }
            payload = packed;
            payload_sz = plen;
        }
    }
    int N = (flags & RNX_N32) ? 32 : 4;
    if ((flags & RNX_ORDER1) && payload_sz < N * 4)
        flags &= ~RNX_ORDER1;          /* too small for order-1 */
    cp = out;
    *cp++ = (uint8_t)flags;
    if (!(flags & RNX_NOSZ)) put_u7(&cp, (uint64_t)in_sz);
    if (flags & RNX_PACK) {
        *cp++ = (uint8_t)n_pack;
        for (int i = 0; i < n_pack; i++) *cp++ = P[i];
        put_u7(&cp, (uint64_t)payload_sz);
    }
    int64_t n;
    if (flags & RNX_CAT) {
        memcpy(cp, payload, payload_sz);
        n = payload_sz;
    } else if (flags & RNX_ORDER1) {
        n = rnx_encode_o1(payload, payload_sz, cp, N);
    } else {
        n = rnx_encode_o0(payload, payload_sz, cp, N);
    }
    free(packed);
    if (n < 0) return -1;
    return (cp - out) + n;
}
