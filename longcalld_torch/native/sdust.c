/* Symmetric DUST low-complexity masker — C fast path.
 *
 * Implemented from the algorithm as published (Morgulis, Gertz, Schaffer
 * & Agarwala, "A fast and symmetric DUST implementation to mask
 * low-complexity DNA sequences", J. Comput. Biol. 13(5), 2006).  This file
 * mirrors the host oracle longcalld_torch/utils/sdust.py — see that module's
 * docstring for the formulation: an append-only triplet log with absolute
 * window/suffix cursors (win_beg/suf_beg) instead of a streaming queue,
 * incremental pair counts via C(c+1,2)-C(c,2)=c, and exact rational score
 * comparison by cross-multiplication.  Fuzz-asserted byte-equal to the
 * Python oracle in tests/test_intervals.py.
 *
 * Output convention and parameterisation (T=5, W=20; 0-based half-open
 * merged intervals; window state persisting across N breaks while the
 * triplet register resets) match the masker the reference tool invokes at
 * reference/src/bam_utils.c:1575-1581.
 *
 * Driven through ctypes; the Python oracle remains the fallback where no
 * compiler is available.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define WLEN 3
#define NCODE 64               /* 4^WLEN triplet codes */

typedef struct { int beg, end, num, den; } Perfect;   /* score = num/den */

typedef struct {
    int T, W, win_len;
    int *trips;                /* append-only triplet log */
    int n_trips;
    int win_beg, suf_beg;      /* window/suffix cursors into trips */
    int win_cnt[NCODE], suf_cnt[NCODE];
    int probe_cnt[NCODE];      /* scratch for probe_perfect */
    long win_pairs, suf_pairs; /* sum_t C(cnt[t], 2) */
    Perfect *pf;               /* candidates, beg descending */
    int n_pf, m_pf;
    int64_t *masked;           /* packed (beg << 32 | end) results */
    int n_masked, m_masked;
} Dust;

static void masked_add(Dust *d, int beg, int end) {
    if (d->n_masked > 0) {
        int64_t last = d->masked[d->n_masked - 1];
        int lbeg = (int)(last >> 32), lend = (int)(uint32_t)last;
        if (beg <= lend) {     /* merge touching/overlapping intervals */
            if (end > lend)
                d->masked[d->n_masked - 1] =
                    ((int64_t)lbeg << 32) | (uint32_t)end;
            return;
        }
    }
    if (d->n_masked == d->m_masked) {
        d->m_masked = d->m_masked ? d->m_masked * 2 : 64;
        d->masked = (int64_t *)realloc(d->masked,
                                       d->m_masked * sizeof(int64_t));
    }
    d->masked[d->n_masked++] = ((int64_t)beg << 32) | (uint32_t)end;
}

/* Move perfect intervals that fell behind the window into the result. */
static void emit_expired(Dust *d, int win_seq_beg) {
    if (d->n_pf == 0 || d->pf[d->n_pf - 1].beg >= win_seq_beg) return;
    masked_add(d, d->pf[d->n_pf - 1].beg, d->pf[d->n_pf - 1].end);
    while (d->n_pf > 0 && d->pf[d->n_pf - 1].beg < win_seq_beg) d->n_pf--;
}

/* Slide the window over one more triplet. */
static void push(Dust *d, int code) {
    int old;
    if (d->n_trips - d->win_beg == d->win_len) {    /* window at capacity */
        old = d->trips[d->win_beg++];
        d->win_pairs -= --d->win_cnt[old];
        if (d->suf_beg < d->win_beg) {  /* suffix was the whole window */
            d->suf_pairs -= --d->suf_cnt[old];
            d->suf_beg = d->win_beg;
        }
    }
    d->trips[d->n_trips++] = code;
    d->win_pairs += d->win_cnt[code]++;
    d->suf_pairs += d->suf_cnt[code]++;
    if (d->suf_cnt[code] * 10 > 2 * d->T) {
        /* code now too frequent: advance suffix past its previous use */
        do {
            old = d->trips[d->suf_beg++];
            d->suf_pairs -= --d->suf_cnt[old];
        } while (old != code);
    }
}

/* Extend the suffix leftwards through the window, recording every
 * extension whose score beats T and is not dominated by a higher-scoring
 * recorded interval it contains. */
static void probe_perfect(Dust *d, int win_seq_beg) {
    long pairs = d->suf_pairs;
    long best_num = 0, best_den = 0;
    int i, j;
    memcpy(d->probe_cnt, d->suf_cnt, sizeof(d->probe_cnt));
    for (i = d->suf_beg - 1; i >= d->win_beg; --i) {
        int code = d->trips[i];
        long run;
        pairs += d->probe_cnt[code]++;
        run = d->n_trips - i - 1;
        if (pairs * 10 > d->T * run) {
            int seq_beg = (i - d->win_beg) + win_seq_beg;
            for (j = 0; j < d->n_pf && d->pf[j].beg >= seq_beg; ++j) {
                Perfect *p = &d->pf[j];
                if (best_num == 0
                        || (long)p->num * best_den > best_num * (long)p->den) {
                    best_num = p->num;
                    best_den = p->den;
                }
            }
            if (best_num == 0 || pairs * best_den >= best_num * run) {
                best_num = pairs;
                best_den = run;
                if (d->n_pf == d->m_pf) {
                    d->m_pf = d->m_pf ? d->m_pf * 2 : 64;
                    d->pf = (Perfect *)realloc(d->pf,
                                               d->m_pf * sizeof(Perfect));
                }
                memmove(&d->pf[j + 1], &d->pf[j],
                        (d->n_pf - j) * sizeof(Perfect));
                d->n_pf++;
                d->pf[j].beg = seq_beg;
                d->pf[j].end = (d->n_trips - d->win_beg) + (WLEN - 1)
                    + win_seq_beg;
                d->pf[j].num = (int)pairs;
                d->pf[j].den = (int)run;
            }
        }
    }
}

/* seq4: nt4 codes (0-3 bases, >=4 breaks).  Writes the interval count to
 * *n_out and returns packed (beg << 32 | end) pairs (free via sdust_free). */
int64_t *sdust_mask(const uint8_t *seq4, int n, int T, int W, int *n_out) {
    Dust d;
    int i, run = 0, code = 0;
    memset(&d, 0, sizeof(d));
    d.T = T;
    d.W = W;
    d.win_len = W - WLEN + 1;
    d.trips = (int *)malloc((n > 0 ? n : 1) * sizeof(int));
    for (i = 0; i <= n; ++i) {
        int b = i < n ? seq4[i] : 4;
        if (b < 4) {
            ++run;
            code = ((code << 2) | b) & (NCODE - 1);
            if (run >= WLEN) {
                int win_seq_beg = (run - W > 0 ? run - W : 0)
                    + (i + 1 - run);
                emit_expired(&d, win_seq_beg);
                push(&d, code);
                if (d.win_pairs * 10 > (long)(d.n_trips - d.suf_beg) * T)
                    probe_perfect(&d, win_seq_beg);
            }
        } else {
            int win_seq_beg = (run - W + 1 > 0 ? run - W + 1 : 0)
                + (i + 1 - run);
            while (d.n_pf > 0) emit_expired(&d, win_seq_beg++);
            /* triplet register resets; window counts deliberately persist
             * across the break */
            run = code = 0;
        }
    }
    free(d.trips);
    free(d.pf);
    *n_out = d.n_masked;
    return d.masked;
}

void sdust_free(int64_t *p) { free(p); }
