/* Digar extraction of a window's reads in one pass.
 *
 * C fast path for longcalld_torch/core/digar.py: for every read of a
 * window whose CIGAR uses =/X (collect_digar_eqx) or uses M and carries
 * no cs/MD tag (collect_digar_from_ref: each M run compared base for
 * base with the window's reference), it builds the event table
 * (pos/type/len/qi/low-qual), the nt4 sequence, the per-read noisy
 * regions and the skip decision, the analog of the reference's
 * collect_digar_from_eqx_cigar and collect_digar_from_ref_seq
 * (reference/src/bam_utils.c:701-841, 1176-1327).  Reads it cannot take
 * (cs/MD tags, an M op in an =/X CIGAR, malformed records, M runs
 * outside the reference window) are marked for the Python path.
 *
 * Equality with the Python path is tested read by read in
 * tests/test_torch_digar.py.
 *
 * Use: lcd_digar_window(...) returns a handle holding the window's
 * variable-length outputs and their counts; lcd_digar_take copies them
 * into the caller's arrays and frees the handle.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CMATCH 0
#define CINS 1
#define CDEL 2
#define CREF_SKIP 3
#define CSOFT_CLIP 4
#define CHARD_CLIP 5
#define CEQUAL 7
#define CDIFF 8

/* per-read status */
#define DG_KEPT 0
#define DG_SKIPPED 1   /* BAM_RECORD_WRONG_MAP: no digar, no regions */
#define DG_PYTHON 2    /* left to the Python path */

/* iopt layout */
enum { O_MIN_BQ, O_SLIDE_WIN, O_MAX_XGAPS, O_END_CLIP_REG, O_FLANK_WIN,
       O_REG_BEG, O_REG_END, O_WHOLE_REF_LEN };

static const int OP_R[16] = {1, 0, 1, 1, 0, 0, 0, 1, 1};  /* M I D N S H P = X */
static const int OP_Q[16] = {1, 1, 0, 0, 1, 0, 0, 1, 1};
static const uint8_t NT16_NT4[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                     3, 4, 4, 4, 4, 4, 4, 4};

typedef struct {
    int64_t n, cap;
    int64_t *pos;
    uint8_t *type;
    int32_t *len;
    int32_t *qi;
    uint8_t *low;
} events_t;

typedef struct {
    int64_t n, cap;
    int64_t *s, *e, *l;
    uint8_t *chunk;
} regions_t;

typedef struct {
    int64_t n, cap;
    int64_t *pos, *len, *cnt;
} pushes_t;

typedef struct {
    events_t ev;
    regions_t rg;
} window_t;

static int grow(void **p, int64_t cap, size_t sz)
{
    void *q = realloc(*p, (size_t)cap * sz);
    if (!q) return -1;
    *p = q;
    return 0;
}

static int ev_reserve(events_t *ev, int64_t more)
{
    if (ev->n + more <= ev->cap) return 0;
    int64_t cap = ev->cap ? ev->cap : 4096;
    while (cap < ev->n + more) cap *= 2;
    if (grow((void **)&ev->pos, cap, 8) || grow((void **)&ev->type, cap, 1)
        || grow((void **)&ev->len, cap, 4) || grow((void **)&ev->qi, cap, 4)
        || grow((void **)&ev->low, cap, 1))
        return -1;
    ev->cap = cap;
    return 0;
}

static int rg_push(regions_t *rg, int64_t s, int64_t e, int64_t l)
{
    if (rg->n == rg->cap) {
        int64_t cap = rg->cap ? rg->cap * 2 : 256;
        if (grow((void **)&rg->s, cap, 8) || grow((void **)&rg->e, cap, 8)
            || grow((void **)&rg->l, cap, 8)
            || grow((void **)&rg->chunk, cap, 1))
            return -1;
        rg->cap = cap;
    }
    rg->s[rg->n] = s;
    rg->e[rg->n] = e;
    rg->l[rg->n] = l;
    rg->chunk[rg->n] = 0;
    rg->n++;
    return 0;
}

static int push_add(pushes_t *pu, int64_t pos, int64_t len, int64_t cnt)
{
    if (pu->n == pu->cap) {
        int64_t cap = pu->cap ? pu->cap * 2 : 1024;
        if (grow((void **)&pu->pos, cap, 8) || grow((void **)&pu->len, cap, 8)
            || grow((void **)&pu->cnt, cap, 8))
            return -1;
        pu->cap = cap;
    }
    pu->pos[pu->n] = pos;
    pu->len[pu->n] = len;
    pu->cnt[pu->n] = cnt;
    pu->n++;
    return 0;
}

static uint32_t rd_u32(const uint8_t *p)
{
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static int32_t rd_i32(const uint8_t *p)
{
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}

static uint16_t rd_u16(const uint8_t *p)
{
    uint16_t v;
    memcpy(&v, p, 2);
    return v;
}

/* BamRecord._iter_tags over the aux block: 1 when a cs or MD tag is met,
 * or when the walk meets what makes the Python walk raise (the read then
 * takes the Python path, which raises as before); 0 otherwise. */
static int tags_need_python(const uint8_t *r, int64_t off, int64_t n)
{
    while (off + 3 <= n) {
        uint8_t t0 = r[off], t1 = r[off + 1], typ = r[off + 2];
        int64_t val = off + 3;
        switch (typ) {
        case 'c': case 'C': case 'A': off = val + 1; break;
        case 's': case 'S': off = val + 2; break;
        case 'i': case 'I': case 'f': off = val + 4; break;
        case 'Z': case 'H': {
            const uint8_t *z = val < n ? memchr(r + val, 0, (size_t)(n - val))
                                       : NULL;
            if (!z) return 1;
            off = (z - r) + 1;
            break;
        }
        case 'B': {
            if (val + 5 > n) return 1;
            int64_t sz;
            switch (r[val]) {
            case 'c': case 'C': sz = 1; break;
            case 's': case 'S': sz = 2; break;
            case 'i': case 'I': case 'f': sz = 4; break;
            default: return 1;
            }
            int32_t cnt = rd_i32(r + val + 1);
            if (cnt < 0) return 1;
            off = val + 5 + (int64_t)cnt * sz;
            break;
        }
        default:
            return 1;
        }
        if ((t0 == 'c' && t1 == 's') || (t0 == 'M' && t1 == 'D')) return 1;
    }
    return 0;
}

/* length of the run of equal bytes of a and b from 0, at most n */
static int64_t eq_run(const uint8_t *a, const uint8_t *b, int64_t n)
{
    int64_t k = 0;
    while (k + 8 <= n) {
        uint64_t x, y;
        memcpy(&x, a + k, 8);
        memcpy(&y, b + k, 8);
        uint64_t d = x ^ y;
        if (d) return k + (__builtin_ctzll(d) >> 3);
        k += 8;
    }
    while (k < n && a[k] == b[k]) k++;
    return k;
}

typedef struct {
    const uint8_t *qual;
    int64_t l_seq, min_bq;
    events_t *ev;
    pushes_t *pu;
    int64_t n_var;     /* X + D + I events, low-quality ones too */
} emit_t;

static int good_q(const emit_t *m, int64_t q)
{
    return (int64_t)m->qual[q] >= m->min_bq;
}

/* one event; the low-quality rules (src/bam_utils.c:728-770) and the
 * noisy-region push of a non-low X (pos,1,1), DEL (pos,len,len) or INS
 * (pos,0,len) */
static int emit(emit_t *m, int64_t pos, uint8_t type, int64_t len,
                int64_t qi)
{
    events_t *ev = m->ev;
    uint8_t low = 0;
    if (type == CDIFF) {
        low = !good_q(m, qi);
    } else if (type == CDEL) {
        int prev_ok = qi == 0 || good_q(m, qi - 1);
        int64_t c = qi < m->l_seq - 1 ? qi : m->l_seq - 1;
        low = !(prev_ok && good_q(m, c));
    } else if (type == CINS) {
        int64_t e = qi + len < m->l_seq ? qi + len : m->l_seq;
        low = 1;
        for (int64_t q = qi; q < e; q++)
            if (good_q(m, q)) {
                low = 0;
                break;
            }
    }
    int64_t i = ev->n++;
    ev->pos[i] = pos;
    ev->type[i] = type;
    ev->len[i] = (int32_t)len;
    ev->qi[i] = (int32_t)qi;
    ev->low[i] = low;
    if (type == CDIFF || type == CDEL || type == CINS) {
        m->n_var++;
        if (!low) {
            int64_t plen = type == CDEL ? len : (type == CDIFF ? 1 : 0);
            int64_t pcnt = type == CDIFF ? 1 : len;
            if (push_add(m->pu, pos, plen, pcnt)) return -1;
        }
    }
    return 0;
}

/* push_xid_size_queue_win (src/bam_utils.c:161-200) as a two-pointer
 * sweep: a push at pos keeps the pushes with pos+len-1 > pos-win; where
 * their counts exceed max_s the span becomes a dense region, chained
 * regions merge, label max(sum of queued counts, span length); regions
 * as (start - 1, end, label) */
static int detect_noisy(const pushes_t *pu, int64_t win, int64_t max_s,
                        regions_t *out, int64_t *csum)
{
    int64_t n = pu->n;
    csum[0] = 0;
    for (int64_t i = 0; i < n; i++) csum[i + 1] = csum[i] + pu->cnt[i];
    int64_t front = 0, have = 0, cs = 0, ce = 0, qs = 0, qe = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t x = pu->pos[i] - win;
        while (front < n && pu->pos[front] + pu->len[front] - 1 <= x) front++;
        if (csum[i + 1] - csum[front] <= max_s) continue;
        int64_t ns = pu->pos[front], ne = pu->pos[i] + pu->len[i];
        if (!have) {
            have = 1;
            cs = ns; ce = ne; qs = front; qe = i;
        } else if (ns <= ce) {
            ce = ne;
            qe = i;
        } else {
            int64_t v = csum[qe + 1] - csum[qs];
            if (v < ce - cs + 1) v = ce - cs + 1;
            if (rg_push(out, cs - 1, ce, v)) return -1;
            cs = ns; ce = ne; qs = front; qe = i;
        }
    }
    if (have) {
        int64_t v = csum[qe + 1] - csum[qs];
        if (v < ce - cs + 1) v = ce - cs + 1;
        if (rg_push(out, cs - 1, ce, v)) return -1;
    }
    return 0;
}

typedef struct {
    pushes_t pu;
    int64_t *csum;
    int64_t csum_cap;
    int64_t *clip_i;      /* event index of each clip */
    uint8_t *clip_left;   /* its CIGAR row (of the =/X form) is row 0 */
    int64_t clip_cap;
} scratch_t;

/* One read; returns its status, or -1 when out of memory. */
static int read_digar(window_t *w, scratch_t *sc, const uint8_t *r,
                      int64_t rlen, int pal, const uint8_t *ref4,
                      int64_t ref_len, int64_t ref_beg, const int64_t *io,
                      const double *dopt, const uint8_t (*nt4_pair)[2],
                      uint8_t *seq_out, int64_t seq_len)
{
    if (rlen < 32) return DG_PYTHON;
    int64_t pos0 = rd_i32(r + 4);
    int64_t l_rn = r[8];
    int64_t n_cig = rd_u16(r + 12);
    int is_rev = (rd_u16(r + 14) & 16) != 0;
    int64_t l_seq = rd_i32(r + 16);
    if (l_seq <= 0 || l_seq != seq_len || n_cig == 0) return DG_PYTHON;
    int64_t cig_off = 32 + l_rn, seq_off = cig_off + 4 * n_cig;
    int64_t qual_off = seq_off + (l_seq + 1) / 2, tag_off = qual_off + l_seq;
    if (tag_off > rlen) return DG_PYTHON;
    const uint8_t *cg = r + cig_off;

    /* has_eqx_cigar: =/X before any M */
    int eqx = 0;
    for (int64_t k = 0; k < n_cig; k++) {
        uint32_t op = rd_u32(cg + 4 * k) & 0xF;
        if (op == CEQUAL || op == CDIFF) { eqx = 1; break; }
        if (op == CMATCH) break;
    }
    if (!eqx && tags_need_python(r, tag_off, rlen)) return DG_PYTHON;

    /* the shapes the Python path rejects or reads out of bounds: an M in
     * an =/X CIGAR (ValueError there), ops past X, the query consumed
     * past the sequence, M runs outside the reference window; and the
     * bound of this read's events */
    int64_t qsum = 0, rpos = pos0 + 1, bound = 0;
    for (int64_t k = 0; k < n_cig; k++) {
        uint32_t word = rd_u32(cg + 4 * k);
        uint32_t op = word & 0xF;
        int64_t ln = word >> 4;
        if (op > CDIFF || (op == CMATCH && eqx)) return DG_PYTHON;
        if (op == CMATCH) {
            int64_t off = rpos - ref_beg;
            if (off < 0 || off + ln > ref_len) return DG_PYTHON;
        }
        qsum += OP_Q[op] * ln;
        rpos += OP_R[op] * ln;
        bound += (op == CMATCH || op == CDIFF) ? ln : 1;
    }
    if (qsum > l_seq) return DG_PYTHON;
    if (ev_reserve(&w->ev, bound)) return -1;
    if (n_cig > sc->clip_cap) {
        if (grow((void **)&sc->clip_i, n_cig, 8)
            || grow((void **)&sc->clip_left, n_cig, 1))
            return -1;
        sc->clip_cap = n_cig;
    }

    /* the nt4 sequence: two bases a packed byte, hi nibble first */
    const uint8_t *packed = r + seq_off;
    for (int64_t q = 0; q < l_seq / 2; q++)
        memcpy(seq_out + 2 * q, nt4_pair[packed[q]], 2);
    if (l_seq & 1) seq_out[l_seq - 1] = nt4_pair[packed[l_seq / 2]][0];

    emit_t m = {r + qual_off, l_seq, io[O_MIN_BQ], &w->ev, &sc->pu, 0};
    sc->pu.n = 0;
    int64_t ev0 = w->ev.n, rg0 = w->rg.n, n_clip = 0;
    int64_t pos = pos0 + 1, qi = 0, row = 0;
    for (int64_t k = 0; k < n_cig; k++) {
        uint32_t word = rd_u32(cg + 4 * k);
        uint8_t op = word & 0xF;
        int64_t ln = word >> 4;
        if (op == CMATCH) {
            /* the M run as =/X runs against the reference; each run is a
             * row of the rewritten CIGAR, each X base an event */
            const uint8_t *a = ref4 + (pos - ref_beg), *b = seq_out + qi;
            int64_t j = 0;
            while (j < ln) {
                int64_t e = j + eq_run(a + j, b + j, ln - j);
                if (e > j) {
                    if (emit(&m, pos + j, CEQUAL, e - j, qi + j)) return -1;
                } else {
                    while (e < ln && a[e] != b[e]) e++;
                    for (int64_t x = j; x < e; x++)
                        if (emit(&m, pos + x, CDIFF, 1, qi + x)) return -1;
                }
                row++;
                j = e;
            }
        } else {
            if (op == CDIFF) {
                for (int64_t x = 0; x < ln; x++)
                    if (emit(&m, pos + x, CDIFF, 1, qi + x)) return -1;
            } else if (op != CREF_SKIP) {
                if (op == CSOFT_CLIP || op == CHARD_CLIP) {
                    sc->clip_i[n_clip] = w->ev.n;
                    sc->clip_left[n_clip++] = row == 0;
                }
                if (emit(&m, pos, op, ln, qi)) return -1;
            }
            row++;
        }
        pos += OP_R[op] * ln;
        qi += OP_Q[op] * ln;
    }

    /* palindromic clips turned hard (src/bam_utils.c:773-774) */
    int left_pal = pal && is_rev, right_pal = pal && !is_rev;
    if (pal)
        for (int64_t c = 0; c < n_clip; c++)
            if (sc->clip_left[c] ? left_pal : right_pal)
                w->ev.type[sc->clip_i[c]] = CHARD_CLIP;

    if (sc->pu.n + 1 > sc->csum_cap) {
        int64_t cap = 2 * (sc->pu.n + 1);
        if (grow((void **)&sc->csum, cap, 8)) return -1;
        sc->csum_cap = cap;
    }
    if (detect_noisy(&sc->pu, io[O_SLIDE_WIN], io[O_MAX_XGAPS], &w->rg,
                     sc->csum))
        return -1;

    /* long end clips add noisy flanks (src/bam_utils.c:777-788) */
    int64_t n_var = m.n_var, whole = io[O_WHOLE_REF_LEN];
    for (int64_t c = 0; c < n_clip; c++) {
        int64_t i = sc->clip_i[c];
        int left = sc->clip_left[c];
        int64_t cpos = w->ev.pos[i];
        if (!((left && cpos > 10) || (!left && cpos < whole - 10))) continue;
        if (w->ev.len[i] <= io[O_END_CLIP_REG]) continue;
        /* (the reference's cpos > 1 and cpos < whole_ref_len guards
         * hold here) */
        if (left && !left_pal) {
            if (rg_push(&w->rg, cpos - 1, cpos + io[O_FLANK_WIN], 0))
                return -1;
            n_var++;
        } else if (!left && !right_pal) {
            if (rg_push(&w->rg, cpos - 1 - io[O_FLANK_WIN], cpos, 0))
                return -1;
            n_var++;
        }
    }

    /* IntervalSet.from_arrays' order: stable by (start, end) */
    regions_t *rg = &w->rg;
    for (int64_t i = rg0 + 1; i < rg->n; i++) {
        int64_t s = rg->s[i], e = rg->e[i], l = rg->l[i], j = i;
        while (j > rg0 && (rg->s[j - 1] > s
                           || (rg->s[j - 1] == s && rg->e[j - 1] > e))) {
            rg->s[j] = rg->s[j - 1];
            rg->e[j] = rg->e[j - 1];
            rg->l[j] = rg->l[j - 1];
            j--;
        }
        rg->s[j] = s;
        rg->e[j] = e;
        rg->l[j] = l;
    }

    /* the skip policy (src/bam_utils.c:807-813) and the regions the
     * window takes */
    int64_t total = 0;
    for (int64_t i = rg0; i < rg->n; i++) total += rg->e[i] - rg->s[i] + 1;
    double mapped = (double)(rpos - (pos0 + 1));
    if ((double)total > mapped * dopt[0] || (double)n_var > mapped * dopt[1]) {
        w->ev.n = ev0;
        rg->n = rg0;
        return DG_SKIPPED;
    }
    for (int64_t i = rg0; i < rg->n; i++)
        rg->chunk[i] = !(rg->s[i] + 1 > io[O_REG_END]
                         || rg->e[i] < io[O_REG_BEG]);
    return DG_KEPT;
}

static void window_free(window_t *w)
{
    if (!w) return;
    free(w->ev.pos); free(w->ev.type); free(w->ev.len); free(w->ev.qi);
    free(w->ev.low);
    free(w->rg.s); free(w->rg.e); free(w->rg.l); free(w->rg.chunk);
    free(w);
}

/* The reads of a window, in order: record k is raw[raw_off[k] ..
 * raw_off[k + 1]) (a BAM record without its block_size), pal[k] its
 * palindrome flag; ref4 the window's reference from 1-based ref_beg;
 * iopt and dopt the options (dopt: max_noisy_frac_per_read,
 * max_var_ratio_per_read).  Writes status[k], the nt4 sequence of each
 * read at seq[seq_off[k] ..], and the offsets of each read's events
 * (ev_off) and regions (rg_off), n_reads + 1 each; counts[0..1] = events,
 * regions.  Returns the handle for lcd_digar_take, NULL when out of
 * memory. */
void *lcd_digar_window(int64_t n_reads, const uint8_t *raw,
                       const int64_t *raw_off, const uint8_t *pal,
                       const uint8_t *ref4, int64_t ref_len, int64_t ref_beg,
                       const int64_t *iopt, const double *dopt,
                       uint8_t *status, uint8_t *seq, const int64_t *seq_off,
                       int64_t *ev_off, int64_t *rg_off, int64_t *counts)
{
    window_t *w = calloc(1, sizeof(window_t));
    scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    int ok = w != NULL;
    uint8_t nt4_pair[256][2];
    for (int b = 0; b < 256; b++) {
        nt4_pair[b][0] = NT16_NT4[b >> 4];
        nt4_pair[b][1] = NT16_NT4[b & 0xF];
    }
    ev_off[0] = rg_off[0] = 0;
    for (int64_t k = 0; ok && k < n_reads; k++) {
        int st = read_digar(w, &sc, raw + raw_off[k],
                            raw_off[k + 1] - raw_off[k], pal[k], ref4,
                            ref_len, ref_beg, iopt, dopt,
                            (const uint8_t (*)[2])nt4_pair, seq + seq_off[k],
                            seq_off[k + 1] - seq_off[k]);
        if (st < 0) ok = 0;
        status[k] = (uint8_t)st;
        ev_off[k + 1] = ok ? w->ev.n : 0;
        rg_off[k + 1] = ok ? w->rg.n : 0;
    }
    free(sc.pu.pos); free(sc.pu.len); free(sc.pu.cnt); free(sc.csum);
    free(sc.clip_i); free(sc.clip_left);
    if (!ok) {
        window_free(w);
        return NULL;
    }
    counts[0] = w->ev.n;
    counts[1] = w->rg.n;
    return w;
}

void lcd_digar_take(void *h, int64_t *pos, uint8_t *type, int32_t *len,
                    int32_t *qi, uint8_t *low, int64_t *rs, int64_t *re,
                    int64_t *rl, uint8_t *rchunk)
{
    window_t *w = h;
    int64_t n = w->ev.n, m = w->rg.n;
    if (n) {
        memcpy(pos, w->ev.pos, (size_t)n * 8);
        memcpy(type, w->ev.type, (size_t)n);
        memcpy(len, w->ev.len, (size_t)n * 4);
        memcpy(qi, w->ev.qi, (size_t)n * 4);
        memcpy(low, w->ev.low, (size_t)n);
    }
    if (m) {
        memcpy(rs, w->rg.s, (size_t)m * 8);
        memcpy(re, w->rg.e, (size_t)m * 8);
        memcpy(rl, w->rg.l, (size_t)m * 8);
        memcpy(rchunk, w->rg.chunk, (size_t)m);
    }
    window_free(w);
}
