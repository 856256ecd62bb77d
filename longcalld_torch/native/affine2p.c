/* Exact gap-affine-2p global alignment with traceback.
 *
 * Bit-identical C port of the host oracle longcalld_torch/ops/affine_align.py
 * (_align): same BIG saturation, same I1/I2/D1/D2/M tie-break order
 * (np.argmin first-minimum through PERM = [1,2,3,4,0]), same
 * prefix-min insertion recursion, same traceback rules.  The Python side
 * handles the left-gap reversal trick and op-string finishing.
 *
 * Replaces the reference's WFA2-lib (wfa_end2end_aln,
 * reference/src/align.c:374-460) for pairs below the device-batch
 * threshold; larger pairs run on the TPU banded kernel (ops/wfa.py).
 *
 * Traceback plane is one byte per cell:
 *   bits 0-2: source state of the diagonal (M) step, canonical ids
 *             0=M 1=I1 2=I2 3=D1 4=D2
 *   bit 3: I1 extension   bit 4: I2 extension
 *   bit 5: D1 extension   bit 6: D2 extension
 */

#include <stdint.h>
#include <stdlib.h>

#define BIG ((int64_t)1 << 28)

static inline int64_t sat(int64_t v) { return v < BIG ? v : BIG; }

/* Actual-executed-work accounting (process-wide, thread-safe): DP cells
 * really computed by the banded kernel (rows x padded band width), by
 * the full-plane DP, and the greedy-prepass work proxy (wavefront
 * diagonal visits + match-slide steps).  Contrast with the pre-routing
 * pattern x text PRODUCT cells the Python layer tracks: the product is
 * what routing decisions cost out, these are what the CPU truly ran.
 * Surfaced via affine2p_cell_counter() for the bench audit trail, where
 * the executed count is compared against the reference's modeled WFA2
 * wavefront volume (~5 s^2 cells/pair). */
static volatile int64_t g_cells_band = 0;
static volatile int64_t g_cells_full = 0;
static volatile int64_t g_cells_greedy = 0;

int64_t affine2p_cell_counter(int64_t which)
{
    switch ((int)which) {
    case 0: return g_cells_band;
    case 1: return g_cells_full;
    case 2: return g_cells_greedy;
    default:
        g_cells_band = 0; g_cells_full = 0; g_cells_greedy = 0;
        return 0;
    }
}

/* returns number of ops written (reversed order: last op first), or
 * -1 on alloc failure, -2 on inconsistent traceback, -3 on empty input.
 * ops values: 0 = M, 1 = I (consumes text), 2 = D (consumes pattern). */
int affine2p_align(const uint8_t *p, int64_t n, const uint8_t *t, int64_t m,
                   int64_t x, int64_t o1, int64_t e1, int64_t o2, int64_t e2,
                   uint8_t *ops_out, int64_t *score_out)
{
    static const uint8_t PERM[5] = {1, 2, 3, 4, 0};
    int64_t i, j;

    if (n == 0 || m == 0)
        return -3;   /* caller's Python handles the degenerate case */

    uint8_t *tb = (uint8_t *)malloc((size_t)(n + 1) * (size_t)(m + 1));
    int64_t *buf = (int64_t *)malloc(sizeof(int64_t) * 10 * (m + 1));
    if (!tb || !buf) {
        free(tb); free(buf);
        return -1;
    }
    __sync_fetch_and_add(&g_cells_full, (n + 1) * (m + 1));
    int64_t *M  = buf + 0 * (m + 1), *nMr = buf + 5 * (m + 1);
    int64_t *I1 = buf + 1 * (m + 1), *nI1 = buf + 6 * (m + 1);
    int64_t *I2 = buf + 2 * (m + 1), *nI2 = buf + 7 * (m + 1);
    int64_t *D1 = buf + 3 * (m + 1), *nD1 = buf + 8 * (m + 1);
    int64_t *D2 = buf + 4 * (m + 1), *nD2 = buf + 9 * (m + 1);

    M[0] = 0; I1[0] = BIG; I2[0] = BIG; D1[0] = BIG; D2[0] = BIG;
    tb[0] = 0;
    for (j = 1; j <= m; j++) {
        M[j] = BIG; D1[j] = BIG; D2[j] = BIG;
        I1[j] = sat(o1 + e1 * j);
        I2[j] = sat(o2 + e2 * j);
        tb[j] = (uint8_t)((j > 1) ? ((1u << 3) | (1u << 4)) : 0);
    }

    for (i = 1; i <= n; i++) {
        uint8_t *tbrow = tb + (size_t)i * (size_t)(m + 1);
        uint8_t pc = p[i - 1];
        int64_t run1 = BIG, run2 = BIG;   /* prefix mins of nM[g] - g*e */

        /* column 0: only D reachable */
        {
            int64_t open1 = sat(M[0] + o1 + e1), ext1 = sat(D1[0] + e1);
            int64_t open2 = sat(M[0] + o2 + e2), ext2 = sat(D2[0] + e2);
            nD1[0] = open1 < ext1 ? open1 : ext1;
            nD2[0] = open2 < ext2 ? open2 : ext2;
            uint8_t bits = 0;
            if (ext1 < open1) bits |= 1u << 5;
            if (ext2 < open2) bits |= 1u << 6;
            tbrow[0] = bits;
            nMr[0] = BIG; nI1[0] = BIG; nI2[0] = BIG;
        }
        for (j = 1; j <= m; j++) {
            /* diagonal from row i-1, column j-1; argmin order
             * [I1, I2, D1, D2, M], first minimum wins */
            int64_t best = I1[j - 1]; int bi = 0;
            if (I2[j - 1] < best) { best = I2[j - 1]; bi = 1; }
            if (D1[j - 1] < best) { best = D1[j - 1]; bi = 2; }
            if (D2[j - 1] < best) { best = D2[j - 1]; bi = 3; }
            if (M[j - 1]  < best) { best = M[j - 1];  bi = 4; }
            int64_t sub = (pc == t[j - 1]) ? 0 : x;
            int64_t vM = sat(best + sub);
            uint8_t bits = PERM[bi];

            /* D from row i-1 at same column */
            int64_t open1 = sat(M[j] + o1 + e1), ext1 = sat(D1[j] + e1);
            int64_t open2 = sat(M[j] + o2 + e2), ext2 = sat(D2[j] + e2);
            nD1[j] = open1 < ext1 ? open1 : ext1;
            nD2[j] = open2 < ext2 ? open2 : ext2;
            if (ext1 < open1) bits |= 1u << 5;
            if (ext2 < open2) bits |= 1u << 6;

            /* I via prefix-min over g < j of nM[g] - g*e (current row) */
            int64_t prevM = nMr[j - 1];
            if (prevM < BIG) {
                int64_t b1 = prevM - (j - 1) * e1;
                if (b1 < run1) run1 = b1;
                int64_t b2 = prevM - (j - 1) * e2;
                if (b2 < run2) run2 = b2;
            }
            int64_t vI1 = run1 >= BIG ? BIG : sat(run1 + j * e1 + o1);
            int64_t vI2 = run2 >= BIG ? BIG : sat(run2 + j * e2 + o2);
            int64_t adj1 = sat(prevM + o1 + e1);
            int64_t adj2 = sat(prevM + o2 + e2);
            if (vI1 < adj1) bits |= 1u << 3;
            if (vI2 < adj2) bits |= 1u << 4;

            tbrow[j] = bits;
            nMr[j] = vM; nI1[j] = vI1; nI2[j] = vI2;
        }
        /* swap row buffers */
        int64_t *tmp;
        tmp = M;  M  = nMr; nMr = tmp;
        tmp = I1; I1 = nI1; nI1 = tmp;
        tmp = I2; I2 = nI2; nI2 = tmp;
        tmp = D1; D1 = nD1; nD1 = tmp;
        tmp = D2; D2 = nD2; nD2 = tmp;
    }

    /* final state: [I1[m], I2[m], D1[m], D2[m], M[m]], first min */
    int64_t f[5] = {I1[m], I2[m], D1[m], D2[m], M[m]};
    int bi = 0; int64_t best = f[0];
    for (j = 1; j < 5; j++) if (f[j] < best) { best = f[j]; bi = (int)j; }
    int state = PERM[bi];
    *score_out = best;

    int64_t oi = 0, ii = n, jj = m;
    while (ii > 0 || jj > 0) {
        uint8_t bits = tb[(size_t)ii * (size_t)(m + 1) + jj];
        if (state == 0) {
            if (ii == 0) { state = 1; continue; }
            if (jj == 0) { state = 3; continue; }
            ops_out[oi++] = 0;
            state = bits & 7;
            ii--; jj--;
        } else if (state == 1 || state == 2) {
            int ext = (state == 1) ? (bits >> 3) & 1 : (bits >> 4) & 1;
            ops_out[oi++] = 1;
            jj--;
            if (!ext) state = 0;
        } else {
            int ext = (state == 3) ? (bits >> 5) & 1 : (bits >> 6) & 1;
            ops_out[oi++] = 2;
            ii--;
            if (!ext) state = 0;
        }
        if (oi > n + m) {
            free(tb); free(buf);
            return -2;
        }
    }
    free(tb); free(buf);
    return (int)oi;
}

/* Banded variant of affine2p_align in diagonal-band coordinates
 * b = j - i - dlo (the same formulation as the device kernel
 * ops/wfa.py:_banded_dp, where every dependency is a static shift):
 *   M[i][b] from state[i-1][b] (same b) + sub
 *   D[i][b] from (i-1, b+1)
 *   I[i][b] = prefix-min over b' < b of M[i][b'] + o + (b-b')*e
 * Soundness: any path leaving the band first crosses an edge column
 * (b = 0 or b = B-1); the banded prefix cost at that first crossing is
 * achievable, so if the banded optimum is <= every edge-cell value the
 * banded optimum is the global optimum (ops/wfa.py:_reconstruct uses the
 * identical test).  Returns -4 when an out-of-band path could win and the
 * caller must widen the band or run the full DP.
 * cells = n*B instead of n*m: for the high-identity consensus-vs-read
 * pairs of the noisy-region engine this is a 10-50x cell reduction. */
int affine2p_align_band_scalar(const uint8_t *p, int64_t n, const uint8_t *t,
                               int64_t m, int64_t x, int64_t o1, int64_t e1,
                               int64_t o2, int64_t e2, int64_t B,
                               uint8_t *ops_out, int64_t *score_out)
{
    static const uint8_t PERM[5] = {1, 2, 3, 4, 0};
    int64_t i, b;

    if (n == 0 || m == 0)
        return -3;
    int64_t diff = m - n;
    int64_t adiff = diff < 0 ? -diff : diff;
    if (B <= adiff + 1)
        return -4;                     /* band cannot hold both endpoints */
    int64_t dlo = (diff < 0 ? diff : 0) - (B - adiff) / 2;
    int64_t b_final = m - n - dlo;

    uint8_t *tb = (uint8_t *)malloc((size_t)(n + 1) * (size_t)B);
    int32_t *buf = (int32_t *)malloc(sizeof(int32_t) * 14 * (size_t)B);
    if (!tb || !buf) {
        free(tb); free(buf);
        return -1;
    }
    __sync_fetch_and_add(&g_cells_band, n * B);
    int32_t *M  = buf + 0 * B, *nMr = buf + 5 * B;
    int32_t *I1 = buf + 1 * B, *nI1 = buf + 6 * B;
    int32_t *I2 = buf + 2 * B, *nI2 = buf + 7 * B;
    int32_t *D1 = buf + 3 * B, *nD1 = buf + 8 * B;
    int32_t *D2 = buf + 4 * B, *nD2 = buf + 9 * B;
    int32_t *be1 = buf + 10 * B, *c1b = buf + 12 * B;
    int32_t *be2 = buf + 11 * B, *c2b = buf + 13 * B;
    for (b = 0; b < B; b++) {
        be1[b] = (int32_t)(b * e1);
        be2[b] = (int32_t)(b * e2);
    }

#define SAT32(v) ((int32_t)((v) < BIG ? (v) : BIG))
    int64_t edge_min = BIG;
    /* suffix lower bound from an edge cell: reaching the final diagonal
     * b_final needs >= |b_final - b_edge| gap-extension steps, each
     * costing >= min(e1, e2).  Tightens the escape test so the cheap
     * row-0 insertion ramp on the band edge does not force a retry. */
    int64_t min_e = e1 < e2 ? e1 : e2;
    int64_t bl = b_final >= 0 ? b_final : -b_final;
    int64_t br = (B - 1) - b_final; if (br < 0) br = -br;
    bl *= min_e; br *= min_e;
    /* row 0: j0 = dlo + b */
    for (b = 0; b < B; b++) {
        int64_t j0 = dlo + b;
        M[b] = (j0 == 0) ? 0 : (int32_t)BIG;
        D1[b] = (int32_t)BIG; D2[b] = (int32_t)BIG;
        if (j0 > 0 && j0 <= m) {
            I1[b] = SAT32(o1 + e1 * j0);
            I2[b] = SAT32(o2 + e2 * j0);
        } else {
            I1[b] = (int32_t)BIG; I2[b] = (int32_t)BIG;
        }
        tb[b] = (uint8_t)((j0 > 1) ? ((1u << 3) | (1u << 4)) : 0);
    }
    /* row-0 edge contribution (ops/wfa.py:146-151) */
    {
        int64_t e0 = M[0];
        if (I1[0] < e0) e0 = I1[0];
        if (I2[0] < e0) e0 = I2[0];
        int64_t e1c = M[B - 1];
        if (I1[B - 1] < e1c) e1c = I1[B - 1];
        if (I2[B - 1] < e1c) e1c = I2[B - 1];
        e0 = sat(e0 + bl); e1c = sat(e1c + br);
        if (e0 < edge_min) edge_min = e0;
        if (e1c < edge_min) edge_min = e1c;
    }

    /* The row body is split into simple per-state passes over int32 arrays
     * (everything is <= BIG = 1<<28, so int32 adds cannot overflow): the
     * diagonal/deletion passes and the insertion finish are
     * auto-vectorizable; only the thin prefix-min scan stays sequential.
     * Semantics are identical to the fused scalar loop this replaces. */
    int32_t xi = (int32_t)x;
    int32_t oe1 = (int32_t)(o1 + e1), oe2 = (int32_t)(o2 + e2);
    int32_t e1i = (int32_t)e1, e2i = (int32_t)e2;
    for (i = 1; i <= n; i++) {
        uint8_t *tbrow = tb + (size_t)i * (size_t)B;
        uint8_t pc = p[i - 1];

        /* restrict views of the current/next planes: the planes come
         * from disjoint slices of one allocation, and telling the
         * compiler so removes the runtime alias-check versioning of the
         * vectorized passes */
        const int32_t *restrict Mp = M, *restrict I1p = I1,
            *restrict I2p = I2, *restrict D1p = D1, *restrict D2p = D2;
        int32_t *restrict nMp = nMr, *restrict nI1p = nI1,
            *restrict nI2p = nI2, *restrict nD1p = nD1,
            *restrict nD2p = nD2, *restrict c1p = c1b,
            *restrict c2p = c2b;
        const int32_t *restrict be1p = be1, *restrict be2p = be2;
        uint8_t *restrict tbr = tbrow;

        /* pass A: diagonal best (prev row, same b) -> vM + source bits.
         * tie order I1 < I2 < D1 < D2 < M with state codes 1,2,3,4,0 */
        int64_t j0r = i + dlo;              /* j at b = 0 */
        int64_t blo = 1 - j0r; if (blo < 0) blo = 0; if (blo > B) blo = B;
        int64_t bhi = m - j0r; if (bhi > B - 1) bhi = B - 1;
        for (b = 0; b < B; b++) {
            int32_t best = I1p[b]; uint8_t code = 1;
            if (I2p[b] < best) { best = I2p[b]; code = 2; }
            if (D1p[b] < best) { best = D1p[b]; code = 3; }
            if (D2p[b] < best) { best = D2p[b]; code = 4; }
            if (Mp[b]  < best) { best = Mp[b];  code = 0; }
            nMp[b] = best;                  /* diag best; sub added below */
            tbr[b] = code;
        }
        for (b = 0; b < blo; b++) nMp[b] = (int32_t)BIG;
        if (blo <= bhi) {
            const uint8_t *restrict trow = t + j0r - 1;  /* t[j-1] at b */
            for (b = blo; b <= bhi; b++) {
                int32_t v = nMp[b] + ((pc == trow[b]) ? 0 : xi);
                nMp[b] = v < (int32_t)BIG ? v : (int32_t)BIG;
            }
        }
        for (b = (blo <= bhi ? bhi + 1 : blo); b < B; b++)
            nMp[b] = (int32_t)BIG;

        /* pass B: deletions from (i-1, b+1) + extend bits */
        for (b = 0; b < B - 1; b++) {
            int32_t open1 = Mp[b + 1] + oe1;
            if (open1 > (int32_t)BIG) open1 = (int32_t)BIG;
            int32_t ext1 = D1p[b + 1] + e1i;
            if (ext1 > (int32_t)BIG) ext1 = (int32_t)BIG;
            int32_t open2 = Mp[b + 1] + oe2;
            if (open2 > (int32_t)BIG) open2 = (int32_t)BIG;
            int32_t ext2 = D2p[b + 1] + e2i;
            if (ext2 > (int32_t)BIG) ext2 = (int32_t)BIG;
            nD1p[b] = ext1 < open1 ? ext1 : open1;
            nD2p[b] = ext2 < open2 ? ext2 : open2;
            tbr[b] |= (uint8_t)(((ext1 < open1) ? 1u << 5 : 0)
                                | ((ext2 < open2) ? 1u << 6 : 0));
        }
        nD1p[B - 1] = (int32_t)BIG;
        nD2p[B - 1] = (int32_t)BIG;

        /* pass C: insertions via the exclusive prefix-min of
         * (vM[b'] - b'*e) over b' < b.  Split so only the thin two-chain
         * running-min loop (C2) is sequential; the base terms (C1) and
         * the insertion/adjacency finish (C3) auto-vectorize.  BIG
         * semantics identical to the fused loop this replaces: invalid
         * vM contributes BIG, and BIG + offsets still clamps to BIG. */
        for (b = 0; b < B; b++) {                       /* C1 */
            int32_t vM = nMp[b];
            c1p[b] = vM < (int32_t)BIG ? vM - be1p[b] : (int32_t)BIG;
            c2p[b] = vM < (int32_t)BIG ? vM - be2p[b] : (int32_t)BIG;
        }
        {                                               /* C2 */
            int32_t r1 = (int32_t)BIG, r2 = (int32_t)BIG;
            for (b = 0; b < B; b++) {
                int32_t t1 = c1p[b], t2 = c2p[b];
                c1p[b] = r1; c2p[b] = r2;
                r1 = t1 < r1 ? t1 : r1;
                r2 = t2 < r2 ? t2 : r2;
            }
        }
        {                                               /* C3, b = 0: the
             * exclusive prefix is BIG there, so vI = BIG and (no prevM)
             * the adjacency bits stay clear, as in the fused loop */
            nI1p[0] = (int32_t)BIG;
            nI2p[0] = (int32_t)BIG;
        }
        for (b = 1; b < B; b++) {                       /* C3, vector */
            int32_t v1 = c1p[b] + be1p[b] + oe1 - e1i;
            int32_t v2 = c2p[b] + be2p[b] + oe2 - e2i;
            int32_t vI1 = v1 < (int32_t)BIG ? v1 : (int32_t)BIG;
            int32_t vI2 = v2 < (int32_t)BIG ? v2 : (int32_t)BIG;
            int32_t prevM = nMp[b - 1];
            int32_t adj1 = prevM + oe1;
            adj1 = adj1 < (int32_t)BIG ? adj1 : (int32_t)BIG;
            int32_t adj2 = prevM + oe2;
            adj2 = adj2 < (int32_t)BIG ? adj2 : (int32_t)BIG;
            tbr[b] |= (uint8_t)(((vI1 < adj1) ? 1u << 3 : 0)
                                | ((vI2 < adj2) ? 1u << 4 : 0));
            nI1p[b] = vI1; nI2p[b] = vI2;
        }
        /* band-edge soundness tracking (rows the path could leave from) */
        {
            int64_t e0 = nMr[0];
            if (nI1[0] < e0) e0 = nI1[0];
            if (nI2[0] < e0) e0 = nI2[0];
            if (nD1[0] < e0) e0 = nD1[0];
            if (nD2[0] < e0) e0 = nD2[0];
            int64_t e1c = nMr[B - 1];
            if (nI1[B - 1] < e1c) e1c = nI1[B - 1];
            if (nI2[B - 1] < e1c) e1c = nI2[B - 1];
            if (nD1[B - 1] < e1c) e1c = nD1[B - 1];
            if (nD2[B - 1] < e1c) e1c = nD2[B - 1];
            e0 = sat(e0 + bl); e1c = sat(e1c + br);
            if (e0 < edge_min) edge_min = e0;
            if (e1c < edge_min) edge_min = e1c;
        }
        int32_t *tmp;
        tmp = M;  M  = nMr; nMr = tmp;
        tmp = I1; I1 = nI1; nI1 = tmp;
        tmp = I2; I2 = nI2; nI2 = tmp;
        tmp = D1; D1 = nD1; nD1 = tmp;
        tmp = D2; D2 = nD2; nD2 = tmp;
    }

    int64_t f[5] = {I1[b_final], I2[b_final], D1[b_final], D2[b_final],
                    M[b_final]};
    int bi = 0; int64_t best = f[0];
    for (b = 1; b < 5; b++) if (f[b] < best) { best = f[b]; bi = (int)b; }
    int state = PERM[bi];
    *score_out = best;
    if (best >= BIG || edge_min < best) {
        free(tb); free(buf);
        return -4;                          /* escape: widen band / full DP */
    }

    int64_t oi = 0, ii = n, bb = b_final;
    while (ii > 0 || ii + dlo + bb > 0) {
        if (bb < 0 || bb >= B) { free(tb); free(buf); return -4; }
        uint8_t bits = tb[(size_t)ii * (size_t)B + bb];
        if (state == 0) {
            if (ii == 0) { state = 1; continue; }
            if (ii + dlo + bb == 0) { state = 3; continue; }
            ops_out[oi++] = 0;
            state = bits & 7;
            ii--;                            /* diagonal: same b */
        } else if (state == 1 || state == 2) {
            int ext = (state == 1) ? (bits >> 3) & 1 : (bits >> 4) & 1;
            ops_out[oi++] = 1;
            bb--;                            /* j-- at same i */
            if (!ext) state = 0;
        } else {
            int ext = (state == 3) ? (bits >> 5) & 1 : (bits >> 6) & 1;
            ops_out[oi++] = 2;
            ii--; bb++;                      /* i-- at same j */
            if (!ext) state = 0;
        }
        if (oi > n + m) {
            free(tb); free(buf);
            return -2;
        }
    }
    free(tb); free(buf);
    return (int)oi;
#undef SAT32
}

/* ------------------------------------------------------------------ */
/* Fused 16-lane vector row kernel for the banded DP (the production
 * affine2p_align_band).  Same contract and BIT-IDENTICAL semantics as
 * affine2p_align_band_scalar above — the band geometry (B, dlo, escape
 * test) is unchanged; only the internal compute width is padded to a
 * multiple of 16 lanes, and pad lanes are proven inert: their diagonal
 * values stay BIG (the valid-j mask excludes them, b > bhi >= B-1), so
 * they contribute nothing to D (reads of lane b+1 see BIG), nothing to
 * the insertion prefix-min (base terms are BIG), and nothing to the
 * edge/escape accounting (which reads lanes 0 and B-1 exactly).  One
 * fused pass per row keeps all five state updates, the two insertion
 * prefix-min chains (log-step lane shifts), the traceback-bit packing
 * (int32 lanes narrowed to one byte per cell) and the stores in
 * straight-line vector code: ~10x fewer per-row cycles than the scalar
 * multi-pass formulation at the narrow bands the greedy-guided routing
 * produces.  GNU C vector extensions only — no intrinsics, portable
 * (gcc lowers to AVX-512/AVX2/SSE or scalar as available). */

typedef int32_t v16i __attribute__((vector_size(64)));
typedef uint8_t v16b __attribute__((vector_size(16)));

#if defined(__AVX512F__)
#include <immintrin.h>
static inline v16i vmin16(v16i a, v16i b)
{
    return (v16i)_mm512_min_epi32((__m512i)a, (__m512i)b);
}
#else
static inline v16i vmin16(v16i a, v16i b)
{
    v16i m = a < b;
    return (a & m) | (b & ~m);
}
#endif

static inline v16i vsplat(int32_t s)
{
    v16i v = {0};
    return v + s;
}

/* lane shifts toward higher index; vacated low lanes take `fill` */
static inline v16i vshr1(v16i v, v16i fill)
{
    return __builtin_shufflevector(fill, v, 15, 16, 17, 18, 19, 20, 21,
                                   22, 23, 24, 25, 26, 27, 28, 29, 30);
}

static inline v16i vshr2(v16i v, v16i fill)
{
    return __builtin_shufflevector(fill, v, 14, 15, 16, 17, 18, 19, 20,
                                   21, 22, 23, 24, 25, 26, 27, 28, 29);
}

static inline v16i vshr4(v16i v, v16i fill)
{
    return __builtin_shufflevector(fill, v, 12, 13, 14, 15, 16, 17, 18,
                                   19, 20, 21, 22, 23, 24, 25, 26, 27);
}

static inline v16i vshr8(v16i v, v16i fill)
{
    return __builtin_shufflevector(fill, v, 8, 9, 10, 11, 12, 13, 14, 15,
                                   16, 17, 18, 19, 20, 21, 22, 23);
}

static inline v16i vload(const int32_t *ptr)
{
    v16i v;
    __builtin_memcpy(&v, ptr, 64);
    return v;
}

static inline void vstore(int32_t *ptr, v16i v)
{
    __builtin_memcpy(ptr, &v, 64);
}

int affine2p_align_band(const uint8_t *p, int64_t n, const uint8_t *t,
                        int64_t m, int64_t x, int64_t o1, int64_t e1,
                        int64_t o2, int64_t e2, int64_t B,
                        uint8_t *ops_out, int64_t *score_out)
{
    static const uint8_t PERM[5] = {1, 2, 3, 4, 0};
    int64_t i, b;

    if (n == 0 || m == 0)
        return -3;
    int64_t diff = m - n;
    int64_t adiff = diff < 0 ? -diff : diff;
    if (B <= adiff + 1)
        return -4;
    int64_t dlo = (diff < 0 ? diff : 0) - (B - adiff) / 2;
    int64_t b_final = m - n - dlo;
    int64_t Wp = (B + 15) & ~(int64_t)15;        /* compute width */
    int64_t NV = Wp / 16;

    uint8_t *tb = (uint8_t *)malloc((size_t)(n + 1) * (size_t)Wp);
    /* 10 state planes + be1/be2, each Wp + 16 tail pad kept at BIG so
     * the b+1 loads of the last block read BIG */
    int64_t PL = Wp + 16;
    int32_t *buf = (int32_t *)malloc(sizeof(int32_t) * 12 * (size_t)PL
                                     + 63);
    if (!tb || !buf) {
        free(tb); free(buf);
        return -1;
    }
    __sync_fetch_and_add(&g_cells_band, n * Wp);
    int32_t *base = (int32_t *)(((uintptr_t)buf + 63) & ~(uintptr_t)63);
    /* NOTE: base points into buf's allocation (alignment slack of 63
     * bytes was reserved); one plane slot is sacrificed for alignment */
    int32_t *M  = base + 0 * PL, *nMr = base + 5 * PL;
    int32_t *I1 = base + 1 * PL, *nI1 = base + 6 * PL;
    int32_t *I2 = base + 2 * PL, *nI2 = base + 7 * PL;
    int32_t *D1 = base + 3 * PL, *nD1 = base + 8 * PL;
    int32_t *D2 = base + 4 * PL, *nD2 = base + 9 * PL;
    int32_t *be1 = base + 10 * PL;
    int32_t *be2 = base + 11 * PL - 16;   /* be2 needs no tail pad */
    for (b = 0; b < Wp; b++) {
        be1[b] = (int32_t)(b * e1);
        be2[b] = (int32_t)(b * e2);
    }

#define SAT32(v) ((int32_t)((v) < BIG ? (v) : BIG))
    int64_t edge_min = BIG;
    int64_t min_e = e1 < e2 ? e1 : e2;
    int64_t bl = b_final >= 0 ? b_final : -b_final;
    int64_t br = (B - 1) - b_final; if (br < 0) br = -br;
    bl *= min_e; br *= min_e;
    /* row 0 (j0 = dlo + b); pad lanes b >= B forced to BIG everywhere */
    for (b = 0; b < PL; b++) {
        int64_t j0 = dlo + b;
        int valid = b < B;
        M[b] = (valid && j0 == 0) ? 0 : (int32_t)BIG;
        D1[b] = (int32_t)BIG; D2[b] = (int32_t)BIG;
        nMr[b] = (int32_t)BIG; nD1[b] = (int32_t)BIG; nD2[b] = (int32_t)BIG;
        nI1[b] = (int32_t)BIG; nI2[b] = (int32_t)BIG;
        if (valid && j0 > 0 && j0 <= m) {
            I1[b] = SAT32(o1 + e1 * j0);
            I2[b] = SAT32(o2 + e2 * j0);
        } else {
            I1[b] = (int32_t)BIG; I2[b] = (int32_t)BIG;
        }
        if (b < Wp)
            tb[b] = (uint8_t)((valid && j0 > 1) ? ((1u << 3) | (1u << 4))
                              : 0);
    }
    {
        int64_t e0 = M[0];
        if (I1[0] < e0) e0 = I1[0];
        if (I2[0] < e0) e0 = I2[0];
        int64_t e1c = M[B - 1];
        if (I1[B - 1] < e1c) e1c = I1[B - 1];
        if (I2[B - 1] < e1c) e1c = I2[B - 1];
        e0 = sat(e0 + bl); e1c = sat(e1c + br);
        if (e0 < edge_min) edge_min = e0;
        if (e1c < edge_min) edge_min = e1c;
    }

    const v16i BIGv = {BIG, BIG, BIG, BIG, BIG, BIG, BIG, BIG,
                       BIG, BIG, BIG, BIG, BIG, BIG, BIG, BIG};
    const v16i IOTA = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                       15};
    const int32_t xi = (int32_t)x;
    const int32_t oe1 = (int32_t)(o1 + e1), oe2 = (int32_t)(o2 + e2);
    const int32_t e1i = (int32_t)e1, e2i = (int32_t)e2;
    const int32_t oi1 = (int32_t)o1, oi2 = (int32_t)o2;

    for (i = 1; i <= n; i++) {
        uint8_t *restrict tbrow = tb + (size_t)i * (size_t)Wp;
        const int32_t pc = (int32_t)p[i - 1];
        int64_t j0r = i + dlo;
        int64_t blo = 1 - j0r; if (blo < 0) blo = 0; if (blo > B) blo = B;
        int64_t bhi = m - j0r; if (bhi > B - 1) bhi = B - 1;
        const v16i pcv = vsplat(pc);
        const v16i blov = vsplat((int32_t)blo), bhiv = vsplat((int32_t)bhi);
        int32_t carry1 = (int32_t)BIG, carry2 = (int32_t)BIG;
        int32_t prev_last = (int32_t)BIG;           /* nM[lane -1] */

        for (int64_t vb = 0; vb < NV; vb++) {
            const int64_t L0 = vb * 16;
            const v16i i1v = vload(I1 + L0), i2v = vload(I2 + L0);
            const v16i d1v = vload(D1 + L0), d2v = vload(D2 + L0);
            const v16i mv = vload(M + L0);

            /* pass A: diagonal 5-way min, PERM tie order (I1 I2 D1 D2 M
             * -> codes 1 2 3 4 0, first strict minimum wins) */
            v16i best = i1v, code = vsplat(1);
            v16i msk = i2v < best;
            best = vmin16(i2v, best);
            code = (code & ~msk) | (msk & 2);
            msk = d1v < best;
            best = vmin16(d1v, best);
            code = (code & ~msk) | (msk & 3);
            msk = d2v < best;
            best = vmin16(d2v, best);
            code = (code & ~msk) | (msk & 4);
            msk = mv < best;
            best = vmin16(mv, best);
            code = code & ~msk;                       /* M -> 0 */

            /* substitution + valid-j mask */
            v16i lane = IOTA + vsplat((int32_t)L0);
            v16i valid = (lane >= blov) & (lane <= bhiv);
            v16i txt;
            {
                int64_t tbase = j0r - 1 + L0;
                if (tbase >= 0 && tbase + 15 < m) {
                    v16b tb8;
                    __builtin_memcpy(&tb8, t + tbase, 16);
                    txt = __builtin_convertvector(tb8, v16i);
                } else {                    /* boundary rows: guarded */
                    int32_t tmp[16];
                    for (int64_t q = 0; q < 16; q++) {
                        int64_t jj = tbase + q;
                        tmp[q] = (jj >= 0 && jj < m) ? t[jj] : -1;
                    }
                    txt = vload(tmp);
                }
            }
            v16i sub = (~(txt == pcv)) & vsplat(xi);
            v16i nM = vmin16(best + sub, BIGv);
            nM = (nM & valid) | (BIGv & ~valid);

            /* pass B: D from (i-1, b+1) — unaligned next-lane loads */
            const v16i mv1 = vload(M + L0 + 1);
            const v16i d1v1 = vload(D1 + L0 + 1);
            const v16i d2v1 = vload(D2 + L0 + 1);
            v16i open1 = vmin16(mv1 + vsplat(oe1), BIGv);
            v16i ext1 = vmin16(d1v1 + vsplat(e1i), BIGv);
            v16i nD1v = vmin16(ext1, open1);
            v16i d1e = ext1 < open1;
            v16i open2 = vmin16(mv1 + vsplat(oe2), BIGv);
            v16i ext2 = vmin16(d2v1 + vsplat(e2i), BIGv);
            v16i nD2v = vmin16(ext2, open2);
            v16i d2e = ext2 < open2;

            /* pass C: I via exclusive prefix-min of (nM - b*e) */
            const v16i be1v = vload(be1 + L0), be2v = vload(be2 + L0);
            v16i okM = nM < BIGv;
            v16i base1 = ((nM - be1v) & okM) | (BIGv & ~okM);
            v16i base2 = ((nM - be2v) & okM) | (BIGv & ~okM);
            v16i p1 = vmin16(base1, vshr1(base1, BIGv));
            p1 = vmin16(p1, vshr2(p1, BIGv));
            p1 = vmin16(p1, vshr4(p1, BIGv));
            p1 = vmin16(p1, vshr8(p1, BIGv));
            v16i p2 = vmin16(base2, vshr1(base2, BIGv));
            p2 = vmin16(p2, vshr2(p2, BIGv));
            p2 = vmin16(p2, vshr4(p2, BIGv));
            p2 = vmin16(p2, vshr8(p2, BIGv));
            v16i c1v = vsplat(carry1);
            v16i c2v = vsplat(carry2);
            v16i run1 = vmin16(vshr1(p1, c1v), c1v);   /* exclusive */
            v16i run2 = vmin16(vshr1(p2, c2v), c2v);
            carry1 = p1[15] < carry1 ? p1[15] : carry1;
            carry2 = p2[15] < carry2 ? p2[15] : carry2;
            v16i vI1 = vmin16(run1 + be1v + vsplat(oi1), BIGv);
            v16i vI2 = vmin16(run2 + be2v + vsplat(oi2), BIGv);
            v16i prevM = vshr1(nM, vsplat(prev_last));
            prev_last = nM[15];
            v16i adj1 = vmin16(prevM + vsplat(oe1), BIGv);
            v16i adj2 = vmin16(prevM + vsplat(oe2), BIGv);
            v16i i1e = vI1 < adj1;
            v16i i2e = vI2 < adj2;

            /* traceback byte: bits 0-2 code, 3/4 I-ext, 5/6 D-ext */
            v16i bits = code | (i1e & vsplat(8)) | (i2e & vsplat(16))
                | (d1e & vsplat(32)) | (d2e & vsplat(64));
            v16b bits8 = __builtin_convertvector(bits, v16b);
            __builtin_memcpy(tbrow + L0, &bits8, 16);

            vstore(nMr + L0, nM);
            vstore(nI1 + L0, vI1);
            vstore(nI2 + L0, vI2);
            vstore(nD1 + L0, nD1v);
            vstore(nD2 + L0, nD2v);
        }

        /* band-edge soundness tracking (lanes 0 and B-1 exactly) */
        {
            int64_t e0 = nMr[0];
            if (nI1[0] < e0) e0 = nI1[0];
            if (nI2[0] < e0) e0 = nI2[0];
            if (nD1[0] < e0) e0 = nD1[0];
            if (nD2[0] < e0) e0 = nD2[0];
            int64_t e1c = nMr[B - 1];
            if (nI1[B - 1] < e1c) e1c = nI1[B - 1];
            if (nI2[B - 1] < e1c) e1c = nI2[B - 1];
            if (nD1[B - 1] < e1c) e1c = nD1[B - 1];
            if (nD2[B - 1] < e1c) e1c = nD2[B - 1];
            e0 = sat(e0 + bl); e1c = sat(e1c + br);
            if (e0 < edge_min) edge_min = e0;
            if (e1c < edge_min) edge_min = e1c;
        }
        int32_t *tmp;
        tmp = M;  M  = nMr; nMr = tmp;
        tmp = I1; I1 = nI1; nI1 = tmp;
        tmp = I2; I2 = nI2; nI2 = tmp;
        tmp = D1; D1 = nD1; nD1 = tmp;
        tmp = D2; D2 = nD2; nD2 = tmp;
    }

    int64_t f[5] = {I1[b_final], I2[b_final], D1[b_final], D2[b_final],
                    M[b_final]};
    int bi = 0; int64_t best = f[0];
    for (b = 1; b < 5; b++) if (f[b] < best) { best = f[b]; bi = (int)b; }
    int state = PERM[bi];
    *score_out = best;
    if (best >= BIG || edge_min < best) {
        free(tb); free(buf);
        return -4;
    }

    int64_t oi = 0, ii = n, bb = b_final;
    while (ii > 0 || ii + dlo + bb > 0) {
        if (bb < 0 || bb >= B) { free(tb); free(buf); return -4; }
        uint8_t bits = tb[(size_t)ii * (size_t)Wp + bb];
        if (state == 0) {
            if (ii == 0) { state = 1; continue; }
            if (ii + dlo + bb == 0) { state = 3; continue; }
            ops_out[oi++] = 0;
            state = bits & 7;
            ii--;
        } else if (state == 1 || state == 2) {
            int ext = (state == 1) ? (bits >> 3) & 1 : (bits >> 4) & 1;
            ops_out[oi++] = 1;
            bb--;
            if (!ext) state = 0;
        } else {
            int ext = (state == 3) ? (bits >> 5) & 1 : (bits >> 6) & 1;
            ops_out[oi++] = 2;
            ii--; bb++;
            if (!ext) state = 0;
        }
        if (oi > n + m) {
            free(tb); free(buf);
            return -2;
        }
    }
    free(tb); free(buf);
    return (int)oi;
#undef SAT32
}

/* Unit-cost global edit DP + traceback counting #mismatches + #gap-opens
 * (the POA admission screen; mirrors core/align_screen.py edit_xgaps_nw,
 * itself the edlib_xgaps analog of reference/src/align.c:189-233).
 * Traceback preference matches the Python exactly: diagonal, then query
 * gap (up), then target gap (left).  Returns -1 on alloc failure. */
/* Plain edit distance, global (hw=0) or infix/HW (hw=1: free target
 * prefix and suffix — row 0 is all zeros and the result is the minimum of
 * the last row).  Mirrors align_screen.edit_distance_nw / _hw. */
int64_t edit_distance(const uint8_t *t, int64_t n, const uint8_t *q,
                      int64_t m, int64_t hw)
{
    int64_t i, j;
    if (n == 0)
        return m;
    int32_t *buf = (int32_t *)malloc(sizeof(int32_t) * 2 * (size_t)(n + 1));
    if (!buf)
        return -1;
    int32_t *prev = buf, *cur = buf + n + 1;
    for (j = 0; j <= n; j++)
        prev[j] = hw ? 0 : (int32_t)j;
    for (i = 1; i <= m; i++) {
        uint8_t qb = q[i - 1];
        cur[0] = (int32_t)i;
        for (j = 1; j <= n; j++) {
            int32_t best = prev[j - 1] + (t[j - 1] != qb);
            int32_t del = prev[j] + 1;
            if (del < best) best = del;
            int32_t ins = cur[j - 1] + 1;
            if (ins < best) best = ins;
            cur[j] = best;
        }
        int32_t *tmp = prev; prev = cur; cur = tmp;
    }
    int64_t res;
    if (hw) {
        int32_t mn = prev[0];
        for (j = 1; j <= n; j++)
            if (prev[j] < mn) mn = prev[j];
        res = mn;
    } else {
        res = prev[n];
    }
    free(buf);
    return res;
}

int64_t edit_xgaps_nw(const uint8_t *t, int64_t n, const uint8_t *q,
                      int64_t m)
{
    if (n == 0 || m == 0)
        return (n || m) ? 1 : 0;
    int32_t *d = (int32_t *)malloc(sizeof(int32_t) * (size_t)(m + 1)
                                   * (size_t)(n + 1));
    if (!d)
        return -1;
    int64_t i, j;
    for (j = 0; j <= n; j++)
        d[j] = (int32_t)j;
    for (i = 1; i <= m; i++) {
        int32_t *row = d + i * (n + 1);
        const int32_t *prev = row - (n + 1);
        uint8_t qb = q[i - 1];
        int32_t left = (int32_t)i;
        row[0] = left;
        for (j = 1; j <= n; j++) {
            int32_t v = prev[j - 1] + (t[j - 1] != qb);
            int32_t up = prev[j] + 1;
            if (up < v) v = up;
            int32_t lf = left + 1;
            if (lf < v) v = lf;
            row[j] = v;
            left = v;
        }
    }
    i = m; j = n;
    int64_t n_mm = 0, n_gaps = 0;
    int last_gap = 0;
    while (i > 0 || j > 0) {
        int32_t v = d[i * (n + 1) + j];
        if (i > 0 && j > 0
                && d[(i - 1) * (n + 1) + j - 1] + (t[j - 1] != q[i - 1]) == v) {
            n_mm += (t[j - 1] != q[i - 1]);
            i--; j--;
            last_gap = 0;
        } else if (i > 0 && d[(i - 1) * (n + 1) + j] + 1 == v) {
            if (last_gap != 1) n_gaps++;
            last_gap = 1;
            i--;
        } else {
            if (last_gap != 2) n_gaps++;
            last_gap = 2;
            j--;
        }
    }
    free(d);
    return n_mm + n_gaps;
}

/* ------------------------------------------------------------------ */
/* Greedy unit-cost wavefront prepass (Myers O(nd) diff extended with
 * substitutions): finds SOME alignment with the fewest unit edits, then
 * prices that concrete path under the affine-2p model.  The result is a
 * true upper bound s_ub on the optimal affine score, which lets the
 * caller pick a band width that provably cannot trip the band-escape
 * test (see guided_band below) — one banded pass replaces the blind
 * B, 4B, 16B... retry ladder.  This is the role WFA2-lib's wavefronts
 * play in the reference (reference/src/align.c:374-460): O(nd)
 * work on the near-identical pairs that dominate the workload. */

static inline int64_t gap_min(int64_t L, int64_t o1, int64_t e1,
                              int64_t o2, int64_t e2)
{
    int64_t g1 = o1 + e1 * L, g2 = o2 + e2 * L;
    return g1 < g2 ? g1 : g2;
}

/* Returns the affine cost of the greedy unit-cost path (0 = sequences
 * identical), or -1 when the edit distance exceeds dcap / the slide-work
 * budget trips / allocation fails — caller falls back to the classic
 * routing.  Requires n >= 1 and m >= 1. */
static int64_t greedy_ub(const uint8_t *p, int64_t n, const uint8_t *t,
                         int64_t m, int64_t x, int64_t o1, int64_t e1,
                         int64_t o2, int64_t e2, int64_t dcap)
{
    int64_t kend = m - n, d, k;

    if (kend > dcap || -kend > dcap)
        return -1;
    int64_t i0 = 0;
    while (i0 < n && i0 < m && p[i0] == t[i0])
        i0++;
    if (i0 >= n && i0 >= m) {
        __sync_fetch_and_add(&g_cells_greedy, i0);
        return 0;                         /* identical */
    }
    /* F triangle: level d at offset d*d, width 2d+1;
     * F[d*d + (k+d)] = furthest pattern index i (matches slid) on
     * diagonal k = j - i after d edits; -1 = unreachable */
    int32_t *F = (int32_t *)malloc(sizeof(int32_t)
                                   * (size_t)((dcap + 1) * (dcap + 1)));
    if (!F)
        return -1;
    F[0] = (int32_t)i0;
    int64_t found_d = -1;
    const int64_t budget0 = 16 * (n + m) + 4 * dcap * dcap;
    int64_t budget = budget0;
    for (d = 1; d <= dcap && found_d < 0; d++) {
        int32_t *cur = F + d * d;
        const int32_t *prev = F + (d - 1) * (d - 1);
        for (k = -d; k <= d; k++) {
            int64_t best = -1, v;
            /* substitution from (d-1, k) */
            if (k >= -(d - 1) && k <= d - 1) {
                v = prev[k + (d - 1)];
                if (v >= 0 && v < n && v + k < m && v + 1 > best)
                    best = v + 1;
            }
            /* deletion (consume pattern) from (d-1, k+1) */
            if (k + 1 >= -(d - 1) && k + 1 <= d - 1) {
                v = prev[k + 1 + (d - 1)];
                if (v >= 0 && v < n && v + 1 > best)
                    best = v + 1;
            }
            /* insertion (consume text) from (d-1, k-1) */
            if (k - 1 >= -(d - 1) && k - 1 <= d - 1) {
                v = prev[k - 1 + (d - 1)];
                if (v >= 0 && v + (k - 1) < m && v > best)
                    best = v;
            }
            if (best < 0) {
                cur[k + d] = -1;
                continue;
            }
            int64_t i = best, j = best + k;
            while (i < n && j < m && p[i] == t[j]) {
                i++; j++; budget--;
            }
            cur[k + d] = (int32_t)i;
            if (k == kend && i >= n) {
                found_d = d;
                break;
            }
            budget -= 2;
            if (budget < 0) {
                free(F);
                __sync_fetch_and_add(&g_cells_greedy, i0 + budget0);
                return -1;
            }
        }
    }
    __sync_fetch_and_add(&g_cells_greedy, i0 + (budget0 - budget));
    if (found_d < 0) {
        free(F);
        return -1;
    }
    /* backtrace (recomputing each level's winning candidate, which by
     * construction equals the forward pass's pre-slide value): record per
     * level the op and the match-slide length that FOLLOWED the edit, so
     * indel runs can be merged exactly when nothing separates them */
    uint8_t *opl = (uint8_t *)malloc((size_t)found_d);      /* 0=X 1=I 2=D */
    int64_t *sl = (int64_t *)malloc(sizeof(int64_t) * (size_t)found_d);
    if (!opl || !sl) {
        free(F); free(opl); free(sl);
        return -1;
    }
    k = kend;
    int64_t iend = n;
    for (d = found_d; d >= 1; d--) {
        const int32_t *prev = F + (d - 1) * (d - 1);
        int64_t best = -1, v;
        uint8_t op = 0;
        if (k >= -(d - 1) && k <= d - 1) {
            v = prev[k + (d - 1)];
            if (v >= 0 && v < n && v + k < m && v + 1 > best) {
                best = v + 1; op = 0;
            }
        }
        if (k + 1 >= -(d - 1) && k + 1 <= d - 1) {
            v = prev[k + 1 + (d - 1)];
            if (v >= 0 && v < n && v + 1 > best) {
                best = v + 1; op = 2;
            }
        }
        if (k - 1 >= -(d - 1) && k - 1 <= d - 1) {
            v = prev[k - 1 + (d - 1)];
            if (v >= 0 && v + (k - 1) < m && v > best) {
                best = v; op = 1;
            }
        }
        opl[d - 1] = op;
        sl[d - 1] = iend - best;
        if (op == 0) {
            iend = best - 1;
        } else if (op == 2) {
            iend = best - 1; k = k + 1;
        } else {
            iend = best; k = k - 1;
        }
    }
    /* price the path: substitutions at x, each maximal indel run at the
     * cheaper of the two gap penalties (matches the affine-2p model) */
    int64_t cost = 0, run_len = 0;
    uint8_t run_op = 255;
    for (d = 0; d < found_d; d++) {
        uint8_t op = opl[d];
        if (op == 0) {
            if (run_len) {
                cost += gap_min(run_len, o1, e1, o2, e2);
                run_len = 0;
            }
            cost += x;
        } else {
            if (run_len && run_op != op) {
                cost += gap_min(run_len, o1, e1, o2, e2);
                run_len = 0;
            }
            run_len++;
            run_op = op;
        }
        if (sl[d] > 0 && run_len) {
            cost += gap_min(run_len, o1, e1, o2, e2);
            run_len = 0;
        }
    }
    if (run_len)
        cost += gap_min(run_len, o1, e1, o2, e2);
    free(F); free(opl); free(sl);
    return cost;
}

/* Smallest band width B such that affine2p_align_band's escape test
 * cannot fire when the optimal score is <= s_ub.  Soundness: every cell
 * in a band-edge column has diagonal displacement b_start (left edge)
 * or B-1-b_start (right edge) from the start diagonal, so its DP value
 * is >= gap_min(displacement) (gap cost is subadditive and increasing);
 * the DP adds the return bound displacement_to_b_final * min(e1,e2).
 * If that sum is >= s_ub >= optimal for both edges, edge_min >= best and
 * the escape test (strict <) cannot trigger.  Returns -1 when no band
 * below the full width helps (caller runs the full DP / ladder). */
static int64_t guided_band(int64_t n, int64_t m, int64_t s_ub,
                           int64_t x, int64_t o1, int64_t e1,
                           int64_t o2, int64_t e2)
{
    (void)x;
    int64_t diff = m - n;
    int64_t adiff = diff < 0 ? -diff : diff;
    int64_t min_e = e1 < e2 ? e1 : e2;
    int64_t delta;

    for (delta = 1; ; delta++) {
        int64_t B = adiff + 2 * delta + 2;
        if (B >= n + m)
            return -1;
        int64_t dlo = (diff < 0 ? diff : 0) - (B - adiff) / 2;
        int64_t b_start = -dlo;
        int64_t b_final = diff + b_start;
        if (gap_min(b_start, o1, e1, o2, e2) + b_final * min_e >= s_ub
            && gap_min(B - 1 - b_start, o1, e1, o2, e2)
               + (B - 1 - b_final) * min_e >= s_ub)
            return B;
    }
}

/* Routed single-pair entry: greedy prepass -> provably escape-free
 * banded pass; identical-pair shortcut; classic full-DP / ladder routing
 * when the prepass bails (high divergence) or the band would not pay.
 * Same output contract as affine2p_align (reversed op walk). */
static int affine2p_align_auto(const uint8_t *p, int64_t n, const uint8_t *t,
                               int64_t m, int64_t x, int64_t o1, int64_t e1,
                               int64_t o2, int64_t e2,
                               uint8_t *ops_out, int64_t *score_out)
{
    int64_t cells = (n + 1) * (m + 1), i;

    if (n == 0 || m == 0)
        return -3;
    if (cells > 2048) {
        /* dcap: past sqrt(cells) the prepass costs as much as the full
         * DP it is trying to avoid; 1024 caps the triangle at ~4 MB */
        int64_t dcap = 64;
        while (dcap * dcap < cells && dcap < 1024)
            dcap *= 2;
        if (dcap > 1024)
            dcap = 1024;
        int64_t s_ub = greedy_ub(p, n, t, m, x, o1, e1, o2, e2, dcap);
        if (s_ub == 0) {
            /* identical: score 0 is uniquely achieved by the all-match
             * path, so this is bit-identical to the full DP */
            for (i = 0; i < n; i++)
                ops_out[i] = 0;
            *score_out = 0;
            return (int)n;
        }
        if (s_ub > 0) {
            int64_t B = guided_band(n, m, s_ub, x, o1, e1, o2, e2);
            if (B > 0 && n * B * 2 < cells) {
                int k = affine2p_align_band(p, n, t, m, x, o1, e1, o2, e2,
                                            B, ops_out, score_out);
                if (k != -4)
                    return k;
                /* cannot happen per the guided_band proof; keep the
                 * ladder as a safety net */
                while (k == -4 && (B *= 4) < m + n)
                    k = affine2p_align_band(p, n, t, m, x, o1, e1, o2, e2,
                                            B, ops_out, score_out);
                if (k != -4)
                    return k;
            }
        }
    }
    /* classic routing: banded ladder for big planes, full DP otherwise */
    if (cells > (int64_t)1 << 16) {
        int64_t adiff = m > n ? m - n : n - m;
        int k = -4;
        int64_t B = adiff + 24;
        while (k == -4 && B < m + n) {
            k = affine2p_align_band(p, n, t, m, x, o1, e1, o2, e2, B,
                                    ops_out, score_out);
            B *= 4;
        }
        if (k != -4)
            return k;
    }
    /* full-plane fallback is capped at ~512 MB of traceback; beyond it
     * report alloc-infeasible rather than attempting a giant malloc */
    if (cells > (int64_t)1 << 29)
        return -1;
    return affine2p_align(p, n, t, m, x, o1, e1, o2, e2, ops_out,
                          score_out);
}

/* shared finishing: reversed 0/1/2 walk -> forward BAM ops, alignment
 * strings, RLE cigar.  Mirrors ops/affine_align.py _finish. */
static int finish_ops(const uint8_t *p, const uint8_t *t, int k,
                      uint8_t *ops_fwd, uint8_t *pat_alg, uint8_t *txt_alg,
                      int64_t *cigar, int64_t *n_cigar)
{
    int64_t i, pi = 0, ti = 0, nc = 0;
    for (i = 0; i < k / 2; i++) {
        uint8_t tmp = ops_fwd[i];
        ops_fwd[i] = ops_fwd[k - 1 - i];
        ops_fwd[k - 1 - i] = tmp;
    }
    for (i = 0; i < k; i++) {
        uint8_t op = ops_fwd[i], bam;
        if (op == 0) {
            uint8_t a = p[pi++], b = t[ti++];
            bam = (a == b) ? 7 : 8;
            pat_alg[i] = a;
            txt_alg[i] = b;
        } else if (op == 1) {
            bam = 1;
            pat_alg[i] = 5;
            txt_alg[i] = t[ti++];
        } else {
            bam = 2;
            pat_alg[i] = p[pi++];
            txt_alg[i] = 5;
        }
        ops_fwd[i] = bam;
        if (nc > 0 && cigar[2 * (nc - 1)] == bam) {
            cigar[2 * (nc - 1) + 1]++;
        } else {
            cigar[2 * nc] = bam;
            cigar[2 * nc + 1] = 1;
            nc++;
        }
    }
    *n_cigar = nc;
    return k;
}

/* Banded full-result entry: tries band widths B, 4B, 16B ... up to
 * max_B, then falls back to the exact full DP.  Bit-identical output to
 * affine2p_align_full (the band-escape test rejects any case where an
 * out-of-band path could score equal-or-better). */
int affine2p_align_band_full(const uint8_t *p, int64_t n, const uint8_t *t,
                             int64_t m, int64_t x, int64_t o1, int64_t e1,
                             int64_t o2, int64_t e2, int64_t B,
                             uint8_t *ops_fwd, uint8_t *pat_alg,
                             uint8_t *txt_alg, int64_t *cigar,
                             int64_t *n_cigar, int64_t *score_out)
{
    int k = -4;
    int64_t diff = m - n;
    int64_t adiff = diff < 0 ? -diff : diff;
    if (B <= adiff + 2)
        B = adiff + 2 + (B > 0 ? B : 64);
    while (k == -4 && B < m + n) {
        k = affine2p_align_band(p, n, t, m, x, o1, e1, o2, e2, B,
                                ops_fwd, score_out);
        B *= 4;
    }
    if (k == -4)
        k = affine2p_align(p, n, t, m, x, o1, e1, o2, e2, ops_fwd,
                           score_out);
    if (k < 0)
        return k;
    return finish_ops(p, t, k, ops_fwd, pat_alg, txt_alg, cigar, n_cigar);
}

/* Full-result routed entry (greedy-guided band, see affine2p_align_auto):
 * the production path for every pair size. */
int affine2p_align_auto_full(const uint8_t *p, int64_t n, const uint8_t *t,
                             int64_t m, int64_t x, int64_t o1, int64_t e1,
                             int64_t o2, int64_t e2,
                             uint8_t *ops_fwd, uint8_t *pat_alg,
                             uint8_t *txt_alg, int64_t *cigar,
                             int64_t *n_cigar, int64_t *score_out)
{
    int k = affine2p_align_auto(p, n, t, m, x, o1, e1, o2, e2, ops_fwd,
                                score_out);
    if (k < 0)
        return k;
    return finish_ops(p, t, k, ops_fwd, pat_alg, txt_alg, cigar, n_cigar);
}

/* Full-result variant: emits forward BAM ops (7 '=', 8 'X', 1 I, 2 D),
 * gap-padded alignment strings (5 = gap) and RLE cigar (op,len int64
 * pairs).  Returns the op-string length, cigar pair count via *n_cigar.
 * Mirrors ops/affine_align.py _finish. */
int affine2p_align_full(const uint8_t *p, int64_t n, const uint8_t *t,
                        int64_t m, int64_t x, int64_t o1, int64_t e1,
                        int64_t o2, int64_t e2,
                        uint8_t *ops_fwd, uint8_t *pat_alg, uint8_t *txt_alg,
                        int64_t *cigar, int64_t *n_cigar, int64_t *score_out)
{
    int k = affine2p_align(p, n, t, m, x, o1, e1, o2, e2, ops_fwd, score_out);
    if (k < 0)
        return k;
    return finish_ops(p, t, k, ops_fwd, pat_alg, txt_alg, cigar, n_cigar);
}

/* ------------------------------------------------------------------ */
/* Batched threaded entry: one call aligns n_pairs sequence pairs over
 * concatenated buffers, with the per-pair size routing (full DP below
 * 2^16 cells, banded ladder above) and the left-gap-alignment reversal
 * convention handled in C.  The kt_for analog
 * (reference/src/kthread.c:24-46): worker threads strided over
 * pairs via an atomic counter.  Replaces one ctypes round trip + two
 * numpy reversals PER PAIR with a single GIL-released call. */

#include <pthread.h>

typedef struct {
    const uint8_t *pbuf; const int64_t *poff;
    const uint8_t *tbuf; const int64_t *toff;
    int64_t n_pairs; const uint8_t *la;
    int64_t x, o1, e1, o2, e2;
    uint8_t *pat_alg, *txt_alg;
    const int64_t *ooff;
    int64_t *cigar, *klen, *n_cigar, *score;
    volatile int64_t next;
} many_job_t;

static void align_one_pair(many_job_t *jb, int64_t k)
{
    int64_t n = jb->poff[k + 1] - jb->poff[k];
    int64_t m = jb->toff[k + 1] - jb->toff[k];
    int64_t L = n + m, i;
    const uint8_t *p0 = jb->pbuf + jb->poff[k];
    const uint8_t *t0 = jb->tbuf + jb->toff[k];
    uint8_t *pat = jb->pat_alg + jb->ooff[k];
    uint8_t *txt = jb->txt_alg + jb->ooff[k];
    int64_t *cig = jb->cigar + 2 * jb->ooff[k];
    uint8_t *pr = NULL, *tr = NULL, *ops;
    const uint8_t *pp = p0, *tt = t0;
    int rev = jb->la[k] != 0;
    int kk;

    if (L == 0) {                      /* both empty: empty alignment */
        jb->klen[k] = 0; jb->n_cigar[k] = 0; jb->score[k] = 0;
        return;
    }
    ops = (uint8_t *)malloc(L);
    if (!ops) { jb->klen[k] = -1; return; }
    if (rev) {
        pr = (uint8_t *)malloc(n > 0 ? n : 1);
        tr = (uint8_t *)malloc(m > 0 ? m : 1);
        if (!pr || !tr) { free(ops); free(pr); free(tr); jb->klen[k] = -1; return; }
        for (i = 0; i < n; i++) pr[i] = p0[n - 1 - i];
        for (i = 0; i < m; i++) tr[i] = t0[m - 1 - i];
        pp = pr; tt = tr;
    }
    if (n == 0 || m == 0) {            /* pure-gap alignment, cost in Python
                                          conventions: min of the two gap
                                          penalties per run */
        int64_t nc = 0, sc = 0;
        for (i = 0; i < n; i++) { pat[i] = pp[i]; txt[i] = 5; }
        for (i = 0; i < m; i++) { pat[n + i] = 5; txt[n + i] = tt[i]; }
        if (n > 0) {
            int64_t g1 = jb->o1 + jb->e1 * n, g2 = jb->o2 + jb->e2 * n;
            sc += g1 < g2 ? g1 : g2;
            cig[2 * nc] = 2; cig[2 * nc + 1] = n; nc++;
        }
        if (m > 0) {
            int64_t g1 = jb->o1 + jb->e1 * m, g2 = jb->o2 + jb->e2 * m;
            sc += g1 < g2 ? g1 : g2;
            cig[2 * nc] = 1; cig[2 * nc + 1] = m; nc++;
        }
        jb->klen[k] = L; jb->n_cigar[k] = nc; jb->score[k] = sc;
        kk = (int)L;
    } else {
        kk = affine2p_align_auto_full(pp, n, tt, m, jb->x, jb->o1, jb->e1,
                                      jb->o2, jb->e2, ops, pat, txt, cig,
                                      &jb->n_cigar[k], &jb->score[k]);
        jb->klen[k] = kk;
    }
    if (rev && kk > 0) {               /* un-reverse outputs in place */
        int64_t nc = jb->n_cigar[k];
        for (i = 0; i < kk / 2; i++) {
            uint8_t tb = pat[i]; pat[i] = pat[kk - 1 - i]; pat[kk - 1 - i] = tb;
            tb = txt[i]; txt[i] = txt[kk - 1 - i]; txt[kk - 1 - i] = tb;
        }
        for (i = 0; i < nc / 2; i++) {
            int64_t a0 = cig[2 * i], a1 = cig[2 * i + 1];
            cig[2 * i] = cig[2 * (nc - 1 - i)];
            cig[2 * i + 1] = cig[2 * (nc - 1 - i) + 1];
            cig[2 * (nc - 1 - i)] = a0;
            cig[2 * (nc - 1 - i) + 1] = a1;
        }
    }
    free(ops); free(pr); free(tr);
}

static void *many_worker(void *arg)
{
    many_job_t *jb = (many_job_t *)arg;
    for (;;) {
        int64_t k = __sync_fetch_and_add(&jb->next, 1);
        if (k >= jb->n_pairs) break;
        align_one_pair(jb, k);
    }
    return NULL;
}

int affine2p_align_many(const uint8_t *pbuf, const int64_t *poff,
                        const uint8_t *tbuf, const int64_t *toff,
                        int64_t n_pairs, const uint8_t *la,
                        int64_t x, int64_t o1, int64_t e1,
                        int64_t o2, int64_t e2,
                        uint8_t *pat_alg, uint8_t *txt_alg,
                        const int64_t *ooff, int64_t *cigar,
                        int64_t *klen, int64_t *n_cigar, int64_t *score,
                        int64_t n_threads)
{
    many_job_t jb = {pbuf, poff, tbuf, toff, n_pairs, la, x, o1, e1, o2, e2,
                     pat_alg, txt_alg, ooff, cigar, klen, n_cigar, score, 0};
    int64_t nt = n_threads < n_pairs ? n_threads : n_pairs, i;
    if (nt <= 1) {
        for (i = 0; i < n_pairs; i++) align_one_pair(&jb, i);
        return 0;
    }
    {
        pthread_t *tid = (pthread_t *)malloc(sizeof(pthread_t) * nt);
        if (!tid) return -1;
        for (i = 0; i < nt; i++)
            pthread_create(&tid[i], NULL, many_worker, &jb);
        for (i = 0; i < nt; i++)
            pthread_join(tid[i], NULL);
        free(tid);
    }
    return 0;
}
