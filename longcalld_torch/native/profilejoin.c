/* Germline read-vs-variant profile merge-join.
 *
 * C fast path for longcalld_torch/core/profile.py:update_read_profile,
 * the analog of the reference's per-read profile fill
 * (update_read_vs_all_var_profile_from_digar,
 * reference/src/bam_utils.c:446-551).  Somatic candidate windows
 * (fuzzy compare + nearby-INS rescue + pileup count updates) stay on the
 * Python path; this routine handles the default germline mode, where the
 * comparator is the STRICT exact site compare (comp_ovlp_var_site,
 * reference/src/collect_var.c:1147-1150).
 *
 * Equality with the Python oracle is fuzz-tested in
 * tests/test_profile_native.py.
 */

#include <stdint.h>
#include <string.h>

#define CINS 1
#define CDEL 2
#define CEQUAL 7
#define CDIFF 8

/* comparator position: raw pos for X, pos-1 for everything else
 * (the anchor-base convention, collect_var.c:1878-1884) */
static int64_t cmp_pos(uint8_t t, int64_t pos)
{
    return t == CDIFF ? pos : pos - 1;
}

/* strict site compare == comp_sites_ins with an unreachable min_sv_len:
 * (cmp_pos, type, ref_len, alt_len, alt bytes for X/INS) */
static int comp_exact(int64_t apos, uint8_t atype, int64_t aref,
                      int64_t aalt, const uint8_t *aseq,
                      int64_t bpos, uint8_t btype, int64_t bref,
                      int64_t balt, const uint8_t *bseq, int64_t bseq_i)
{
    int64_t pa = cmp_pos(atype, apos), pb = cmp_pos(btype, bpos);
    if (pa != pb) return pa < pb ? -1 : 1;
    if (atype != btype) return atype < btype ? -1 : 1;
    if (aref != bref) return aref < bref ? -1 : 1;
    if (atype == CDIFF || atype == CINS) {
        if (aalt != balt) return aalt < balt ? -1 : 1;
        int r = memcmp(aseq, bseq + bseq_i, (size_t)aalt);
        return r < 0 ? -1 : (r > 0 ? 1 : 0);
    }
    return 0; /* DEL with equal ref_len */
}

/* ovlp_var_site (collect_var.c:79-95): ref-span overlap with INS cases */
static int ovlp_sites(int64_t a0, int64_t a2, int64_t b0, int64_t b2)
{
    int64_t e1 = a0 + a2, e2 = b0 + b2;
    if (a2 == 0 && b2 == 0) return a0 == b0;
    if (a2 == 0) return (b0 < a0) && (a0 < e2) && (e1 < e2);
    if (b2 == 0) return (a0 < b0) && (b0 < e1) && (e2 < e1);
    return !(a0 >= e2 || b0 >= e1);
}

/* get_var_site_start (src/bam_utils.c:215-226) */
static int64_t site_start(const int64_t *svpos, const int64_t *spos,
                          int64_t n, int64_t beg)
{
    int64_t target = beg > 0 ? beg - 1 : beg;
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (svpos[mid] < target) lo = mid + 1; else hi = mid;
    }
    while (lo < n && spos[lo] < beg) lo++;
    return lo;
}

/* comp_sites_ins (collect_var.c:1901-1933): exact compare with fuzzy
 * (>= 80% length) equality for large INSs; the small/large decision uses
 * the FIRST argument's alt_len (the site side in the pileup join) */
static int comp_fuzzy(int64_t min_sv,
                      int64_t apos, uint8_t atype, int64_t aref,
                      int64_t aalt, const uint8_t *aseq,
                      int64_t bpos, uint8_t btype, int64_t bref,
                      int64_t balt, const uint8_t *bseq, int64_t bseq_i)
{
    int64_t pa = cmp_pos(atype, apos), pb = cmp_pos(btype, bpos);
    if (pa != pb) return pa < pb ? -1 : 1;
    if (atype != btype) return atype < btype ? -1 : 1;
    if (aref != bref) return aref < bref ? -1 : 1;
    if (atype == CDIFF || (atype == CINS && aalt < min_sv)) {
        if (aalt != balt) return aalt < balt ? -1 : 1;
        int r = memcmp(aseq, bseq + bseq_i, (size_t)aalt);
        return r < 0 ? -1 : (r > 0 ? 1 : 0);
    }
    if (atype == CINS) { /* large INS: similar length == match */
        int64_t mn = aalt < balt ? aalt : balt;
        int64_t mx = aalt < balt ? balt : aalt;
        if (mn * 5 >= mx * 4) return 0;
        return aalt < balt ? -1 : 1;
    }
    return 0; /* DEL with equal ref_len */
}

/* Pileup pass: one read's events merge-joined against the site list,
 * crediting ref / alt / low-qual depth and strand counts
 * (update_cand_vars_from_digar, reference/src/bam_utils.c:287-327).
 * Count arrays: alle_covs is (n,2) row-major, strand_covs (n,2,2). */
void pileup_join_read(
    int64_t n_sites, const int64_t *svpos, const int64_t *spos,
    const uint8_t *stype, const int64_t *sref, const int64_t *salt,
    const uint8_t *salt_blob, const int64_t *salt_off,
    int64_t n_digar, const uint8_t *etype, const int64_t *epos,
    const int32_t *elen, const int32_t *eqi, const int64_t *eaveq,
    const uint8_t *elow, const uint8_t *rseq,
    int64_t read_beg, int64_t read_end, int64_t strand,
    int64_t min_sv, int64_t min_bq,
    int32_t *total_cov, int32_t *low_qual_cov, int32_t *alle_covs,
    int32_t *strand_covs)
{
    int64_t site_i = site_start(svpos, spos, n_sites, read_beg);
    int64_t digar_i = 0;
#define REF_CREDIT(si) do { \
        total_cov[si]++; \
        alle_covs[(si) * 2]++; \
        strand_covs[(si) * 4 + strand * 2]++; \
    } while (0)
    while (site_i < n_sites && digar_i < n_digar) {
        uint8_t t = etype[digar_i];
        if (t == CEQUAL) { digar_i++; continue; } /* clips join like C */
        int64_t el = elen[digar_i];
        int64_t eref, ealt;
        if (t == CINS) { eref = 0; ealt = el; }
        else if (t == CDEL) { eref = el; ealt = 0; }
        else { eref = 1; ealt = el; }
        int ret = comp_fuzzy(min_sv, spos[site_i], stype[site_i],
                             sref[site_i], salt[site_i],
                             salt_blob + salt_off[site_i],
                             epos[digar_i], t, eref, ealt,
                             rseq, eqi[digar_i]);
        if (ret < 0) {
            REF_CREDIT(site_i);
            site_i++;
        } else if (ret == 0) {
            if (elow[digar_i] || eaveq[digar_i] < min_bq) {
                low_qual_cov[site_i]++;
            } else {
                total_cov[site_i]++;
                alle_covs[site_i * 2 + 1]++;
                strand_covs[site_i * 4 + strand * 2 + 1]++;
            }
            site_i++;
        } else {
            digar_i++;
        }
    }
    while (site_i < n_sites && spos[site_i] <= read_end) {
        REF_CREDIT(site_i);
        site_i++;
    }
#undef REF_CREDIT
}

/* One read's merge-join against the classified variant list.
 * Writes the read's allele/alt_qi rows and [start_var, end_var] span. */
void profile_join_read(
    int64_t n_vars, const int64_t *svpos, const int64_t *spos,
    const uint8_t *stype, const int64_t *sref, const int64_t *salt,
    const uint8_t *salt_blob, const int64_t *salt_off,
    const int32_t *scate, int32_t non_var,
    int64_t n_digar, const uint8_t *etype, const int64_t *epos,
    const int32_t *elen, const int32_t *eqi, const int64_t *eaveq,
    const uint8_t *rseq, int64_t read_beg, int64_t read_end,
    int64_t n_noisy, const int64_t *nst, const int64_t *nen_runmax,
    int64_t min_bq,
    int8_t *alleles, int32_t *alt_qi, int64_t *span)
{
    int64_t var_i = site_start(svpos, spos, n_vars, read_beg);
    int64_t digar_i = 0;
    int64_t start_var = -1, end_var = -2;
#define SET(vi, al, q) do { \
        if (start_var == -1) start_var = (vi); \
        end_var = (vi); \
        alleles[vi] = (int8_t)(al); \
        alt_qi[vi] = (int32_t)(q); \
    } while (0)

    while (var_i < n_vars && digar_i < n_digar) {
        if (scate[var_i] == non_var) { var_i++; continue; }
        uint8_t t = etype[digar_i];
        if (t == CEQUAL) { digar_i++; continue; }
        int64_t el = elen[digar_i];
        int64_t eref, ealt;
        if (t == CINS) { eref = 0; ealt = el; }
        else if (t == CDEL) { eref = el; ealt = 0; }
        else { eref = 1; ealt = el; } /* X and clips both carry ref_len 1 */
        int ret = comp_exact(spos[var_i], stype[var_i], sref[var_i],
                             salt[var_i], salt_blob + salt_off[var_i],
                             epos[digar_i], t, eref, ealt,
                             rseq, eqi[digar_i]);
        int is_ovlp = ovlp_sites(spos[var_i], sref[var_i],
                                 epos[digar_i], eref);
        if (!is_ovlp) {
            if (ret < 0)      { SET(var_i, 0, -1); var_i++; }
            else if (ret > 0) { digar_i++; }
            else              { var_i++; digar_i++; }
        } else if (ret == 0) {
            SET(var_i, eaveq[digar_i] >= min_bq ? 1 : -2, eqi[digar_i]);
            var_i++;
        } else {
            SET(var_i, -1, -1);
            var_i++;
        }
    }
    /* trailing ref span, skipping vars inside the read's noisy regions */
    while (var_i < n_vars && spos[var_i] <= read_end) {
        int64_t p = spos[var_i] - 1;
        int hit = 0;
        if (n_noisy) {
            int64_t lo = 0, hi = n_noisy; /* upper bound over starts */
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (nst[mid] <= p) lo = mid + 1; else hi = mid;
            }
            if (lo > 0 && nen_runmax[lo - 1] > p) hit = 1;
        }
        if (!hit) SET(var_i, 0, -1);
        var_i++;
    }
    span[0] = start_var;
    span[1] = end_var;
#undef SET
}

/* Byte histogram: the per-window base-quality distribution
 * (collect_digars_from_bam quartiles, reference/src/collect_var.c:
 * 1083-1105).  numpy's bincount pays an int64 cast copy of the ~5M-byte
 * qual concat per window; this one-pass count is ~20x faster and releases
 * the GIL via ctypes. */
void u8_hist(const uint8_t *data, int64_t n, int64_t out[256])
{
    int64_t c0[256] = {0}, c1[256] = {0}, c2[256] = {0}, c3[256] = {0};
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        c0[data[i]]++; c1[data[i + 1]]++;
        c2[data[i + 2]]++; c3[data[i + 3]]++;
    }
    for (; i < n; i++) c0[data[i]]++;
    for (int k = 0; k < 256; k++) out[k] = c0[k] + c1[k] + c2[k] + c3[k];
}
