"""Final variant construction: candidate vars + haplotype consensus -> VCF
records (make_variants, reference/src/collect_var.c:1465-1591)."""

from __future__ import annotations

from typing import List

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.io.bam import CDEL, CINS
from longcalld_torch.io.vcf import VcfVar
from longcalld_torch.utils.mathx import cal_sample_gq, cal_var_qual


def make_variants(opt: CallOpts, chunk: WindowChunk) -> List[VcfVar]:
    cand = chunk.cand_vars
    if cand is None or len(cand) == 0:
        return []
    order_arr = np.asarray(chunk.order, dtype=np.int64)
    out: List[VcfVar] = []
    target = (config.CLEAN_HET_SNP | config.CLEAN_HET_INDEL
              | config.CLEAN_HOM_VAR | config.NOISY_CAND_HET_VAR
              | config.NOISY_CAND_HOM_VAR)
    if opt.out_somatic:
        target |= config.CAND_SOMATIC_VAR
    for i in range(len(cand)):
        c = int(chunk.var_cate[i])
        if (c & target) == 0:
            continue
        t = int(cand.type[i])
        if t in (CDEL, CINS):
            pos = int(cand.pos[i]) - 1   # anchor base
            ref_len = int(cand.ref_len[i]) + 1
        else:
            pos = int(cand.pos[i])
            ref_len = int(cand.ref_len[i])
        if pos < chunk.reg_beg or pos > chunk.reg_end:
            continue
        if cand.hap_cons_alle is None:
            continue
        hom_alle = int(cand.hap_cons_alle[i, 0])
        hap1 = int(cand.hap_cons_alle[i, 1])
        hap2 = int(cand.hap_cons_alle[i, 2])
        is_hom = False
        if hap1 == -1 and hap2 == -1:
            is_hom = True
            hap1 = hap2 = hom_alle
        elif hap1 == hap2:
            is_hom = True
        if hap1 == -1:
            hap1 = 0
        if hap2 == -1:
            hap2 = 0

        ref_bases = chunk.ref4_slice(pos, ref_len).copy()
        alt_bases: List[np.ndarray] = []
        gt = [0, 0]
        is_sv = False
        hom_alt_set = False
        n_alt = 0
        for hap_i, hap_alle in enumerate((hap1, hap2)):
            if hap_alle != 0:
                if is_hom and hom_alt_set:
                    gt[hap_i] = n_alt
                    continue
                alt_seq = np.frombuffer(cand.alt_seqs[i], dtype=np.uint8)
                if t in (CDEL, CINS):
                    anchor = chunk.ref4_at(pos)
                    alt = np.concatenate(
                        [np.array([anchor], dtype=np.uint8), alt_seq])
                else:
                    alt = alt_seq
                alt_bases.append(alt)
                if abs(len(alt) - ref_len) >= opt.min_sv_len:
                    is_sv = True
                n_alt += 1
                gt[hap_i] = n_alt
                if is_hom:
                    hom_alt_set = True
            else:
                gt[hap_i] = 0

        dp = int(cand.total_cov[i])
        ad = [int(cand.alle_covs[i, 0]), int(cand.alle_covs[i, 1])]
        alt_read_names = None
        if ad[1] > 0 and chunk.alleles is not None:
            # alt-read ids in chunk order (collect_var.c:1562-1584); a read
            # only has allele 1 inside its profile span, so the column test
            # subsumes the span/digar checks of the sequential scan
            ids = [k for k in order_arr[chunk.alleles[order_arr, i] == 1]]
            ad[1] = len(ids)  # re-derive like the C fallback (:1580-1583)
            if chunk.read_names:
                alt_read_names = [chunk.read_names[int(k)] for k in ids]

        qual = cal_var_qual(ad[0], ad[1], opt.log_p, opt.log_1p, opt.max_qual)
        gq = cal_sample_gq(ad[0], ad[1], opt.log_p, opt.log_1p, opt.log_2,
                           opt.max_gq)
        ps = int(cand.phase_set[i]) if cand.phase_set is not None else 0
        # TSD/polyA/TE annotation for SVs (collect_te_info outputs feeding
        # the TSD/TSDLEN/POLYALEN/MEI/REPNAME INFO fields)
        te = None
        te_list = getattr(chunk, "var_te_info", None)
        if te_list is not None and i < len(te_list):
            te = te_list[i]
        tsd_seq = None
        polya_len = 0
        tsd_pos1 = tsd_pos2 = 0
        te_name = None
        te_rev = False
        if te is not None and te.tsd_len > 0:
            tsd_seq = te.tsd_seq
            polya_len = te.polya_len
            tsd_pos1 = te.tsd_pos1
            tsd_pos2 = te.tsd_pos2 if te.tsd_pos2 and te.tsd_pos2 > 0 else 0
            if te.te_seq_i >= 0:
                names = getattr(opt, "_te_names", None)
                if names and te.te_seq_i < len(names):
                    te_name = names[te.te_seq_i]
                    te_rev = bool(te.te_is_rev)
        out.append(VcfVar(
            pos=pos, ref_bases=ref_bases, alt_bases=alt_bases, gt=tuple(gt),
            dp=dp, ad=ad, qual=qual, gq=gq, ps=ps, var_type=t, is_sv=is_sv,
            is_somatic=(c == config.CAND_SOMATIC_VAR),
            is_clean=bool(c & config.CAND_GERMLINE_CLEAN_VAR_CATE),
            tsd_seq=tsd_seq, polya_len=polya_len, tsd_pos1=tsd_pos1,
            tsd_pos2=tsd_pos2, te_name=te_name, te_is_rev=te_rev,
            alt_read_names=alt_read_names))
    return out
