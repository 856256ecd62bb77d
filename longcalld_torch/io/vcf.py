"""VCF output matching the reference's header and record layout
(reference/src/vcf_utils.c:17-270)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, TextIO

import numpy as np

from longcalld_torch.config import CallOpts

NT4_CHARS = "ACGTN-"


@dataclass
class VcfVar:
    """Final variant record (mirrors var1_t, src/call_var_main.h:108-121)."""
    pos: int                      # 1-based POS as printed
    ref_bases: np.ndarray         # nt4 codes
    alt_bases: List[np.ndarray] = field(default_factory=list)
    gt: Sequence[int] = (0, 0)
    dp: int = 0
    ad: Sequence[int] = (0, 0)
    qual: int = 0
    gq: int = 0
    ps: int = 0
    var_type: int = 8             # BAM op of underlying cand var
    is_sv: bool = False
    is_somatic: bool = False
    is_clean: bool = False
    tsd_seq: Optional[np.ndarray] = None
    polya_len: int = 0
    tsd_pos1: int = 0
    tsd_pos2: int = 0
    te_name: Optional[str] = None
    te_is_rev: bool = False
    alt_read_names: Optional[List[str]] = None

    @property
    def ref_len(self) -> int:
        return len(self.ref_bases)

    @property
    def n_alt_allele(self) -> int:
        return len(self.alt_bases)


def _seq_str(codes: np.ndarray) -> str:
    return "".join(NT4_CHARS[c] for c in codes)


def write_vcf_header(out: TextIO, contigs: Sequence[str], lengths: Sequence[int],
                     sample_name: str, cmdline: str,
                     version: str = "0.1.0") -> None:
    """Replicates write_vcf_header (src/vcf_utils.c:17-95): fileDate, source,
    CL, contigs, FILTER/INFO/FORMAT lines, single sample."""
    w = out.write
    w("##fileformat=VCFv4.2\n")
    w(f"##fileDate={time.strftime('%Y%m%d')}\n")
    w(f"##source=longcalld-tpu version={version}\n")
    w(f"##CL={cmdline}\n")
    for name, ln in zip(contigs, lengths):
        w(f"##contig=<ID={name},length={ln}>\n")
    w('##FILTER=<ID=PASS,Description="All filters passed">\n')
    w('##FILTER=<ID=LowQual,Description="Low quality variant">\n')
    w('##FILTER=<ID=RefCall,Description="Reference call">\n')
    w('##FILTER=<ID=NoCall,Description="Site has depth=0 resulting in no call">\n')
    w('##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the variant described in this record">\n')
    w('##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description="Somatic/mosaic variant">\n')
    w('##INFO=<ID=CLEAN,Number=0,Type=Flag,Description="Clean-region variant (SNP or simple indel in non-repetitive region)">\n')
    w('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n')
    w('##INFO=<ID=SVLEN,Number=A,Type=Integer,Description="Difference in length between REF and ALT alleles">\n')
    w('##INFO=<ID=TSD,Number=A,Type=String,Description="Target site duplication sequence">\n')
    w('##INFO=<ID=TSDLEN,Number=A,Type=Integer,Description="Length of target site duplication">\n')
    w('##INFO=<ID=POLYALEN,Number=A,Type=Integer,Description="Length of polyA/T sequence">\n')
    w('##INFO=<ID=MEI,Number=0,Type=Flag,Description="Mobile element insertion">\n')
    w('##INFO=<ID=TSDPOS1,Number=A,Type=Integer,Description="Start position of first target site duplication on CHROM">\n')
    w('##INFO=<ID=TSDPOS2,Number=A,Type=Integer,Description="Start position of second target site duplication on CHROM">\n')
    w('##INFO=<ID=REPNAME,Number=A,Type=String,Description="Repeat name">\n')
    w('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    w('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n')
    w('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Total read depth">\n')
    w('##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Read depth for each allele">\n')
    w('##FORMAT=<ID=VAF,Number=A,Type=Float,Description="Variant allele frequency">\n')
    w('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods rounded to the closest integer">\n')
    w('##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">\n')
    w('##FORMAT=<ID=ALTREADS,Number=.,Type=String,Description="IDs of reads supporting the variant">\n')
    w(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample_name}\n")


def write_var_records(out: TextIO, chrom: str, variants: Sequence[VcfVar],
                      opt: CallOpts) -> int:
    """Replicates write_var_to_vcf (src/vcf_utils.c:97-270) including its
    output-time re-filters, phased-GT ordering and INFO/FORMAT layout."""
    n_out = 0
    for var in variants:
        if var.n_alt_allele == 0:
            continue
        if var.dp < opt.min_dp:
            continue
        if opt.out_somatic and var.is_somatic:
            if var.ad[1] < opt.min_somatic_te_dp:
                continue
            if var.ad[1] < opt.min_alt_dp and (var.tsd_seq is None or len(var.tsd_seq) == 0):
                continue
        else:
            if var.ad[1] < opt.min_alt_dp:
                continue
        if not opt.out_amb_base:
            if (var.ref_bases >= 4).any():
                continue
            if any((a >= 4).any() for a in var.alt_bases):
                continue

        ref_s = _seq_str(var.ref_bases)
        alt_s = ",".join(_seq_str(a) for a in var.alt_bases)

        info_parts = []
        if var.is_clean:
            info_parts.append("CLEAN")
        if var.is_somatic:
            info_parts.append("SOMATIC")
        if var.te_name is not None:
            info_parts.append("MEI")
        info = ";".join(info_parts)
        if info:
            info += ";"
        info += f"END={var.pos + var.ref_len - 1}"
        if var.is_sv:
            svlens, svtypes = [], []
            for a in var.alt_bases:
                svlens.append(str(len(a) - var.ref_len))
                svtypes.append("INS" if len(a) > var.ref_len else "DEL")
            info += f";SVTYPE={','.join(svtypes)};SVLEN={','.join(svlens)}"
            if var.tsd_seq is not None and len(var.tsd_seq) > 0:
                info += (f";TSD={_seq_str(var.tsd_seq)};TSDLEN={len(var.tsd_seq)}"
                         f";POLYALEN={var.polya_len};TSDPOS1={var.tsd_pos1}")
                if var.tsd_pos2 > 0:
                    info += f";TSDPOS2={var.tsd_pos2}"
            if var.te_name is not None:
                info += f";REPNAME={'+-'[int(var.te_is_rev)]}{var.te_name}"

        gt1, gt2 = var.gt
        is_hom = gt1 == gt2
        sep = "|"
        if var.ps == 0:
            sep = "/"
            if gt1 > gt2:
                gt1, gt2 = gt2, gt1
        fmt = "GT:DP:AD:VAF:GQ"
        want_reads = (opt.output_var_rnames
                      or (var.is_sv and opt.output_sv_rnames)
                      or (var.is_somatic and opt.output_somatic_var_rnames))
        if not is_hom and var.ps != 0:
            fmt += ":PS"
        if want_reads:
            fmt += ":ALTREADS"

        ad_s = ",".join(str(a) for a in var.ad[:1 + var.n_alt_allele])
        vaf_s = ",".join(f"{var.ad[j + 1] / var.dp:.3f}"
                         for j in range(var.n_alt_allele))
        sample = f"{gt1}{sep}{gt2}:{var.dp}:{ad_s}:{vaf_s}:{var.gq}"
        if not is_hom and var.ps != 0:
            sample += f":{var.ps}"
        if want_reads:
            names = var.alt_read_names or []
            sample += ":" + (",".join(names) if names else ".")

        out.write(f"{chrom}\t{var.pos}\t.\t{ref_s}\t{alt_s}\t{var.qual}\tPASS\t"
                  f"{info}\t{fmt}\t{sample}\n")
        n_out += 1
    return n_out
