"""TSD / polyA / TE (mobile element) annotation for >=30 bp indels.

Mirrors collect_te_info (reference/src/align.c:32-83): a target-site
duplication is a prefix of the gap sequence duplicated in the right reference
flank (<=1 cumulative mismatch, 2..100 bp); polyA (>=10 bp, >=80% A) is
scanned from the gap end, polyT from just after the TSD.  TE family
classification uses the 15-mer index in longcalld_torch.core.kmer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from longcalld_torch.config import CallOpts
from longcalld_torch.io.bam import CDEL, CINS


class TeInfo(NamedTuple):
    tsd_len: int
    tsd_seq: Optional[np.ndarray]
    tsd_pos1: int
    tsd_pos2: int
    polya_len: int            # negative = polyT of that length
    te_seq_i: int
    te_is_rev: bool


NO_TE = TeInfo(0, None, -1, -1, 0, -1, False)


def collect_te_info(opt: CallOpts, var_type: int, gap_seq: np.ndarray,
                    flank_ref_seq: np.ndarray, gap_pos: int,
                    te_index=None) -> TeInfo:
    gap_len = len(gap_seq)
    tsd_len = 0
    n_mis = 0
    for i in range(gap_len):
        if i >= len(flank_ref_seq):
            break
        if gap_seq[i] == flank_ref_seq[i]:
            tsd_len = i + 1
        else:
            n_mis += 1
            if n_mis > 1:
                break
        if tsd_len > opt.max_tsd_len:
            break
    if not (opt.min_tsd_len <= tsd_len <= opt.max_tsd_len):
        return NO_TE
    # polyA from the right end of the gap
    polya_len_out = -1
    has_polya = False
    polya_len = 0
    polya = 0
    max_search = 20
    for i in range(gap_len - 1, -1, -1):
        polya_len += 1
        if gap_seq[i] == 0:  # A
            polya += 1
            if polya_len >= opt.min_polya_len and \
                    polya >= opt.min_polya_ratio * polya_len:
                has_polya = True
                polya_len_out = polya_len
        elif polya_len > max_search:
            break
    if not has_polya:  # polyT just after the TSD
        polyt_len = 0
        polyt = 0
        for i in range(tsd_len, gap_len):
            polyt_len += 1
            if gap_seq[i] == 3:  # T
                polyt += 1
                if polyt_len >= opt.min_polya_len and \
                        polyt >= opt.min_polya_ratio * polyt_len:
                    has_polya = True
                    polya_len_out = -polyt_len
            elif polyt_len > max_search:
                break
    if not has_polya:
        return NO_TE
    te_seq_i, te_is_rev = -1, False
    if te_index is not None:
        te_seq_i, te_is_rev = te_index.classify(gap_seq)
    tsd_pos2 = gap_pos + gap_len if var_type == CDEL else -1
    return TeInfo(tsd_len=tsd_len, tsd_seq=flank_ref_seq[:tsd_len].copy(),
                  tsd_pos1=gap_pos, tsd_pos2=tsd_pos2,
                  polya_len=polya_len_out, te_seq_i=te_seq_i,
                  te_is_rev=te_is_rev)


def te_info_for_gap(opt: CallOpts, chunk, var_type: int, pos: int,
                    gap_seq: Optional[np.ndarray], gap_len: int,
                    te_index=None) -> TeInfo:
    """Gap sequence + right flank from the chunk reference
    (collect_te_info_from_var / _from_cons, align.c:87-162)."""
    if var_type == CINS:
        flank = chunk.ref4_slice(pos, gap_len)
        return collect_te_info(opt, var_type, np.asarray(gap_seq), flank,
                               pos, te_index)
    else:
        gap = chunk.ref4_slice(pos, gap_len)
        flank = chunk.ref4_slice(pos + gap_len, gap_len)
        return collect_te_info(opt, var_type, gap, flank, pos, te_index)
