"""Per-window state (bam_chunk_t analog, reference/src/bam_utils.h:45-92)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from longcalld_torch.core.digar import ReadDigar
from longcalld_torch.core.sites import CandVars
from longcalld_torch.utils.intervals import IntervalSet


@dataclasses.dataclass
class WindowChunk:
    tid: int
    tname: str
    reg_beg: int      # 1-based inclusive active region
    reg_end: int
    ref_beg: int      # 1-based start of fetched ref window (with flanks)
    ref_end: int
    whole_ref_len: int
    ref4: np.ndarray  # nt4 codes of [ref_beg, ref_end]
    chunk_i: int = 0
    reg_i: int = 0

    n_reads: int = 0
    read_names: List[str] = dataclasses.field(default_factory=list)
    order: List[int] = dataclasses.field(default_factory=list)  # sorted read ids
    digars: List[Optional[ReadDigar]] = dataclasses.field(default_factory=list)
    is_skipped: Optional[np.ndarray] = None
    is_palindrome: Optional[np.ndarray] = None
    # boundary bookkeeping for stitching
    up_ovlp_read_i: List[int] = dataclasses.field(default_factory=list)
    down_ovlp_read_i: List[int] = dataclasses.field(default_factory=list)

    # base-quality quartiles over the window (collect_digars_from_bam,
    # src/collect_var.c:1083-1105)
    min_qual: int = 0
    first_quar_qual: int = 0
    median_qual: int = 0
    third_quar_qual: int = 0
    max_qual: int = 0

    low_comp: Optional[IntervalSet] = None
    noisy_regs: Optional[IntervalSet] = None

    cand_vars: Optional[CandVars] = None
    var_cate: Optional[np.ndarray] = None  # int32 category bitmask per var

    # read x var profile: dense matrices indexed [read_id, var_id]
    alleles: Optional[np.ndarray] = None   # int8: -1 none, -2 lowqual-alt, 0 ref, 1 alt
    alt_qi: Optional[np.ndarray] = None    # int32
    read_start_var: Optional[np.ndarray] = None  # int32 per read, -1 = none
    read_end_var: Optional[np.ndarray] = None    # int32 per read, -2 = none

    # phasing state
    haps: Optional[np.ndarray] = None        # int8 per read: 0/1/2
    phase_sets: Optional[np.ndarray] = None  # int64 per read, -1 = unset
    n_clean_agree_snps: Optional[np.ndarray] = None
    n_clean_conflict_snps: Optional[np.ndarray] = None
    is_skipped_for_somatic: Optional[np.ndarray] = None

    # noisy-read ratio cache (build_var_noisy_reads_ratio_cache,
    # src/collect_var.c:668-716)
    var_noisy_cov: Optional[IntervalSet] = None
    var_noisy_err: Optional[IntervalSet] = None

    # stitch outputs
    flip_hap: bool = False
    flip_pre_ps: int = -1
    flip_cur_ps: int = -1

    def ref4_at(self, pos1: int) -> int:
        """nt4 code at 1-based ref position (N outside the window)."""
        off = pos1 - self.ref_beg
        if off < 0 or off >= len(self.ref4):
            return 4
        return int(self.ref4[off])

    def ref4_slice(self, pos1: int, length: int) -> np.ndarray:
        off = pos1 - self.ref_beg
        if off < 0 or off + length > len(self.ref4):
            out = np.full(length, 4, dtype=np.uint8)
            s = max(0, off)
            e = min(len(self.ref4), off + length)
            if e > s:
                out[s - off:e - off] = self.ref4[s:e]
            return out
        return self.ref4[off:off + length]
