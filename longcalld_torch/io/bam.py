"""BAM container parsing + BAI-indexed region queries.

Replaces the htslib readers used by the reference
(`sam_itr_queryi`/`sam_itr_next`, reference/src/bam_utils.c:1673-1706).
Pure host code: records are decoded into numpy-friendly arrays that feed the
device featurization kernels.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from longcalld_torch.io import bgzf

# BAM cigar op codes
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
CIGAR_STR = "MIDNSHP=X"
CIGAR_SHIFT = 4
# which ops consume query/reference
_CONSUME_Q = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)
_CONSUME_R = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)

FUNMAP = 0x4
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800
FREVERSE = 0x10

# nt16 code -> nt4 int (htslib seq_nt16_int)
SEQ_NT16_INT = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                        dtype=np.uint8)
SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
# packed byte -> its two nt4 codes (hi nibble first)
_SEQ_PAIR_NT4 = np.stack([SEQ_NT16_INT[np.arange(256) >> 4],
                          SEQ_NT16_INT[np.arange(256) & 0xF]], axis=1)


class BamRecord:
    """One alignment record, decoded lazily from raw bytes."""

    __slots__ = ("tid", "pos", "mapq", "flag", "l_seq", "_raw",
                 "_name_off", "_cigar_off", "_n_cigar", "_seq_off",
                 "_qual_off", "_tag_off", "_endpos", "_nt4")

    def __init__(self, raw: bytes):
        (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _ntid, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", raw, 0)
        self.tid = tid
        self.pos = pos  # 0-based leftmost
        self.mapq = mapq
        self.flag = flag
        self.l_seq = l_seq
        self._raw = raw
        self._name_off = 32
        self._cigar_off = 32 + l_read_name
        self._n_cigar = n_cigar
        self._seq_off = self._cigar_off + 4 * n_cigar
        self._qual_off = self._seq_off + (l_seq + 1) // 2
        self._tag_off = self._qual_off + l_seq
        self._endpos = -1

    @property
    def qname(self) -> str:
        end = self._raw.index(b"\x00", self._name_off)
        return self._raw[self._name_off:end].decode()

    @property
    def is_rev(self) -> bool:
        return bool(self.flag & FREVERSE)

    def cigar_array(self) -> np.ndarray:
        """(n,2) array of (op, len)."""
        a = np.frombuffer(self._raw, dtype="<u4", count=self._n_cigar,
                          offset=self._cigar_off)
        return np.stack([a & 0xF, a >> CIGAR_SHIFT], axis=1).astype(np.int64)

    @property
    def endpos(self) -> int:
        """0-based exclusive reference end (htslib bam_endpos semantics)."""
        if self._endpos < 0:
            if self._n_cigar == 0:
                self._endpos = self.pos + 1
            else:
                c = self.cigar_array()
                self._endpos = int(self.pos + (_CONSUME_R[c[:, 0]] * c[:, 1]).sum())
        return self._endpos

    def seq_nt4(self) -> np.ndarray:
        """Read bases as nt4 codes (A0 C1 G2 T3 N4), length l_seq.
        Decoded once and cached — digar extraction, profile fill, and the
        consensus engine all re-request it within a window."""
        cached = getattr(self, "_nt4", None)
        if cached is not None:
            return cached
        packed = np.frombuffer(self._raw, dtype=np.uint8,
                               count=(self.l_seq + 1) // 2,
                               offset=self._seq_off)
        # one gather through the byte-pair table decodes two bases at once
        out = _SEQ_PAIR_NT4[packed].reshape(-1)[:self.l_seq]
        out.flags.writeable = False   # shared across callers
        self._nt4 = out
        return out

    def qual(self) -> np.ndarray:
        return np.frombuffer(self._raw, dtype=np.uint8, count=self.l_seq,
                             offset=self._qual_off)

    # --- aux tags ---
    def _iter_tags(self) -> Iterator[Tuple[str, str, int]]:
        raw = self._raw
        off = self._tag_off
        n = len(raw)
        while off + 3 <= n:
            tag = raw[off:off + 2].decode("ascii", "replace")
            typ = chr(raw[off + 2])
            val_off = off + 3
            if typ in "cC":
                off = val_off + 1
            elif typ in "sS":
                off = val_off + 2
            elif typ in "iIf":
                off = val_off + 4
            elif typ == "A":
                off = val_off + 1
            elif typ in "ZH":
                off = raw.index(b"\x00", val_off) + 1
            elif typ == "B":
                st = chr(raw[val_off])
                cnt = struct.unpack_from("<i", raw, val_off + 1)[0]
                sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[st]
                off = val_off + 5 + cnt * sz
            else:
                raise ValueError(f"unknown tag type {typ!r}")
            yield tag, typ, val_off

    def get_tag(self, name: str):
        raw = self._raw
        for tag, typ, off in self._iter_tags():
            if tag != name:
                continue
            if typ == "c":
                return struct.unpack_from("<b", raw, off)[0]
            if typ == "C":
                return raw[off]
            if typ == "s":
                return struct.unpack_from("<h", raw, off)[0]
            if typ == "S":
                return struct.unpack_from("<H", raw, off)[0]
            if typ == "i":
                return struct.unpack_from("<i", raw, off)[0]
            if typ == "I":
                return struct.unpack_from("<I", raw, off)[0]
            if typ == "f":
                return struct.unpack_from("<f", raw, off)[0]
            if typ == "A":
                return chr(raw[off])
            if typ in "ZH":
                end = raw.index(b"\x00", off)
                return raw[off:end].decode()
            if typ == "B":
                st = chr(raw[off])
                cnt = struct.unpack_from("<i", raw, off + 1)[0]
                dt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
                      "i": "<i4", "I": "<u4", "f": "<f4"}[st]
                return np.frombuffer(raw, dtype=dt, count=cnt, offset=off + 5)
        return None

    def has_tag(self, name: str) -> bool:
        return any(tag == name for tag, _, _ in self._iter_tags())

    def get_nm(self) -> int:
        """NM tag or 0 (reference bam_get_NM, src/bam_utils.c:1632-1639)."""
        v = self.get_tag("NM")
        return int(v) if v is not None else 0

    def has_eqx_cigar(self) -> bool:
        """True if CIGAR uses =/X before any M (src/bam_utils.c:50-66)."""
        for op, _ in self.cigar_array():
            if op in (CEQUAL, CDIFF):
                return True
            if op == CMATCH:
                return False
        return False


# ---------------- BAI index ----------------

_BIN_OFFSETS = (0, 1, 9, 73, 585, 4681)


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (0-based), standard 5-level scheme."""
    end -= 1
    bins = [0]
    for lvl, off in enumerate(_BIN_OFFSETS[1:], start=1):
        shift = 29 - 3 * lvl
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def reg2bin(beg: int, end: int) -> int:
    """SAM-spec bin for a 0-based half-open interval."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def build_bai(bam_path: str, out_path: Optional[str] = None) -> str:
    """samtools-index analog: write a .bai for a coordinate-sorted BAM.

    The reference consumes pre-indexed BAMs only (htslib iterators,
    reference/src/bam_utils.c:1673-1706) and leans on `samtools
    index` for the index itself; this builder closes that tooling gap
    in-framework and gives synthetic test/bench BAMs true random access.
    Spec-standard layout: per-ref binning index (R-tree bins with merged
    voffset chunks) + 16 kb linear index.  Returns the index path."""
    from longcalld_torch.io import bgzf as _bgzf

    with open(bam_path, "rb") as f:
        raw = f.read()
    # block map: compressed offsets + uncompressed starts
    coffs: List[int] = []
    ustarts: List[int] = []
    parts: List[bytes] = []
    off = 0
    total = 0
    while off + 18 <= len(raw):
        csize = _bgzf._block_size_from_header(raw, off)
        blk = _bgzf.decompress_block(raw, off, csize)
        coffs.append(off)
        ustarts.append(total)
        parts.append(blk)
        total += len(blk)
        off += csize
    data = b"".join(parts)
    ustart_arr = np.asarray(ustarts, dtype=np.int64)
    coff_arr = np.asarray(coffs, dtype=np.int64)

    def voffset(p: int) -> int:
        bi = int(np.searchsorted(ustart_arr, p, side="right")) - 1
        return (int(coff_arr[bi]) << 16) | (p - int(ustarts[bi]))

    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    o = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, o)
    o += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, o)
        o += 4 + l_name + 4
    bins: List[Dict[int, List[List[int]]]] = [dict() for _ in range(n_ref)]
    intv: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    while o + 4 <= len(data):
        (bs,) = struct.unpack_from("<i", data, o)
        vb, ve = voffset(o), voffset(o + 4 + bs)
        ref_id, pos = struct.unpack_from("<ii", data, o + 4)
        if 0 <= ref_id < n_ref and pos >= 0:
            l_read_name = data[o + 12]
            (n_cigar,) = struct.unpack_from("<H", data, o + 16)
            end = pos + 1
            if n_cigar:
                cig = np.frombuffer(data, dtype="<u4", count=n_cigar,
                                    offset=o + 36 + l_read_name)
                span = int((cig[np.isin(cig & 0xF, (0, 2, 3, 7, 8))]
                            >> 4).sum())
                end = pos + max(span, 1)
            b = reg2bin(pos, end)
            got = bins[ref_id].setdefault(b, [])
            if got and got[-1][1] == vb:
                got[-1][1] = ve      # merge contiguous records
            else:
                got.append([vb, ve])
            for w in range(pos >> 14, ((end - 1) >> 14) + 1):
                cur = intv[ref_id].get(w)
                if cur is None or vb < cur:
                    intv[ref_id][w] = vb
        o += 4 + bs

    out_path = out_path or bam_path + ".bai"
    buf = bytearray(b"BAI\x01")
    buf += struct.pack("<i", n_ref)
    for t in range(n_ref):
        bd = bins[t]
        buf += struct.pack("<i", len(bd))
        for bin_id in sorted(bd):
            chunks = bd[bin_id]
            buf += struct.pack("<Ii", bin_id, len(chunks))
            for cb, ce in chunks:
                buf += struct.pack("<QQ", cb, ce)
        n_intv = (max(intv[t]) + 1) if intv[t] else 0
        buf += struct.pack("<i", n_intv)
        for w in range(n_intv):
            buf += struct.pack("<Q", intv[t].get(w, 0))
    tmp = out_path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(bytes(buf))
    os.replace(tmp, out_path)
    return out_path


class BaiIndex:
    def __init__(self, path: str):
        from longcalld_torch.io.remote import fetch_url, is_url
        if is_url(path):
            data = fetch_url(path)   # .bai is small; fetch whole
        else:
            with open(path, "rb") as f:
                data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("not a BAI file")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.intervals: List[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bd[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = np.frombuffer(data, dtype="<u8", count=n_intv, offset=off)
            off += 8 * n_intv
            self.bins.append(bd)
            self.intervals.append(ioff)
        self._tile_prefix: Dict[int, np.ndarray] = {}

    def tile_prefix(self, tid: int) -> np.ndarray:
        """Prefix-sum over 16 kb-tile occupancy for ``tid``: tile t counts
        as occupied when any index bin whose span covers t holds a chunk.
        Bin-granular, hence conservative — a window whose tile range sums
        to zero provably holds no reads, the converse need not hold.
        Lets callers test thousands of windows for emptiness in one
        vectorized pass instead of a per-window ``query_chunks`` (whose
        O(tiles) linear-offset scan dominated whole-genome window
        streaming)."""
        cached = self._tile_prefix.get(tid)
        if cached is not None:
            return cached
        bd = self.bins[tid] if 0 <= tid < len(self.bins) else {}
        n_tiles = max(int(self.intervals[tid].size) if bd else 0, 1)
        # bins can cover tiles past the linear index's extent
        for bin_id in bd:
            lvl = max(l for l, off in enumerate(_BIN_OFFSETS)
                      if bin_id >= off)
            tiles_per = 1 << (29 - 3 * lvl - 14)
            n_tiles = max(n_tiles,
                          ((bin_id - _BIN_OFFSETS[lvl]) + 1) * tiles_per)
        diff = np.zeros(n_tiles + 1, dtype=np.int64)
        for bin_id, chunks in bd.items():
            if not chunks:
                continue
            lvl = max(l for l, off in enumerate(_BIN_OFFSETS)
                      if bin_id >= off)
            tiles_per = 1 << (29 - 3 * lvl - 14)
            t0 = (bin_id - _BIN_OFFSETS[lvl]) * tiles_per
            diff[t0] += 1
            diff[min(t0 + tiles_per, n_tiles)] -= 1
        occ = (np.cumsum(diff[:-1]) > 0)
        pre = np.zeros(n_tiles + 1, dtype=np.int64)
        np.cumsum(occ, out=pre[1:])
        self._tile_prefix[tid] = pre
        return pre

    def busy_mask(self, tid: int, begs: np.ndarray,
                  ends: np.ndarray) -> np.ndarray:
        """Vectorized window-emptiness test: out[k] is False only when the
        index proves no read overlaps [begs[k], ends[k]) (0-based
        half-open)."""
        if tid < 0 or tid >= len(self.bins) or not self.bins[tid]:
            return np.zeros(len(begs), dtype=bool)
        pre = self.tile_prefix(tid)
        n_tiles = len(pre) - 1
        tb = np.clip(np.asarray(begs, dtype=np.int64) >> 14, 0, n_tiles)
        te = np.clip((np.asarray(ends, dtype=np.int64) - 1) >> 14, -1,
                     n_tiles - 1)
        return pre[np.maximum(te + 1, tb)] - pre[tb] > 0

    def window_volumes(self, tid: int, begs: np.ndarray,
                       ends: np.ndarray) -> np.ndarray:
        """Approximate compressed-byte volume per window from the linear
        index: the coffset span of the (monotonified) 16 kb-tile ioffsets
        across each window — O(1) per window after one prefix pass, where
        per-window ``query_chunks`` would be O(tiles) each (quadratic over
        a whole-genome window stream).  Used as the range-scheduling cost
        proxy; read bp per window tracks compressed bytes near-linearly."""
        out = np.zeros(len(begs), dtype=np.int64)
        if tid < 0 or tid >= len(self.intervals):
            return out
        intv = self.intervals[tid]
        if intv.size == 0:
            return out
        coff = np.maximum.accumulate(intv.astype(np.int64)) >> 16
        # sentinel end coffset = end of the contig's data (max chunk end
        # across the contig's bins), so a window confined to the final
        # 16 kb tile costs its real bytes instead of clipping to zero and
        # being lumped into a neighbor's range
        end_coff = int(coff[-1])
        bd = self.bins[tid] if 0 <= tid < len(self.bins) else {}
        for chunks in bd.values():
            for _cb, ce in chunks:
                if (ce >> 16) > end_coff:
                    end_coff = ce >> 16
        coff = np.concatenate([coff, [end_coff]])
        n = coff.size - 1
        # tb clips to n (not n-1): a window entirely past the linear
        # index's extent must cost 0, not the tail tile's volume — only
        # windows genuinely ENDING in the last tile use the sentinel
        tb = np.clip(np.asarray(begs, dtype=np.int64) >> 14, 0, n)
        te = np.clip(((np.asarray(ends, dtype=np.int64) - 1) >> 14) + 1,
                     0, n)
        return np.maximum(coff[te] - coff[tb], 0)

    def query_chunks(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Candidate (voffset_beg, voffset_end) chunks for region [beg, end)."""
        if tid < 0 or tid >= len(self.bins) or not self.bins[tid]:
            return []
        bd = self.bins[tid]
        intv = self.intervals[tid]
        min_off = 0
        iv = beg >> 14
        if intv.size:
            iv = min(iv, intv.size - 1)
            # first non-zero linear offset at or before the interval
            sub = intv[:iv + 1]
            nz = sub[sub > 0]
            min_off = int(nz[-1]) if nz.size else 0
        chunks = []
        for b in reg2bins(beg, end):
            for cb, ce in bd.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        # merge adjacent/overlapping chunks
        merged: List[Tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


# ---------------- BAM reader ----------------

class BamReader:
    """Coordinate-sorted BAM with optional .bai random access."""

    def __init__(self, path: str, index_path: Optional[str] = None):
        self.path = path
        self._bgzf = bgzf.BgzfReader(path)
        self._parse_header()
        self.index: Optional[BaiIndex] = None
        for cand in ([index_path] if index_path else
                     [path + ".bai", path[:-4] + ".bai" if path.endswith(".bam") else None]):
            if cand is None:
                continue
            try:
                self.index = BaiIndex(cand)
                break
            except (OSError, ValueError):
                continue

    def _parse_header(self) -> None:
        # decode blocks until the full header (text + refs) is available
        data = bytearray()
        coff = 0
        raw = self._bgzf.raw

        def need(nbytes: int) -> None:
            nonlocal coff
            while len(data) < nbytes and coff < len(raw):
                data.extend(self._bgzf.read_block(coff))
                coff = self._bgzf.next_block_offset(coff)
            if len(data) < nbytes:
                raise ValueError("truncated BAM header")

        need(8)
        if bytes(data[:4]) != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack_from("<i", data, 4)
        need(8 + l_text + 4)
        self.header_text = bytes(data[8:8 + l_text]).rstrip(b"\x00").decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            need(off + 4)
            (l_name,) = struct.unpack_from("<i", data, off)
            off += 4
            need(off + l_name + 4)
            self.references.append(bytes(data[off:off + l_name - 1]).decode())
            off += l_name
            (l_ref,) = struct.unpack_from("<i", data, off)
            off += 4
            self.lengths.append(l_ref)
        self._header_len_uncomp = off  # uncompressed offset where records start

    def name2tid(self, name: str) -> int:
        try:
            return self.references.index(name)
        except ValueError:
            return -1

    # --- record iteration ---
    def _iter_records_from(self, data: bytes, start: int = 0,
                           stop_pos: Optional[int] = None,
                           tid: Optional[int] = None) -> Iterator[BamRecord]:
        off = start
        n = len(data)
        while off + 4 <= n:
            (block_size,) = struct.unpack_from("<i", data, off)
            if off + 4 + block_size > n:
                break
            rec = BamRecord(data[off + 4:off + 4 + block_size])
            off += 4 + block_size
            if tid is not None and rec.tid > tid:
                return
            if stop_pos is not None and rec.tid == tid and rec.pos >= stop_pos:
                return
            yield rec

    def window_certainly_empty(self, tid: int, beg: int, end: int) -> bool:
        """Index-only emptiness test: True when the .bai proves no read can
        overlap [beg, end).  Lets the caller skip the whole load path for
        the (whole-genome-mode) majority of read-free windows without
        opening per-thread handles or decoding any BGZF block."""
        if self.index is None:
            return False
        return not self.index.query_chunks(tid, beg, end)

    def windows_busy(self, tid: int, begs: np.ndarray,
                     ends: np.ndarray) -> np.ndarray:
        """Vectorized form of (not window_certainly_empty) over many
        windows — one numpy pass instead of per-window index queries."""
        if self.index is None:
            return np.ones(len(begs), dtype=bool)
        return self.index.busy_mask(tid, begs, ends)

    def _indexless_cache(self):
        """One-time full decode for .bai-less inputs: every record parsed
        once into per-tid, file-order (== coordinate-order) lists with
        sorted-pos + running-max-end arrays, so later fetches are two
        bisects instead of re-inflating and re-parsing the whole file per
        window (measured 12x whole-file zlib on a 12-window contig)."""
        cached = getattr(self, "_noidx", None)
        if cached is not None:
            return cached
        data = bgzf.decompress_all(self._bgzf.raw)
        by_tid: dict = {}
        for rec in self._iter_records_from(data, self._header_len_uncomp):
            by_tid.setdefault(rec.tid, []).append(rec)
        cached = {}
        for t, recs in by_tid.items():
            pos = np.fromiter((r.pos for r in recs), dtype=np.int64,
                              count=len(recs))
            ends = np.fromiter((r.endpos for r in recs), dtype=np.int64,
                               count=len(recs))
            cached[t] = (recs, pos, np.maximum.accumulate(ends))
        self._noidx = cached
        return cached

    def fetch(self, tid: int, beg: int, end: int) -> List[BamRecord]:
        """All records overlapping [beg, end) (0-based half-open), in file
        order — matches htslib ``sam_itr_queryi`` semantics."""
        out: List[BamRecord] = []
        if self.index is not None:
            for cb, ce in self.index.query_chunks(tid, beg, end):
                nbytes = self._chunk_span_bytes(cb, ce)
                data = self._bgzf.read_from(cb, nbytes)
                for rec in self._iter_records_from(data, 0, stop_pos=end, tid=tid):
                    if rec.tid == tid and rec.pos < end and rec.endpos > beg:
                        out.append(rec)
        else:
            got = self._indexless_cache().get(tid)
            if got is not None:
                recs, pos, run_end = got
                # first candidate: running max end is monotone, so the
                # records that could overlap start where it passes beg
                lo = int(np.searchsorted(run_end, beg, side="right"))
                hi = int(np.searchsorted(pos, end, side="left"))
                for k in range(lo, hi):
                    r = recs[k]
                    if r.pos < end and r.endpos > beg:
                        out.append(r)
        # de-dup records that appear in multiple chunks (same identity)
        seen = set()
        uniq = []
        for r in out:
            key = (r.pos, r.flag, r.qname)
            if key in seen:
                continue
            seen.add(key)
            uniq.append(r)
        return uniq

    def _chunk_span_bytes(self, vbeg: int, vend: int) -> int:
        """Upper bound of uncompressed bytes spanned by a voffset chunk."""
        cb, ub = vbeg >> 16, vbeg & 0xFFFF
        ce, ue = vend >> 16, vend & 0xFFFF
        if cb == ce:
            return ue - ub
        # ~64KiB per block upper bound
        nblocks = 0
        coff = cb
        while coff < ce:
            coff = self._bgzf.next_block_offset(coff)
            nblocks += 1
        return nblocks * 65536 + ue

    def __iter__(self) -> Iterator[BamRecord]:
        data = bgzf.decompress_all(self._bgzf.raw)
        yield from self._iter_records_from(data, self._header_len_uncomp)
