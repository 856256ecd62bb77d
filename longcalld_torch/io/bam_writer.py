"""Phased BAM output: input records + HP (haplotype) / PS (phase set) tags.

Re-implements the tag-writing path of write_read_to_bam
(reference/src/bam_utils.c:1718-2048): per window, reads already
emitted by the previous window are skipped, existing HP/PS tags are replaced
with ours.  (--refine-aln CIGAR rewriting is a separate, later stage.)
"""

from __future__ import annotations

import struct
from typing import List, Optional

from longcalld_torch.io import bgzf
from longcalld_torch.io.bam import BamReader, BamRecord


def _strip_tags(raw: bytes, tag_off: int, names=(b"HP", b"PS")) -> bytes:
    """Remove specific aux tags from the raw record bytes."""
    out = bytearray(raw[:tag_off])
    off = tag_off
    n = len(raw)
    while off + 3 <= n:
        start = off
        tag = raw[off:off + 2]
        typ = chr(raw[off + 2])
        off += 3
        if typ in "cCA":
            off += 1
        elif typ in "sS":
            off += 2
        elif typ in "iIf":
            off += 4
        elif typ in "ZH":
            off = raw.index(b"\x00", off) + 1
        elif typ == "B":
            st = chr(raw[off])
            cnt = struct.unpack_from("<i", raw, off + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[st]
            off += 5 + cnt * sz
        else:
            break
        if tag not in names:
            out += raw[start:off]
    return bytes(out)


def finalize_record(rec: BamRecord, hap: int = 0, phase_set: int = -1,
                    raw_override: Optional[bytes] = None) -> bytes:
    """The canonical final record: input bytes (or the refined override)
    with any pre-existing HP/PS stripped and ours appended (the
    bam_aux_update path of src/bam_utils.c:1967-2002).  Every phased
    writer emits exactly this byte string — which also makes it the unit
    persisted by --checkpoint for deterministic replay."""
    if raw_override is not None:
        rec = BamRecord(raw_override)
    raw = _strip_tags(rec._raw, rec._tag_off)
    extra = bytearray()
    if hap > 0:
        # 'i' 4-byte int, matching the reference's bam_aux_append
        # (src/bam_utils.c:1975-1978)
        extra += b"HP" + b"i" + struct.pack("<i", hap)
    if phase_set >= 0:
        extra += b"PS" + b"i" + struct.pack("<i", int(phase_set))
    return raw + bytes(extra)


class PhasedCramWriter:
    """Phased output as CRAM 3.0 (the reference's --out-cram path,
    reference/src/call_var_main.c:753-754): same tag surface as
    PhasedBamWriter, records re-encoded reference-based."""

    def __init__(self, path: str, template: "BamReader", ref_fa_fn: str):
        from longcalld_torch.io.cram import CramWriter
        self._w = CramWriter(path, template.header_text,
                             list(template.references),
                             list(template.lengths), ref_fa_fn)

    def write_record(self, rec: BamRecord, hap: int = 0,
                     phase_set: int = -1,
                     raw_override: Optional[bytes] = None) -> None:
        self.write_final(finalize_record(rec, hap, phase_set, raw_override))

    def write_final(self, raw: bytes) -> None:
        self._w.write_record(BamRecord(raw))

    def close(self) -> None:
        self._w.close()


class PhasedBamWriter:
    def __init__(self, path: str, template: BamReader, n_threads: int = 4):
        self._fh = open(path, "wb")
        # threaded block compression = hts_set_threads on the output BAM
        # (call_var_main.c:756)
        self._w = bgzf.BgzfWriter(self._fh, n_threads=n_threads)
        # header: magic + text + reference list from the template
        text = template.header_text.encode()
        hdr = bytearray(b"BAM\x01")
        hdr += struct.pack("<i", len(text))
        hdr += text
        hdr += struct.pack("<i", len(template.references))
        for name, ln in zip(template.references, template.lengths):
            nb = name.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._w.write(bytes(hdr))

    def write_record(self, rec: BamRecord, hap: int = 0,
                     phase_set: int = -1,
                     raw_override: Optional[bytes] = None) -> None:
        self.write_final(finalize_record(rec, hap, phase_set, raw_override))

    def write_final(self, body: bytes) -> None:
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        self._w.close()
        self._fh.close()


def write_window_reads(writer: PhasedBamWriter, chunk, opt=None,
                       capture: Optional[List[bytes]] = None) -> int:
    """Emit one window's reads with phasing tags, skipping reads that
    overlap the previous window (already written there, mirrors
    src/bam_utils.c:2026-2041).  With --refine-aln, records whose digar was
    respliced during noisy-region realignment are rewritten
    (write_processed_read_to_bam, src/bam_utils.c:1955-1966).  When
    `capture` is given, the finalized record bytes are also appended to it
    (the --checkpoint persistence unit)."""
    refine = opt is not None and opt.refine_bam
    if refine:
        from longcalld_torch.core.refine import refine_record_bytes
    skip = set(chunk.up_ovlp_read_i)
    n = 0
    for ri in range(chunk.n_reads):
        if ri in skip:
            continue
        hap = int(chunk.haps[ri]) if chunk.haps is not None else 0
        ps = int(chunk.phase_sets[ri]) if chunk.phase_sets is not None else -1
        raw = None
        if refine and chunk.digars[ri] is not None:
            raw = refine_record_bytes(opt, chunk.reads[ri], chunk.digars[ri],
                                      chunk.ref4, chunk.ref_beg,
                                      chunk.ref_end)
        final = finalize_record(chunk.reads[ri], hap, ps if ps > 0 else -1,
                                raw_override=raw)
        writer.write_final(final)
        if capture is not None:
            capture.append(final)
        n += 1
    return n


def replay_window_reads(writer, payloads: List[bytes]) -> int:
    """Re-emit a checkpointed window's finalized records verbatim.  Same
    writer code path as a live window, so a resumed run's output stream is
    byte-for-byte the stream an uninterrupted run produced."""
    for raw in payloads:
        writer.write_final(raw)
    return len(payloads)


# ---------- SAM text output (the reference's -S/--out-sam) ----------

_NT16_CHARS = "=ACMGRSVTWYHKDBN"
_CIGAR_CHARS = "MIDNSHP=X"


def _tags_to_sam(raw: bytes, tag_off: int, skip=(b"HP", b"PS")) -> List[str]:
    """Decode aux tags to SAM TAG:TYPE:VALUE text columns."""
    out: List[str] = []
    off = tag_off
    n = len(raw)
    while off + 3 <= n:
        tag = raw[off:off + 2]
        typ = chr(raw[off + 2])
        off += 3
        if typ in "cC":
            v = struct.unpack_from("<b" if typ == "c" else "<B", raw, off)[0]
            off += 1
            txt = f"{tag.decode()}:i:{v}"
        elif typ == "A":
            txt = f"{tag.decode()}:A:{chr(raw[off])}"
            off += 1
        elif typ in "sS":
            v = struct.unpack_from("<h" if typ == "s" else "<H", raw, off)[0]
            off += 2
            txt = f"{tag.decode()}:i:{v}"
        elif typ in "iI":
            v = struct.unpack_from("<i" if typ == "i" else "<I", raw, off)[0]
            off += 4
            txt = f"{tag.decode()}:i:{v}"
        elif typ == "f":
            v = struct.unpack_from("<f", raw, off)[0]
            off += 4
            txt = f"{tag.decode()}:f:{v:g}"
        elif typ in "ZH":
            end = raw.index(b"\x00", off)
            txt = f"{tag.decode()}:{typ}:{raw[off:end].decode()}"
            off = end + 1
        elif typ == "B":
            st = chr(raw[off])
            cnt = struct.unpack_from("<i", raw, off + 1)[0]
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                   "i": "<i", "I": "<I", "f": "<f"}[st]
            sz = struct.calcsize(fmt)
            vals = [struct.unpack_from(fmt, raw, off + 5 + k * sz)[0]
                    for k in range(cnt)]
            txt = (f"{tag.decode()}:B:{st}," +
                   ",".join(f"{v:g}" if st == "f" else str(v) for v in vals))
            off += 5 + cnt * sz
        else:
            break
        if tag not in skip:
            out.append(txt)
    return out


def record_to_sam(rec: BamRecord, references,
                  keep_phase_tags: bool = False) -> str:
    """Decode one BAM record to a SAM line (HP/PS dropped unless
    keep_phase_tags)."""
    raw = rec._raw
    (_tid, _pos, _lrn, _mapq, _bin, n_cigar, _flag, l_seq,
     ntid, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", raw, 0)
    rname = references[rec.tid] if rec.tid >= 0 else "*"
    if n_cigar:
        cig = "".join(
            f"{v >> 4}{_CIGAR_CHARS[v & 0xF]}"
            for v in struct.unpack_from(f"<{n_cigar}I", raw,
                                        rec._cigar_off))
    else:
        cig = "*"
    if l_seq:
        so = rec._seq_off
        seq = "".join(
            _NT16_CHARS[(raw[so + i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
            for i in range(l_seq))
        q = raw[rec._qual_off:rec._qual_off + l_seq]
        qual = ("*" if q and q[0] == 0xFF
                else "".join(chr(min(x, 93) + 33) for x in q))
    else:
        seq = qual = "*"
    rnext = ("*" if ntid < 0
             else "=" if ntid == rec.tid else references[ntid])
    cols = [rec.qname, str(rec.flag), rname, str(rec.pos + 1),
            str(rec.mapq), cig, rnext, str(npos + 1), str(tlen), seq, qual]
    cols += _tags_to_sam(raw, rec._tag_off,
                         skip=() if keep_phase_tags else (b"HP", b"PS"))
    return "\t".join(cols)


class PhasedSamWriter:
    """Phased output as SAM text (the reference's -S path,
    reference/src/call_var_main.c:751)."""

    def __init__(self, path: str, template: BamReader):
        import sys as _sys
        self._own = path != "-"
        self._fh = open(path, "w") if self._own else _sys.stdout
        self._refs = list(template.references)
        hdr = template.header_text
        if not hdr.endswith("\n") and hdr:
            hdr += "\n"
        self._fh.write(hdr)

    def write_record(self, rec: BamRecord, hap: int = 0,
                     phase_set: int = -1,
                     raw_override: Optional[bytes] = None) -> None:
        self.write_final(finalize_record(rec, hap, phase_set, raw_override))

    def write_final(self, raw: bytes) -> None:
        # the finalized record carries our HP/PS at the end of the aux
        # data, so decoding with no skip list renders them as the last
        # SAM columns — identical text to the reference's append order
        rec = BamRecord(raw)
        cols = record_to_sam(rec, self._refs, keep_phase_tags=True)
        self._fh.write(cols + "\n")

    def close(self) -> None:
        if self._own:
            self._fh.close()
