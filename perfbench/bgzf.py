"""A BGZF writer and a BAM index (.bai) builder in numpy and zlib.

The BAM is made whole in memory: its uncompressed bytes are cut into
blocks of MAX_BLOCK bytes, each deflated on its own, so a record that
starts at uncompressed offset ``p`` has the virtual offset
``coffset[p // MAX_BLOCK] << 16 | p % MAX_BLOCK``, and the index is
built from the record offsets without reading the file back.  The index
follows the SAM specification: a binning index of merged chunks and a
16 kb linear index, as samtools writes it."""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence

import numpy as np

MAX_BLOCK = 0xFF00
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
# BAM CIGAR ops that consume the reference: M, D, N, =, X
_REF_OPS = (0, 2, 3, 7, 8)


def block(payload: bytes, level: int) -> bytes:
    """One BGZF block holding ``payload`` (at most MAX_BLOCK bytes)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    hdr = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                      66, 67, 2, len(comp) + 25)
    return hdr + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                    len(payload))


def reg2bin(beg: int, end: int) -> int:
    """SAM-spec bin of the 0-based half-open interval [beg, end)."""
    end -= 1
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return first + (beg >> shift)
    return 0


def bam_header(names: Sequence[str], lengths: Sequence[int]) -> bytes:
    text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(names, lengths))
    hdr = bytearray(b"BAM\x01")
    hdr += struct.pack("<i", len(text)) + text.encode()
    hdr += struct.pack("<i", len(names))
    for n, l in zip(names, lengths):
        nb = n.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    return bytes(hdr)


def write_bam(path: str, names: Sequence[str], lengths: Sequence[int],
              records: Sequence[bytes], level: int = 6) -> None:
    """Write ``records`` (raw BAM records without their block_size,
    coordinate-sorted) as a BGZF BAM at ``path`` and its index at
    ``path + '.bai'``."""
    head = bam_header(names, lengths)
    sizes = np.fromiter((len(r) + 4 for r in records), dtype=np.int64,
                        count=len(records))
    starts = len(head) + np.concatenate([[0], np.cumsum(sizes)])
    data = bytearray(head)
    for rec in records:
        data += struct.pack("<i", len(rec)) + rec
    blocks = [block(bytes(data[o:o + MAX_BLOCK]), level)
              for o in range(0, len(data), MAX_BLOCK)]
    with open(path, "wb") as fh:
        for b in blocks:
            fh.write(b)
        fh.write(EOF_BLOCK)
    # coff[len(blocks)] is the EOF block's: the end of the last record
    # points there, as an index built by reading the blocks back has it
    coff = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])

    def voff(p: int) -> int:
        bi = p // MAX_BLOCK if p < len(data) else len(blocks)
        return (int(coff[bi]) << 16) | (p - min(bi * MAX_BLOCK, len(data)))

    bins: List[dict] = [dict() for _ in names]
    intv: List[dict] = [dict() for _ in names]
    for k, rec in enumerate(records):
        ref_id, pos = struct.unpack_from("<ii", rec, 0)
        if not (0 <= ref_id < len(names) and pos >= 0):
            continue
        l_name = rec[8]
        (n_cigar,) = struct.unpack_from("<H", rec, 12)
        end = pos + 1
        if n_cigar:
            cig = np.frombuffer(rec, dtype="<u4", count=n_cigar,
                                offset=32 + l_name)
            end = pos + max(int((cig[np.isin(cig & 0xF, _REF_OPS)]
                                 >> 4).sum()), 1)
        vb, ve = voff(int(starts[k])), voff(int(starts[k + 1]))
        got = bins[ref_id].setdefault(reg2bin(pos, end), [])
        if got and got[-1][1] == vb:
            got[-1][1] = ve
        else:
            got.append([vb, ve])
        for w in range(pos >> 14, ((end - 1) >> 14) + 1):
            if w not in intv[ref_id] or vb < intv[ref_id][w]:
                intv[ref_id][w] = vb
    buf = bytearray(b"BAI\x01") + struct.pack("<i", len(names))
    for t in range(len(names)):
        buf += struct.pack("<i", len(bins[t]))
        for bin_id in sorted(bins[t]):
            chunks = bins[t][bin_id]
            buf += struct.pack("<Ii", bin_id, len(chunks))
            for cb, ce in chunks:
                buf += struct.pack("<QQ", cb, ce)
        n_intv = (max(intv[t]) + 1) if intv[t] else 0
        buf += struct.pack("<i", n_intv)
        for w in range(n_intv):
            buf += struct.pack("<Q", intv[t].get(w, 0))
    with open(path + ".bai", "wb") as fh:
        fh.write(bytes(buf))
