"""BGZF (blocked gzip) reader/writer.

Replaces the reference's dependency on htslib bgzf (used for BAM and
bgzip-compressed VCF I/O; see SURVEY.md L0).  BGZF is a series of gzip members,
each carrying a BSIZE extra field giving the compressed block length; files end
with a fixed 28-byte EOF marker block.
"""

from __future__ import annotations

import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Iterator, List, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<4BI2BH")  # magic(4) mtime xfl os xlen


def _block_size_from_header(buf, off: int) -> int:
    """Parse one BGZF block header at ``off``; return total compressed size.

    ``buf`` is ``bytes`` or any sliceable byte source (io.remote.RemoteBytes
    for http(s) inputs) — only small local slices are materialized."""
    hdr = bytes(buf[off:off + 12])
    if len(hdr) < 12 or hdr[0] != 0x1F or hdr[1] != 0x8B:
        raise ValueError(f"bad gzip magic at offset {off}")
    xlen = struct.unpack_from("<H", hdr, 10)[0]
    extra = bytes(buf[off + 12:off + 12 + xlen])
    xoff = 0
    while xoff < xlen:
        si1, si2, slen = struct.unpack_from("<BBH", extra, xoff)
        if si1 == 66 and si2 == 67:  # 'B','C'
            bsize = struct.unpack_from("<H", extra, xoff + 4)[0]
            return bsize + 1
        xoff += 4 + slen
    raise ValueError("BGZF: missing BSIZE extra field")


def iter_blocks(data: bytes) -> Iterator[Tuple[int, int]]:
    """Yield (coffset, csize) for every BGZF block in ``data``."""
    off = 0
    n = len(data)
    while off < n:
        size = _block_size_from_header(data, off)
        yield off, size
        off += size


def decompress_block(data, coffset: int, csize: int) -> bytes:
    # skip 12-byte fixed header + extra fields; inflate raw deflate stream
    raw = bytes(data[coffset:coffset + csize])
    xlen = struct.unpack_from("<H", raw, 10)[0]
    isize = struct.unpack_from("<I", raw, csize - 4)[0]
    d = zlib.decompressobj(-15)
    out = d.decompress(raw[12 + xlen:csize - 8], isize)
    return out


def decompress_all(data: bytes) -> bytes:
    """Decompress an entire BGZF byte string (concatenated gzip members)."""
    parts: List[bytes] = []
    for coff, csize in iter_blocks(data):
        parts.append(decompress_block(data, coff, csize))
    return b"".join(parts)


class BgzfReader:
    """Random-access BGZF reader over an in-memory or file-backed byte source.

    Supports htslib-style virtual file offsets voffset = coffset << 16 | uoffset
    used by .bai indices.
    """

    def __init__(self, path: str):
        from longcalld_torch.io.remote import RemoteBytes, is_url, resolve_url
        if is_url(path):
            # range-request view: .bai-guided queries touch only the
            # chunks they need (htslib hfile_libcurl analog)
            self._data = RemoteBytes(resolve_url(path))
        else:
            with open(path, "rb") as f:
                self._data = f.read()
        self._block_cache: dict = {}

    def _block_and_size(self, coffset: int):
        ent = self._block_cache.get(coffset)
        if ent is None:
            csize = _block_size_from_header(self._data, coffset)
            ent = (decompress_block(self._data, coffset, csize), csize)
            self._block_cache[coffset] = ent
        return ent

    def read_block(self, coffset: int) -> bytes:
        return self._block_and_size(coffset)[0]

    def next_block_offset(self, coffset: int) -> int:
        ent = self._block_cache.get(coffset)
        if ent is not None:
            return coffset + ent[1]
        return coffset + _block_size_from_header(self._data, coffset)

    @property
    def raw(self) -> bytes:
        return self._data

    def read_from(self, voffset: int, nbytes: int) -> bytes:
        """Read ``nbytes`` of uncompressed data starting at virtual offset.

        Collects whole blocks and joins once — growing a bytearray across
        a multi-megabyte span re-copies the tail on every block and
        dominated window loads."""
        coff = voffset >> 16
        uoff = voffset & 0xFFFF
        parts: List[bytes] = []
        got = -uoff
        n = len(self._data)
        while got < nbytes and coff < n:
            blk, csize = self._block_and_size(coff)
            parts.append(blk)
            got += len(blk)
            coff += csize
        out = b"".join(parts)
        return out[uoff:uoff + nbytes]


class BgzfWriter:
    """Streaming BGZF writer (used for .vcf.gz / output BAM).

    With ``n_threads > 1``, blocks are compressed by a thread pool and
    written strictly in order — the analog of the reference's
    ``hts_set_threads`` on the output BAM
    (reference/src/call_var_main.c:756).  CPython's zlib releases
    the GIL while deflating, so the pool parallelizes for real.
    """

    MAX_BLOCK = 0xFF00  # uncompressed payload per block (htslib default)

    def __init__(self, fh: BinaryIO, level: int = 6, n_threads: int = 1):
        self._fh = fh
        self._level = level
        self._buf = bytearray()
        self._pool = None
        self._pending: "deque" = deque()
        if n_threads and n_threads > 1:
            self._pool = ThreadPoolExecutor(max_workers=int(n_threads))
            self._max_pending = int(n_threads) * 4

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(bytes(self._buf[:self.MAX_BLOCK]))
            del self._buf[:self.MAX_BLOCK]

    @staticmethod
    def _compress_block(payload: bytes, level: int) -> bytes:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25  # header(12)+extra(6)+payload+crc(4)+isize(4)-1
        hdr = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                          66, 67, 2, bsize)
        trailer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                              len(payload))
        return hdr + comp + trailer

    def _flush_block(self, payload: bytes) -> None:
        if self._pool is None:
            self._fh.write(self._compress_block(payload, self._level))
            return
        self._pending.append(
            self._pool.submit(self._compress_block, payload, self._level))
        # drain completed blocks in order; bound in-flight memory
        while self._pending and (self._pending[0].done()
                                 or len(self._pending) > self._max_pending):
            self._fh.write(self._pending.popleft().result())

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        while self._pending:
            self._fh.write(self._pending.popleft().result())
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self._fh.write(BGZF_EOF)
        self._fh.flush()
