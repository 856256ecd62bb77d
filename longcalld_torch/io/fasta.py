"""faidx-backed FASTA access (replaces htslib faidx_fetch_seq usage at
reference/src/bam_utils.c:1555-1582)."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

# ASCII -> nt4 (A0 C1 G2 T3 N4, '-' -> 5); mirrors nst_nt4_table
# (reference/src/seq.c:14-31), including the 0..3 mapping of bytes 0-3.
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
NT4_TABLE[:4] = [0, 1, 2, 3]
for i, ch in enumerate("ACGT"):
    NT4_TABLE[ord(ch)] = i
    NT4_TABLE[ord(ch.lower())] = i
NT4_TABLE[ord("-")] = 5

NT4_TO_CHAR = np.frombuffer(b"ACGTN-", dtype=np.uint8)


class FastaFile:
    """Random access to a FASTA via its .fai index."""

    def __init__(self, path: str, fai_path: str | None = None):
        from longcalld_torch.io.remote import (RemoteBytes, RemoteFileHandle,
                                             fetch_url, is_url, resolve_url)
        self.path = path
        fai_path = fai_path or path + ".fai"
        if is_url(path):
            # remote FASTA: .fai fetched whole, sequence slices by faidx
            # arithmetic over range requests (utils.c:483-521 + hfile)
            fai_text = fetch_url(fai_path).decode()
            self._fh = RemoteFileHandle(RemoteBytes(resolve_url(path)))
        else:
            if not os.path.exists(fai_path):
                raise FileNotFoundError(
                    f"FASTA index not found: {fai_path}; index the FASTA first")
            with open(fai_path) as f:
                fai_text = f.read()
            self._fh = open(path, "rb")
        self._idx: Dict[str, Tuple[int, int, int, int]] = {}
        self.references: List[str] = []
        for line in fai_text.splitlines():
            if not line.strip():
                continue
            name, length, offset, linebases, linewidth = line.split()[:5]
            self._idx[name] = (int(length), int(offset),
                               int(linebases), int(linewidth))
            self.references.append(name)

    def seq_len(self, name: str) -> int:
        return self._idx[name][0]

    def fetch(self, name: str, beg: int, end: int) -> bytes:
        """Sequence for [beg, end] 0-based INCLUSIVE (htslib faidx_fetch_seq
        convention).  Clamps to the contig like htslib does."""
        length, offset, linebases, linewidth = self._idx[name]
        beg = max(0, beg)
        end = min(length - 1, end)
        if beg > end:
            return b""
        fbeg = offset + beg // linebases * linewidth + beg % linebases
        fend = offset + end // linebases * linewidth + end % linebases + 1
        self._fh.seek(fbeg)
        raw = self._fh.read(fend - fbeg)
        return raw.replace(b"\n", b"").replace(b"\r", b"")

    def fetch_nt4(self, name: str, beg: int, end: int) -> np.ndarray:
        raw = np.frombuffer(self.fetch(name, beg, end), dtype=np.uint8)
        return NT4_TABLE[raw]

    def close(self) -> None:
        self._fh.close()
