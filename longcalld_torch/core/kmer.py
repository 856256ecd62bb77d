"""TE (mobile-element) k-mer index and classification.

Re-implements make_te_kmer_idx / check_te_seq
(reference/src/kmer.c:120-148, 218-248): per TE consensus sequence
(AluY / L1 / SVA FASTA via -T), forward and reverse-complement 15-mer sets
(simple homopolymer k-mers excluded); a candidate insertion is classified by
counting its strided (0, k, 2k, ...) k-mers against each set, best family
wins with >= 3 hits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from longcalld_torch.io.fasta import NT4_TABLE


def _not_simple(kmers: np.ndarray, k: int) -> np.ndarray:
    """Exclude k-mers that are a single repeated base (not_simple_kmer,
    kmer.c:16-24)."""
    base = kmers & 3
    simple = np.ones(len(kmers), dtype=bool)
    v = kmers.copy()
    for _ in range(k):
        simple &= (v & 3) == base
        v >>= 2
    return ~simple


def _rolling_kmers(seq4: np.ndarray, k: int, rev: bool) -> np.ndarray:
    """All consecutive k-mers (N breaks runs); reverse-complement codes when
    rev (collect_kmer / collect_rev_kmer, kmer.c:27-74)."""
    n = len(seq4)
    if n < k:
        return np.zeros(0, dtype=np.uint32)
    valid = seq4 < 4
    codes = seq4.astype(np.uint64)
    out = []
    key = 0
    l = 0
    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    for i in range(n):
        if valid[i]:
            c = int(codes[i])
            if rev:
                key = (key >> 2) | ((c ^ 3) << shift1)
            else:
                key = ((key << 2) | c) & mask
            l += 1
            if l >= k:
                out.append(key)
        else:
            l = 0
            key = 0
    arr = np.array(out, dtype=np.uint32)
    return arr[_not_simple(arr, k)] if len(arr) else arr


def _strided_kmers(seq4: np.ndarray, k: int) -> np.ndarray:
    """Query k-mers at positions 0, k, 2k, ... (collect_query_kmer,
    kmer.c:151-173): the counter resets after each emitted k-mer and at Ns.
    """
    out = []
    key = 0
    l = 0
    mask = (1 << (2 * k)) - 1
    for b in seq4:
        if b < 4:
            key = ((key << 2) | int(b)) & mask
            l += 1
            if l == k:
                out.append(key)
                l = 0
        else:
            l = 0
    arr = np.array(out, dtype=np.uint32)
    return arr[_not_simple(arr, k)] if len(arr) else arr


class TeKmerIndex:
    def __init__(self, fasta_path: str, k: int = 15):
        self.k = k
        self.names: List[str] = []
        self.for_sets: List[np.ndarray] = []
        self.rev_sets: List[np.ndarray] = []
        for name, seq in _read_fasta(fasta_path):
            seq4 = NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]
            self.names.append(name)
            self.for_sets.append(np.unique(_rolling_kmers(seq4, k, False)))
            self.rev_sets.append(np.unique(_rolling_kmers(seq4, k, True)))

    def classify(self, seq4: np.ndarray) -> Tuple[int, bool]:
        """(te_seq_i, is_rev); (-1, False) if no family reaches 3 hits
        (check_te_seq, kmer.c:218-248)."""
        q = _strided_kmers(np.asarray(seq4, dtype=np.uint8), self.k)
        if len(q) == 0:
            return -1, False
        max_for = max_rev = 0
        max_for_i = max_rev_i = -1
        for i in range(len(self.names)):
            fc = int(np.isin(q, self.for_sets[i]).sum())
            rc = int(np.isin(q, self.rev_sets[i]).sum())
            if fc > max_for:
                max_for, max_for_i = fc, i
            if rc > max_rev:
                max_rev, max_rev_i = rc, i
        if max_for > max_rev:
            return (max_for_i, False) if max_for >= 3 else (-1, False)
        return (max_rev_i, True) if max_rev >= 3 else (-1, True)


def _read_fasta(path: str):
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    name = None
    chunks: List[bytes] = []
    with opener(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n\r")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)
