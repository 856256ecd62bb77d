"""Remote http(s) inputs: redirect resolution + range-request byte access.

TPU-native analog of the reference's remote-BAM/FASTA support
(reference/src/utils.c:447-521 ``is_url``/``retrieve_full_url`` +
htslib's hfile_libcurl): the driver resolves the URL once up-front
(following redirects, as ``retrieve_full_url`` does with
CURLOPT_FOLLOWLOCATION) and the readers then fetch only the byte ranges
they need — .bai-guided BGZF chunks, faidx-guided FASTA slices — instead
of downloading whole files.

Implemented with urllib (no curl in-image).  Servers that ignore Range
headers (HTTP 200 instead of 206) degrade gracefully to a one-shot full
download.
"""

from __future__ import annotations

import re
import urllib.request
from collections import OrderedDict
from typing import Optional

_URL_RE = re.compile(r"^(https?)://", re.IGNORECASE)

# 512 KiB range chunks: large enough to amortize request latency over the
# ~16 KiB BGZF blocks a .bai chunk walk touches, small enough not to drag
# in whole files.
CHUNK_BYTES = 512 * 1024
MAX_CACHED_CHUNKS = 1024  # 512 MiB cap per remote file


def is_url(path: str) -> bool:
    """True for http(s) URLs (utils.c:447-476 ``is_url`` regex analog)."""
    return bool(_URL_RE.match(path))


def resolve_url(url: str, timeout: float = 30.0) -> str:
    """Follow redirects and return the effective URL
    (``retrieve_full_url``, utils.c:483-521: HEAD + FOLLOWLOCATION +
    CURLINFO_EFFECTIVE_URL)."""
    if not is_url(url):
        return url
    req = urllib.request.Request(url, method="HEAD")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.geturl()


def fetch_url(url: str, timeout: float = 60.0) -> bytes:
    """Download a whole (small) remote file: .bai/.fai/.crai indexes."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


class RemoteBytes:
    """Lazily-fetched, sliceable view of a remote file.

    Quacks enough like ``bytes`` for the BGZF/FASTA readers: ``len()``,
    ``obj[i]`` and ``obj[a:b]`` (returning real ``bytes``), backed by an
    LRU cache of fixed-size range-request chunks.
    """

    def __init__(self, url: str, chunk_bytes: int = CHUNK_BYTES,
                 max_chunks: int = MAX_CACHED_CHUNKS, timeout: float = 60.0):
        self.url = url
        self._chunk = int(chunk_bytes)
        self._max_chunks = int(max_chunks)
        self._timeout = timeout
        self._cache: "OrderedDict[int, bytes]" = OrderedDict()
        self._full: Optional[bytes] = None  # fallback: server ignores Range
        self._len = self._probe_length()
        self.n_requests = 0
        self.bytes_fetched = 0

    def _probe_length(self) -> int:
        req = urllib.request.Request(self.url, method="HEAD")
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            cl = resp.headers.get("Content-Length")
            if cl is None:
                # no length advertised: must download fully
                self._full = fetch_url(self.url, self._timeout)
                return len(self._full)
            return int(cl)

    def __len__(self) -> int:
        return self._len

    def _fetch_range(self, beg: int, end_incl: int) -> bytes:
        req = urllib.request.Request(
            self.url, headers={"Range": f"bytes={beg}-{end_incl}"})
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            body = resp.read()
            self.n_requests += 1
            self.bytes_fetched += len(body)
            if resp.status == 206:
                return body
            # server ignored Range: body is the whole file
            self._full = body
            return body[beg:end_incl + 1]

    def _chunk_data(self, ci: int) -> bytes:
        blk = self._cache.get(ci)
        if blk is not None:
            self._cache.move_to_end(ci)
            return blk
        beg = ci * self._chunk
        end_incl = min(self._len, beg + self._chunk) - 1
        blk = self._fetch_range(beg, end_incl)
        if self._full is not None:
            return self._full[beg:end_incl + 1]
        self._cache[ci] = blk
        while len(self._cache) > self._max_chunks:
            self._cache.popitem(last=False)
        return blk

    def _read(self, beg: int, end: int) -> bytes:
        """bytes for [beg, end) clamped to the file."""
        beg = max(0, min(beg, self._len))
        end = max(beg, min(end, self._len))
        if beg == end:
            return b""
        if self._full is not None:
            return self._full[beg:end]
        c0, c1 = beg // self._chunk, (end - 1) // self._chunk
        parts = [self._chunk_data(ci) for ci in range(c0, c1 + 1)]
        raw = parts[0] if len(parts) == 1 else b"".join(parts)
        off = c0 * self._chunk
        return raw[beg - off:end - off]

    def __getitem__(self, key):
        if isinstance(key, slice):
            beg, end, step = key.indices(self._len)
            if step != 1:
                return self._read(beg, end)[::step]
            return self._read(beg, end)
        if key < 0:
            key += self._len
        b = self._read(key, key + 1)
        if not b:
            raise IndexError("index out of range")
        return b[0]


class RemoteFileHandle:
    """Minimal seek/read file-object over :class:`RemoteBytes`
    (what ``FastaFile`` needs in place of ``open(path, 'rb')``)."""

    def __init__(self, src: RemoteBytes):
        self._src = src
        self._pos = 0

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = len(self._src) + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        end = len(self._src) if n < 0 else self._pos + n
        out = self._src[self._pos:end]
        self._pos += len(out)
        return out

    def close(self) -> None:
        pass
