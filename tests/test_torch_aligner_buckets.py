"""The aligner's routing counters (ops/wfa.py:BatchAligner) and band_fwd's
real rows by launch shape (ops/band.py:fwd_rows), and how a pool range
ships them (core/pipeline.py:_worker_totals / _range_worker).

On a crafted batch on CPU tensors (the kernels' plain versions) with a
low ``device_min_cells``: the wide host cells are exactly those of the
pairs above the threshold whose band bucket is above 512, a part of
``cells_host``; the device-routed cells are the other pairs above it;
and the rows counted a shape are the pattern lengths that band_fwd was
given.  Then a call whose ranges run in this process, with counters
that first appear inside a range.

Tolerance: exact (integer counts)."""

import collections
import io
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from longcalld_torch.config import CallOpts
from longcalld_torch.core import pipeline as tpl
from longcalld_torch.core import procpool
from longcalld_torch.ops import band
from longcalld_torch.ops import wfa
from longcalld_torch.utils import counters
from perfbench import gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MIN_CELLS = 5_000


def _pair(rng, n, diff):
    """A pattern of n bases and a text that is the pattern with ``diff``
    bases inserted in its middle (deleted where ``diff`` < 0), and a few
    substitutions."""
    p = rng.integers(0, 4, n).astype(np.uint8)
    t = p.copy()
    mut = rng.choice(n, 4, replace=False)
    t[mut] = (t[mut] + 1) % 4
    mid = n // 2
    if diff >= 0:
        t = np.concatenate([t[:mid], rng.integers(0, 4, diff).astype(
            np.uint8), t[mid:]])
    else:
        t = np.concatenate([t[:mid], t[mid - diff:]])
    return p, t


def _batch():
    rng = np.random.default_rng(20261018)
    small = [_pair(rng, 40, 3), _pair(rng, 60, -2)]         # <= MIN_CELLS
    # band bucket: |len(t) - len(p)| + 128 rounded up to 256, 1024, 4096
    wide = [_pair(rng, 300, 500), _pair(rng, 900, -450),    # bucket 1024
            _pair(rng, 400, 140), _pair(rng, 200, 1500)]    # 1024, 4096
    dev = [_pair(rng, 150, 5), _pair(rng, 400, -30),        # bucket 256
           _pair(rng, 700, 128), _pair(rng, 1200, 10)]      # Lp 2048
    return small, wide, dev


def _band_bucket(p, t, pad=64):
    return wfa._bucket(abs(len(t) - len(p)) + 2 * pad, wfa.BAND_BUCKETS)


def _cells(pairs):
    return sum(len(p) * len(t) for p, t in pairs)


def test_wide_host_cells_and_band_rows(monkeypatch):
    small, wide, dev = _batch()
    pairs = small + wide + dev
    assert all(_band_bucket(p, t) > 512 for p, t in wide)
    assert all(_band_bucket(p, t) <= 512 and len(p) * len(t) > MIN_CELLS
               for p, t in dev)
    assert all(len(p) * len(t) <= MIN_CELLS for p, t in small)
    given = []
    real = band.banded_dp

    def spy(P, Tband, plen, tlen, dlo, B, Lp, *a, **k):
        given.append((int(B), int(Lp), int(P.shape[0]), int(plen.sum())))
        return real(P, Tband, plen, tlen, dlo, B, Lp, *a, **k)

    monkeypatch.setattr(band, "banded_dp", spy)
    rows0 = band.fwd_rows()
    al = wfa.BatchAligner(device=CPU, device_min_cells=MIN_CELLS)
    got = al.align_many(pairs, left_align=[k % 2 == 0 for k in
                                           range(len(pairs))])
    assert len(got) == len(pairs) and all(r is not None for r in got)

    assert al.cells_host_wide == _cells(wide)
    assert al.cells_host == _cells(small + wide)
    assert al.cells_device == _cells(dev)
    assert al.host_align_ns > 0

    # band_fwd's rows a shape: the plen it was given (the plain version
    # on CPU tensors launches no kernel)
    rows1 = band.fwd_rows()
    grew = {}
    for shape, (launches, rows) in rows1.items():
        l0, r0 = rows0.get(shape, (0, 0))
        assert launches == l0
        if rows > r0:
            grew[shape] = rows - r0
    want = {}
    for b, lp, n, plen in given:
        want[(b, lp, n)] = want.get((b, lp, n), 0) + plen
    assert grew == want and len(given) >= 2

    # aligner_totals carries both counters
    monkeypatch.setattr(wfa, "_ALIGNER_CACHE", {"only": al})
    tot = wfa.aligner_totals()
    for k in ("cells_host_wide", "host_align_ns"):
        assert tot[k] == getattr(al, k)


def test_host_only_aligner_counts_no_wide_cells():
    """A host-only aligner routes nothing: no pair is kept on the host
    by the band rule, and the C aligner's time is counted."""
    small, wide, dev = _batch()
    al = wfa.BatchAligner(use_device=False)
    al.align_many(small + wide + dev)
    assert al.cells_host == _cells(small + wide + dev)
    assert al.cells_host_wide == 0 and al.cells_device == 0
    assert al.host_align_ns > 0


def test_routing_is_unchanged_by_the_counters():
    """The split decides nothing: every pair's answer is the host C
    aligner's exact one, wherever it ran."""
    small, wide, dev = _batch()
    pairs = small + wide + dev
    got = wfa.BatchAligner(device=CPU, device_min_cells=MIN_CELLS
                           ).align_many(pairs, left_align=False)
    host = wfa.BatchAligner(use_device=False).align_many(pairs,
                                                         left_align=False)
    for a, b in zip(got, host):
        assert a.score == b.score
        assert np.array_equal(a.cigar, b.cigar)


@pytest.fixture
def tr_contig(tmp_path):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "hifi_hg002_30x_tr.json")) as fh:
        cfg = json.load(fh)
    return gen.make_contig((str(tmp_path), "tr", "chr1", 4_000_000_037,
                            cfg["reads"], cfg["genome"], 150_000, 1))


def test_range_ships_counters_first_seen_inside_it(tr_contig, monkeypatch):
    """Every range of a device-worker call (its ranges run here, in
    order, through _range_worker) starts with no band shape counted, so
    the launch shapes' counters first appear inside it: they ship from
    0, and the range span carries the routing threshold."""
    monkeypatch.setattr(wfa, "_ALIGNER_CACHE", {})
    monkeypatch.setattr(band, "_fwd_rows", collections.Counter())

    def inline(opt, wins, ranges, n_workers, range_worker_out=None,
               device=None, **k):
        for r, (first, count) in enumerate(ranges):
            wfa._ALIGNER_CACHE.clear()
            band._fwd_rows.clear()
            if range_worker_out is not None:
                range_worker_out[r] = r % n_workers
            yield tpl._range_worker((opt, wins, first, count, device))

    monkeypatch.setattr(procpool, "imap_ranges", inline)
    before = counters.snapshot()
    t_start = time.time_ns()
    opt = CallOpts.hifi(ref_fa_fn=tr_contig["fasta"],
                        in_bam_fns=[tr_contig["bam"]], n_threads=2,
                        host_procs=2, window_size=30_000,
                        procs_use_device=True, use_device=True,
                        device_min_cells=20_000)
    out = io.StringIO()
    tpl.run_call(opt, out, "t", device="cpu")
    assert len([ln for ln in out.getvalue().splitlines()
                if not ln.startswith("#")]) > 50
    after = counters.snapshot()
    d = {k[4:]: v - before.get(k, 0) for k, v in after.items()
         if k.startswith("aln_") and not re.search(r"_w-?\d+$", k)
         and v - before.get(k, 0)}
    assert d["cells_host"] > d["cells_host_wide"] > 0
    assert d["cells_device"] > 0 and d["host_align_ns"] > 0
    shapes = [k for k in d if k.startswith("band_fwd_")
              and k.endswith("_rows")]
    assert shapes and all(d[k] > 0 for k in shapes)
    ranges = [s for s in counters.spans()
              if s.name == "range" and s.t0 >= t_start]
    assert ranges and all(s.attrs["device_min_cells"] == 20_000
                          for s in ranges)
