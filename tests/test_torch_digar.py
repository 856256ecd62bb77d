"""The port's digar pass (longcalld_torch/core/digar.py with
native/digar.c) against the JAX package's digar collectors, read by read.

Each case is a list of raw BAM records.  The port's
``pipeline.collect_digars`` and the JAX package's run over the same
records in the same order, and every read's event table (pos, type,
len, qi, low_qual), sequence, quality, noisy regions, skip and
palindrome flags, the chunk-level noisy regions and the quality
summary must be equal, as must an exception where one is raised.  The
port's read counters say which reads took native/digar.c.

Cases: the SNP / insertion / deletion read of test_digar_sources.py in
=/X and M form (and cs / MD form, the Python path, between native
reads), zero-length and adjacent events, the three low-quality rules, N
in the read and in the reference, the N (ref-skip) op, long soft and
hard clips at both ends and near the contig ends, ONT palindromic SA
reads, each skip rule, a dense-noise read whose regions chain, the 'M'
op in an =/X CIGAR, and a whole window of perfbench/gen.py reads under
each cell's read model.  Last, run_call in process and host-only on a
small HiFi and ONT contig, with the native pass and with the library
unavailable, against the JAX package's VCF.

Tolerance: exact (arrays with their dtypes, VCF text).
"""

import io
import json
import os
import types

import numpy as np
import pytest

from longcalld_torch.config import CallOpts as TOpts
from longcalld_torch.core import digar as tdigar
from longcalld_torch.core import pipeline as tpipe
from longcalld_torch.io.bam import BamRecord as TRecord
from longcalld_tpu.config import CallOpts as JOpts
from longcalld_tpu.core import pipeline as jpipe
from longcalld_tpu.io.bam import BamRecord as JRecord
from perfbench import gen
from tests.util_bam import make_record, z_tag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = "ACGTN"
L = 6000                       # the contig of the hand-made cases
EQ, X, I, D, N, S, H, M = "=", "X", "I", "D", "N", "S", "H", "M"
CODE = {M: 0, I: 1, D: 2, N: 3, S: 4, H: 5, EQ: 7, X: 8}
FIELDS = ("pos", "type", "len", "qi", "low_qual", "seq", "qual")


def _ref(seed=11):
    ref = np.random.default_rng(seed).integers(0, 4, L).astype(np.uint8)
    ref[[700, 701, 1500]] = 4      # N in the reference
    return ref


REF = _ref()


def _simulate(ref, pos0, script, seed=0):
    """(read nt4, =/X CIGAR, M CIGAR) of ``script``: (op, len) with '='
    copying the reference, 'X' a different base, 'n' N bases read where
    the reference has a base, 'I'/'S' random bases, 'D'/'N' skipping
    reference, 'H' nothing.  The =/X CIGAR keeps the script's ops as
    written ('n' as X); the M CIGAR merges each run of =/X ops."""
    rng = np.random.default_rng(seed)
    seq, eqx, mform = [], [], []
    r = pos0
    for op, ln in script:
        if op in (EQ, X, "n"):
            part = ref[r:r + ln].copy()
            if op == X:
                part = np.where(part < 4, (part + 1 + rng.integers(0, 3, ln))
                                % 4, rng.integers(0, 4, ln)).astype(np.uint8)
            elif op == "n":
                part[:] = 4
            seq.append(part)
            r += ln
            eqx.append((CODE[X if op == "n" else op], ln))
            if mform and mform[-1][0] == 0:
                mform[-1] = (0, mform[-1][1] + ln)
            else:
                mform.append((0, ln))
            continue
        if op in (I, S):
            seq.append(rng.integers(0, 4, ln).astype(np.uint8))
        elif op in (D, N):
            r += ln
        eqx.append((CODE[op], ln))
        mform.append((CODE[op], ln))
    s = np.concatenate(seq) if seq else np.zeros(0, np.uint8)
    return s.astype(np.uint8), eqx, mform


def _cs(ref, pos0, eqx, seq):
    """minimap2's short cs tag of an =/X CIGAR."""
    out, r, q = [], pos0, 0
    for op, ln in eqx:
        if op == 7:
            out.append(f":{ln}")
        elif op == 8:
            out += [f"*{NT[ref[r + k]].lower()}{NT[seq[q + k]].lower()}"
                    for k in range(ln)]
        elif op == 1:
            out.append("+" + "".join(NT[b].lower() for b in seq[q:q + ln]))
        elif op == 2:
            out.append("-" + "".join(NT[b].lower() for b in ref[r:r + ln]))
        r += ln if op in (7, 8, 2, 3) else 0
        q += ln if op in (7, 8, 1, 4) else 0
    return "".join(out)


def _md(ref, pos0, eqx):
    """The MD tag of an =/X CIGAR."""
    out, run, r = [], 0, pos0
    for op, ln in eqx:
        if op == 7:
            run += ln
        elif op == 8:
            for k in range(ln):
                out.append(f"{run}{NT[ref[r + k]]}")
                run = 0
        elif op == 2:
            out.append(f"{run}^" + "".join(NT[b] for b in ref[r:r + ln]))
            run = 0
        r += ln if op in (7, 8, 2, 3) else 0
    return "".join(out) + str(run)


def _rec(pos0, cigar, seq, quals=None, flag=0, tags=b"", name="r"):
    q = np.full(len(seq), 40, np.uint8) if quals is None else quals
    return make_record(0, pos0, name, cigar, seq, q, flag=flag, tags=tags)


def _both_forms(pos0, script, quals=None, flag=0, tags=b"", seed=0,
                ref=REF):
    seq, eqx, mform = _simulate(ref, pos0, script, seed)
    return [_rec(pos0, eqx, seq, quals, flag, tags, "eqx"),
            _rec(pos0, mform, seq, quals, flag, tags, "m")]


def _chunk(rec_cls, raws, reg_beg, reg_end, whole, ref4, ref_beg):
    reads = [rec_cls(r) for r in raws]
    n = len(reads)
    return types.SimpleNamespace(
        n_reads=n, reads=reads, order=list(range(n)), reg_beg=reg_beg,
        reg_end=reg_end, whole_ref_len=whole, ref4=ref4, ref_beg=ref_beg,
        is_skipped=np.zeros(n, np.uint8), is_palindrome=np.zeros(n, np.uint8))


def _outcome(collect, opt, chunk):
    try:
        collect(opt, chunk)
    except Exception as e:       # the port must raise what the JAX does
        return type(e).__name__, str(e)
    return None


def _check(raws, ont=False, reg=(1, L), whole=L, ref4=REF, ref_beg=1,
           native=None, order=None, **opts):
    """Both packages' collect_digars on ``raws``; ``native``: how many
    reads must take native/digar.c (default: all); ``opts``: CallOpts
    fields."""
    topt = TOpts.ont(**opts) if ont else TOpts.hifi(**opts)
    jopt = JOpts.ont(**opts) if ont else JOpts.hifi(**opts)
    tc = _chunk(TRecord, raws, *reg, whole, ref4, ref_beg)
    jc = _chunk(JRecord, raws, *reg, whole, ref4, ref_beg)
    if order is not None:
        tc.order = jc.order = list(order)
    before = tdigar.read_counts()
    got = _outcome(tpipe.collect_digars, topt, tc)
    want = _outcome(jpipe.collect_digars, jopt, jc)
    assert got == want
    if got is not None:
        return tc, jc
    after = tdigar.read_counts()
    grew = {k: after[k] - before[k] for k in after}
    assert grew == {"digar_native_reads": len(raws) if native is None
                    else native,
                    "digar_python_reads": 0 if native is None
                    else len(raws) - native}
    assert np.array_equal(tc.is_skipped, jc.is_skipped)
    assert np.array_equal(tc.is_palindrome, jc.is_palindrome)
    for k, (a, b) in enumerate(zip(tc.digars, jc.digars)):
        assert (a is None) == (b is None), k
        if a is None:
            continue
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (k, f)
        assert (a.beg, a.end, a.is_rev, a.qlen) == (b.beg, b.end, b.is_rev,
                                                    b.qlen), k
        assert list(a.noisy_regs) == list(b.noisy_regs), k
        assert np.array_equal(a.seq, tc.reads[k].seq_nt4())
    assert list(tc.noisy_regs) == list(jc.noisy_regs)
    for f in ("min_qual", "first_quar_qual", "median_qual",
              "third_quar_qual", "max_qual"):
        assert getattr(tc, f) == getattr(jc, f), f
    return tc, jc


def _mk_events():
    """test_digar_sources.py's read: SNP at +20, 3 bp INS at +120, 2 bp
    DEL at +180."""
    return [(EQ, 20), (X, 1), (EQ, 99), (I, 3), (EQ, 60), (D, 2), (EQ, 118)]


def _dense():
    """Clusters of 6 mismatches in 30 bp, 40-60 bp apart: regions that
    chain across the 100 bp window, and one apart."""
    s = [(EQ, 200)]
    for gap in (40, 60, 45, 300, 50):
        s += [(X, 1), (EQ, 5)] * 6 + [(EQ, gap)]
    return s + [(EQ, 200)]


CASES = {
    "events": [_both_forms(100, _mk_events())],
    "zero_length_and_adjacent": [
        [_rec(300, [(7, 140), (8, 1), (8, 1), (7, 0), (1, 0), (2, 0),
                    (7, 30), (8, 0), (7, 20), (1, 2), (2, 1), (8, 1),
                    (7, 130)],
              _simulate(REF, 300, [(EQ, 140), (X, 2), (EQ, 50), (I, 2),
                                   (D, 1), (X, 1), (EQ, 130)])[0])],
        _both_forms(400, [(EQ, 150), (X, 3), (I, 1), (X, 1), (D, 1), (X, 1),
                          (EQ, 150)]),
        [_rec(500, [(0, 0), (0, 60), (1, 0), (0, 0), (0, 40)],
              REF[500:600].copy())]],
    "n_bases": [_both_forms(650, [(EQ, 48), ("n", 3), (EQ, 60), (X, 1),
                                  (EQ, 30)]),
                _both_forms(1480, [(EQ, 15), (X, 1), (EQ, 4), (X, 1),
                                   ("n", 2), (EQ, 80)])],
    "ref_skip_op": [_both_forms(2000, [(EQ, 100), (N, 200), (EQ, 100), (X, 1),
                                       (EQ, 50), (N, 0), (EQ, 10)])],
    "clips": [
        _both_forms(2500, [(S, 50), (EQ, 500), (S, 60)]),
        _both_forms(2500, [(H, 40), (EQ, 500), (H, 31)]),
        _both_forms(2500, [(S, 30), (EQ, 500), (S, 29)]),
        # a clip behind another is a right clip (row != 0)
        _both_forms(2600, [(H, 5), (S, 50), (EQ, 600), (S, 50), (H, 5)]),
        # near the contig's ends: no flank where the clip is within 10 bp
        _both_forms(0, [(S, 80), (EQ, 300)]),
        _both_forms(5, [(S, 80), (EQ, 300)]),
        _both_forms(9, [(S, 80), (EQ, 300)]),
        _both_forms(10, [(S, 80), (EQ, 300)]),
        _both_forms(L - 300, [(EQ, 300), (S, 80)]),
        _both_forms(L - 311, [(EQ, 300), (S, 80)]),
        _both_forms(L - 312, [(EQ, 300), (S, 80)])],
    "skip_rules": [
        # 40 mismatches over 600 bp (6.7% > 5%), spread past the window
        _both_forms(3000, [(EQ, 10)] + [(X, 1), (EQ, 14)] * 40),
        # two long clips' flanks (2 x 101 bp) over 180 bp mapped
        _both_forms(3700, [(S, 100), (EQ, 180), (S, 100)]),
        # just under both
        _both_forms(3000, [(EQ, 10)] + [(X, 1), (EQ, 24)] * 40)],
    "dense_chain": [_both_forms(4000, _dense())],
    "m_in_eqx_cigar": [[_rec(100, [(7, 50), (0, 50)], REF[100:200].copy())]],
}


def _low_quals():
    """A read of X, DEL and INS events over bases of quality 2 and 40:
    each low-quality rule, true and false, and a DEL at the read's start
    and at its end.  ``low`` marks the bases of quality 2: for an X its
    base, for a DEL the base before ('p') or the one it points to ('c'),
    for an INS all its bases or all but one ('some')."""
    script = [(D, 2, ""), (EQ, 60, ""), (X, 1, "low"), (EQ, 60, ""),
              (X, 1, ""), (EQ, 60, ""), (D, 1, "p"), (EQ, 60, ""),
              (D, 1, "c"), (EQ, 60, ""), (I, 3, "low"), (EQ, 60, ""),
              (I, 3, "some"), (EQ, 60, ""), (I, 0, ""), (EQ, 60, ""),
              (D, 2, "")]
    seq, eqx, mform = _simulate(REF, 5000, [(op, ln) for op, ln, _ in script],
                                3)
    q = np.full(len(seq), 40, np.uint8)
    qi = 0
    for op, ln, low in script:
        if low == "low":
            q[qi:qi + ln] = 2
        elif low == "some":
            q[qi:qi + ln - 1] = 2
        elif low == "p":
            q[qi - 1] = 2
        elif low == "c":
            q[qi] = 2
        qi += ln if op in (EQ, X, I) else 0
    return [_rec(5000, c, seq, q, name=nm) for nm, c in (("eqx", eqx),
                                                         ("m", mform))]


# per case: each read's noisy regions (None: skipped), both forms alike
REGIONS = {
    "events": [0, 0],
    "zero_length_and_adjacent": [1, 1, 1, 0],
    "n_bases": [0, 0, 0, 0],
    "ref_skip_op": [0, 0],
    "clips": [2, 2, 2, 2, 0, 0, 2, 2, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0,
              1, 1],
    "skip_rules": [None, None, None, None, 0, 0],
    "dense_chain": [2, 2],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_jax(case):
    raws = [r for group in CASES[case] for r in group]
    tc, _ = _check(raws, native=0 if case == "m_in_eqx_cigar" else None)
    if case in REGIONS:
        assert [None if d is None else len(d.noisy_regs)
                for d in tc.digars] == REGIONS[case]


def _requal(raw):
    """The record with its base qualities of 40 raised to 250."""
    rec = TRecord(raw)
    q = np.frombuffer(raw, np.uint8, rec.l_seq, rec._qual_off).copy()
    q[q == 40] = 250
    return raw[:rec._qual_off] + q.tobytes() + raw[rec._tag_off:]


@pytest.mark.parametrize("min_bq", [10, 200])
def test_low_quality_rules(min_bq):
    """At min_bq 200 (qualities 250 and 2) a DEL at the read's start
    must not read the byte before the qualities, nor one at its end the
    byte after them."""
    raws = _low_quals()
    if min_bq > 10:
        raws = [_requal(r) for r in raws]
    tc, _ = _check(raws, min_bq=min_bq)
    d = tc.digars[0]
    assert d.low_qual[d.var_mask()].tolist() == [False, True, False, True,
                                                 True, True, False, True,
                                                 False]


def test_reads_in_another_order():
    raws = [r for g in CASES["clips"] + CASES["dense_chain"] for r in g]
    order = np.random.default_rng(4).permutation(len(raws))
    _check(raws, order=order)


@pytest.mark.parametrize("reg", [(2200, 2800), (4100, 4300), (1, 100),
                                 (1, 2500), (2601, 4200), (4486, 4789)])
def test_region_filter(reg):
    raws = [r for g in CASES["clips"] + CASES["dense_chain"] for r in g]
    tc, _ = _check(raws, reg=reg)
    assert sum(len(d.noisy_regs) for d in tc.digars if d is not None) \
        > len(tc.noisy_regs)


def test_cs_and_md_reads_take_the_python_path_in_between():
    """cs- and MD-tagged reads (with dense noise: they bring regions) go
    to the Python path between native reads; the window's regions keep
    read order."""
    raws = []
    for pos0, script in ((100, _mk_events()), (4000, _dense())):
        seq, eqx, mform = _simulate(REF, pos0, script)
        raws += [_rec(pos0, eqx, seq),
                 _rec(pos0, mform, seq, tags=z_tag("cs", _cs(REF, pos0, eqx,
                                                               seq))),
                 _rec(pos0, mform, seq),
                 _rec(pos0, mform, seq, tags=z_tag("MD", _md(REF, pos0,
                                                             eqx)))]
    tc, _ = _check(raws, native=4)
    # the tagged forms agree with the native forms
    for a, b in ((0, 1), (2, 3), (4, 5), (6, 7)):
        for f in FIELDS:
            assert np.array_equal(getattr(tc.digars[a], f),
                                  getattr(tc.digars[b], f))


def _pal_reads():
    """ONT reads of an inverted duplicate: a primary of 1000 bp and a
    200 bp soft clip that is its reverse complement, on either strand,
    with an SA entry over 97% (palindrome) or 40% (not) of the span, in
    =/X and M form."""
    pos0, aln, clip = 500, 1000, 200
    seq = np.concatenate([REF[pos0:pos0 + aln],
                          3 - REF[pos0 + aln - clip:pos0 + aln][::-1]])
    seq = np.where(seq > 3, 0, seq).astype(np.uint8)
    out = []
    for sa in ("chrT,531,-,970M200S,60,0;", "chrT,1101,-,400M200S,60,0;",
               "chrT,1,+,10M,60,0;chrT,521,+,990M200S,60,0;"):
        for flag in (0, 16):
            for cig in ([(7, aln), (4, clip)], [(0, aln), (4, clip)],
                        [(4, clip), (0, aln)]):
                s = seq if cig[0][0] != 4 else np.concatenate(
                    [seq[aln:], seq[:aln]])
                out.append(_rec(pos0, cig, s, flag=flag,
                                tags=z_tag("SA", sa)))
    return out


@pytest.mark.parametrize("ont", [True, False])
def test_palindromic_sa_reads(ont):
    tc, _ = _check(_pal_reads(), ont=ont)
    assert bool(tc.is_palindrome.any()) == ont


def _window(kind, tmp_path):
    cfg = json.load(open(os.path.join(
        ROOT, "perfbench", "configs",
        "hifi_hg002_30x.json" if kind == "hifi"
        else "ont_r10_hg002_30x.json")))
    return gen.make_contig((str(tmp_path), kind, "chr1", 4_000_000_021,
                            cfg["reads"], cfg["genome"], 90_000, 1))


@pytest.mark.parametrize("kind", ["hifi", "ont"])
def test_whole_window_of_the_cells_read_models(kind, tmp_path):
    from longcalld_torch.core.windows import Window as TWin
    from longcalld_torch.io.bam import BamReader as TBam
    from longcalld_torch.io.fasta import FastaFile as TFasta
    from longcalld_tpu.core.windows import Window as JWin
    from longcalld_tpu.io.bam import BamReader as JBam
    from longcalld_tpu.io.fasta import FastaFile as JFasta
    c = _window(kind, tmp_path)
    ont = kind == "ont"
    tc = tpipe.load_chunk(TOpts.ont() if ont else TOpts.hifi(),
                          TFasta(c["fasta"]), [TBam(c["bam"])],
                          TWin(0, "chr1", 30_001, 60_000, 0, 0), None, None)
    jc = jpipe.load_chunk(JOpts.ont() if ont else JOpts.hifi(),
                          JFasta(c["fasta"]), [JBam(c["bam"])],
                          JWin(0, "chr1", 30_001, 60_000, 0, 0), None, None)
    raws = [tc.reads[k]._raw for k in tc.order]
    assert raws == [jc.reads[k]._raw for k in jc.order]
    t, _ = _check(raws, ont=ont, reg=(tc.reg_beg, tc.reg_end),
                  whole=tc.whole_ref_len, ref4=tc.ref4, ref_beg=tc.ref_beg)
    assert len(raws) > 50 and len(t.noisy_regs) > 0


@pytest.mark.parametrize("kind", ["hifi", "ont"])
def test_run_call_native_and_python_match_jax(kind, tmp_path, monkeypatch):
    """run_call in process and host-only: the VCF with the native pass,
    and with the library made unavailable, equals the JAX package's."""
    c = _window(kind, tmp_path)
    kw = dict(ref_fa_fn=c["fasta"], in_bam_fns=[c["bam"]], host_procs=0,
              n_threads=2, window_size=30_000, use_device=False)
    pick = "ont" if kind == "ont" else "hifi"
    want = io.StringIO()
    jpipe.run_call(getattr(JOpts, pick)(**kw), want, "t")
    got = {}
    for native in (True, False):
        if not native:
            monkeypatch.setattr(tdigar, "load_digar_native", lambda: False)
        before = tdigar.read_counts()
        buf = io.StringIO()
        tpipe.run_call(getattr(TOpts, pick)(**kw), buf, "t")
        got[native] = buf.getvalue()
        after = tdigar.read_counts()
        grew = {k: after[k] - before[k] for k in after}
        assert grew["digar_native_reads" if native
                    else "digar_python_reads"] > 0, grew
        assert grew["digar_python_reads" if native
                    else "digar_native_reads"] == 0, grew
    body = [ln for ln in want.getvalue().splitlines()
            if not ln.startswith("#")]
    assert len(body) > 10
    for text in got.values():
        assert text == want.getvalue()
