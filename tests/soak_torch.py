"""Fuzz soak of the PyTorch port: device == host over five scene families.

    python3 tests/soak_torch.py --seeds 100 --out SOAK_torch_r08.json
    python3 tests/soak_torch.py --seeds 5 --device cpu      # plain versions

The port of tests/soak.py over longcalld_torch: the same families, drawn
round-robin over the seed budget from the same random numbers in the same
order (given the same base and seed it writes the same reads), with the
same outcomes, pass rules and known-miss confirmations:
  pipeline  planted diploid genomes -> device==host VCF equality + planted
            SNV/indel truth recovery
  ont       ONT preset, 3% error reads -> device==host + SNV recovery
  stitch    multi-window vs single-window call invariance + per-phase-set
            orientation consistency
  somatic   -s mode: device==host, germline slice unchanged, planted
            mosaic SNV recovered when its carriers actually cover it
  f1        truth-set F1 over a 1 Mb synthetic diploid slice, host only
            (as in tests/soak.py: this family runs no kernel there either)

Outcome per seed: pass | ineligible(<why>) | known_miss(<mode>) | FAIL.
The two reference-faithful miss modes (indel_dp_refilter, confirmed by a
host-only re-run with min_dp=2; hom_one_hap_uncovered, read from the
record) are tests/soak.py's.  Zero FAILs is the contract (exit 1
otherwise).

Routing is forced: every call that tests/soak.py makes with
use_device=True runs here on ``--device`` with device_min_cells=1, so each
pair of a scene goes through the band kernels (a calibrated threshold
would keep every pair of a 9 kb scene on the host).  Every use_device=False
call stays host-only.  ``--device`` defaults to cuda:0 and raises without
CUDA; ``--device cpu`` runs the kernels' plain versions (the tests).

An error of the kernel wrappers (ops/band.py, utils/kbuild.py) or any CUDA
error is not counted as a FAIL: it ends the run with its traceback, since
the CUDA context cannot be trusted after it.  Other exceptions of a scene
count as FAIL, as in tests/soak.py.

The base: ``--ref-fa`` names a FASTA with a chr11 of at least 1.36 Mb
(tests/soak.py reads chr11_2M.fa); without it a seeded random 2 Mb chr11
(``--ref-seed``) is written once per run.  Random sequence has no repeats
and little low-complexity sequence, so its scenes are easier than chr11's.

The summary JSON holds tests/soak.py's seeds, counts, non_pass and wall_s,
and per family: counts, wall, band_fwd/band_bwd launches and their
(B, Lp, batch) shapes, the phasing EM's CUDA runs, the DP cells on the
device and on the host, and the device's share of the device calls' DP
cells (pairs whose band bucket is above 512 stay on the host); beside
them the card line (nvidia-smi name and power limit), torch and CUDA
versions and the base.  The run fails
(exit 1) when a device family (pipeline, ont, stitch, somatic) aligned DP
cells but sent none to the device (on CUDA: launched no band_fwd or no
band_bwd), when, on CUDA, one ran no phasing EM on the card, or when the
device families sent no DP cell to the device at all (audit_failures).
The somatic scene gives the aligner no pair (SNVs only, substitution
errors only), so it owes the EM alone.

Imports torch, numpy, longcalld_torch and tests/torch_helpers.py; never
jax or the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (_HERE, os.path.dirname(_HERE)):     # torch_helpers, the package
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from longcalld_torch.config import CallOpts  # noqa: E402
from longcalld_torch.core.pipeline import run_call  # noqa: E402
from longcalld_torch.io.fasta import FastaFile  # noqa: E402
from longcalld_torch.ops import band, phase_kernel, wfa  # noqa: E402
from torch_helpers import make_record, sim_read, write_bam  # noqa: E402

REF_BEG = 1_350_000
REF_LEN = 9_000
READ_LEN = 5_200
BASE_LEN = 2_000_000           # the seeded base, chr11_2M.fa's length
DEVICE_FAMILIES = ("pipeline", "ont", "stitch", "somatic")


class Base(NamedTuple):
    """The base sequence: FASTA path, chr11 as nt4 codes, its length and
    where it came from."""
    fa: str
    ref4: np.ndarray
    fa_len: int
    source: str


def load_base(fa: str, source: str) -> Base:
    fasta = FastaFile(fa)
    fa_len = fasta.seq_len("chr11")
    if fa_len < REF_BEG + REF_LEN:
        raise ValueError(f"{fa}: chr11 has {fa_len} bases, the scenes need "
                         f"{REF_BEG + REF_LEN}")
    return Base(fa, fasta.fetch_nt4("chr11", 0, fa_len - 1), fa_len, source)


def seeded_base(d: str, ref_seed: int = 2026) -> Base:
    """A random 2 Mb chr11 drawn from ``ref_seed``, written to ``d``."""
    from torch_helpers import write_synth_fasta
    ref4 = np.random.default_rng(ref_seed).integers(
        0, 4, BASE_LEN).astype(np.uint8)
    fa = os.path.join(d, "soak_base.fa")
    write_synth_fasta(fa, "chr11", ref4)
    return load_base(fa, f"seeded random chr11 of {BASE_LEN} bp "
                         f"(--ref-seed {ref_seed})")


def _body(vcf: str):
    return [l for l in vcf.splitlines() if l and not l.startswith("#")]


def _call(opt, device) -> str:
    out = io.StringIO()
    run_call(opt, out, "soak", device=device if opt.use_device else None)
    return out.getvalue()


def _opts(ctor, use_device, **kw):
    """CallOpts with forced routing on the device calls."""
    if use_device:
        kw["device_min_cells"] = 1
    return ctor(use_device=use_device, **kw)


def _plant(rng, ref4, indels=True):
    out = []
    pos = REF_BEG + 600
    while pos < REF_BEG + REF_LEN - 800:
        kind = rng.choice(["snv", "snv", "snv", "ins", "del"]
                          if indels else ["snv"])
        gt = rng.choice(["het1", "het2", "hom"])
        if kind == "snv":
            payload = (int(ref4[pos]) + 1 + int(rng.integers(3))) % 4
        elif kind == "ins":
            payload = rng.integers(0, 4, int(rng.integers(2, 9))).tolist()
        else:
            payload = int(rng.integers(2, 9))
        out.append((pos, kind, payload, gt))
        pos += int(rng.integers(400, 900))
    return out


def _make_bam(tmp, rng, ref4, fa_len, variants, n_reads, err, qual,
              preset_tag):
    bypos = {p: (k, pl, gt) for p, k, pl, gt in variants}
    recs, starts_by_hap = [], {1: [], 2: []}
    for k in range(n_reads):
        hap = 1 + (k % 2)
        start = REF_BEG + int(rng.integers(0, REF_LEN - READ_LEN))
        starts_by_hap[hap].append(start)
        seq4, cigar = sim_read(rng, ref4, start, READ_LEN, hap, bypos,
                               err=err)
        recs.append((start, make_record(
            0, start, f"{preset_tag}{k:03d}", cigar, seq4,
            np.full(len(seq4), qual, dtype=np.uint8), mapq=60,
            flag=16 if k % 4 >= 2 else 0)))
    recs.sort(key=lambda r: r[0])
    bam = os.path.join(tmp, "soak.bam")
    write_bam(bam, ["chr11"], [fa_len], [r[1] for r in recs])
    return bam, recs, starts_by_hap


def _coverage_gates(recs, starts_by_hap, pos, gt, min_cov=5, min_hap=4,
                    min_frac=0.25):
    cov = sum(1 for s, _ in recs if s <= pos < s + READ_LEN - 60)
    per = {h: sum(1 for s in starts_by_hap[h]
                  if s <= pos < s + READ_LEN - 60) for h in (1, 2)}
    hap_cov = (per[1] + per[2] if gt == "hom"
               else per[1] if gt == "het1" else per[2])
    ok = cov >= min_cov and hap_cov >= min_hap and hap_cov >= min_frac * cov
    # a hom GT is only owed when BOTH haps cover: the emitter defaults an
    # uncovered hap's consensus allele to REF (collect_var.c:1499-1500)
    if gt == "hom" and min(per[1], per[2]) < 2:
        ok = False
    return ok, cov, hap_cov


# ---------------- families ----------------

def family_pipeline(seed: int, base: Base, tmp: str, device,
                    preset="hifi"):
    rng = np.random.default_rng(seed)
    ref4 = base.ref4
    ont = preset == "ont"
    variants = _plant(rng, ref4, indels=not ont)
    err, qual, n_reads = ((0.03, 20, 30) if ont else (0.002, 35, 22))
    bam, recs, sbh = _make_bam(tmp, rng, ref4, base.fa_len, variants,
                               n_reads, err, qual, preset[0])
    region = f"chr11:{REF_BEG + 1}-{REF_BEG + REF_LEN}"
    ctor = CallOpts.ont if ont else CallOpts.hifi

    def call(use_device, **kw):
        return _call(_opts(ctor, use_device, ref_fa_fn=base.fa,
                           in_bam_fns=[bam], regions=[region], **kw), device)

    dev = _body(call(True))
    if dev != _body(call(False)):
        return "FAIL", "device VCF differs from host oracle"
    called = {}
    for line in dev:
        f = line.split("\t")
        fmt = dict(zip(f[8].split(":"), f[9].split(":")))
        called[int(f[1])] = (f[3], f[4], fmt.get("GT", ""),
                            fmt.get("AD", ""))
    min_cov, min_hap, min_frac = (8, 6, 0.3) if ont else (5, 4, 0.25)
    known = []
    for pos, kind, payload, gt in variants:
        ok, cov, hap_cov = _coverage_gates(recs, sbh, pos, gt, min_cov,
                                           min_hap, min_frac)
        if not ok:
            continue
        vpos = pos + 1
        if kind == "snv":
            if vpos not in called:
                return "FAIL", f"planted SNV at {vpos} missed " \
                               f"(cov={cov}, hap_cov={hap_cov})"
            if called[vpos][1] != "ACGT"[payload]:
                return "FAIL", f"SNV at {vpos}: wrong ALT {called[vpos][1]}"
            al = sorted(called[vpos][2].replace("|", "/").split("/"))
            want = ["1", "1"] if gt == "hom" else ["0", "1"]
            if al != want:
                # hom_one_hap_uncovered: a true hom whose covering reads all
                # land in one haplotype is emitted as a phased het (the
                # reference defaults an evidence-free hap to REF,
                # collect_var.c:1497-1499); confirmed from the record:
                # phased 0/1 with zero ref-supporting reads
                ad = called[vpos][3].split(",")
                if (gt == "hom" and al == ["0", "1"]
                        and "|" in called[vpos][2]
                        and len(ad) == 2 and ad[0] == "0"):
                    known.append(f"hom_one_hap_uncovered@{vpos}")
                    continue
                return "FAIL", f"SNV at {vpos}: GT {called[vpos][2]} != {gt}"
        else:
            near = [p for p in called if abs(p - vpos) <= 30
                    and len(called[p][0]) != len(called[p][1])]
            if near:
                continue
            # candidate known miss: confirm the documented DP-refilter
            # mode by relaxing min_dp -- the record must reappear
            relaxed = _body(call(False, min_dp=2))
            re_called = {int(l.split("\t")[1]) for l in relaxed
                         if len(l.split("\t")[3]) != len(l.split("\t")[4])}
            if any(abs(p - vpos) <= 30 for p in re_called):
                known.append(f"indel_dp_refilter@{vpos}")
                continue
            return "FAIL", f"planted {kind} at {vpos} missed " \
                           f"(cov={cov}, hap_cov={hap_cov}; not the " \
                           "documented dp-refilter mode)"
    if known:
        return "known_miss", ";".join(known)
    return "pass", ""


def family_stitch(seed: int, base: Base, tmp: str, device):
    WIN = 2_000
    rng = np.random.default_rng(seed)
    variants = _plant(rng, base.ref4)
    bam, recs, sbh = _make_bam(tmp, rng, base.ref4, base.fa_len, variants,
                               22, 0.002, 35, "s")
    region = f"chr11:{REF_BEG + 1}-{REF_BEG + REF_LEN}"

    def call(use_device, window_size):
        return _call(_opts(CallOpts.hifi, use_device, ref_fa_fn=base.fa,
                           in_bam_fns=[bam], regions=[region],
                           window_size=window_size), device)

    multi_dev = call(True, WIN)
    if _body(multi_dev) != _body(call(False, WIN)):
        return "FAIL", "multi-window device VCF differs from host oracle"

    def rec_map(vcf):
        out = {}
        for l in _body(vcf):
            f = l.split("\t")
            out[(int(f[1]), f[3], f[4])] = dict(zip(f[8].split(":"),
                                                    f[9].split(":")))
        return out

    multi = rec_map(multi_dev)
    single = rec_map(call(True, REF_LEN + 10_000))

    # a call whose WIN-window holds < 2 other planted clean het SNVs is
    # phase-starved there (the window's EM leaves every read hap=0), so
    # windowing invariance is only owed where each window can phase alone
    het_snvs = [p + 1 for p, k, _pl, gt in variants
                if k == "snv" and gt != "hom"]

    def starved(pos1):
        w0 = REF_BEG + 1 + ((pos1 - (REF_BEG + 1)) // WIN) * WIN
        return sum(1 for p in het_snvs
                   if w0 <= p < w0 + WIN and p != pos1) < 2

    def norm(m):
        return {k: "".join(sorted(v["GT"].replace("|", "/")))
                for k, v in m.items() if not starved(k[0])}
    if norm(multi) != norm(single):
        d = set(norm(multi).items()) ^ set(norm(single).items())
        return "FAIL", f"windowing changed calls: {sorted(d)[:4]}"
    bypos = {p: gt for p, _, _, gt in variants}
    by_ps = {}
    for (pos, _r, _a), fmt in multi.items():
        gt_true = bypos.get(pos - 1)
        if gt_true in ("het1", "het2") and "PS" in fmt \
                and fmt["GT"] in ("0|1", "1|0"):
            orient = (fmt["GT"] == "1|0") == (gt_true == "het1")
            by_ps.setdefault(fmt["PS"], set()).add(orient)
    for ps, orients in by_ps.items():
        if len(orients) != 1:
            return "FAIL", f"phase-set {ps} flips orientation"
    if not by_ps:
        return "ineligible", "no planted het was phased in-window"
    return "pass", ""


def _hp_context(ref4, pos, w=8):
    """Any 3-run of one base within +-w of pos: the somatic hp-error
    filter (assign_hap.c:1012-1084) kills SNVs there by design, so the
    somatic scene must not plant on such sites."""
    s = ref4[pos - w:pos + w + 1]
    return any(s[i] == s[i + 1] == s[i + 2] for i in range(len(s) - 2))


_LOW_COMP = {}                 # scene bases -> their sdust intervals


def low_comp_intervals(ref4, flank=5):
    """The sdust low-complexity intervals of the scene region of ``ref4``,
    widened by ``flank``; cached per base sequence."""
    seq = np.ascontiguousarray(ref4[REF_BEG:REF_BEG + REF_LEN])
    key = seq.tobytes()
    if key not in _LOW_COMP:
        from longcalld_torch import config
        from longcalld_torch.utils.sdust import sdust_native
        ivs = sdust_native(seq, config.SDUST_T, config.SDUST_W)
        _LOW_COMP[key] = [(REF_BEG + int(s) - flank, REF_BEG + int(e) + flank)
                          for s, e in ivs]
    return _LOW_COMP[key]


def _low_comp_context(ref4, pos):
    """SNVs sitting on an sdust low-complexity interval are killed by the
    phased-snv gate whenever any alt read has a sequencing error inside
    the interval (assign_hap.c:1426) -- reference-faithful, so the scene
    must not plant there.  The flank covers the widened hp-error window."""
    return any(s <= pos < e for s, e in low_comp_intervals(ref4))


def family_somatic(seed: int, base: Base, tmp: str, device):
    rng = np.random.default_rng(seed)
    ref4 = base.ref4
    som_pos = REF_BEG + 2_000 + int(rng.integers(0, REF_LEN - 4_000))
    while _hp_context(ref4, som_pos) or _low_comp_context(ref4, som_pos):
        som_pos = REF_BEG + 2_000 + int(rng.integers(0, REF_LEN - 4_000))
    germline = {}
    pos = REF_BEG + 500
    k = 0
    while pos < REF_BEG + REF_LEN - 600:
        if abs(pos - som_pos) > 60:
            alt = (int(ref4[pos]) + 1 + int(rng.integers(3))) % 4
            germline[pos] = ("snv", alt, "het1" if k % 2 == 0 else "het2")
            k += 1
        pos += int(rng.integers(300, 600))
    som_alt = (int(ref4[som_pos]) + 1) % 4
    n_reads = 30
    carriers = set(rng.choice(np.arange(0, n_reads, 2), size=4,
                              replace=False).tolist())
    recs, sbh = [], {1: [], 2: []}
    carrier_cov = 0
    # a carrier read must actually cover the somatic site (that is what
    # makes it a carrier); non-carriers sample the window uniformly
    c_lo = max(0, som_pos - REF_BEG - (READ_LEN - 100))
    c_hi = min(REF_LEN - READ_LEN, som_pos - REF_BEG - 100)
    for k in range(n_reads):
        hap = 1 + (k % 2)
        if k in carriers:
            start = REF_BEG + int(rng.integers(c_lo, c_hi + 1))
        else:
            start = REF_BEG + int(rng.integers(0, REF_LEN - READ_LEN))
        sbh[hap].append(start)
        v = dict(germline)
        if k in carriers:
            v[som_pos] = ("snv", som_alt, "hom")
            if start <= som_pos < start + READ_LEN - 60:
                carrier_cov += 1
        seq4, cigar = sim_read(rng, ref4, start, READ_LEN, hap, v,
                               err=0.0015)
        recs.append((start, make_record(
            0, start, f"sm{k:03d}", cigar, seq4,
            np.full(len(seq4), 35, dtype=np.uint8), mapq=60,
            flag=16 if k % 4 >= 2 else 0)))
    recs.sort(key=lambda r: r[0])
    bam = os.path.join(tmp, "som.bam")
    write_bam(bam, ["chr11"], [base.fa_len], [r[1] for r in recs])
    region = f"chr11:{REF_BEG + 1}-{REF_BEG + REF_LEN}"

    def call(use_device, somatic):
        return _call(_opts(CallOpts.hifi, use_device, ref_fa_fn=base.fa,
                           in_bam_fns=[bam], regions=[region],
                           out_somatic=somatic), device)

    som_dev = _body(call(True, True))
    if som_dev != _body(call(False, True)):
        return "FAIL", "-s device VCF differs from host oracle"
    plain = _body(call(True, False))
    germ_like = [l for l in som_dev if "SOMATIC" not in l.split("\t")[7]]
    if germ_like != plain:
        return "FAIL", "-s changed the germline slice"
    # recovery is only owed when the scene gives the somatic filters what
    # they need: >=3 covering carriers on a phased hap with depth>=5 and
    # alt<=ref (select_somatic_phase_set_alt_hap gates)
    hap1_cov = sum(1 for s in sbh[1] if s <= som_pos < s + READ_LEN - 60)
    if carrier_cov < 4 or hap1_cov < 8 or carrier_cov > hap1_cov / 2:
        return "ineligible", (f"carrier_cov={carrier_cov}, "
                              f"hap1_cov={hap1_cov}")
    som_ps = {int(l.split("\t")[1]) for l in som_dev
              if "SOMATIC" in l.split("\t")[7]}
    if som_pos + 1 not in som_ps:
        return "FAIL", f"planted mosaic SNV at {som_pos + 1} not somatic " \
                       f"(carrier_cov={carrier_cov}, hap1_cov={hap1_cov})"
    return "pass", ""


def family_f1(seed: int, base: Base, tmp: str, device):
    """Truth-set F1 over a 1 Mb synthetic diploid contig slice (planted
    SNV/indel/SV at human-ish densities, ~20x HiFi-like reads, full
    pipeline, left-normalized scoring), host only as in tests/soak.py.
    Pass: F1 >= (0.94 snv, 0.90 indel) and precision >= 0.97; only gross
    SV failure (recall 0 with >= 3 planted) fails."""
    from torch_helpers import (build_truth, evaluate_f1, write_synth_bam,
                               write_synth_fasta)
    rng = np.random.default_rng(seed)
    ref4 = base.ref4
    ref1m = np.where(ref4[:1_000_000] > 3, 0,
                     ref4[:1_000_000]).astype(np.uint8)
    beg, end = 10_000, len(ref1m) - 10_000
    truth = build_truth(rng, ref1m, beg, end)
    if len(truth) < 500:
        return "ineligible", f"only {len(truth)} planted"
    fa_fn = os.path.join(tmp, "synth.fa")
    bam_fn = os.path.join(tmp, "synth.bam")
    write_synth_fasta(fa_fn, "chr21", ref1m)
    write_synth_bam(bam_fn, "chr21", len(ref1m), ref1m, truth, beg, end,
                    coverage=20, read_len=12_000, err=0.003, seed=seed + 1)
    out = _call(CallOpts.hifi(ref_fa_fn=fa_fn, in_bam_fns=[bam_fn],
                              use_device=False, n_threads=2), None)
    res = evaluate_f1(_body(out), truth, beg, end, ref1m)
    if res["snv"]["f1"] < 0.94 or res["snv"]["precision"] < 0.97:
        return "FAIL", f"snv {res['snv']}"
    if res["indel"]["f1"] < 0.90 or res["indel"]["precision"] < 0.97:
        return "FAIL", f"indel {res['indel']}"
    sv = res["sv"]
    if sv["tp"] + sv["fn"] >= 3 and sv["recall"] == 0.0:
        return "FAIL", f"sv {sv}"
    return "pass", ""


FAMILIES = {
    "pipeline": lambda seed, base, tmp, dev: family_pipeline(
        seed, base, tmp, dev, "hifi"),
    "ont": lambda seed, base, tmp, dev: family_pipeline(
        seed, base, tmp, dev, "ont"),
    "stitch": family_stitch,
    "somatic": family_somatic,
    "f1": family_f1,
}


# ---------------- the run ----------------

_KERNEL_FILES = (os.path.join("ops", "band.py"),
                 os.path.join("ops", "phase_kernel.py"),
                 os.path.join("utils", "kbuild.py"))
_CUDA_WORDS = re.compile(r"\bCUDA\b|cudaError|CUBLAS|cuDNN")


def kernel_fault(exc: BaseException) -> bool:
    """Whether ``exc`` (or an exception it chains) came from the kernel
    wrappers or from CUDA: a traceback through ops/band.py or
    utils/kbuild.py, a CUDA error type, or a CUDA error message."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if (isinstance(exc, torch.cuda.OutOfMemoryError)
                or type(exc).__name__ == "AcceleratorError"
                or _CUDA_WORDS.search(str(exc))):
            return True
        tb = exc.__traceback__
        while tb is not None:
            if tb.tb_frame.f_code.co_filename.endswith(_KERNEL_FILES):
                return True
            tb = tb.tb_next
        exc = exc.__cause__ or exc.__context__
    return False


def _audit() -> dict:
    """The process's kernel launches, their shapes, the EM's CUDA runs and
    the aligners' DP cells, as they stand: on the device, on the host, and
    on the host in device calls (pairs whose band bucket is above 512)."""
    tot = wfa.aligner_totals()
    return {"launches": band.launch_counts(),
            "launch_shapes": band.launch_shapes(),
            "phase_cuda_calls": phase_kernel.cuda_calls(),
            "phase_em_launches": phase_kernel.em_launch_counts()["phase_em"],
            "cells_device": tot["cells_device"],
            "cells_host": tot["cells_host"],
            "cells_host_device_calls": sum(
                al.cells_host for al in wfa._ALIGNER_CACHE.values()
                if al.use_device)}


def _add_audit(acc: dict, before: dict, after: dict) -> None:
    for k in ("phase_cuda_calls", "phase_em_launches", "cells_device",
              "cells_host", "cells_host_device_calls"):
        acc[k] += after[k] - before[k]
    for name, n in after["launches"].items():
        acc["launches"][name] += n - before["launches"][name]
        shapes = acc["launch_shapes"][name]
        for shape, m in after["launch_shapes"][name].items():
            d = m - before["launch_shapes"][name].get(shape, 0)
            if d:
                shapes[shape] += d


def _family_record() -> dict:
    return {"seeds": 0,
            "counts": {"pass": 0, "ineligible": 0, "known_miss": 0,
                       "FAIL": 0},
            "wall_s": 0.0,
            "launches": {name: 0 for name in band.launch_counts()},
            "launch_shapes": {name: collections.Counter()
                              for name in band.launch_counts()},
            "phase_cuda_calls": 0, "phase_em_launches": 0,
            "cells_device": 0, "cells_host": 0,
            "cells_host_device_calls": 0}


def audit_failures(families: dict, device: torch.device) -> list:
    """What the device families' seeds, taken together, failed to run on
    the device: in a family that aligned any DP cell, a device DP cell
    and, on CUDA, a band_fwd and a band_bwd launch; on CUDA, a launch of
    the EM kernel in every device family, and no CUDA EM run without it;
    and device DP cells over all of them.
    A family whose scenes give the aligner no pair at all (the somatic
    scene plants SNVs only and its reads carry substitutions only) owes
    no launch."""
    bad = []
    for fam in DEVICE_FAMILIES:
        rec = families.get(fam)
        if rec is None or not rec["seeds"]:
            continue
        missing = []
        if rec["cells_device"] + rec["cells_host"] > 0:
            if rec["cells_device"] <= 0:
                missing.append("device DP cells")
            if device.type == "cuda":
                missing += [n for n, k in rec["launches"].items() if k <= 0]
        if device.type == "cuda" and rec["phase_em_launches"] <= 0:
            missing.append("EM kernel launch")
        if missing:
            bad.append(f"{fam}: no {', no '.join(missing)}")
        plain = rec["phase_cuda_calls"] - rec["phase_em_launches"]
        if plain:
            bad.append(f"{fam}: {plain} CUDA EM runs without the EM kernel")
    ran = [families[f] for f in DEVICE_FAMILIES
           if f in families and families[f]["seeds"]]
    if ran and not sum(rec["cells_device"] for rec in ran):
        bad.append("device families: no device DP cells")
    return bad


def card_line() -> str | None:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def soak(n_seeds: int, base: Base, device, base_seed: int = 10_000,
         log=print) -> dict:
    """Run ``n_seeds`` seeds round-robin over FAMILIES on ``device`` (a
    resolved torch.device); returns the summary."""
    names = list(FAMILIES)
    results = []
    counts = {"pass": 0, "ineligible": 0, "known_miss": 0, "FAIL": 0}
    families = {fam: _family_record() for fam in names}
    t0 = time.time()
    for i in range(n_seeds):
        fam = names[i % len(names)]
        seed = base_seed + i
        rec = families[fam]
        before = _audit()
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                outcome, detail = FAMILIES[fam](seed, base, tmp, device)
            except Exception as e:  # noqa: BLE001 - triage, don't die
                if kernel_fault(e):
                    raise
                outcome, detail = "FAIL", f"exception: {e!r}"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["wall_s"] += time.perf_counter() - t1
        _add_audit(rec, before, _audit())
        rec["seeds"] += 1
        rec["counts"][outcome] += 1
        counts[outcome] += 1
        if outcome != "pass":
            results.append({"family": fam, "seed": seed,
                            "outcome": outcome, "detail": detail})
        log(f"[{i + 1}/{n_seeds}] {fam} seed={seed}: {outcome}"
            f"{' - ' + detail if detail else ''}")
    for rec in families.values():
        # the share of the device calls' DP cells that the device aligned
        cells = rec["cells_device"] + rec["cells_host_device_calls"]
        rec["device_share_of_dp_cells"] = (rec["cells_device"] / cells
                                           if cells else None)
        rec["launch_shapes"] = {name: dict(sorted(c.items()))
                                for name, c in rec["launch_shapes"].items()}
    return {"seeds": n_seeds, "counts": counts, "non_pass": results,
            "wall_s": round(time.time() - t0, 1),
            "families": families,
            "audit_failures": audit_failures(families, device),
            "device": str(device),
            "card": card_line() if device.type == "cuda" else None,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "base": {"source": base.source, "fasta": os.path.basename(base.fa),
                     "contig": "chr11", "length": base.fa_len},
            "device_min_cells": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--base-seed", type=int, default=10_000)
    ap.add_argument("--device", default=None,
                    help="torch device of the kernels (default cuda:0)")
    ap.add_argument("--ref-fa", default=None,
                    help="FASTA with a chr11 of >= 1.36 Mb (default: a "
                         "seeded random 2 Mb chr11)")
    ap.add_argument("--ref-seed", type=int, default=2026)
    args = ap.parse_args(argv)

    from longcalld_torch.utils.device import resolve_device
    device = resolve_device(args.device)          # raises without CUDA
    log = lambda s: print(s, flush=True)          # noqa: E731
    with tempfile.TemporaryDirectory() as d:
        base = (load_base(args.ref_fa, args.ref_fa) if args.ref_fa
                else seeded_base(d, args.ref_seed))
        summary = soak(args.seeds, base, device, args.base_seed, log)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    for line in summary["audit_failures"]:
        print(f"audit: {line}", file=sys.stderr)
    return 1 if summary["counts"]["FAIL"] or summary["audit_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
