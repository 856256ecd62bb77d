"""The port owns every module it runs.

(a) No ``import`` of jax or of the JAX package (longcalld_tpu), at module
    level or inside a function, in any .py under longcalld_torch/, in
    chip_smoke.py, in tools/time_band_fwd.py or in tests/torch_helpers.py
    (the test helpers that chip_smoke.py and longcalld_torch/entry.py
    import); one case per file.
(b) Every module and C source that the port copies from the JAX package
    equals its original once ``longcalld_tpu`` reads ``longcalld_torch``
    and the citations of the reference C sources read ``reference/src/...``
    without the checkout's absolute path (``copy_of``); one case per file.  Every file the two packages share by path is
    either such a copy or named below as the port's own.
(c) tests/torch_helpers.py's contig builder writes FASTA, .fai, BAM and BAI
    files byte-identical to tests/synthcontig.py's for one seed, with and
    without ONT-style indel errors.

Tolerance: exact (import nodes, source text, file bytes).
"""

import ast
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "longcalld_torch")
REF = os.path.join(ROOT, "longcalld_tpu")
sys.path.insert(0, os.path.join(ROOT, "tests"))

FOREIGN = ("jax", "jaxlib", "longcalld_tpu")

# copies of the JAX package's host modules, byte-equal but for the name
COPIED = (
    ["config.py"]
    + [f"{p}/__init__.py" for p in ("core", "io", "ops", "parallel", "utils")]
    + [f"core/{m}.py" for m in (
        "align_screen", "alnstr", "chunk", "classify", "consensus", "digar",
        "genotype", "kmer", "msa", "noisy", "phase", "profile", "refine",
        "sites", "somatic", "somatic_call", "te", "windows")]
    + [f"io/{m}.py" for m in (
        "bam", "bam_writer", "bgzf", "cram", "fasta", "remote", "vcf")]
    + ["ops/affine_align.py"]
    + [f"utils/{m}.py" for m in (
        "cbuild", "checkpoint", "counters", "intervals", "log", "mathx",
        "sdust")]
    + [f"native/{m}.c" for m in (
        "affine2p", "profilejoin", "rans4x8", "ransnx16", "sdust")])
# whole modules of the port that merge the JAX package's host code with
# the port's device code: not copies
MERGED = ("cli.py", "core/pipeline.py")
# the port's own forms of the JAX package's device modules
OWN = ("__init__.py", "core/procpool.py", "core/procworker.py",
       "ops/phase_kernel.py", "ops/wfa.py", "parallel/mesh.py",
       "utils/device.py")


def _files(top, exts):
    out = []
    for d, _, names in os.walk(top):
        for name in names:
            if name.endswith(exts):
                out.append(os.path.relpath(os.path.join(d, name), top))
    return sorted(out)


def _port_python():
    return (["longcalld_torch/" + f for f in _files(PORT, (".py",))]
            + ["chip_smoke.py", "tools/time_band_fwd.py",
               "tools/time_band_bwd.py", "tests/torch_helpers.py"])


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, "." * node.level + (node.module or "")


@pytest.mark.parametrize("rel", _port_python())
def test_no_jax_package_import(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    names = list(_imports(tree))
    bad = [(ln, n) for ln, n in names if n.split(".")[0] in FOREIGN]
    assert not bad, f"{rel} imports {bad}"
    # relative imports would hide the package they reach
    assert not [n for _, n in names if n.startswith(".")], rel


def copy_of(ref: str) -> str:
    """The port's copy of a JAX package source: the package renamed, and
    the citations of the reference implementation relative to its
    checkout (``reference/src/align.c:164``)."""
    return (ref.replace("longcalld_tpu", "longcalld_torch")
            .replace("/" + "root/reference/", "reference/"))


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_original(rel):
    with open(os.path.join(PORT, rel)) as f:
        port = f.read()
    with open(os.path.join(REF, rel)) as f:
        ref = f.read()
    assert port == copy_of(ref)


def test_every_shared_file_is_a_copy_or_named():
    exts = (".py", ".c")
    shared = set(_files(PORT, exts)) & set(_files(REF, exts))
    assert shared - set(COPIED) == set(MERGED) | set(OWN)
    assert set(COPIED) <= shared


def test_smoke_guard_names_the_jax_package():
    """chip_smoke.py's per-phase guard fails in a process that holds the
    JAX package (this one does: the test imports it)."""
    import chip_smoke
    import longcalld_tpu.config  # noqa: F401

    with pytest.raises(AssertionError, match="longcalld_tpu"):
        chip_smoke.guard("t")


def _synth_contig(d, seed, length, coverage, read_len, margin, **bam_kw):
    """torch_helpers.build_contig's steps over tests/synthcontig.py."""
    from synthcontig import build_truth, write_synth_bam, write_synth_fasta
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    truth = build_truth(rng, ref4, margin, length - margin, sv_per_mb=25)
    fa = os.path.join(str(d), f"synth{length}.fa")
    bam = os.path.join(str(d), f"synth{length}.bam")
    write_synth_fasta(fa, "chr1", ref4)
    n = write_synth_bam(bam, "chr1", length, ref4, truth, margin,
                        length - margin, coverage=coverage,
                        read_len=read_len, err=0.003, seed=seed + 1,
                        **bam_kw)
    return fa, bam, n, len(truth)


@pytest.mark.parametrize("indel_err", [0.0, 0.01])
def test_contig_builder_matches_synthcontig(tmp_path, indel_err):
    from torch_helpers import build_contig
    kw = dict(coverage=12, read_len=4_000, margin=2_000)
    bam_kw = {"indel_err": indel_err} if indel_err else {}
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = build_contig(tmp_path / "port", 9, 60_000, **kw, **bam_kw)
    want = _synth_contig(tmp_path / "ref", 9, 60_000, **kw, **bam_kw)
    assert got[2:] == want[2:] and got[2] > 50
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        for ext in ("", ".fai" if a.endswith(".fa") else ".bai"):
            with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
                assert fa.read() == fb.read(), os.path.basename(a + ext)
