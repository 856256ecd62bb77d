"""The reference-CLI surface of the port (longcalld_torch.cli.main), the
counterpart of tests/test_cli_surface.py on a seeded contig: positional
regions, -L list input, -X extra BAMs, -O z BGZF output, and the JAX
package's CLI on the same arguments.

Tolerance: byte-equal VCF bodies.  The workload is a 120 kb diploid
contig at 20x (tests/torch_helpers.py:build_contig); every call is host
only (``--no-device``), so no CUDA device is needed.
"""

import os
import sys

import pytest

from longcalld_tpu.cli import main as jax_main
from longcalld_tpu.io.bgzf import decompress_all
from longcalld_torch.cli import main as torch_main

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import build_contig, vcf_body  # noqa: E402

REGION = "chr1:20000-80000"


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    return build_contig(tmp_path_factory.mktemp("torch_cli"), 12,
                        120_000)[:2]


def _run(main, argv, capsys):
    assert main(["call", *argv, "--hifi", "--no-device"]) == 0
    return vcf_body(capsys.readouterr().out)


def test_positional_region_equals_r_flag(contig, capsys):
    fa, bam = contig
    pos = _run(torch_main, [fa, bam, REGION], capsys)
    flg = _run(torch_main, [fa, bam, "-r", REGION], capsys)
    assert pos == flg
    assert len(pos) > 10
    whole = _run(torch_main, [fa, bam], capsys)
    assert len(whole) > len(pos)


def test_input_list_and_extra_bam(contig, tmp_path, capsys):
    fa, bam = contig
    lst = tmp_path / "bams.txt"
    lst.write_text(bam + "\n")
    one = _run(torch_main, [fa, bam, REGION], capsys)
    assert _run(torch_main, [fa, "-L", str(lst), REGION], capsys) == one
    # -X doubles the sample depth at every shared SNV site (a noisy-region
    # record's depth comes from its consensus over the region's reads,
    # which the duplicates change; the JAX CLI gives the same records)
    dbl = _run(torch_main, [fa, bam, "-X", bam, REGION], capsys)

    def dp_by_pos(body):
        out = {}
        for line in body:
            f = line.split("\t")
            if len(f[3]) == len(f[4]) == 1:
                fmt = dict(zip(f[8].split(":"), f[9].split(":")))
                out[int(f[1])] = int(fmt["DP"])
        return out
    d1, d2 = dp_by_pos(one), dp_by_pos(dbl)
    shared = sorted(set(d1) & set(d2))
    assert len(shared) >= 10
    assert all(d2[p] == 2 * d1[p] for p in shared)


def test_out_type_z_writes_bgzf(contig, tmp_path, capsys):
    fa, bam = contig
    gz = tmp_path / "out.vcf.gz"
    assert _run(torch_main, [fa, bam, REGION, "-O", "z", "-o", str(gz)],
                capsys) == []
    text = decompress_all(gz.read_bytes()).decode()
    assert text.startswith("##fileformat")
    assert vcf_body(text) == _run(torch_main, [fa, bam, REGION], capsys)


@pytest.mark.parametrize("extra", [[REGION], ["-r", REGION, "-X", "{bam}"]])
def test_body_equals_jax_cli(contig, capsys, extra):
    """The port's CLI and the JAX package's on the same arguments."""
    fa, bam = contig
    argv = [fa, bam] + [a.format(bam=bam) for a in extra]
    assert (_run(torch_main, argv, capsys)
            == _run(jax_main, argv, capsys))
