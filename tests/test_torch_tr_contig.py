"""The port on a contig with tandem repeats: a 1 Mb contig that
perfbench/gen.py makes under the repeat-rich HiFi configuration
(perfbench/configs/hifi_hg002_30x_tr.json, its own ``tandem_repeats``
block), called host-only in process and on the host-only pool at its
smallest size (2 workers, 250 kb windows so that 4 windows engage it),
against the JAX package in process on the same inputs.

Repeats bring what the repeat-free contigs of the other tests do not:
sdust masks and low-complexity extension, repeat and homopolymer
classes, noisy regions toward MAX_NOISY_REG_LEN with POA consensus over
whole-motif alleles, compound heterozygous loci and long alignment
pairs.

Tolerance: the VCF bodies byte-equal.  The loci scored by haplotype
sequence (perfbench/reference.py:score_tr_loci): at most one wrong of
the ~120-150 each seed scores, for a compound heterozygous locus whose
two alleles differ by a copy or two, which both packages call
homozygous."""

import io
import json
import os

import pytest

from longcalld_torch.config import CallOpts as TOpts
from longcalld_torch.core import pipeline as tpl
from longcalld_torch.core import procpool
from longcalld_tpu.config import CallOpts as JOpts
from longcalld_tpu.core import pipeline as jpl
from perfbench import gen, reference

from torch_helpers import pool_calls, vcf_body

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTH = 1_000_000
WINDOW = 250_000


def _config():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "hifi_hg002_30x_tr.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("seed", [20261018, 4_000_000_037])
def test_repeat_contig_matches_jax_in_process_and_on_the_pool(seed,
                                                              tmp_path):
    cfg = _config()
    assert cfg["genome"]["tandem_repeats"]["loci_per_mb"] > 0
    c = gen.make_contig((str(tmp_path), "tr", "chr1", seed, cfg["reads"],
                         cfg["genome"], LENGTH, 1))
    kw = dict(ref_fa_fn=c["fasta"], in_bam_fns=[c["bam"]], n_threads=2,
              window_size=WINDOW, use_device=False)
    bodies = {}
    buf = io.StringIO()
    jpl.run_call(JOpts.hifi(host_procs=0, **kw), buf, "t")
    bodies["jax"] = vcf_body(buf.getvalue())
    buf = io.StringIO()
    with pool_calls(tpl) as calls:
        tpl.run_call(TOpts.hifi(host_procs=0, **kw), buf, "t")
    assert calls == []
    bodies["in_process"] = vcf_body(buf.getvalue())
    buf = io.StringIO()
    try:
        with pool_calls(tpl) as calls:
            tpl.run_call(TOpts.hifi(host_procs=2, **kw), buf, "t")
    finally:
        procpool.shutdown()
    assert calls == [(LENGTH // WINDOW, 2)]
    bodies["pool"] = vcf_body(buf.getvalue())

    assert len(bodies["jax"]) > 500
    assert bodies["in_process"] == bodies["jax"]
    assert bodies["pool"] == bodies["jax"]

    ref4, truth = gen.genome_truth(c["seed"], LENGTH, cfg["reads"],
                                   cfg["genome"])
    edge = int(cfg["reads"]["margin"]) + int(cfg["reads"]["read_len"])
    loci = [(t[2].beg, t[2].end, t[2].allele(ref4, 1), t[2].allele(ref4, 2))
            for t in truth if t[1] == "tr"]
    plants = [t for t in truth if t[1] != "tr"]
    got = reference.score_tr_loci(bodies["in_process"], loci, ref4, edge,
                                  LENGTH - edge, plants)
    assert got["tr_loci"] > 100
    assert got["tr_bad"] <= 1, got["tr_bad"]
