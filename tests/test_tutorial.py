"""Tests against the REAL tutorial VCF shipped with the reference
(tutorial/jurkat_293T_exons_only.vcf.gz: 54,424 records, samples jurkat +
293T_RTG, FORMAT GT:GQ:DP:PL:AD). The tutorial BAM is not in the reference
repo (stripped large blob), so reads are synthesized at the real SNP
positions from each sample's real genotypes — the de-facto integration test
of SURVEY.md §4 run end-to-end."""

import os
import random

import numpy as np
import pytest

from demuxlet_jax import cli
from demuxlet_jax.io.vcf import load_snp_table
from fixtures import SimRead, write_bam

TUT_VCF = "/root/reference/tutorial/jurkat_293T_exons_only.vcf.gz"

pytestmark = pytest.mark.skipif(
    not os.path.exists(TUT_VCF), reason="reference tutorial VCF not present"
)


def test_tutorial_vcf_loads_gt():
    t = load_snp_table(TUT_VCF, field_name="GT")
    assert t.sample_ids == ["jurkat", "293T_RTG"]
    assert t.nsnps == 54116  # records passing biallelic/MAC/callrate filters
    assert t.gps.shape == (54116, 2, 3)
    # GT conversion: called genotypes get 1-err, others err/2 (SURVEY §2.1)
    rows = t.gps.reshape(-1, 3)
    assert np.allclose(rows.sum(axis=1), 1.0, atol=1e-9)


def test_tutorial_vcf_pl_missing_errors_like_reference():
    """Some tutorial records lack PL (FORMAT GT:RE:GQ:DP:RS); the reference
    hard-errors 'Cannot parse posterior probability at <pos>'
    (cmd_cram_demuxlet.cpp:211-213) — so do we, at the same record."""
    from demuxlet_jax.utils.logging_utils import DemuxError

    with pytest.raises(DemuxError, match="Cannot parse posterior"):
        load_snp_table(TUT_VCF, field_name="PL")


def test_tutorial_demux_end_to_end(tmp_path):
    """Synthetic droplets over the real SNP panel are correctly assigned."""
    t = load_snp_table(TUT_VCF, field_name="GT")
    rng = random.Random(5)
    # pick informative SNPs on one chromosome where genotypes differ
    chrom = t.chroms[0]
    geno = np.argmax(t.gps, axis=2)  # (nsnps, 2) called genotype
    cand = [
        i for i in range(t.nsnps)
        if t.chroms[i] == chrom and geno[i, 0] != geno[i, 1]
    ][:200]
    assert len(cand) >= 100
    contigs = [(chrom, int(t.pos0[max(cand)] + 1000))]
    reads = []
    truth = {}
    for c in range(20):
        bc = "TBC%04d" % c
        s = c % 2
        truth[bc] = s
        for j in range(60):
            i = cand[rng.randrange(len(cand))]
            g = geno[i, s]
            p_ref = [1.0, 0.5, 0.0][g]
            base = chr(t.ref[i]) if rng.random() < p_ref else chr(t.alt[i])
            reads.append(
                SimRead(
                    chrom=chrom, pos0=int(t.pos0[i]), seq=base,
                    quals=[37], cb=bc, ub=f"U{c}_{j}",
                )
            )
    bam = write_bam(str(tmp_path / "tut.bam"), contigs, reads)
    rc = cli.main([
        "--sam", bam, "--vcf", TUT_VCF, "--field", "GT",
        "--out", str(tmp_path / "tut"),
    ])
    assert rc == 0
    ok = 0
    names = ["jurkat", "293T_RTG"]
    for line in open(str(tmp_path / "tut") + ".best"):
        if line.startswith("BARCODE"):
            continue
        f = line.split("\t")
        if f[5] == "SNG-" + names[truth[f[0]]]:
            ok += 1
    assert ok == 20
