"""BCF2 binary reader vs the text VCF path."""

import random

import numpy as np

from demuxlet_jax.io.vcf import load_snp_table
from fixtures import SimVariant, random_workload, write_bcf, write_vcf


def _variants(seed=3, n=25, ns=3, fields=("GT",)):
    rng = random.Random(seed)
    bases = ["A", "C", "G", "T"]
    out = []
    for k in range(n):
        ref, alt = rng.sample(bases, 2)
        svals = []
        for _ in range(ns):
            g = rng.choice([0, 1, 2])
            d = {}
            if "GT" in fields:
                d["GT"] = ["0/0", "0/1", "1/1"][g]
            if "GP" in fields:
                p = [0.05, 0.05, 0.05]
                p[g] = 0.9
                d["GP"] = ",".join("%.3f" % x for x in p)
            if "PL" in fields:
                pl = [60, 60, 60]
                pl[g] = 0
                d["PL"] = ",".join(str(x) for x in pl)
            svals.append(d)
        out.append(SimVariant("chr1", 100 + 50 * k, ref, alt, svals))
    return out


def _cmp(tmp_path, fields, load_field):
    names = [f"S{i}" for i in range(3)]
    variants = _variants(fields=fields)
    contigs = [("chr1", 100000)]
    vcf = write_vcf(str(tmp_path / "x.vcf"), names, variants, contigs=contigs,
                    fmt_keys=list(fields))
    bcf = write_bcf(str(tmp_path / "x.bcf"), names, variants, contigs=contigs,
                    fmt_keys=list(fields))
    tv = load_snp_table(vcf, field_name=load_field)
    tb = load_snp_table(bcf, field_name=load_field)
    assert tv.sample_ids == tb.sample_ids
    assert tv.nsnps == tb.nsnps
    np.testing.assert_array_equal(tv.pos0, tb.pos0)
    np.testing.assert_array_equal(tv.ref, tb.ref)
    np.testing.assert_allclose(tv.gps, tb.gps, rtol=0, atol=0)


def test_bcf_gt(tmp_path):
    _cmp(tmp_path, ("GT",), "GT")


def test_bcf_gp(tmp_path):
    _cmp(tmp_path, ("GP", "GT"), "GP")


def test_bcf_pl(tmp_path):
    _cmp(tmp_path, ("PL", "GT"), "PL")


def test_bcf_shared_implicit_idx(tmp_path):
    """BCF2 spec: an ID in multiple dictionary lines (DP in INFO+FORMAT)
    without explicit IDX= shares ONE implicit index; later FORMAT keys
    (GT/GP/PL) must not be shifted."""
    names = [f"S{i}" for i in range(3)]
    variants = _variants(fields=("GT", "GP"))
    contigs = [("chr1", 100000)]
    vcf = write_vcf(str(tmp_path / "x.vcf"), names, variants, contigs=contigs,
                    fmt_keys=["GT", "GP"])
    bcf = write_bcf(str(tmp_path / "x.bcf"), names, variants, contigs=contigs,
                    fmt_keys=["GT", "GP"], dup_dp_header=True)
    tv = load_snp_table(vcf, field_name="GP")
    tb = load_snp_table(bcf, field_name="GP")
    assert tv.sample_ids == tb.sample_ids
    np.testing.assert_allclose(tv.gps, tb.gps, rtol=0, atol=0)


def test_csi_region_seek_matches_full_load(tmp_path):
    """load_snp_table(regions=...) over a .csi-indexed BCF == full load +
    filter_snp_table (the BCF analog of the .tbi seek path)."""
    import random

    import numpy as np

    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from fixtures import SimVariant, write_bcf

    rng = random.Random(13)
    contigs = [("chr1", 60000), ("chr2", 60000), ("chr3", 60000)]
    names = ["S0", "S1"]
    variants = []
    for ch, ln in contigs:
        for p in range(500, ln - 500, 113):
            ref, alt = rng.sample("ACGT", 2)
            variants.append(SimVariant(ch, p, ref, alt,
                            [{"GT": rng.choice(["0/0", "0/1", "1/1"])}
                             for _ in names]))
    bcf = write_bcf(str(tmp_path / "t.bcf"), names, variants,
                    contigs=contigs, index=True)
    import os

    assert os.path.exists(bcf + ".csi")
    full = load_snp_table(bcf, field_name="GT")
    for regions in (
        [("chr2", 1, 60000)],
        [("chr1", 20000, 40000), ("chr3", 1, 400)],
        [("chr3", 55000, 60000)],
    ):
        want = filter_snp_table(full, regions)
        got = load_snp_table(bcf, field_name="GT", regions=regions)
        assert got.chroms == want.chroms
        np.testing.assert_array_equal(got.pos0, want.pos0)
        np.testing.assert_array_equal(got.gps, want.gps)
