"""VCF parsing + GT/GP/PL posterior conversion tests (bcf_filtered_reader.cpp
semantics)."""

import numpy as np
import pytest

from demuxlet_jax.host import genotypes as G
from demuxlet_jax.io.vcf import load_snp_table
from fixtures import SimVariant, write_vcf


def _table(tmp_path, variants, names=("A", "B"), **kw):
    p = str(tmp_path / "t.vcf")
    write_vcf(p, list(names), variants)
    return load_snp_table(p, **kw)


def test_gt_basic(tmp_path):
    t = _table(
        tmp_path,
        [SimVariant("chr1", 99, "A", "C", [{"GT": "0/0"}, {"GT": "1/1"}])],
        field_name="GT",
        geno_error=0.01,
    )
    assert t.nsnps == 1
    assert t.pos0[0] == 99
    assert chr(t.ref[0]) == "A" and chr(t.alt[0]) == "C"
    np.testing.assert_allclose(
        t.gps[0, 0], np.float32([0.99, 0.005, 0.005]).astype(np.float64)
    )
    np.testing.assert_allclose(
        t.gps[0, 1], np.float32([0.005, 0.005, 0.99]).astype(np.float64)
    )
    # af = (acs[1] + 0.5) / (an + 1) = (2 + 0.5) / 5
    assert t.af[0] == (2 + 0.5) / 5.0


def test_gt_missing_uses_hwe(tmp_path):
    t = _table(
        tmp_path,
        [
            SimVariant(
                "chr1",
                10,
                "G",
                "T",
                [{"GT": "./."}, {"GT": "0/1"}, {"GT": "0/1"}],
            )
        ],
        names=("A", "B", "C"),
        field_name="GT",
    )
    # acs = [2,2], an = 4 over non-missing; p = (2+0.5)/5 for both alleles
    p0 = (2 + 0.5) / 5.0
    p1 = (2 + 0.5) / 5.0
    expect = np.float32([p0 * p0, 2 * p1 * p0, p1 * p1]).astype(np.float64)
    np.testing.assert_allclose(t.gps[0, 0], expect)


def test_filters_monomorphic_and_callrate(tmp_path):
    variants = [
        # monomorphic (all 0/0): MAC < 1 -> filtered
        SimVariant("chr1", 10, "A", "C", [{"GT": "0/0"}, {"GT": "0/0"}]),
        # callrate 0/4 < 0.5 -> filtered
        SimVariant("chr1", 20, "A", "C", [{"GT": "./."}, {"GT": "./."}]),
        # passes
        SimVariant("chr1", 30, "A", "C", [{"GT": "0/1"}, {"GT": "0/0"}]),
    ]
    t = _table(tmp_path, variants, field_name="GT")
    assert t.nsnps == 1
    assert t.pos0[0] == 30


def test_multiallelic_filtered(tmp_path):
    variants = [
        SimVariant("chr1", 10, "A", "C,G", [{"GT": "0/1"}, {"GT": "0/2"}]),
        SimVariant("chr1", 30, "A", "C", [{"GT": "0/1"}, {"GT": "0/0"}]),
    ]
    t = _table(tmp_path, variants, field_name="GT")
    assert t.nsnps == 1


def test_gp_field_f32_dance(tmp_path):
    raw = [{"GP": "0.2,0.6,0.2"}, {"GP": "0.8,0.1,0.1"}]
    t = _table(
        tmp_path,
        [SimVariant("chr1", 10, "A", "C", [{**r, "GT": "0/1"} for r in raw])],
        field_name="GP",
        geno_error=0.01,
    )
    # oracle computation in strict f32
    g = np.float32([[0.2, 0.6, 0.2], [0.8, 0.1, 0.1]])
    expect = G.gp_to_gps(g, 0.01).astype(np.float64)
    np.testing.assert_array_equal(t.gps[0], expect)
    # each row still sums to ~1
    np.testing.assert_allclose(t.gps[0].sum(axis=1), [1.0, 1.0], atol=1e-6)


def test_pl_em(tmp_path):
    t = _table(
        tmp_path,
        [
            SimVariant(
                "chr1",
                10,
                "A",
                "C",
                [
                    {"PL": "0,30,300", "GT": "0/0"},
                    {"PL": "300,30,0", "GT": "1/1"},
                ],
            )
        ],
        field_name="PL",
    )
    gps = t.gps[0]
    # sample 0 strongly RR, sample 1 strongly AA
    assert gps[0, 0] > 0.9 and gps[1, 2] > 0.9
    np.testing.assert_allclose(gps.sum(axis=1), [1.0, 1.0], rtol=1e-6)


def test_pl_missing_clamps_to_255():
    gps, acs, an = G.pl_to_gps(
        np.array([[0, 30, 300], [-2147483648, -2147483648, -2147483648]], np.int32)
    )
    # missing PLs act like PL=255 everywhere: posterior ~ HWE prior
    assert an == 4
    np.testing.assert_allclose(gps[1].sum(), 1.0, rtol=1e-6)


def test_sample_subset_sorted_order(tmp_path):
    p = str(tmp_path / "t.vcf")
    write_vcf(
        p,
        ["Z", "A", "M"],
        [
            SimVariant(
                "chr1",
                10,
                "A",
                "C",
                [{"GT": "0/0"}, {"GT": "0/1"}, {"GT": "1/1"}],
            )
        ],
    )
    t = load_snp_table(p, field_name="GT", sm_ids=["Z", "M"])
    # std::set order: sorted IDs
    assert t.sample_ids == ["M", "Z"]
    # M is column 2 (1/1), Z is column 0 (0/0)
    assert t.gps[0, 0, 2] > 0.9  # M: AA
    assert t.gps[0, 1, 0] > 0.9  # Z: RR


def test_chr_pattern_chunked_load(tmp_path):
    """-_CHR_- pattern expansion == single concatenated VCF (and missing
    chunk files are skipped)."""
    import numpy as np

    from demuxlet_jax.io.vcf import (
        expand_chr_pattern,
        load_snp_table,
        merge_snp_tables,
    )
    from fixtures import SimVariant, write_vcf

    names = ["S0", "S1"]
    v1 = [SimVariant("chr1", 100 + i * 10, "A", "C",
                     [{"GT": "0/1"}, {"GT": "0/0"}]) for i in range(5)]
    v2 = [SimVariant("chr2", 200 + i * 10, "G", "T",
                     [{"GT": "1/1"}, {"GT": "0/1"}]) for i in range(4)]
    write_vcf(str(tmp_path / "x.chr1.vcf"), names, v1,
              contigs=[("chr1", 10000)])
    write_vcf(str(tmp_path / "x.chr2.vcf"), names, v2,
              contigs=[("chr2", 10000)])
    write_vcf(str(tmp_path / "all.vcf"), names, v1 + v2,
              contigs=[("chr1", 10000), ("chr2", 10000)])

    files = expand_chr_pattern(
        str(tmp_path / "x.-_CHR_-.vcf"), ["chr1", "chr2", "chrM"]
    )
    assert len(files) == 2  # chrM chunk missing -> skipped
    merged = merge_snp_tables([load_snp_table(f, field_name="GT") for f in files])
    ref = load_snp_table(str(tmp_path / "all.vcf"), field_name="GT")
    assert merged.chrom_names == ref.chrom_names
    np.testing.assert_array_equal(merged.pos0, ref.pos0)
    np.testing.assert_allclose(merged.gps, ref.gps, rtol=0, atol=0)


def test_beg_end_pattern_chunked_load(tmp_path):
    """-_BEG_-/-_END_- pattern expansion with --chunk-unit: per-interval
    files substitute beg1/end0 per genomeChunk.cpp:91-126 + setFileName
    (:181-202); missing interval files are skipped."""
    import numpy as np

    from demuxlet_jax.io.vcf import (
        expand_chunk_pattern,
        load_snp_table,
        merge_snp_tables,
    )
    from fixtures import SimVariant, write_vcf

    names = ["S0", "S1"]
    va = [SimVariant("chr1", 100 + i * 10, "A", "C",
                     [{"GT": "0/1"}, {"GT": "0/0"}]) for i in range(5)]
    vb = [SimVariant("chr1", 6000 + i * 10, "G", "T",
                     [{"GT": "1/1"}, {"GT": "0/1"}]) for i in range(4)]
    contigs = [("chr1", 9000)]
    # unit=5000 over a 9000bp chromosome: intervals 1-5000 and 5001-9000
    write_vcf(str(tmp_path / "x.chr1.1.5000.vcf"), names, va, contigs=contigs)
    write_vcf(str(tmp_path / "x.chr1.5001.9000.vcf"), names, vb,
              contigs=contigs)
    write_vcf(str(tmp_path / "all.vcf"), names, va + vb, contigs=contigs)

    files = expand_chunk_pattern(
        str(tmp_path / "x.-_CHR_-.-_BEG_-.-_END_-.vcf"),
        [("chr1", 9000), ("chr2", 8000)],  # chr2 chunks missing -> skipped
        unit=5000,
    )
    assert [f.rsplit("/", 1)[-1] for f in files] == [
        "x.chr1.1.5000.vcf", "x.chr1.5001.9000.vcf"
    ]
    merged = merge_snp_tables([load_snp_table(f, field_name="GT") for f in files])
    ref = load_snp_table(str(tmp_path / "all.vcf"), field_name="GT")
    np.testing.assert_array_equal(merged.pos0, ref.pos0)
    np.testing.assert_allclose(merged.gps, ref.gps, rtol=0, atol=0)


def test_beg_without_end_pattern_errors(tmp_path):
    from demuxlet_jax.io.vcf import expand_chunk_pattern
    from demuxlet_jax.utils.logging_utils import DemuxError

    import pytest

    with pytest.raises(DemuxError):
        expand_chunk_pattern("x.-_BEG_-.vcf", [("chr1", 100)], unit=10)


def test_tabix_region_seek_matches_full_load(tmp_path):
    """load_snp_table(regions=...) over a .tbi-indexed .vcf.gz == full load
    + filter_snp_table: same SNPs/gps, full header contig list preserved
    (zero-SNP region chroms must still resolve for read ownership)."""
    import random

    import numpy as np

    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from fixtures import SimVariant, write_tabix, write_vcf

    rng = random.Random(11)
    contigs = [("chr1", 60000), ("chr2", 60000), ("chr3", 60000)]
    names = ["S0", "S1"]
    variants = []
    for ch, ln in contigs:
        for p in range(500, ln - 500, 97):
            ref, alt = rng.sample("ACGT", 2)
            variants.append(SimVariant(ch, p, ref, alt,
                            [{"GT": rng.choice(["0/0", "0/1", "1/1"])}
                             for _ in names]))
    gz = write_vcf(str(tmp_path / "t.vcf.gz"), names, variants,
                   contigs=contigs)
    write_tabix(gz, contigs)

    full = load_snp_table(gz, field_name="GT")
    for regions in (
        [("chr2", 1, 60000)],                       # whole chromosome
        [("chr1", 20000, 40000), ("chr3", 1, 500)], # mid-chrom + empty
        [("chr1", 55000, 60000), ("chr2", 1, 9000)],
    ):
        want = filter_snp_table(full, regions)
        got = load_snp_table(gz, field_name="GT", regions=regions)
        assert got.chrom_names == full.chrom_names  # full header contigs
        assert got.chroms == want.chroms
        np.testing.assert_array_equal(got.pos0, want.pos0)
        np.testing.assert_array_equal(got.ref, want.ref)
        np.testing.assert_array_equal(got.gps, want.gps)

    # no index -> transparent full-scan + post-filter fallback
    import os

    os.remove(gz + ".tbi")
    regions = [("chr1", 20000, 40000)]
    got = load_snp_table(gz, field_name="GT", regions=regions)
    want = filter_snp_table(full, regions)
    np.testing.assert_array_equal(got.pos0, want.pos0)
    np.testing.assert_array_equal(got.gps, want.gps)


def test_corrupt_index_falls_back_cleanly(tmp_path):
    """Garbage/truncated .tbi or .csi files never crash region loading —
    the parsers return None and the loader full-scans + post-filters."""
    import gzip as _gzip
    import random

    import numpy as np

    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from fixtures import SimVariant, write_bcf, write_tabix, write_vcf

    rng = random.Random(17)
    contigs = [("chr1", 40000), ("chr2", 40000)]
    names = ["S0", "S1"]
    variants = []
    for ch, ln in contigs:
        for p in range(500, ln - 500, 301):
            ref, alt = rng.sample("ACGT", 2)
            variants.append(SimVariant(ch, p, ref, alt,
                            [{"GT": rng.choice(["0/0", "0/1", "1/1"])}
                             for _ in names]))
    gz = write_vcf(str(tmp_path / "t.vcf.gz"), names, variants,
                   contigs=contigs)
    tbi = write_tabix(gz, contigs)
    bcf = write_bcf(str(tmp_path / "t.bcf"), names, variants,
                    contigs=contigs, index=True)
    regions = [("chr1", 10000, 30000)]
    full_v = load_snp_table(gz, field_name="GT")
    want = filter_snp_table(full_v, regions)

    # truncate the gzip payloads mid-stream + pure garbage
    good_tbi = open(tbi, "rb").read()
    for payload in (good_tbi[: len(good_tbi) // 2], b"GARBAGE" * 10,
                    _gzip.compress(b"TBI\x01" + b"\x00" * 3)):
        open(tbi, "wb").write(payload)
        got = load_snp_table(gz, field_name="GT", regions=regions)
        np.testing.assert_array_equal(got.pos0, want.pos0)

    good_csi = open(bcf + ".csi", "rb").read()
    full_b = load_snp_table(bcf, field_name="GT")
    want_b = filter_snp_table(full_b, regions)
    for payload in (good_csi[: len(good_csi) // 2], b"junk",
                    _gzip.compress(b"CSI\x01" + b"\x00" * 5)):
        open(bcf + ".csi", "wb").write(payload)
        got = load_snp_table(bcf, field_name="GT", regions=regions)
        np.testing.assert_array_equal(got.pos0, want_b.pos0)
