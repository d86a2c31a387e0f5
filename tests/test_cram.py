"""CRAM 3.0 subset reader vs the BAM path: identical pileups and outputs.

A synthetic genome is generated; reads carry genome-consistent bases with
planted substitutions, indels, clips and skips. The same reads are written
as BAM (explicit bases) and CRAM (features vs the genome); the demux pileup
must be identical — CRAM match positions resolve through the VCF REF allele
(io/cram.py docstring), which the fixture guarantees equals the genome base.
"""

import random

import numpy as np
import pytest

from demuxlet_jax.host.csr import CsrPileup
from demuxlet_jax.host.pileup import build_pileup
from demuxlet_jax.host.slots import build_slots
from demuxlet_jax.io.bam import AlignmentReader
from demuxlet_jax.io.cram import CramReader
from demuxlet_jax.io.vcf import load_snp_table
from fixtures import SimRead, SimVariant, write_bam, write_cram, write_vcf


def _genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _workload(tmp_path, seed=23, n_cells=12, n_snps=30, method=0,
              **cram_kw):
    import os

    os.makedirs(str(tmp_path), exist_ok=True)
    rng = random.Random(seed)
    glen = 8000
    g = list(_genome(rng, glen))
    positions = sorted(rng.sample(range(100, glen - 100), n_snps))
    names = ["S0", "S1", "S2"]
    variants = []
    genos = []
    for p in positions:
        ref = g[p]
        alt = rng.choice([b for b in "ACGT" if b != ref])
        row = [rng.choice([0, 1, 2]) for _ in names]
        genos.append((p, ref, alt, row))
        variants.append(
            SimVariant("chr1", p, ref, alt,
                       [{"GT": ["0/0", "0/1", "1/1"][x]} for x in row])
        )
    genome = "".join(g)
    reads = []
    for c in range(n_cells):
        bc = "CB%04d" % c
        src = c % 3
        for j in range(50):
            p, ref, alt, row = genos[rng.randrange(n_snps)]
            start = max(0, p - rng.randrange(1, 40))
            ln = 50
            seq = list(genome[start : start + ln])
            # plant the allele at the SNP
            gcode = row[src]
            want_ref = rng.random() < [1.0, 0.5, 0.0][gcode]
            seq[p - start] = ref if want_ref else alt
            # random extra mismatch elsewhere
            if rng.random() < 0.3:
                off = rng.randrange(ln)
                seq[off] = rng.choice("ACGT")
            reads.append(
                SimRead("chr1", start, "".join(seq),
                        [rng.randrange(25, 41) for _ in range(ln)],
                        cb=bc, ub=f"u{c}_{j}")
            )
    # adversarial CIGARs over the genome
    p0 = positions[0]
    reads.append(SimRead("chr1", p0 - 3, genome[p0 - 3 : p0] + genome[p0 + 5 : p0 + 12],
                         [30] * 10, cigar="3M5D7M", cb="CB0000", ub="ux1"))
    reads.append(SimRead("chr1", p0 - 2, "TT" + genome[p0 - 2 : p0 + 6],
                         [30] * 10, cigar="2S8M", cb="CB0001", ub="ux2"))
    reads.append(SimRead("chr1", p0 - 4, genome[p0 - 4 : p0 - 1] + "GGG" + genome[p0 - 1 : p0 + 3],
                         [30] * 10, cigar="3M3I4M", cb="CB0002", ub="ux3"))
    reads.append(SimRead("chr1", p0 - 2, genome[p0 - 2 : p0 + 2] + genome[p0 + 30 : p0 + 36],
                         [30] * 10, cigar="4M28N6M", cb="CB0003", ub="ux4"))
    contigs = [("chr1", glen)]
    vcf = write_vcf(str(tmp_path / "c.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "c.bam"), contigs, reads)
    cram = write_cram(str(tmp_path / "c.cram"), contigs, reads,
                      {"chr1": genome}, method=method, **cram_kw)
    return vcf, bam, cram


def test_cram_pileup_matches_bam(tmp_path):
    vcf, bam, cram = _workload(tmp_path)
    table = load_snp_table(vcf, field_name="GT")
    scl_b, ctr_b = build_pileup(AlignmentReader(bam), table)
    scl_c, ctr_c = build_pileup(CramReader(cram), table)
    assert scl_c.barcodes == scl_b.barcodes
    assert ctr_c == ctr_b
    cb = CsrPileup.from_pileup(scl_b)
    cc = CsrPileup.from_pileup(scl_c)
    np.testing.assert_array_equal(cb.cell_uniq, cc.cell_uniq)
    cells = list(range(cb.nbcs))
    bb, bc2 = build_slots(cb, cells), build_slots(cc, cells)
    np.testing.assert_array_equal(bb.idx, bc2.idx)
    np.testing.assert_array_equal(bb.cnt, bc2.cnt)


def test_cram_cli_end_to_end(tmp_path):
    from demuxlet_jax import cli

    vcf, bam, cram = _workload(tmp_path, seed=29)
    rc = cli.main(["--sam", cram, "--vcf", vcf, "--field", "GT",
                   "--out", str(tmp_path / "cr")])
    assert rc == 0
    rc = cli.main(["--sam", bam, "--vcf", vcf, "--field", "GT",
                   "--out", str(tmp_path / "ba"), "--ingest", "python"])
    assert rc == 0
    assert (
        open(str(tmp_path / "cr") + ".best").read()
        == open(str(tmp_path / "ba") + ".best").read()
    )


@pytest.mark.parametrize("method", [1, 3, 4])  # gzip, lzma, rANS 4x8
def test_cram_compressed_blocks(tmp_path, method):
    """gzip-, lzma- and rANS-compressed external blocks decode identically
    to BAM."""
    vcf, bam, cram = _workload(tmp_path / ("m%d" % method), seed=31,
                               method=method)
    table = load_snp_table(vcf, field_name="GT")
    scl_b, ctr_b = build_pileup(AlignmentReader(bam), table)
    scl_c, ctr_c = build_pileup(CramReader(cram), table)
    assert scl_c.barcodes == scl_b.barcodes
    assert ctr_c == ctr_b
    cb = CsrPileup.from_pileup(scl_b)
    cc = CsrPileup.from_pileup(scl_c)
    cells = list(range(cb.nbcs))
    bb, bc2 = build_slots(cb, cells), build_slots(cc, cells)
    np.testing.assert_array_equal(bb.cnt, bc2.cnt)


def test_cramread_feature_walk_direct():
    """Hand-built feature lists: 'b' (explicit base run) and 'i' (single-base
    insertion) walk correctly; matches resolve through ref_base."""
    from demuxlet_jax.io.cram import CramRead, Feature, _SubCode

    # read at pos 10, len 10: 2 match, b-run "GT" at read pos 3-4, 3 match,
    # single-base insertion at pos 8, 2 match
    r = CramRead(
        tid=0, pos=10, mapq=60, flag=0, l_qseq=10,
        features=[
            Feature("b", 3, b"GT"),
            Feature("i", 8, 1),
        ],
        quals=bytes(range(30, 40)),
        tags={},
    )
    # genomic: 10,11 match; 12,13 are the b-run; 14,15,16 match (read 5,6,7);
    # read 7 (0-based) is the inserted base (consumes no ref); 17,18 match
    assert r.base_qual_at(10, "A") == ("A", 30, 0)
    assert r.base_qual_at(12, "C") == ("G", 32, 2)
    assert r.base_qual_at(13, "C") == ("T", 33, 3)
    assert r.base_qual_at(14, "C") == ("C", 34, 4)
    base, q, rp = r.base_qual_at(17, "T")
    assert (base, rp) == ("T", 8)  # after the insertion, ref resumes at read 8
    assert r.endpos() == 10 + 9  # 10 read bases, 1 is an insertion

    # substitution resolution through the matrix
    table = {"A": "CGTN"}
    sc = _SubCode(table, 1)
    assert sc("A") == "G"


@pytest.mark.parametrize("kw", [
    dict(core_codecs=True),
    dict(slices=3),
    dict(core_codecs=True, slices=3, method=4),
])
def test_cram_core_codecs_and_slices_match_bam(tmp_path, kw):
    """Core-bitstream codecs (BETA/GAMMA/SUBEXP/multi-symbol canonical
    HUFFMAN) and multi-slice containers decode to the same pileup as the
    BAM, including rANS-compressed external blocks."""
    vcf, bam, cram = _workload(tmp_path, seed=41, **kw)
    table = load_snp_table(vcf, field_name="GT")
    scl_b, ctr_b = build_pileup(AlignmentReader(bam), table)
    scl_c, ctr_c = build_pileup(CramReader(cram), table)
    assert scl_c.barcodes == scl_b.barcodes
    assert ctr_c == ctr_b
    cb = CsrPileup.from_pileup(scl_b)
    cc = CsrPileup.from_pileup(scl_c)
    np.testing.assert_array_equal(cb.cell_uniq, cc.cell_uniq)
    cells = list(range(cb.nbcs))
    bb, bc2 = build_slots(cb, cells), build_slots(cc, cells)
    np.testing.assert_array_equal(bb.idx, bc2.idx)
    np.testing.assert_array_equal(bb.cnt, bc2.cnt)


def test_cram_b_feature_pileup_matches_bam(tmp_path):
    """'B' (base + quality) features must carry their STORED base — a
    decoder that discards it resolves the position to the reference base
    and silently corrupts the pileup (round-4 review #4). The fixture
    encodes every third mismatch as 'B'; the CRAM pileup must equal the
    BAM twin's exactly."""
    vcf, bam, cram = _workload(tmp_path, seed=53, b_features=True)
    table = load_snp_table(vcf, field_name="GT")
    scl_b, ctr_b = build_pileup(AlignmentReader(bam), table)
    scl_c, ctr_c = build_pileup(CramReader(cram), table)
    assert ctr_c == ctr_b
    cb = CsrPileup.from_pileup(scl_b)
    cc = CsrPileup.from_pileup(scl_c)
    cells = list(range(cb.nbcs))
    bb, bc2 = build_slots(cb, cells), build_slots(cc, cells)
    np.testing.assert_array_equal(bb.idx, bc2.idx)
    np.testing.assert_array_equal(bb.cnt, bc2.cnt)


def test_cram_b_feature_qual_without_preserved_quals(tmp_path):
    """CRAMs without wholesale qual preservation (no CF 0x1): the 'B'
    feature's stored qual byte is the ONLY BQ source at its position.
    A decoder that reads-and-drops it returned BQ 0 there, silently
    failing the min-BQ filter (advisor r4 #1). Both the Python and the
    native reader must surface the feature qual; preserved-quals CRAMs
    keep letting the QS array win (htslib decode order)."""
    import os

    os.makedirs(str(tmp_path), exist_ok=True)
    rng = random.Random(7)
    genome = _genome(rng, 240)
    snp_pos = 100
    ref = genome[snp_pos]
    alt = next(b for b in "ACGT" if b != ref)
    vcf = write_vcf(
        str(tmp_path / "v.vcf"), ["S0"],
        [SimVariant("chr1", snp_pos, ref, alt, [{"GT": "0/1"}])],
        contigs=[("chr1", 240)],
    )
    # one 50bp read at pos0=80; mismatches at read offsets 5, 12, 20 —
    # the third becomes the 'B' feature and sits ON the SNP (offset 20
    # -> genomic 100), planted with the ALT allele and BQ 37
    pos0, off_b, bq_b = 80, snp_pos - 80, 37
    seq = list(genome[pos0 : pos0 + 50])
    for off in (5, 12):
        seq[off] = next(b for b in "ACGT" if b != seq[off])
    seq[off_b] = alt
    quals = [30] * 50
    quals[off_b] = bq_b
    read = SimRead("chr1", pos0, "".join(seq), quals, cb="CB0001",
                   ub="U1")
    cram = write_cram(
        str(tmp_path / "r.cram"), [("chr1", 240)], [read],
        {"chr1": genome}, b_features=True, preserve_quals=False,
    )
    table = load_snp_table(vcf, field_name="GT")
    scl, _ = build_pileup(CramReader(cram), table)
    # the SNP observation survives min-BQ with the feature's qual
    assert (0, 0) in scl.umis, "B-feature obs dropped (BQ lost)"
    (al, bq), = scl.umis[(0, 0)].values()
    assert (al, bq) == (1, bq_b)

    native = pytest.importorskip("demuxlet_jax.native.ingest")
    if not native.available():
        pytest.skip("native ingest not built")
    csr_n, _ = native.build_pileup(cram, table)
    a, b = csr_n.cell_ptr[0], csr_n.cell_ptr[1]
    assert b - a == 1
    assert csr_n.obs_allele[a] == 1 and csr_n.obs_bq[a] == bq_b


def test_cram_31_codec_loud_error():
    """A CRAM 3.1-codec block (method ids 5-8) must fail with a message
    naming CRAM 3.1 and the re-encode remedy, not a generic
    'method not supported' that reads like corruption (VERDICT r4 #8).
    3.1 files are structurally 3.x containers, so the failure surfaces
    at block decode, not at the version gate."""
    from types import SimpleNamespace

    from demuxlet_jax.io.cram import CramReader, _Buf
    from demuxlet_jax.utils.logging_utils import DemuxError

    # minimal block: method=5 (rANS-Nx16), ctype=4, cid=0, csize=1,
    # rsize=1, 1 payload byte, 4 CRC bytes
    raw = bytes([5, 4, 0, 1, 1, 0xAB, 0, 0, 0, 0])
    fake = SimpleNamespace(path="x.cram")
    with pytest.raises(DemuxError, match="CRAM 3.1 codec unsupported"):
        CramReader._block(fake, _Buf(raw))
