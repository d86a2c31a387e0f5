"""Pileup semantics tests: CIGAR walk (hts_utils.cpp:279-359), UMI dedup
(sc_drop_seq.cpp:34-77), read filters and counters (cmd_cram_demuxlet.cpp
:195-361)."""

import numpy as np
import pytest

from demuxlet_jax.io.bam import READ_INDEX_NA, AlignedRead, AlignmentReader
from demuxlet_jax.io.vcf import load_snp_table
from demuxlet_jax.host.pileup import build_pileup
from fixtures import SimRead, SimVariant, write_bam, write_sam, write_vcf


def mk_read(pos0, seq, cigar, quals=None):
    return AlignedRead(
        tid=0,
        pos=pos0,
        mapq=60,
        flag=0,
        l_qseq=len(seq),
        cigar=_cig(cigar),
        seq=seq,
        qual=bytes(quals or [30] * len(seq)),
        tags={},
    )


def _cig(s):
    out, num = [], ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append(("MIDNSHP=X".index(ch), int(num)))
            num = ""
    return out


class TestCigarWalk:
    def test_simple_match(self):
        r = mk_read(100, "ACGT", "4M")
        base, qual, rpos = r.base_qual_at(102)
        assert (base, rpos) == ("G", 2)

    def test_before_read(self):
        r = mk_read(100, "ACGT", "4M")
        # pos < read start never hits the M window; rpos accumulates to 4
        # == l_qseq -> NA (reference behavior)
        assert r.base_qual_at(99)[2] == READ_INDEX_NA

    def test_after_read(self):
        r = mk_read(100, "ACGT", "4M")
        assert r.base_qual_at(104)[2] == READ_INDEX_NA

    def test_deletion_gap(self):
        # 2M3D2M: positions 100,101 from read, 102-104 deleted, 105,106 read
        r = mk_read(100, "ACGT", "2M3D2M")
        assert r.base_qual_at(101)[0] == "C"
        assert r.base_qual_at(103)[2] == READ_INDEX_NA  # in deletion
        base, _, rpos = r.base_qual_at(105)
        assert (base, rpos) == ("G", 2)

    def test_refskip_gap(self):
        r = mk_read(100, "ACGT", "2M100N2M")
        assert r.base_qual_at(150)[2] == READ_INDEX_NA
        assert r.base_qual_at(202)[0] == "G"

    def test_softclip_leading(self):
        # 2S2M: first 2 bases clipped; alignment starts at pos with seq[2]
        r = mk_read(100, "ACGT", "2S2M")
        base, _, rpos = r.base_qual_at(100)
        assert (base, rpos) == ("G", 2)

    def test_insertion(self):
        # 2M2I2M: gpos 100->seq[0], 101->seq[1], 102->seq[4]
        r = mk_read(100, "ACGTAC", "2M2I2M")
        base, _, rpos = r.base_qual_at(102)
        assert (base, rpos) == ("A", 4)

    def test_hard_clip_noop(self):
        r = mk_read(100, "ACGT", "2H4M")
        assert r.base_qual_at(102)[0] == "G"

    def test_endpos(self):
        assert mk_read(100, "ACGT", "4M").endpos() == 104
        assert mk_read(100, "ACGT", "2M3D2M").endpos() == 107
        assert mk_read(100, "ACGTAC", "2M2I2M").endpos() == 104
        assert mk_read(100, "ACGT", "2M100N2M").endpos() == 204


def _setup(tmp_path, reads, variants, samples=("A", "B"), use_bam=False, **kw):
    vcf = str(tmp_path / "t.vcf")
    svals = [{"GT": "0/1"}, {"GT": "0/0"}][: len(samples)]
    write_vcf(vcf, list(samples), variants)
    table = load_snp_table(vcf, field_name="GT")
    contigs = [("chr1", 100000)]
    if use_bam:
        aln = write_bam(str(tmp_path / "t.bam"), contigs, reads)
    else:
        aln = write_sam(str(tmp_path / "t.sam"), contigs, reads)
    rdr = AlignmentReader(aln)
    return build_pileup(rdr, table, **kw)


VAR = [SimVariant("chr1", 102, "G", "T", [{"GT": "0/1"}, {"GT": "0/0"}])]


class TestIngest:
    def test_basic_observation(self, tmp_path):
        reads = [SimRead("chr1", 100, "ACGT", [30] * 4, cb="BC1", ub="U1")]
        scl, ctr = _setup(tmp_path, reads, VAR)
        assert scl.nbcs == 1
        assert scl.umis[(0, 0)] == {"U1": (0, 30)}  # G==ref -> allele 0
        assert ctr.n_pass == 1

    def test_umi_dedup_first_wins(self, tmp_path):
        reads = [
            SimRead("chr1", 100, "ACGT", [30] * 4, cb="BC1", ub="U1"),
            SimRead("chr1", 100, "ACTT", [35] * 4, cb="BC1", ub="U1"),  # dup UMI
            SimRead("chr1", 100, "ACTT", [35] * 4, cb="BC1", ub="U2"),  # alt
        ]
        scl, ctr = _setup(tmp_path, reads, VAR)
        assert scl.umis[(0, 0)] == {"U1": (0, 30), "U2": (1, 35)}
        assert ctr.n_redundant == 1
        assert ctr.n_pass == 2
        assert scl.cell_pass[0] == 3
        assert scl.cell_uniq[0] == 2
        assert scl.cell_totl[0] == 3

    def test_allele2_mismatch_stored(self, tmp_path):
        reads = [SimRead("chr1", 100, "ACAT", [30] * 4, cb="BC1", ub="U1")]
        scl, _ = _setup(tmp_path, reads, VAR)
        assert scl.umis[(0, 0)]["U1"] == (2, 30)  # A matches neither G nor T

    def test_bq_filters(self, tmp_path):
        reads = [
            SimRead("chr1", 100, "ACGT", [30, 30, 5, 30], cb="B1", ub="U1"),
            SimRead("chr1", 100, "ACGT", [30, 30, 50, 30], cb="B2", ub="U1"),
        ]
        scl, ctr = _setup(tmp_path, reads, VAR, min_bq=13, cap_bq=40)
        assert (0, scl.bc_map["B1"]) not in scl.umis  # BQ 5 < 13 skipped
        assert scl.umis[(0, scl.bc_map["B2"])]["U1"] == (0, 40)  # capped
        assert ctr.n_lq == 1

    def test_n_base_skipped(self, tmp_path):
        reads = [SimRead("chr1", 100, "ACNT", [30] * 4, cb="B1", ub="U1")]
        scl, ctr = _setup(tmp_path, reads, VAR)
        assert not scl.umis
        assert ctr.n_n == 1

    def test_mq_filter(self, tmp_path):
        reads = [SimRead("chr1", 100, "ACGT", [30] * 4, cb="B1", ub="U1", mapq=5)]
        scl, ctr = _setup(tmp_path, reads, VAR)
        assert not scl.umis
        assert ctr.n_skip == 1

    def test_excl_flag(self, tmp_path):
        reads = [
            SimRead("chr1", 100, "ACGT", [30] * 4, cb="B1", ub="U1", flag=1024)
        ]
        scl, ctr = _setup(tmp_path, reads, VAR)
        assert not scl.umis
        assert ctr.n_skip == 1

    def test_group_list(self, tmp_path):
        reads = [
            SimRead("chr1", 100, "ACGT", [30] * 4, cb="IN", ub="U1"),
            SimRead("chr1", 100, "ACGT", [30] * 4, cb="OUT", ub="U1"),
        ]
        scl, ctr = _setup(tmp_path, reads, VAR, group_set={"IN"})
        assert scl.nbcs == 1
        assert ctr.n_skip_bcd == 1

    def test_missing_cb_dot(self, tmp_path):
        reads = [SimRead("chr1", 100, "ACGT", [30] * 4, ub="U1")]
        scl, ctr = _setup(tmp_path, reads, VAR)
        assert scl.barcodes == ["."]
        assert ctr.n_no_gtag == 1

    def test_min_td(self, tmp_path):
        # rpos=2, l_qseq=4: minTD=3 -> rpos+minTD=5 > 4 -> skipped
        reads = [SimRead("chr1", 100, "ACGT", [30] * 4, cb="B1", ub="U1")]
        scl, _ = _setup(tmp_path, reads, VAR, min_td=3)
        assert not scl.umis

    def test_bam_equals_sam(self, tmp_path):
        reads = [
            SimRead("chr1", 100, "ACGT", [30, 31, 32, 33], cb="BC1", ub="U1"),
            SimRead("chr1", 101, "CGTA", [20] * 4, cb="BC2", ub="U9"),
        ]
        scl_s, ctr_s = _setup(tmp_path, reads, VAR, use_bam=False)
        scl_b, ctr_b = _setup(tmp_path, reads, VAR, use_bam=True)
        assert scl_s.umis == scl_b.umis
        assert scl_s.barcodes == scl_b.barcodes
        assert ctr_s == ctr_b

    def test_multi_snp_read(self, tmp_path):
        variants = [
            SimVariant("chr1", 101, "C", "T", [{"GT": "0/1"}, {"GT": "0/0"}]),
            SimVariant("chr1", 102, "G", "T", [{"GT": "0/1"}, {"GT": "0/0"}]),
        ]
        reads = [SimRead("chr1", 100, "ACGT", [30] * 4, cb="B1", ub="U1")]
        scl, ctr = _setup(tmp_path, reads, variants)
        assert len(scl.umis) == 2
        assert ctr.n_multi_snps == 1


class TestLongCigarCG:
    """Long-CIGAR BAM records: >65535-op CIGARs store a dummy `l_seqS
    spanN` pair in the CIGAR field and the real ops in a CG:B,I aux tag;
    htslib restores them transparently (sam.c), so both ingest paths
    must too — the dummy soft-clip would otherwise silently drop every
    observation the read carries (VERDICT r4 #6)."""

    def _workload(self, tmp_path, cg):
        import random

        rng = random.Random(11)
        variants, reads = [], []
        # adversarial CIGAR shapes spanning the SNPs: indels, skips, clips
        shapes = ["20M", "5M2D15M", "4S8M3N8M", "6M3I11M", "2S5M1D5M2N8M"]
        for i in range(12):
            p = 100 + 40 * i
            ref, alt = rng.sample("ACGT", 2)
            variants.append(
                SimVariant("chr1", p + 7, ref, alt,
                           [{"GT": "0/1"}, {"GT": "0/0"}])
            )
            cig = shapes[i % len(shapes)]
            ln = sum(
                int(n) for n, ch in __import__("re").findall(
                    r"(\d+)([MIDNSHP=X])", cig) if ch in "MIS"
            )
            seq = "".join(rng.choice("ACGT") for _ in range(ln))
            reads.append(
                SimRead("chr1", p, seq, [30] * ln, cigar=cig,
                        cb="BC%02d" % (i % 4), ub="U%d" % i)
            )
        vcf = write_vcf(str(tmp_path / "v.vcf"), ["S0", "S1"], variants,
                        contigs=[("chr1", 4000)])
        bam = write_bam(str(tmp_path / ("cg.bam" if cg else "plain.bam")),
                        [("chr1", 4000)], reads, cg_tags=cg)
        return vcf, bam

    def test_python_reader_restores_cg(self, tmp_path):
        vcf, plain = self._workload(tmp_path, cg=False)
        _, cgbam = self._workload(tmp_path, cg=True)
        table = load_snp_table(vcf, field_name="GT")
        scl_p, ctr_p = build_pileup(AlignmentReader(plain), table)
        scl_c, ctr_c = build_pileup(AlignmentReader(cgbam), table)
        assert scl_p.umis == scl_c.umis
        assert ctr_p == ctr_c
        assert len(scl_p.umis) > 0  # the workload actually covers SNPs

    def test_native_reader_restores_cg(self, tmp_path):
        native = pytest.importorskip("demuxlet_jax.native.ingest")
        if not native.available():
            pytest.skip("native ingest not built")
        vcf, plain = self._workload(tmp_path, cg=False)
        _, cgbam = self._workload(tmp_path, cg=True)
        table = load_snp_table(vcf, field_name="GT")
        csr_p, ctr_p = native.build_pileup(plain, table)
        csr_c, ctr_c = native.build_pileup(cgbam, table)
        np.testing.assert_array_equal(csr_p.obs_snp, csr_c.obs_snp)
        np.testing.assert_array_equal(csr_p.obs_allele, csr_c.obs_allele)
        np.testing.assert_array_equal(csr_p.obs_bq, csr_c.obs_bq)
        assert ctr_p == ctr_c
        assert len(csr_p.obs_snp) > 0
