"""Native C++ ingest parity vs the pure Python ingest on synthetic BAMs."""

import random

import numpy as np
import pytest

from demuxlet_jax.host.csr import CsrPileup, build_slots_csr
from demuxlet_jax.host.pileup import build_pileup
from demuxlet_jax.host.slots import build_slots
from demuxlet_jax.io.bam import AlignmentReader
from demuxlet_jax.io.vcf import load_snp_table
from fixtures import SimRead, SimVariant, random_workload, write_bam, write_vcf

native = pytest.importorskip("demuxlet_jax.native.ingest")

if not native.available():
    pytest.skip("native ingest not built", allow_module_level=True)


def _workload(tmp_path, seed=7, n_cells=25, n_snps=40, n_samples=3):
    rng = random.Random(seed)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=n_cells, n_snps=n_snps, n_samples=n_samples,
        reads_per_cell=60,
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    return bam, table


def _py_csr(bam, table, **kw):
    rdr = AlignmentReader(bam)
    scl, ctr = build_pileup(rdr, table, **kw)
    return CsrPileup.from_pileup(scl), ctr


def test_native_matches_python(tmp_path):
    bam, table = _workload(tmp_path)
    csr_n, ctr_n = native.build_pileup(bam, table)
    csr_p, ctr_p = _py_csr(bam, table)

    assert csr_n.barcodes == csr_p.barcodes
    np.testing.assert_array_equal(csr_n.cell_totl, csr_p.cell_totl)
    np.testing.assert_array_equal(csr_n.cell_pass, csr_p.cell_pass)
    np.testing.assert_array_equal(csr_n.cell_uniq, csr_p.cell_uniq)
    assert ctr_n == ctr_p

    # identical slot tensors for every cell block
    cells = list(range(csr_n.nbcs))
    bn = build_slots(csr_n, cells)
    bp = build_slots(csr_p, cells)
    np.testing.assert_array_equal(bn.idx, bp.idx)
    np.testing.assert_array_equal(bn.msk, bp.msk)
    np.testing.assert_array_equal(bn.cnt, bp.cnt)


def test_native_group_list(tmp_path):
    bam, table = _workload(tmp_path, seed=9)
    keep = {"BC%05d" % i for i in range(0, 25, 2)}
    csr_n, ctr_n = native.build_pileup(bam, table, group_set=keep)
    csr_p, ctr_p = _py_csr(bam, table, group_set=keep)
    assert csr_n.barcodes == csr_p.barcodes
    assert set(csr_n.barcodes) <= keep
    assert ctr_n == ctr_p
    np.testing.assert_array_equal(csr_n.cell_uniq, csr_p.cell_uniq)


def test_native_filters(tmp_path):
    bam, table = _workload(tmp_path, seed=11)
    kw = dict(min_bq=20, min_td=5, cap_bq=30, min_mq=30)
    csr_n, ctr_n = native.build_pileup(bam, table, **kw)
    rdr = AlignmentReader(bam, min_mq=30)
    scl, ctr_p = build_pileup(
        rdr, table, min_bq=20, min_td=5, cap_bq=30
    )
    csr_p = CsrPileup.from_pileup(scl)
    assert ctr_n == ctr_p
    cells = list(range(csr_n.nbcs))
    bn = build_slots(csr_n, cells)
    bp = build_slots(csr_p, cells)
    np.testing.assert_array_equal(bn.cnt, bp.cnt)


def test_csr_engine_same_output(tmp_path):
    """Engine over native CSR == engine over Python dict pileup."""
    from demuxlet_jax.models.engine import DemuxEngine

    bam, table = _workload(tmp_path, seed=13)
    csr_n, _ = native.build_pileup(bam, table)
    rdr = AlignmentReader(bam)
    scl, _ = build_pileup(rdr, table)
    eng = DemuxEngine(table.gps, [0.0, 0.5], cell_block=16)
    rn = eng.run(csr_n)
    rp = eng.run(scl)
    np.testing.assert_allclose(rn.llks, rp.llks, rtol=0, atol=0)
    np.testing.assert_allclose(rn.llk_ab, rp.llk_ab, rtol=0, atol=0)


def test_native_parallel_chrom_segments(tmp_path):
    """BAI-driven per-chromosome parallel scan == sequential Python ingest."""
    rng = random.Random(21)
    chroms = [("chr1", 20000), ("chr2", 20000), ("chr3", 20000)]
    variants, reads = [], []
    bases = ["A", "C", "G", "T"]
    names = ["S0", "S1"]
    genos = {}
    for ci, (ch, _) in enumerate(chroms):
        for k in range(15):
            p = 100 + k * 97
            ref, alt = rng.sample(bases, 2)
            svals = []
            for s in range(2):
                g = rng.choice([0, 1, 2])
                genos[(ch, p, s)] = g
                svals.append({"GT": ["0/0", "0/1", "1/1"][g]})
            variants.append(SimVariant(ch, p, ref, alt, svals))
    for ci, (ch, _) in enumerate(chroms):
        for j in range(120):
            p0 = rng.randrange(50, 1600)
            seq = "".join(rng.choice(bases) for _ in range(40))
            reads.append(
                SimRead(
                    chrom=ch, pos0=p0, seq=seq,
                    quals=[rng.randrange(20, 41) for _ in range(40)],
                    cb=f"BC{rng.randrange(6):03d}", ub=f"U{j}",
                )
            )
    vcf = write_vcf(str(tmp_path / "m.vcf"), names, variants,
                    contigs=chroms)
    bam = write_bam(str(tmp_path / "m.bam"), chroms, reads)
    import os.path
    assert os.path.exists(bam + ".bai")
    table = load_snp_table(vcf, field_name="GT")
    csr_n, ctr_n = native.build_pileup(bam, table, n_threads=4)
    csr_p, ctr_p = _py_csr(bam, table)
    assert csr_n.barcodes == csr_p.barcodes
    assert ctr_n == ctr_p
    np.testing.assert_array_equal(csr_n.cell_uniq, csr_p.cell_uniq)
    cells = list(range(csr_n.nbcs))
    bn = build_slots(csr_n, cells)
    bp = build_slots(csr_p, cells)
    np.testing.assert_array_equal(bn.idx, bp.idx)
    np.testing.assert_array_equal(bn.cnt, bp.cnt)


def test_native_adversarial_cigars_and_flags(tmp_path):
    """Edge battery: SNP at pos 0 and chromosome end, D/N/I/S/H spanning
    SNPs, excluded flags (unmapped/duplicate), low MQ, missing CB/UB tags —
    native must equal Python byte-for-byte."""
    from demuxlet_jax.host.csr import CsrPileup

    contigs = [("chr1", 50000)]
    names = ["S0", "S1"]
    variants = [
        SimVariant("chr1", p, "A", "G", [{"GT": "0/0"}, {"GT": "1/1"}])
        for p in (0, 100, 200, 49999)
    ]
    vcf = write_vcf(str(tmp_path / "adv.vcf"), names, variants, contigs=contigs)
    table = load_snp_table(vcf, field_name="GT")
    reads = [
        SimRead("chr1", 0, "AAAA", [30] * 4, cb="B0", ub="u0"),
        SimRead("chr1", 95, "A" * 10, [30] * 10, cigar="5M10D5M", cb="B0", ub="u1"),
        SimRead("chr1", 95, "A" * 10, [30] * 10, cigar="5M10N5M", cb="B1", ub="u2"),
        SimRead("chr1", 195, "CCCCGCCCCC", [30] * 10, cigar="4M2I4M", cb="B1", ub="u3"),
        SimRead("chr1", 198, "TTGAAA", [30] * 6, cigar="2S4M", cb="B2", ub="u4"),
        SimRead("chr1", 49995, "AAAAA", [30] * 5, cb="B2", ub="u5"),
        SimRead("chr1", 100, "AAAA", [30] * 4, flag=4, cb="B3", ub="u6"),
        SimRead("chr1", 100, "AAAA", [30] * 4, flag=1024, cb="B3", ub="u7"),
        SimRead("chr1", 100, "AAAA", [30] * 4, mapq=5, cb="B3", ub="u8"),
        SimRead("chr1", 200, "GAAA", [30] * 4, cigar="3H4M2H", cb="B4", ub="u9"),
        SimRead("chr1", 200, "GAAA", [30] * 4, cb=None, ub="u10"),
        SimRead("chr1", 200, "GAAA", [30] * 4, cb="B5", ub=None),
    ]
    bam = write_bam(str(tmp_path / "adv.bam"), contigs, reads)
    scl, ctr_p = build_pileup(AlignmentReader(bam), table)
    csr_p = CsrPileup.from_pileup(scl)
    csr_n, ctr_n = native.build_pileup(bam, table)
    assert csr_n.barcodes == csr_p.barcodes
    assert ctr_n == ctr_p
    cells = list(range(csr_p.nbcs))
    bp, bn = build_slots(csr_p, cells), build_slots(csr_n, cells)
    np.testing.assert_array_equal(bp.cnt, bn.cnt)
    np.testing.assert_array_equal(bp.idx, bn.idx)


def test_native_sam_verbose_notices(tmp_path, capfd):
    """--sam-verbose progress notices are emitted by the C++ scan in the
    reference's format (sam_filtered_reader.cpp:182-189)."""
    bam, table = _workload(tmp_path)
    native.build_pileup(bam, table, sam_verbose=100)
    err = capfd.readouterr().err
    assert "Reading " in err and " reads at " in err and "skipping" in err


def test_native_adversarial_umis_match_python(tmp_path):
    """Native UMI identity is a 64-bit FNV-1a hash of the string; this pins
    native == Python on adversarial UMI sets (shared prefixes/suffixes,
    transpositions, 1-char diffs, varying lengths) where any sloppy hashing
    (truncation, case folding, delimiter confusion) would collide."""
    rng = random.Random(11)
    umis = []
    base = "ACGTACGTAC"
    umis += [base[:k] for k in range(1, 11)]           # prefixes
    umis += [base[k:] for k in range(10)]              # suffixes
    umis += [base[:k] + "T" + base[k + 1:] for k in range(10)]  # 1-char diff
    umis += ["".join(rng.sample(base, 10)) for _ in range(20)]  # shuffles
    umis += ["A" * k for k in range(1, 12)]            # runs
    umis = list(dict.fromkeys(umis))

    pos = 500
    variants = [SimVariant("chr1", pos, "A", "C", [{"GT": "0/1"}])]
    reads = []
    for i, u in enumerate(umis):
        # two reads per UMI -> every UMI is a dedup candidate
        for j in range(2):
            reads.append(SimRead(
                "chr1", pos - 5, "G" * 5 + ("A" if i % 2 else "C") + "G" * 4,
                [30] * 10, cb="CB%02d" % (i % 4), ub=u,
            ))
    contigs = [("chr1", 10000)]
    vcf = write_vcf(str(tmp_path / "u.vcf"), ["S0"], variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "u.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")

    csr_n, ctr_n = native.build_pileup(bam, table)
    csr_p, ctr_p = _py_csr(bam, table)
    assert ctr_n == ctr_p  # same redundant/unique accounting
    assert csr_n.barcodes == csr_p.barcodes
    np.testing.assert_array_equal(csr_n.cell_uniq, csr_p.cell_uniq)
    cells = list(range(csr_n.nbcs))
    bn, bp = build_slots(csr_n, cells), build_slots(csr_p, cells)
    np.testing.assert_array_equal(bn.cnt, bp.cnt)


def _multi_chrom_workload(tmp_path, seed=19, n_chroms=3, index=True):
    rng = random.Random(seed)
    parts = []
    contigs = []
    for c in range(n_chroms):
        cg, names, variants, reads, truth = random_workload(
            random.Random(seed + c), n_cells=15, n_snps=25, n_samples=3,
            reads_per_cell=40, chrom=f"chr{c + 1}",
        )
        contigs.append((f"chr{c + 1}", cg[0][1]))
        parts.append((variants, reads))
    variants = [v for vs, _ in parts for v in vs]
    reads = [r for _, rs in parts for r in rs]
    vcf = write_vcf(str(tmp_path / "g.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "g.bam"), contigs, reads, index=index)
    return vcf, bam, contigs


def test_native_genome_region_shards_union(tmp_path):
    """BAI-seeked region ingest: N genome shards' pileups merge (obs concat,
    counters sum) to the unsharded pileup exactly."""
    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from demuxlet_jax.utils.intervals import split_genome_shards

    vcf, bam, contigs = _multi_chrom_workload(tmp_path)
    table = load_snp_table(vcf, field_name="GT")
    full, ctr_full = native.build_pileup(bam, table)

    shards = split_genome_shards(contigs, 4)
    assert len([r for s in shards for r in s]) >= 4
    totl = {}
    uniq = {}
    obs = {}
    nsnp_sum = 0
    for regs in shards:
        sub = filter_snp_table(table, regs)
        # zero-SNP shards must still work (and own nothing beyond their
        # regions' reads) — no skip
        csr, ctr = native.build_pileup(bam, sub, regions=regs)
        for i, b in enumerate(csr.barcodes):
            totl[b] = totl.get(b, 0) + int(csr.cell_totl[i])
            uniq[b] = uniq.get(b, 0) + int(csr.cell_uniq[i])
        # map shard SNP ids back to global ids by (chrom, pos)
        import numpy as np_

        sub_key = [(sub.chroms[k], int(sub.pos0[k])) for k in range(sub.nsnps)]
        glob = {(table.chroms[k], int(table.pos0[k])): k
                for k in range(table.nsnps)}
        for c in range(csr.nbcs):
            a, bnd = csr.cell_ptr[c], csr.cell_ptr[c + 1]
            for j in range(a, bnd):
                gk = glob[sub_key[int(csr.obs_snp[j])]]
                key = (csr.barcodes[c], gk, int(csr.obs_allele[j]),
                       int(csr.obs_bq[j]))
                obs[key] = obs.get(key, 0) + 1

    full_obs = {}
    for c in range(full.nbcs):
        a, bnd = full.cell_ptr[c], full.cell_ptr[c + 1]
        for j in range(a, bnd):
            key = (full.barcodes[c], int(full.obs_snp[j]),
                   int(full.obs_allele[j]), int(full.obs_bq[j]))
            full_obs[key] = full_obs.get(key, 0) + 1
    assert obs == full_obs
    for i, b in enumerate(full.barcodes):
        assert totl.get(b, 0) == int(full.cell_totl[i]), b
        assert uniq.get(b, 0) == int(full.cell_uniq[i]), b


def test_native_csi_index_fallback(tmp_path):
    """A BAM indexed only with .csi (no .bai — the only option for
    chromosomes >2^29 bp) drives both the parallel per-chromosome scan
    and the region-seeked genome-shard ingest identically to the BAI path
    (sam_filtered_reader.cpp via hts_idx_load reads either flavor)."""
    import os

    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from demuxlet_jax.utils.intervals import split_genome_shards

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    vcf, bam, contigs = _multi_chrom_workload(tmp_path / "a")
    _, bam_csi, _ = _multi_chrom_workload(tmp_path / "b", index="csi")
    assert os.path.exists(bam_csi + ".csi")
    assert not os.path.exists(bam_csi + ".bai")
    table = load_snp_table(vcf, field_name="GT")

    # parallel per-chromosome scan seeded from either index flavor
    want, ctr_want = native.build_pileup(bam, table, n_threads=4)
    got, ctr_got = native.build_pileup(bam_csi, table, n_threads=4)
    assert got.barcodes == want.barcodes
    assert ctr_got == ctr_want
    np.testing.assert_array_equal(got.obs_snp, want.obs_snp)
    np.testing.assert_array_equal(got.obs_bq, want.obs_bq)

    # region-seeked genome shards over the CSI file: union == full pileup
    shards = split_genome_shards(contigs, 3)
    totl = {}
    for regs in shards:
        sub = filter_snp_table(table, regs)
        csr, _ = native.build_pileup(bam_csi, sub, regions=regs)
        for i, b in enumerate(csr.barcodes):
            totl[b] = totl.get(b, 0) + int(csr.cell_totl[i])
    for i, b in enumerate(want.barcodes):
        assert totl.get(b, 0) == int(want.cell_totl[i]), b


def test_native_mid_chromosome_region_split(tmp_path):
    """Two shards splitting ONE chromosome mid-span: reads are owned by the
    region containing their start, observations partition by SNP position,
    and counter/observation unions equal the unsharded pileup exactly.
    Also covers the BAI linear-index region seek (fixtures write a .bai)."""
    import random

    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from fixtures import random_workload, write_bam, write_vcf

    rng = random.Random(23)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=12, n_snps=40, n_samples=3, reads_per_cell=50,
    )
    vcf = write_vcf(str(tmp_path / "m.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "m.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    full, _ = native.build_pileup(bam, table)

    chrom, ln = contigs[0]
    mid = int(table.pos0[table.nsnps // 2])  # boundary ON a SNP position
    shard_regs = [[(chrom, 1, mid)], [(chrom, mid + 1, ln)]]
    totl, uniq, obs = {}, {}, {}
    for regs in shard_regs:
        sub = filter_snp_table(table, regs)
        csr, _ = native.build_pileup(bam, sub, regions=regs)
        sub_key = [(sub.chroms[k], int(sub.pos0[k])) for k in range(sub.nsnps)]
        glob = {(table.chroms[k], int(table.pos0[k])): k
                for k in range(table.nsnps)}
        for i, b in enumerate(csr.barcodes):
            totl[b] = totl.get(b, 0) + int(csr.cell_totl[i])
            uniq[b] = uniq.get(b, 0) + int(csr.cell_uniq[i])
        for c in range(csr.nbcs):
            a, bnd = csr.cell_ptr[c], csr.cell_ptr[c + 1]
            for j in range(a, bnd):
                gk = glob[sub_key[int(csr.obs_snp[j])]]
                key = (csr.barcodes[c], gk, int(csr.obs_allele[j]),
                       int(csr.obs_bq[j]))
                obs[key] = obs.get(key, 0) + 1

    full_obs = {}
    for c in range(full.nbcs):
        a, bnd = full.cell_ptr[c], full.cell_ptr[c + 1]
        for j in range(a, bnd):
            key = (full.barcodes[c], int(full.obs_snp[j]),
                   int(full.obs_allele[j]), int(full.obs_bq[j]))
            full_obs[key] = full_obs.get(key, 0) + 1
    assert obs == full_obs
    for i, b in enumerate(full.barcodes):
        assert totl.get(b, 0) == int(full.cell_totl[i]), b
        assert uniq.get(b, 0) == int(full.cell_uniq[i]), b


def test_native_cram_crai_region_seek(tmp_path):
    """Genome-sharded ingest over a .crai-indexed multi-container CRAM:
    the seeked scan (visiting only containers overlapping each shard's
    regions) unions to the full-scan pileup exactly — the CRAM analog of
    the BAI/CSI region fetch (htslib cram_itr semantics)."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_cram import _genome

    from demuxlet_jax.io.vcf import filter_snp_table, load_snp_table
    from demuxlet_jax.utils.intervals import split_genome_shards
    from fixtures import SimRead, SimVariant, write_cram, write_vcf

    rng = random.Random(31)
    glen = 6000
    contigs, ref_seqs, variants, reads = [], {}, [], []
    names = ["S0", "S1", "S2"]
    for ci in range(3):
        ch = f"chr{ci + 1}"
        contigs.append((ch, glen))
        g = list(_genome(rng, glen))
        genome = "".join(g)
        ref_seqs[ch] = genome
        genos = []
        for p in sorted(rng.sample(range(100, glen - 100), 20)):
            ref = g[p]
            alt = rng.choice([b for b in "ACGT" if b != ref])
            row = [rng.choice([0, 1, 2]) for _ in names]
            genos.append((p, ref, alt, row))
            variants.append(SimVariant(ch, p, ref, alt,
                            [{"GT": ["0/0", "0/1", "1/1"][x]} for x in row]))
        for c in range(9):
            bc = "CB%04d" % c
            src = c % 3
            for j in range(30):
                p, ref, alt, row = genos[rng.randrange(len(genos))]
                start = max(0, p - rng.randrange(1, 40))
                ln = 50
                seq = list(genome[start : start + ln])
                if row[src] == 2 or (row[src] == 1 and rng.random() < 0.5):
                    seq[p - start] = alt
                reads.append(SimRead(
                    chrom=ch, pos0=start, seq="".join(seq),
                    quals=[rng.randrange(20, 41) for _ in range(ln)],
                    cb=bc, ub=f"{ch}U{j}c{c}",
                ))
    vcf = write_vcf(str(tmp_path / "c.vcf"), names, variants,
                    contigs=contigs)
    cram = write_cram(str(tmp_path / "c.cram"), contigs, reads, ref_seqs,
                      index=True)
    import os
    assert os.path.exists(cram + ".crai")
    table = load_snp_table(vcf, field_name="GT")
    full, ctr_full = native.build_pileup(cram, table)
    assert len(full.obs_snp)  # non-trivial workload

    shards = split_genome_shards(contigs, 3)
    totl, uniq = {}, {}
    for regs in shards:
        sub = filter_snp_table(table, regs)
        csr, _ = native.build_pileup(cram, sub, regions=regs)
        for i, b in enumerate(csr.barcodes):
            totl[b] = totl.get(b, 0) + int(csr.cell_totl[i])
            uniq[b] = uniq.get(b, 0) + int(csr.cell_uniq[i])
    for i, b in enumerate(full.barcodes):
        assert totl.get(b, 0) == int(full.cell_totl[i]), b
        assert uniq.get(b, 0) == int(full.cell_uniq[i]), b


@pytest.mark.parametrize("kw", [
    dict(method=0),
    dict(method=2),
    dict(method=3),
    dict(method=4, core_codecs=True, slices=2),
])
def test_native_cram_matches_python(tmp_path, kw):
    """Native C++ CRAM reader == Python CRAM reader == BAM pileup,
    including rANS blocks, core-bitstream codecs and multi-slice."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_cram import _workload

    from demuxlet_jax.host.csr import CsrPileup
    from demuxlet_jax.host.pileup import build_pileup as py_build
    from demuxlet_jax.host.slots import build_slots
    from demuxlet_jax.io.cram import CramReader
    from demuxlet_jax.io.vcf import load_snp_table

    vcf, bam, cram = _workload(tmp_path, seed=47, **kw)
    table = load_snp_table(vcf, field_name="GT")
    csr_n, ctr_n = native.build_pileup(cram, table)
    scl_p, ctr_p = py_build(CramReader(cram), table)
    csr_p = CsrPileup.from_pileup(scl_p)
    assert csr_n.barcodes == csr_p.barcodes
    assert ctr_n == ctr_p
    np.testing.assert_array_equal(csr_n.cell_totl, csr_p.cell_totl)
    np.testing.assert_array_equal(csr_n.cell_uniq, csr_p.cell_uniq)
    cells = list(range(csr_n.nbcs))
    bn, bp = build_slots(csr_n, cells), build_slots(csr_p, cells)
    np.testing.assert_array_equal(bn.idx, bp.idx)
    np.testing.assert_array_equal(bn.cnt, bp.cnt)


def _edge_csr(nv=3):
    """Hand-built CSR hitting every native-prep edge: an empty cell, an
    allele==2-only slot (254 marker), allele-2 HOLES between valid codes
    (the Python path leaves 255 at the dropped position; the C path
    compacts — multiset-equal), a slot-id delta > 255 (sparse fix), and
    BQ above the cap."""
    from demuxlet_jax.host.csr import CsrPileup

    obs = [
        # cell 0: snps 5 (2 umis), 6 (allele2 then valid: hole), 400 (fix)
        (0, 5, 0, 30), (0, 5, 1, 99), (0, 6, 2, 30), (0, 6, 1, 13),
        (0, 400, 0, 20),
        # cell 1: empty
        # cell 2: single allele2-only slot, then a normal one
        (2, 1, 2, 30), (2, 2, 0, 40),
    ]
    obs_cell = np.array([o[0] for o in obs], np.int64)
    obs_snp = np.array([o[1] for o in obs], np.int64)
    obs_al = np.array([o[2] for o in obs], np.int64)
    obs_bq = np.array([o[3] for o in obs], np.int64)
    n = 3
    z = np.zeros(n, np.int64)
    return CsrPileup.from_arrays(
        [f"S{i}" for i in range(nv)], 500, [f"BC{i}" for i in range(n)],
        z + 5, z + 5, z + 5, obs_cell, obs_snp, obs_al, obs_bq,
    )


def test_native_prep_matches_python():
    """Native single-pass prep == python build+shrink BIT-FOR-BIT:
    identical codes arrays (incl. 255 holes at dropped allele==2 lane
    positions and the U bucket), d8/base/fixes — so device results match
    exactly in both modes on any host."""
    from demuxlet_jax.host.csr import build_codes_block
    from demuxlet_jax.models.engine import DemuxEngine
    from demuxlet_jax.native import prep as nprep

    if not nprep.available():
        import pytest

        pytest.skip("native prep unavailable")
    csr = _edge_csr()
    gps = np.random.default_rng(0).dirichlet(np.ones(3), size=(500, 3))
    eng = DemuxEngine(gps, [0.0, 0.5], cell_block=32, mode="fast")
    cells = list(range(csr.nbcs))
    py = eng._shrink_codes_blk(
        build_codes_block(csr, cells, cap_bq=40, pad_cells_to=32)
    )
    nat = nprep.prep_block_shrunk(csr, cells, cap_bq=40, pad_cells_to=32)
    assert nat is not None
    pc, (pd8, pbase, pfp, pfv), pm = py
    nc, (nd8, nbase, nfp, nfv), nm = nat
    assert pm is None and nm is None
    assert pc.shape[:2] == nc.shape[:2]
    np.testing.assert_array_equal(pd8, nd8)
    np.testing.assert_array_equal(pbase, nbase)
    np.testing.assert_array_equal(pfp, nfp)
    np.testing.assert_array_equal(pfv, nfv)
    # the >255 delta must actually exercise the fix list
    assert pfv.max() > 0
    assert pc.shape == nc.shape  # same U bucket (holes preserved)
    np.testing.assert_array_equal(pc, nc)
    # 254 marker present for the allele2-only slot
    assert (nc[2] == 254).any()


def test_native_prep_engine_bytes(tmp_path):
    """Fast-mode run_compact with native prep == forced-Python prep,
    bit-identical packed decision rows and LLKs (the fast front counts
    codes, so compaction cannot change any bit)."""
    import random

    from demuxlet_jax.host.pileup import build_pileup
    from demuxlet_jax.io.bam import AlignmentReader
    from demuxlet_jax.io.vcf import load_snp_table
    from demuxlet_jax.models.engine import DemuxEngine
    from demuxlet_jax.native import prep as nprep
    from fixtures import random_workload, write_bam, write_vcf

    if not nprep.available():
        import pytest

        pytest.skip("native prep unavailable")
    rng = random.Random(13)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=20, n_snps=40, n_samples=3, reads_per_cell=60
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    scl, _ = build_pileup(AlignmentReader(bam), table)

    def run(force_py):
        import os as _os

        if force_py:
            _os.environ["DEMUX_NO_NATIVE_PREP"] = "1"
        # reset the module's load cache so the env var takes effect
        nprep._LIB, nprep._LOAD_FAILED = None, False
        try:
            eng = DemuxEngine(table.gps, [0.0, 0.5], cell_block=32,
                              mode="fast")
            return eng.run_compact(scl, doublet_prior=0.5)
        finally:
            _os.environ.pop("DEMUX_NO_NATIVE_PREP", None)
            nprep._LIB, nprep._LOAD_FAILED = None, False

    ln, l0n, cn = run(False)
    lp, l0p, cp = run(True)
    np.testing.assert_array_equal(ln, lp)
    np.testing.assert_array_equal(l0n, l0p)
    for f in cn.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(cn, f), getattr(cp, f))
