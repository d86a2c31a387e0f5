"""CRAM spec-fuzz roundtrip harness (VERDICT r2 #6).

All other CRAM coverage writes fixtures with tests/fixtures.py::write_cram
and reads them back with io/cram.py + native/cram_reader.inc — a SHARED
misreading of the CRAM 3.0 spec between writer and readers would be
invisible. No htslib/samtools exists in this sandbox (README), so the
strongest available substitutes are:

  1. a randomized fuzz over codec x encoding x feature x multi-slice
     combinations, asserting the CRAM decode is SEMANTICALLY equal to the
     BAM twin of the same reads through the pileup primitive
     (base_qual_at — the only surface demuxlet consumes;
     /root/reference/hts_utils.cpp:279-359), record by record;
  2. the same fuzz through the full pileup for the native C++ reader;
  3. hand-transcribed byte-level fixtures for the ITF8/LTF8 varints from
     the CRAM 3.0 spec §2.3 (incl. the 5-byte low-nibble quirk), decoded
     with io/cram.py's _Buf directly — these bytes come from the spec
     text, not from this repo's writer.

Reference analog: the htslib `cram_*` behavioral surface of
/root/reference/sam_filtered_reader.cpp.
"""

import random

import numpy as np
import pytest

from demuxlet_jax.io.bam import AlignmentReader
from demuxlet_jax.io.cram import CramReader, _Buf
from fixtures import SimRead, SimVariant, write_bam, write_cram, write_vcf

BASES = "ACGT"


def _genome(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def _random_cigar_read(rng, chrom, genome, max_start):
    """A read with a random CIGAR over M/S/I/D/N (+ rare H/P), bases
    consistent with the genome except random substitutions in M runs."""
    pos0 = rng.randrange(max_start)
    segs = []  # (op, len)
    if rng.random() < 0.3:
        segs.append(("H", rng.randrange(1, 5)))
    if rng.random() < 0.35:
        segs.append(("S", rng.randrange(1, 8)))
    n_m = rng.randrange(1, 4)
    for i in range(n_m):
        segs.append(("M", rng.randrange(5, 30)))
        if i < n_m - 1:
            op = rng.choice("IDNP")
            ln = rng.randrange(1, 6)
            segs.append((op, ln))
    if rng.random() < 0.35:
        segs.append(("S", rng.randrange(1, 8)))
    if rng.random() < 0.2:
        segs.append(("H", rng.randrange(1, 5)))

    seq, gpos = [], pos0
    for op, ln in segs:
        if op == "M":
            for o in range(ln):
                rb = genome[gpos + o]
                seq.append(rb if rng.random() < 0.85
                           else rng.choice([b for b in BASES if b != rb]))
            gpos += ln
        elif op in ("S", "I"):
            seq.extend(rng.choice(BASES) for _ in range(ln))
        elif op in ("D", "N"):
            gpos += ln
        # H/P consume nothing
    seq = "".join(seq)
    cig = "".join(f"{ln}{op}" for op, ln in segs)
    has_cb = rng.random() < 0.9
    return SimRead(
        chrom=chrom, pos0=pos0, seq=seq,
        quals=[rng.randrange(2, 42) for _ in range(len(seq))],
        cigar=cig,
        cb=f"FZ{rng.randrange(6):03d}" if has_cb else None,
        ub=f"u{rng.randrange(10000)}" if rng.random() < 0.95 else None,
        mapq=rng.choice([0, 10, 30, 60]),
        flag=rng.choice([0, 16]),
    )


def _fuzz_files(tmp_path, seed):
    """Same random reads written as CRAM (random codec combo) and BAM."""
    rng = random.Random(seed)
    contigs = [("chrA", 700), ("chrB", 500)]
    ref_seqs = {c: _genome(rng, ln) for c, ln in contigs}
    reads = []
    for _ in range(rng.randrange(12, 30)):
        chrom, ln = rng.choice(contigs)
        reads.append(_random_cigar_read(rng, chrom, ref_seqs[chrom],
                                        ln - 160))
    order = {c: i for i, (c, _) in enumerate(contigs)}
    reads.sort(key=lambda r: (order[r.chrom], r.pos0))
    kw = dict(
        method=rng.choice([0, 1, 2, 4]),
        core_codecs=rng.random() < 0.5,
        slices=rng.choice([1, 2, 3]),
        index=rng.random() < 0.3,
        b_features=rng.random() < 0.4,
    )
    cram = write_cram(str(tmp_path / f"f{seed}.cram"), contigs, reads,
                      ref_seqs, **kw)
    bam = write_bam(str(tmp_path / f"f{seed}.bam"), contigs, reads)
    return cram, bam, contigs, ref_seqs, kw


@pytest.mark.parametrize("seed", range(50))
def test_cram_fuzz_semantics_vs_bam_twin(tmp_path, seed):
    """Record-by-record: the CRAM decode must agree with the BAM twin on
    every field demuxlet consumes — position, mapq, flag, endpos, CB/UB
    tags, and (base, qual, read-offset) at EVERY genomic position the
    read touches (the pileup primitive)."""
    cram, bam, contigs, ref_seqs, kw = _fuzz_files(tmp_path, seed)
    chrom_of = {i: c for i, (c, _) in enumerate(contigs)}
    creads = list(CramReader(cram).records())
    breads = list(AlignmentReader(bam).records())
    assert len(creads) == len(breads), kw
    for rc, rb in zip(creads, breads):
        ctx = (seed, kw, rb.pos)
        assert (rc.tid, rc.pos, rc.mapq, rc.flag) == (
            rb.tid, rb.pos, rb.mapq, rb.flag), ctx
        assert rc.endpos() == rb.endpos(), ctx
        assert rc.tags.get("CB") == rb.tags.get("CB"), ctx
        assert rc.tags.get("UB") == rb.tags.get("UB"), ctx
        genome = ref_seqs[chrom_of[rb.tid]]
        for gpos in range(max(rb.pos - 2, 0),
                          min(rb.endpos() + 2, len(genome))):
            got = rc.base_qual_at(gpos, ref_base=genome[gpos])
            want = rb.base_qual_at(gpos, ref_base=genome[gpos])
            if want[2] == -1:
                # non-informative position: the pileup skips it; the
                # sentinel BASE char is never consumed (the reference
                # itself returns 'N' or '.' depending on the branch,
                # hts_utils.cpp:287,352)
                assert got[2] == -1, (*ctx, gpos)
            else:
                assert got == want, (*ctx, gpos)


@pytest.mark.parametrize("seed", range(100, 106))
def test_cram_fuzz_native_pileup(tmp_path, seed):
    """The native C++ CRAM reader through the full pileup, against the
    Python CRAM reader AND the BAM twin, per fuzzed codec combo."""
    native = pytest.importorskip("demuxlet_jax.native.ingest")
    if not native.available():
        pytest.skip("native ingest not built")
    from demuxlet_jax.host.csr import CsrPileup
    from demuxlet_jax.host.pileup import build_pileup
    from demuxlet_jax.io.vcf import load_snp_table

    rng = random.Random(seed)
    cram, bam, contigs, ref_seqs, kw = _fuzz_files(tmp_path, seed)
    names = [f"S{i}" for i in range(3)]
    variants = []
    for chrom, ln in contigs:
        for p in sorted(rng.sample(range(50, ln - 50), 12)):
            ref = ref_seqs[chrom][p]
            alt = rng.choice([b for b in BASES if b != ref])
            variants.append(SimVariant(
                chrom, p, ref, alt,
                [{"GT": rng.choice(["0/0", "0/1", "1/1"])}
                 for _ in names]))
    vcf = write_vcf(str(tmp_path / "f.vcf"), names, variants,
                    contigs=contigs)
    table = load_snp_table(vcf, field_name="GT")

    csr_n, ctr_n = native.build_pileup(cram, table)
    scl_c, ctr_c = build_pileup(CramReader(cram), table)
    scl_b, ctr_b = build_pileup(AlignmentReader(bam), table)
    csr_c = CsrPileup.from_pileup(scl_c)
    csr_b = CsrPileup.from_pileup(scl_b)
    assert ctr_n == ctr_c, kw
    assert csr_n.barcodes == csr_c.barcodes == csr_b.barcodes, kw
    def canon_obs(csr, cell):
        """Within-cell observations as a SORTED multiset of
        (snp, allele, bq) — obs order inside a (cell, snp) group is UMI
        insertion order, which is reader-internal and semantically
        irrelevant (the likelihood is a product over obs)."""
        a, b = csr.cell_ptr[cell], csr.cell_ptr[cell + 1]
        return sorted(zip(csr.obs_snp[a:b], csr.obs_allele[a:b],
                          csr.obs_bq[a:b]))

    for a, b in ((csr_n, csr_c), (csr_c, csr_b)):
        np.testing.assert_array_equal(a.cell_totl, b.cell_totl)
        np.testing.assert_array_equal(a.cell_uniq, b.cell_uniq)
        np.testing.assert_array_equal(a.cell_ptr, b.cell_ptr)
        for cell in range(a.nbcs):
            assert canon_obs(a, cell) == canon_obs(b, cell), (kw, cell)


# ---- hand-transcribed byte fixtures: CRAM 3.0 spec §2.3 varints ----
# (value, encoded bytes) pairs written out from the spec's encoding
# rules by hand, NOT produced by this repo's writer. The 5-byte ITF8
# form stores only the LOW 4 bits of the final byte (total 4+8+8+8+4
# = 32 bits) — the classic interop quirk.
ITF8_SPEC = [
    (0, b"\x00"),
    (1, b"\x01"),
    (127, b"\x7f"),
    (128, b"\x80\x80"),  # 10xxxxxx + 1 byte: (0x00<<8)|0x80
    (1337, b"\x85\x39"),  # 0x8000 | 1337
    (16383, b"\xbf\xff"),  # max 2-byte (14 bits)
    (16384, b"\xc0\x40\x00"),  # 110xxxxx + 2 bytes
    (2097151, b"\xdf\xff\xff"),  # max 3-byte (21 bits)
    (2097152, b"\xe0\x20\x00\x00"),  # 1110xxxx + 3 bytes
    (268435455, b"\xef\xff\xff\xff"),  # max 4-byte (28 bits)
    # 5-byte: 1111 + top4 | next 8 | next 8 | next 8 | LOW 4 of last
    (268435456, b"\xf1\x00\x00\x00\x00"),  # 0x10000000
    (0x7FFFFFFF, b"\xf7\xff\xff\xff\x0f"),
    (-1, b"\xff\xff\xff\xff\x0f"),  # 0xFFFFFFFF, signed reads as -1
]

LTF8_SPEC = [
    (0, b"\x00"),
    (127, b"\x7f"),
    (128, b"\x80\x80"),  # 10xxxxxx + 1 byte
    (255, b"\x80\xff"),
    (65535, b"\xc0\xff\xff"),  # 110xxxxx + 2 bytes
    (1 << 24, b"\xe1\x00\x00\x00"),  # 1110xxxx + 3 bytes
    (1 << 32, b"\xf1\x00\x00\x00\x00"),  # 11110xxx + 4 bytes
    ((1 << 40) - 1, b"\xf8\xff\xff\xff\xff\xff"),  # 111110xx + 5 bytes
    (1 << 56, b"\xff\x01\x00\x00\x00\x00\x00\x00\x00"),  # 8 ext bytes
]


@pytest.mark.parametrize("value,enc", ITF8_SPEC,
                         ids=[str(v) for v, _ in ITF8_SPEC])
def test_itf8_spec_bytes(value, enc):
    b = _Buf(enc)
    got = b.itf8_signed() if value < 0 else b.itf8()
    assert got == value
    assert b.o == len(enc), "decoder consumed the wrong byte count"


@pytest.mark.parametrize("value,enc", LTF8_SPEC,
                         ids=[str(v) for v, _ in LTF8_SPEC])
def test_ltf8_spec_bytes(value, enc):
    b = _Buf(enc)
    assert b.ltf8() == value
    assert b.o == len(enc), "decoder consumed the wrong byte count"
