"""Parser robustness: truncated/corrupted inputs fail cleanly (DemuxError or
a builtin parse exception), never hang or segfault."""

import random

import pytest

from demuxlet_jax.io.bcf import BcfReader
from demuxlet_jax.io.cram import CramReader
from demuxlet_jax.io.vcf import load_snp_table
from demuxlet_jax.utils.logging_utils import DemuxError
from fixtures import SimVariant, write_bcf, write_cram, write_vcf, SimRead


def _consume(reader):
    for _ in reader:
        pass


def test_truncated_bcf(tmp_path):
    names = ["S0", "S1"]
    variants = [
        SimVariant("chr1", 100 + i * 10, "A", "C",
                   [{"GT": "0/1"}, {"GT": "0/0"}]) for i in range(10)
    ]
    path = write_bcf(str(tmp_path / "x.bcf"), names, variants,
                     contigs=[("chr1", 10000)], fmt_keys=["GT"])
    raw = open(path, "rb").read()
    import gzip

    plain = gzip.decompress(raw)
    for cut in (len(plain) - 3, len(plain) // 2, 40):
        from demuxlet_jax.io.bgzf import BgzfWriter

        p2 = str(tmp_path / f"cut{cut}.bcf")
        with BgzfWriter(open(p2, "wb")) as w:
            w.write(plain[:cut])
        # either a clean error, or graceful early EOF with fewer records
        try:
            t = load_snp_table(p2, field_name="GT")
            assert t.nsnps < 10
        except (DemuxError, Exception):
            pass


def test_corrupt_cram_bytes(tmp_path):
    rng = random.Random(0)
    genome = "".join(rng.choice("ACGT") for _ in range(2000))
    reads = [
        SimRead("chr1", 50 + 10 * i, genome[50 + 10 * i : 90 + 10 * i],
                [30] * 40, cb="B0", ub=f"u{i}")
        for i in range(20)
    ]
    path = write_cram(str(tmp_path / "c.cram"), [("chr1", 2000)], reads,
                      {"chr1": genome})
    raw = bytearray(open(path, "rb").read())
    # truncations and byte flips must raise cleanly, not hang
    for cut in (len(raw) - 5, len(raw) // 2, 30):
        p2 = str(tmp_path / f"cut{cut}.cram")
        open(p2, "wb").write(bytes(raw[:cut]))
        try:
            _consume(CramReader(p2))
        except (DemuxError, IndexError, ValueError, struct_error_types):
            pass

    rng2 = random.Random(1)
    for trial in range(10):
        mut = bytearray(raw)
        for _ in range(5):
            mut[rng2.randrange(30, len(mut))] = rng2.randrange(256)
        p2 = str(tmp_path / f"mut{trial}.cram")
        open(p2, "wb").write(bytes(mut))
        try:
            _consume(CramReader(p2))
        except (DemuxError, Exception):
            pass  # any clean exception is acceptable; hangs are not


import struct

struct_error_types = struct.error


def test_garbage_magic(tmp_path):
    p = str(tmp_path / "g.cram")
    open(p, "wb").write(b"NOPE" * 10)
    with pytest.raises(DemuxError):
        CramReader(p)
    p2 = str(tmp_path / "g.bcf")
    from demuxlet_jax.io.bgzf import BgzfWriter

    with BgzfWriter(open(p2, "wb")) as w:
        w.write(b"JUNKJUNKJUNK")
    with pytest.raises(DemuxError):
        BcfReader(p2)


def test_corrupt_bam_bgzf_native(tmp_path):
    """Byte-flipped BGZF payloads in a BAM fail cleanly through the native
    ingest (libdeflate or zlib path) — DemuxError, never a crash/hang."""
    from fixtures import random_workload, write_bam, write_vcf
    from demuxlet_jax.io.vcf import load_snp_table
    from demuxlet_jax.native import ingest as native

    if not native.available():
        pytest.skip("native ingest unavailable")
    rng = random.Random(3)
    contigs, names, variants, reads, _ = random_workload(
        rng, n_cells=8, n_snps=20, n_samples=2, reads_per_cell=30)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    raw = bytearray(open(bam, "rb").read())
    rng2 = random.Random(4)
    for trial in range(6):
        mut = bytearray(raw)
        # flip bytes inside the compressed payloads (past the first
        # header block region)
        for _ in range(8):
            mut[rng2.randrange(60, len(mut) - 30)] ^= 0xFF
        p2 = str(tmp_path / f"mut{trial}.bam")
        open(p2, "wb").write(bytes(mut))
        try:
            native.build_pileup(p2, table)  # harmless decode is fine...
        except DemuxError:
            pass  # ...and so is the CLEAN error; any other type fails
