"""GenomeLoci interval-set semantics (genomeLoci.h analog)."""

from demuxlet_jax.utils.intervals import (
    GenomeLoci,
    Locus,
    parse_region,
    plan_genome_chunks,
    read_fai,
)


def test_parse_region():
    assert parse_region("chr1:100-200") == Locus("chr1", 100, 200)
    assert parse_region("chr2:55") == Locus("chr2", 55, 55)
    assert parse_region("chrX").beg1 == 1


def test_merge_and_contains():
    g = GenomeLoci()
    g.add("chr1", 100, 200)
    g.add("chr1", 150, 300)
    g.add("chr1", 301, 400)  # adjacent -> merged
    g.add("chr1", 500, 600)
    g.add("chr2", 10, 20)
    assert len(g) == 3
    assert g.contains1("chr1", 100) and g.contains1("chr1", 400)
    assert not g.contains1("chr1", 450)
    assert g.overlaps("chr1", 420, 520)
    assert not g.overlaps("chr1", 420, 480)
    assert not g.overlaps("chr3", 1, 10)
    assert g.total_length() == (400 - 100 + 1) + 101 + 11


def test_chunk_planner(tmp_path):
    fai = tmp_path / "ref.fai"
    fai.write_text("chr1\t2500\t0\t60\t61\nchr2\t990\t0\t60\t61\n")
    chunks = plan_genome_chunks(read_fai(str(fai)), unit=1000)
    ls = list(chunks)
    assert ls == [
        Locus("chr1", 1, 1000), Locus("chr1", 1001, 2000),
        Locus("chr1", 2001, 2500), Locus("chr2", 1, 990),
    ]
    tgt = GenomeLoci()
    tgt.add_region("chr1:1500-1600")
    sel = list(plan_genome_chunks(read_fai(str(fai)), 1000, target=tgt))
    assert sel == [Locus("chr1", 1001, 2000)]
