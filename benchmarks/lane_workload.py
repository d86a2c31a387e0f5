"""Seeded synthetic 10x-style lane: a BAM + GT VCF with planted donors.

A pooled lane of `n_cells` droplet barcodes over `n_donors` donors: most
cells are planted singlets, a `doublet_rate` share are alpha = 0.5
doublets of two distinct donors. Every cell covers `snps_per_cell` random
markers of the `n_snps`-marker panel with 1-2 UMIs per covered marker; each
UMI is one read whose base at the marker is drawn from the source donor's
genotype (a doublet read picks either donor with probability 1/2), with a
small base-error rate. Reads are 30M, one marker each (markers are spaced
wider than a read), CB/UB-tagged, coordinate-sorted.

Records are packed with numpy (every record has the same length) and
BGZF-compressed on a thread pool, so a ~7M-read lane takes seconds, not
the minutes of a per-read Python writer.

    lane = make_lane(out_dir, seed=0)
    lane.bam, lane.vcf, lane.truth  # truth: barcode -> (d1, d2), d1 == d2 singlet
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from demuxlet_jax.io.bgzf import BGZF_EOF, compress_block

READ_LEN = 30
SNP_OFFSET = 12  # marker position within the read
SPACING = 100  # bp between markers (> READ_LEN: one marker per read)
CHROM = "chr1"
_NT = np.frombuffer(b"ACGT", dtype=np.uint8)
_NT16 = {ord(c): i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


@dataclass
class Lane:
    bam: str
    vcf: str
    donors: list  # sample names
    barcodes: list  # cell barcodes, cell order
    truth: dict  # barcode -> (d1, d2) donor indices; d1 == d2 singlet
    # per-read arrays (cell, snp, allele 0/1/2, bq) for independent checks
    obs: tuple
    n_reads: int


def _ascii_digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n,) ints -> (n, width) uint8 zero-padded decimal ASCII."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // pw) % 10 + ord("0")).astype(np.uint8)


def _barcodes(n: int) -> np.ndarray:
    """(n, 18) uint8 ASCII 10x-style barcodes: 16 nt + '-1'."""
    pw = 4 ** np.arange(15, -1, -1, dtype=np.int64)
    idx = (np.arange(n, dtype=np.int64)[:, None] // pw) % 4
    tail = np.frombuffer(b"-1", dtype=np.uint8)
    return np.concatenate(
        [_NT[idx], np.broadcast_to(tail, (n, 2))], axis=1)


def _genotypes(rng, n_snps: int, n_donors: int) -> np.ndarray:
    """(n_snps, n_donors) 0/1/2 genotypes; every marker polymorphic in
    the pool (minor allele count >= 1, so the VCF loader keeps it)."""
    g = rng.choice(3, size=(n_snps, n_donors), p=[0.36, 0.48, 0.16])
    mono = (g == g[:, :1]).all(axis=1)
    g[mono, np.arange(n_snps)[mono] % n_donors] = 1
    return g.astype(np.int8)


def _write_vcf(path, donors, pos, ref, alt, geno):
    gt = np.array(["0/0", "0/1", "1/1"])[geno]
    head = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID={CHROM},length={int(pos[-1]) + 1000}>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(donors),
    ]
    refc = _NT[ref].view("S1").astype(str)
    altc = _NT[alt].view("S1").astype(str)
    rows = (f"{CHROM}\t{p + 1}\t.\t{r}\t{a}\t.\tPASS\t.\tGT\t" + "\t".join(g)
            for p, r, a, g in zip(pos.tolist(), refc, altc, gt.tolist()))
    with open(path, "w") as fh:
        fh.write("\n".join(head) + "\n")
        fh.write("\n".join(rows) + "\n")


def _bam_records(cell, snp, allele_base, bq, pos, barcodes):
    """Fixed-length BAM records for reads sorted by position."""
    n = len(cell)
    name_w, umi_w = 10, 10
    rec_len = (36 + (name_w + 1) + 4 + (READ_LEN + 1) // 2 + READ_LEN
               + (3 + 18 + 1) + (3 + umi_w + 1))
    dt = np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
        ("name", "u1", (name_w + 1,)), ("cigar", "<u4"),
        ("seq", "u1", ((READ_LEN + 1) // 2,)), ("qual", "u1", (READ_LEN,)),
        ("cb_tag", "u1", (3,)), ("cb", "u1", (18,)), ("cb_nul", "u1"),
        ("ub_tag", "u1", (3,)), ("ub", "u1", (umi_w,)), ("ub_nul", "u1"),
    ])
    assert dt.itemsize == rec_len
    r = np.zeros(n, dtype=dt)
    r["block_size"] = rec_len - 4
    r["pos"] = pos[snp] - SNP_OFFSET
    r["l_name"] = name_w + 1
    r["mapq"] = 60
    r["n_cigar"] = 1
    r["l_seq"] = READ_LEN
    r["next_ref"] = -1
    r["next_pos"] = -1
    r["name"][:, :name_w] = _ascii_digits(np.arange(n), name_w)
    r["cigar"] = (READ_LEN << 4) | 0  # READ_LENM
    # read bases: a fixed filler with the marker's base at SNP_OFFSET
    bases = np.full((n, READ_LEN + READ_LEN % 2), ord("A"), np.uint8)
    bases[:, SNP_OFFSET] = allele_base
    codes = np.array([_NT16.get(i, 15) for i in range(256)], np.uint8)
    nib = codes[bases]
    r["seq"] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    r["qual"] = 30
    r["qual"][:, SNP_OFFSET] = bq
    r["cb_tag"] = np.frombuffer(b"CBZ", np.uint8)
    r["cb"] = barcodes[cell]
    r["ub_tag"] = np.frombuffer(b"UBZ", np.uint8)
    r["ub"][:, 0] = ord("U")
    r["ub"][:, 1:] = _ascii_digits(np.arange(n), umi_w - 1)
    return r


def _write_bam(path, records, contig_len, threads=8):
    header_text = (f"@HD\tVN:1.6\tSO:coordinate\n"
                   f"@SQ\tSN:{CHROM}\tLN:{contig_len}\n").encode()
    name = CHROM.encode() + b"\x00"
    head = (b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
            + struct.pack("<i", 1) + struct.pack("<i", len(name)) + name
            + struct.pack("<i", contig_len))
    raw = memoryview(head + records.tobytes())
    blk = 65280
    chunks = [raw[i:i + blk] for i in range(0, len(raw), blk)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        comp = list(pool.map(lambda c: compress_block(bytes(c), level=1),
                             chunks))
    with open(path, "wb") as fh:
        for c in comp:
            fh.write(c)
        fh.write(BGZF_EOF)
    # minimal .bai: one linear-index entry (the first record's offset)
    u = len(head)
    voff = (sum(len(c) for c in comp[: u // blk]) << 16) | (u % blk)
    with open(path + ".bai", "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", 1) + struct.pack("<i", 0)
                 + struct.pack("<i", 1) + struct.pack("<Q", voff))


def make_lane(out_dir, n_cells=10_000, n_donors=8, n_snps=50_000,
              snps_per_cell=500, doublet_rate=0.1, base_error=0.005,
              seed=0, prefix="lane") -> Lane:
    """Write <out_dir>/<prefix>.bam(+.bai) and .vcf; return the Lane."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    donors = [f"D{i}" for i in range(n_donors)]
    pos = (1000 + SPACING * np.arange(n_snps)).astype(np.int64)
    ref = rng.integers(0, 4, size=n_snps)
    alt = (ref + rng.integers(1, 4, size=n_snps)) % 4
    geno = _genotypes(rng, n_snps, n_donors)
    vcf = os.path.join(out_dir, prefix + ".vcf")
    _write_vcf(vcf, donors, pos, ref, alt, geno)

    # planted identities: singlets, and alpha = 0.5 doublets of 2 donors
    d1 = rng.integers(0, n_donors, size=n_cells)
    dbl = rng.random(n_cells) < doublet_rate if n_donors > 1 else \
        np.zeros(n_cells, bool)
    d2 = d1.copy()
    d2[dbl] = (d1[dbl] + rng.integers(1, n_donors, size=dbl.sum())) \
        % n_donors

    # covered markers and UMIs: 1-2 reads (UMIs) per covered marker
    cs = np.repeat(np.arange(n_cells), snps_per_cell)
    ss = rng.integers(0, n_snps, size=n_cells * snps_per_cell)
    reps = 1 + (rng.random(len(cs)) < 0.5)
    cell = np.repeat(cs, reps)
    snp = np.repeat(ss, reps)
    src = np.where(rng.random(len(cell)) < 0.5, d1[cell], d2[cell])
    p_alt = geno[snp, src] / 2.0
    allele = (rng.random(len(cell)) < p_alt).astype(np.int8)
    base = np.where(allele == 1, alt[snp], ref[snp])
    err = rng.random(len(cell)) < base_error
    base[err] = (base[err] + rng.integers(1, 4, size=err.sum())) % 4
    allele = np.where(err, np.where(base == ref[snp], 0,
                                    np.where(base == alt[snp], 1, 2)),
                      allele).astype(np.int8)
    bq = rng.integers(25, 41, size=len(cell)).astype(np.uint8)

    order = np.argsort(snp, kind="stable")
    cell, snp, base, allele, bq = (a[order] for a in
                                   (cell, snp, base, allele, bq))
    barcodes = _barcodes(n_cells)
    recs = _bam_records(cell, snp, _NT[base], bq, pos, barcodes)
    bam = os.path.join(out_dir, prefix + ".bam")
    _write_bam(bam, recs, int(pos[-1]) + 1000)
    bc = [b.tobytes().decode() for b in barcodes]
    truth = {bc[c]: (int(d1[c]), int(d2[c])) for c in range(n_cells)}
    return Lane(bam=bam, vcf=vcf, donors=donors, barcodes=bc, truth=truth,
                obs=(cell, snp, allele, bq), n_reads=len(cell))


def oracle_llks(obs, gps, cells, grid_alpha):
    """NumPy-oracle LLKs (oracle/numpy_oracle.py) of the given cells,
    from the generator's own per-read record `obs` — independent of the
    BAM ingest and of JAX (safe in a worker process). gps: the loaded
    VCF's (n_snps, V, 3) table, whose marker order is the generator's.
    Returns (llks (n,V), llk0s (n,), llk_ab (n,V,V,A), llk_00 (n,A))."""
    from oracle.numpy_oracle import (
        PileupData,
        compute_gp0s,
        pass1_singlet,
        pass2_cell,
    )

    cell, snp, allele, bq = obs
    scl = PileupData([f"D{i}" for i in range(gps.shape[1])], list(gps))
    slot = {}
    for c in cells:
        slot[int(c)] = scl.add_cell("C%d" % c)
    for i in np.nonzero(np.isin(cell, cells))[0]:
        k = slot[int(cell[i])]
        scl.cell_totl[k] += 1
        scl.add_read(int(snp[i]), k, "U%09d" % i, int(allele[i]),
                     int(bq[i]))
    gp0s = compute_gp0s(scl)
    llks, llk0s = pass1_singlet(scl, gp0s)
    ab, z0 = [], []
    for k in range(len(cells)):
        a, _, z = pass2_cell(scl, gp0s, k, grid_alpha)
        ab.append(a)
        z0.append(z)
    return (np.asarray(llks), np.asarray(llk0s), np.stack(ab),
            np.stack(z0))
