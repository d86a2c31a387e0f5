"""Synthetic SAM/BAM/VCF fixture generators for unit and e2e tests.

These build small, fully-specified inputs (known CIGARs, barcodes, UMIs,
genotypes) so pileup and likelihood semantics can be pinned without large
data, per SURVEY.md §4.
"""

from __future__ import annotations

import random
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from demuxlet_jax.io.bgzf import BgzfWriter

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"


@dataclass
class SimRead:
    chrom: str
    pos0: int
    seq: str
    quals: List[int]  # phred values
    cigar: str = ""  # e.g. "50M"; default: len(seq)M
    cb: Optional[str] = None
    ub: Optional[str] = None
    mapq: int = 60
    flag: int = 0
    name: str = "r"

    def cigar_str(self) -> str:
        return self.cigar or f"{len(self.seq)}M"


@dataclass
class SimVariant:
    chrom: str
    pos0: int
    ref: str
    alt: str
    # per-sample fields: list of dicts like {"GT": "0/1", "GP": "0.1,0.8,0.1"}
    samples: List[dict] = field(default_factory=list)
    qual: str = "100"
    filt: str = "PASS"


def write_vcf(
    path: str,
    sample_names: List[str],
    variants: List[SimVariant],
    contigs: Optional[List[Tuple[str, int]]] = None,
    fmt_keys: Optional[List[str]] = None,
) -> str:
    lines = ["##fileformat=VCFv4.2"]
    if contigs:
        for name, ln in contigs:
            lines.append(f"##contig=<ID={name},length={ln}>")
    lines.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    lines.append('##FORMAT=<ID=GP,Number=G,Type=Float,Description="Posterior">')
    lines.append('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred GL">')
    lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_names)
    )
    for v in variants:
        keys = fmt_keys or sorted({k for s in v.samples for k in s})
        fmt = ":".join(keys)
        cols = [
            v.chrom,
            str(v.pos0 + 1),
            ".",
            v.ref,
            v.alt,
            v.qual,
            v.filt,
            ".",
            fmt,
        ]
        for s in v.samples:
            cols.append(":".join(s.get(k, ".") for k in keys))
        lines.append("\t".join(cols))
    text = "\n".join(lines) + "\n"
    if path.endswith(".gz"):
        with BgzfWriter(open(path, "wb")) as w:
            w.write(text.encode())
    else:
        with open(path, "w") as fh:
            fh.write(text)
    return path


def write_tabix(vcf_gz_path: str, contigs: List[Tuple[str, int]]) -> str:
    """Minimal .tbi for a BGZF VCF written by write_vcf: one linear-index
    entry per contig pointing at its first data record's virtual offset
    (no bins), enough for VcfReader.iter_regions' seek + scan-to-end."""
    import gzip as _gzip
    import struct as _struct

    from demuxlet_jax.io.bgzf import read_block_at

    # block table (file offset, uncompressed start) + full text, then map
    # each chromosome's first data-line uncompressed offset to a voff
    blocks = []  # (file_off, u_start)
    parts = []
    u = 0
    with open(vcf_gz_path, "rb") as fh:
        while True:
            coff = fh.tell()
            b = read_block_at(fh)
            if b is None:
                break
            blocks.append((coff, u))
            parts.append(b)
            u += len(b)
    text = b"".join(parts)

    def voff_of(uoff: int) -> int:
        bi = max(i for i in range(len(blocks)) if blocks[i][1] <= uoff)
        coff, ustart = blocks[bi]
        return (coff << 16) | (uoff - ustart)

    first_voff = {}
    off = 0
    for line in text.split(b"\n"):
        if line and not line.startswith(b"#"):
            chrom = line.split(b"\t", 1)[0].decode()
            if chrom not in first_voff:
                first_voff[chrom] = voff_of(off)
        off += len(line) + 1
    names = [n for n, _ in contigs]
    blob = b"TBI\x01" + _struct.pack("<i", len(names))
    blob += _struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0)
    nm = b"".join(n.encode() + b"\x00" for n in names)
    blob += _struct.pack("<i", len(nm)) + nm
    for n in names:
        blob += _struct.pack("<i", 0)  # n_bin
        if n in first_voff:
            blob += _struct.pack("<i", 1) + _struct.pack(
                "<Q", first_voff[n]
            )
        else:
            blob += _struct.pack("<i", 0)
    out = vcf_gz_path + ".tbi"
    with _gzip.open(out, "wb") as fh:
        fh.write(blob)
    return out


def write_sam(
    path: str, contigs: List[Tuple[str, int]], reads: List[SimRead]
) -> str:
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    for name, ln in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
    for i, r in enumerate(reads):
        tags = []
        if r.cb is not None:
            tags.append(f"CB:Z:{r.cb}")
        if r.ub is not None:
            tags.append(f"UB:Z:{r.ub}")
        qual = "".join(chr(q + 33) for q in r.quals)
        cols = [
            f"{r.name}{i}",
            str(r.flag),
            r.chrom,
            str(r.pos0 + 1),
            str(r.mapq),
            r.cigar_str(),
            "*",
            "0",
            "0",
            r.seq,
            qual,
        ] + tags
        lines.append("\t".join(cols))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _encode_cigar(cig: str) -> List[int]:
    out = []
    num = ""
    for ch in cig:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | CIGAR_OPS.index(ch))
            num = ""
    return out


def write_bam(
    path: str,
    contigs: List[Tuple[str, int]],
    reads: List[SimRead],
    index=True,
    cg_tags: bool = False,
) -> str:
    """Minimal spec-compliant BAM writer (BGZF-compressed).

    cg_tags=True emits every record in the long-CIGAR form: the CIGAR
    field holds the dummy `l_seqS spanN` pair and the real CIGAR rides in
    a CG:B,I aux tag (the BAM encoding for >65535 ops, restored
    transparently by htslib — and by this repo's readers).

    Sorts records by (tid, pos) and, with index=True (or "bai"), writes a
    minimal .bai (no bins, one linear-index entry per covered reference)
    sufficient for the native ingest's per-chromosome segment
    partitioning; index="csi" instead writes a minimal CSI (min_shift=14,
    depth=5, one leaf bin per covered reference, BGZF-compressed) to
    exercise the CSI fallback."""
    ref_index = {name: i for i, (name, _) in enumerate(contigs)}
    reads = sorted(reads, key=lambda r: (ref_index[r.chrom], r.pos0))
    header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in contigs
    )
    buf = bytearray()
    buf += b"BAM\x01"
    ht = header_text.encode()
    buf += struct.pack("<i", len(ht)) + ht
    buf += struct.pack("<i", len(contigs))
    for name, ln in contigs:
        nb = name.encode() + b"\x00"
        buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    first_uoff = {}  # ref id -> uncompressed offset of its first record
    for i, r in enumerate(reads):
        first_uoff.setdefault(ref_index[r.chrom], len(buf))
        rec = bytearray()
        name = f"{r.name}{i}".encode() + b"\x00"
        cig = _encode_cigar(r.cigar_str())
        l_seq = len(r.seq)
        cg_payload = None
        if cg_tags:
            span = sum(
                c >> 4 for c in cig if (c & 0xF) in (0, 2, 3, 7, 8)
            )
            cg_payload = cig
            cig = [(l_seq << 4) | 4, (span << 4) | 3]  # l_seqS spanN
        rec += struct.pack(
            "<iiBBHHHiiii",
            ref_index[r.chrom],
            r.pos0,
            len(name),
            r.mapq,
            0,
            len(cig),
            r.flag,
            l_seq,
            -1,
            -1,
            0,
        )
        rec += name
        for c in cig:
            rec += struct.pack("<I", c)
        # 4-bit packed seq
        for j in range(0, l_seq, 2):
            hi = SEQ_NT16.index(r.seq[j]) if r.seq[j] in SEQ_NT16 else 15
            lo = (
                SEQ_NT16.index(r.seq[j + 1])
                if j + 1 < l_seq and r.seq[j + 1] in SEQ_NT16
                else 15
            )
            rec += bytes([(hi << 4) | (lo if j + 1 < l_seq else 0)])
        rec += bytes(r.quals)
        if r.cb is not None:
            rec += b"CBZ" + r.cb.encode() + b"\x00"
        if r.ub is not None:
            rec += b"UBZ" + r.ub.encode() + b"\x00"
        if cg_payload is not None:
            rec += b"CGBI" + struct.pack("<I", len(cg_payload))
            for c in cg_payload:
                rec += struct.pack("<I", c)
        buf += struct.pack("<i", len(rec)) + bytes(rec)
    from demuxlet_jax.io.bgzf import BGZF_EOF, compress_block

    blk = 65280
    comp = bytearray()
    comp_off = []  # per 65280-chunk compressed start offset
    for i in range(0, max(1, len(buf)), blk):
        comp_off.append(len(comp))
        comp += compress_block(bytes(buf[i : i + blk]))
    comp += BGZF_EOF
    with open(path, "wb") as fh:
        fh.write(bytes(comp))
    if index == "csi":
        # leaf bins start at ((1<<3*5)-1)/7 = 4681 for depth=5; record the
        # first covered leaf of each reference with loff = first-read voff
        idx = b"CSI\x01" + struct.pack("<iii", 14, 5, 0)
        idx += struct.pack("<i", len(contigs))
        for rid in range(len(contigs)):
            if rid in first_uoff:
                u = first_uoff[rid]
                voff = (comp_off[u // blk] << 16) | (u % blk)
                first_pos = min(
                    r.pos0 for r in reads if ref_index[r.chrom] == rid
                )
                bin_ = 4681 + (first_pos >> 14)
                idx += struct.pack("<i", 1)  # n_bin
                idx += struct.pack("<IQi", bin_, voff, 1)  # bin, loff, n_chunk
                idx += struct.pack("<QQ", voff, (len(comp_off) * blk) << 16)
            else:
                idx += struct.pack("<i", 0)
        with open(path + ".csi", "wb") as fh:
            fh.write(compress_block(idx) + BGZF_EOF)
    elif index:
        with open(path + ".bai", "wb") as fh:
            fh.write(b"BAI\x01" + struct.pack("<i", len(contigs)))
            for rid in range(len(contigs)):
                fh.write(struct.pack("<i", 0))  # n_bin
                if rid in first_uoff:
                    u = first_uoff[rid]
                    voff = (comp_off[u // blk] << 16) | (u % blk)
                    fh.write(struct.pack("<i", 1) + struct.pack("<Q", voff))
                else:
                    fh.write(struct.pack("<i", 0))
    return path


def random_workload(
    rng: random.Random,
    n_cells: int,
    n_snps: int,
    n_samples: int,
    reads_per_cell: int = 30,
    chrom: str = "chr1",
    doublet_rate: float = 0.2,
    read_len: int = 60,
):
    """A synthetic demux workload with known truth assignments.

    Returns (contigs, variants, reads, truth) — variants use GT field with
    random genotypes at fixed allele frequency, reads sample alleles from the
    truth sample's genotype (with a doublet mixing two samples).
    """
    bases = ["A", "C", "G", "T"]
    positions = sorted(rng.sample(range(100, 100 + n_snps * 50), n_snps))
    sample_names = [f"S{i}" for i in range(n_samples)]
    variants = []
    genos = []  # (snp, sample) genotype 0/1/2
    for p in positions:
        ref, alt = rng.sample(bases, 2)
        row = []
        svals = []
        for _ in range(n_samples):
            g = rng.choices([0, 1, 2], weights=[0.36, 0.48, 0.16])[0]
            row.append(g)
            svals.append({"GT": ["0/0", "0/1", "1/1"][g]})
        genos.append(row)
        variants.append(SimVariant(chrom, p, ref, alt, svals))

    reads = []
    truth = {}
    for c in range(n_cells):
        cb = f"BC{c:05d}"
        if rng.random() < doublet_rate and n_samples > 1:
            s1, s2 = rng.sample(range(n_samples), 2)
            truth[cb] = (s1, s2)
        else:
            s1 = rng.randrange(n_samples)
            truth[cb] = (s1, s1)
        for j in range(reads_per_cell):
            k = rng.randrange(n_snps)
            p = positions[k]
            src = truth[cb][rng.random() < 0.5]
            start = max(0, p - rng.randrange(read_len - 1))
            # genotype-consistent bases at EVERY covered SNP position (a read
            # overlapping several SNPs must not inject mixture-like noise)
            import bisect

            lo = bisect.bisect_left(positions, start)
            hi = bisect.bisect_left(positions, start + read_len)
            snp_at = {positions[q]: q for q in range(lo, hi)}
            seq_chars = []
            for i in range(read_len):
                gp = start + i
                q = snp_at.get(gp)
                if q is None:
                    seq_chars.append(rng.choice(bases))
                else:
                    g = genos[q][src]
                    af = [1.0, 0.5, 0.0][g]  # P(ref allele)
                    seq_chars.append(
                        variants[q].ref if rng.random() < af else variants[q].alt
                    )
            seq = "".join(seq_chars)
            quals = [rng.randrange(25, 41) for _ in range(read_len)]
            reads.append(
                SimRead(
                    chrom=chrom,
                    pos0=start,
                    seq=seq,
                    quals=quals,
                    cb=cb,
                    ub=f"U{c}_{j}",
                )
            )
    reads.sort(key=lambda r: r.pos0)
    contigs = [(chrom, positions[-1] + 1000)]
    return contigs, sample_names, variants, reads, truth


def write_bcf(
    path: str,
    sample_names: List[str],
    variants: List[SimVariant],
    contigs: Optional[List[Tuple[str, int]]] = None,
    fmt_keys: Optional[List[str]] = None,
    dup_dp_header: bool = False,
    index: bool = False,
) -> str:
    """Minimal spec-compliant BCF2.2 writer (BGZF-compressed).

    Supports GT (int8 allele codes), GP (float32) and PL (int32) FORMAT
    fields — enough to exercise io/bcf.py against the text VCF path.
    dup_dp_header=True inserts DP as both an INFO and a FORMAT line with no
    explicit IDX; per BCF2 spec both share ONE implicit dictionary index."""
    from demuxlet_jax.io.bgzf import BgzfWriter

    contigs = contigs or []
    lines = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">']
    for name, ln in contigs:
        lines.append(f"##contig=<ID={name},length={ln}>")
    if dup_dp_header:
        lines.append('##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">')
        lines.append('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">')
    lines.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    lines.append('##FORMAT=<ID=GP,Number=G,Type=Float,Description="Posterior">')
    lines.append('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred GL">')
    lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_names)
    )
    text = ("\n".join(lines) + "\n").encode() + b"\x00"
    if dup_dp_header:
        fdict = {"PASS": 0, "DP": 1, "GT": 2, "GP": 3, "PL": 4}
    else:
        fdict = {"PASS": 0, "GT": 1, "GP": 2, "PL": 3}
    rid_of = {name: i for i, (name, _) in enumerate(contigs)}

    def typed_str(s: bytes) -> bytes:
        if len(s) >= 15:
            return bytes([0xF7, 0x11, len(s)]) + s
        return bytes([(len(s) << 4) | 7]) + s

    def typed_i8v(vals) -> bytes:
        assert len(vals) < 15
        return bytes([(len(vals) << 4) | 1]) + bytes(v & 0xFF for v in vals)

    buf = bytearray()
    buf += b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
    first_rec = {}  # chrom -> (uncompressed offset, pos0)
    for v in variants:
        if v.chrom not in first_rec:
            first_rec[v.chrom] = (len(buf), v.pos0)
        keys = fmt_keys or sorted({k for s in v.samples for k in s})
        n_allele = 2
        shared = bytearray()
        shared += struct.pack(
            "<iiifII",
            rid_of.get(v.chrom, 0),
            v.pos0,
            len(v.ref),
            float(v.qual) if v.qual not in (".", "") else 0.0,
            (n_allele << 16) | 0,
            (len(keys) << 24) | len(v.samples),
        )
        shared += typed_str(b"")  # ID
        shared += typed_str(v.ref.encode())
        shared += typed_str(v.alt.encode())
        shared += typed_i8v([0])  # FILTER PASS
        indiv = bytearray()
        for k in keys:
            indiv += typed_i8v([fdict[k]])
            if k == "GT":
                indiv += bytes([(2 << 4) | 1])
                for s in v.samples:
                    gt = s.get("GT", ".")
                    parts = gt.replace("|", "/").split("/")
                    codes = []
                    for p in parts[:2]:
                        codes.append(0 if p in (".", "") else ((int(p) + 1) << 1))
                    while len(codes) < 2:
                        codes.append(-127)  # END_OF_VECTOR
                    indiv += bytes(c & 0xFF for c in codes)
            elif k == "GP":
                indiv += bytes([(3 << 4) | 5])
                for s in v.samples:
                    gp = s.get("GP", ".")
                    if gp == ".":
                        vals = [struct.pack("<I", 0x7F800001)] * 3
                    else:
                        vals = [
                            struct.pack("<f", float(t)) for t in gp.split(",")
                        ]
                    indiv += b"".join(vals[:3])
            elif k == "PL":
                indiv += bytes([(3 << 4) | 3])
                for s in v.samples:
                    pl = s.get("PL", ".")
                    if pl == ".":
                        vals = [-2147483648] * 3
                    else:
                        vals = [int(t) if t != "." else -2147483648 for t in pl.split(",")]
                    while len(vals) < 3:
                        vals.append(-2147483647)
                    indiv += struct.pack("<3i", *vals[:3])
        buf += struct.pack("<II", len(shared), len(indiv))
        buf += bytes(shared) + bytes(indiv)
    with BgzfWriter(open(path, "wb")) as w:
        w.write(bytes(buf))
    if index:
        _write_bcf_csi(path, contigs, first_rec)
    return path


def _write_bcf_csi(path, contigs, first_rec):
    """Minimal .csi (min_shift=14, depth=5): one leaf bin per covered
    contig with loff = its first record's virtual offset."""
    import gzip as _gzip

    from demuxlet_jax.io.bgzf import read_block_at

    blocks = []
    u = 0
    with open(path, "rb") as fh:
        while True:
            coff = fh.tell()
            b = read_block_at(fh)
            if b is None:
                break
            blocks.append((coff, u))
            u += len(b)

    def voff_of(uoff):
        bi = max(i for i in range(len(blocks)) if blocks[i][1] <= uoff)
        coff, ustart = blocks[bi]
        return (coff << 16) | (uoff - ustart)

    blob = b"CSI\x01" + struct.pack("<iii", 14, 5, 0)
    blob += struct.pack("<i", len(contigs))
    for name, _ln in contigs:
        if name in first_rec:
            uoff, pos0 = first_rec[name]
            voff = voff_of(uoff)
            bin_ = 4681 + (pos0 >> 14)
            blob += struct.pack("<i", 1)
            blob += struct.pack("<IQi", bin_, voff, 1)
            blob += struct.pack("<QQ", voff, voff + (1 << 32))
        else:
            blob += struct.pack("<i", 0)
    with _gzip.open(path + ".csi", "wb") as fh:
        fh.write(blob)


# ---------------------------------------------------------------- CRAM
def _itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([
        0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
        (v >> 4) & 0xFF, v & 0x0F,
    ])


def _ltf8(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    nbytes = (v.bit_length() + 7) // 8
    # prefix byte carries only the leading-ones count; value in full bytes
    return bytes([(0xFF << (8 - nbytes)) & 0xFF]) + v.to_bytes(nbytes, "big")


def _cram_block(ctype: int, cid: int, data: bytes, method: int = 0) -> bytes:
    if method == 1:
        import gzip as _gz

        comp = _gz.compress(data)
    elif method == 2:
        import bz2 as _bz2

        comp = _bz2.compress(data)
    elif method == 3:
        import lzma as _lzma

        comp = _lzma.compress(data, format=_lzma.FORMAT_XZ)
    elif method == 4:
        from demuxlet_jax.io import rans

        comp = rans.compress(data, order=1 if len(data) >= 4 else 0)
    else:
        comp = data
    body = (bytes([method, ctype]) + _itf8(cid) + _itf8(len(comp))
            + _itf8(len(data)) + comp)
    return body + struct.pack("<I", 0)  # CRC not checked by our reader


def _enc_external(cid: int) -> bytes:
    p = _itf8(cid)
    return _itf8(1) + _itf8(len(p)) + p


def _enc_bas(stop: int, cid: int) -> bytes:
    p = bytes([stop]) + _itf8(cid)
    return _itf8(5) + _itf8(len(p)) + p


_CRAM_IDS = dict(BF=1, CF=2, RL=3, AP=4, RG=5, RN=6, TL=7, FN=8, FC=9,
                 FP=10, BS=11, DL=12, RS=13, IN=14, SC=15, HC=16, PD=17,
                 BA=18, QS=19, MF=20, NS=21, NP=22, TS=23, MQ=24, RI=25)


def _enc_beta(offset: int, nbits: int) -> bytes:
    p = _itf8(offset) + _itf8(nbits)
    return _itf8(6) + _itf8(len(p)) + p


def _enc_gamma(offset: int) -> bytes:
    p = _itf8(offset)
    return _itf8(9) + _itf8(len(p)) + p


def _enc_subexp(offset: int, k: int) -> bytes:
    p = _itf8(offset) + _itf8(k)
    return _itf8(7) + _itf8(len(p)) + p


def _enc_huffman(symbols, lengths) -> bytes:
    p = _itf8(len(symbols)) + b"".join(_itf8(s) for s in symbols)
    p += _itf8(len(lengths)) + b"".join(_itf8(l) for l in lengths)
    return _itf8(3) + _itf8(len(p)) + p


class _BitW:
    """MSB-first bit writer (mirror of io/cram._Bits)."""

    def __init__(self):
        self.bits = []

    def write_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def tobytes(self) -> bytes:
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            byte = 0
            for j, b in enumerate(self.bits[i : i + 8]):
                byte |= b << (7 - j)
            out.append(byte)
        return bytes(out)


def _huffman_lengths(values):
    """Code bit-lengths from value frequencies (heapq Huffman)."""
    import heapq
    from collections import Counter

    cnt = Counter(values)
    syms = sorted(cnt)
    if len(syms) == 1:
        return syms, [0]
    heap = [(c, i, [s]) for i, (s, c) in enumerate(sorted(cnt.items()))]
    heapq.heapify(heap)
    depth = {s: 0 for s in syms}
    uid = len(heap)
    while len(heap) > 1:
        c1, _, g1 = heapq.heappop(heap)
        c2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            depth[s] += 1
        heapq.heappush(heap, (c1 + c2, uid, g1 + g2))
        uid += 1
    return syms, [depth[s] for s in syms]


class _CoreEnc:
    """Per-series core-codec encoder matching io/cram's decoders."""

    def __init__(self, kind, params):
        self.kind = kind
        self.params = params

    def encoding_bytes(self):
        if self.kind == "beta":
            return _enc_beta(*self.params)
        if self.kind == "gamma":
            return _enc_gamma(*self.params)
        if self.kind == "subexp":
            return _enc_subexp(*self.params)
        if self.kind == "huffman":
            return _enc_huffman(*self.params)
        raise AssertionError(self.kind)

    def write(self, w: _BitW, value: int):
        if self.kind == "beta":
            offset, nbits = self.params
            w.write_bits(value + offset, nbits)
        elif self.kind == "gamma":
            (offset,) = self.params
            v = value + 1 + offset
            n = v.bit_length() - 1
            w.write_bits(0, n)
            w.write_bits(v, n + 1)
        elif self.kind == "subexp":
            offset, k = self.params
            v = value + offset
            if v < (1 << k):
                w.write_bits(0, 1)
                w.write_bits(v, k)
            else:
                b = v.bit_length() - 1
                u = b - k + 1
                w.write_bits((1 << u) - 1, u)
                w.write_bits(0, 1)
                w.write_bits(v - (1 << b), b)
        elif self.kind == "huffman":
            syms, lens = self.params
            if len(syms) == 1:
                return  # zero-bit constant
            # canonical codes: sorted by (length, symbol)
            pairs = sorted(zip(lens, syms))
            code = 0
            prev = pairs[0][0]
            table = {}
            for ln, sym in pairs:
                code <<= ln - prev
                prev = ln
                table[sym] = (code, ln)
                code += 1
            c, ln = table[value]
            w.write_bits(c, ln)


def write_cram(
    path: str,
    contigs: List[Tuple[str, int]],
    reads: List[SimRead],
    ref_seqs: dict,
    method: int = 0,
    core_codecs: bool = False,
    slices: int = 1,
    index: bool = False,
    b_features: bool = False,
    preserve_quals: bool = True,
) -> str:
    """Spec-structured CRAM 3.0 writer for testing io/cram.py.

    ref_seqs: chrom -> str genome (reads encode as substitution features;
    with b_features every third mismatch encodes as a 'B' base+qual
    feature instead of an 'X' substitution code).
    preserve_quals=False drops CF bit 0x1 and the wholesale QS array —
    feature-carried quals ('B') become the only BQ source, the htslib
    semantics the decoders must honor (advisor r4 #1).
    method: block compression (0 raw, 1 gzip, 2 bzip2, 4 rANS).
    core_codecs: encode the integer data series with core-bitstream codecs
    (BETA/GAMMA/SUBEXP/multi-symbol canonical HUFFMAN) in a CORE data
    block instead of EXTERNAL itf8 streams.
    slices: split records into this many slices within one container."""
    ref_index = {name: i for i, (name, _) in enumerate(contigs)}
    reads = sorted(reads, key=lambda r: (ref_index[r.chrom], r.pos0))
    bases_order = "ACGTN"

    def sub_code(ref_b: str, read_b: str):
        others = [c for c in bases_order if c != ref_b][:4]
        return others.index(read_b) if read_b in others else 0

    sm = bytes([0x1B] * 5)  # code j == j-th other base, every row

    # tag dictionary: distinct tag signatures in first-seen order
    td_lines, td_index = [], {}
    tag_ids = {}
    next_tag_cid = 30

    def tag_sig(r):
        sig = []
        if r.cb is not None:
            sig.append(("CB", "Z"))
        if r.ub is not None:
            sig.append(("UB", "Z"))
        return tuple(sig)

    for r in reads:
        sig = tag_sig(r)
        if sig not in td_index:
            td_index[sig] = len(td_lines)
            td_lines.append(sig)
            for tag, typ in sig:
                if (tag, typ) not in tag_ids:
                    tag_ids[(tag, typ)] = next_tag_cid
                    next_tag_cid += 1

    # ---- pass 1: per-slice event streams (exact decoder read order for
    # the int series; byte-array series go straight to external streams)
    def emit_slice(slice_reads, base_index):
        events = []  # (series_key, int_value) in decoder order
        streams = {cid: bytearray() for cid in _CRAM_IDS.values()}
        for cid in tag_ids.values():
            streams[cid] = bytearray()
        for i, r in enumerate(slice_reads):
            S = streams
            events.append(("BF", r.flag))
            events.append(("CF", (0x1 if preserve_quals else 0) | 0x2))
            # RI (record reference id): consumed by decoders ONLY in
            # multi-ref (ref_id == -2) slices; always emitted (external
            # stream, trailing unread bytes are legal)
            events.append(("RI", ref_index[r.chrom]))
            events.append(("RL", len(r.seq)))
            events.append(("AP", r.pos0 + 1))
            events.append(("RG", -1))
            S[_CRAM_IDS["RN"]] += f"{r.name}{base_index + i}".encode() + b"\x00"
            events.append(("MF", 0))
            events.append(("NS", -1))
            events.append(("NP", 0))
            events.append(("TS", 0))
            events.append(("TL", td_index[tag_sig(r)]))
            for tag, typ in tag_sig(r):
                val = r.cb if tag == "CB" else r.ub
                streams[tag_ids[(tag, typ)]] += val.encode() + b"\x09"
            feats = []
            genome = ref_seqs[r.chrom]
            rpos = 0
            gpos = r.pos0
            for ch, ln in _iter_cigar(r.cigar_str()):
                if ch == "M":
                    for o in range(ln):
                        rb = genome[gpos + o]
                        sb = r.seq[rpos + o]
                        if sb != rb:
                            if b_features and len(feats) % 3 == 2:
                                feats.append(("B", rpos + o + 1,
                                              (sb, r.quals[rpos + o])))
                            else:
                                feats.append(
                                    ("X", rpos + o + 1, sub_code(rb, sb)))
                    gpos += ln
                    rpos += ln
                elif ch == "S":
                    feats.append(("S", rpos + 1, r.seq[rpos : rpos + ln]))
                    rpos += ln
                elif ch == "I":
                    feats.append(("I", rpos + 1, r.seq[rpos : rpos + ln]))
                    rpos += ln
                elif ch == "D":
                    feats.append(("D", rpos + 1, ln))
                    gpos += ln
                elif ch == "N":
                    feats.append(("N", rpos + 1, ln))
                    gpos += ln
                elif ch == "H":
                    feats.append(("H", rpos + 1, ln))
                elif ch == "P":
                    feats.append(("P", rpos + 1, ln))
            events.append(("FN", len(feats)))
            prev = 0
            for code, p0, payload in feats:
                S[_CRAM_IDS["FC"]] += code.encode()
                events.append(("FP", p0 - prev))
                prev = p0
                if code == "X":
                    S[_CRAM_IDS["BS"]] += bytes([payload])
                elif code == "D":
                    events.append(("DL", payload))
                elif code == "N":
                    events.append(("RS", payload))
                elif code == "I":
                    S[_CRAM_IDS["IN"]] += payload.encode() + b"\x00"
                elif code == "S":
                    S[_CRAM_IDS["SC"]] += payload.encode() + b"\x00"
                elif code == "H":
                    events.append(("HC", payload))
                elif code == "P":
                    events.append(("PD", payload))
                elif code == "B":
                    S[_CRAM_IDS["BA"]] += payload[0].encode()
                    S[_CRAM_IDS["QS"]] += bytes([payload[1]])
            events.append(("MQ", r.mapq))
            if preserve_quals:
                S[_CRAM_IDS["QS"]] += bytes(r.quals)
        return events, streams

    if index:
        # one slice (-> one container) per chromosome, so a .crai region
        # seek genuinely skips whole containers
        groups = []
        for rid in range(len(contigs)):
            g = [r for r in reads if ref_index[r.chrom] == rid]
            if g:
                groups.append(g)
        groups = groups or [[]]
    else:
        nsl = max(1, min(slices, max(1, len(reads))))
        per = -(-len(reads) // nsl) if reads else 1
        groups = [reads[i : i + per]
                  for i in range(0, len(reads), per)] or [[]]
    slice_data = []
    base = 0
    for g in groups:
        slice_data.append((g, *emit_slice(g, base)))
        base += len(g)

    # ---- choose per-series encodings (shared by all slices)
    # RI stays EXTERNAL always (core-encoding it would misalign the CORE
    # bitstream for single-ref slices, whose decoders never read RI)
    INT_KEYS = ("BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
                "TL", "FN", "FP", "DL", "RS", "HC", "PD", "MQ")
    encodings = {}
    core_enc = {}
    if core_codecs:
        allv = {k: [] for k in INT_KEYS}
        for _, events, _ in slice_data:
            for k, v in events:
                allv[k].append(v)
        core_for = {
            "BF": _CoreEnc("beta", (0, 16)),
            "RL": _CoreEnc("gamma", (0,)),
            "FN": _CoreEnc("gamma", (0,)),
            "FP": _CoreEnc("subexp", (0, 2)),
            "TL": _CoreEnc("beta", (0, 4)),
            "DL": _CoreEnc("gamma", (0,)),
            "RS": _CoreEnc("gamma", (0,)),
            "HC": _CoreEnc("gamma", (0,)),
            "PD": _CoreEnc("gamma", (0,)),
        }
        if allv["MQ"]:
            core_for["MQ"] = _CoreEnc("huffman", _huffman_lengths(allv["MQ"]))
        core_enc = {k: e for k, e in core_for.items()
                    if k != "FP" or all(v >= 0 for v in allv["FP"])}
    for k in INT_KEYS:
        if k in core_enc:
            encodings[k] = core_enc[k].encoding_bytes()
        else:
            encodings[k] = _enc_external(_CRAM_IDS[k])

    # ---- compression header
    td_blob = b"".join(
        b"".join(t.encode() + y.encode() for t, y in line) + b"\x00"
        for line in td_lines
    )
    pres_entries = [
        (b"RN", bytes([1])),
        (b"AP", bytes([0])),
        (b"RR", bytes([0])),
        (b"SM", sm),
        (b"TD", _itf8(len(td_blob)) + td_blob),
    ]
    pres = _itf8(len(pres_entries))
    for k, v in pres_entries:
        pres += k + v
    pres = _itf8(len(pres)) + pres
    ds_entries = [(k.encode(), encodings[k]) for k in INT_KEYS]
    ds_entries += [
        (b"RN", _enc_bas(0, _CRAM_IDS["RN"])),
        (b"FC", _enc_external(_CRAM_IDS["FC"])),
        (b"BS", _enc_external(_CRAM_IDS["BS"])),
        (b"IN", _enc_bas(0, _CRAM_IDS["IN"])),
        (b"SC", _enc_bas(0, _CRAM_IDS["SC"])),
        (b"QS", _enc_external(_CRAM_IDS["QS"])),
        (b"BA", _enc_external(_CRAM_IDS["BA"])),
    ]
    ds = _itf8(len(ds_entries))
    for k, e in ds_entries:
        ds += k + e
    ds = _itf8(len(ds)) + ds
    te_entries = []
    for (tag, typ), cid in tag_ids.items():
        key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
        te_entries.append((key, _enc_bas(0x09, cid)))
    te = _itf8(len(te_entries))
    for k, e in te_entries:
        te += _itf8(k) + e
    te = _itf8(len(te)) + te
    chdr = pres + ds + te

    # ---- slices
    def slice_blocks(g, events, streams):
        core_w = _BitW()
        for k, v in events:
            if k in core_enc:
                core_enc[k].write(core_w, v)
            else:
                streams[_CRAM_IDS[k]] += _itf8(v)
        used = sorted(cid for cid in streams if streams[cid])
        core_bytes = core_w.tobytes()
        n_data = len(used) + (1 if core_codecs else 0)
        rids = {ref_index[r.chrom] for r in g}
        # multi-reference slice: ref_id -2 + per-record RI (CRAM 3.0 §8.5)
        rid = (-2 if len(rids) > 1 else rids.pop()) if g else -1
        start = (g[0].pos0 + 1 if g else 0) if rid != -2 else 0
        slice_hdr = (
            _itf8(rid) + _itf8(start) + _itf8(0) + _itf8(len(g))
            + _ltf8(0) + _itf8(n_data)
            + _itf8(len(used)) + b"".join(_itf8(c) for c in used)
            + _itf8(-1) + b"\x00" * 16
        )
        out_b = _cram_block(2, 0, slice_hdr)
        nb = 1
        if core_codecs:
            out_b += _cram_block(5, 0, core_bytes, method=0)
            nb += 1
        for cid in used:
            out_b += _cram_block(4, cid, bytes(streams[cid]), method=method)
            nb += 1
        return out_b, nb

    def container(ref_id, start, nrec_, blocks_bytes, nblocks, span=0):
        hdr = (
            struct.pack("<i", len(blocks_bytes))
            + _itf8(ref_id) + _itf8(start) + _itf8(span) + _itf8(nrec_)
            + _ltf8(0) + _ltf8(0) + _itf8(nblocks) + _itf8(0)
            + struct.pack("<I", 0)
        )
        return hdr + blocks_bytes

    # SAM header container
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in contigs)).encode()
    hblock = _cram_block(0, 0, struct.pack("<i", len(text)) + text)

    out = b"CRAM\x03\x00" + b"\x00" * 20
    out += container(-1, 0, 1, hblock, 1)
    crai_rows = []
    if index:
        # one data container per slice group + one .crai row each
        for g, events, streams in slice_data:
            sb, nb = slice_blocks(g, events, streams)
            body = _cram_block(1, 0, chdr) + sb
            rid = ref_index[g[0].chrom] if g else -1
            start = g[0].pos0 + 1 if g else 0
            end = max((r.pos0 + len(r.seq) for r in g), default=start)
            span = max(1, end - start + 1)
            crai_rows.append((rid, start, span, len(out), 0, len(body)))
            out += container(rid, start, len(g), body, nb + 1, span=span)
    else:
        blocks = _cram_block(1, 0, chdr)
        total_blocks = 1
        for g, events, streams in slice_data:
            sb, nb = slice_blocks(g, events, streams)
            blocks += sb
            total_blocks += nb
        min_start = reads[0].pos0 + 1 if reads else 1
        c_rids = {ref_index[r.chrom] for r in reads}
        c_rid = (-2 if len(c_rids) > 1 else c_rids.pop()) if reads else -1
        out += container(
            c_rid, min_start if c_rid != -2 else 0,
            len(reads), blocks, total_blocks,
        )
    out += container(-1, 0, 0, b"", 0)  # EOF
    with open(path, "wb") as fh:
        fh.write(out)
    if index:
        import gzip

        txt = "".join("%d\t%d\t%d\t%d\t%d\t%d\n" % row for row in crai_rows)
        with gzip.open(path + ".crai", "wb") as fh:
            fh.write(txt.encode())
    return path


def _iter_cigar(cig: str):
    num = ""
    for ch in cig:
        if ch.isdigit():
            num += ch
        else:
            yield ch, int(num)
            num = ""
