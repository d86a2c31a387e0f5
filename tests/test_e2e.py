"""End-to-end CLI tests: synthetic BAM+VCF -> output files vs oracle pipeline."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from demuxlet_jax import cli
from demuxlet_jax.host.pileup import build_pileup
from demuxlet_jax.io.bam import AlignmentReader
from demuxlet_jax.io.vcf import load_snp_table
from fixtures import random_workload, write_bam, write_sam, write_vcf
from oracle.numpy_oracle import (
    compute_gp0s,
    pass1_singlet,
    pass2_outputs,
    write_single,
)
from parity_utils import canonicalize_best


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    rng = random.Random(7)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=25, n_snps=50, n_samples=3, reads_per_cell=60
    )
    vcf = write_vcf(str(tmp / "w.vcf.gz"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp / "w.bam"), contigs, reads)
    return tmp, vcf, bam, truth


def _oracle_files(vcf, bam, field="GT", grid=(0.0, 0.5), **kw):
    table = load_snp_table(vcf, field_name=field)
    rdr = AlignmentReader(bam)
    scl, _ = build_pileup(rdr, table)
    gp0s = compute_gp0s(scl)
    llks, llk0s = pass1_singlet(scl, gp0s)
    single = write_single(scl, llks, llk0s)
    sing2, pair, best = pass2_outputs(
        scl, gp0s, list(grid), write_pair=True, **kw
    )
    return single, sing2, pair, best


def test_cli_end_to_end_gt(workload):
    tmp, vcf, bam, truth = workload
    out = str(tmp / "res")
    rc = cli.main(
        [
            "--sam", bam, "--vcf", vcf, "--field", "GT",
            "--out", out, "--write-pair", "--device", "cpu",
        ]
    )
    assert rc == 0

    o_single, o_sing2, o_pair, o_best = _oracle_files(vcf, bam)
    assert open(out + ".single").read().rstrip("\n").split("\n") == o_single
    assert open(out + ".sing2").read().rstrip("\n").split("\n") == o_sing2
    assert open(out + ".pair").read().rstrip("\n").split("\n") == o_pair
    e_best = open(out + ".best").read().rstrip("\n").split("\n")
    assert canonicalize_best(e_best) == canonicalize_best(o_best)

    # truth recovery: planted singlets called correctly
    n_ok = n_cells = 0
    for row in e_best[1:]:
        c = row.split("\t")
        t1, t2 = truth[c[0]]
        n_cells += 1
        if t1 == t2 and c[5] == f"SNG-S{t1}":
            n_ok += 1
        if t1 != t2 and c[5].startswith("DBL-"):
            pair_ids = set(c[5].split("-")[1:3])
            if pair_ids == {f"S{t1}", f"S{t2}"}:
                n_ok += 1
    assert n_ok >= 0.9 * n_cells


def test_cli_alpha_grid_and_prior(workload):
    tmp, vcf, bam, _ = workload
    out = str(tmp / "res5")
    rc = cli.main(
        [
            "--sam", bam, "--vcf", vcf, "--field", "GT", "--out", out,
            "--alpha", "0", "--alpha", "0.2", "--alpha", "0.5",
            "--doublet-prior", "0.3", "--device", "cpu",
        ]
    )
    assert rc == 0
    _, o_sing2, _, o_best = _oracle_files(
        vcf, bam, grid=(0.0, 0.2, 0.5), doublet_prior=0.3
    )
    e_best = open(out + ".best").read().rstrip("\n").split("\n")
    assert canonicalize_best(e_best) == canonicalize_best(o_best)


def test_cli_module_invocation(workload):
    """python -m demuxlet_jax.cli works as a subprocess (the user surface)."""
    tmp, vcf, bam, _ = workload
    out = str(tmp / "res_sub")
    r = subprocess.run(
        [
            sys.executable, "-m", "demuxlet_jax.cli",
            "--sam", bam, "--vcf", vcf, "--field", "GT",
            "--out", out, "--device", "cpu",
        ],
        capture_output=True,
        text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    best = open(out + ".best").read()
    assert best.startswith("BARCODE\t")
    assert "Available Options" in r.stderr


def test_cli_group_list(workload):
    tmp, vcf, bam, truth = workload
    keep = sorted(truth.keys())[:5]
    gl = tmp / "keep.txt"
    gl.write_text("\n".join(keep) + "\n")
    out = str(tmp / "res_gl")
    rc = cli.main(
        [
            "--sam", bam, "--vcf", vcf, "--field", "GT", "--out", out,
            "--group-list", str(gl), "--device", "cpu",
        ]
    )
    assert rc == 0
    rows = open(out + ".best").read().rstrip("\n").split("\n")[1:]
    assert {r.split("\t")[0] for r in rows} <= set(keep)


def test_cli_gp_field(tmp_path):
    from fixtures import SimVariant

    rng = random.Random(11)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=8, n_snps=20, n_samples=2, reads_per_cell=40
    )
    # attach GP fields derived from GT
    for v in variants:
        for s in v.samples:
            g = {"0/0": 0, "0/1": 1, "1/1": 2}[s["GT"]]
            gp = [0.02, 0.02, 0.02]
            gp[g] = 0.96
            s["GP"] = ",".join(f"{x:g}" for x in gp)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    out = str(tmp_path / "res_gp")
    rc = cli.main(
        ["--sam", bam, "--vcf", vcf, "--field", "GP", "--out", out, "--device", "cpu"]
    )
    assert rc == 0
    o_single, o_sing2, o_pair, o_best = _oracle_files(vcf, bam, field="GP")
    e_best = open(out + ".best").read().rstrip("\n").split("\n")
    assert canonicalize_best(e_best) == canonicalize_best(o_best)
    assert open(out + ".single").read().rstrip("\n").split("\n") == o_single


def test_cli_pl_field(tmp_path):
    """--field PL end-to-end (10-iteration EM path) recovers truth."""
    import random as _random

    rng = _random.Random(31)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=15, n_snps=40, n_samples=3, reads_per_cell=70
    )
    for v in variants:
        for s in v.samples:
            g = {"0/0": 0, "0/1": 1, "1/1": 2}[s["GT"]]
            pl = [60, 60, 60]
            pl[g] = 0
            s["PL"] = ",".join(str(x) for x in pl)
    vcf = write_vcf(str(tmp_path / "pl.vcf"), names, variants,
                    contigs=contigs, fmt_keys=["GT", "PL"])
    bam = write_bam(str(tmp_path / "pl.bam"), contigs, reads)
    rc = cli.main([
        "--sam", bam, "--vcf", vcf, "--field", "PL",
        "--out", str(tmp_path / "pl"),
    ])
    assert rc == 0
    ok = 0
    for line in open(str(tmp_path / "pl") + ".best"):
        if line.startswith("BARCODE"):
            continue
        f = line.split("\t")
        t = truth[f[0]]
        if t[0] == t[1] and f[5] == f"SNG-S{t[0]}":
            ok += 1
        elif t[0] != t[1] and f[5].startswith("DBL-"):
            ok += 1
    assert ok >= 13  # allow a couple of ambiguous calls


def test_cli_write_pair_matches_oracle(tmp_path):
    """--write-pair .pair bytes == NumPy oracle rendering."""
    import random as _random

    import numpy as np

    rng = _random.Random(37)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=10, n_snps=30, n_samples=3, reads_per_cell=40
    )
    vcf = write_vcf(str(tmp_path / "wp.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "wp.bam"), contigs, reads)
    rc = cli.main([
        "--sam", bam, "--vcf", vcf, "--field", "GT", "--write-pair",
        "--alpha", "0", "--alpha", "0.3", "--alpha", "0.5",
        "--out", str(tmp_path / "wp"),
    ])
    assert rc == 0
    pair = open(str(tmp_path / "wp") + ".pair").read()
    hdr = pair.splitlines()[0].split("\t")
    assert hdr == ["BARCODE", "SM1.ID", "SM2.ID", "LLK12", "POSTPRB"]
    # the reference's 5-name/6-column mismatch is reproduced
    row = pair.splitlines()[1].split("\t")
    assert len(row) == 6

    table = load_snp_table(vcf, field_name="GT")
    scl, _ = build_pileup(AlignmentReader(bam), table)
    gp0s = compute_gp0s(scl)
    _sing2, ref_pair, _best = pass2_outputs(
        scl, gp0s, [0.0, 0.3, 0.5], write_pair=True
    )
    assert pair == "\n".join(ref_pair) + "\n"


def test_cli_sm_subset(tmp_path):
    """--sm restricts the sample panel (sorted-ID order, resolve_samples)."""
    import random as _random

    rng = _random.Random(41)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=12, n_snps=30, n_samples=4, reads_per_cell=50
    )
    vcf = write_vcf(str(tmp_path / "sm.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "sm.bam"), contigs, reads)
    rc = cli.main([
        "--sam", bam, "--vcf", vcf, "--field", "GT",
        "--sm", "S2", "--sm", "S0",
        "--out", str(tmp_path / "sm"),
    ])
    assert rc == 0
    sms = set()
    for line in open(str(tmp_path / "sm") + ".single"):
        if line.startswith("BARCODE"):
            continue
        sms.add(line.split("\t")[1])
    assert sms == {"S0", "S2"}


def test_cli_parity_mode(tmp_path, workload):
    """--mode parity output is byte-identical to the oracle, including the
    ulp-tie pair-order behavior the device kernels can't guarantee."""
    tmp, vcf, bam, truth = workload
    rc = cli.main([
        "--sam", bam, "--vcf", vcf, "--field", "GT", "--mode", "parity",
        "--out", str(tmp_path / "par"),
    ])
    assert rc == 0
    single, sing2, pair, best = _oracle_files(vcf, bam)
    assert open(str(tmp_path / "par") + ".best").read() == "\n".join(best) + "\n"
    assert open(str(tmp_path / "par") + ".single").read() == "\n".join(single) + "\n"
    assert open(str(tmp_path / "par") + ".sing2").read() == "\n".join(sing2) + "\n"


def test_cli_single_sample_and_single_alpha(tmp_path):
    """Degenerate panels must not crash: nv==1 (doublet search empty, best
    call SNG per the reference's running-max seeding) and a 1-point alpha
    grid (sumDouble loop empty)."""
    import random as _random

    rng = _random.Random(3)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=6, n_snps=20, n_samples=1, reads_per_cell=30
    )
    vcf = write_vcf(str(tmp_path / "n1.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "n1.bam"), contigs, reads)
    rc = cli.main([
        "--sam", bam, "--vcf", vcf, "--field", "GT",
        "--out", str(tmp_path / "n1"),
    ])
    assert rc == 0
    rows = open(str(tmp_path / "n1") + ".best").read().splitlines()[1:]
    assert rows and all(r.split("\t")[5] == "SNG-S0" for r in rows)
    rc = cli.main([
        "--sam", bam, "--vcf", vcf, "--field", "GT", "--alpha", "0",
        "--out", str(tmp_path / "a1"),
    ])
    assert rc == 0


def test_cli_gp_field_8_samples_fast(tmp_path):
    """BASELINE config 2/4 shape: GP-field input, 8 samples, 5-alpha grid,
    fast mode vs exact mode — identical calls."""
    import random as _random

    rng = _random.Random(61)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=16, n_snps=60, n_samples=8, reads_per_cell=80
    )
    for v in variants:
        for s in v.samples:
            g = {"0/0": 0, "0/1": 1, "1/1": 2}[s["GT"]]
            p = [0.02, 0.02, 0.02]
            p[g] = 0.96
            s["GP"] = ",".join("%.4f" % x for x in p)
    vcf = write_vcf(str(tmp_path / "gp8.vcf"), names, variants,
                    contigs=contigs, fmt_keys=["GT", "GP"])
    bam = write_bam(str(tmp_path / "gp8.bam"), contigs, reads)
    alphas = []
    for a in (0.0, 0.1, 0.2, 0.3, 0.5):
        alphas += ["--alpha", str(a)]
    base = ["--sam", bam, "--vcf", vcf, "--field", "GP"] + alphas

    def calls(out, *extra):
        rc = cli.main(base + ["--out", str(tmp_path / out)] + list(extra))
        assert rc == 0
        from parity_utils import canonicalize_best_line

        return [
            canonicalize_best_line(l).split("\t")[5]
            for l in open(str(tmp_path / out) + ".best").read().splitlines()[1:]
        ]

    exact = calls("e")
    fast = calls("f", "--mode", "fast")
    assert fast == exact
    ok = 0
    for line in open(str(tmp_path / "e") + ".best").read().splitlines()[1:]:
        f = line.split("\t")
        t = truth[f[0]]
        if t[0] == t[1]:
            ok += f[5] == f"SNG-S{t[0]}"
        else:
            ok += f[5].startswith("DBL-")
    assert ok >= 14


def test_cli_bgzf_output(workload):
    """--out x.gz writes BGZF-compressed x.single.gz/.sing2.gz/.best.gz
    whose decompressed bytes equal the plain-text outputs."""
    import gzip

    tmp, vcf, bam, truth = workload
    plain = str(tmp / "plain")
    rc = cli.main(["--sam", bam, "--vcf", vcf, "--field", "GT",
                   "--out", plain, "--write-pair", "--device", "cpu"])
    assert rc == 0
    comp = str(tmp / "comp.gz")
    rc = cli.main(["--sam", bam, "--vcf", vcf, "--field", "GT",
                   "--out", comp, "--write-pair", "--device", "cpu"])
    assert rc == 0
    for ext in (".single", ".sing2", ".best", ".pair"):
        with open(plain + ext, "rb") as fh:
            want = fh.read()
        with gzip.open(str(tmp / "comp") + ext + ".gz", "rb") as fh:
            got = fh.read()
        assert got == want, ext


def test_cli_backend_init_timeout(workload, tmp_path, monkeypatch):
    """A hanging engine/backend initialisation must fail loudly within
    DEMUX_BACKEND_TIMEOUT instead of joining forever."""
    import time as _t

    import demuxlet_jax.models.engine as eng_mod
    from demuxlet_jax.utils.logging_utils import DemuxError

    _, vcf, bam, _truth = workload

    class _HangingEngine:
        def __init__(self, *a, **k):
            _t.sleep(60)

    monkeypatch.setattr(eng_mod, "DemuxEngine", _HangingEngine)
    monkeypatch.setenv("DEMUX_BACKEND_TIMEOUT", "1.5")
    with pytest.raises(DemuxError, match="did not complete within"):
        cli.main([
            "--sam", bam, "--vcf", vcf, "--field", "GT",
            "--out", str(tmp_path / "to"), "--device", "cpu",
        ])
