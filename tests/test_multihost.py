"""Barcode-shard invariance: N-shard merged outputs == unsharded outputs."""

import io
import pytest
import random

import numpy as np

from demuxlet_jax.host.pileup import build_pileup
from demuxlet_jax.io.bam import AlignmentReader
from demuxlet_jax.io.vcf import load_snp_table
from demuxlet_jax.models import outputs as out_mod
from demuxlet_jax.models.engine import DemuxEngine, cell_stats
from demuxlet_jax.parallel import multihost as mh
from fixtures import random_workload, write_bam, write_vcf


def _outputs(scl, table, res):
    stats = cell_stats(scl)
    s1, s2, sb = io.StringIO(), io.StringIO(), io.StringIO()
    out_mod.write_single(s1, stats, table.sample_ids, res.llks, res.llk0s)
    out_mod.write_pass2(
        stats, table.sample_ids, res.llk_ab, res.llk_00, [0.0, 0.5], 0.5,
        s2, sb,
    )
    return s1.getvalue(), s2.getvalue(), sb.getvalue()


def test_shard_merge_invariance(tmp_path):
    rng = random.Random(17)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=30, n_snps=40, n_samples=3, reads_per_cell=50
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")

    # unsharded reference run
    scl, _ = build_pileup(AlignmentReader(bam), table)
    eng = DemuxEngine(table.gps, [0.0, 0.5], cell_block=16)
    full = _outputs(scl, table, eng.run(scl))

    # 3 shards, merged
    N = 3
    shards = []
    for k in range(N):
        sclk, _ = build_pileup(
            AlignmentReader(bam), table, n_shards=N, shard_id=k
        )
        resk = eng.run(sclk)
        statsk = cell_stats(sclk)
        shards.append(
            mh.ShardResult(
                barcodes=statsk.barcodes, totl=statsk.totl,
                pass_=statsk.pass_, uniq=statsk.uniq, nsnp=statsk.nsnp,
                llks=resk.llks, llk0s=resk.llk0s, llk_ab=resk.llk_ab,
                llk_00=resk.llk_00,
            )
        )
    # disjoint, complete partition
    allbc = [b for s in shards for b in s.barcodes]
    assert sorted(allbc) == sorted(scl.barcodes)
    merged = mh.merge_shards(shards)
    assert merged.barcodes == sorted(scl.barcodes)

    # rebuild outputs from the merged arrays and compare byte-for-byte
    from demuxlet_jax.models.outputs import CellStats

    mstats = CellStats(
        barcodes=merged.barcodes, totl=merged.totl, pass_=merged.pass_,
        uniq=merged.uniq, nsnp=merged.nsnp,
    )
    s1, s2, sb = io.StringIO(), io.StringIO(), io.StringIO()
    out_mod.write_single(s1, mstats, table.sample_ids, merged.llks, merged.llk0s)
    out_mod.write_pass2(
        mstats, table.sample_ids, merged.llk_ab, merged.llk_00,
        [0.0, 0.5], 0.5, s2, sb,
    )
    assert (s1.getvalue(), s2.getvalue(), sb.getvalue()) == full


def test_owns_barcode_partition():
    bcs = ["BC%05d" % i for i in range(500)]
    for n in (1, 2, 5):
        owners = [
            [b for b in bcs if mh.owns_barcode(b, k, n)] for k in range(n)
        ]
        assert sorted(b for o in owners for b in o) == sorted(bcs)
        flat = [b for o in owners for b in o]
        assert len(flat) == len(set(flat))


def test_gather_results_single_process():
    r = mh.ShardResult(
        barcodes=["B2", "B1"], totl=np.array([2, 1]), pass_=np.array([2, 1]),
        uniq=np.array([2, 1]), nsnp=np.array([2, 1]),
        llks=np.zeros((2, 3)), llk0s=np.zeros(2),
        llk_ab=np.zeros((2, 3, 3, 2)), llk_00=np.zeros((2, 2)),
    )
    m = mh.gather_results(r)
    assert m.barcodes == ["B1", "B2"]
    assert list(m.totl) == [1, 2]


def test_shard_merge_invariance_native(tmp_path):
    """Same shard-merge invariance through the native C++ ingest."""
    pytest.importorskip("demuxlet_jax.native.ingest")
    from demuxlet_jax.native import ingest as native

    if not native.available():
        pytest.skip("native ingest not built")
    rng = random.Random(19)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=20, n_snps=30, n_samples=3, reads_per_cell=40
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    full, _ = native.build_pileup(bam, table)
    bcs = []
    for k in range(3):
        s, _ = native.build_pileup(bam, table, n_shards=3, shard_id=k)
        bcs.extend(s.barcodes)
    assert sorted(bcs) == sorted(full.barcodes)
    assert len(bcs) == len(set(bcs))


def _write_workload(tmp_path, seed=21, n_cells=24):
    rng = random.Random(seed)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=n_cells, n_snps=40, n_samples=3, reads_per_cell=50
    )
    vcf = write_vcf(str(tmp_path / "d.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "d.bam"), contigs, reads)
    return vcf, bam


def _cli_env(n_devices=1):
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "true"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    return env


def _run_cli(args, env, timeout=300):
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "-m", "demuxlet_jax.cli"] + args,
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    return p


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_two_process_jax_distributed_cli(tmp_path, mode):
    """REAL 2-process jax.distributed run: two CLI processes join via a
    localhost coordinator with --num-shards 2, each demuxes its barcode
    stripe, compact rows all-gather, and process 0 writes outputs that are
    byte-identical to the single-process run."""
    import socket
    import subprocess
    import sys

    vcf, bam = _write_workload(tmp_path)
    env = _cli_env()

    # single-process reference
    _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode", mode,
              "--out", str(tmp_path / "ref"), "--device", "cpu",
              "--mesh", "none"], env)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    procs = []
    for k in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
             "--vcf", vcf, "--field", "GT", "--mode", mode,
             "--out", str(tmp_path / "dist"), "--device", "cpu",
             "--mesh", "none", "--num-shards", "2", "--shard-id", str(k),
             "--dist-coordinator", coord],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        errs.append(err)
        assert p.returncode == 0, err[-4000:]
    if mode == "exact":
        # f64 exact path: byte-identical regardless of block composition
        for ext in (".single", ".sing2", ".best"):
            want = open(str(tmp_path / "ref") + ext).read()
            got = open(str(tmp_path / "dist") + ext).read()
            assert got == want, f"{mode}{ext} differs\n{errs[0][-1500:]}"
    else:
        # fast f32: block composition differs per shard, so padded slot
        # bucketing and reduction trees differ -> LLKs agree only to the
        # documented fast-mode tolerance; calls must be identical
        # (canonicalized for the symmetric alpha=0.5 pair-order fp tie).
        from parity_utils import canonicalize_best

        want = canonicalize_best(
            open(str(tmp_path / "ref") + ".best").read().splitlines()
        )
        got = canonicalize_best(
            open(str(tmp_path / "dist") + ".best").read().splitlines()
        )
        assert len(want) == len(got)
        for lw, lg in zip(want, got):
            cw, cg = lw.split("\t"), lg.split("\t")
            assert cw[0] == cg[0]
            if cw[0] == "BARCODE":
                continue
            assert cw[5].split("-")[0] == cg[5].split("-")[0], (lw, lg)
            for col in (6, 11, 12):  # SNG.1ST, DBL.1ST, DBL.2ND
                assert cw[col] == cg[col], (lw, lg)
            for col in (7, 9, 10, 14):  # LLK columns ~tolerance
                assert abs(float(cw[col]) - float(cg[col])) < 1e-2, (lw, lg)


def test_two_process_fast_stripe_bit_parity(tmp_path):
    """Fast-mode distributed parity, TIGHT (VERDICT r2 #9): for each
    shard k, a single-process run restricted to exactly shard k's
    barcodes (--group-list of the crc32%2==k stripe — the same predicate
    as mh.owns_barcode) reproduces that process's block composition, so
    its f32 LLKs must be BIT-identical to the distributed run's rows for
    those barcodes. The loose 1e-2 tolerance in
    test_two_process_jax_distributed_cli remains only for the
    cross-composition comparison against the unsharded run."""
    import socket
    import subprocess
    import sys

    vcf, bam = _write_workload(tmp_path, seed=29)
    env = _cli_env()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
         "--vcf", vcf, "--field", "GT", "--mode", "fast",
         "--out", str(tmp_path / "dist"), "--device", "cpu",
         "--mesh", "none", "--num-shards", "2", "--shard-id", str(k),
         "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]

    def rows_by_bc(path):
        out = {}
        for line in open(path).read().splitlines():
            bc = line.split("\t", 1)[0]
            if bc != "BARCODE":
                out[bc] = line
        return out

    dist = {ext: rows_by_bc(str(tmp_path / "dist") + ext)
            for ext in (".single", ".sing2", ".best")}
    all_bcs = sorted(dist[".single"])
    covered = 0
    for k in range(2):
        stripe = [b for b in all_bcs if mh.owns_barcode(b, k, 2)]
        assert stripe, "degenerate stripe — pick another seed"
        glist = str(tmp_path / f"stripe{k}.txt")
        with open(glist, "w") as fh:
            fh.write("\n".join(stripe) + "\n")
        _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT",
                  "--mode", "fast", "--out", str(tmp_path / f"solo{k}"),
                  "--device", "cpu", "--mesh", "none",
                  "--group-list", glist], env)
        for ext in (".single", ".sing2", ".best"):
            solo = rows_by_bc(str(tmp_path / f"solo{k}") + ext)
            assert sorted(solo) == stripe
            for bc in stripe:
                assert dist[ext][bc] == solo[bc], (k, ext, bc)
        covered += len(stripe)
    assert covered == len(all_bcs)


def test_two_process_distributed_write_pair(tmp_path):
    """--write-pair in distributed mode gathers the full tensor; .pair from
    process 0 matches the single-process .pair byte-for-byte."""
    import socket
    import subprocess
    import sys

    vcf, bam = _write_workload(tmp_path, seed=23, n_cells=16)
    env = _cli_env()
    _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT", "--write-pair",
              "--out", str(tmp_path / "ref"), "--device", "cpu",
              "--mesh", "none"], env)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
         "--vcf", vcf, "--field", "GT", "--write-pair",
         "--out", str(tmp_path / "dist"), "--device", "cpu",
         "--mesh", "none", "--num-shards", "2", "--shard-id", str(k),
         "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    for ext in (".single", ".sing2", ".best", ".pair"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        assert got == want, f"{ext} differs"


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_cli_mesh_auto_matches_single_device(tmp_path, mode):
    """--mesh auto over the 8 virtual CPU devices == --mesh none, byte for
    byte (barcode-axis sharding is exact: no cross-cell reductions)."""
    vcf, bam = _write_workload(tmp_path, seed=29, n_cells=20)
    env = _cli_env(n_devices=4)
    common = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode", mode,
              "--device", "cpu", "--cell-block", "64"]
    _run_cli(common + ["--out", str(tmp_path / "one"), "--mesh", "none"], env)
    _run_cli(common + ["--out", str(tmp_path / "mesh"), "--mesh", "auto"], env)
    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "one") + ext).read()
        got = open(str(tmp_path / "mesh") + ext).read()
        assert got == want, f"{mode}{ext} differs under mesh"


def test_cli_mesh_bxs_exact(tmp_path):
    """--mesh 2x2 (barcode x slot psum) == single device in exact mode."""
    vcf, bam = _write_workload(tmp_path, seed=31, n_cells=12)
    env = _cli_env(n_devices=4)
    common = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode", "exact",
              "--device", "cpu", "--cell-block", "32"]
    _run_cli(common + ["--out", str(tmp_path / "one"), "--mesh", "none"], env)
    _run_cli(common + ["--out", str(tmp_path / "mesh"), "--mesh", "2x2"], env)
    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "one") + ext).read()
        got = open(str(tmp_path / "mesh") + ext).read()
        assert got == want, f"{ext} differs under 2x2 mesh"


def test_two_process_genome_sharded_cli(tmp_path):
    """--shard-by genome: 2 processes each ingest ONLY their genome span
    (BAI-seeked), per-shard LLK contributions SUM at the gather, and
    process 0's outputs are byte-identical to the single-process run."""
    import socket
    import subprocess
    import sys

    rng = random.Random(77)
    parts = []
    contigs = []
    for c in range(2):
        cg, names, variants, reads, truth = random_workload(
            random.Random(77 + c), n_cells=14, n_snps=20, n_samples=3,
            reads_per_cell=40, chrom=f"chr{c + 1}",
        )
        contigs.append((f"chr{c + 1}", cg[0][1]))
        parts.append((variants, reads))
    variants = [v for vs, _ in parts for v in vs]
    reads = [r for _, rs in parts for r in rs]
    vcf = write_vcf(str(tmp_path / "g.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "g.bam"), contigs, reads)

    env = _cli_env()
    _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode",
              "exact", "--out", str(tmp_path / "ref"), "--device", "cpu",
              "--mesh", "none"], env)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
         "--vcf", vcf, "--field", "GT", "--mode", "exact",
         "--out", str(tmp_path / "dist"), "--device", "cpu",
         "--mesh", "none", "--num-shards", "2", "--shard-id", str(k),
         "--shard-by", "genome", "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(2)]
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        errs.append(err)
        assert p.returncode == 0, err[-4000:]
    from parity_utils import canonicalize_best

    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        if ext == ".best":
            # alpha=0.5 mirrored pairs are exact real-arithmetic ties;
            # shard-summed f64 rounds the mirror differently (documented
            # exact-mode contract)
            want = "\n".join(canonicalize_best(want.splitlines()))
            got = "\n".join(canonicalize_best(got.splitlines()))
        assert got == want, f"{ext} differs\n{errs[0][-1500:]}"


def test_two_process_genome_shard_with_zero_snps(tmp_path):
    """A genome shard whose region contains NO SNPs must still join the
    distributed gather with an empty contribution (regression: it used to
    fail the chrom-order check and deadlock the peer) and must not count
    any reads outside its regions (regression: an all-dropped region list
    used to disable ownership entirely, double-counting RD.TOTL)."""
    import socket
    import subprocess
    import sys

    from fixtures import SimRead

    cg, names, variants, reads, truth = random_workload(
        random.Random(7), n_cells=10, n_snps=20, n_samples=3,
        reads_per_cell=30, chrom="chr1",
    )
    contigs = [("chr1", cg[0][1]), ("chr2", cg[0][1])]  # chr2: reads, 0 SNPs
    for c in range(5):
        reads.append(SimRead("chr2", 100 + c * 10, "ACGTACGTAC", [30] * 10,
                             cb="BC%05d" % c, ub=f"x{c}"))
    reads.sort(key=lambda r: (0 if r.chrom == "chr1" else 1, r.pos0))
    vcf = write_vcf(str(tmp_path / "z.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "z.bam"), contigs, reads)

    env = _cli_env()
    _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode",
              "exact", "--out", str(tmp_path / "ref"), "--device", "cpu",
              "--mesh", "none"], env)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
         "--vcf", vcf, "--field", "GT", "--mode", "exact",
         "--out", str(tmp_path / "dist"), "--device", "cpu",
         "--mesh", "none", "--num-shards", "2", "--shard-id", str(k),
         "--shard-by", "genome", "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        assert got == want, f"{ext} differs"


def test_two_process_distributed_with_mesh(tmp_path):
    """Multi-host AND multi-chip together: 2 processes x 2-device local
    meshes; outputs byte-identical to the plain single-process run."""
    import socket
    import subprocess
    import sys

    vcf, bam = _write_workload(tmp_path, seed=83, n_cells=16)
    env = _cli_env(n_devices=2)
    _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode",
              "exact", "--out", str(tmp_path / "ref"), "--device", "cpu",
              "--mesh", "none"], env)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
         "--vcf", vcf, "--field", "GT", "--mode", "exact",
         "--out", str(tmp_path / "dist"), "--device", "cpu",
         "--mesh", "auto", "--cell-block", "32",
         "--num-shards", "2", "--shard-id", str(k),
         "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        assert got == want, f"{ext} differs"


def test_two_process_genome_sharded_cli_indexed_vcf(tmp_path):
    # NOTE .best is compared canonicalized: the two-shard LLK sum reorders
    # the SNP reduction, and on the CPU XLA exact path the (j,k)/(k,j)
    # alpha=0.5 mirrors are computed independently — ulp ties can resolve
    # to the mirrored doublet order (documented contract, parity_utils).
    """Genome shards over a .tbi-indexed .vcf.gz (each process index-seeks
    only its regions' VCF ranges) produce byte-identical outputs to the
    single-process plain-VCF run."""
    import socket
    import subprocess
    import sys

    from fixtures import write_tabix
    from demuxlet_jax.io.vcf import VcfReader

    rng = random.Random(37)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=20, n_snps=40, n_samples=3, reads_per_cell=50
    )
    vcf = write_vcf(str(tmp_path / "d.vcf"), names, variants,
                    contigs=contigs)
    gz = write_vcf(str(tmp_path / "d.vcf.gz"), names, variants,
                   contigs=contigs)
    write_tabix(gz, contigs)
    bam = write_bam(str(tmp_path / "d.bam"), contigs, reads)
    # sanity: the index path actually engages for this input
    regions = [(contigs[0][0], 1, contigs[0][1])]
    assert VcfReader(gz).iter_regions(regions) is not None

    env = _cli_env()
    _run_cli(["--sam", bam, "--vcf", vcf, "--field", "GT",
              "--out", str(tmp_path / "ref"), "--device", "cpu",
              "--mesh", "none"], env)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli", "--sam", bam,
         "--vcf", gz, "--field", "GT",
         "--out", str(tmp_path / "dist"), "--device", "cpu",
         "--mesh", "none", "--num-shards", "2", "--shard-id", str(k),
         "--shard-by", "genome", "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    from parity_utils import canonicalize_best

    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        if ext == ".best":
            want = canonicalize_best(want.splitlines())
            got = canonicalize_best(got.splitlines())
        assert got == want, f"{ext} differs"


@pytest.mark.slow
def test_two_process_distributed_tiled_pool(tmp_path):
    """Multi-host at a large pool size (V=16), two ways:

    1. Single-process runs restricted to each crc32 stripe (--group-list
       of mh.owns_barcode, reproducing a distributed shard's exact block
       composition) must be byte-identical to the unsharded rows.
    2. A real 2-process jax.distributed run must be byte-identical to
       the reference."""
    import socket
    import subprocess
    import sys

    rng = random.Random(33)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=16, n_snps=30, n_samples=16, reads_per_cell=50
    )
    vcf = write_vcf(str(tmp_path / "d.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "d.bam"), contigs, reads)
    env = _cli_env()
    common = ["--sam", bam, "--vcf", vcf, "--field", "GT",
              "--mode", "exact", "--device", "cpu", "--mesh", "none",
              "--cell-block", "16"]
    _run_cli(common + ["--out", str(tmp_path / "ref")], env, timeout=1200)

    def rows_by_bc(path):
        return {ln.split("\t", 1)[0]: ln
                for ln in open(path).read().splitlines()
                if not ln.startswith("BARCODE")}

    ref_rows = {ext: rows_by_bc(str(tmp_path / "ref") + ext)
                for ext in (".single", ".sing2", ".best")}
    bcs = sorted(ref_rows[".single"])
    for k in range(2):
        stripe = [b for b in bcs if mh.owns_barcode(b, k, 2)]
        assert stripe, "degenerate stripe - pick another seed"
        glist = str(tmp_path / f"stripe{k}.txt")
        with open(glist, "w") as fh:
            fh.write("\n".join(stripe) + "\n")
        _run_cli(common + ["--out", str(tmp_path / f"solo{k}"),
                           "--group-list", glist], env, timeout=1800)
        from parity_utils import canonicalize_best

        for ext in (".single", ".sing2", ".best"):
            solo = rows_by_bc(str(tmp_path / f"solo{k}") + ext)
            assert sorted(solo) == stripe
            for bc in stripe:
                want, got = ref_rows[ext][bc], solo[bc]
                if ext == ".best":
                    # symmetric alpha=0.5 doublet pair order is an exact
                    # real-arithmetic tie; blockings may resolve to
                    # mirrored pairs (documented contract)
                    want = canonicalize_best([want])[0]
                    got = canonicalize_best([got])[0]
                assert got == want, (k, ext, bc)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli"] + common +
        ["--out", str(tmp_path / "dist"), "--num-shards", "2",
         "--shard-id", str(k), "--dist-coordinator", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    ) for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=1200)
        assert p.returncode == 0, err[-4000:]
    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        assert got == want, f"{ext} differs at V=16 distributed"


def _dist_procs(common, out, coord_n, env, extra=None):
    """Launch coord_n CLI processes joined via a fresh localhost
    coordinator; returns after all exit 0."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli"] + common +
        ["--out", out, "--num-shards", str(coord_n), "--shard-id", str(k),
         "--dist-coordinator", coord] + (extra or []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(coord_n)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=900)
        errs.append(err)
        assert p.returncode == 0, err[-4000:]
    return errs


def test_three_process_barcode_sharded_cli(tmp_path):
    """P=3 barcode sharding (exact): every multi-process test so far ran
    P=2, where the compact gather's reordering happens to be
    fp-symmetric; barcode-sharded rows are computed whole by their owner
    at any P, so process 0's outputs must stay BYTE-identical to the
    single-process run (VERDICT r4 #4)."""
    vcf, bam = _write_workload(tmp_path, seed=43, n_cells=27)
    env = _cli_env()
    common = ["--sam", bam, "--vcf", vcf, "--field", "GT",
              "--mode", "exact", "--device", "cpu", "--mesh", "none"]
    _run_cli(common + ["--out", str(tmp_path / "ref")], env)
    errs = _dist_procs(common, str(tmp_path / "dist"), 3, env)
    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read()
        got = open(str(tmp_path / "dist") + ext).read()
        assert got == want, f"P=3 {ext} differs\n{errs[0][-1500:]}"


def _render_quantum(s: str) -> float:
    """Smallest rendered step of a printf-formatted number: one unit in
    the last printed decimal (fixed) or significant (e-notation) digit."""
    s = s.strip()
    if "e" in s or "E" in s:
        mant, _, exp = s.lower().partition("e")
        dec = len(mant.split(".")[1]) if "." in mant else 0
        return 10.0 ** (int(exp) - dec)
    dec = len(s.split(".")[1]) if "." in s else 0
    return 10.0 ** (-dec)


def _assert_rows_close(want_line: str, got_line: str, ctx):
    """Rendered rows equal up to ONE rendering quantum per float field —
    tolerates the documented P>2 psum-reorder ulp, catches any real
    merge bug (which shifts values by many quanta)."""
    cw, cg = want_line.split("\t"), got_line.split("\t")
    assert len(cw) == len(cg), ctx
    for a, b in zip(cw, cg):
        if a == b:
            continue
        fa, fb = float(a), float(b)  # non-float mismatch raises -> fail
        tol = 1.5 * max(_render_quantum(a), _render_quantum(b))
        assert abs(fa - fb) <= tol, (ctx, a, b, tol)


def test_four_process_genome_sharded_cli(tmp_path):
    """P=4 genome sharding: the SUM-merge (psum_scatter) adds per-shard
    LLK contributions in device order, which is documented ~1-ulp
    nondeterministic beyond P=2 (parallel/multihost.py) — and was never
    exercised past P=2. Calls and ids must match the single-process run
    exactly; every rendered float must agree to one rendering quantum,
    so a real merge bug (wrong/missing shard contribution) cannot hide
    behind the ulp caveat (VERDICT r4 #4)."""
    parts = []
    contigs = []
    names = None
    for c in range(2):
        cg, names, variants, reads, truth = random_workload(
            random.Random(87 + c), n_cells=15, n_snps=24, n_samples=3,
            reads_per_cell=40, chrom=f"chr{c + 1}",
        )
        contigs.append((f"chr{c + 1}", cg[0][1]))
        parts.append((variants, reads))
    variants = [v for vs, _ in parts for v in vs]
    reads = [r for _, rs in parts for r in rs]
    vcf = write_vcf(str(tmp_path / "g4.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "g4.bam"), contigs, reads)

    env = _cli_env()
    common = ["--sam", bam, "--vcf", vcf, "--field", "GT",
              "--mode", "exact", "--device", "cpu", "--mesh", "none"]
    _run_cli(common + ["--out", str(tmp_path / "ref")], env)
    errs = _dist_procs(common, str(tmp_path / "dist"), 4, env,
                       extra=["--shard-by", "genome"])

    from parity_utils import canonicalize_best

    for ext in (".single", ".sing2", ".best"):
        want = open(str(tmp_path / "ref") + ext).read().splitlines()
        got = open(str(tmp_path / "dist") + ext).read().splitlines()
        if ext == ".best":
            want = canonicalize_best(want)
            got = canonicalize_best(got)
        assert len(want) == len(got), (ext, errs[0][-1500:])
        for lw, lg in zip(want, got):
            if lw == lg:
                continue
            if ext == ".best":
                # call string + ids must be exact; only LLK/posterior
                # columns may move by a quantum
                cw, cg = lw.split("\t"), lg.split("\t")
                for col in (0, 5, 6, 8, 11, 12):  # BARCODE..BEST..ids
                    assert cw[col] == cg[col], (ext, lw, lg)
            _assert_rows_close(lw, lg, (ext, lw[:60]))
