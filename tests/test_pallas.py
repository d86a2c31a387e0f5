"""Fast-mode block step: the Pallas-Triton pair kernel (interpret mode on
CPU) and the plain XLA f32 route vs the exact f64 contraction."""

import numpy as np
import pytest

import jax.numpy as jnp

from demuxlet_jax.models.likelihood import pair_llks, singlet_llks
from demuxlet_jax.ops import luts
from demuxlet_jax.ops.pallas_pair import (
    dedup_channels,
    demux_block_fast,
    extend_luts,
    plan_tiles,
)


def _codes_case(B, S, V, grid, U=2, NS=50, seed=0):
    """A codes-path block (the engine's fast-mode input) plus its dense
    f64 reference tensors: per-UMI codes -> counts, gathered gps rows,
    masked slots neutral."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 82, size=(B, S, U)).astype(np.uint8)
    codes[rng.random((B, S, U)) < 0.3] = 255
    idx = rng.integers(0, NS, size=(B, S)).astype(np.int32)
    msk = rng.random((B, S)) < 0.8
    codes[~msk] = 255  # build_codes_block contract: masked slots empty
    gtab = rng.dirichlet(np.ones(3), size=(NS, V)).astype(np.float32)
    g0tab = gtab.mean(axis=1)
    cnt = np.zeros((B, S, 82), dtype=np.int32)
    for u in range(U):
        cu = codes[..., u]
        ok = cu != 255
        bi, si = np.nonzero(ok)
        np.add.at(cnt, (bi, si, cu[ok].astype(np.int64)), 1)
    neutral = np.array([1.0, 0.0, 0.0])
    gps_g = np.where(msk[..., None, None], gtab.astype(np.float64)[idx],
                     neutral)
    gp0_g = np.where(msk[..., None], g0tab.astype(np.float64)[idx], neutral)
    return (codes, idx, msk, gtab, g0tab), (cnt, msk, gps_g, gp0_g)


def _fast(dev, V, grid, opt, **kw):
    cols, expand = dedup_channels(grid)
    w_ext, logf_ext = extend_luts(
        luts.pair_lut(grid, 40)[:, list(cols)], luts.singlet_lut(40))
    args = tuple(jnp.asarray(x) for x in dev) + (
        jnp.asarray(w_ext), jnp.asarray(logf_ext))
    return demux_block_fast(
        *args, len(grid), V, expand=expand,
        a0_sep=opt and grid[0] == 0.0,
        sym_a=grid.index(0.5) if opt and 0.5 in grid else None, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return (np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max()


@pytest.mark.parametrize(
    "B,S,V,A,opt",
    [
        (4, 64, 3, 2, False),
        (6, 100, 4, 3, False),
        # S=200 is no multiple of the kernel's slot step: neutral slot
        # padding inside the kernel wrapper; opt turns on a0_sep + sym_a
        (4, 200, 3, 2, True),
        (6, 100, 4, 3, True),
        # V=16: two 8-sample tiles per axis; 17: sample-axis padding
        # (Vp=24, neutral rows dropped at reassembly); 32 triangular
        # default grid
        (4, 64, 16, 2, False),
        (4, 200, 17, 3, True),
        (4, 64, 32, 2, True),
        # single-point alpha=0 grid: no kernel planes at all — the
        # separable plane carries the whole result
        (4, 64, 20, 1, True),
        # triangular AND sample-padded: V=20 on the default [0, 0.5]
        # grid -> Vp=24, upper-triangle tiles with neutral padded rows
        (4, 64, 20, 2, True),
    ],
)
def test_pallas_matches_exact(B, S, V, A, opt):
    """The Triton kernel route (interpret mode) against the exact f64
    contraction, within fast mode's stated 1e-4 relative contract."""
    grid = np.linspace(0, 0.5, A).tolist()
    dev, (cnt, msk, gps_g, gp0_g) = _codes_case(B, S, V, grid)
    ref_ab, ref_00 = pair_llks(
        jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps_g),
        jnp.asarray(gp0_g), jnp.asarray(luts.pair_lut(grid, 40)), A,
    )
    ref_l, ref_l0 = singlet_llks(
        jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps_g),
        jnp.asarray(gp0_g), jnp.asarray(luts.singlet_lut(40)),
    )
    llk, llk0, ab, z0 = _fast(dev, V, grid, opt, pair_impl="triton",
                              interpret=True)
    assert ab.shape == (B, V, V, A) and z0.shape == (B, A)
    assert _rel(ab, ref_ab) < 1e-4
    assert _rel(z0, ref_00) < 1e-4
    assert _rel(llk, ref_l) < 1e-4
    assert _rel(llk0, ref_l0) < 1e-4


@pytest.mark.parametrize(
    "B,S,V,grid,cfg",
    [
        # odd V, cells no TB multiple, slots no (TS * log_batch) multiple
        (5, 40, 1, [0.0, 0.5], ()),
        (3, 72, 3, [0.0, 0.5], ()),
        (9, 33, 5, [0.0, 0.25, 0.5], ()),
        (7, 50, 9, [0.0, 0.5], (("TB", 4), ("TS", 16))),
        (4, 64, 11, [0.1, 0.5], (("log_batch", 1),)),
        (4, 64, 6, [0.0, 0.1, 0.2, 0.3, 0.5], (("kt_max", 4),)),
        (2, 128, 17, [0.0, 0.5], (("min_programs", 1),)),
        (6, 96, 4, [0.2, 0.3], (("num_warps", 2),)),
    ],
)
def test_triton_kernel_matches_plain_f32(B, S, V, grid, cfg):
    """Kernel (interpret mode) vs the plain f32 XLA contraction through
    the same front: they differ only in summation and log-batching
    order, |err| <= 1e-5 * max(1, |ref|)."""
    dev, _ = _codes_case(B, S, V, grid, seed=B + V)
    ref = _fast(dev, V, grid, True, pair_impl="xla")
    got = _fast(dev, V, grid, True, pair_impl="triton", interpret=True,
                kernel_cfg=cfg)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) < 1e-5


def test_plan_pair_tiles_shapes():
    """Tile-plan invariants: the tile is the smallest power of two that
    covers small pools; the default [0, 0.5] grid enumerates only upper-
    triangle tiles; padded sample counts round up to the tile size."""
    assert plan_tiles(2, 2, True, 1) == (2, 2, ((0, 0),), (1,))
    assert plan_tiles(5, 5, True, 4)[:2] == (8, 8)
    # V=32 default grid: a0_sep leaves only the symmetric alpha=0.5 plane
    Kt, Vp, tiles, ac_list = plan_tiles(32, 2, True, 1)
    assert (Kt, Vp, ac_list) == (8, 32, (1,))
    assert len(tiles) == 10 and all(j <= k for j, k in tiles)
    # V=17 pads to 24; a 5-alpha grid tiles all of a>=1 on the full square
    Kt, Vp, tiles, ac_list = plan_tiles(17, 5, True, 4)
    assert (Kt, Vp, ac_list) == (8, 24, (1, 2, 3, 4)) and len(tiles) == 9
    # no separable plane: every alpha is a kernel plane
    assert plan_tiles(4, 2, False, 1)[3] == (0, 1)


def test_engine_fast_vs_exact_tiled_pool(tmp_path):
    """Engine-level parity at a tiled pool size (V=16 > unroll cap):
    fast-mode LLKs match the XLA f64 exact path within fast tolerance."""
    import random

    from demuxlet_jax.host.pileup import build_pileup
    from demuxlet_jax.io.bam import AlignmentReader
    from demuxlet_jax.io.vcf import load_snp_table
    from demuxlet_jax.models.engine import DemuxEngine
    from fixtures import random_workload, write_bam, write_vcf

    rng = random.Random(21)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=12, n_snps=30, n_samples=16, reads_per_cell=50
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    scl, _ = build_pileup(AlignmentReader(bam), table)

    grid = [0.0, 0.5]
    rf = DemuxEngine(table.gps, grid, cell_block=8, mode="fast").run(scl)
    rx = DemuxEngine(table.gps, grid, cell_block=8, mode="exact").run(scl)
    scale = np.maximum(1.0, np.abs(rx.llk_ab))
    assert (np.abs(rf.llk_ab - rx.llk_ab) / scale).max() < 2e-4
    assert (np.abs(rf.llk_00 - rx.llk_00)
            / np.maximum(1.0, np.abs(rx.llk_00))).max() < 2e-4
    assert (np.abs(rf.llks - rx.llks)
            / np.maximum(1.0, np.abs(rx.llks))).max() < 2e-4


def test_fast_engine_same_calls(tmp_path):
    """Fast-mode engine produces identical .best calls on a synthetic run."""
    import random

    from demuxlet_jax.host.pileup import build_pileup
    from demuxlet_jax.io.bam import AlignmentReader
    from demuxlet_jax.io.vcf import load_snp_table
    from demuxlet_jax.models.engine import DemuxEngine, cell_stats
    from demuxlet_jax.models import outputs as out_mod
    from fixtures import random_workload, write_bam, write_vcf

    rng = random.Random(5)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=20, n_snps=40, n_samples=3, reads_per_cell=60
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    rdr = AlignmentReader(bam)
    scl, _ = build_pileup(rdr, table)
    stats = cell_stats(scl)

    def calls(mode):
        eng = DemuxEngine(table.gps, [0.0, 0.5], cell_block=8, mode=mode)
        res = eng.run(scl)
        import io

        s2, sb = io.StringIO(), io.StringIO()
        out_mod.write_pass2(
            stats, table.sample_ids, res.llk_ab, res.llk_00,
            [0.0, 0.5], 0.5, s2, sb,
        )
        out = []
        for ln in sb.getvalue().splitlines()[1:]:
            best = ln.split("\t")[5]
            if best.startswith("DBL-"):
                # (j,k,0.5) and (k,j,0.5) are the same call: the doublet LLK
                # is symmetric at alpha=0.5 and the argmax tie is broken by
                # fp rounding luck (also true of the reference). Canonicalize.
                _, a, b, al = best.split("-")
                best = "DBL-%s-%s-%s" % (min(a, b), max(a, b), al)
            out.append(best)
        return out

    assert calls("fast") == calls("exact")


def test_compact_decision_path_bytes(tmp_path):
    """run_compact + write_pass2_compact == run + write_pass2 byte-for-byte
    in fast mode (the device decision pass ships ~30 scalars/cell)."""
    import io
    import random

    from demuxlet_jax.host.pileup import build_pileup
    from demuxlet_jax.io.bam import AlignmentReader
    from demuxlet_jax.io.vcf import load_snp_table
    from demuxlet_jax.models import outputs as out_mod
    from demuxlet_jax.models.engine import DemuxEngine, cell_stats
    from fixtures import random_workload, write_bam, write_vcf

    rng = random.Random(8)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=22, n_snps=40, n_samples=3, reads_per_cell=60
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    table = load_snp_table(vcf, field_name="GT")
    scl, _ = build_pileup(AlignmentReader(bam), table)
    stats = cell_stats(scl)
    grid = [0.0, 0.3, 0.5]
    eng = DemuxEngine(table.gps, grid, cell_block=8, mode="fast")

    res = eng.run(scl)
    s2a, sba = io.StringIO(), io.StringIO()
    out_mod.write_pass2(
        stats, table.sample_ids, res.llk_ab, res.llk_00, grid, 0.5, s2a, sba
    )

    llks, llk0s, compact = eng.run_compact(scl, doublet_prior=0.5)
    s2b, sbb = io.StringIO(), io.StringIO()
    out_mod.write_pass2_compact(
        stats, table.sample_ids, compact, grid, 0.5, s2b, sbb
    )
    assert s2b.getvalue() == s2a.getvalue()
    assert sbb.getvalue() == sba.getvalue()
    import numpy as np

    np.testing.assert_allclose(llks, res.llks, rtol=0, atol=0)


def test_allele2_only_slot_keeps_uniform_gl_term():
    """A slot whose only observations are allele==2 carries no codes but
    must stay masked-in: the reference includes the SNP in the cell's
    covered set and every sample's LLK gains the uniform-GL log(1/3) term
    (cmd_cram_demuxlet.cpp:426-459 with the :435 skip). The shrunk fast
    path (msk derived on device) marks such slots with the reserved code
    254 — without it they would silently drop ~1.1 nats per slot."""
    import random

    import numpy as np

    from demuxlet_jax.models.engine import DemuxEngine
    from oracle.numpy_oracle import PileupData, compute_gp0s, pass1_singlet

    rng = random.Random(11)
    nv, nsnps = 3, 8
    g = np.random.RandomState(11).dirichlet([2, 2, 2], size=(nsnps, nv))
    scl = PileupData([f"S{i}" for i in range(nv)], list(g))
    for c in range(2):
        scl.add_cell(f"BC{c:03d}")
        for u in range(12):
            s = 1 + rng.randrange(nsnps - 1)
            scl.cell_totl[c] += 1
            scl.add_read(s, c, f"U{u}", rng.choice([0, 1]), 30)
    # cell 0, snp 0: only mismatch-both observations -> zero codes
    scl.cell_totl[0] += 2
    scl.add_read(0, 0, "UX1", 2, 30)
    scl.add_read(0, 0, "UX2", 2, 30)

    gp0s = compute_gp0s(scl)
    o_llks, o_llk0s = pass1_singlet(scl, gp0s)

    eng = DemuxEngine(np.stack(scl.snp_gps), [0.0, 0.5], mode="fast")
    res = eng.run(scl)
    np.testing.assert_allclose(res.llks, o_llks, rtol=0, atol=2e-3)
    np.testing.assert_allclose(res.llk0s, o_llk0s, rtol=0, atol=2e-3)
