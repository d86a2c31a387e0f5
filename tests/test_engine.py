"""Device engine vs NumPy oracle: LLK parity and byte-identical outputs."""

import io
import math
import random

import numpy as np
import pytest

from demuxlet_jax.models.engine import DemuxEngine, cell_stats, compute_gp0
from demuxlet_jax.models import outputs as out_mod
from oracle.numpy_oracle import (
    PileupData,
    compute_gp0s,
    pass1_singlet,
    pass2_cell,
    pass2_outputs,
    write_single,
)


def _random_pileup(seed, nv=3, nsnps=40, ncells=10, numis=60):
    rng = random.Random(seed)
    g = np.random.RandomState(seed).dirichlet([2, 2, 2], size=(nsnps, nv))
    scl = PileupData(
        [f"S{i}" for i in range(nv)], [g[i] for i in range(nsnps)]
    )
    for c in range(ncells):
        scl.add_cell(f"BC{c:03d}")
        for _ in range(numis):
            s = rng.randrange(nsnps)
            scl.cell_totl[c] += 1
            scl.add_read(
                s,
                c,
                f"U{rng.randrange(10000)}",
                rng.choice([0, 0, 1, 1, 2]),
                rng.randrange(13, 41),
            )
    return scl


GRID = [0.0, 0.5]
GRID5 = [0.0, 0.1, 0.2, 0.3, 0.5]


@pytest.mark.parametrize("seed,grid", [(1, GRID), (2, GRID), (3, GRID5)])
def test_llk_parity(seed, grid):
    scl = _random_pileup(seed)
    gps = np.stack(scl.snp_gps)
    gp0s = compute_gp0s(scl)
    np.testing.assert_array_equal(compute_gp0(gps), gp0s)

    eng = DemuxEngine(gps, grid, cell_block=4, slot_chunk=8)
    res = eng.run(scl)

    o_llks, o_llk0s = pass1_singlet(scl, gp0s)
    np.testing.assert_allclose(res.llks, o_llks, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.llk0s, o_llk0s, rtol=0, atol=1e-9)

    for c in range(scl.nbcs):
        ab, _, z0 = pass2_cell(scl, gp0s, c, grid)
        np.testing.assert_allclose(res.llk_ab[c], ab, rtol=0, atol=1e-9)
        np.testing.assert_allclose(res.llk_00[c], z0, rtol=0, atol=1e-9)


def _engine_lines(scl, grid, doublet_prior=0.5, write_pair=True, **filt):
    gps = np.stack(scl.snp_gps)
    eng = DemuxEngine(gps, grid, cell_block=8)
    res = eng.run(scl)
    stats = cell_stats(scl)
    s1 = io.StringIO()
    out_mod.write_single(s1, stats, scl.sample_ids, res.llks, res.llk0s, **filt)
    s2, sp, sb = io.StringIO(), io.StringIO(), io.StringIO()
    out_mod.write_pass2(
        stats,
        scl.sample_ids,
        res.llk_ab,
        res.llk_00,
        grid,
        doublet_prior,
        s2,
        sb,
        sp if write_pair else None,
        **filt,
    )
    return (
        s1.getvalue().rstrip("\n").split("\n"),
        s2.getvalue().rstrip("\n").split("\n"),
        sp.getvalue().rstrip("\n").split("\n") if write_pair else None,
        sb.getvalue().rstrip("\n").split("\n"),
    )


@pytest.mark.parametrize("seed,grid", [(1, GRID), (4, GRID5)])
def test_output_byte_parity(seed, grid):
    scl = _random_pileup(seed, nv=4, ncells=9)
    gps = np.stack(scl.snp_gps)
    gp0s = compute_gp0s(scl)

    e_single, e_sing2, e_pair, e_best = _engine_lines(scl, grid)

    o_llks, o_llk0s = pass1_singlet(scl, gp0s)
    o_single = write_single(scl, o_llks, o_llk0s)
    o_sing2, o_pair, o_best = pass2_outputs(scl, gp0s, grid, write_pair=True)

    assert e_single == o_single
    assert e_sing2 == o_sing2
    assert e_pair == o_pair
    # .best compared modulo the symmetric-pair fp coin flip (parity_utils)
    from parity_utils import canonicalize_best

    assert canonicalize_best(e_best) == canonicalize_best(o_best)


def test_min_filters_applied():
    scl = _random_pileup(5, ncells=6)
    # make cell 0 fail the min-uniq filter by construction: compare outputs
    min_uniq = int(scl.cell_uniq[1]) + 1  # guarantees cell 1 is excluded
    e = _engine_lines(scl, GRID, min_uniq=min_uniq)
    gps = np.stack(scl.snp_gps)
    gp0s = compute_gp0s(scl)
    o_llks, o_llk0s = pass1_singlet(scl, gp0s)
    o_single = write_single(scl, o_llks, o_llk0s, min_uniq=min_uniq)
    o_sing2, o_pair, o_best = pass2_outputs(
        scl, gp0s, GRID, write_pair=True, min_uniq=min_uniq
    )
    assert e[0] == o_single
    assert e[3] == o_best
    # at least one cell got filtered relative to unfiltered run
    assert len(o_best) < 1 + scl.nbcs


def test_cell_with_no_coverage_skipped_in_best():
    scl = _random_pileup(6, ncells=4)
    scl.add_cell("ZZZ_EMPTY")  # barcode seen, zero SNP coverage
    scl.cell_totl[-1] = 3
    e_single, e_sing2, e_pair, e_best = _engine_lines(scl, GRID)
    # .single includes the empty cell, .best/.sing2 exclude it (:592)
    assert any("ZZZ_EMPTY" in l for l in e_single)
    assert not any("ZZZ_EMPTY" in l for l in e_best)
    assert not any("ZZZ_EMPTY" in l for l in e_sing2)


def test_engine_spool_resume(tmp_path):
    """Spooled rerun reproduces results without recomputation."""
    import numpy as np

    from demuxlet_jax.models.engine import DemuxEngine
    from demuxlet_jax.host.csr import CsrPileup

    rng = np.random.default_rng(0)
    N, S, NSNPS, NV = 20, 10, 50, 3
    obs_cell = np.repeat(np.arange(N), S)
    obs_snp = rng.integers(0, NSNPS, size=N * S)
    csr = CsrPileup.from_arrays(
        [f"S{i}" for i in range(NV)], NSNPS, ["B%02d" % i for i in range(N)],
        np.ones(N, np.int64), np.ones(N, np.int64), np.ones(N, np.int64),
        obs_cell, obs_snp, rng.integers(0, 2, N * S), 
        rng.integers(13, 41, N * S),
    )
    gps = rng.dirichlet(np.ones(3), size=(NSNPS, NV))
    eng = DemuxEngine(gps, [0.0, 0.5], cell_block=8)
    spool = str(tmp_path / "spool")
    r1 = eng.run(csr, spool_dir=spool)
    import os

    files = sorted(os.listdir(spool))
    assert len(files) == 3  # ceil(20/8) blocks
    r2 = eng.run(csr, spool_dir=spool)  # resume: loads every block
    np.testing.assert_array_equal(r1.llk_ab, r2.llk_ab)
    np.testing.assert_array_equal(r1.llks, r2.llks)


def test_idx_delta_encoding_roundtrip():
    """_shrink_codes_blk's u8-delta idx form (and its u16-pair fallback)
    must decode on device to the exact slot ids: fast-path outputs are
    bit-identical to the unshrunk (codes, idx, msk) dispatch."""
    import numpy as np

    from demuxlet_jax.host.csr import CsrPileup

    rng = np.random.default_rng(11)
    NS, V, n, S_PER = 70000, 3, 64, 200
    gps = rng.dirichlet(np.ones(3), size=(NS, V))
    grid = [0.0, 0.5]

    def build_csr(snps):
        obs_snp = np.repeat(snps.reshape(-1), 2).astype(np.int64)
        obs_cell = np.repeat(np.arange(n, dtype=np.int64), S_PER * 2)
        obs_allele = rng.integers(0, 2, size=n * S_PER * 2).astype(np.uint8)
        obs_bq = rng.integers(13, 41, size=n * S_PER * 2).astype(np.uint8)
        totl = np.full(n, S_PER * 2, dtype=np.int64)
        return CsrPileup.from_arrays(
            [f"S{i}" for i in range(V)], NS,
            ["BC%04d" % i for i in range(n)], totl, totl, totl,
            obs_cell, obs_snp, obs_allele, obs_bq,
        )

    # small deltas + a sprinkle of >255 jumps (sparse fix list), and a
    # wild layout that must fall back to the 16-bit pair packing
    base = np.cumsum(rng.integers(1, 80, size=(n, S_PER)), axis=1)
    base[:, ::37] += 1000  # escapes
    csr_delta = build_csr(np.minimum(base, NS - 1))
    csr_wild = build_csr(
        np.sort(rng.choice(NS, size=(n, S_PER), replace=False), axis=1)
    )

    for csr in (csr_delta, csr_wild):
        eng = DemuxEngine(gps, grid, cell_block=32, mode="fast")
        blk = __import__(
            "demuxlet_jax.host.csr", fromlist=["build_codes_block"]
        ).build_codes_block(csr, list(range(n)), pad_cells_to=32)
        shrunk = eng._shrink_codes_blk(
            (blk[0].copy(), blk[1], blk[2])
        )
        out_s = [np.asarray(x) for x in eng._dispatch_fast(shrunk)]
        out_r = [np.asarray(x) for x in eng._dispatch_fast(blk)]
        for a, b in zip(out_s, out_r):
            assert np.array_equal(a, b)

    # the engineered workload must actually take the delta form
    eng = DemuxEngine(gps, grid, cell_block=32, mode="fast")
    from demuxlet_jax.host.csr import build_codes_block

    blk = build_codes_block(csr_delta, list(range(n)), pad_cells_to=32)
    _, idx_s, _ = eng._shrink_codes_blk(blk)
    assert isinstance(idx_s, tuple) and idx_s[0].dtype == np.uint8


def test_n_snps_all_matches_per_cell_unique():
    import numpy as np

    from demuxlet_jax.host.csr import CsrPileup

    rng = np.random.default_rng(5)
    n, NS = 50, 500
    lengths = rng.integers(0, 40, size=n)
    lengths[7] = 0  # empty cell
    obs_cell = np.repeat(np.arange(n, dtype=np.int64), lengths)
    obs_snp = np.concatenate(
        [np.sort(rng.integers(0, NS, size=k)) for k in lengths]
    ).astype(np.int64) if lengths.sum() else np.zeros(0, np.int64)
    tot = np.ones(n, dtype=np.int64)
    csr = CsrPileup.from_arrays(
        ["A"], NS, ["BC%02d" % i for i in range(n)], tot, tot, tot,
        obs_cell, obs_snp,
        np.zeros(lengths.sum(), np.uint8), np.full(lengths.sum(), 30, np.uint8),
    )
    expect = np.asarray([csr.n_cell_snps(c) for c in range(n)])
    assert np.array_equal(csr.n_snps_all(), expect)


def _skewed_csr(seed=3, NSNPS=60, NV=3, N=24):
    import numpy as np

    from demuxlet_jax.host.csr import CsrPileup

    rng = np.random.default_rng(seed)
    # coverage skew: cell i covers 2 + 2*i observations
    lens = 2 + 2 * np.arange(N)
    obs_cell = np.repeat(np.arange(N), lens)
    nobs = int(lens.sum())
    obs_snp = rng.integers(0, NSNPS, size=nobs)
    order = np.lexsort((obs_snp, obs_cell))
    csr = CsrPileup.from_arrays(
        [f"S{i}" for i in range(NV)], NSNPS,
        ["B%02d" % i for i in range(N)],
        lens.astype(np.int64), lens.astype(np.int64),
        lens.astype(np.int64), obs_cell[order], obs_snp[order],
        rng.integers(0, 2, nobs), rng.integers(13, 41, nobs),
    )
    gps = rng.dirichlet(np.ones(3), size=(NSNPS, NV))
    return csr, gps


def test_coverage_sort_heuristic():
    """engine._blocks sorts only when the bucketed padded-slot total
    actually drops: sub-128 counts all share one bucket (natural order
    kept — the contiguous-slice prep fast path survives); a strongly
    skewed multi-bucket distribution sorts."""
    import numpy as np

    from demuxlet_jax.models.engine import DemuxEngine

    csr, gps = _skewed_csr()
    eng = DemuxEngine(gps, [0.0, 0.5], cell_block=8, mode="fast")
    # all counts < 128 -> one bucket -> sorting cannot help
    blocks, pads = eng._blocks(csr.nbcs, csr)
    assert blocks[0] == list(range(8)) and pads is None

    class FakeCsr:
        nbcs = 24

        def n_snps_all(self):
            # interleaved tiny/huge coverage: natural blocks all bucket
            # to the max; sorted blocks segregate -> >10% saving
            return np.where(np.arange(24) % 2 == 0, 10, 2000)

    blocks, pads = eng._blocks(24, FakeCsr())
    assert blocks[0] != list(range(8)), "skewed distribution must sort"
    assert sorted(sum(blocks, [])) == list(range(24))
    # pow2 pad hints bound the distinct compiled shapes
    assert pads is not None and len(pads) == len(blocks)
    assert all(p >= 128 and (p & (p - 1)) == 0 for p in pads)
    assert pads == sorted(pads), "ascending coverage -> ascending pads"


def test_block_permutation_output_invariance():
    """Permuted blocks (the coverage sort's mechanism) must be output-
    invariant: llks write by cell id and compact rows are inverse-
    permuted. Pinned by forcing a SHUFFLED block order against the
    natural order on the same workload."""
    import dataclasses

    import numpy as np

    from demuxlet_jax.models import decision as D
    from demuxlet_jax.models.engine import DemuxEngine

    csr, gps = _skewed_csr()
    N = csr.nbcs
    eng = DemuxEngine(gps, [0.0, 0.5], cell_block=8, mode="fast")
    perm = np.random.default_rng(0).permutation(N)
    eng._blocks = lambda n, scl=None: ([
        perm[s : s + 8].tolist() for s in range(0, n, 8)
    ], None)
    l1, l01, c1 = eng.run_compact(csr, doublet_prior=0.5)
    eng2 = DemuxEngine(gps, [0.0, 0.5], cell_block=8, mode="fast")
    eng2._blocks = lambda n, scl=None: ([
        list(range(s, min(s + 8, n))) for s in range(0, n, 8)
    ], None)
    l2, l02, c2 = eng2.run_compact(csr, doublet_prior=0.5)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(l01, l02)
    for f in dataclasses.fields(D.CompactResult):
        a, b = getattr(c1, f.name), getattr(c2, f.name)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            # fast f32: block composition differs -> padded-slot
            # bucketing may shift values within documented tolerance
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-2,
                                       err_msg=f.name)
