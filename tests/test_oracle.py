"""NumPy-oracle unit tests: hand-computed likelihoods + the structural
properties the dense reformulation relies on (SURVEY.md §4 'unit')."""

import math
import random

import numpy as np
import pytest

from demuxlet_jax.utils.phred import PHRED2ERR, PHRED2MAT
from oracle.numpy_oracle import (
    PileupData,
    compute_gp0s,
    pass1_singlet,
    pass2_cell,
    pass2_outputs,
    write_single,
)


def mk_scl(nv=2, nsnps=1, gps=None):
    if gps is None:
        rng = np.random.RandomState(0)
        g = rng.dirichlet([1, 1, 1], size=(nsnps, nv))
    else:
        g = np.asarray(gps, dtype=np.float64)
    return PileupData([f"S{i}" for i in range(g.shape[1])], [g[i] for i in range(g.shape[0])])


def test_pass1_hand_computed():
    # one cell, one SNP, one ref-allele UMI at Q30
    gps = [[[0.9, 0.05, 0.05], [0.05, 0.05, 0.9]]]
    scl = mk_scl(gps=gps)
    scl.add_cell("BC1")
    scl.cell_totl[0] += 1
    scl.add_read(0, 0, "U1", 0, 30)
    gp0s = compute_gp0s(scl)
    llks, llk0s = pass1_singlet(scl, gp0s)

    e = PHRED2ERR[30]
    GL = np.array([1.0 - e, 0.5 - e / 3.0, e / 3.0])
    GL /= GL.sum()
    GL += 1e-6
    GL /= GL.sum()
    exp0 = math.log(GL @ np.array([0.9, 0.05, 0.05]))
    exp1 = math.log(GL @ np.array([0.05, 0.05, 0.9]))
    assert llks[0, 0] == pytest.approx(exp0, abs=1e-15)
    assert llks[0, 1] == pytest.approx(exp1, abs=1e-15)
    gp0 = np.array([0.475, 0.05, 0.475])
    assert llk0s[0] == pytest.approx(math.log(GL @ gp0), abs=1e-14)


def test_allele2_skipped():
    scl = mk_scl()
    scl.add_cell("BC1")
    scl.add_read(0, 0, "U1", 2, 30)  # mismatch to both alleles
    gp0s = compute_gp0s(scl)
    llks, llk0s = pass1_singlet(scl, gp0s)
    # GL stays [1,1,1] -> normalized [1/3,1/3,1/3]; contributions = log(1/3 * 1)
    assert llks[0, 0] == pytest.approx(math.log(1.0 / 3.0), rel=1e-9)


def _random_pileup(seed, nv=3, nsnps=6, ncells=4, numis=5):
    rng = random.Random(seed)
    g = np.random.RandomState(seed).dirichlet([2, 2, 2], size=(nsnps, nv))
    scl = mk_scl(gps=g)
    for c in range(ncells):
        scl.add_cell(f"BC{c}")
        for _ in range(numis):
            s = rng.randrange(nsnps)
            scl.cell_totl[c] += 1
            scl.add_read(
                s, c, f"U{rng.randrange(1000)}", rng.choice([0, 0, 1, 1, 2]),
                rng.randrange(13, 41),
            )
    return scl


def test_alpha0_column_equals_singlet_pairing():
    """gridAlpha[0]=0 => llksAB[j,k,0] is independent of k and equals the
    singlet LLK of j (the reference decision logic depends on this)."""
    scl = _random_pileup(1)
    gp0s = compute_gp0s(scl)
    for c in range(scl.nbcs):
        llksAB, llksA0, llks00 = pass2_cell(scl, gp0s, c, [0.0, 0.5])
        for j in range(scl.nv):
            for k in range(1, scl.nv):
                assert llksAB[j, k, 0] == pytest.approx(
                    llksAB[j, 0, 0], rel=1e-12
                )


def test_umi_order_invariance_modulo_rounding():
    """Per-UMI renormalization telescopes: processing order changes results
    only at ~1e-12 (this is what lets the device engine use counts)."""
    scl1 = _random_pileup(2)
    gp0s = compute_gp0s(scl1)
    llks1, _ = pass1_singlet(scl1, gp0s)

    # rebuild with UMI insertion order scrambled (sorted_umis sorts anyway,
    # so instead scramble by renaming UMIs to change the sort order)
    scl2 = mk_scl(gps=np.stack(scl1.snp_gps))
    for c in range(scl1.nbcs):
        scl2.add_cell(scl1.barcodes[c])
    for (s, c), d in scl1.umis.items():
        for i, (u, (al, bq)) in enumerate(sorted(d.items(), reverse=True)):
            scl2.add_read(s, c, f"Z{i}_{u}", al, bq)
    llks2, _ = pass1_singlet(scl2, gp0s)
    np.testing.assert_allclose(llks1, llks2, rtol=1e-11)


def test_pair_llk_symmetry_at_half():
    """alpha=0.5 => p = 0.25(l+m) symmetric in (l,m) => llksAB[j,k,.5] ==
    llksAB[k,j,.5]."""
    scl = _random_pileup(3)
    gp0s = compute_gp0s(scl)
    llksAB, _, _ = pass2_cell(scl, gp0s, 0, [0.0, 0.5])
    for j in range(scl.nv):
        for k in range(scl.nv):
            assert llksAB[j, k, 1] == pytest.approx(llksAB[k, j, 1], rel=1e-12)


def test_outputs_shapes_and_determinism():
    scl = _random_pileup(4)
    gp0s = compute_gp0s(scl)
    llks, llk0s = pass1_singlet(scl, gp0s)
    single = write_single(scl, llks, llk0s)
    assert len(single) == 1 + scl.nbcs * scl.nv
    sing2, pair, best = pass2_outputs(
        scl, gp0s, [0.0, 0.5], write_pair=True
    )
    assert len(best) == 1 + scl.nbcs
    assert len(sing2) == 1 + scl.nbcs * scl.nv
    # .pair rows: nv singlet rows + nv*(nv-1)/2 doublet rows at alpha=0.5
    nv = scl.nv
    assert len(pair) == 1 + scl.nbcs * (nv + nv * (nv - 1) // 2)
    # determinism
    sing2b, pairb, bestb = pass2_outputs(
        scl, gp0s, [0.0, 0.5], write_pair=True
    )
    assert best == bestb and pair == pairb


def test_best_call_types():
    scl = _random_pileup(5, nv=2, nsnps=10, ncells=6, numis=20)
    gp0s = compute_gp0s(scl)
    _, _, best = pass2_outputs(scl, gp0s, [0.0, 0.5])
    for row in best[1:]:
        call = row.split("\t")[5]
        assert call.startswith(("SNG-", "DBL-", "AMB-"))
