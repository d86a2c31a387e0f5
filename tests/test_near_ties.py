"""Near-tie behavior between device modes (VERDICT r1 weak #10).

llkAB[j,k,0.5] and llkAB[k,j,0.5] are EXACT ties in real arithmetic
(p(l,m;0.5) is symmetric), so which mirror an argmax picks is decided by
the last ulp of whichever kernel computed it — f32 fast and f64 exact
can legitimately disagree. The documented contract
(tests/parity_utils.canonicalize_best, cli --mode help) is that .best
rows must be compared after canonicalizing the mirror order. This test
constructs the disagreement explicitly and pins that the
canonicalization catches exactly this class — and nothing else.
"""

import io

import numpy as np

from demuxlet_jax.models import outputs as out_mod
from demuxlet_jax.models.outputs import CellStats
from parity_utils import canonicalize_best


def _render_best(llk_ab, llk_00):
    n, V = llk_ab.shape[0], llk_ab.shape[1]
    stats = CellStats(
        barcodes=[f"BC{i}" for i in range(n)],
        totl=np.full(n, 10), pass_=np.full(n, 10),
        uniq=np.full(n, 10), nsnp=np.full(n, 5),
    )
    s2, sb = io.StringIO(), io.StringIO()
    out_mod.write_pass2(
        stats, [f"S{j}" for j in range(V)], llk_ab, llk_00,
        [0.0, 0.5], 0.5, s2, sb,
    )
    return sb.getvalue().splitlines()


def _tied_tensor(eps_jk=0.0, eps_kj=0.0):
    """One cell whose best doublet is an exact (S0,S1,0.5) mirror tie,
    with per-mirror ulp-level perturbations emulating kernel rounding."""
    V, A = 3, 2
    llk_ab = np.full((1, V, V, A), -50.0)
    # singlet columns (j, 0, 0): S0 and S1 close, S2 far
    llk_ab[0, 0, 0, 0] = -10.0
    llk_ab[0, 1, 0, 0] = -10.1
    llk_ab[0, 2, 0, 0] = -30.0
    # dominant symmetric doublet
    llk_ab[0, 0, 1, 1] = -5.0 + eps_jk
    llk_ab[0, 1, 0, 1] = -5.0 + eps_kj
    llk_00 = np.full((1, A), -40.0)
    return llk_ab, llk_00


def test_mirror_tie_flip_is_canonicalized():
    a, a0 = _tied_tensor(eps_jk=1e-12, eps_kj=0.0)  # "f64 kernel" rounding
    b, b0 = _tied_tensor(eps_jk=0.0, eps_kj=1e-12)  # "f32 kernel" rounding
    best_a = _render_best(a, a0)
    best_b = _render_best(b, b0)
    assert best_a != best_b  # raw outputs disagree on the mirror order
    assert "DBL-S0-S1-0.500" in best_a[1]
    assert "DBL-S1-S0-0.500" in best_b[1]
    assert canonicalize_best(best_a) == canonicalize_best(best_b)


def test_canonicalization_does_not_mask_real_differences():
    """A GENUINE call difference (different pair, not a mirror) must
    survive canonicalization."""
    a, a0 = _tied_tensor(eps_jk=1e-12)
    c, c0 = _tied_tensor(eps_jk=1e-12)
    c[0, 0, 2, 1] = -4.0  # different best pair entirely (S0, S2)
    assert canonicalize_best(_render_best(a, a0)) != canonicalize_best(
        _render_best(c, c0)
    )


def test_fast_vs_exact_on_symmetric_doublets(tmp_path):
    """End-to-end: a doublet-heavy workload through both device modes —
    raw .best may disagree only in mirror order; canonicalized .best rows
    must be line-identical except for LLK digits, and the called pair set
    must match."""
    import random

    from demuxlet_jax import cli
    from fixtures import random_workload, write_bam, write_vcf

    rng = random.Random(53)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=24, n_snps=40, n_samples=3, reads_per_cell=60,
        doublet_rate=0.6,
    )
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    for mode in ("exact", "fast"):
        rc = cli.main(["--sam", bam, "--vcf", vcf, "--field", "GT",
                       "--mode", mode, "--device", "cpu", "--mesh", "none",
                       "--out", str(tmp_path / mode)])
        assert rc == 0
    ex = canonicalize_best(
        open(str(tmp_path / "exact.best")).read().splitlines()
    )
    fa = canonicalize_best(
        open(str(tmp_path / "fast.best")).read().splitlines()
    )
    assert len(ex) == len(fa)
    for le, lf in zip(ex[1:], fa[1:]):
        ce, cf = le.split("\t"), lf.split("\t")
        # barcode + call class + identities must agree post-canonicalization
        assert ce[0] == cf[0]
        assert ce[5].split("-")[0] == cf[5].split("-")[0], (le, lf)
        assert ce[6] == cf[6] and ce[11] == cf[11] and ce[12] == cf[12]
