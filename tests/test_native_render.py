"""Native renderer (_render.so) byte parity vs the Python renderer."""

import io
import random

import numpy as np
import pytest

from demuxlet_jax.models import outputs as out_mod
from demuxlet_jax.models.decision import CompactResult

render = pytest.importorskip("demuxlet_jax.native.render")

if not render.available():
    pytest.skip("native render not built", allow_module_level=True)


def _random_compact(rng, n, nv, na, degenerate=False):
    sing = rng.normal(-80, 20, size=(n, nv))
    llk00 = rng.normal(-90, 15, size=(n, na))
    max_llk = sing.max(axis=1) + rng.uniform(0, 3, n)
    ssum = rng.uniform(0, 1, n)
    dsum = rng.uniform(0, 1, n)
    if degenerate:
        # exercise the IEEE edge paths: exact-zero posteriors denominators
        # (inf/nan prints), huge LLKs, near-tie calls
        ssum[::3] = 0.0
        dsum[1::3] = 0.0
        sing[::5] = -1e300
        max_llk[::7] = 1e300
    best = rng.integers(0, nv * nv * na, n)
    comp = CompactResult(
        sing_col=sing,
        llk_00=llk00,
        max_llk=max_llk,
        sum_single=ssum,
        sum_double=dsum,
        i_sing1=rng.integers(0, nv, n),
        i_sing2=rng.integers(0, nv, n),
        max_sing2=sing.min(axis=1) - rng.uniform(0, 4, n),
        best_flat=best,
        pair_llk12=rng.normal(-70, 20, n),
        pair_llk10=rng.normal(-80, 20, n),
        pair_llk20=rng.normal(-80, 20, n),
    )
    stats = out_mod.CellStats(
        barcodes=["BC%04d" % rng.integers(0, 10_000) + "-%d" % i
                  for i in range(n)],
        totl=rng.integers(0, 500, n).astype(np.int64),
        pass_=rng.integers(0, 500, n).astype(np.int64),
        uniq=rng.integers(0, 300, n).astype(np.int64),
        nsnp=rng.integers(0, 120, n).astype(np.int64),
    )
    return stats, comp


@pytest.mark.parametrize("seed,degenerate,filters", [
    (1, False, {}),
    (2, True, {}),
    (3, False, dict(min_total=50, min_uniq=30, min_snp=10)),
    (4, True, dict(min_total=200, min_uniq=1, min_snp=0)),
])
def test_native_render_byte_parity(seed, degenerate, filters):
    rng = np.random.default_rng(seed)
    nv, na = 4, 3
    grid = [0.0, 0.3, 0.5]
    stats, comp = _random_compact(rng, 60, nv, na, degenerate)
    sample_ids = [f"SAMP{i}" for i in range(nv)]

    p2, pb = io.StringIO(), io.StringIO()
    # FORCE the Python fallback — write_pass2_compact delegates to the
    # native renderer when available, which would make this comparison
    # native-vs-native (vacuous)
    import demuxlet_jax.native.render as nr
    orig = nr.available
    nr.available = lambda: False
    try:
        out_mod.write_pass2_compact(stats, sample_ids, comp, grid, 0.5,
                                    p2, pb, **filters)
    finally:
        nr.available = orig
    n2, nb = io.StringIO(), io.StringIO()
    # headers come from the shared Python prologue in the integrated
    # path; write bodies only here by replaying the header lines
    ok = render.write_pass2_compact(stats, sample_ids, comp, grid, 0.5,
                                    n2, nb, **filters)
    assert ok
    want2 = p2.getvalue().split("\n", 1)[1]  # drop header
    wantb = pb.getvalue().split("\n", 1)[1]
    assert n2.getvalue() == want2
    assert nb.getvalue() == wantb


@pytest.mark.parametrize("seed,degenerate,filters", [
    (11, False, {}),
    (12, True, dict(min_total=100)),
])
def test_native_render_single_byte_parity(seed, degenerate, filters):
    rng = np.random.default_rng(seed)
    nv = 5
    stats, _ = _random_compact(rng, 50, nv, 2, degenerate)
    llks = rng.normal(-100, 30, size=(50, nv))
    llk0s = rng.normal(-110, 20, size=50)
    if degenerate:
        llks[::4] = -1e300
    sample_ids = [f"SM{i}" for i in range(nv)]

    pf = io.StringIO()
    import demuxlet_jax.native.render as nr
    orig = nr.available
    nr.available = lambda: False  # force the Python fallback
    try:
        out_mod.write_single(pf, stats, sample_ids, llks, llk0s, **filters)
    finally:
        nr.available = orig
    nf = io.StringIO()
    assert render.write_single(stats, sample_ids, llks, llk0s, nf, **filters)
    assert nf.getvalue() == pf.getvalue().split("\n", 1)[1]


def test_native_render_empty():
    rng = np.random.default_rng(9)
    stats, comp = _random_compact(rng, 0, 3, 2)
    n2, nb = io.StringIO(), io.StringIO()
    ok = render.write_pass2_compact(stats, ["A", "B", "C"], comp,
                                    [0.0, 0.5], 0.5, n2, nb)
    assert ok
    assert n2.getvalue() == "" and nb.getvalue() == ""
