"""The plain pair-search contraction (models/likelihood.pair_contract, the
exact-mode step and the kernel's reference) against the NumPy oracle at
f64: every (j, k, alpha) LLK within the 1e-9 parity contract."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from demuxlet_jax.host.slots import build_slots
from demuxlet_jax.models.engine import compute_gp0
from demuxlet_jax.models.likelihood import pair_llks, singlet_llks
from demuxlet_jax.ops import luts
from oracle.numpy_oracle import (
    PileupData,
    compute_gp0s,
    pass1_singlet,
    pass2_cell,
)

# a0/sym on: alpha = 0 (separable plane) and 0.5 (symmetric plane) in the
# grid; off: neither
GRIDS = {
    (1, True): [0.0], (1, False): [0.25],
    (2, True): [0.0, 0.5], (2, False): [0.1, 0.3],
    (5, True): [0.0, 0.1, 0.2, 0.3, 0.5],
    (5, False): [0.05, 0.15, 0.25, 0.35, 0.45],
}


def _pileup(seed, nv, nsnps=12, ncells=3, numis=24):
    rng = random.Random(seed)
    g = np.random.RandomState(seed).dirichlet([2, 2, 2], size=(nsnps, nv))
    scl = PileupData([f"S{i}" for i in range(nv)], [g[i] for i in range(nsnps)])
    for c in range(ncells):
        scl.add_cell(f"BC{c:03d}")
        for _ in range(numis):
            scl.cell_totl[c] += 1
            scl.add_read(rng.randrange(nsnps), c, f"U{rng.randrange(10**6)}",
                         rng.choice([0, 0, 1, 1, 2]), rng.randrange(13, 41))
    return scl


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("A", [1, 2, 5])
@pytest.mark.parametrize("V", [1, 2, 3, 8, 20])
def test_pair_contract_matches_oracle(V, A, sym):
    grid = GRIDS[(A, sym)]
    scl = _pileup(V * 31 + A * 7 + sym, V)
    gps = np.stack(scl.snp_gps)
    cells = list(range(scl.nbcs))
    blk = build_slots(scl, cells)
    gps_g = gps[blk.idx]
    gp0_g = compute_gp0(gps)[blk.idx]
    dense = [jnp.asarray(x) for x in (blk.cnt, blk.msk, gps_g, gp0_g)]
    # odd V also runs the chunked (lax.scan) slot path
    ab, z0 = pair_llks(*dense, jnp.asarray(luts.pair_lut(grid, 40)), A,
                       slot_chunk=4 if V % 2 else 0)
    l1, l0 = singlet_llks(*dense, jnp.asarray(luts.singlet_lut(40)))
    assert ab.dtype == jnp.float64 and ab.shape == (len(cells), V, V, A)

    gp0s = compute_gp0s(scl)
    o_l, o_l0 = pass1_singlet(scl, gp0s)
    np.testing.assert_allclose(np.asarray(l1), o_l, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(l0), o_l0, rtol=0, atol=1e-9)
    for c in cells:
        o_ab, _, o_00 = pass2_cell(scl, gp0s, c, grid)
        np.testing.assert_allclose(np.asarray(ab[c]), o_ab, rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(z0[c]), o_00, rtol=0,
                                   atol=1e-9)
