"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Shard-invariance (SURVEY.md §4 'Distributed'): the sharded SPMD step must
reproduce the single-device result exactly in f64 — the "b" axis is pure data
parallelism and the "s" axis psum adds disjoint partial sums whose per-chunk
values are bit-identical to the unsharded per-chunk sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from demuxlet_jax.models.likelihood import pair_llks, singlet_llks
from demuxlet_jax.parallel import mesh as pmesh


def _block(B, S, V, A, seed=0):
    from demuxlet_jax.ops import luts

    rng = np.random.default_rng(seed)
    nb = 2 * 41
    cnt = rng.integers(0, 3, size=(B, S, nb)).astype(np.int32)
    msk = rng.random((B, S)) < 0.9
    gps = rng.dirichlet(np.ones(3), size=(B, S, V))
    gp0 = gps.mean(axis=2)
    grid = np.linspace(0.0, 0.5, A).tolist()
    return (
        cnt,
        msk,
        gps,
        gp0,
        luts.singlet_lut(40),
        luts.pair_lut(grid, 40),
    )


@pytest.mark.parametrize("n_b,n_s", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_step_matches_single_device(n_b, n_s):
    if len(jax.devices()) < n_b * n_s:
        pytest.skip("needs 8 virtual devices")
    B, S, V, A = 16, 32, 4, 3
    cnt, msk, gps, gp0, logf, w = _block(B, S, V, A)

    ref_llk, ref_llk0 = singlet_llks(
        jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps), jnp.asarray(gp0),
        jnp.asarray(logf),
    )
    ref_ab, ref_00 = pair_llks(
        jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps), jnp.asarray(gp0),
        jnp.asarray(w), A,
    )

    mesh = pmesh.make_mesh(n_b=n_b, n_s=n_s)
    sc, sm, sg, s0 = pmesh.shard_block(
        mesh, jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps),
        jnp.asarray(gp0),
    )
    lf, ww = pmesh.replicate(mesh, jnp.asarray(logf), jnp.asarray(w))
    step = pmesh.build_sharded_step(mesh, n_alpha=A)
    llk, llk0, ab, z0 = step(sc, sm, sg, s0, lf, ww)

    # "b"-axis sharding is exact; "s"-axis psum may reassociate the S-sum,
    # so compare to tight f64 tolerance (exact when n_s == 1).
    tol = 0 if n_s == 1 else 1e-9
    np.testing.assert_allclose(np.asarray(llk), np.asarray(ref_llk), atol=tol, rtol=0)
    np.testing.assert_allclose(np.asarray(llk0), np.asarray(ref_llk0), atol=tol, rtol=0)
    np.testing.assert_allclose(np.asarray(ab), np.asarray(ref_ab), atol=tol, rtol=0)
    np.testing.assert_allclose(np.asarray(z0), np.asarray(ref_00), atol=tol, rtol=0)


def test_pad_to_mesh():
    assert pmesh.pad_to_mesh(10, 4) == 12
    assert pmesh.pad_to_mesh(16, 4) == 16
    assert pmesh.pad_to_mesh(1, 8, block=8) == 64


def test_dryrun_multichip_entry():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.parametrize("pair_impl", ["xla", "triton"])
def test_sharded_fast_step_matches_single_device(pair_impl):
    """Fast-mode step under shard_map over 'b' == single device, for both
    pair-search implementations (the kernel in interpret mode)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    from demuxlet_jax.ops import luts
    from demuxlet_jax.ops.pallas_pair import demux_block_fast, extend_luts

    rng = np.random.default_rng(3)
    B, S, U, V, A, NS = 128, 128, 2, 4, 3, 50
    codes = rng.integers(0, 82, size=(B, S, U)).astype(np.uint8)
    codes[rng.random((B, S, U)) < 0.3] = 255
    idx = rng.integers(0, NS, size=(B, S)).astype(np.int32)
    msk = rng.random((B, S)) < 0.9
    gps = rng.dirichlet(np.ones(3), size=(NS, V)).astype(np.float32)
    gp0 = gps.mean(axis=1)
    grid = np.linspace(0, 0.5, A).tolist()
    w_ext, logf_ext = extend_luts(
        luts.pair_lut(grid, 40), luts.singlet_lut(40)
    )
    args = tuple(
        jnp.asarray(x) for x in (codes, idx, msk, gps, gp0, w_ext, logf_ext)
    )
    kw = dict(pair_impl=pair_impl, interpret=pair_impl == "triton")
    ref = demux_block_fast(*args, A, V, **kw)

    mesh = pmesh.make_mesh(n_b=4, n_s=1)
    step = pmesh.build_sharded_fast_step(mesh, A, V, **kw)
    out = step(*args)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=1e-5
        )


@pytest.mark.slow
def test_mesh_fast_step_tiled_pool():
    """Sharded fast step at a multi-tile pool size (V=16): the pair-tiled
    kernel must compose with shard_map over the barcode axis — per-shard
    results equal the single-device kernel's."""
    import jax.numpy as jnp

    from demuxlet_jax.parallel import mesh as pmesh
    from demuxlet_jax.ops import luts
    from demuxlet_jax.ops.pallas_pair import demux_block_fast, extend_luts

    rng = np.random.default_rng(9)
    B, S, U, V, A, NS = 128, 128, 2, 16, 2, 50
    codes = rng.integers(0, 82, size=(B, S, U)).astype(np.uint8)
    codes[rng.random((B, S, U)) < 0.3] = 255
    idx = rng.integers(0, NS, size=(B, S)).astype(np.int32)
    msk = rng.random((B, S)) < 0.9
    gps = rng.dirichlet(np.ones(3), size=(NS, V)).astype(np.float32)
    gp0 = gps.mean(axis=1)
    grid = [0.0, 0.5]
    w_ext, logf_ext = extend_luts(
        luts.pair_lut(grid, 40), luts.singlet_lut(40)
    )
    args = tuple(
        jnp.asarray(x) for x in (codes, idx, msk, gps, gp0, w_ext, logf_ext)
    )
    kw = dict(pair_impl="triton", interpret=True, a0_sep=True, sym_a=A - 1)
    ref = demux_block_fast(*args, A, V, **kw)
    mesh = pmesh.make_mesh(n_b=4, n_s=1)
    step = pmesh.build_sharded_fast_step(mesh, A, V, **kw)
    out = step(*args)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=1e-5
        )
