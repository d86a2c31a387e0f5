"""Tests that need a CUDA GPU: the Pallas-Triton kernel compiled for the
card, and the CLI with --device gpu. Each skips without a GPU; the
decision is made in the `gpu` fixture, never at import time.

Run on a GPU machine with `JAX_PLATFORMS=cuda pytest -m gpu tests/`
(chip_smoke.py runs them too)."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU")
    return jax.devices()[0]


@pytest.mark.parametrize("V,grid", [(3, [0.0, 0.5]), (17, [0.0, 0.5]),
                                    (8, [0.0, 0.1, 0.2, 0.3, 0.5])])
def test_triton_kernel_on_gpu_matches_plain(gpu, V, grid):
    """The compiled kernel against the plain f32 contraction through the
    same front, at 1e-5 * max(1, |ref|), with odd cells/slots."""
    from test_pallas import _codes_case, _fast, _rel

    dev, _ = _codes_case(100, 333, V, grid, seed=V)
    ref = _fast(dev, V, grid, True, pair_impl="xla")
    got = _fast(dev, V, grid, True, pair_impl="triton")
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-5


def test_engine_picks_triton_on_gpu(gpu):
    from demuxlet_jax.models.engine import DemuxEngine

    for V in (2, 16):
        eng = DemuxEngine(np.full((4, V, 3), 1 / 3), [0.0, 0.5], mode="fast")
        assert eng.pair_impl == "triton"


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_cli_device_gpu(gpu, tmp_path, mode):
    """--device gpu end to end on a small workload: planted calls."""
    import random

    from demuxlet_jax import cli
    from fixtures import random_workload, write_bam, write_vcf

    rng = random.Random(3)
    contigs, names, variants, reads, truth = random_workload(
        rng, n_cells=30, n_snps=60, n_samples=4, reads_per_cell=80)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    out = str(tmp_path / "o")
    assert cli.main(["--sam", bam, "--vcf", vcf, "--field", "GT",
                     "--out", out, "--device", "gpu", "--mode", mode]) == 0
    rows = open(out + ".best").read().splitlines()[1:]
    ok = 0
    for ln in rows:
        cols = ln.split("\t")
        a, b = truth[cols[0]]
        if a == b:
            ok += cols[5] == f"SNG-S{a}"
        else:
            ok += cols[5].startswith("DBL-")
    assert ok >= 0.9 * len(rows)
