#!/usr/bin/env python
"""End-to-end demux benchmark at production scale (BASELINE config 5 shape).

Generates a synthetic 100K-barcode scATAC-style pileup (CSR form — ingest is
benchmarked separately by the native-ingest tests/bench), runs the full
engine (fast: run_compact with the device decision pass; exact: run + host
decisions) + output rendering, and reports wall-clock barcodes/s per
pipeline phase and the host->device bytes per barcode. Prints one JSON
line; set E2E_ARTIFACT=path to also write it to a file.

Usage: python benchmarks/e2e_demux.py [n_cells] [snps_per_cell] [nv]
           [nalpha] [mode] [profile]

profile (default "uniform"):
  uniform    every cell covers snps_per_cell SNPs at exactly 2 UMIs each,
             BQ uniform over [13, 40] — the round-1..4 workload (kept
             for cross-round comparability; its wide BQ alphabet and
             full-lane slots are the wire format's WORST case).
  realistic  what actual droplet data looks like, each property sourced:
             BQ binned to {23, 37} (NovaSeq RTA3 emits 4 quality bins;
             after the default min-BQ 13 filter two survive), per-cell
             coverage lognormal around snps_per_cell (library-size
             skew), SNPs drawn as per-gene runs with zipf gene
             popularity (expression concentrates on few genes; covered
             SNPs cluster inside genes), UMIs/slot 1 + Poisson(0.15)
             with rare PCR-hot slots (deep-lane tail).
"""

from __future__ import annotations

import io
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_CELLS = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
S_PER_CELL = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
NV = int(sys.argv[3]) if len(sys.argv) > 3 else 8
NA = int(sys.argv[4]) if len(sys.argv) > 4 else 5
MODE = sys.argv[5] if len(sys.argv) > 5 else "fast"
PROFILE = sys.argv[6] if len(sys.argv) > 6 else "uniform"
NSNPS = 50_000
UMIS = 2


def synth_csr(rng):
    from demuxlet_jax.host.csr import CsrPileup

    nobs = N_CELLS * S_PER_CELL * UMIS
    # each cell covers S_PER_CELL distinct random SNPs, UMIS umis each
    # (distinct via strided offsets so per-slot UMI counts stay == UMIS)
    base = rng.integers(0, NSNPS // S_PER_CELL, size=(N_CELLS, S_PER_CELL))
    snps_per_cell = base + np.arange(S_PER_CELL) * (NSNPS // S_PER_CELL)
    obs_snp = np.repeat(snps_per_cell.reshape(-1), UMIS).astype(np.int32)
    obs_cell = np.repeat(
        np.arange(N_CELLS, dtype=np.int64), S_PER_CELL * UMIS
    )
    obs_allele = rng.integers(0, 2, size=nobs).astype(np.uint8)
    obs_bq = rng.integers(13, 41, size=nobs).astype(np.uint8)
    barcodes = ["BC%06d" % i for i in range(N_CELLS)]
    totl = np.full(N_CELLS, S_PER_CELL * UMIS, dtype=np.int64)
    return CsrPileup.from_arrays(
        [f"S{i}" for i in range(NV)], NSNPS, barcodes, totl, totl, totl,
        obs_cell, obs_snp.astype(np.int64), obs_allele, obs_bq,
    )


def synth_csr_realistic(rng):
    """Droplet-realistic pileup (see module docstring for sources).
    Exercises the paths the uniform profile cannot: coverage-sorted
    blocking (engine._blocks), the wire-v2 4-bit dict + deep-lane tail,
    and narrow deltas over gene-run SNP clusters."""
    from demuxlet_jax.host.csr import CsrPileup

    gene_len = 25  # SNPs per gene cluster
    n_genes = NSNPS // gene_len
    pop = 1.0 / np.arange(1, n_genes + 1) ** 0.9  # zipf popularity
    pop /= pop.sum()
    gene_perm = rng.permutation(n_genes)  # popular genes spread genomewide
    cdf = np.cumsum(pop)

    # per-cell coverage: lognormal around S_PER_CELL, sd ~0.6 dex
    s_c = np.clip(
        rng.lognormal(np.log(S_PER_CELL), 0.6, size=N_CELLS),
        40, 6 * S_PER_CELL,
    ).astype(np.int64)
    genes_per_cell = np.maximum(s_c // 12, 1)  # ~12 covered SNPs/gene

    cell_parts, snp_parts = [], []
    step = 4096
    for lo in range(0, N_CELLS, step):
        hi = min(lo + step, N_CELLS)
        ng = genes_per_cell[lo:hi]
        tot = int(ng.sum())
        g = gene_perm[
            np.searchsorted(cdf, rng.random(tot)).clip(0, n_genes - 1)
        ]
        cell_of_gene = np.repeat(np.arange(lo, hi), ng)
        # covered run inside the gene: random start + length ~12
        run = rng.integers(6, 19, size=tot)
        start = rng.integers(0, gene_len - 5, size=tot)
        run = np.minimum(run, gene_len - start)
        snp0 = g * gene_len + start
        snps = np.repeat(snp0, run) + _ranges(run)
        cells = np.repeat(cell_of_gene, run)
        cell_parts.append(cells)
        snp_parts.append(snps)
    obs_cell1 = np.concatenate(cell_parts)
    obs_snp1 = np.concatenate(snp_parts).astype(np.int64)

    # UMIs per covered slot: 1 + Poisson(0.15), plus rare PCR-hot slots
    occ = 1 + rng.poisson(0.15, size=len(obs_snp1))
    hot = rng.random(len(obs_snp1)) < 5e-4
    occ[hot] += rng.integers(4, 20, size=int(hot.sum()))
    obs_cell = np.repeat(obs_cell1, occ)
    obs_snp = np.repeat(obs_snp1, occ)
    nobs = len(obs_snp)
    obs_allele = rng.integers(0, 2, size=nobs).astype(np.uint8)
    # post-min-BQ NovaSeq bins
    obs_bq = np.where(rng.random(nobs) < 0.85, 37, 23).astype(np.uint8)
    barcodes = ["BC%06d" % i for i in range(N_CELLS)]
    totl = np.bincount(obs_cell, minlength=N_CELLS).astype(np.int64)
    return CsrPileup.from_arrays(
        [f"S{i}" for i in range(NV)], NSNPS, barcodes, totl, totl, totl,
        obs_cell, obs_snp, obs_allele, obs_bq,
    )


def _ranges(lengths):
    """concatenate([arange(n) for n in lengths]) without the loop."""
    tot = int(lengths.sum())
    out = np.ones(tot, dtype=np.int64)
    out[0] = 0
    ends = np.cumsum(lengths)[:-1]
    out[ends] = 1 - lengths[:-1]
    return np.cumsum(out)


def main():
    import jax

    from demuxlet_jax.utils.jaxcfg import enable_compilation_cache

    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)  # match the CLI (f64 decide)
    dev = jax.devices()[0]
    t0 = time.time()
    rng = np.random.default_rng(0)
    csr = synth_csr_realistic(rng) if PROFILE == "realistic" else (
        synth_csr(rng))
    gps = rng.dirichlet(np.ones(3), size=(NSNPS, NV))
    t_gen = time.time() - t0
    mean_cov = len(csr.obs_snp) / N_CELLS
    print(f"# workload[{PROFILE}]: {N_CELLS} cells, "
          f"{mean_cov:.0f} obs/cell mean, V={NV} A={NA} "
          f"(gen {t_gen:.1f}s)", flush=True)

    from demuxlet_jax.models import decision as D
    from demuxlet_jax.models import outputs as out_mod
    from demuxlet_jax.models.engine import DemuxEngine, cell_stats

    grid = np.linspace(0.0, 0.5, NA).tolist()
    eng = DemuxEngine(gps, grid, cell_block=2048, mode=MODE)

    def run_engine():
        if MODE == "fast":
            return eng.run_compact(csr, doublet_prior=0.5)
        res = eng.run(csr)
        return res.llks, res.llk0s, D.compact_from_result(
            res.llk_ab, res.llk_00, grid, 0.5)

    # Per-process FIXED cost (trace + compile + first touch) is paid once;
    # warm with one FULL pass so every compiled shape (wire-v2 metas are
    # data-dependent) exists before the timed passes
    t0 = time.time()
    run_engine()
    t_fixed = time.time() - t0
    print(f"# fixed+first-pass (trace+executable load, full warm pass): "
          f"{t_fixed:.1f}s", flush=True)

    # two timed passes: report the better one and both raw times
    passes = []
    for _p in range(2):
        t0 = time.time()
        llks, llk0s, compact = run_engine()
        passes.append(time.time() - t0)
        print(f"# engine pass{_p} ({MODE}+device decisions): "
              f"{passes[-1]:.1f}s -> {N_CELLS / passes[-1]:.0f} b/s; "
              f"phases {dict((k, round(v, 1)) for k, v in eng.phase_s.items())}",
              flush=True)
    t_engine = min(passes)

    t0 = time.time()
    stats = cell_stats(csr)
    t_stats = time.time() - t0
    s2 = io.StringIO()
    sb = io.StringIO()
    out_mod.write_pass2_compact(
        stats, csr.sample_ids, compact, grid, 0.5, s2, sb
    )
    t_out = time.time() - t0
    print(f"#   (cell_stats {t_stats:.1f}s, render {t_out - t_stats:.1f}s)",
          flush=True)
    total = t_gen * 0 + t_engine + t_out
    print(f"# outputs (.sing2/.best): {t_out:.1f}s", flush=True)

    bpb = getattr(eng, "h2d_bytes", 0) / N_CELLS  # fast path only
    base_bps = 213.6  # single-thread C++ baseline (BASELINE.md)
    rate = N_CELLS / total
    row = {
        "metric": "e2e_demux_barcodes_per_s",
        "mode": MODE,
        "profile": PROFILE,
        "wire_cfg": None if eng._wire_cfg is None else {
            "n_dict": eng._wire_cfg.n_real,
            "code_w": eng._wire_cfg.code_w,
            "delta_w": eng._wire_cfg.delta_w,
            "u_cap": eng._wire_cfg.u_cap,
        },
        "value": round(rate, 1),
        "unit": "barcodes/s",
        "vs_baseline": round(rate / base_bps, 1),
        "cold_bps": round(N_CELLS / (total + t_fixed), 1),
        "cold_vs_baseline": round(N_CELLS / (total + t_fixed) / base_bps, 1),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n_devices": len(jax.devices()),
        "cells": N_CELLS,
        "snps_per_cell": S_PER_CELL,
        "nv": NV,
        "nalpha": NA,
        "phases_s": {"gen": round(t_gen, 2), "fixed": round(t_fixed, 2),
                     "engine": round(t_engine, 2),
                     "engine_passes": [round(p, 2) for p in passes],
                     "engine_parts": {k: round(v, 2)
                                      for k, v in eng.phase_s.items()},
                     "cell_stats": round(t_stats, 2),
                     "render": round(t_out - t_stats, 2)},
        "h2d_bytes_per_barcode": round(bpb, 1),
        "baseline_bps": base_bps,
    }
    art = os.environ.get("E2E_ARTIFACT")
    if art:
        import json

        with open(art, "w") as fh:
            json.dump(row, fh, indent=1)
    import json

    print(json.dumps(row))


if __name__ == "__main__":
    main()
