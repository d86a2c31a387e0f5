#!/usr/bin/env python
"""Pair-search benchmark on one GPU: barcodes/s vs single-thread C++.

Workload (BASELINE.json config 4/5 shape): doublet pair search over V=8
samples x A=5 alpha grid, 1024 covered SNPs per barcode, 2 UMIs per
(barcode, SNP), 8192 distinct SNPs; extra rows at other (V, A).

Baseline: bench/ref_pairsearch.cpp — a from-scratch single-thread C++
replica of the reference's pass-2 loop nest (cmd_cram_demuxlet.cpp:542-709),
built from source here and run on this machine's host CPU.

Device rows: the fast block step (codes in, the platform's pair search) and
the exact f64 step (dense counts in), device-resident inputs, each timed as
the wall time of a call that ends in block_until_ready after a warm-up;
min/median/max over BENCH_ITERS calls. Needs a GPU (exits non-zero
otherwise). Prints ONE JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Workload parameters (match C++ baseline exactly).
S_PER_CELL = 1024
UMIS_PER_SNP = 2
NV = 8        # headline shape; extra rows bench other (V, A) below
NALPHA = 5
NSNPS = 8192
CAP_BQ = 40

EXTRA_SHAPES = [(2, 2), (16, 5), (32, 2), (32, 5), (64, 2)]

BASE_CELLS = int(os.environ.get("BENCH_BASE_CELLS", "256"))
BLOCK = int(os.environ.get("BENCH_BLOCK", "2048"))
ITERS = int(os.environ.get("BENCH_ITERS", "8"))
SLOT_CHUNK = int(os.environ.get("BENCH_SLOT_CHUNK", "512"))


def measure_cpp_baseline(nv: int = NV, nalpha: int = NALPHA,
                         cells: int = BASE_CELLS) -> float:
    """Build (from bench/ref_pairsearch.cpp) + run the single-thread C++
    replica; returns barcodes/s, best of two runs."""
    exe = os.path.join(ROOT, "bench", "ref_pairsearch")
    src = os.path.join(ROOT, "bench", "ref_pairsearch.cpp")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(
            ["g++", "-O2", "-march=native", "-o", exe, src, "-lm"],
            check=True,
        )
    best = 0.0
    for _ in range(2):
        out = subprocess.run(
            [exe, str(cells), str(S_PER_CELL), str(UMIS_PER_SNP), str(nv),
             str(nalpha), str(NSNPS)],
            check=True, capture_output=True, text=True,
        )
        best = max(best, float(json.loads(out.stdout)["barcodes_per_s"]))
    return best


def _synth_block(B: int, rng: np.random.Generator, nv: int = NV):
    """Synthetic slot tensors matching the C++ baseline's workload:
    per-UMI codes + slot SNP ids for the fast step, and the equivalent
    dense counts for the exact step; plus the SNP genotype table."""
    nq = CAP_BQ + 1
    nb = 2 * nq
    codes = np.zeros((B, S_PER_CELL, UMIS_PER_SNP), dtype=np.uint8)
    for u in range(UMIS_PER_SNP):
        al = rng.integers(0, 2, size=(B, S_PER_CELL))
        bq = rng.integers(13, CAP_BQ + 1, size=(B, S_PER_CELL))
        codes[:, :, u] = (al * nq + bq).astype(np.uint8)
    cnt = np.zeros((B * S_PER_CELL, nb), dtype=np.int32)
    flat = codes.reshape(B * S_PER_CELL, UMIS_PER_SNP).astype(np.int64)
    for u in range(UMIS_PER_SNP):
        np.add.at(cnt, (np.arange(B * S_PER_CELL), flat[:, u]), 1)
    idx = np.sort(rng.integers(0, NSNPS, size=(B, S_PER_CELL)),
                  axis=1).astype(np.int32)
    table = rng.dirichlet(np.ones(3), size=(NSNPS, nv))
    return codes, idx, cnt.reshape(B, S_PER_CELL, nb), table


def _time(fn, *args, iters=ITERS):
    """Wall times of `iters` calls, each ending in block_until_ready,
    after one warm-up call (compile)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return compile_s, ts


def measure_device(nv: int = NV, nalpha: int = NALPHA,
                   block: int = BLOCK) -> dict:
    """Fast and exact block-step throughput at one (nv, nalpha) shape."""
    import jax
    import jax.numpy as jnp

    from demuxlet_jax.backend import fast_pair_impl
    from demuxlet_jax.models.engine import compute_gp0
    from demuxlet_jax.models.likelihood import (
        auto_pair_chunk,
        pair_llks,
        singlet_llks,
    )
    from demuxlet_jax.ops import luts
    from demuxlet_jax.ops.pallas_pair import (
        dedup_channels,
        demux_block_fast,
        extend_luts,
    )

    grid = np.linspace(0.0, 0.5, nalpha).tolist()
    rng = np.random.default_rng(0)
    codes, idx, cnt, table = _synth_block(block, rng, nv)
    gp0 = compute_gp0(table)
    msk = np.ones(idx.shape, bool)

    cols, expand = dedup_channels(grid)
    w_ext, logf_ext = extend_luts(
        luts.pair_lut(grid, CAP_BQ)[:, list(cols)], luts.singlet_lut(CAP_BQ))
    impl = fast_pair_impl()
    fargs = [jax.device_put(jnp.asarray(x)) for x in (
        codes, idx, msk, table.astype(np.float32), gp0.astype(np.float32),
        w_ext, logf_ext)]

    @jax.jit
    def fast_step(*a):
        return demux_block_fast(*a, nalpha, nv, pair_impl=impl,
                                a0_sep=True, sym_a=nalpha - 1,
                                expand=expand)

    c_fast, t_fast = _time(fast_step, *fargs)

    eargs = [jax.device_put(jnp.asarray(x)) for x in (
        cnt, msk, table[idx], gp0[idx], luts.singlet_lut(CAP_BQ),
        luts.pair_lut(grid, CAP_BQ))]

    @jax.jit
    def exact_step(cnt, msk, gps, gp0, logf, w):
        l1, l0 = singlet_llks(cnt, msk, gps, gp0, logf)
        ab, z0 = pair_llks(cnt, msk, gps, gp0, w, nalpha,
                           slot_chunk=SLOT_CHUNK,
                           pair_chunk=auto_pair_chunk(
                               block, SLOT_CHUNK, nv, nalpha))
        return l1, l0, ab, z0

    c_exact, t_exact = _time(exact_step, *eargs, iters=max(2, ITERS // 2))

    def row(prefix, compile_s, ts):
        med = ts[len(ts) // 2]
        return {
            f"{prefix}barcodes_per_s": block / med,
            f"{prefix}step_ms": med * 1e3,
            f"{prefix}step_ms_minmax": [ts[0] * 1e3, ts[-1] * 1e3],
            f"{prefix}compile_s": compile_s,
        }

    return {"fast_pair_impl": impl, **row("", c_fast, t_fast),
            **row("exact_", c_exact, t_exact)}


def device_info() -> dict:
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "n_devices": len(devs),
    }
    if devs[0].platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        info["card"] = smi.stdout.strip().splitlines()[0]
    return info


def main():
    import jax

    from demuxlet_jax.utils.jaxcfg import enable_compilation_cache

    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    info = device_info()
    if info["platform"] != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {info['platform']}")
    base = measure_cpp_baseline()
    head = measure_device()
    extra = []
    for nv, nalpha in EXTRA_SHAPES:
        cells = BASE_CELLS if nv <= 16 else 32  # C++ cost grows ~V^2
        b = measure_cpp_baseline(nv, nalpha, cells=cells)
        t = measure_device(nv, nalpha)
        extra.append({
            "workload": f"V={nv} A={nalpha} S/cell={S_PER_CELL} "
                        f"umis/slot={UMIS_PER_SNP}",
            **t,
            "baseline_cpp_barcodes_per_s": b,
            "vs_baseline": t["barcodes_per_s"] / b,
        })
    result = {
        "metric": "pair_search_barcodes_per_s",
        "value": head["barcodes_per_s"],
        "unit": "barcodes/s",
        "vs_baseline": head["barcodes_per_s"] / base,
        "baseline_cpp_barcodes_per_s": base,
        "workload": f"V={NV} A={NALPHA} S/cell={S_PER_CELL} "
                    f"umis/slot={UMIS_PER_SNP}",
        **head,
        **info,
        "extra_workloads": extra,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
