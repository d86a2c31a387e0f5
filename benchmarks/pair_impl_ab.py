#!/usr/bin/env python
"""A/B of the fast-mode pair search on a GPU: the Pallas-Triton kernel
against the plain f32 XLA contraction, per (V, A) shape.

    python benchmarks/pair_impl_ab.py            # every shape below
    python benchmarks/pair_impl_ab.py --shapes 8x5,64x2 --pairs 4
    python benchmarks/pair_impl_ab.py --sweep    # kernel-config sweep only

Per shape (2048-cell x 1024-slot blocks, grid linspace(0, 0.5, A)):
  * step: one device-resident fast block step per implementation
    (median of 5), and its max relative difference from the plain step;
  * parity: both routes' full LLK tensors (DemuxEngine.run in fast mode)
    against exact mode's f64 contraction at 1e-4 * max(1, |ref|), and the
    .best calls of both routes' device decision pass (run_compact)
    against exact mode's, after parity_utils.canonicalize_best. Each call
    that still differs is classified by its f64 decision margin: below
    twice the f32 tolerance it is a near-tie, beyond it an error (exit 1);
  * e2e: `--pairs` alternating pairs of run_compact runs (xla, triton,
    then triton, xla, ...) after a warm-up of each.

Workload: `--blocks` x 2048 cells, each covering exactly 1024 distinct
markers with 1-2 UMIs, planted from V donors with GT-style posteriors
(10% alpha = 0.5 doublets), the way benchmarks/lane_workload.py plants
its lane. One JSON line per measurement goes to --out. Needs a GPU.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

SHAPES = [(V, A) for V in (2, 8, 16, 32, 64) for A in (2, 5)]
IMPLS = ("xla", "triton")
DOUBLET_PRIOR = 0.5
# kernel-config candidates (overrides of pallas_pair.KERNEL_CFG); TB=16
# at V=8/A=5 compiled for ~400 s on an H100 and is left out
SWEEP = [
    {},
    {"TB": 4},
    {"TS": 16},
    {"TB": 4, "TS": 16},
    {"TB": 2},
    {"TB": 4, "log_batch": 1},
    {"TB": 4, "num_warps": 2},
    {"TB": 4, "min_programs": 4096},
]


class ParityError(Exception):
    pass


def pileup(n_cells, V, seed=0, n_snps=50_000, per_cell=1024,
           doublet_rate=0.1, geno_error=0.01):
    """Planted CSR pileup: (scl, gps, truth (d1, d2) per cell)."""
    from demuxlet_jax.host.csr import CsrPileup

    rng = np.random.default_rng(seed)
    geno = rng.choice(3, size=(n_snps, V), p=[0.36, 0.48, 0.16])
    gps = np.full((n_snps, V, 3), geno_error / 2)
    np.put_along_axis(gps, geno[..., None], 1.0 - geno_error, axis=2)
    d1 = rng.integers(0, V, size=n_cells)
    d2 = d1.copy()
    if V > 1:
        dbl = rng.random(n_cells) < doublet_rate
        d2[dbl] = (d1[dbl] + rng.integers(1, V, size=dbl.sum())) % V
    gaps = rng.integers(1, n_snps // per_cell, size=(n_cells, per_cell))
    snps = np.cumsum(gaps, axis=1) - 1
    reps = 1 + (rng.random(snps.shape) < 0.5)
    cell = np.repeat(np.repeat(np.arange(n_cells), per_cell), reps.ravel())
    snp = np.repeat(snps.ravel(), reps.ravel())
    n = len(cell)
    src = np.where(rng.random(n) < 0.5, d1[cell], d2[cell])
    bq = rng.integers(13, 41, n)
    allele = (rng.random(n) < geno[snp, src] / 2.0) ^ (
        rng.random(n) < 10.0 ** (-bq / 10.0))
    scl = CsrPileup.from_arrays(
        [f"S{i}" for i in range(V)], n_snps,
        ["C%06d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        cell, snp, allele.astype(np.uint8), bq.astype(np.uint8))
    return scl, gps, (d1, d2)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def step_args(V, A, B=2048, S=1024, seed=1):
    import jax.numpy as jnp

    from demuxlet_jax.ops import luts
    from demuxlet_jax.ops.pallas_pair import dedup_channels, extend_luts

    rng = np.random.default_rng(seed)
    NS = 50_000
    codes = np.full((B, S, 2), 255, np.uint8)
    real = rng.random((B, S, 2)) < np.array([1.0, 0.5])
    codes[real] = rng.integers(13, 82, size=real.sum())
    idx = np.sort(rng.integers(0, NS, size=(B, S)), axis=1).astype(np.int32)
    msk = np.ones((B, S), bool)
    gtab = rng.dirichlet(np.ones(3), size=(NS, V)).astype(np.float32)
    grid = np.linspace(0.0, 0.5, A).tolist()
    cols, expand = dedup_channels(grid)
    w_ext, logf_ext = extend_luts(
        luts.pair_lut(grid, 40)[:, list(cols)], luts.singlet_lut(40))
    args = [jnp.asarray(x) for x in (codes, idx, msk, gtab,
                                      gtab.mean(axis=1), w_ext, logf_ext)]
    kw = dict(n_alpha=A, n_samples=V, a0_sep=True, sym_a=A - 1,
              expand=expand)
    return args, kw


def time_step(fn, args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)


def step(out, shapes, configs):
    """Device-resident step time per kernel config (and the plain
    contraction); parity of each against the plain f32 step. Returns
    {(V, A): [(median_s, cfg)]} of the configs within 1e-5."""
    import jax

    from demuxlet_jax.ops.pallas_pair import demux_block_fast

    best = {}
    for V, A in shapes:
        args, kw = step_args(V, A)
        ref_fn = jax.jit(lambda *a: demux_block_fast(*a, pair_impl="xla",
                                                     **kw))
        ref = [np.asarray(x, np.float64) for x in ref_fn(*args)]
        ts = time_step(ref_fn, args)
        out(dict(kind="step", V=V, A=A, impl="xla", cfg=None,
                 median_s=ts[len(ts) // 2], min_s=ts[0], max_s=ts[-1]))
        for cfg in configs:
            kc = tuple(sorted(cfg.items()))
            fn = jax.jit(lambda *a, kc=kc: demux_block_fast(
                *a, pair_impl="triton", kernel_cfg=kc, **kw))
            t0 = time.perf_counter()
            try:
                got = [np.asarray(x, np.float64) for x in fn(*args)]
            except Exception as e:  # a config the compiler refuses
                if not cfg:
                    raise
                out(dict(kind="step", V=V, A=A, impl="triton", cfg=cfg,
                         error=f"{type(e).__name__}: {str(e)[:300]}"))
                continue
            comp = time.perf_counter() - t0
            err = max(float((np.abs(g - r) / np.maximum(1, np.abs(r))).max())
                      for g, r in zip(got, ref))
            ts = time_step(fn, args)
            out(dict(kind="step", V=V, A=A, impl="triton", cfg=cfg,
                     compile_and_first_s=comp, rel_err_vs_plain=err,
                     median_s=ts[len(ts) // 2], min_s=ts[0], max_s=ts[-1]))
            if err <= 1e-5:
                best.setdefault((V, A), []).append((ts[len(ts) // 2], cfg))
    return best


def best_calls(scl, comp, grid):
    """{cell id: BEST call of the canonicalized .best row}, rendered
    from a decision.CompactResult by the CLI's own writer."""
    from parity_utils import canonicalize_best_line

    from demuxlet_jax.models.engine import cell_stats
    from demuxlet_jax.models.outputs import write_pass2_compact

    buf = io.StringIO()
    write_pass2_compact(cell_stats(scl), scl.sample_ids, comp, grid,
                        DOUBLET_PRIOR, io.StringIO(), buf)
    calls = {}
    for ln in buf.getvalue().splitlines()[1:]:
        cols = canonicalize_best_line(ln).split("\t")
        calls[int(cols[0][1:])] = cols[5]
    return calls


def decision_margin(llk_ab, c):
    """Smallest f64 distance of cell c's .best decision from a flip: the
    gap between the two best distinct doublet candidates (the mirrored
    alpha = 0.5 pair counts once) and the slack of each call threshold
    (cmd_cram_demuxlet.cpp:830-850)."""
    from demuxlet_jax.models.decision import doublet_mask

    V, _, A = llk_ab.shape[1:]
    ab = llk_ab[c]
    sing = ab[:, 0, 0]
    msk = doublet_mask(V, A)
    gaps = []
    if msk.any():
        top = np.unique(np.round(ab[msk], 9))[::-1]
        if len(top) > 1:
            gaps.append(top[0] - top[1])
        b = int(np.argmax(np.where(msk, ab, -np.inf)))
        jb, kb = b // (V * A), (b // A) % V
        p12 = ab.ravel()[b]
        gaps += [p12 - sing[jb], p12 - sing[kb], p12 - (sing.max() + 2)]
    if V > 1:
        s = np.sort(sing)[::-1]
        gaps.append(s[0] - (s[1] + 2))
    return float(min(abs(g) for g in gaps))


def truth_hits(calls, truth):
    d1, d2 = truth
    ok = 0
    for c, call in calls.items():
        if d1[c] == d2[c]:
            ok += call == f"SNG-S{d1[c]}"
        else:
            parts = call.split("-")
            ok += (call.startswith("DBL-") and
                   {parts[1], parts[2]} == {f"S{d1[c]}", f"S{d2[c]}"})
    return ok


def parity(out, V, A, scl, gps, truth, comps):
    """Both routes against exact mode's f64 contraction: full LLK tensors
    at 1e-4 * max(1, |ref|) and canonicalized .best calls."""
    from demuxlet_jax.models import decision as D
    from demuxlet_jax.models.engine import DemuxEngine

    grid = np.linspace(0.0, 0.5, A).tolist()
    t0 = time.perf_counter()
    ref = DemuxEngine(gps, grid, cell_block=2048).run(scl)
    ref_s = time.perf_counter() - t0
    names = ("llks", "llk0s", "llk_ab", "llk_00")
    exact_calls = best_calls(
        scl, D.compact_from_result(ref.llk_ab, ref.llk_00, grid,
                                   DOUBLET_PRIOR), grid)
    rec = dict(kind="parity", V=V, A=A, exact_s=ref_s, cells=scl.nbcs,
               exact_truth_hits=truth_hits(exact_calls, truth))
    exact_best = D.compact_from_result(ref.llk_ab, ref.llk_00, grid,
                                       DOUBLET_PRIOR).best_flat
    bad = []
    for impl in IMPLS:
        eng = DemuxEngine(gps, grid, cell_block=2048, mode="fast")
        eng.pair_impl = impl
        got = eng.run(scl)
        errs = {n: float((np.abs(getattr(got, n) - getattr(ref, n))
                          / np.maximum(1.0, np.abs(getattr(ref, n)))).max())
                for n in names}
        calls = best_calls(scl, comps[impl], grid)
        diff = sorted(c for c in exact_calls if calls[c] != exact_calls[c])
        margins = [decision_margin(ref.llk_ab, c) for c in diff]
        # two LLKs each within 1e-4 * max(1, |LLK|) of f64 can swap order
        # when their f64 gap is below twice that
        tol = [2e-4 * max(1.0, abs(float(ref.llk_ab[c].max())))
               for c in diff]
        errors = [c for c, m, t in zip(diff, margins, tol) if m > t]
        rec[impl] = dict(
            rel_err_vs_f64=errs, truth_hits=truth_hits(calls, truth),
            calls_differ=len(diff),
            calls_differ_near_tie=len(diff) - len(errors),
            max_margin_of_differing=max(margins, default=0.0),
            raw_best_flat_differ=int((comps[impl].best_flat
                                      != exact_best).sum()),
            examples=[(c, exact_calls[c], calls[c], m)
                      for c, m in list(zip(diff, margins))[:5]])
        if max(errs.values()) > 1e-4:
            bad.append(f"{impl} LLKs beyond 1e-4 of f64 at V={V} A={A}")
        if errors:
            bad.append(f"{impl}: {len(errors)} calls differ from exact "
                       f"beyond the f32 tolerance at V={V} A={A}")
    out(rec)
    if bad:
        raise ParityError("; ".join(bad))


def e2e(out, shapes, blocks, pairs):
    from demuxlet_jax.models.engine import DemuxEngine

    for V, A in shapes:
        scl, gps, truth = pileup(2048 * blocks, V)
        grid = np.linspace(0.0, 0.5, A).tolist()
        engs = {}
        for impl in IMPLS:
            eng = DemuxEngine(gps, grid, cell_block=2048, mode="fast")
            eng.pair_impl = impl
            t0 = time.perf_counter()
            eng.run_compact(scl, DOUBLET_PRIOR)  # compile + warm
            out(dict(kind="e2e_warmup", V=V, A=A, impl=impl,
                     seconds=time.perf_counter() - t0))
            engs[impl] = eng
        res = {impl: [] for impl in IMPLS}
        comps = {}
        for p in range(pairs):
            for impl in (IMPLS if p % 2 == 0 else IMPLS[::-1]):
                t0 = time.perf_counter()
                _, _, comps[impl] = engs[impl].run_compact(scl,
                                                           DOUBLET_PRIOR)
                dt = time.perf_counter() - t0
                res[impl].append(dt)
                out(dict(kind="e2e", V=V, A=A, impl=impl, pair=p,
                         seconds=dt, barcodes_per_s=scl.nbcs / dt,
                         phase_s=engs[impl].phase_s))
        x, t = np.asarray(res["xla"]), np.asarray(res["triton"])
        out(dict(kind="e2e_summary", V=V, A=A, pairs=pairs,
                 xla_s=res["xla"], triton_s=res["triton"],
                 xla_median_s=float(np.median(x)),
                 triton_median_s=float(np.median(t)),
                 triton_faster_pairs=int((t < x).sum()),
                 median_ratio_xla_over_triton=float(np.median(x / t))))
        parity(out, V, A, scl, gps, truth, comps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="kernel-config sweep at 8x5 and 64x2 only")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating (xla, triton) pairs per shape")
    ap.add_argument("--shapes", default=None,
                    help="comma list VxA, e.g. 8x5,64x2")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "pair_ab.jsonl"))
    args = ap.parse_args()
    import jax

    from demuxlet_jax.utils.jaxcfg import enable_compilation_cache

    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"needs a GPU, JAX found {d.platform}")
    label = dict(device_kind=d.device_kind, n_devices=len(jax.devices()),
                 card=card())
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    fh = open(args.out, "a")

    def out(rec):
        rec = dict(rec, **label)
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        fh.write(line + "\n")
        fh.flush()

    shapes = SHAPES
    if args.shapes:
        shapes = [tuple(int(x) for x in s.split("x"))
                  for s in args.shapes.split(",")]
    if args.sweep:
        from demuxlet_jax.ops import pallas_pair

        best = step(out, [(8, 5), (64, 2)], SWEEP)
        # the config with the best geometric-mean time over the swept
        # shapes
        score = {}
        for v in best.values():
            base = dict((json.dumps(c, sort_keys=True), t) for t, c in v)
            ref = base.get("{}", min(base.values()))
            for key, t in base.items():
                score.setdefault(key, []).append(np.log(t / ref))
        full = [k for k, v in score.items() if len(v) == len(best)]
        if full:
            pick = json.loads(min(full, key=lambda k: sum(score[k])))
            out(dict(kind="sweep_pick", cfg=pick,
                     kernel_cfg=dict(pallas_pair.KERNEL_CFG, **pick)))
        return 0
    step(out, shapes, [{}])
    try:
        e2e(out, shapes, args.blocks, args.pairs)
    except ParityError as e:
        out(dict(kind="parity_failed", error=str(e)))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
