#!/usr/bin/env python
"""Smoke test of demuxlet-jax's main path on one NVIDIA GPU.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: mesh and multi-process
                                       # runs against one card, nothing else
    python chip_smoke.py --rehearse    # CPU rehearsal at toy sizes (the
                                       # kernel in interpret mode); never
                                       # prints the result line

Phases (one GPU):
  1. device: JAX must find a GPU; prints device_kind, count, and the card's
     name and power limit (nvidia-smi);
  2. build: the native host libraries from the checked-in sources;
  3. kernel parity at real widths: one 2048-cell x 1024-slot block at
     V=8/A=5 and V=64/A=2 — the fast step (the platform's pair search)
     against the plain f32 and f64 contractions, each step compiled first
     with its memory_analysis() printed; the exact f64 step at V=64/A=5
     must not materialise a (B, S, V, V, A) temporary; then the tests
     marked `gpu`;
  4. the CLI end to end on a seeded 10x-style lane (10,000 barcodes,
     8 donors, 50,000 GT markers, ~500 covered markers per cell, ~7.5M
     reads), exact and fast mode: planted singlets/doublets called, fast
     calls equal exact calls, exact LLKs equal the NumPy oracle on a
     subsample of 200 cells at 1e-9.

One process uses the card: the CLI runs in-process; the oracle's worker
processes never import JAX. Any failure exits non-zero. The last line of
standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

FULL = dict(cells=10_000, donors=8, snps=50_000, per_cell=500,
            block=(2048, 1024), oracle_cells=200, interpret=False,
            min_acc=0.99)
REHEARSE = dict(cells=400, donors=8, snps=4_000, per_cell=80,
                block=(16, 64), oracle_cells=24, interpret=True,
                min_acc=0.95)


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr[-500:])
    lines = out.stdout.strip().splitlines()
    same = sorted(set(lines))
    return "; ".join(same) + (f" (x{len(lines)})" if len(lines) > 1 else "")


# ------------------------------------------------------------ phase 1


def phase_device(rehearse, want):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)}")
    if not rehearse:
        check(d.platform == "gpu", f"no GPU: JAX found {d.platform}")
        check(len(devs) >= want, f"need {want} GPUs, found {len(devs)}")
        card = card_line()
        log(f"[device] nvidia-smi: {card}")
    else:
        card = "cpu rehearsal"
    return d, card


# ------------------------------------------------------------ phase 2


def phase_build():
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "demuxlet_jax", "native",
                                      "build.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    check(out.returncode == 0, "native build failed: " + out.stderr[-2000:])
    from demuxlet_jax.native import ingest

    log(f"[build] native libraries built in {time.time() - t0:.1f}s; "
        f"CLI ingest: {'native' if ingest.available() else 'python'}")


# ------------------------------------------------------------ phase 3


def _block(B, S, V, grid, seed):
    """A codes-path block and its dense (counts, gathered gps) twin."""
    import numpy as np

    rng = np.random.default_rng(seed)
    NS, U = 8192, 2
    codes = np.full((B, S, U), 255, np.uint8)
    al = rng.integers(0, 2, size=(B, S, U))
    bq = rng.integers(13, 41, size=(B, S, U))
    real = rng.random((B, S, U)) < np.array([1.0, 0.5])
    codes[real] = (al * 41 + bq)[real]
    msk = rng.random((B, S)) < 0.95
    codes[~msk] = 255
    idx = rng.integers(0, NS, size=(B, S)).astype(np.int32)
    gtab = rng.dirichlet(np.ones(3), size=(NS, V))
    g0tab = gtab.mean(axis=1)
    cnt = np.zeros((B * S, 82), np.int32)
    flat = codes.reshape(B * S, U)
    for u in range(U):
        ok = flat[:, u] != 255
        np.add.at(cnt, (np.nonzero(ok)[0], flat[ok, u].astype(np.int64)), 1)
    return dict(codes=codes, idx=idx, msk=msk, gtab=gtab, g0tab=g0tab,
                cnt=cnt.reshape(B, S, 82))


def _mem(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (f"memory_analysis: temp={m.temp_size_in_bytes} "
            f"args={m.argument_size_in_bytes} "
            f"out={m.output_size_in_bytes}")


def phase_kernels(cfg):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from demuxlet_jax.backend import fast_pair_impl
    from demuxlet_jax.models import likelihood as L
    from demuxlet_jax.ops import luts
    from demuxlet_jax.ops.pallas_pair import (
        dedup_channels,
        demux_block_fast,
        extend_luts,
    )

    impl = "triton" if cfg["interpret"] else fast_pair_impl()
    B, S = cfg["block"]
    for V, A in ((8, 5), (64, 2)):
        grid = np.linspace(0.0, 0.5, A).tolist()
        blk = _block(B, S, V, grid, seed=V * 10 + A)
        cols, expand = dedup_channels(grid)
        w_ext, logf_ext = extend_luts(
            luts.pair_lut(grid, 40)[:, list(cols)], luts.singlet_lut(40))
        args = [jnp.asarray(blk[k]) for k in ("codes", "idx", "msk")] + [
            jnp.asarray(blk["gtab"], jnp.float32),
            jnp.asarray(blk["g0tab"], jnp.float32),
            jnp.asarray(w_ext), jnp.asarray(logf_ext)]
        kw = dict(n_alpha=A, n_samples=V, a0_sep=True, sym_a=A - 1,
                  expand=expand)
        outs = {}
        for name, extra in (
                ("plain_f32", dict(pair_impl="xla")),
                (impl, dict(pair_impl=impl, interpret=cfg["interpret"]))):
            t0 = time.time()
            comp = demux_block_fast.lower(*args, **kw, **extra).compile()
            t1 = time.time()
            out = jax.block_until_ready(comp(*args))
            t2 = time.time()
            log(f"[kernel] V={V} A={A} {name}: compile {t1 - t0:.1f}s, "
                f"first run {t2 - t1:.3f}s, {_mem(comp)}")
            outs[name] = [np.asarray(o, np.float64) for o in out]
        # plain f64 contraction (exact mode's step) on the dense twin
        neutral = np.array([1.0, 0.0, 0.0])
        msk = blk["msk"]
        gps_g = np.where(msk[..., None, None], blk["gtab"][blk["idx"]],
                         neutral)
        gp0_g = np.where(msk[..., None], blk["g0tab"][blk["idx"]], neutral)
        dense = [jnp.asarray(x) for x in (blk["cnt"], msk, gps_g, gp0_g)]
        ab, z0 = L.pair_llks(*dense, jnp.asarray(luts.pair_lut(grid, 40)),
                             A, slot_chunk=512)
        l1, l0 = L.singlet_llks(*dense, jnp.asarray(luts.singlet_lut(40)))
        ref64 = [np.asarray(x) for x in (l1, l0, ab, z0)]

        def rel(a, b):
            return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

        names = ("llk", "llk0", "llk_ab", "llk_00")
        e64 = max(rel(a, b) for a, b in zip(outs[impl], ref64))
        e32 = max(rel(a, b) for a, b in zip(outs[impl], outs["plain_f32"]))
        p64 = max(rel(a, b) for a, b in zip(outs["plain_f32"], ref64))
        log(f"[kernel] V={V} A={A} parity: {impl} vs f64 {e64:.3g} "
            f"(<= 1e-4), {impl} vs plain f32 {e32:.3g} (<= 1e-5), "
            f"plain f32 vs f64 {p64:.3g} (<= 1e-4)")
        check(e64 <= 1e-4 and p64 <= 1e-4,
              f"fast step vs f64 beyond 1e-4 at V={V} A={A}")
        check(e32 <= 1e-5, f"{impl} vs plain f32 beyond 1e-5 at V={V} A={A}")
        for o, n in zip(outs[impl], names):
            check(np.isfinite(o).all(), f"non-finite {n} at V={V} A={A}")

    # exact f64 step at V=64/A=5: neither the engine's row blocking
    # (auto_pair_chunk) nor the unblocked form may materialise a
    # (B, slot_chunk, V, V, A) f64 temporary on the GPU
    V, A, chunk = 64, 5, 512
    grid = np.linspace(0.0, 0.5, A).tolist()
    blk = _block(B, S, V, grid, seed=7)
    neutral = np.array([1.0, 0.0, 0.0])
    dense = [blk["cnt"], blk["msk"],
             np.where(blk["msk"][..., None, None], blk["gtab"][blk["idx"]],
                      neutral),
             np.where(blk["msk"][..., None], blk["g0tab"][blk["idx"]],
                      neutral),
             luts.pair_lut(grid, 40)]
    dense = [jnp.asarray(x) for x in dense]
    bound = B * min(S, chunk) * V * V * A * 8
    auto = L.auto_pair_chunk(B, chunk, V, A)
    outs = []
    for pc in sorted({0, auto}):
        t0 = time.time()
        comp = L.pair_llks.lower(*dense, A, slot_chunk=chunk,
                                 pair_chunk=pc).compile()
        log(f"[exact] V={V} A={A} f64 pair step B={B} S={S} pair_chunk="
            f"{pc}: compile {time.time() - t0:.1f}s, {_mem(comp)}")
        m = comp.memory_analysis()
        fits = m is None or m.temp_size_in_bytes < bound
        if not fits:
            log(f"[exact] pair_chunk={pc}: temp >= one (B, chunk, V, V, A) "
                f"f64 temporary ({bound} B)")
            if pc == auto:
                check(cfg["interpret"], "exact step materialises the "
                      "(B, S, V, V, A) contraction")
            continue
        jax.block_until_ready(comp(*dense))
        t0 = time.time()
        out = jax.block_until_ready(comp(*dense))
        log(f"[exact] V={V} A={A} pair_chunk={pc}: {time.time() - t0:.3f}s "
            f"per block (second run)")
        outs.append([np.asarray(o) for o in out])
    check(all(np.isfinite(o).all() for r in outs for o in r),
          "non-finite exact LLKs")
    if len(outs) == 2:
        check(all(np.array_equal(a, b) for a, b in zip(*outs)),
              "row-blocked exact step differs from the unblocked one")


def phase_gpu_tests(rehearse):
    import pytest

    xml = os.path.join(tempfile.mkdtemp(), "gpu.xml")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", f"--junitxml={xml}",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    import re

    s = open(xml).read()
    m = re.search(r'errors="(\d+)" failures="(\d+)" skipped="(\d+)" '
                  r'tests="(\d+)"', s)
    err, fail, skip, tests = map(int, m.groups())
    log(f"[gpu tests] rc={rc} tests={tests} failures={fail} errors={err} "
        f"skipped={skip}")
    check(rc == 0 and fail == 0 and err == 0, "gpu-marked tests failed")
    if not rehearse:
        check(tests > 0 and skip == 0, "gpu-marked tests did not all run")


# ------------------------------------------------------------ phase 4


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv, card, label):
    """demuxlet_jax.cli.main in-process; returns (seconds, captured
    stderr). Prints its phase timings, compile seconds and peak device
    memory, labelled with the card."""
    import jax
    import jax.monitoring as mon

    from demuxlet_jax import cli

    compile_s = [0.0]

    def on_event(event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += duration

    mon.register_event_duration_secs_listener(on_event)
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
            rc = cli.main(argv)
    finally:
        mon.unregister_event_duration_listener(on_event)
    dt = time.time() - t0
    check(rc == 0, f"{label}: CLI exit {rc}")
    stats = jax.devices()[0].memory_stats() or {}
    for ln in buf.getvalue().splitlines():
        if "Phase timing" in ln or "Device passes" in ln or \
                "Total wall-clock" in ln:
            log(f"[cli {label}] {ln.split(' - ', 1)[-1]} [{card}]")
    if "--mode" in argv and argv[argv.index("--mode") + 1] == "fast":
        # fast mode must have run the kernel compiled for the card
        want = "xla" if "cpu" in argv else "triton"
        check(f"pair search={want})" in buf.getvalue(),
              f"{label}: fast mode did not use the {want} pair search")
    log(f"[cli {label}] wall {dt:.2f}s, compile {compile_s[0]:.2f}s, "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')} "
        f"[{card}]")
    return dt, buf.getvalue()


def best_calls(prefix):
    from parity_utils import canonicalize_best_line

    calls = {}
    with open(prefix + ".best") as fh:
        for ln in fh.read().splitlines()[1:]:
            cols = canonicalize_best_line(ln).split("\t")
            calls[cols[0]] = cols[5]
    return calls


def check_truth(calls, lane, label, min_acc):
    n_sng = n_sng_ok = n_dbl = n_dbl_ok = 0
    for bc, (d1, d2) in lane.truth.items():
        got = calls.get(bc, "")
        if d1 == d2:
            n_sng += 1
            n_sng_ok += got == f"SNG-D{d1}"
        else:
            n_dbl += 1
            a, b = sorted((f"D{d1}", f"D{d2}"))
            n_dbl_ok += got.startswith(f"DBL-{a}-{b}-")
    fs, fd = n_sng_ok / max(n_sng, 1), n_dbl_ok / max(n_dbl, 1)
    log(f"[cli {label}] planted singlets called SNG-<truth>: {n_sng_ok}/"
        f"{n_sng} ({fs:.4f}); planted doublets DBL-<pair>: {n_dbl_ok}/"
        f"{n_dbl} ({fd:.4f})")
    check(fs >= min_acc, f"{label}: singlet accuracy {fs:.4f} < {min_acc}")
    check(fd >= min_acc, f"{label}: doublet accuracy {fd:.4f} < {min_acc}")


def make_lane(cfg, work, seed=0):
    from benchmarks.lane_workload import make_lane as mk

    t0 = time.time()
    lane = mk(work, n_cells=cfg["cells"], n_donors=cfg["donors"],
              n_snps=cfg["snps"], snps_per_cell=cfg["per_cell"], seed=seed)
    log(f"[workload] {cfg['cells']} barcodes, {cfg['donors']} donors, "
        f"{cfg['snps']} GT markers, {lane.n_reads} reads: generated in "
        f"{time.time() - t0:.1f}s (host, not part of any demux time)")
    return lane


def oracle_check(lane, cfg, device_label):
    """Exact-mode LLKs of an oracle subsample: the BAM ingest restricted
    to the subsample's barcodes + the exact engine, against the NumPy
    oracle run on the generator's own read record (worker processes that
    never import JAX)."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp

    import numpy as np

    from benchmarks.lane_workload import oracle_llks
    from demuxlet_jax.io.vcf import load_snp_table
    from demuxlet_jax.models.engine import DemuxEngine
    from demuxlet_jax.native import ingest

    rng = np.random.default_rng(1)
    cells = np.sort(rng.choice(cfg["cells"], cfg["oracle_cells"],
                               replace=False))
    table = load_snp_table(lane.vcf, field_name="GT")
    check(table.nsnps == cfg["snps"], "VCF loader dropped markers")
    grid = [0.0, 0.5]
    group = {lane.barcodes[c] for c in cells}
    scl, _ = ingest.build_pileup(lane.bam, table, group_set=group)
    res = DemuxEngine(table.gps, grid, cell_block=256).run(scl)
    row = {bc: i for i, bc in enumerate(scl.barcodes)}

    n_w = min(16, os.cpu_count() or 1)
    parts = np.array_split(cells, n_w)
    t0 = time.time()
    with ProcessPoolExecutor(n_w, mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(oracle_llks, lane.obs, table.gps, p, grid)
                for p in parts if len(p)]
        got = [f.result() for f in futs]
    log(f"[oracle] {len(cells)} cells in {time.time() - t0:.1f}s on "
        f"{n_w} worker processes")
    worst = 0.0
    for p, (o_l, o_l0, o_ab, o_00) in zip(parts, got):
        r = [row[lane.barcodes[c]] for c in p]
        for a, b in ((res.llks[r], o_l), (res.llk0s[r], o_l0),
                     (res.llk_ab[r], o_ab), (res.llk_00[r], o_00)):
            worst = max(worst, float(np.abs(a - b).max()))
    log(f"[oracle] exact LLKs vs oracle: max |diff| {worst:.3g} (<= 1e-9) "
        f"[{device_label}]")
    check(worst <= 1e-9, f"exact LLKs differ from the oracle by {worst}")


def phase_cli(cfg, card, work):
    lane = make_lane(cfg, work)
    common = ["--sam", lane.bam, "--vcf", lane.vcf, "--field", "GT",
              "--device", "cpu" if cfg["interpret"] else "gpu"]
    outs = {}
    for mode in ("exact", "fast"):
        out = os.path.join(work, mode)
        run_cli(common + ["--mode", mode, "--out", out], card, mode)
        outs[mode] = best_calls(out)
        check_truth(outs[mode], lane, mode, cfg["min_acc"])
    diff = [bc for bc in outs["exact"] if outs["fast"].get(bc) !=
            outs["exact"][bc]]
    log(f"[cli] fast vs exact calls (canonicalized): {len(diff)} differ "
        f"of {len(outs['exact'])}")
    check(not diff, f"fast calls differ from exact: {diff[:5]}")
    oracle_check(lane, cfg, card)


# ------------------------------------------------------------ four cards


def four_cards(cfg, work, rehearse):
    """--mesh auto on 4 cards vs --mesh none on one card (in-process), and
    4 one-card processes (--num-shards 4 --shard-by barcode) vs one card.
    The distributed processes run first, while this process is off JAX.
    Rehearsal: 4 virtual CPU devices."""
    import socket

    if rehearse:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=4")
    else:
        card_line()  # fails without a GPU
    lane = make_lane(cfg, work)
    common = ["--sam", lane.bam, "--vcf", lane.vcf, "--field", "GT",
              "--device", "cpu" if rehearse else "gpu", "--mode", "exact"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist = os.path.join(work, "dist")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_jax.cli"] + common +
        ["--out", dist, "--num-shards", "4", "--shard-by", "barcode",
         "--shard-id", str(k), "--dist-coordinator", f"localhost:{port}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for k in range(4)]
    try:
        errs = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for k, (p, e) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"shard {k} failed: {e[-3000:]}")
        for ln in e.splitlines():
            if "Device passes" in ln or "Device:" in ln:
                log(f"[4-proc shard {k}] {ln.split(' - ', 1)[-1]}")
    log(f"[4-proc] 4 one-card processes: {time.time() - t0:.1f}s wall")

    d, card = phase_device(rehearse, 4)
    import jax

    from demuxlet_jax.utils.jaxcfg import enable_compilation_cache

    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    check(len(jax.devices()) >= 4, "need 4 devices")

    log(f"[four-cards] {card}; JAX devices: {len(jax.devices())}")
    runs = {}
    for mode in ("exact", "fast"):
        for mesh in ("auto", "none"):
            out = os.path.join(work, f"{mode}_{mesh}")
            argv = common[:-1] + [mode, "--mesh", mesh, "--out", out]
            run_cli(argv, card, f"{mode} mesh={mesh}")
            runs[(mode, mesh)] = out
    for ext in (".best", ".single", ".sing2"):
        a = open(runs[("exact", "auto")] + ext, "rb").read()
        b = open(runs[("exact", "none")] + ext, "rb").read()
        c = open(dist + ext, "rb").read()
        log(f"[four-cards] exact {ext}: mesh=auto vs one card "
            f"{'identical' if a == b else 'DIFFER'}; 4-process merge vs "
            f"one card {'identical' if c == b else 'DIFFER'}")
        check(a == b, f"exact {ext}: 4-card mesh differs from one card")
        check(c == b, f"exact {ext}: 4-process merge differs from one card")
    fa = best_calls(runs[("fast", "auto")])
    fn = best_calls(runs[("fast", "none")])
    ex = best_calls(runs[("exact", "none")])
    nd = sum(fa[bc] != fn[bc] for bc in fn)
    ne = sum(fa[bc] != ex[bc] for bc in ex)
    log(f"[four-cards] fast calls mesh=auto vs one card: {nd} differ; "
        f"vs exact (canonicalized): {ne} differ")
    check(nd == 0, "fast calls differ between the mesh and one card")
    check(ne == 0, "fast mesh calls differ from exact calls")
    check_truth(fa, lane, "fast mesh=auto", cfg["min_acc"])
    check_truth(fn, lane, "fast one card", cfg["min_acc"])
    return d, 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh and 4-process paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at toy sizes; prints no result")
    args = ap.parse_args(argv)
    cfg = REHEARSE if args.rehearse else FULL
    work = tempfile.mkdtemp(prefix="demux_smoke_")
    t0 = time.time()
    try:
        if args.four_cards:
            d, count = four_cards(cfg, work, args.rehearse)
        else:
            from demuxlet_jax.utils.jaxcfg import enable_compilation_cache

            import jax

            jax.config.update("jax_enable_x64", True)
            enable_compilation_cache()
            d, card = phase_device(args.rehearse, 1)
            count = 1
            phase_build()
            phase_kernels(cfg)
            phase_gpu_tests(args.rehearse)
            phase_cli(cfg, card, work)
    except SmokeError as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    log(f"[smoke] all phases passed in {time.time() - t0:.1f}s")
    if args.rehearse:
        log("rehearsal passed (no result line on the CPU)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
