"""demuxlet-jax command-line interface.

Mirrors the reference binary's 24 options and defaults 1:1
(cmd_cram_demuxlet.cpp:37-72) and adds an "Engine options" group for
device execution control. Outputs .single/.sing2/.best and (with
--write-pair) .pair, byte-compatible with the reference.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from demuxlet_jax.utils.logging_utils import error, notice


class _BgzfText:
    """Text adapter over the BGZF writer for compressed outputs."""

    def __init__(self, path: str):
        from demuxlet_jax.io.bgzf import BgzfWriter

        self._w = BgzfWriter(open(path, "wb"))

    def write(self, s: str) -> None:
        self._w.write(s.encode())

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_out(prefix: str, ext: str):
    """Open an output file for the given prefix + extension.

    A prefix ending in .gz implies BGZF-compressed outputs (the reference's
    hprintf writes through bgzf when the htsFile was opened compressed,
    hts_utils.cpp:1013-1034): --out x.gz writes x.single.gz etc."""
    if prefix.endswith(".gz"):
        return _BgzfText(prefix[:-3] + ext + ".gz")
    return open(prefix + ext, "w")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="demuxlet-jax",
        description=(
            "Accelerated droplet demultiplexing: deconvolute sample identity "
            "and detect doublets from pooled single-cell data using natural "
            "genetic variation."
        ),
    )
    g = p.add_argument_group("Options for input SAM/BAM/CRAM")
    g.add_argument("--sam", required=True, help="Input SAM/BAM file, coordinate-sorted")
    g.add_argument("--tag-group", default="CB", help="Tag for cell barcodes (CB)")
    g.add_argument("--tag-UMI", default="UB", help="Tag for UMIs (UB)")

    g = p.add_argument_group("Options for input VCF/BCF")
    g.add_argument("--vcf", required=True, help="Input VCF/BCF with genotypes")
    g.add_argument(
        "--field",
        default="GP",
        help="FORMAT field to extract genotype/likelihood/posterior (GT/GP/PL)",
    )
    g.add_argument(
        "--geno-error",
        type=float,
        default=0.01,
        help="Genotype error rate (must be used with --field GT)",
    )
    g.add_argument("--min-mac", type=int, default=1, help="Minimum minor allele count")
    g.add_argument(
        "--min-callrate", type=float, default=0.5, help="Minimum call rate"
    )
    g.add_argument(
        "--sm", action="append", default=[], help="Sample ID to include (repeatable)"
    )
    g.add_argument("--sm-list", default=None, help="File with sample IDs to include")
    g.add_argument(
        "--ref",
        default=None,
        help=(
            "FASTA (with .fai) or .fai giving chromosome lengths for "
            "-_BEG_-/-_END_- chunk patterns (genomeChunk.cpp:91-126); "
            "defaults to lengths from the BAM header"
        ),
    )
    g.add_argument(
        "--chunk-unit",
        type=int,
        default=None,
        help="Chunk size in bp for -_BEG_-/-_END_- VCF filename patterns",
    )

    g = p.add_argument_group("Output Options")
    g.add_argument("--out", required=True, help="Output file prefix")
    g.add_argument(
        "--alpha",
        action="append",
        type=float,
        default=None,
        help="Grid of alpha to search (repeatable; default 0, 0.5)",
    )
    g.add_argument("--write-pair", action="store_true", help="Write the (HUGE) pair file")
    g.add_argument(
        "--doublet-prior", type=float, default=0.5, help="Prior of doublet"
    )
    g.add_argument("--sam-verbose", type=int, default=1000000)
    g.add_argument("--vcf-verbose", type=int, default=10000)

    g = p.add_argument_group("Read filtering Options")
    g.add_argument("--cap-BQ", type=int, default=40, help="Maximum base quality cap")
    g.add_argument("--min-BQ", type=int, default=13, help="Minimum base quality")
    g.add_argument("--min-MQ", type=int, default=20, help="Minimum mapping quality")
    g.add_argument("--min-TD", type=int, default=0, help="Minimum tail distance")
    g.add_argument(
        "--excl-flag", type=int, default=0x0F04, help="SAM flags to exclude"
    )

    g = p.add_argument_group("Cell/droplet filtering options")
    g.add_argument("--group-list", default=None, help="Barcode whitelist file")
    g.add_argument(
        "--num-shards",
        type=int,
        default=1,
        help=(
            "Split barcodes into N deterministic stripes (crc32 hash); this "
            "process handles stripe --shard-id (one process per GPU). The "
            "analog of manual --group-list sharding"
        ),
    )
    g.add_argument("--shard-id", type=int, default=0, help="Stripe index for --num-shards")
    g.add_argument(
        "--shard-by",
        default="barcode",
        choices=["barcode", "genome"],
        help=(
            "--num-shards decomposition: 'barcode' stripes cells by crc32 "
            "(disjoint outputs, concat-merged); 'genome' gives each shard "
            "a contiguous bp-balanced genome span — the BAI-seeked ingest "
            "scans ~1/N of the BAM, SNPs partition by position, and "
            "per-shard LLK contributions SUM at the distributed merge"
        ),
    )
    g.add_argument(
        "--dist-coordinator",
        default=None,
        metavar="HOST:PORT",
        help=(
            "jax.distributed coordinator address; with --num-shards N and "
            "--shard-id k this process joins an N-process run (process k, "
            "one local GPU each), shard results all-gather compactly, and "
            "process 0 writes the single merged output set"
        ),
    )
    g.add_argument("--min-total", type=int, default=0)
    g.add_argument("--min-uniq", type=int, default=0)
    g.add_argument("--min-snp", type=int, default=0)

    g = p.add_argument_group("Engine options")
    g.add_argument(
        "--mesh",
        default="auto",
        metavar="auto|none|BxS",
        help=(
            "Multi-device mesh: 'auto' data-parallels barcodes over "
            "all local devices (no-op with one device), 'none' disables, "
            "'BxS' shards barcodes x SNP-slots (exact mode only; psum over "
            "the slot axis)"
        ),
    )
    g.add_argument(
        "--device",
        default="auto",
        choices=["auto", "gpu", "cpu"],
        help=(
            "Execution platform: gpu requires a CUDA GPU (error otherwise); "
            "cpu runs on the host; auto = JAX's default backend"
        ),
    )
    g.add_argument(
        "--precision",
        default="f64",
        choices=["f64", "f32"],
        help="Device compute precision (f64 = reference parity)",
    )
    g.add_argument(
        "--mode",
        default="exact",
        choices=["exact", "fast", "parity"],
        help=(
            "exact: f64 device contraction (printed values reference-"
            "identical; exact ulp-ties between mirrored (j,k,0.5) doublet "
            "pairs may resolve to the mirrored order). fast: f32 pair search "
            "(Pallas-Triton kernel on a GPU; calls identical, LLKs "
            "approximate in the last printed digit). parity: bit-faithful "
            "host oracle "
            "replicating the reference's per-UMI scalar loop order — "
            "byte-exact outputs incl. tie direction (small inputs)"
        ),
    )
    g.add_argument("--cell-block", type=int, default=2048,
                   help="Cells per device batch")
    g.add_argument(
        "--slot-chunk", type=int, default=512, help="SNP-slot chunk per scan step"
    )
    g.add_argument(
        "--ingest",
        default="auto",
        choices=["auto", "native", "python"],
        help="Host pileup implementation (native C++ if built)",
    )
    g.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="Write a JAX profiler trace of the device passes to DIR",
    )
    g.add_argument(
        "--spool",
        default=None,
        metavar="DIR",
        help=(
            "Spool per-block results to DIR for checkpoint/resume: a rerun "
            "with the same inputs skips completed blocks"
        ),
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()

    import jax

    from demuxlet_jax.utils.jaxcfg import enable_compilation_cache

    from demuxlet_jax import backend

    enable_compilation_cache()
    backend.select_platform(args.device)
    if args.precision == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    if args.dist_coordinator:
        from demuxlet_jax.parallel import multihost as mh

        if args.num_shards < 2:
            error("--dist-coordinator requires --num-shards >= 2")
        pid, n_procs = mh.initialize(
            args.dist_coordinator, args.num_shards, args.shard_id
        )
        notice(
            "jax.distributed initialized: process %d of %d (%s)",
            pid, n_procs, args.dist_coordinator,
        )
    # the backend check initialises the device (and, for --device gpu,
    # fails fast without one); it must follow jax.distributed.initialize
    notice("Device: %s", backend.check_platform(args.device))

    grid_alpha = args.alpha if args.alpha else [0.0, 0.5]
    if not args.out:
        error("--out parameter is missing")
    for tag, name in ((args.tag_group, "group"), (args.tag_UMI, "UMI")):
        if tag and len(tag) != 2:
            error(
                "Cannot recognize %s tag %s. It is suppose to be a length 2 string",
                name,
                tag,
            )

    _echo_params(args, grid_alpha)

    group_set = None
    if args.group_list:
        group_set = set()
        with open(args.group_list) as fh:
            for line in fh:
                tok = line.split()
                if tok:
                    group_set.add(tok[0])
        notice(
            "Finished loading %d droplet/cell barcodes to consider", len(group_set)
        )

    from demuxlet_jax.io.vcf import (
        expand_chunk_pattern,
        load_snp_table,
        merge_snp_tables,
    )

    kw = dict(
        field_name=args.field,
        geno_error=args.geno_error,
        sm_ids=args.sm,
        sm_list_path=args.sm_list,
        min_mac=args.min_mac,
        min_callrate=args.min_callrate,
        verbose=args.vcf_verbose,
    )
    genome_regions = None
    if args.shard_by == "genome" and args.num_shards > 1:
        # compute this shard's regions BEFORE the VCF load so an indexed
        # .vcf.gz parses only ~1/N of the file (VcfReader.iter_regions)
        from demuxlet_jax.native.ingest import _bam_refs_len
        from demuxlet_jax.utils.intervals import split_genome_shards

        shards = split_genome_shards(_bam_refs_len(args.sam), args.num_shards)
        genome_regions = shards[args.shard_id]
        args._genome_regions = genome_regions
    if any(t in args.vcf for t in ("-_CHR_-", "-_BEG_-", "-_END_-")):
        from demuxlet_jax.native.ingest import _bam_refs_len

        if args.ref:
            from demuxlet_jax.utils.intervals import read_fai

            fai = args.ref if args.ref.endswith(".fai") else args.ref + ".fai"
            chrom_lengths = read_fai(fai)
        else:
            chrom_lengths = _bam_refs_len(args.sam)
        files = expand_chunk_pattern(
            args.vcf, chrom_lengths, unit=args.chunk_unit
        )
        if not files:
            error("No chunk files found for pattern %s", args.vcf)
        table = merge_snp_tables([load_snp_table(f, **kw) for f in files])
        if genome_regions is not None:
            from demuxlet_jax.io.vcf import filter_snp_table

            table = filter_snp_table(table, genome_regions)
    else:
        table = load_snp_table(args.vcf, regions=genome_regions, **kw)
    if table.nsnps == 0 and genome_regions is None:
        error("Cannot read any single variant from %s", args.vcf)

    if genome_regions is not None:
        if not args.dist_coordinator:
            notice(
                "WARNING: genome-sharded run without --dist-coordinator "
                "writes PARTIAL per-shard LLKs (this shard's SNPs only); "
                "contributions from all shards must be sum-merged"
            )
        notice(
            "Genome shard %d/%d: %d regions, %d SNPs",
            args.shard_id, args.num_shards, len(args._genome_regions),
            table.nsnps,
        )

    t_vcf_done = time.time()

    # Build the engine on a worker thread while the BAM scan runs: its
    # device-table uploads + (for mesh modes) sharded-step tracing ride
    # the still-initializing backend instead of stalling after ingest.
    eng_box: dict = {}

    def _build_engine():
        try:
            from demuxlet_jax.models.engine import DemuxEngine

            dtype = jnp.float64 if args.precision == "f64" else jnp.float32
            eng_box["eng"] = DemuxEngine(
                table.gps,
                grid_alpha,
                cap_bq=args.cap_BQ,
                cell_block=args.cell_block,
                slot_chunk=args.slot_chunk,
                dtype=dtype,
                mesh=_build_mesh(args),
                mode=args.mode,
            )
        except BaseException as e:  # re-raised on join
            eng_box["err"] = e

    eng_thread = None
    if args.mode != "parity":
        import threading

        eng_thread = threading.Thread(target=_build_engine, daemon=True)
        eng_thread.start()

    scl, ctr = _ingest(args, table, group_set)
    ctr.report(scl.nbcs, scl.nsnps)
    t_ingest_done = time.time()
    notice("Phase timing: VCF load %.2fs, pileup ingest %.2fs",
           t_vcf_done - t_start, t_ingest_done - t_vcf_done)

    from demuxlet_jax.models.engine import EngineResult, cell_stats
    from demuxlet_jax.models import outputs as out_mod

    notice("Starting to identify best matching individual IDs")
    if args.mode == "parity":
        return _run_parity(args, scl, table, grid_alpha, t_start)
    # bounded wait: a hung engine/backend initialisation would otherwise
    # block the join forever — fail loudly with the remedy instead
    import os as _os

    backend_timeout = float(
        _os.environ.get("DEMUX_BACKEND_TIMEOUT", "600"))
    eng_thread.join(timeout=backend_timeout)
    if eng_thread.is_alive():
        error(
            "engine/backend initialization did not complete within %.0fs "
            "— the '%s' JAX backend may be unreachable. Set "
            "DEMUX_BACKEND_TIMEOUT to wait longer, or rerun with "
            "--device cpu.", backend_timeout, args.device,
        )
    if "err" in eng_box:
        raise eng_box["err"]
    eng = eng_box["eng"]
    if args.profile:
        jax.profiler.start_trace(args.profile)
    t_eng = time.time()
    genome_sharded = args.shard_by == "genome" and args.num_shards > 1
    compact = None
    use_compact = (
        not args.write_pair and not args.spool and not genome_sharded
        and args.mode == "fast"
    )
    if use_compact:
        # device-side decision pass: ~16x less device->host traffic
        llks_c, llk0s_c, compact = eng.run_compact(scl, args.doublet_prior)
    else:
        res = eng.run(scl, spool_dir=args.spool)
    t_eng_done = time.time()
    if args.profile:
        jax.profiler.stop_trace()
        notice("Profiler trace written to %s", args.profile)
    if scl.nbcs:
        notice(
            "Device passes: %.2fs (%.0f barcodes/s, mode=%s%s)",
            t_eng_done - t_eng,
            scl.nbcs / max(t_eng_done - t_eng, 1e-9),
            args.mode,
            ", pair search=" + eng.pair_impl if args.mode == "fast" else "",
        )
    stats = cell_stats(scl)

    if jax.process_count() > 1:
        # Multi-host: all-gather this shard's rows (compact decision rows
        # by default; the full (V,V,A) tensor only for --write-pair), merge
        # + barcode-sort on process 0, which alone writes the outputs.
        from demuxlet_jax.models import decision as D
        from demuxlet_jax.parallel import multihost as mh

        if genome_sharded:
            # genome decomposition: every shard holds partial LLKs for all
            # its barcodes over ITS SNPs; contributions SUM by barcode
            local = mh.ShardResult(
                barcodes=stats.barcodes, totl=stats.totl, pass_=stats.pass_,
                uniq=stats.uniq, nsnp=stats.nsnp, llks=res.llks,
                llk0s=res.llk0s, llk_ab=res.llk_ab, llk_00=res.llk_00,
            )
            if args.write_pair or args.spool:
                # the .pair writer needs the full (V,V,A) tensor — keep
                # the full-tensor allgather for that case only
                merged = mh.gather_results_sum(local)
                if merged is None:
                    notice("Genome shard %d: results gathered to process 0",
                           args.shard_id)
                    return 0
                stats = out_mod.CellStats(
                    barcodes=merged.barcodes, totl=merged.totl,
                    pass_=merged.pass_, uniq=merged.uniq, nsnp=merged.nsnp,
                )
                res = EngineResult(
                    merged.llks, merged.llk0s, merged.llk_ab, merged.llk_00
                )
            else:
                # device reduce-scatter of the summed LLKs + on-device
                # decision per stripe; only compact rows reach process 0
                merged = mh.gather_results_sum_compact(
                    local, grid_alpha, args.doublet_prior
                )
                if merged is None:
                    notice("Genome shard %d: results gathered to process 0",
                           args.shard_id)
                    return 0
                stats = out_mod.CellStats(
                    barcodes=merged.barcodes, totl=merged.totl,
                    pass_=merged.pass_, uniq=merged.uniq, nsnp=merged.nsnp,
                )
                llks_c, llk0s_c, compact = (
                    merged.llks, merged.llk0s, merged.compact
                )
        elif args.write_pair or args.spool:
            local = mh.ShardResult(
                barcodes=stats.barcodes, totl=stats.totl, pass_=stats.pass_,
                uniq=stats.uniq, nsnp=stats.nsnp, llks=res.llks,
                llk0s=res.llk0s, llk_ab=res.llk_ab, llk_00=res.llk_00,
            )
            merged = mh.gather_results(local)
            if merged is None:
                notice("Shard %d: results gathered to process 0", args.shard_id)
                return 0
            stats = out_mod.CellStats(
                barcodes=merged.barcodes, totl=merged.totl,
                pass_=merged.pass_, uniq=merged.uniq, nsnp=merged.nsnp,
            )
            res = EngineResult(
                merged.llks, merged.llk0s, merged.llk_ab, merged.llk_00
            )
            compact = None
        else:
            if compact is not None:
                llks_l, llk0s_l, compact_l = llks_c, llk0s_c, compact
            else:
                llks_l, llk0s_l = res.llks, res.llk0s
                compact_l = D.compact_from_result(
                    res.llk_ab, res.llk_00, grid_alpha, args.doublet_prior
                )
            local = mh.CompactShard(
                barcodes=stats.barcodes, totl=stats.totl, pass_=stats.pass_,
                uniq=stats.uniq, nsnp=stats.nsnp, llks=llks_l,
                llk0s=llk0s_l, compact=compact_l,
            )
            merged = mh.gather_compact(local)
            if merged is None:
                notice("Shard %d: results gathered to process 0", args.shard_id)
                return 0
            stats = out_mod.CellStats(
                barcodes=merged.barcodes, totl=merged.totl,
                pass_=merged.pass_, uniq=merged.uniq, nsnp=merged.nsnp,
            )
            llks_c, llk0s_c, compact = merged.llks, merged.llk0s, merged.compact

    filt = dict(
        min_total=args.min_total, min_uniq=args.min_uniq, min_snp=args.min_snp
    )
    with _open_out(args.out, ".single") as fh:
        out_mod.write_single(
            fh, stats, table.sample_ids,
            llks_c if compact is not None else res.llks,
            llk0s_c if compact is not None else res.llk0s,
            **filt,
        )
    if compact is not None:
        with _open_out(args.out, ".sing2") as s2, _open_out(args.out, ".best") as sb:
            out_mod.write_pass2_compact(
                stats, table.sample_ids, compact, grid_alpha,
                args.doublet_prior, s2, sb, **filt,
            )
    else:
        wpair = _open_out(args.out, ".pair") if args.write_pair else None
        with _open_out(args.out, ".sing2") as s2, _open_out(args.out, ".best") as sb:
            out_mod.write_pass2(
                stats,
                table.sample_ids,
                res.llk_ab,
                res.llk_00,
                grid_alpha,
                args.doublet_prior,
                s2,
                sb,
                wpair,
                **filt,
            )
        if wpair is not None:
            wpair.close()
    notice("Finished writing output files")
    notice("Total wall-clock time: %.3fs", time.time() - t_start)
    return 0


def _build_mesh(args):
    """Construct the multi-device mesh per --mesh (None = single device).
    Adjusts --cell-block upward so blocks split evenly over the mesh."""
    import jax

    if args.mesh == "none":
        return None
    devs = jax.local_devices()
    if args.mesh == "auto":
        n_b, n_s = len(devs), 1
    else:
        try:
            n_b, n_s = (int(t) for t in args.mesh.lower().split("x"))
        except ValueError:
            error("Cannot parse --mesh %s (expected auto|none|BxS)", args.mesh)
    if n_b * n_s <= 1:
        return None
    if n_b * n_s > len(devs):
        error(
            "--mesh %dx%d needs %d local devices, have %d",
            n_b, n_s, n_b * n_s, len(devs),
        )
    if args.mode == "fast" and n_s != 1:
        error("--mesh BxS with S > 1 requires --mode exact (slot-axis psum)")
    if n_s & (n_s - 1):
        error("--mesh slot axis must be a power of two (got %d)", n_s)
    from demuxlet_jax.parallel import mesh as pmesh

    new_block = -(-args.cell_block // n_b) * n_b
    if new_block != args.cell_block:
        notice("Rounding --cell-block %d up to %d for the %dx%d mesh",
               args.cell_block, new_block, n_b, n_s)
        args.cell_block = new_block
    notice("Device mesh: %d (barcodes) x %d (slots) over %d local devices",
           n_b, n_s, n_b * n_s)
    return pmesh.make_mesh(n_b=n_b, n_s=n_s, devices=devs[: n_b * n_s])


def _run_parity(args, scl, table, grid_alpha, t_start):
    """Byte-exact host path: the NumPy oracle's reference-ordered scalar
    loops (oracle/numpy_oracle.py implements cmd_cram_demuxlet.cpp:415-875
    op-for-op, including per-UMI normalization order and ulp-tie behavior).
    Requires the dict pileup (python ingest)."""
    from oracle import numpy_oracle as O

    if not hasattr(scl, "umis"):
        error(
            "--mode parity requires the Python ingest (per-UMI order); "
            "rerun with --ingest python"
        )
    gp0s = O.compute_gp0s(scl)
    llks, llk0s = O.pass1_singlet(scl, gp0s)
    filt = dict(
        min_total=args.min_total, min_uniq=args.min_uniq, min_snp=args.min_snp
    )
    single = O.write_single(scl, llks, llk0s, **filt)
    sing2, pair, best = O.pass2_outputs(
        scl, gp0s, grid_alpha, doublet_prior=args.doublet_prior,
        write_pair=args.write_pair, **filt,
    )
    with _open_out(args.out, ".single") as fh:
        fh.write("\n".join(single) + "\n")
    with _open_out(args.out, ".sing2") as fh:
        fh.write("\n".join(sing2) + "\n")
    with _open_out(args.out, ".best") as fh:
        fh.write("\n".join(best) + "\n")
    if args.write_pair and pair is not None:
        with _open_out(args.out, ".pair") as fh:
            fh.write("\n".join(pair) + "\n")
    notice("Finished writing output files")
    notice("Total wall-clock time: %.3fs", time.time() - t_start)
    return 0


def _ingest(args, table, group_set):
    """Dispatch host pileup: native C++ ingest if available, else Python."""
    use_native = False
    if args.mode == "parity" and args.ingest == "auto":
        args.ingest = "python"  # parity needs the per-UMI dict pileup
    if args.ingest in ("auto", "native"):
        try:
            from demuxlet_jax.native import ingest as native_ingest

            use_native = native_ingest.available()
        except Exception:
            use_native = False
        if args.ingest == "native" and not use_native:
            error("--ingest native requested but the native library is not built")
    if use_native:
        from demuxlet_jax.native import ingest as native_ingest

        return native_ingest.build_pileup(
            args.sam,
            table,
            tag_group=args.tag_group,
            tag_umi=args.tag_UMI,
            cap_bq=args.cap_BQ,
            min_bq=args.min_BQ,
            min_td=args.min_TD,
            min_mq=args.min_MQ,
            excl_flag=args.excl_flag,
            group_set=group_set,
            n_shards=args.num_shards if args.shard_by == "barcode" else 1,
            shard_id=args.shard_id if args.shard_by == "barcode" else 0,
            sam_verbose=args.sam_verbose,
            regions=getattr(args, "_genome_regions", None),
        )
    from demuxlet_jax.host.pileup import build_pileup

    if args.sam.endswith(".cram"):
        from demuxlet_jax.io.cram import CramReader

        notice("CRAM input: using the Python CRAM 3.0 reader")
        rdr = CramReader(args.sam, min_mq=args.min_MQ, excl_flag=args.excl_flag)
    else:
        from demuxlet_jax.io.bam import AlignmentReader

        rdr = AlignmentReader(
            args.sam, min_mq=args.min_MQ, excl_flag=args.excl_flag
        )
    return build_pileup(
        rdr,
        table,
        tag_group=args.tag_group,
        tag_umi=args.tag_UMI,
        cap_bq=args.cap_BQ,
        min_bq=args.min_BQ,
        min_td=args.min_TD,
        group_set=group_set,
        n_shards=args.num_shards if args.shard_by == "barcode" else 1,
        shard_id=args.shard_id if args.shard_by == "barcode" else 0,
        sam_verbose=args.sam_verbose,
        regions=getattr(args, "_genome_regions", None),
    )


def _echo_params(args, grid_alpha) -> None:
    """Parameter echo in the spirit of paramList::Status (params.cpp:552-574)."""
    notice("Available Options")
    rows = [
        ("sam", args.sam),
        ("tag-group", args.tag_group),
        ("tag-UMI", args.tag_UMI),
        ("vcf", args.vcf),
        ("field", args.field),
        ("geno-error", args.geno_error),
        ("min-mac", args.min_mac),
        ("min-callrate", args.min_callrate),
        ("sm", ",".join(args.sm) if args.sm else ""),
        ("sm-list", args.sm_list or ""),
        ("out", args.out),
        ("alpha", ",".join(str(a) for a in grid_alpha)),
        ("write-pair", args.write_pair),
        ("doublet-prior", args.doublet_prior),
        ("cap-BQ", args.cap_BQ),
        ("min-BQ", args.min_BQ),
        ("min-MQ", args.min_MQ),
        ("min-TD", args.min_TD),
        ("excl-flag", args.excl_flag),
        ("group-list", args.group_list or ""),
        ("num-shards", args.num_shards),
        ("shard-id", args.shard_id),
        ("min-total", args.min_total),
        ("min-uniq", args.min_uniq),
        ("min-snp", args.min_snp),
    ]
    for k, v in rows:
        sys.stderr.write(f"   --{k} [{v}]\n")
    sys.stderr.flush()


if __name__ == "__main__":
    sys.exit(main())
