"""Demux engine: orchestrates device likelihood passes over barcode blocks.

The barcode axis is the data-parallel axis (reference scaling analog:
--group-list manual sharding, cmd_cram_demuxlet.cpp:68). Cells are processed
in fixed-size blocks; each block's covered-SNP slot count is bucketed to a
power of two so jit compiles a bounded set of shapes.

gp0 (mean genotype posterior per SNP) accumulates over samples in the
reference's order (cmd_cram_demuxlet.cpp:390-401) for bit-faithfulness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from demuxlet_jax.host.pileup import PileupData
from demuxlet_jax.host.slots import SlotBlock, build_slots
from demuxlet_jax.models import likelihood
from demuxlet_jax.models.outputs import CellStats
from demuxlet_jax.ops import luts


def compute_gp0(gps: np.ndarray) -> np.ndarray:
    """(nsnps, nv, 3) -> (nsnps, 3): sequential sum over samples, / nv."""
    nv = gps.shape[1]
    out = np.zeros((gps.shape[0], 3), dtype=np.float64)
    for j in range(nv):
        out += gps[:, j, :]
    out /= nv
    return out


def _prefetched(pool, fn, items, depth: int = 4):
    """Yield fn(item) in order with up to `depth` evaluations in flight on
    `pool` — overlaps host block prep (numpy, releases the GIL) with device
    compute; the serial prep was the end-to-end bottleneck at 100K cells."""
    from collections import deque

    futs = deque()
    it = iter(items)
    try:
        for _ in range(depth):
            futs.append(pool.submit(fn, next(it)))
    except StopIteration:
        pass
    while futs:
        out = futs.popleft().result()
        try:
            futs.append(pool.submit(fn, next(it)))
        except StopIteration:
            pass
        yield out


def _dev(x):
    """jnp.asarray over a leaf or a tuple of leaves (delta-encoded idx)."""
    if isinstance(x, (tuple, list)):
        return tuple(jnp.asarray(e) for e in x)
    return jnp.asarray(x)


def _to_wire(codes, idx_tuple):
    """Fuse (codes, delta-idx) into ONE (B, W) int32 wire buffer: one
    host->device transfer per block instead of five
    (pallas_pair.demux_block_fast_impl unpacks via bitcast). Returns
    (wire, (S, U, K) static meta)."""
    d8, base, fix_pos, fix_val = idx_tuple
    B, S, U = codes.shape
    K = fix_pos.shape[1]
    wire = np.concatenate(
        [
            codes.reshape(B, S * U).view(np.int32),
            d8.view(np.int32),
            base[:, None],
            fix_pos,
            fix_val,
        ],
        axis=1,
    )
    return wire, (S, U, K)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class EngineResult:
    llks: np.ndarray  # (ncells, nv)
    llk0s: np.ndarray  # (ncells,)
    llk_ab: np.ndarray  # (ncells, nv, nv, nA)
    llk_00: np.ndarray  # (ncells, nA)


class DemuxEngine:
    def __init__(
        self,
        gps: np.ndarray,  # (nsnps, nv, 3) float64
        grid_alpha: Sequence[float],
        cap_bq: int = 40,
        cell_block: int = 256,
        slot_chunk: int = 512,
        dtype=jnp.float64,
        mesh: Optional[jax.sharding.Mesh] = None,
        mode: str = "exact",
    ):
        """mode="exact": f64 XLA contraction (byte-parity path); an
        optional ("b","s") mesh shards blocks across devices
        (parallel/mesh.py). mode="fast": f32 block step whose pair search
        is the platform's implementation (backend.fast_pair_impl: the
        Pallas-Triton kernel on a GPU, the plain XLA contraction
        elsewhere); demux calls identical, LLKs within 1e-4 relative;
        with a mesh the barcode axis shards over its "b" dimension
        (build_sharded_fast_step / build_sharded_compact_step). Multi-host
        scale-out additionally stripes barcodes across processes
        (parallel/multihost.py)."""
        from demuxlet_jax.backend import fast_pair_impl

        self.gps = np.ascontiguousarray(gps, dtype=np.float64)
        if self.gps.shape[0] == 0:
            # zero SNPs (e.g. a genome shard whose region holds no markers):
            # pad one neutral row so LUT gathers stay well-formed; every
            # slot is masked, so the row's value never reaches an output.
            self.gps = np.full((1, gps.shape[1], 3), 1.0 / 3)
        self.gp0 = compute_gp0(self.gps)
        self.grid_alpha = list(grid_alpha)
        self.cap_bq = cap_bq
        self.cell_block = cell_block
        self.slot_chunk = slot_chunk
        self.dtype = jnp.float32 if mode == "fast" else dtype
        self.mesh = mesh
        self.mode = mode
        self.logf = luts.singlet_lut(cap_bq)
        self.w = luts.pair_lut(self.grid_alpha, cap_bq)
        self.nv = gps.shape[1]
        self.n_alpha = len(self.grid_alpha)
        self._gps_dev = jnp.asarray(self.gps, dtype=self.dtype)
        self._gp0_dev = jnp.asarray(self.gp0, dtype=self.dtype)
        self._logf_dev = jnp.asarray(self.logf, dtype=self.dtype)
        self._w_dev = jnp.asarray(self.w, dtype=self.dtype)
        self._fast_luts = None
        self._sharded_step = None
        self._sharded_fast = None
        self._sharded_compact = None  # (doublet_prior, fn) cache
        self.pair_impl = fast_pair_impl()
        self.pair_chunk = likelihood.auto_pair_chunk(
            cell_block, slot_chunk, self.nv, self.n_alpha)
        # wire v2 (host/wire.py): per-run packed H2D format — dict codes
        # + capped UMI lanes + narrow deltas. Chosen once per pileup
        # (static per run -> one compiled variant per shape bucket).
        self._wire_cfg = None
        self._fast_luts_v2 = None
        # wire-v2 meta registry: same-(S, U) blocks share one compiled
        # (U0, K2p, Kp) variant; a block that outgrows it bumps the
        # entry (ONE new compile) instead of every block minting its
        # own meta and its own compile.
        import threading

        self._wire_reg = {}
        self._wire_reg_lock = threading.Lock()
        if self.cap_bq > 126 and mode == "fast":
            # u8 observation codes top out at 2*(cap_bq+1)-1 <= 253 (254/
            # 255 are reserved markers): beyond cap-BQ 126 the codes path
            # can't represent observations. Exact mode's dense slots can.
            from demuxlet_jax.utils.logging_utils import DemuxError

            raise DemuxError(
                "--cap-BQ > 126 is not representable by the fast-mode "
                "u8 observation codes; use --mode exact"
            )
        if mesh is not None and mode == "exact":
            from demuxlet_jax.parallel import mesh as pmesh

            self._sharded_step = pmesh.build_sharded_step(
                mesh, self.n_alpha, slot_chunk=self.slot_chunk,
                dtype=self.dtype, pair_chunk=self.pair_chunk,
            )

    # ---- per-block device dispatch ----

    def _run_block(self, blk: SlotBlock):
        idx = jnp.asarray(blk.idx)
        # gather the gps table as one 2D take
        ns, nv = self._gps_dev.shape[:2]
        gps_g = jnp.take(
            self._gps_dev.reshape(ns, nv * 3), idx, axis=0
        ).reshape(idx.shape + (nv, 3))  # (B,S,V,3)
        gp0_g = jnp.take(self._gp0_dev, idx, axis=0)  # (B,S,3)
        cnt = jnp.asarray(blk.cnt)
        msk = jnp.asarray(blk.msk)
        if self._sharded_step is not None:
            from demuxlet_jax.parallel import mesh as pmesh

            cnt, msk, gps_g, gp0_g = pmesh.shard_block(
                self.mesh, cnt, msk, gps_g, gp0_g
            )
            logf, w = pmesh.replicate(self.mesh, self._logf_dev, self._w_dev)
            return self._sharded_step(cnt, msk, gps_g, gp0_g, logf, w)
        llk, llk0 = likelihood.singlet_llks(
            cnt, msk, gps_g, gp0_g, self._logf_dev, dtype=self.dtype
        )
        llk_ab, llk_00 = likelihood.pair_llks(
            cnt,
            msk,
            gps_g,
            gp0_g,
            self._w_dev,
            self.n_alpha,
            slot_chunk=self.slot_chunk,
            dtype=self.dtype,
            pair_chunk=self.pair_chunk,
        )
        return llk, llk0, llk_ab, llk_00

    def _sym_a(self):
        """Index of alpha == 0.5 in the grid (the (j,k)-symmetric doublet
        plane the kernels mirror instead of recomputing), if present."""
        return (self.grid_alpha.index(0.5)
                if 0.5 in self.grid_alpha else None)

    def _wire_cfg_for(self, scl):
        """The run's wire-v2 config, or None when the packed wire does
        not apply (mesh paths keep explicit codes; cap-BQ > 126 breaks
        the u8 code bytes; dict-based pileups lack the CSR arrays).
        Cached per pileup; recomputing invalidates the dict LUT caches.
        DEMUX_WIRE=v1 forces the v1 format (A/B runs)."""
        import os

        if (
            self.mesh is not None
            or self.cap_bq > 126
            or not hasattr(scl, "cell_ptr")
            or os.environ.get("DEMUX_WIRE", "v2") == "v1"
        ):
            return None
        # u16 fix/tail positions bound the slot axis: if ANY block could
        # pad past 65535 slots, disable v2 for the whole RUN (uniform
        # wire form — mixed per-block v1/v2 fallbacks would need
        # per-block LUT swaps and pay the Python dense builder on
        # exactly the hugest blocks; review r5-2 #1/#3)
        if hasattr(scl, "n_snps_all"):
            smax = int(np.max(scl.n_snps_all(), initial=0))
            # conservative pow2 bucket: coverage-sorted blocking pads
            # slot axes to powers of two
            if _bucket(max(smax, 1), minimum=128) > 0xFFFF:
                return None
        # the cfg cache rides ON the pileup (an id(scl)-keyed engine
        # cache could serve a stale dictionary to a DIFFERENT pileup
        # allocated at a reused address — review r5 #3; a stale dict
        # silently drops observations on the native path)
        cache = getattr(scl, "_wire_cfg_cache", None)
        if cache is not None and cache[0] == self.cap_bq:
            cfg = cache[1]
        else:
            from demuxlet_jax.host.wire import choose_cfg

            cfg = choose_cfg(scl, self.cap_bq)
            try:
                scl._wire_cfg_cache = (self.cap_bq, cfg)
            except AttributeError:
                pass
        if cfg != self._wire_cfg:
            self._wire_cfg = cfg
            self._fast_luts_v2 = None
            self._wire_reg = {}
        return self._wire_cfg

    def _prep_codes_blk(self, scl, cells, pad=None):
        """Host block prep for the wire path: native C single pass
        (native/prep.py — build + shrink fused) with
        the Python build_codes_block + _shrink_codes_blk fallback, then
        (default) the v2 repack: dict codes at 4/6/8 bits, dense UMI
        lanes capped with a sparse deep tail, narrow deltas
        (host/wire.py). Mesh / cap-BQ > 126 paths keep the explicit
        (codes, idx, msk)."""
        from demuxlet_jax.host.csr import build_codes_block

        kw = {} if pad is None else {"pad_slots_to": pad}
        cfg = self._wire_cfg_for(scl)
        if (
            self.mesh is None
            and self.cap_bq <= 126
            and hasattr(scl, "cell_ptr")
        ):
            from demuxlet_jax.native import prep as nprep

            if cfg is not None and nprep.available():
                out = self._pack_reg(lambda ff: nprep.pack_block_v2(
                    scl, cells, cfg, cap_bq=self.cap_bq,
                    pad_cells_to=self.cell_block, floors_for=ff, **kw,
                ))
                if out is not None:
                    buf, meta = out
                    return buf, meta, None
            elif cfg is None:
                blk = nprep.prep_block_shrunk(
                    scl, cells, cap_bq=self.cap_bq,
                    pad_cells_to=self.cell_block, **kw,
                ) if nprep.available() else None
                if blk is not None:
                    return blk
        codes_blk = build_codes_block(
            scl, cells, cap_bq=self.cap_bq,
            pad_cells_to=self.cell_block, **kw,
        )
        if cfg is not None:
            from demuxlet_jax.host import wire as W

            key = (codes_blk[0].shape[1], codes_blk[0].shape[2])
            out = self._pack_reg(
                lambda ff: W.pack_wire_block(*codes_blk, cfg,
                                             floors=ff(key)))
            if out is not None:
                buf, meta = out
                return buf, meta, None
            # v2 declined (slot extent beyond u16 addressing): v1 wire
        return self._shrink_codes_blk(codes_blk)

    def _pack_reg(self, pack_fn):
        """Pack through the shape registry: pack_fn receives a
        floors-lookup callable (key=(S, U) -> harmonized (U0, K2p, Kp)
        or None); afterwards the produced meta raises its key's maxima.
        Prefetch threads race benignly — a stale floor only costs one
        extra compiled variant, never correctness."""

        def floors_for(key):
            with self._wire_reg_lock:
                return self._wire_reg.get(key)

        out = pack_fn(floors_for)
        if out is None:
            return None
        buf, meta = out
        key = (meta[1], meta[2])
        u0, k2p, kp = meta[3], meta[4], meta[5]
        with self._wire_reg_lock:
            cur = self._wire_reg.get(key)
            if cur is None:
                self._wire_reg[key] = (u0, k2p, kp)
            else:
                self._wire_reg[key] = (
                    cur[0], max(cur[1], k2p), max(cur[2], kp))
        return buf, meta

    def _shrink_codes_blk(self, codes_blk):
        """Cut fast-path H2D bytes: when slot ids fit in 16 bits, adjacent
        pairs pack into one int32 lane (unpacked on device — only u8/i32
        are shipped), and msk is dropped — the
        device derives it from codes != 255 (see demux_block_fast_impl).
        Valid slots whose observations were all allele==2 have no codes but
        must stay masked-in (uniform-GL term, cmd_cram_demuxlet.cpp:435
        semantics), so they get the reserved marker 254 in lane 0; real
        codes top out at 2*(cap_bq+1)-1 <= 253 (shrink skipped otherwise).

        Slot ids ship as u8 DELTAS when they can (ids are per-cell sorted;
        idx = base + cumsum(d), with the rare deltas > 255 restored from a
        sparse fix list whose width buckets to a power of two) — 1B/slot;
        else as 16-bit pairs packed into i32 lanes — 2B/slot.
        Mesh shard_map steps
        keep the explicit (codes, idx, msk) signature."""
        if self.mesh is not None or self.cap_bq > 126:
            return codes_blk
        codes, idx, msk = codes_blk
        empty = msk & (codes == 255).all(axis=-1)
        if empty.any():
            b, s = np.nonzero(empty)
            codes[b, s, 0] = 254
        S = idx.shape[1]
        d = np.zeros_like(idx, dtype=np.int64)
        d[:, 1:] = np.diff(idx.astype(np.int64), axis=1)
        d[~msk] = 0
        d[:, 1:][~msk[:, 1:]] = 0
        over = d > 255
        n_over = over.sum(axis=1)
        K = int(n_over.max())
        if (d >= 0).all() and K <= S // 8:
            Kp = 8
            while Kp < K:
                Kp *= 2
            fix_pos = np.zeros((idx.shape[0], Kp), dtype=np.int32)
            fix_val = np.zeros((idx.shape[0], Kp), dtype=np.int32)
            if K:
                rows, cols = np.nonzero(over)
                slot = np.concatenate(
                    [np.arange(n) for n in n_over]
                ).astype(np.int64) if K else np.zeros(0, np.int64)
                fix_pos[rows, slot] = cols.astype(np.int32)
                fix_val[rows, slot] = (d[rows, cols] - 255).astype(np.int32)
            d8 = np.minimum(d, 255).astype(np.uint8)
            base = idx[:, 0].astype(np.int32)
            return codes, (d8, base, fix_pos, fix_val), None
        if self.gps.shape[0] <= 0xFFFF and S % 2 == 0:
            u = idx.astype(np.uint32)
            idx = (u[:, 0::2] | (u[:, 1::2] << 16)).view(np.int32)
        return codes, idx, None

    def _fast_tables(self, cfg=None):
        """Deduped fast-path LUTs: the A*9 mixture columns collapse to the
        unique p-value columns (pallas_pair.dedup_channels) — the pair
        search expands via the static map, narrowing the front's matmul
        and normalisation. With a wire-v2 cfg, the LUT rows additionally shrink to
        the run's code dictionary (sorted, so the f32 einsum reduction
        order over rows is a subsequence of the full-table order) — the
        one-hot front narrows from 2*(cap_bq+1)+1 rows to n_dict+1.
        Returns (w_ext, logf_ext, expand)."""
        from demuxlet_jax.ops.pallas_pair import dedup_channels, extend_luts

        if cfg is not None:
            if self._fast_luts_v2 is None:
                cols, expand = dedup_channels(self.grid_alpha)
                rows = list(cfg.dict_codes)
                w_ext, logf_ext = extend_luts(
                    self.w[rows][:, list(cols)], self.logf[rows]
                )
                self._fast_luts_v2 = (
                    jnp.asarray(w_ext), jnp.asarray(logf_ext), expand
                )
            return self._fast_luts_v2
        if self._fast_luts is None:
            cols, expand = dedup_channels(self.grid_alpha)
            w_ext, logf_ext = extend_luts(self.w[:, list(cols)], self.logf)
            self._fast_luts = (
                jnp.asarray(w_ext), jnp.asarray(logf_ext), expand
            )
        return self._fast_luts

    def _dispatch_fast(self, codes_blk):
        from demuxlet_jax.ops.pallas_pair import demux_block_fast

        codes, idx, msk = codes_blk
        wire = None
        if msk is None and isinstance(idx, tuple) and isinstance(idx[0], str):
            wire, idx = idx, None  # v2 packed wire: codes IS the buffer
        w_ext, logf_ext, expand = self._fast_tables(
            self._wire_cfg if wire is not None else None
        )
        if msk is None and isinstance(idx, tuple):
            codes, wire = _to_wire(codes, idx)
            idx = None
        if self.mesh is not None:
            if self._sharded_fast is None:
                from demuxlet_jax.parallel import mesh as pmesh

                self._sharded_fast = pmesh.build_sharded_fast_step(
                    self.mesh, self.n_alpha, self.nv,
                    pair_impl=self.pair_impl,
                    a0_sep=self.grid_alpha[0] == 0.0, sym_a=self._sym_a(),
                    expand=expand,
                )
            return self._sharded_fast(
                jnp.asarray(codes), jnp.asarray(idx), jnp.asarray(msk),
                self._gps_dev, self._gp0_dev, w_ext, logf_ext,
            )
        return demux_block_fast(
            jnp.asarray(codes),
            None if idx is None else _dev(idx),
            None if msk is None else jnp.asarray(msk),
            self._gps_dev,
            self._gp0_dev,
            w_ext,
            logf_ext,
            self.n_alpha,
            self.nv,
            pair_impl=self.pair_impl,
            a0_sep=self.grid_alpha[0] == 0.0,
            sym_a=self._sym_a(),
            expand=expand,
            wire=wire,
        )

    def _blocks(self, n: int, scl=None):
        """Cell-id blocks, COVERAGE-SORTED (ascending distinct-SNP count)
        when it pays: each block buckets its slot axis to the block MAX
        covered-SNP count, so grouping similar-coverage cells shrinks
        padded slots — less wire volume and kernel work on the skewed
        coverage distributions of real droplet data.

        Returns (blocks, pads): pads is None for natural order, else a
        per-block POWER-OF-TWO slot pad (>= 128) for prep to request.
        Pow2 (not 128-multiple) buckets bound the number of distinct
        compiled shapes a sorted run creates to ~log2(Smax/128) — each
        new shape is a new compile, which would otherwise eat the padding
        savings. The heuristic compares the REAL costs:
        natural order pads to 128-multiples (build_codes_block default,
        few shapes since block maxes cluster near the global max) vs
        sorted order at pow2 buckets; sort engages on a >10% saving.
        Sorting also breaks build_codes_block's contiguous-slice fast
        path (per-block obs become a gather), another reason uniform
        workloads must stay natural. Outputs are order-safe either way:
        llks/llk_ab write by cell id and compact rows are inverse-
        permuted after the run. The sort is deterministic (stable), so
        block compositions reproduce across runs (spool files also
        self-validate their stored cell ids)."""
        ids = np.arange(n, dtype=np.int64)
        if n and scl is not None and hasattr(scl, "n_snps_all"):
            counts = np.asarray(scl.n_snps_all())
            # secondary key: total observations (UMI depth) within each
            # coverage level — clusters PCR-deep cells into the same
            # blocks so the wire-v2 tail padding (block-MAX entry count)
            # tracks its block's depth, not the whole run's (round 5)
            depth = (np.diff(np.asarray(scl.cell_ptr))
                     if hasattr(scl, "cell_ptr") else np.zeros_like(counts))
            order = ids[np.lexsort((depth, counts))]

            def block_maxes(perm):
                c = counts[perm]
                pad = (-len(c)) % self.cell_block
                if pad:
                    c = np.concatenate([c, np.zeros(pad, c.dtype)])
                return c.reshape(-1, self.cell_block).max(axis=1)

            cost_nat = int(
                np.maximum(-(-block_maxes(ids) // 128) * 128, 128).sum()
            )
            pow2 = [_bucket(max(int(m), 1), minimum=128)
                    for m in block_maxes(order)]
            if sum(pow2) < 0.9 * cost_nat:
                return [
                    order[s : s + self.cell_block].tolist()
                    for s in range(0, n, self.cell_block)
                ], pow2
        return [
            ids[s : s + self.cell_block].tolist()
            for s in range(0, n, self.cell_block)
        ], None

    def run_compact(self, scl, doublet_prior: float, pipeline_depth: int = 1):
        """Fast-mode pipeline with the device-side decision pass (kernel 3):
        returns (llks, llk0s, decision.CompactResult). ~16x less
        device->host traffic than run(); requires mode == 'fast'.

        pipeline_depth = outstanding D2H readbacks on mesh runs."""
        from concurrent.futures import ThreadPoolExecutor

        from demuxlet_jax.host.csr import CsrPileup, build_codes_block
        from demuxlet_jax.models import decision as D

        assert self.mode == "fast", "run_compact needs mode='fast'"
        if not hasattr(scl, "cell_ptr"):
            scl = CsrPileup.from_pileup(scl)
        cfg = self._wire_cfg_for(scl)  # None on mesh / forced-v1 paths
        w_ext, logf_ext, expand = self._fast_tables(cfg)
        dbl_w = jnp.asarray(
            D.doublet_weights(self.nv, self.grid_alpha, doublet_prior)
        )
        dbl_msk = jnp.asarray(D.doublet_mask(self.nv, self.n_alpha))

        n = scl.nbcs
        llks = np.zeros((n, self.nv), dtype=np.float64)
        llk0s = np.zeros(n, dtype=np.float64)
        parts = []
        # per-run transport accounting (read by benchmarks/e2e_demux.py
        # for the H2D-ceiling artifact): bytes shipped per block, tables
        # excluded (they ship once and are cached on device)
        import threading
        import time as _time

        self.h2d_bytes = 0  # main-thread dispatch only
        self.d2h_bytes = 0  # fetch pool: guard the read-modify-write
        # phase attribution (seconds, summed across threads where noted):
        # prep = host packing on the prefetch pool (overlaps device);
        # prep_wait = main-thread stall waiting on prep results;
        # dispatch = main-thread H2D + device enqueue; fetch = D2H.
        self.phase_s = {"prep": 0.0, "prep_wait": 0.0, "dispatch": 0.0,
                        "fetch": 0.0}
        d2h_lock = threading.Lock()

        def fetch(cells, packed):
            t0 = _time.monotonic()
            m = len(cells)
            a, b, c = D.unpack_block(
                np.asarray(packed)[:m], self.nv, self.n_alpha
            )
            with d2h_lock:
                self.d2h_bytes += np.asarray(packed).nbytes
                self.phase_s["fetch"] += _time.monotonic() - t0
            llks[cells] = a
            llk0s[cells] = b
            return c

        blocks, pads = self._blocks(n, scl)
        jobs = list(zip(blocks, pads or [None] * len(blocks)))

        def prep(job):
            cells, pad = job
            t0 = _time.monotonic()
            out = cells, self._prep_codes_blk(scl, cells, pad)
            with d2h_lock:
                self.phase_s["prep"] += _time.monotonic() - t0
            return out

        def sharded_step():
            """Build (and cache per doublet_prior) the mesh compact step."""
            if (
                self._sharded_compact is None
                or self._sharded_compact[0] != doublet_prior
            ):
                from demuxlet_jax.parallel import mesh as pmesh

                step = pmesh.build_sharded_compact_step(
                    self.mesh, self.n_alpha, self.nv, doublet_prior,
                    pair_impl=self.pair_impl,
                    a0_sep=self.grid_alpha[0] == 0.0,
                    sym_a=self._sym_a(), expand=expand,
                )
                self._sharded_compact = (doublet_prior, step)
            return self._sharded_compact[1]

        def dispatch(codes, idx, msk):
            if self.mesh is not None:
                self.h2d_bytes += codes.nbytes + sum(
                    e.nbytes
                    for buf in (idx, msk)
                    if buf is not None
                    for e in (buf if isinstance(buf, tuple) else (buf,))
                )
                args = (jnp.asarray(codes), jnp.asarray(idx),
                        jnp.asarray(msk))
                return sharded_step()(
                    *args, self._gps_dev, self._gp0_dev,
                    w_ext, logf_ext, dbl_w, dbl_msk,
                )
            wire = None
            if msk is None and isinstance(idx, tuple) and isinstance(idx[0], str):
                wire, idx = idx, None  # v2 packed wire
            elif msk is None and isinstance(idx, tuple):
                codes, wire = _to_wire(codes, idx)  # codes IS the buffer now
                idx = None
            # invariant: with a v2 cfg active, this run's LUTs are the
            # dict-narrowed tables — a v1-form block here would be
            # scored against the wrong rows (silent corruption, review
            # r5-2 #1). The run-level slot-extent gate in _wire_cfg_for
            # makes mixing unreachable; fail loudly if it ever isn't.
            assert cfg is None or (wire is not None and wire[0] == "w2"), (
                "v1-form block in a wire-v2 run"
            )
            self.h2d_bytes += codes.nbytes + sum(
                e.nbytes
                for buf in (idx, msk)
                if buf is not None
                for e in (buf if isinstance(buf, tuple) else (buf,))
            )
            args = (
                jnp.asarray(codes),
                None if idx is None else _dev(idx),
                None if msk is None else jnp.asarray(msk),
            )
            return D.demux_block_fast_compact(
                *args, self._gps_dev, self._gp0_dev,
                w_ext, logf_ext, dbl_w, dbl_msk, self.n_alpha,
                self.nv, doublet_prior, pair_impl=self.pair_impl,
                a0_sep=self.grid_alpha[0] == 0.0,
                sym_a=self._sym_a(), expand=expand, wire=wire,
            )

        # Single-device: DEFER all device->host readback to ONE fetch at
        # the end (the decision rows are small): one device-side concat +
        # a single transfer. Mesh mode keeps the per-block worker-thread
        # readback (concat over a sharded global array would re-layout
        # across devices).
        if self.mesh is None:
            dev_parts = []
            with ThreadPoolExecutor(max_workers=4) as prep_pool:
                it = _prefetched(prep_pool, prep, jobs)
                while True:
                    t0 = _time.monotonic()
                    try:
                        cells, (codes, idx, msk) = next(it)
                    except StopIteration:
                        break
                    self.phase_s["prep_wait"] += _time.monotonic() - t0
                    t0 = _time.monotonic()
                    dev_parts.append((cells, dispatch(codes, idx, msk)))
                    self.phase_s["dispatch"] += _time.monotonic() - t0
            if dev_parts:
                t0 = _time.monotonic()
                host = np.asarray(jnp.concatenate(
                    [p for _, p in dev_parts], axis=0
                ))
                self.phase_s["fetch"] += _time.monotonic() - t0
                off = 0
                for cells, p in dev_parts:
                    b = p.shape[0]
                    parts.append(fetch(cells, host[off : off + b]))
                    off += b
            comp = D.concat(parts)
            perm = np.concatenate(
                [np.asarray(b, np.int64) for b in blocks]
            )
            if not np.array_equal(perm, np.arange(n)):
                inv = np.empty(n, np.int64)
                inv[perm] = np.arange(n)
                comp = D.take(comp, inv)
            return llks, llk0s, comp

        pending = []
        with ThreadPoolExecutor(max_workers=2) as pool, ThreadPoolExecutor(
            max_workers=4
        ) as prep_pool:
            for cells, (codes, idx, msk) in _prefetched(
                prep_pool, prep, jobs
            ):
                packed = dispatch(codes, idx, msk)
                pending.append(pool.submit(fetch, cells, packed))
                while len(pending) > pipeline_depth:
                    parts.append(pending.pop(0).result())
            for f in pending:
                parts.append(f.result())
        comp = D.concat(parts)
        perm = np.concatenate([np.asarray(b, np.int64) for b in blocks])
        if not np.array_equal(perm, np.arange(n)):
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n)
            comp = D.take(comp, inv)
        return llks, llk0s, comp

    def run(
        self,
        scl: PileupData,
        pipeline_depth: int = 1,
        spool_dir: Optional[str] = None,
    ) -> EngineResult:
        """Run all barcode blocks; device dispatch is pipelined — the next
        block's host prep and dispatch overlap the previous blocks' device
        compute, and device->host readback happens on worker threads.

        spool_dir: per-block result spooling for checkpoint/resume (the
        reference has no resume story; its analog is manual --group-list
        splits). Completed blocks are .npz files keyed by block extent;
        a rerun loads them instead of recomputing."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        if spool_dir:
            os.makedirs(spool_dir, exist_ok=True)

        if self.mode == "fast" and not hasattr(scl, "cell_ptr"):
            from demuxlet_jax.host.csr import CsrPileup

            scl = CsrPileup.from_pileup(scl)
        if self.mode == "fast":
            # pre-warm the wire cfg on the main thread: otherwise the 4
            # prefetch workers each race through choose_cfg's full-data
            # pass before the first block dispatches (review r5 #4)
            self._wire_cfg_for(scl)
        n = scl.nbcs
        nv = self.nv
        na = self.n_alpha
        llks = np.zeros((n, nv), dtype=np.float64)
        llk0s = np.zeros(n, dtype=np.float64)
        llk_ab = np.zeros((n, nv, nv, na), dtype=np.float64)
        llk_00 = np.zeros((n, na), dtype=np.float64)

        def fetch(out):
            return tuple(np.asarray(x) for x in out)

        def store(cells, arrs):
            m = len(cells)
            a, b, c, d = arrs
            llks[cells] = a[:m]
            llk0s[cells] = b[:m]
            llk_ab[cells] = c[:m]
            llk_00[cells] = d[:m]

        def spool_path(cells):
            return os.path.join(
                spool_dir, "block_%08d_%d.npz" % (cells[0], len(cells))
            )

        def fetch_and_spool(cells, out):
            arrs = fetch(out)
            if spool_dir:
                tmp = spool_path(cells) + ".tmp.npz"
                # cells recorded for load-time validation: the (first-id,
                # length) filename no longer determines membership now that
                # coverage-sorted blocking can permute block composition
                np.savez(tmp, a=arrs[0], b=arrs[1], c=arrs[2], d=arrs[3],
                         cells=np.asarray(cells, np.int64))
                os.replace(tmp, spool_path(cells))
            return arrs

        # Dispatch (host prep + async H2D + device enqueue) stays on the
        # main thread; D2H readback runs on worker threads so the next
        # block's prep overlaps the previous blocks' compute + transfers.
        blocks, pads = self._blocks(n, scl)
        jobs = list(zip(blocks, pads or [None] * len(blocks)))

        def prep(job):
            """Host-side block prep (spool probe / codes / dense slots);
            runs on the prefetch pool, overlapping device compute."""
            cells, pad = job
            if spool_dir and os.path.exists(spool_path(cells)):
                z = np.load(spool_path(cells))
                # block files from a different blocking (older version,
                # different sort decision) must recompute, not misattribute
                if "cells" in z.files and np.array_equal(
                    z["cells"], np.asarray(cells, np.int64)
                ):
                    return cells, (
                        "spooled", (z["a"], z["b"], z["c"], z["d"])
                    )
            if self.mode == "fast":
                return cells, ("codes", self._prep_codes_blk(
                    scl, cells, pad
                ))
            blk = build_slots(scl, cells, cap_bq=self.cap_bq)
            blk = _pad_block(blk, self.cell_block, _bucket(blk.idx.shape[1]))
            return cells, ("slots", blk)

        pending = []
        with ThreadPoolExecutor(max_workers=2) as pool, ThreadPoolExecutor(
            max_workers=4
        ) as prep_pool:
            for cells, (kind, data) in _prefetched(prep_pool, prep, jobs):
                if kind == "spooled":
                    store(cells, data)
                    continue
                if self.mode == "fast":
                    out = self._dispatch_fast(data)
                else:
                    out = self._run_block(data)
                pending.append(
                    (cells, pool.submit(fetch_and_spool, cells, out))
                )
                while len(pending) > pipeline_depth:
                    c0, f0 = pending.pop(0)
                    store(c0, f0.result())
            for c0, f0 in pending:
                store(c0, f0.result())
        return EngineResult(llks, llk0s, llk_ab, llk_00)


def _pad_block(blk: SlotBlock, n_cells: int, n_slots: int) -> SlotBlock:
    B, S = blk.idx.shape
    if B == n_cells and S == n_slots:
        return blk
    pb, ps = n_cells - B, n_slots - S
    return SlotBlock(
        cell_ids=blk.cell_ids,
        idx=np.pad(blk.idx, ((0, pb), (0, ps))),
        msk=np.pad(blk.msk, ((0, pb), (0, ps))),
        cnt=np.pad(blk.cnt, ((0, pb), (0, ps), (0, 0))),
    )


def cell_stats(scl: PileupData) -> CellStats:
    if hasattr(scl, "n_snps_all"):  # CSR form: vectorized distinct counts
        nsnp = scl.n_snps_all()
    else:
        nsnp = np.asarray(
            [scl.n_cell_snps(c) for c in range(scl.nbcs)], np.int64
        )
    return CellStats(
        barcodes=list(scl.barcodes),
        totl=np.asarray(scl.cell_totl, dtype=np.int64),
        pass_=np.asarray(scl.cell_pass, dtype=np.int64),
        uniq=np.asarray(scl.cell_uniq, dtype=np.int64),
        nsnp=nsnp,
    )
