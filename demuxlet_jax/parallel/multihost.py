"""Multi-host execution: distributed init, barcode sharding, result merge.

The reference scales across machines only by manual `--group-list` splits
(cmd_cram_demuxlet.cpp:68). Here the same decomposition is first-class:

  1. every process calls `initialize()` (jax.distributed) and learns its
     (process_id, n_processes);
  2. each process ingests + demuxes only the barcodes in its stripe
     (`owns_barcode`) — results are pure functions of a barcode's reads, so
     shards are embarrassingly parallel;
  3. per-barcode result rows merge to process 0 with `gather_results`
     (all-gather via multihost_utils), which re-sorts by
     barcode to reproduce the reference's std::map output order
     (cmd_cram_demuxlet.cpp:472,576).

The merge path is pure (arrays in, arrays out) and is unit-tested
single-process by splitting a workload into stripes and comparing against
the unsharded run (tests/test_multihost.py).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


def local_gpu_count() -> int:
    """GPUs this process may open, counted without initialising a
    backend: CUDA_VISIBLE_DEVICES when set, else the /dev/nvidiaN nodes."""
    import os
    import re

    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    try:
        return sum(bool(re.fullmatch(r"nvidia\d+", f))
                   for f in os.listdir("/dev"))
    except OSError:
        return 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> tuple[int, int]:
    """jax.distributed.initialize (no-op fallback single-process).

    One process per GPU: unless local_device_ids says otherwise, process
    k opens only local GPU k mod (local GPU count) — a JAX process
    reserves most of each card it opens, so processes sharing a host must
    not all open every card. Hosts without GPUs pass no restriction.

    Returns (process_id, n_processes)."""
    import jax

    if num_processes is not None and num_processes > 1:
        if local_device_ids is None:
            n_gpu = local_gpu_count()
            if n_gpu:
                local_device_ids = [(process_id or 0) % n_gpu]
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def owns_barcode(barcode: str, shard_id: int, n_shards: int) -> bool:
    """Deterministic barcode -> shard assignment (stable across runs/hosts)."""
    if n_shards <= 1:
        return True
    h = zlib.crc32(barcode.encode()) & 0xFFFFFFFF
    return h % n_shards == shard_id


def shard_filter(shard_id: int, n_shards: int):
    """A group-set-style predicate for the ingest layer."""
    return lambda bc: owns_barcode(bc, shard_id, n_shards)


@dataclass
class ShardResult:
    """One shard's per-barcode outputs, ready to merge."""

    barcodes: List[str]
    totl: np.ndarray
    pass_: np.ndarray
    uniq: np.ndarray
    nsnp: np.ndarray
    llks: np.ndarray  # (n, nv)
    llk0s: np.ndarray  # (n,)
    llk_ab: np.ndarray  # (n, nv, nv, na)
    llk_00: np.ndarray  # (n, na)


def merge_shards(shards: Sequence[ShardResult]) -> ShardResult:
    """Concatenate shard rows and sort by barcode (reference output order).

    Barcodes must be disjoint across shards (they are, by owns_barcode)."""
    barcodes: List[str] = []
    for s in shards:
        barcodes.extend(s.barcodes)
    order = np.argsort(np.asarray(barcodes, dtype=object), kind="stable")
    cat = lambda f: np.concatenate([getattr(s, f) for s in shards])[order]
    return ShardResult(
        barcodes=[barcodes[i] for i in order],
        totl=cat("totl"),
        pass_=cat("pass_"),
        uniq=cat("uniq"),
        nsnp=cat("nsnp"),
        llks=cat("llks"),
        llk0s=cat("llk0s"),
        llk_ab=cat("llk_ab"),
        llk_00=cat("llk_00"),
    )


def _encode_barcodes(barcodes: Sequence[str]) -> np.ndarray:
    """Fixed-width byte matrix sized to the GLOBAL max barcode length
    (allgathered), so no barcode is ever truncated."""
    from jax.experimental import multihost_utils as mhu

    raws = [b.encode() for b in barcodes]
    local_max = max((len(r) for r in raws), default=0)
    width = int(
        mhu.process_allgather(np.asarray([local_max], dtype=np.int64)).max()
    )
    width = max(width, 1)
    bc = np.zeros((len(raws), width), dtype=np.uint8)
    for i, raw in enumerate(raws):
        bc[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return bc


def gather_results(local: ShardResult) -> Optional[ShardResult]:
    """All-gather FULL shard results across processes; returns the merged
    result on process 0 and None elsewhere. Single-process: identity.

    Ships the whole (n,V,V,A) tensor — needed only for --write-pair; the
    default distributed path is gather_compact (per-cell decision rows)."""
    import jax

    if jax.process_count() == 1:
        return merge_shards([local])

    from jax.experimental import multihost_utils as mhu

    n = len(local.barcodes)
    bc = _encode_barcodes(local.barcodes)

    counts = mhu.process_allgather(np.asarray([n], dtype=np.int64))
    nmax = int(counts.max())

    def pad(a):
        out = np.zeros((nmax,) + a.shape[1:], dtype=a.dtype)
        out[: len(a)] = a
        return out

    fields = [
        bc.astype(np.int32), local.totl, local.pass_, local.uniq, local.nsnp,
        local.llks, local.llk0s, local.llk_ab, local.llk_00,
    ]
    gathered = [mhu.process_allgather(pad(np.asarray(f))) for f in fields]
    if jax.process_index() != 0:
        return None
    shards = []
    for p in range(jax.process_count()):
        np_ = int(counts[p])
        g = [arr[p][:np_] for arr in gathered]
        names = [
            bytes(row.astype(np.uint8)).rstrip(b"\x00").decode()
            for row in g[0]
        ]
        shards.append(
            ShardResult(
                barcodes=names, totl=g[1], pass_=g[2], uniq=g[3], nsnp=g[4],
                llks=g[5], llk0s=g[6], llk_ab=g[7], llk_00=g[8],
            )
        )
    return merge_shards(shards)


# ---------------------------------------------------------------- compact
@dataclass
class CompactShard:
    """One shard's per-barcode outputs in compact (decision-row) form:
    O(V + A) floats per cell instead of the (V,V,A) tensor — what actually
    crosses between processes in the default distributed path."""

    barcodes: List[str]
    totl: np.ndarray
    pass_: np.ndarray
    uniq: np.ndarray
    nsnp: np.ndarray
    llks: np.ndarray  # (n, V) pass-1 singlet LLKs
    llk0s: np.ndarray  # (n,)
    compact: "object"  # models.decision.CompactResult


def merge_compact_shards(shards: Sequence[CompactShard]) -> CompactShard:
    """Concatenate shard rows and sort by barcode (reference output order,
    cmd_cram_demuxlet.cpp:472,576). Barcodes must be disjoint."""
    from demuxlet_jax.models.decision import CompactResult

    barcodes: List[str] = []
    for s in shards:
        barcodes.extend(s.barcodes)
    order = np.argsort(np.asarray(barcodes, dtype=object), kind="stable")
    cat = lambda f: np.concatenate([getattr(s, f) for s in shards])[order]
    ccat = lambda f: np.concatenate(
        [getattr(s.compact, f) for s in shards]
    )[order]
    compact = CompactResult(
        **{f: ccat(f) for f in CompactResult.__dataclass_fields__}
    )
    return CompactShard(
        barcodes=[barcodes[i] for i in order],
        totl=cat("totl"),
        pass_=cat("pass_"),
        uniq=cat("uniq"),
        nsnp=cat("nsnp"),
        llks=cat("llks"),
        llk0s=cat("llk0s"),
        compact=compact,
    )


_COMPACT_F64 = (
    "sing_col", "llk_00", "max_llk", "sum_single", "sum_double",
    "max_sing2", "pair_llk12", "pair_llk10", "pair_llk20",
)
_COMPACT_I64 = ("i_sing1", "i_sing2", "best_flat")


def gather_compact(local: CompactShard) -> Optional[CompactShard]:
    """All-gather compact decision rows across processes; merged result on
    process 0, None elsewhere. Three allgathers total (barcode bytes, one
    packed f64 matrix, one packed i64 matrix): ~(2V+A+12) values/cell."""
    import jax

    if jax.process_count() == 1:
        return merge_compact_shards([local])

    from jax.experimental import multihost_utils as mhu

    from demuxlet_jax.models.decision import CompactResult

    n = len(local.barcodes)
    V = local.llks.shape[1]
    A = local.compact.llk_00.shape[1]
    bc = _encode_barcodes(local.barcodes)

    fcols = [np.asarray(local.llks, np.float64).reshape(n, V),
             np.asarray(local.llk0s, np.float64).reshape(n, 1)]
    for f in _COMPACT_F64:
        a = np.asarray(getattr(local.compact, f), np.float64)
        fcols.append(a.reshape(n, -1))
    fmat = np.concatenate(fcols, axis=1) if n else np.zeros(
        (0, 2 * V + A + 8), np.float64
    )
    icols = [
        np.asarray(local.totl, np.int64), np.asarray(local.pass_, np.int64),
        np.asarray(local.uniq, np.int64), np.asarray(local.nsnp, np.int64),
    ] + [np.asarray(getattr(local.compact, f), np.int64) for f in _COMPACT_I64]
    imat = np.stack(icols, axis=1) if n else np.zeros((0, 7), np.int64)

    counts = mhu.process_allgather(np.asarray([n], dtype=np.int64))
    nmax = int(max(counts.max(), 1))

    def pad(a):
        out = np.zeros((nmax,) + a.shape[1:], dtype=a.dtype)
        out[: len(a)] = a
        return out

    g_bc = mhu.process_allgather(pad(bc))
    g_f = mhu.process_allgather(pad(fmat))
    g_i = mhu.process_allgather(pad(imat))
    if jax.process_index() != 0:
        return None

    shards = []
    for p in range(jax.process_count()):
        np_ = int(counts[p])
        names = [
            bytes(row).rstrip(b"\x00").decode()
            for row in np.asarray(g_bc[p][:np_], np.uint8)
        ]
        f = np.asarray(g_f[p][:np_], np.float64)
        ii = np.asarray(g_i[p][:np_], np.int64)
        o = 0
        llks = f[:, o : o + V]; o += V
        llk0s = f[:, o]; o += 1
        cvals = {}
        for name in _COMPACT_F64:
            w = {"sing_col": V, "llk_00": A}.get(name, 1)
            col = f[:, o : o + w]; o += w
            cvals[name] = col if w > 1 else col[:, 0]
        for k, name in enumerate(_COMPACT_I64):
            cvals[name] = ii[:, 4 + k]
        shards.append(CompactShard(
            barcodes=names,
            totl=ii[:, 0], pass_=ii[:, 1], uniq=ii[:, 2], nsnp=ii[:, 3],
            llks=llks, llk0s=llk0s, compact=CompactResult(**cvals),
        ))
    return merge_compact_shards(shards)


# ---------------------------------------------------------- genome shards
def merge_shards_sum(shards: Sequence[ShardResult]) -> ShardResult:
    """Merge GENOME-sharded results: the same barcode appears in several
    shards with partial (disjoint-SNP) contributions, and log-likelihoods,
    read counters and SNP counts all SUM. Output rows sort by barcode
    (reference output order)."""
    order: List[str] = []
    index = {}
    for s in shards:
        for b in s.barcodes:
            if b not in index:
                index[b] = len(order)
                order.append(b)
    sorted_bcs = sorted(order)
    pos = {b: i for i, b in enumerate(sorted_bcs)}
    n = len(sorted_bcs)
    first = shards[0]
    out = ShardResult(
        barcodes=sorted_bcs,
        totl=np.zeros(n, first.totl.dtype),
        pass_=np.zeros(n, first.pass_.dtype),
        uniq=np.zeros(n, first.uniq.dtype),
        nsnp=np.zeros(n, first.nsnp.dtype),
        llks=np.zeros((n,) + first.llks.shape[1:], np.float64),
        llk0s=np.zeros(n, np.float64),
        llk_ab=np.zeros((n,) + first.llk_ab.shape[1:], np.float64),
        llk_00=np.zeros((n,) + first.llk_00.shape[1:], np.float64),
    )
    for s in shards:
        idx = np.asarray([pos[b] for b in s.barcodes], dtype=np.int64)
        if not len(idx):
            continue
        np.add.at(out.totl, idx, s.totl)
        np.add.at(out.pass_, idx, s.pass_)
        np.add.at(out.uniq, idx, s.uniq)
        np.add.at(out.nsnp, idx, s.nsnp)
        np.add.at(out.llks, idx, np.asarray(s.llks, np.float64))
        np.add.at(out.llk0s, idx, np.asarray(s.llk0s, np.float64))
        np.add.at(out.llk_ab, idx, np.asarray(s.llk_ab, np.float64))
        np.add.at(out.llk_00, idx, np.asarray(s.llk_00, np.float64))
    return out


def gather_results_sum_compact(
    local: ShardResult,
    grid_alpha: Sequence[float],
    doublet_prior: float,
    max_chunk_bytes: int = 48 << 20,
) -> Optional[CompactShard]:
    """Genome-shard merge WITHOUT the full-tensor allgather.

    gather_results_sum ships every process's full (n, V, V, A) f64 tensor
    to every process (~205 MB x P at 100K cells, V=8, A=5). But the LLKs
    only need to SUM before the decision, and the decision is per-cell —
    so instead:

      1. allgather barcode NAMES + integer counters (O(n) bytes) and
         derive the global sorted barcode order on every process;
      2. device reduce-scatter (lax.psum_scatter over a one-lead-device-
         per-process mesh) of the barcode-aligned (N, V*V*A + A + V + 1)
         f64 LLK matrix, in fixed-size chunks — each process ends holding
         the fully SUMMED stripe of 1/P of the barcodes (reduction
         traffic ~1x the local tensor, the floor for any merge);
      3. the decision pass (models/decision.decide — the multi-host
         analog of cmd_cram_demuxlet.cpp:713-828) runs ON DEVICE per
         stripe inside the same shard_map, packing compact rows;
      4. ONE small allgather of the (N/P, 2V+A+11) compact stripes —
         per-process gather traffic O(n*(V+A)).

    Merged CompactShard on process 0, None elsewhere. Output order and
    values match gather_results_sum + compact_from_result; the P-way
    psum reorders the shard sum — fp-identical for P=2, ~1 ulp beyond,
    so at P>2 rendered digits / 2-LLK-threshold calls can differ on exact
    near-ties vs the full-tensor merge (documented in README's golden
    validation section; use --write-pair's full-tensor path when byte
    parity across output modes matters)."""
    import jax

    from demuxlet_jax.models import decision as D

    nproc = jax.process_count()
    if nproc == 1:
        m = merge_shards_sum([local])
        comp = D.compact_from_result(
            m.llk_ab, m.llk_00, grid_alpha, doublet_prior
        )
        return CompactShard(
            barcodes=m.barcodes, totl=m.totl, pass_=m.pass_, uniq=m.uniq,
            nsnp=m.nsnp, llks=m.llks, llk0s=m.llk0s, compact=comp,
        )

    import jax.numpy as jnp
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    n = len(local.barcodes)
    V = local.llks.shape[1]
    A = local.llk_00.shape[1]
    bc = _encode_barcodes(local.barcodes)
    counts = mhu.process_allgather(np.asarray([n], dtype=np.int64))
    nmax = int(max(counts.max(), 1))

    def pad(a):
        out = np.zeros((nmax,) + a.shape[1:], dtype=a.dtype)
        out[: len(a)] = a
        return out

    imat = np.stack(
        [np.asarray(local.totl, np.int64), np.asarray(local.pass_, np.int64),
         np.asarray(local.uniq, np.int64), np.asarray(local.nsnp, np.int64)],
        axis=1) if n else np.zeros((0, 4), np.int64)
    g_bc = mhu.process_allgather(pad(bc.astype(np.int32)))
    g_i = mhu.process_allgather(pad(imat))

    # global sorted barcode order — derived identically on every process
    names_by_p = []
    seen = set()
    order: List[str] = []
    for p in range(nproc):
        np_ = int(counts[p])
        names = [
            bytes(row.astype(np.uint8)).rstrip(b"\x00").decode()
            for row in g_bc[p][:np_]
        ]
        names_by_p.append(names)
        for b in names:
            if b not in seen:
                seen.add(b)
                order.append(b)
    sorted_bcs = sorted(order)
    pos = {b: i for i, b in enumerate(sorted_bcs)}
    N = len(sorted_bcs)

    # barcode-aligned local LLK matrix (zeros where this shard has no row)
    F = V * V * A + A + V + 1
    RS = max(16, min(4096, max_chunk_bytes // max(nproc * F * 8, 1)))
    CH = nproc * RS
    n_chunks = max(1, -(-max(N, 1) // CH))
    N_pad = n_chunks * CH
    loc = np.zeros((N_pad, F), np.float64)
    if n:
        my = np.asarray([pos[b] for b in local.barcodes], np.int64)
        o = V * V * A
        loc[my, :o] = np.asarray(local.llk_ab, np.float64).reshape(n, -1)
        loc[my, o : o + A] = np.asarray(local.llk_00, np.float64)
        loc[my, o + A : o + A + V] = np.asarray(local.llks, np.float64)
        loc[my, o + A + V] = np.asarray(local.llk0s, np.float64)

    lead = {}
    for d in jax.devices():
        lead.setdefault(d.process_index, d)
    mesh = Mesh(np.asarray([lead[p] for p in range(nproc)]), ("p",))
    dbl_w = jnp.asarray(D.doublet_weights(V, grid_alpha, doublet_prior))
    dbl_msk = jnp.asarray(D.doublet_mask(V, A))
    NC = 2 * V + A + 11

    def body(x):
        y = jax.lax.psum_scatter(x[0], "p", scatter_dimension=0, tiled=True)
        o = V * V * A
        llk_ab = y[:, :o].reshape(RS, V, V, A)
        llk_00 = y[:, o : o + A]
        llks = y[:, o + A : o + A + V]
        llk0s = y[:, o + A + V]
        out = D.decide(llk_ab, llk_00, dbl_w, dbl_msk, doublet_prior)
        cols = [out["sing_col"], out["llk_00"]]
        for k in D._PACK_KEYS:
            cols.append(out[k].astype(jnp.float64)[:, None])
        cols.append(llks)
        cols.append(llk0s[:, None])
        return jnp.concatenate(cols, axis=1)[None]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=P("p", None, None), out_specs=P("p", None, None),
        check_vma=False,
    ))
    sharding = NamedSharding(mesh, P("p", None, None))
    my_stripes = []
    for c in range(n_chunks):
        chunk = np.ascontiguousarray(loc[c * CH : (c + 1) * CH])[None]
        garr = jax.make_array_from_process_local_data(
            sharding, chunk, (nproc, CH, F)
        )
        out = fn(garr)
        my_stripes.append(
            np.asarray(out.addressable_shards[0].data)[0]  # (RS, NC)
        )
    g_s = mhu.process_allgather(np.concatenate(my_stripes, axis=0))
    if jax.process_index() != 0:
        return None

    full = np.empty((N_pad, NC), np.float64)
    for c in range(n_chunks):
        for p in range(nproc):
            full[c * CH + p * RS : c * CH + (p + 1) * RS] = (
                g_s[p][c * RS : (c + 1) * RS]
            )
    llks, llk0s, d = D.unpack_block(full[:N], V, A)
    comp = D.concat([d])

    totl = np.zeros(N, np.int64)
    pass_ = np.zeros(N, np.int64)
    uniq = np.zeros(N, np.int64)
    nsnp = np.zeros(N, np.int64)
    for p in range(nproc):
        np_ = int(counts[p])
        if not np_:
            continue
        idx = np.asarray([pos[b] for b in names_by_p[p]], np.int64)
        gi = np.asarray(g_i[p][:np_], np.int64)
        np.add.at(totl, idx, gi[:, 0])
        np.add.at(pass_, idx, gi[:, 1])
        np.add.at(uniq, idx, gi[:, 2])
        np.add.at(nsnp, idx, gi[:, 3])
    return CompactShard(
        barcodes=sorted_bcs, totl=totl, pass_=pass_, uniq=uniq, nsnp=nsnp,
        llks=np.asarray(llks, np.float64),
        llk0s=np.asarray(llk0s, np.float64), compact=comp,
    )


def gather_results_sum(local: ShardResult) -> Optional[ShardResult]:
    """All-gather genome-shard results and SUM-merge by barcode; merged
    result on process 0, None elsewhere."""
    import jax

    if jax.process_count() == 1:
        return merge_shards_sum([local])

    from jax.experimental import multihost_utils as mhu

    n = len(local.barcodes)
    bc = _encode_barcodes(local.barcodes)
    counts = mhu.process_allgather(np.asarray([n], dtype=np.int64))
    nmax = int(max(counts.max(), 1))

    def pad(a):
        out = np.zeros((nmax,) + a.shape[1:], dtype=a.dtype)
        out[: len(a)] = a
        return out

    fields = [
        bc.astype(np.int32), local.totl, local.pass_, local.uniq, local.nsnp,
        local.llks, local.llk0s, local.llk_ab, local.llk_00,
    ]
    gathered = [mhu.process_allgather(pad(np.asarray(f))) for f in fields]
    if jax.process_index() != 0:
        return None
    shards = []
    for p in range(jax.process_count()):
        np_ = int(counts[p])
        g = [arr[p][:np_] for arr in gathered]
        names = [
            bytes(row.astype(np.uint8)).rstrip(b"\x00").decode()
            for row in g[0]
        ]
        shards.append(ShardResult(
            barcodes=names, totl=g[1], pass_=g[2], uniq=g[3], nsnp=g[4],
            llks=g[5], llk0s=g[6], llk_ab=g[7], llk_00=g[8],
        ))
    return merge_shards_sum(shards)
