"""Multi-chip SPMD execution: device mesh, sharded demux step, result merge.

The reference scales only by manual process-level sharding (`--group-list`,
cmd_cram_demuxlet.cpp:68, README.md:66: "useful for parallelized run").  The
replacement here is a 2-D `jax.sharding.Mesh`, shaped by the algorithm
alone (every device reaches every other at the same rate):

  axis "b" (barcodes)   — pure data parallelism: each device owns a block of
                          cell barcodes; no communication until output merge.
  axis "s" (SNP slots)  — reduction-axis parallelism: each device owns a slice
                          of every cell's covered-SNP slots and computes a
                          partial log-likelihood sum, combined with a single
                          `psum`.

All per-slot math (GL normalization, mixture tables) is slot-local, so the
"s" split is exact: partial sums add, and the combined result is bit-identical
to the single-device sum per-chunk (sum order over shards is fixed by psum's
deterministic reduction).

Genotype tensors (the LUTs and per-slot gathered GPs) ride along with the
slot shards; the GP master table stays replicated per host (BASELINE.json:
"genotype tensor is replicated per host").
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from demuxlet_jax.models.likelihood import pair_llks_impl, singlet_llks_impl


def make_mesh(
    n_b: Optional[int] = None,
    n_s: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("b", "s") mesh over the available devices.

    n_b defaults to len(devices) // n_s (all devices used).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_s < 1:
        raise ValueError("n_s must be >= 1")
    if n_b is None:
        n_b = len(devices) // n_s
    need = n_b * n_s
    if need > len(devices):
        raise ValueError(f"mesh {n_b}x{n_s} needs {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need], dtype=object).reshape(n_b, n_s)
    return Mesh(arr, ("b", "s"))


# PartitionSpecs for the slot-block tensors (cnt, msk, gps_g, gp0_g) and LUTs.
BLOCK_SPECS = (
    P("b", "s", None),        # cnt  (B, S, NB)
    P("b", "s"),              # msk  (B, S)
    P("b", "s", None, None),  # gps_g (B, S, V, 3)
    P("b", "s", None),        # gp0_g (B, S, 3)
)
LUT_SPECS = (P(None, None), P(None, None))  # logf (NB,3), w (NB, A*9)
OUT_SPECS = (
    P("b", None),              # llk   (B, V)
    P("b"),                    # llk0  (B,)
    P("b", None, None, None),  # llkAB (B, V, V, A)
    P("b", None),              # llk00 (B, A)
)


def build_sharded_step(
    mesh: Mesh,
    n_alpha: int,
    slot_chunk: int = 0,
    dtype=jnp.float64,
    pair_chunk: int = 0,
):
    """jit-compiled full demux likelihood step, SPMD over the mesh.

    Signature: step(cnt, msk, gps_g, gp0_g, logf, w) ->
               (llk[B,V], llk0[B], llkAB[B,V,V,A], llk00[B,A]).
    B must divide by mesh "b" size, S by mesh "s" size (pad upstream).
    """

    def body(cnt, msk, gps_g, gp0_g, logf, w):
        llk, llk0 = singlet_llks_impl(cnt, msk, gps_g, gp0_g, logf, dtype=dtype)
        llk_ab, llk_00 = pair_llks_impl(
            cnt, msk, gps_g, gp0_g, w, n_alpha, slot_chunk=slot_chunk,
            dtype=dtype, pair_chunk=pair_chunk,
        )
        if mesh.shape["s"] > 1:
            llk = jax.lax.psum(llk, "s")
            llk0 = jax.lax.psum(llk0, "s")
            llk_ab = jax.lax.psum(llk_ab, "s")
            llk_00 = jax.lax.psum(llk_00, "s")
        return llk, llk0, llk_ab, llk_00

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=BLOCK_SPECS + LUT_SPECS,
        out_specs=OUT_SPECS,
        check_vma=False,
    )
    return jax.jit(fn)


def shard_block(mesh: Mesh, cnt, msk, gps_g, gp0_g) -> Tuple:
    """device_put the slot-block tensors with their mesh shardings."""
    arrs = (cnt, msk, gps_g, gp0_g)
    return tuple(
        jax.device_put(a, NamedSharding(mesh, s)) for a, s in zip(arrs, BLOCK_SPECS)
    )


def replicate(mesh: Mesh, *luts) -> Tuple:
    """Replicate lookup tables across the mesh."""
    return tuple(
        jax.device_put(a, NamedSharding(mesh, P(*([None] * a.ndim))))
        for a in luts
    )


def pad_to_mesh(n: int, shard: int, block: int = 1) -> int:
    """Round n up so it divides evenly into `shard` shards of multiple-of-
    `block` size."""
    per = math.ceil(n / shard)
    per = ((per + block - 1) // block) * block
    return per * shard


def build_sharded_fast_step(
    mesh: Mesh,
    n_alpha: int,
    n_samples: int,
    pair_impl: str = "xla",
    interpret: bool = False,
    a0_sep: bool = False,
    sym_a: int | None = None,
    expand: tuple | None = None,
):
    """Fast-mode (f32) demux step sharded over the "b" barcode axis:
    each device runs the kernel on its barcode shard; genotype tables are
    replicated. No collectives needed until the output merge — barcodes are
    embarrassingly parallel (the reference's --group-list decomposition).

    Signature: step(codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext)
    -> (llk, llk0, llk_ab, llk_00). The global batch must split evenly
    over the "b" axis.
    """
    from demuxlet_jax.ops.pallas_pair import demux_block_fast_impl

    def body(codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext):
        return demux_block_fast_impl(
            codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext,
            n_alpha, n_samples, pair_impl=pair_impl, interpret=interpret,
            a0_sep=a0_sep, sym_a=sym_a, expand=expand,
        )

    rep2 = P(None, None)
    rep3 = P(None, None, None)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("b", None, None),  # codes (B,S,U)
            P("b", None),        # idx
            P("b", None),        # msk
            rep3,                # gps_table (NS,V,3)
            rep2,                # gp0_table (NS,3)
            rep2,                # w_ext
            rep2,                # logf_ext
        ),
        out_specs=(
            P("b", None),
            P("b"),
            P("b", None, None, None),
            P("b", None),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def build_sharded_compact_step(
    mesh: Mesh,
    n_alpha: int,
    n_samples: int,
    doublet_prior: float,
    pair_impl: str = "xla",
    interpret: bool = False,
    a0_sep: bool = False,
    sym_a: int | None = None,
    expand: tuple | None = None,
):
    """Fast-mode fused kernel + decision pass sharded over the "b" barcode
    axis (models/decision.compact_step_body: every op is per-cell, so the
    shard is exact; genotype tables and decision weights replicate). Output
    is one packed (B, 2V+A+11) f64 row per cell — the multi-chip analog of
    the single-device demux_block_fast_compact.

    Signature: step(codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext,
    dbl_w, dbl_msk) -> packed. The global batch must split evenly over
    the "b" axis.
    """
    from demuxlet_jax.models.decision import compact_step_body

    def body(codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext,
             dbl_w, dbl_msk):
        return compact_step_body(
            codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext,
            dbl_w, dbl_msk, n_alpha, n_samples, doublet_prior,
            pair_impl=pair_impl, interpret=interpret, a0_sep=a0_sep,
            sym_a=sym_a, expand=expand,
        )

    rep2 = P(None, None)
    rep3 = P(None, None, None)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("b", None, None),  # codes (B,S,U)
            P("b", None),        # idx
            P("b", None),        # msk
            rep3,                # gps_table (NS,V,3)
            rep2,                # gp0_table (NS,3)
            rep2,                # w_ext
            rep2,                # logf_ext
            rep3,                # dbl_w (V,V,A)
            rep3,                # dbl_msk (V,V,A)
        ),
        out_specs=P("b", None),
        check_vma=False,
    )
    return jax.jit(fn)
