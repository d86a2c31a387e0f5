"""Device-side decision pass (SURVEY.md §7 "kernel 3").

Computes, on device, everything the .sing2/.best renderers need per cell —
posterior sums, singlet argmaxes, best-doublet argmax and its associated
LLK columns (cmd_cram_demuxlet.cpp:713-828) — so the fast path ships ~30
scalars per cell to the host instead of the full (V,V,A) LLK tensor
(~16x less device->host traffic; the .pair writer still needs the full
tensor, so --write-pair keeps the full fetch).

Decision semantics mirror models/outputs.py's vectorized host pass:
first-occurrence argmaxes (== the reference's running strict-< loops),
-1e300-seeded second best, doublet weights zeroed for j==k / alpha==0 and
empty when nv==1 or nA==1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax.numpy as jnp
import numpy as np


@dataclass
class CompactResult:
    """Per-cell decision outputs (numpy, trimmed to real cells)."""

    sing_col: np.ndarray  # (n, V)   llkAB[j,0,0]
    llk_00: np.ndarray  # (n, A)
    max_llk: np.ndarray  # (n,)
    sum_single: np.ndarray  # (n,)
    sum_double: np.ndarray  # (n,)
    i_sing1: np.ndarray  # (n,) int
    i_sing2: np.ndarray  # (n,) int
    max_sing2: np.ndarray  # (n,)  second-best value (seeded -1e300)
    best_flat: np.ndarray  # (n,) int flat (j,k,a) argmax over doublet mask
    pair_llk12: np.ndarray  # (n,)
    pair_llk10: np.ndarray  # (n,)  llkAB[j_best, 0, a_best] (reference quirk)
    pair_llk20: np.ndarray  # (n,)  llkAB[k_best, 0, a_best]


def doublet_weights(nv: int, grid_alpha: Sequence[float], doublet_prior: float):
    """(V,V,A) posterior weights of cmd_cram_demuxlet.cpp:724-734."""
    na = len(grid_alpha)
    w = np.zeros((nv, nv, na))
    if nv > 1 and na > 1:
        for n in range(1, na):
            w[:, :, n] = (
                doublet_prior
                / nv
                / (nv - 1)
                / (na - 1)
                / (2.0 if grid_alpha[n] == 0.5 else 1.0)
            )
        for j in range(nv):
            w[j, j, :] = 0.0
    return w


def doublet_mask(nv: int, na: int) -> np.ndarray:
    """(V,V,A) bool argmax mask: j != k, alpha index >= 1 (:799-814) —
    independent of the posterior weights (which can be all-zero)."""
    m = np.ones((nv, nv, na), dtype=bool)
    for j in range(nv):
        m[j, j, :] = False
    m[:, :, 0] = False
    return m


def decide(llk_ab, llk_00, dbl_w, dbl_msk, doublet_prior):
    """Traceable decision pass. llk_ab (B,V,V,A), llk_00 (B,A),
    dbl_w/dbl_msk (V,V,A) host-built. Returns a dict of per-cell arrays."""
    B, V, _, A = llk_ab.shape
    flat = llk_ab.reshape(B, -1)
    # -1e300 seed (:476-501); f32 can't hold it — finfo.min is the same
    # floor for any finite f32 and avoids an overflow-on-cast warning
    seed = -1e300 if flat.dtype == jnp.float64 else float(
        np.finfo(np.dtype(flat.dtype)).min
    )
    max_llk = jnp.maximum(jnp.max(flat, axis=1), seed)
    sing_col = llk_ab[:, :, 0, 0]
    sum_single = (
        jnp.sum(jnp.exp(sing_col - max_llk[:, None]), axis=1)
        * (1.0 - doublet_prior)
        / V
    )
    sum_double = jnp.einsum(
        "cjkn,jkn->c", jnp.exp(llk_ab - max_llk[:, None, None, None]), dbl_w
    )
    i1 = jnp.argmax(sing_col, axis=1)
    masked = sing_col.at[jnp.arange(B), i1].set(-jnp.inf)
    i2 = jnp.argmax(masked, axis=1)
    max2 = jnp.maximum(masked[jnp.arange(B), i2], seed)
    flat_masked = jnp.where(dbl_msk.reshape(-1)[None, :], flat, -jnp.inf)
    best = jnp.argmax(flat_masked, axis=1)
    jb = best // (V * A)
    kb = (best // A) % V
    ab_ = best % A
    rows = jnp.arange(B)
    return dict(
        sing_col=sing_col,
        llk_00=llk_00,
        max_llk=max_llk,
        sum_single=sum_single,
        sum_double=sum_double,
        i_sing1=i1,
        i_sing2=i2,
        max_sing2=max2,
        best_flat=best,
        pair_llk12=llk_ab[rows, jb, kb, ab_],
        pair_llk10=llk_ab[rows, jb, 0, ab_],
        pair_llk20=llk_ab[rows, kb, 0, ab_],
    )


def trim(out: dict, m: int) -> dict:
    return {k: np.asarray(v)[:m] for k, v in out.items()}


def take(res: CompactResult, idx: np.ndarray) -> CompactResult:
    """Reindex every per-cell field (row i of the result <- row idx[i]);
    used to undo the engine's coverage-sorted block permutation."""
    import dataclasses

    return CompactResult(**{
        f.name: getattr(res, f.name)[idx]
        for f in dataclasses.fields(CompactResult)
    })


def concat(parts: Sequence[dict]) -> CompactResult:
    cat = lambda k: np.concatenate([p[k] for p in parts])
    return CompactResult(
        sing_col=cat("sing_col").astype(np.float64),
        llk_00=cat("llk_00").astype(np.float64),
        max_llk=cat("max_llk").astype(np.float64),
        sum_single=cat("sum_single").astype(np.float64),
        sum_double=cat("sum_double").astype(np.float64),
        i_sing1=cat("i_sing1").astype(np.int64),
        i_sing2=cat("i_sing2").astype(np.int64),
        max_sing2=cat("max_sing2").astype(np.float64),
        best_flat=cat("best_flat").astype(np.int64),
        pair_llk12=cat("pair_llk12").astype(np.float64),
        pair_llk10=cat("pair_llk10").astype(np.float64),
        pair_llk20=cat("pair_llk20").astype(np.float64),
    )


import functools

import jax


_PACK_KEYS = (
    "max_llk", "sum_single", "sum_double", "i_sing1", "i_sing2",
    "max_sing2", "best_flat", "pair_llk12", "pair_llk10", "pair_llk20",
)


def compact_step_body(
    codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext, dbl_w, dbl_msk,
    n_alpha, n_samples, doublet_prior, pair_impl="xla", interpret=False,
    a0_sep=False, sym_a=None, expand=None, wire=None,
):
    """Traceable fused fast block step + device decision pass, packed into
    ONE (B, 2V+A+11) f64 array. Shared by the single-device jit
    (demux_block_fast_compact) and the multi-chip shard_map
    (parallel/mesh.build_sharded_compact_step — every op here is per-cell,
    so sharding the barcode axis is exact).

    Layout: [sing_col(V), llk_00(A), _PACK_KEYS(10), llks(V), llk0s(1)];
    integer fields ride as exact small f64s."""
    from demuxlet_jax.ops.pallas_pair import demux_block_fast_impl

    llk, llk0, llk_ab, llk_00 = demux_block_fast_impl(
        codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext,
        n_alpha, n_samples, pair_impl=pair_impl, interpret=interpret,
        a0_sep=a0_sep, sym_a=sym_a, expand=expand, wire=wire,
    )
    out = decide(
        llk_ab.astype(jnp.float64),
        llk_00.astype(jnp.float64),
        dbl_w, dbl_msk, doublet_prior,
    )
    cols = [out["sing_col"], out["llk_00"]]
    for k in _PACK_KEYS:
        cols.append(out[k].astype(jnp.float64)[:, None])
    cols.append(llk.astype(jnp.float64))
    cols.append(llk0.astype(jnp.float64)[:, None])
    return jnp.concatenate(cols, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("n_alpha", "n_samples", "doublet_prior", "pair_impl",
                     "interpret", "a0_sep", "sym_a", "expand", "wire"),
)
def demux_block_fast_compact(
    codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext, dbl_w, dbl_msk,
    n_alpha, n_samples, doublet_prior, pair_impl="xla", interpret=False,
    a0_sep=False, sym_a=None, expand=None, wire=None,
):
    """Single-device jit wrapper over compact_step_body: one device->host
    buffer per block, ~16x less data than the full (V,V,A) tensor."""
    return compact_step_body(
        codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext, dbl_w,
        dbl_msk, n_alpha, n_samples, doublet_prior, pair_impl=pair_impl,
        interpret=interpret, a0_sep=a0_sep, sym_a=sym_a, expand=expand,
        wire=wire,
    )


def compact_from_result(
    llk_ab: np.ndarray,
    llk_00: np.ndarray,
    grid_alpha: Sequence[float],
    doublet_prior: float,
) -> CompactResult:
    """Build a CompactResult from full (n,V,V,A) LLKs (exact-mode path):
    the same decision pass the fast path fuses on device, run once over
    host-resident f64 arrays. Used to gather compact rows (not the full
    tensor) across hosts (parallel/multihost.gather_compact)."""
    llk_ab = np.asarray(llk_ab, dtype=np.float64)
    llk_00 = np.asarray(llk_00, dtype=np.float64)
    n, V, _, A = llk_ab.shape
    dbl_w = doublet_weights(V, grid_alpha, doublet_prior)
    dbl_msk = doublet_mask(V, A)
    rows = np.arange(n)
    flat = llk_ab.reshape(n, -1)
    max_llk = np.maximum(
        flat.max(axis=1) if flat.shape[1] else np.full(n, -np.inf), -1e300
    )
    sing_col = llk_ab[:, :, 0, 0]
    sum_single = (
        np.exp(sing_col - max_llk[:, None]).sum(axis=1)
        * (1.0 - doublet_prior) / V
    )
    sum_double = np.einsum(
        "cjkn,jkn->c", np.exp(llk_ab - max_llk[:, None, None, None]), dbl_w
    )
    i1 = np.argmax(sing_col, axis=1)
    masked = sing_col.copy()
    masked[rows, i1] = -np.inf
    i2 = np.argmax(masked, axis=1)
    max2 = np.maximum(masked[rows, i2], -1e300)
    flat_masked = np.where(dbl_msk.reshape(-1)[None, :], flat, -np.inf)
    best = np.argmax(flat_masked, axis=1)
    jb = best // (V * A)
    kb = (best // A) % V
    ab_ = best % A
    return CompactResult(
        sing_col=sing_col,
        llk_00=llk_00,
        max_llk=max_llk,
        sum_single=sum_single,
        sum_double=sum_double,
        i_sing1=i1.astype(np.int64),
        i_sing2=i2.astype(np.int64),
        max_sing2=max2,
        best_flat=best.astype(np.int64),
        pair_llk12=llk_ab[rows, jb, kb, ab_],
        pair_llk10=llk_ab[rows, jb, 0, ab_],
        pair_llk20=llk_ab[rows, kb, 0, ab_],
    )


def unpack_block(packed: np.ndarray, n_samples: int, n_alpha: int):
    """Split the packed (m, 2V+A+11) array back into (llks, llk0s, dict)."""
    V, A = n_samples, n_alpha
    o = 0
    out = {}
    out["sing_col"] = packed[:, o : o + V]; o += V
    out["llk_00"] = packed[:, o : o + A]; o += A
    for k in _PACK_KEYS:
        out[k] = packed[:, o]; o += 1
    llks = packed[:, o : o + V]; o += V
    llk0s = packed[:, o]; o += 1
    return llks, llk0s, out
