"""Dense JAX likelihood kernels over the slot representation.

These replace the reference's two scalar passes (cmd_cram_demuxlet.cpp
:415-461 singlet, :576-709 pair search) with batched contractions:

  log-raw likelihoods  = counts @ LUT           (matmul)
  posterior mixing     = contraction over the tiny (l, m) genotype axes
  per-cell LLKs        = masked log-reduction over the slot (SNP) axis

Everything is shape-static and jit friendly, and generic in dtype: f64 is
exact mode, f32 the fast path's XLA route. The barcode axis is the
data-parallel axis for multi-device sharding (parallel/mesh.py).

Normalization semantics preserved exactly (they telescope — SURVEY.md §2.1):
GL: normalize, +1e-6, renormalize (:446-452); pGs: max-normalize, +1e-6,
max-renormalize (:626-663).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 contractions must not drop to TF32 on the GPU (~1e-3 relative on
# lograw, beyond fast-mode tolerance); a no-op for f64
_HIGHEST = jax.lax.Precision.HIGHEST


def singlet_llks_impl(cnt, msk, gps_g, gp0_g, logf, dtype=jnp.float64):
    """Pass 1: per-(cell, sample) singlet log-likelihoods (traceable impl).

    cnt:   (B, S, NB) int/float counts
    msk:   (B, S) bool
    gps_g: (B, S, V, 3) genotype posteriors gathered per slot
    gp0_g: (B, S, 3) background (mean) genotype posteriors per slot
    logf:  (NB, 3) singlet LUT
    Returns (llk[B, V], llk0[B]).
    """
    cnt = cnt.astype(dtype)
    logf = logf.astype(dtype)
    gps_g = gps_g.astype(dtype)
    gp0_g = gp0_g.astype(dtype)
    lograw = jnp.einsum("bsn,ng->bsg", cnt, logf, precision=_HIGHEST)
    mx = jnp.max(lograw, axis=-1, keepdims=True)
    gl = jnp.exp(lograw - mx)
    gl = gl / jnp.sum(gl, axis=-1, keepdims=True)
    gl = gl + 1e-6
    gl = gl / jnp.sum(gl, axis=-1, keepdims=True)
    m = msk.astype(dtype)
    contrib = jnp.log(
        jnp.einsum("bsg,bsvg->bsv", gl, gps_g, precision=_HIGHEST))
    llk = jnp.sum(contrib * m[..., None], axis=1)
    contrib0 = jnp.log(
        jnp.einsum("bsg,bsg->bs", gl, gp0_g, precision=_HIGHEST))
    llk0 = jnp.sum(contrib0 * m, axis=1)
    return llk, llk0


singlet_llks = jax.jit(singlet_llks_impl, static_argnames=("dtype",))


def pair_contract(g, t, msk=None, g_k=None):
    """Plain pair-search contraction, vectorised over the sample pair:

        llk[b, j, k, a] = sum_s log(sum_{l,m} (g_j[l] * g_k[m]) * t[a, l, m])

    g: (B, S, V, 3) per-slot genotype posteriors (rows j); g_k the column
    samples (defaults to g; pass (B, S, 1, 3) rows for the background
    term); t: (B, S, A, 3, 3) mixture table; msk: (B, S) bool or None
    (None: padded slots are exactly neutral). Returns (B, V, Vk, A).

    The nine (l, m) terms are summed l-major, each product formed as
    (g_j[l] * g_k[m]) * t[a, l, m] — the reference's per-element order
    (cmd_cram_demuxlet.cpp:671-684), so the mirrored alpha = 0.5 pairs
    round the way the reference's do. XLA on the GPU materialises the
    (B, S, V, Vk, A) product before the slot reduction, so large shapes
    must go through pair_rows (rows of j per step, auto_pair_chunk)."""
    if g_k is None:
        g_k = g
    inner = None
    for l in range(3):
        for m in range(3):
            p = g[:, :, :, None, l] * g_k[:, :, None, :, m]  # (B,S,V,Vk)
            term = p[..., None] * t[:, :, None, None, :, l, m]
            inner = term if inner is None else inner + term
    logs = jnp.log(inner)
    if msk is not None:
        logs = jnp.where(msk[:, :, None, None, None], logs, 0)
    return jnp.sum(logs, axis=1)


# per-step element budget of the (B, S, rows, V, A) contraction
PAIR_STEP_ELEMS = 1 << 28


def auto_pair_chunk(n_cells, slot_chunk, n_samples, n_alpha):
    """Rows per pair block keeping one step within PAIR_STEP_ELEMS
    elements (0 = no row blocking needed)."""
    per_row = max(n_cells * max(slot_chunk, 1) * n_samples * n_alpha, 1)
    rows = max(1, PAIR_STEP_ELEMS // per_row)
    return 0 if rows >= n_samples else rows


def pair_rows(g, t, msk, pair_chunk):
    """pair_contract over blocks of `pair_chunk` sample rows j (a lax.map,
    so one block's working set is live at a time); 0 = all rows at once.
    Padded rows are neutral and dropped."""
    V = g.shape[2]
    if pair_chunk <= 0 or V <= pair_chunk:
        return pair_contract(g, t, msk)
    nb = -(-V // pair_chunk)
    pad = nb * pair_chunk - V
    gj = g
    if pad:
        neutral = jnp.zeros(g.shape[:2] + (pad, 3), g.dtype).at[..., 0].set(1)
        gj = jnp.concatenate([g, neutral], axis=2)
    blocks = jnp.moveaxis(
        gj.reshape(g.shape[:2] + (nb, pair_chunk, 3)), 2, 0)
    out = jax.lax.map(lambda gb: pair_contract(gb, t, msk, g_k=g), blocks)
    B = g.shape[0]
    out = jnp.moveaxis(out, 0, 1).reshape((B, nb * pair_chunk) + out.shape[3:])
    return out[:, :V]


def _pair_block(cnt, msk, gps_g, gp0_g, w, n_alpha, pair_chunk):
    """Pair-search LLK contribution of one slot chunk.

    Returns (llkAB[B,V,V,A], llk00[B,A]) contributions (to be summed over
    chunks)."""
    B, S = cnt.shape[0], cnt.shape[1]
    lograw = jnp.einsum("bsn,nx->bsx", cnt, w, precision=_HIGHEST)  # (B,S,A*9)
    mx = jnp.max(lograw, axis=-1, keepdims=True)
    t = jnp.exp(lograw - mx)
    t = t + 1e-6
    t = t / jnp.max(t, axis=-1, keepdims=True)
    t = t.reshape(B, S, n_alpha, 3, 3)
    llk_ab = pair_rows(gps_g, t, msk, pair_chunk)
    # background pair term llks00 (:700-709), same (l,m) order
    g0 = gp0_g[:, :, None, :]
    llk_00 = pair_contract(g0, t, msk)[:, 0, 0]
    return llk_ab, llk_00


def pair_llks_impl(cnt, msk, gps_g, gp0_g, w, n_alpha, slot_chunk=0,
                   dtype=jnp.float64, pair_chunk=0):
    """Pass 2: doublet pair-search LLKs.

    cnt: (B, S, NB); msk: (B, S); gps_g: (B, S, V, 3); gp0_g: (B, S, 3);
    w: (NB, A*9) pair LUT.
    Returns (llkAB[B, V, V, A], llk00[B, A]).

    slot_chunk > 0 processes the slot axis in chunks via lax.scan, and
    pair_chunk > 0 the sample rows j in blocks of that many (lax.map):
    both bound the per-step working set where a backend does not fuse
    the contraction into its slot reduction.
    """
    cnt = cnt.astype(dtype)
    w = w.astype(dtype)
    gps_g = gps_g.astype(dtype)
    gp0_g = gp0_g.astype(dtype)
    B, S = cnt.shape[0], cnt.shape[1]
    if slot_chunk <= 0 or S <= slot_chunk:
        return _pair_block(cnt, msk, gps_g, gp0_g, w, n_alpha, pair_chunk)

    pad = (-S) % slot_chunk
    if pad:
        cnt = jnp.pad(cnt, ((0, 0), (0, pad), (0, 0)))
        msk = jnp.pad(msk, ((0, 0), (0, pad)))
        gps_g = jnp.pad(gps_g, ((0, 0), (0, pad), (0, 0), (0, 0)))
        gp0_g = jnp.pad(gp0_g, ((0, 0), (0, pad), (0, 0)))
    nc = (S + pad) // slot_chunk
    V = gps_g.shape[2]

    def chunk(i):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, i * slot_chunk, slot_chunk, 1)
        return _pair_block(
            sl(cnt), sl(msk), sl(gps_g), sl(gp0_g), w, n_alpha, pair_chunk
        )

    def body(carry, i):
        ab, z = carry
        dab, dz = chunk(i)
        return (ab + dab, z + dz), None

    init = (
        jnp.zeros((B, V, V, n_alpha), dtype),
        jnp.zeros((B, n_alpha), dtype),
    )
    (llk_ab, llk_00), _ = jax.lax.scan(body, init, jnp.arange(nc))
    return llk_ab, llk_00


pair_llks = jax.jit(
    pair_llks_impl,
    static_argnames=("n_alpha", "slot_chunk", "dtype", "pair_chunk"),
)
