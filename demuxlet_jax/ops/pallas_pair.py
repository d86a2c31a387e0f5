"""Fast-mode (f32) block step and the Pallas-Triton pair-search kernel.

The reference's hot loop (cmd_cram_demuxlet.cpp:671-709) computes, per cell
and covered SNP, llkAB[j,k,a] += log(sum_lm gps[j,l]*gps[k,m]*pGs[a,l,m]).

Division of labor:
  * XLA: wire decode, one-hot count front + LUT matmul (lograw = cnt @ W),
    exp-normalize -> mixture table t, genotype gather, singlet pass, the
    separable alpha = 0 plane and the llks00 background term.
  * the (j, k, a) pair contraction + log + slot reduction, by one of two
    implementations chosen per platform (demuxlet_jax/backend.py):
      - "xla": likelihood.pair_contract, the plain vectorised contraction
        (also the reference the kernel is tested against);
      - "triton": _pair_kernel below, a Pallas kernel through Triton.

The kernel's grid is (pair tile, slot split, cell tile). A program owns a
(Kt x Kt) sample-pair tile for TB cells and loops over slot chunks with a
fori_loop, keeping its (Kt, TB) log-sum accumulators in registers; the
k axis is vectorised inside the block and j is unrolled. Per slot and row j
it forms U[a,m] = sum_l g_j[l] t[a,l,m] once and reuses it for the Kt
columns: inner[k,a] = sum_m g_k[m] U[a,m].

Algebra kept from the original kernel design:
  * dedup_channels: the A*9 mixture columns collapse to the unique p values;
  * the alpha = 0 plane factorises (t[0,l,m] is constant in m), so
    llk_ab[j,k,0] = sum_s log(g_j . t0) + sum_s log(sum g_k) — O(V) work;
  * the alpha = 0.5 plane is (j,k)-symmetric: when it is the only kernel
    plane, only upper-triangle tiles run, and it is always mirrored from
    its upper triangle;
  * log batching: `log_batch` slot sub-chunks multiply before one log
    (inner >= ~1e-6, so a product of two stays far above f32 underflow).

Padded slots are exactly neutral by construction (zero counts => t == 1;
gps row (1,0,0) => inner == 1 => log == 0), so no mask input is needed.

Precision: f32 ("fast" mode; |err| <= 1e-4 * max(1, |LLK|) against the f64
contraction — demux calls identical, printed LLKs may differ in the last
digit; the alpha=0.5 symmetric-pair argmax tie can resolve to the mirrored
pair). The byte-parity path is exact mode's f64 contraction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from demuxlet_jax.models.likelihood import (
    auto_pair_chunk,
    pair_contract,
    pair_rows,
)


def dedup_channels(grid_alpha):
    """Static channel-dedup map for the A*9 mixture columns.

    The per-UMI mixture factor pr*(1-p) + pa*p depends on (a,l,m) only
    through p = 0.5*l + (m-l)*0.5*alpha (cmd_cram_demuxlet.cpp:606-625),
    so LUT columns with equal p are bit-identical (same expression, same
    inputs — luts.pair_lut) and the A*9 logical channels collapse to the
    unique p values (18 for a 5-point grid, 5 for the default [0, 0.5]
    grid). Narrows the front's matmul and normalisation width.

    Returns (cols, expand): cols = A*9-order indices of first-occurrence
    unique columns (select them from the full LUT with w[:, cols]);
    expand = per-logical-channel index into the deduped table.
    """
    seen, cols, expand = {}, [], []
    for a, alpha in enumerate(grid_alpha):
        for l in range(3):
            for m in range(3):
                p = 0.5 * l + (m - l) * 0.5 * alpha
                if p not in seen:
                    seen[p] = len(cols)
                    cols.append(a * 9 + l * 3 + m)
                expand.append(seen[p])
    return tuple(cols), tuple(expand)


# exact-neutrality constant: with q = fl(1 + 1e-6), fl(q * fl(1/q)) == 1.0,
# so a padded slot (lograw == 0 everywhere) yields t == 1 exactly and
# contributes log(1) == 0 — no mask needed (checked in tests/test_pallas.py)
_SMOOTH = np.float32(1e-6)
_KNORM = np.float32(1.0) / (np.float32(1.0) + np.float32(1e-6))


def _norm_t(lograw, axis):
    """Mixture table from raw LUT log-sums: t = (exp(lr-max)+1e-6)/(1+1e-6).

    The reference divides by the (telescoped) running max and smooths once
    (cmd_cram_demuxlet.cpp:631-663); the final max-division is the CONSTANT
    1+1e-6 because max(exp(lr-max)) == 1 exactly — saving a second reduce
    pass, and fl(q*fl(1/q)) == 1 keeps padded slots exactly neutral."""
    mx = jnp.max(lograw, axis=axis, keepdims=True)
    return (jnp.exp(lograw - mx) + _SMOOTH) * _KNORM


# ------------------------------------------------------------ Triton kernel


@functools.lru_cache(maxsize=None)
def plan_tiles(V, A, a0_sep, sym_a, kt_max=8):
    """Static pair-tile plan for the kernel.

    Returns (Kt, Vp, tiles, ac_list): Kt the (square) tile extent, a power
    of two no larger than V needs; Vp = V padded to a Kt multiple (padded
    samples carry neutral rows and are dropped at reassembly); tiles the
    (jt, kt) list — upper-triangular when the only kernel plane is the
    symmetric alpha = 0.5 one (the default [0, 0.5] grid); ac_list the
    alpha indices the kernel computes (alpha[0] == 0 is separable)."""
    Kt = min(kt_max, 1 << max(V - 1, 0).bit_length())
    Vp = -(-V // Kt) * Kt
    n_t = Vp // Kt
    ac_list = tuple(a for a in range(A) if not (a0_sep and a == 0))
    if ac_list == (sym_a,):
        tiles = tuple((j, k) for j in range(n_t) for k in range(j, n_t))
    else:
        tiles = tuple((j, k) for j in range(n_t) for k in range(n_t))
    return Kt, Vp, tiles, ac_list


def _pair_kernel(tj_ref, tk_ref, t_ref, g_ref, out_ref, *, Kt, TB, TS,
                 n_chunks, ac_list, expand, log_batch):
    """One (Kt x Kt) pair tile x TB cells x 1/n_split of the slot axis.

    t_ref (C, Bp, Sp) deduped mixture table; g_ref (3, Vp, Bp, Sp) gps
    planes (genotype-major); out_ref (n_split, nAc, Vp, Vp, Bp)."""
    ip, isp, ib = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    j0 = tj_ref[ip] * Kt
    k0 = tk_ref[ip] * Kt
    cells = pl.ds(ib * TB, TB)
    ks = pl.ds(k0, Kt)
    n_t = 1 + max(expand)
    nA = len(ac_list)

    def body(i, acc):
        subs = []
        for h in range(log_batch):
            s = pl.ds(((isp * n_chunks + i) * log_batch + h) * TS, TS)
            tu = [t_ref[c, cells, s] for c in range(n_t)]
            gk = [g_ref[m, ks, cells, s] for m in range(3)]  # (Kt, TB, TS)
            subs.append((s, [tu[e] for e in expand], gk))
        acc = list(acc)
        for dj in range(Kt):
            gj = [[g_ref[l, j0 + dj, cells, s] for l in range(3)]
                  for s, _, _ in subs]
            for ai, a in enumerate(ac_list):
                prod = None
                for h, (_, t, gk) in enumerate(subs):
                    g = gj[h]
                    u = [g[0] * t[a * 9 + m] + g[1] * t[a * 9 + 3 + m]
                         + g[2] * t[a * 9 + 6 + m] for m in range(3)]
                    inner = (gk[0] * u[0][None] + gk[1] * u[1][None]
                             + gk[2] * u[2][None])
                    prod = inner if prod is None else prod * inner
                acc[dj * nA + ai] = acc[dj * nA + ai] + jnp.sum(
                    jnp.log(prod), axis=2)
        return tuple(acc)

    acc = jax.lax.fori_loop(
        0, n_chunks, body,
        tuple(jnp.zeros((Kt, TB), jnp.float32) for _ in range(Kt * nA)),
    )
    for dj in range(Kt):
        for ai in range(nA):
            out_ref[isp, ai, j0 + dj, ks, cells] = acc[dj * nA + ai]


# kernel launch configuration, picked by benchmarks/pair_impl_ab.py's
# sweep on an H100 (PERF.md)
KERNEL_CFG = dict(kt_max=8, TB=4, TS=32, log_batch=2, num_warps=4,
                  min_programs=4096)


def _call_pair_kernel(t, g, V, expand, ac_list, Kt, tiles, sym_a=None,
                      interpret=False, cfg=None):
    """Run the kernel over kernel planes ac_list. t (C, B, S), g (3, Vp,
    B, S), both f32 with exactly neutral padding. Pads cells to a TB
    multiple and slots to a (TS * log_batch) multiple with neutral
    values, picks the slot split for occupancy, sums the split partials
    and reassembles (B, V, V, nAc), mirroring the sym_a plane from its
    upper triangle."""
    cfg = dict(KERNEL_CFG, **(cfg or {}))
    TB, TS, lb = cfg["TB"], cfg["TS"], cfg["log_batch"]
    C, B, S = t.shape
    Vp = g.shape[1]
    Bp = -(-B // TB) * TB
    step = TS * lb
    Sp = -(-S // step) * step
    if Bp != B or Sp != S:
        pad = ((0, 0), (0, Bp - B), (0, Sp - S))
        t = jnp.pad(t, pad, constant_values=1.0)
        g = jnp.concatenate(
            [jnp.pad(g[:1], ((0, 0), (0, 0)) + pad[1:], constant_values=1.0),
             jnp.pad(g[1:], ((0, 0), (0, 0)) + pad[1:])], axis=0)
    n_steps = Sp // step
    # split the slot axis across programs until the grid fills the card;
    # each split writes its own partial plane, summed below
    n_split = 1
    base = len(tiles) * (Bp // TB)
    while (base * n_split < cfg["min_programs"]
           and n_steps % (2 * n_split) == 0):
        n_split *= 2
    nA = len(ac_list)
    kernel = functools.partial(
        _pair_kernel, Kt=Kt, TB=TB, TS=TS, n_chunks=n_steps // n_split,
        ac_list=tuple(ac_list), expand=tuple(expand), log_batch=lb,
    )
    tile_j = jnp.asarray([jt for jt, _ in tiles], jnp.int32)
    tile_k = jnp.asarray([kt for _, kt in tiles], jnp.int32)
    out = pl.pallas_call(
        kernel,
        grid=(len(tiles), n_split, Bp // TB),
        out_shape=jax.ShapeDtypeStruct((n_split, nA, Vp, Vp, Bp),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=cfg["num_warps"]),
        interpret=interpret,
        name="demux_pair_search",
    )(tile_j, tile_k, t, g)
    out = jnp.sum(out, axis=0) if n_split > 1 else out[0]
    ab = out[:, :V, :V, :B]
    if sym_a in ac_list:
        # the lower triangle of a triangular plan is never written; every
        # (j, k) reads (min, max) from the upper triangle
        i = ac_list.index(sym_a)
        up = np.triu(np.ones((V, V), dtype=bool))[..., None]
        ab = ab.at[i].set(jnp.where(up, ab[i], jnp.swapaxes(ab[i], 0, 1)))
    return jnp.transpose(ab, (3, 1, 2, 0))


def _unpack_bits_dev(by, width, n):
    """(B, n*width/8) u8 -> (B, n) i32; width in {4, 6, 8}. Device twin
    of host.wire.unpack_bits (vector shifts, no gathers)."""
    B = by.shape[0]
    if width == 8:
        return by.astype(jnp.int32)[:, :n]
    if width == 4:
        b = by.astype(jnp.int32)
        return jnp.stack([b & 15, b >> 4], axis=-1).reshape(B, -1)[:, :n]
    b = by.astype(jnp.int32).reshape(B, -1, 3)
    q0 = b[..., 0] & 63
    q1 = ((b[..., 0] >> 6) | (b[..., 1] << 2)) & 63
    q2 = ((b[..., 1] >> 4) | (b[..., 2] << 4)) & 63
    q3 = b[..., 2] >> 2
    return jnp.stack([q0, q1, q2, q3], axis=-1).reshape(B, -1)[:, :n]


def _unpack_wire_v2(wbuf, meta, parts=False):
    """Decode the v2 packed wire (host.wire.pack_wire_block) on device:
    dict-index codes at 4/6/8 bits with the dense planes capped at U0
    and deeper lanes in the sparse (u16 pos, u8 code) tail;
    generalized-escape deltas.

    parts=False: returns (codes (B,S,U) i32 in WIRE-code space
    [0, n_real+1], idx, msk) — deep lanes reconstructed by a .at[].set
    scatter.
    parts=True: returns (dense (B,S,U0) i32, (tpos, tcode) or None,
    idx, msk) WITHOUT materializing the deep lanes — the fast front
    scatter-ADDS the tail into its count tensor instead (counts are all
    the math needs there), keeping its one-hot cost at U0 lanes even on
    PCR-hot blocks where U is 16+. msk derives from the dense lanes
    alone: the packer's marker rule guarantees a tail-only-visible slot
    carries the marker in lane 0.

    Callers map codes into LUT rows with jnp.minimum(codes, n_real) —
    the marker (n_real) and none (n_real+1) both land on the zero/none
    row."""
    _, S, U, U0, K2p, Kp, cw, dw, n_real, tw = meta
    B = wbuf.shape[0]
    none = jnp.int32(n_real + 1)
    off = 0
    ncb = S * U0 * cw // 8 // 4
    by = jax.lax.bitcast_convert_type(
        wbuf[:, :ncb], jnp.uint8).reshape(B, -1)
    dense = _unpack_bits_dev(by, cw, S * U0).reshape(B, S, U0)
    off = ncb
    tail_parts = None
    if K2p:
        if tw == 16:
            ntp = K2p * 2 // 4
            tpos = jax.lax.bitcast_convert_type(
                wbuf[:, off : off + ntp], jnp.uint16
            ).reshape(B, K2p).astype(jnp.int32)
        elif tw == 24:
            # (slot u16, lane u8) planes — rebuilt into the flat pos the
            # scatters consume; pad entries (slot == S) land on the same
            # S*(U-U0) OOB sentinel as tw == 32
            ns = K2p * 2 // 4
            nl = K2p // 4
            tslot = jax.lax.bitcast_convert_type(
                wbuf[:, off : off + ns], jnp.uint16
            ).reshape(B, K2p).astype(jnp.int32)
            tlane = jax.lax.bitcast_convert_type(
                wbuf[:, off + ns : off + ns + nl], jnp.uint8
            ).reshape(B, K2p).astype(jnp.int32)
            tpos = tslot * jnp.int32(U - U0) + tlane
            ntp = ns + nl
        else:  # i32 positions: lane index outgrew u8 (deep-U pathology)
            ntp = K2p
            tpos = wbuf[:, off : off + ntp]
        off += ntp
        ntc = K2p * cw // 8 // 4
        tcode = _unpack_bits_dev(
            jax.lax.bitcast_convert_type(
                wbuf[:, off : off + ntc], jnp.uint8).reshape(B, -1),
            cw, K2p)
        off += ntc
        tail_parts = (tpos, tcode)
    if dw == 16:
        ndb = S // 2
        d = jax.lax.bitcast_convert_type(
            wbuf[:, off : off + ndb], jnp.uint16
        ).reshape(B, S).astype(jnp.int32)
    else:
        ndb = S * dw // 8 // 4
        d = _unpack_bits_dev(
            jax.lax.bitcast_convert_type(
                wbuf[:, off : off + ndb], jnp.uint8).reshape(B, -1),
            dw, S)
    off += ndb
    base = wbuf[:, off]
    fix_pos = jax.lax.bitcast_convert_type(
        wbuf[:, off + 1 : off + 1 + Kp // 2], jnp.uint16
    ).reshape(B, Kp).astype(jnp.int32)
    fix_val = wbuf[:, off + 1 + Kp // 2 : off + 1 + Kp // 2 + Kp]
    d = d.at[jnp.arange(B)[:, None], fix_pos].add(fix_val)
    idx = base[:, None] + jnp.cumsum(d, axis=1)
    msk = jnp.any(dense != none, axis=-1)
    if parts:
        return dense, tail_parts, idx, msk
    if tail_parts is not None:
        tpos, tcode = tail_parts
        tail = jnp.full((B, S * (U - U0)), none, jnp.int32)
        # pad entries carry pos 0xFFFF > S*(U-U0)-1 (packer invariant)
        # and drop here
        tail = tail.at[jnp.arange(B)[:, None], tpos].set(tcode,
                                                         mode="drop")
        codes = jnp.concatenate(
            [dense, tail.reshape(B, S, U - U0)], axis=2)
    else:
        codes = dense
    return codes, idx, msk


def unpack_block_inputs(codes, idx, msk, wire):
    """Device-side unpack of the shipped block forms (see demux_block_fast_impl's docstring for the
    wire / delta-idx / packed-idx encodings and the 254-marker msk
    contract). Returns (codes (B,S,U) u8 — or i32 wire-code space for
    the v2 packed wire — idx (B,S) i32, msk (B,S) bool).
    """
    if wire is not None and wire[0] == "w2":
        return _unpack_wire_v2(codes, wire)
    if wire is not None:
        S, U, K = wire
        B = codes.shape[0]
        nc, nd = S * U // 4, S // 4
        bytes_c = jax.lax.bitcast_convert_type(codes[:, :nc], jnp.uint8)
        d8 = jax.lax.bitcast_convert_type(
            codes[:, nc : nc + nd], jnp.uint8
        ).reshape(B, S)
        base = codes[:, nc + nd]
        fix_pos = codes[:, nc + nd + 1 : nc + nd + 1 + K]
        fix_val = codes[:, nc + nd + 1 + K : nc + nd + 1 + 2 * K]
        codes = bytes_c.reshape(B, S, U)
        idx = (d8, base, fix_pos, fix_val)
    B, S, U = codes.shape
    if msk is None:
        msk = jnp.any(codes != jnp.uint8(255), axis=-1)
    if isinstance(idx, (tuple, list)):
        d, base, fix_pos, fix_val = idx
        d32 = d.astype(jnp.int32)
        # dummy fixes carry (pos=0, val=0): slot 0's delta is always 0
        # (idx[:,0] == base), so the scatter-add no-ops there
        d32 = d32.at[jnp.arange(B)[:, None], fix_pos].add(fix_val)
        idx = base[:, None].astype(jnp.int32) + jnp.cumsum(d32, axis=1)
    elif idx.shape[1] == S // 2 and S > 1:
        u = jax.lax.bitcast_convert_type(idx.astype(jnp.int32), jnp.uint32)
        pair = jnp.stack([u & 0xFFFF, u >> 16], axis=-1)
        idx = pair.reshape(B, S).astype(jnp.int32)
    else:
        idx = idx.astype(jnp.int32)
    return codes, idx, msk


def demux_block_fast_impl(
    codes, idx, msk, gps_table, gp0_table, w_ext, logf_ext,
    n_alpha, n_samples, pair_impl="xla", interpret=False, a0_sep=False,
    sym_a=None, expand=None, wire=None, kernel_cfg=None,
):
    """Fused fast-mode block step: codes -> (llk, llk0, llk_ab, llk_00).

    codes (B,S,U) uint8 per-UMI observation codes (255 = none);
    idx: slot SNP ids — (B,S) int-typed; or (B,S//2) int32 with two
    16-bit ids packed per lane (low half = even slot); or the u8-delta
    tuple (d (B,S) u8, base (B,) i32, fix_pos (B,K) i32, fix_val (B,K)
    i32) — ids are per-cell sorted, so idx = base + cumsum(d) with the
    rare deltas > 255 restored by the sparse fixes (engine
    _shrink_codes_blk; ~1B/slot instead of 2). All shipped forms are
    unpacked here; msk (B,S) bool, or None to derive it on device as
    any(codes != 255, -1) — exact under the shrunk-block contract
    (_shrink_codes_blk): masked-out slots carry all-255, and a valid slot
    with zero real codes (all its observations were allele==2; it still
    owes the uniform-GL term, cmd_cram_demuxlet.cpp:435) carries the
    reserved marker 254, which maps to the neutral LUT row like 255;
    gps_table (NS,V,3) f32; gp0_table (NS,3) f32;
    w_ext (NB+1, A*9) f32 pair LUT with a zero "none" row appended — or,
    with the static `expand` map set (dedup_channels), the column-deduped
    (NB+1, C) LUT;
    logf_ext (NB+1, 3) f32 singlet LUT with a zero row appended.

    wire: static (S, U, K) when `codes` is instead the single fused
    (B, S*U/4 + S/4 + 1 + 2K) int32 WIRE buffer carrying
    [codes-bytes | delta-bytes | base | fix_pos | fix_val] per row
    (engine _to_wire), idx/msk None; or the v2 meta tuple ("w2", ...)
    of host/wire.py. Little-endian byte packing both sides (bitcast
    round-trip pinned by tests).

    pair_impl: "xla" (plain contraction) or "triton" (the Pallas kernel;
    interpret=True runs it in the Pallas interpreter, for tests only).
    kernel_cfg: optional tuple of (key, value) overrides of KERNEL_CFG.

    Everything (gather, LUT sums, normalization, pair search, singlet
    contraction) runs on device in one jit — the host ships only the
    compact codes.
    """
    V, A = n_samples, n_alpha
    none_row = w_ext.shape[0] - 1
    C = w_ext.shape[1]
    R = w_ext.shape[0]
    ar = jnp.arange(R, dtype=jnp.int32)
    if expand is None:
        expand = tuple(range(A * 9))

    # Front: one-hot observation counts (R, B, S) -> ONE matmul against
    # the fused [pair|singlet] LUT, emitting lograw channel-leading (the
    # none row is all-zero so padding is exactly neutral: lograw == 0 ->
    # t == 1, gl uniform).
    if wire is not None and wire[0] == "w2":
        # v2 packed wire, PARTS decode: the one-hot runs over the U0
        # dense lanes only; deep-lane tail entries scatter-ADD straight
        # into the count tensor (f32 adds of small integers are exact,
        # so cnt_t is bit-identical to the dense reconstruction) — on
        # PCR-hot blocks (U 16+) this keeps the front cost flat.
        dense, tail, idx, msk = _unpack_wire_v2(codes, wire, parts=True)
        B, S, _U0 = dense.shape
        c = jnp.minimum(dense, jnp.int32(none_row))
        cnt_t = jnp.sum(
            (c[None] == ar[:, None, None, None]).astype(jnp.float32),
            axis=-1,
        )  # (R, B, S)
        if tail is not None:
            tpos, tcode = tail
            tslot = tpos // jnp.int32(wire[2] - wire[3])  # pos -> slot
            # pad entries drop twice over: tcode == none (row R, OOB on
            # axis 0) and tslot >= S (packer u16 invariant)
            cnt_t = cnt_t.at[
                tcode, jnp.arange(B)[:, None], tslot
            ].add(jnp.float32(1.0), mode="drop")
    else:
        codes, idx, msk = unpack_block_inputs(codes, idx, msk, wire)
        B, S, U = codes.shape
        # LUT-row mapping, shared by the u8 (v1) and dict-i32 (v2) code
        # spaces: real codes sit below none_row in both, and the
        # marker/none values (254/255 v1; n_real/n_real+1 v2) clamp onto
        # the zero none row.
        c = jnp.minimum(codes.astype(jnp.int32), jnp.int32(none_row))
        cnt_t = jnp.sum(
            (c[None] == ar[:, None, None, None]).astype(jnp.float32),
            axis=-1,
        )  # (R, B, S)
    wl = jnp.concatenate([w_ext, logf_ext], axis=1)  # (R, C+3)
    # HIGHEST: f32 matmuls would otherwise run in TF32 on the GPU (~1e-3
    # relative error on lograw); with one-hot counts HIGHEST reproduces
    # the per-UMI LUT sums to f32 rounding
    lograw = jnp.einsum(
        "nbs,nx->xbs", cnt_t, wl, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    t_x = _norm_t(lograw[:C], 0)  # (C, B, S)

    # pass-1 GL table (cmd_cram_demuxlet.cpp:428-452), channel-leading
    ls = lograw[C:]
    gl = jnp.exp(ls - jnp.max(ls, axis=0, keepdims=True))
    gl = gl / jnp.sum(gl, axis=0, keepdims=True)
    gl = gl + jnp.float32(1e-6)
    gl = gl / jnp.sum(gl, axis=0, keepdims=True)
    neutral3 = np.zeros((3, 1, 1), dtype=np.float32)
    neutral3[0] = 1.0
    gl = jnp.where(msk[None], gl, neutral3)  # masked slots -> exact log 0

    # per-slot genotype posteriors + gp0 in ONE 2D take, genotype-major
    # ((l, j) planes, the kernel's layout); the kernel route pads the
    # samples to its tile with neutral (1, 0, 0) columns. Masked slots
    # gather a NEUTRAL ROW appended at index NS.
    if pair_impl == "triton":
        cfg = dict(KERNEL_CFG, **dict(kernel_cfg or ()))
        Kt, Vp, tiles, ac_list = plan_tiles(V, A, a0_sep, sym_a,
                                            cfg["kt_max"])
    else:
        Vp = V
    NS = gps_table.shape[0]
    tab = jnp.transpose(gps_table, (0, 2, 1))  # (NS, 3, V)
    if Vp > V:
        pad = np.zeros((1, 3, Vp - V), dtype=np.float32)
        pad[:, 0] = 1.0
        tab = jnp.concatenate(
            [tab, jnp.broadcast_to(jnp.asarray(pad), (NS, 3, Vp - V))],
            axis=2)
    neutral_g = np.zeros((1, 3 * Vp + 3), dtype=np.float32)
    neutral_g[0, :Vp] = 1.0
    neutral_g[0, 3 * Vp] = 1.0
    gps_all = jnp.concatenate(
        [jnp.concatenate([tab.reshape(NS, 3 * Vp), gp0_table], axis=1),
         jnp.asarray(neutral_g)], axis=0
    )
    idx_n = jnp.where(msk, idx, jnp.int32(NS))
    g_all = jnp.transpose(jnp.take(gps_all, idx_n, axis=0), (2, 0, 1))
    g = g_all[: 3 * Vp].reshape(3, Vp, B, S)
    g0 = g_all[3 * Vp:]  # (3, B, S)

    # logical (B, S, ...) views for the plain contraction
    t_full = jnp.transpose(
        t_x[np.asarray(expand)].reshape(A, 3, 3, B, S), (3, 4, 0, 1, 2))
    llk_00 = pair_contract(
        jnp.transpose(g0, (1, 2, 0))[:, :, None], t_full)[:, 0, 0]
    if pair_impl == "triton":
        planes = []
        if a0_sep:
            # separable alpha = 0 plane: log(g_j . t0) + log(sum_m g_k[m])
            t0 = [t_x[expand[3 * l]] for l in range(3)]
            sd = jnp.sum(jnp.log(g[0] * t0[0] + g[1] * t0[1]
                                 + g[2] * t0[2]), axis=-1)[:V]  # (V, B)
            sg = jnp.sum(jnp.log(g[0] + g[1] + g[2]), axis=-1)[:V]
            planes.append((sd[:, None, :] + sg[None, :, :])
                          .transpose(2, 0, 1)[..., None])
        if ac_list:
            planes.append(_call_pair_kernel(
                t_x, g, V, expand, ac_list, Kt, tiles, sym_a=sym_a,
                interpret=interpret, cfg=cfg))
        llk_ab = (planes[0] if len(planes) == 1
                  else jnp.concatenate(planes, axis=3))
    else:
        llk_ab = pair_rows(jnp.transpose(g, (2, 3, 1, 0)), t_full, None,
                           auto_pair_chunk(B, S, V, A))

    # singlet pass (pass 1, :415-461): masked slots hit exact-neutral rows
    # (gl = gps = gp0 = (1,0,0) -> log 1 == 0), so no mask multiply
    contrib = jnp.log(g[0] * gl[0] + g[1] * gl[1] + g[2] * gl[2])
    llk = jnp.sum(contrib, axis=-1)[:V].T
    contrib0 = jnp.log(
        jnp.maximum(g0[0] * gl[0] + g0[1] * gl[1] + g0[2] * gl[2], 1e-30)
    )
    llk0 = jnp.sum(contrib0, axis=-1)
    return llk, llk0, llk_ab, llk_00


demux_block_fast = jax.jit(
    demux_block_fast_impl,
    static_argnames=("n_alpha", "n_samples", "pair_impl", "interpret",
                     "a0_sep", "sym_a", "expand", "wire", "kernel_cfg"),
)


def extend_luts(w, logf):
    """Append the zero 'none' row used by code 255."""
    w_ext = np.zeros((w.shape[0] + 1, w.shape[1]), dtype=np.float32)
    w_ext[:-1] = w
    logf_ext = np.zeros((logf.shape[0] + 1, 3), dtype=np.float32)
    logf_ext[:-1] = logf
    return w_ext, logf_ext
