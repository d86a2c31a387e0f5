#!/usr/bin/env python
"""Decompose wire-v2 bytes per block on the realistic profile (host-only,
deterministic — no device involved).

Quantifies the two known paddings of the sparse UMI tail + delta fixes:
  * pow2 rounding: each block's K2p/Kp round up to a power of two
    (bounded compiled-shape count, host/wire.py _split_tail/_pack_deltas);
  * registry ratchet: engine._pack_reg harmonizes (U0, K2p, Kp) per
    (S, U) shape key by MAX over blocks seen so far, so one deep block
    raises every later same-key block's padded tail.

Prints per-block section bytes and the run totals under three layouts:
  shipped   what the engine actually sends (registry floors applied)
  own-pow2  per-block pow2 of its OWN need (no ratchet; what a
            per-block meta would ship at the cost of ~5-10 s remote jit
            per distinct meta — CLAUDE.md dead end)
  exact     the no-padding information floor of this layout

Usage: python benchmarks/probe_tail_pad.py [n_cells] [snps_per_cell]
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import benchmarks.e2e_demux as E

E.N_CELLS = int(sys.argv[1]) if len(sys.argv) > 1 else 40_960
E.S_PER_CELL = int(sys.argv[2]) if len(sys.argv) > 2 else 1000


def main():
    rng = np.random.default_rng(0)
    csr = E.synth_csr_realistic(rng)
    gps = rng.dirichlet(np.ones(3), size=(E.NSNPS, E.NV))

    from demuxlet_jax.host.csr import build_codes_block
    from demuxlet_jax.models.engine import DemuxEngine

    eng = DemuxEngine(gps, [0.0, 0.5], cell_block=2048, mode="fast")
    cfg = eng._wire_cfg_for(csr)
    assert cfg is not None
    print(f"# cfg: n_dict={cfg.n_real} code_w={cfg.code_w} "
          f"delta_w={cfg.delta_w} u_cap={cfg.u_cap}")
    blocks, pads = eng._blocks(csr.nbcs, csr)

    tot = dict(shipped=0, own=0, exact=0, codes=0, tail=0, deltas=0, fix=0)
    n_metas = set()
    for bi, cells in enumerate(blocks):
        pad = pads[bi] if pads is not None else None
        out = eng._prep_codes_blk(csr, cells, pad=pad)
        buf, meta, _ = out
        assert meta[0] == "w2", meta
        _, S, U, U0, K2p, Kp, cw, dw, n_real, tw = meta
        n_metas.add(meta[1:])
        B = buf.shape[0]
        shipped = buf.shape[1] * 4
        codes_b = S * U0 * cw // 8
        tail_b = (K2p * tw // 8 + K2p * cw // 8) if K2p else 0
        delta_b = (S * dw // 8) if dw != 16 else S * 2
        fix_b = 4 + 2 * Kp + 4 * Kp
        assert codes_b + tail_b + delta_b + fix_b == shipped, (
            codes_b, tail_b, delta_b, fix_b, shipped)

        # own need (no registry): recompute the block's real K2/Kfix
        kw = {} if pad is None else {"pad_slots_to": pad}
        codes, idx, msk = build_codes_block(
            csr, cells, cap_bq=eng.cap_bq, pad_cells_to=eng.cell_block,
            **kw)
        wc = cfg.code_lut()[codes]
        deep = wc[:, :, U0:]
        tail_counts = (deep != cfg.none).reshape(B, -1).sum(axis=1)
        K2 = int(tail_counts.max()) if B else 0
        d = np.zeros_like(idx, dtype=np.int64)
        d[:, 1:] = np.diff(idx.astype(np.int64), axis=1)
        d[~msk] = 0
        Ew = (1 << dw) - 1
        over = (d > Ew).sum(axis=1)
        K = int(over.max())

        def pow2(n, floor):
            p = floor
            while p < n:
                p *= 2
            return p

        own_tail = ((pow2(K2, 16) * (tw // 8 + cw / 8)) if K2 else 0)
        own_fix = 4 + 6 * pow2(K, 8)
        own = codes_b + own_tail + delta_b + own_fix
        exact = (codes_b + float(tail_counts.mean()) * (tw // 8 + cw / 8)
                 + delta_b + 4 + 6 * float(over.mean()))
        tot["shipped"] += shipped * B
        tot["own"] += own * B
        tot["exact"] += exact * B
        tot["codes"] += codes_b * B
        tot["tail"] += tail_b * B
        tot["deltas"] += delta_b * B
        tot["fix"] += fix_b * B
        print(f"blk{bi:3d} S={S:5d} U={U} U0={U0} K2p={K2p:5d} "
              f"(need {K2:5d}, mean {tail_counts.mean():7.1f}) "
              f"Kp={Kp:4d} (need {K:4d}) B/cell={shipped}")

    n = csr.nbcs
    print(f"\n# metas compiled: {len(n_metas)}")
    print(f"# section B/barcode: codes {tot['codes']/n:.0f} "
          f"tail {tot['tail']/n:.0f} deltas {tot['deltas']/n:.0f} "
          f"fix {tot['fix']/n:.0f}")
    print(f"# shipped {tot['shipped']/n:.0f} B/barcode | own-pow2 "
          f"{tot['own']/n:.0f} | exact floor {tot['exact']/n:.0f}")


if __name__ == "__main__":
    main()
