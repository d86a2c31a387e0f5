"""Wire-format v2 (host/wire.py + pallas_pair device decode): packing
roundtrips, config choice, and engine-level parity against the v1 wire.
"""

import os

import numpy as np
import pytest

from demuxlet_jax.host import wire as W


def _rand_block(rng, B=36, S=160, U=4, ncodes=12):
    """A build_codes_block-shaped (codes, idx, msk) triple: sorted slot
    ids, sparse deep lanes, 255 holes, some empty-valid (254-class)
    slots. Valid slots form a per-row PREFIX (build_codes_block pads at
    the end), which the delta encoding's masked-zeroing assumes."""
    code_vals = np.sort(rng.choice(200, size=ncodes, replace=False))
    codes = np.full((B, S, U), 255, dtype=np.uint8)
    nvalid = rng.integers(S // 4, S + 1, size=B)
    nvalid[-2:] = 0  # padded cells
    msk = np.arange(S)[None, :] < nvalid[:, None]
    occ = 1 + (rng.random((B, S)) < 0.2) + 3 * (rng.random((B, S)) < 0.02)
    occ = np.minimum(occ, U)
    for u in range(U):
        lane = (occ > u) & msk
        vals = code_vals[rng.integers(0, ncodes, size=(B, S))]
        hole = rng.random((B, S)) < 0.1  # dropped allele==2 holes
        codes[:, :, u] = np.where(lane & ~hole, vals, 255)
    idx = np.cumsum(rng.integers(1, 40, size=(B, S)), axis=1).astype(
        np.int32
    )
    idx = np.where(msk, idx, 0)
    return codes, idx, msk, code_vals


def _cfg(code_vals, code_w=None, delta_w=8, u_cap=2):
    dc = tuple(int(c) for c in code_vals)
    return W.WireCfg(
        dict_codes=dc,
        code_w=code_w or W._width_for(len(dc) + 2),
        delta_w=delta_w,
        u_cap=u_cap,
        adaptive=False,  # tests pin the layout under test
    )


def _device_unpack(wire_buf, meta):
    import jax.numpy as jnp

    from demuxlet_jax.ops.pallas_pair import unpack_block_inputs

    c, idx, msk = unpack_block_inputs(jnp.asarray(wire_buf), None, None,
                                      meta)
    return np.asarray(c), np.asarray(idx), np.asarray(msk)


def _expected_codes(codes, msk, cfg, U0):
    """lut-mapped codes + the two marker rules (empty-valid slots;
    tail-only-visible slots when deep lanes split off)."""
    lut = cfg.code_lut()
    want = lut[codes].astype(np.int32)
    empty = msk & (want == cfg.none).all(axis=-1)
    b, s = np.nonzero(empty)
    want[b, s, 0] = cfg.marker
    U = codes.shape[2]
    if U0 < U:
        dense_none = (want[:, :, :U0] == cfg.none).all(axis=-1)
        deep_any = (want[:, :, U0:] != cfg.none).any(axis=-1)
        b, s = np.nonzero(dense_none & deep_any)
        want[b, s, 0] = cfg.marker
    return want


@pytest.mark.parametrize("code_w,delta_w,u_cap", [
    (4, 4, 1),
    (4, 8, 2),
    (6, 6, 2),
    (8, 4, 4),  # u_cap == U: no tail sections
])
def test_wire_v2_roundtrip(code_w, delta_w, u_cap):
    """pack_wire_block -> device unpack restores the exact wire-code
    tensor (dict space incl. marker/none), slot ids, and mask."""
    rng = np.random.default_rng(5)
    ncodes = {4: 12, 6: 50, 8: 80}[code_w]
    codes, idx, msk, code_vals = _rand_block(rng, ncodes=ncodes)
    cfg = _cfg(code_vals, code_w=code_w, delta_w=delta_w, u_cap=u_cap)
    buf, meta = W.pack_wire_block(codes, idx, msk, cfg)

    want = _expected_codes(codes, msk, cfg, meta[3])
    got_c, got_idx, got_msk = _device_unpack(buf, meta)
    np.testing.assert_array_equal(got_c, want)
    np.testing.assert_array_equal(got_msk, msk)
    # ids compare where the mask holds (masked slots decode to the
    # running id, exactly like the v1 delta stream)
    np.testing.assert_array_equal(got_idx[msk], idx[msk])


def test_wire_v2_deep_tail_entries():
    """Deep lanes (>= u_cap) survive the sparse-tail roundtrip at their
    exact lane positions; holes in deep lanes need no entries."""
    rng = np.random.default_rng(9)
    codes, idx, msk, code_vals = _rand_block(rng, U=8, ncodes=10)
    cfg = _cfg(code_vals, u_cap=2)
    buf, meta = W.pack_wire_block(codes, idx, msk, cfg)
    assert meta[3] == 2 and meta[4] >= 8  # U0, K2p
    got_c, _, _ = _device_unpack(buf, meta)
    want = _expected_codes(codes, msk, cfg, meta[3])
    np.testing.assert_array_equal(got_c, want)
    # the wire must actually be smaller than dense u8 lanes
    dense_bytes = codes.shape[0] * codes.shape[1] * codes.shape[2]
    assert buf.shape[1] * 4 * codes.shape[0] < dense_bytes


def test_wire_v2_tail_width_24_roundtrip():
    """Big-S deep-U blocks where the flat tail space outgrows u16 but
    the lane index fits u8 ship (slot u16, lane u8) planes (tw == 24,
    3 B/entry vs 4 for flat i32); the device rebuilds flat positions —
    codes, ids, and mask must roundtrip exactly, incl. pad sentinels."""
    rng = np.random.default_rng(17)
    codes, idx, msk, code_vals = _rand_block(rng, B=12, S=1280, U=64,
                                             ncodes=10)
    # force real deep lanes: a few PCR-hot slots per row
    for b in range(10):
        hot = rng.choice(200, size=3, replace=False)
        codes[b, hot, :40] = code_vals[rng.integers(0, 10, size=(3, 40))]
        msk[b, hot] = True
        idx[b] = np.cumsum(rng.integers(1, 4, size=1280))
    cfg = _cfg(code_vals, u_cap=1)
    buf, meta = W.pack_wire_block(codes, idx, msk, cfg)
    U0, tw = meta[3], meta[9]
    assert tw == 24 and 1280 * (64 - U0) > 0xFFFF and 64 - U0 <= 255
    got_c, got_idx, got_msk = _device_unpack(buf, meta)
    want = _expected_codes(codes, msk, cfg, U0)
    np.testing.assert_array_equal(got_c, want)
    np.testing.assert_array_equal(got_msk, msk)
    np.testing.assert_array_equal(got_idx[msk], idx[msk])


def test_pack_bits_roundtrip():
    rng = np.random.default_rng(3)
    for w, hi in ((4, 16), (6, 64), (8, 256)):
        a = rng.integers(0, hi, size=(8, 192)).astype(np.uint8)
        p = W.pack_bits(a, w)
        assert p.shape[1] == 192 * w // 8
        np.testing.assert_array_equal(W.unpack_bits(p, w, 192), a)


def test_choose_cfg_widths():
    """Dict width tracks the distinct-code count; delta width tracks the
    sampled gap distribution; u_cap tracks occupancy."""
    from demuxlet_jax.host.csr import CsrPileup

    rng = np.random.default_rng(1)
    n_cells, spc = 64, 200
    # 6 distinct codes (allele 0/1 x bq {37, 12, 23}), occ mostly 1,
    # small gaps -> expect cw=4, dw=4, u_cap small
    obs = []
    for c in range(n_cells):
        snps = np.cumsum(rng.integers(1, 10, size=spc))
        for s in snps:
            k = 1 + (rng.random() < 0.1)
            for _ in range(k):
                obs.append((c, s, rng.integers(0, 2),
                            rng.choice([12, 23, 37])))
    obs = np.asarray(obs, dtype=np.int64)
    csr = CsrPileup.from_arrays(
        ["S0"], int(obs[:, 1].max()) + 1,
        ["B%d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8),
    )
    cfg = W.choose_cfg(csr, cap_bq=40)
    assert len(cfg.dict_codes) == 6
    assert cfg.code_w == 4
    assert cfg.delta_w == 4
    assert cfg.u_cap in (1, 2)

    # wide uniform BQs + wide gaps -> 6-bit dict, 8-bit deltas
    obs2 = []
    for c in range(n_cells):
        snps = np.cumsum(rng.integers(30, 200, size=60))
        for s in snps:
            obs2.append((c, s, rng.integers(0, 2),
                         rng.integers(13, 41)))
    obs2 = np.asarray(obs2, dtype=np.int64)
    csr2 = CsrPileup.from_arrays(
        ["S0"], int(obs2[:, 1].max()) + 1,
        ["B%d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs2[:, 0], obs2[:, 1], obs2[:, 2].astype(np.uint8),
        obs2[:, 3].astype(np.uint8),
    )
    cfg2 = W.choose_cfg(csr2, cap_bq=40)
    assert cfg2.code_w == 6
    assert cfg2.delta_w == 8
    assert cfg2.u_cap == 1


def test_pack_from_shrunk_matches_pack_wire_block():
    """The native-prep route (v1 shrunk form -> v2 wire) emits the same
    bytes as the direct packer."""
    rng = np.random.default_rng(11)
    codes, idx, msk, code_vals = _rand_block(rng)
    cfg = _cfg(code_vals, delta_w=4, u_cap=2)
    buf_a, meta_a = W.pack_wire_block(codes, idx, msk, cfg)

    # build the v1 shrunk form the way engine._shrink_codes_blk does
    codes254 = codes.copy()
    empty = msk & (codes == 255).all(axis=-1)
    b, s = np.nonzero(empty)
    codes254[b, s, 0] = 254
    d = np.zeros_like(idx, dtype=np.int64)
    d[:, 1:] = np.diff(idx.astype(np.int64), axis=1)
    d[~msk] = 0
    d[:, 1:][~msk[:, 1:]] = 0
    over = d > 255
    n_over = over.sum(axis=1)
    K = max(int(n_over.max()), 1)
    Kp = 8
    while Kp < K:
        Kp *= 2
    fix_pos = np.zeros((codes.shape[0], Kp), dtype=np.int32)
    fix_val = np.zeros((codes.shape[0], Kp), dtype=np.int32)
    rows, cols = np.nonzero(over)
    slot = np.concatenate(
        [np.arange(k) for k in n_over if k]
    ).astype(np.int64) if n_over.sum() else np.zeros(0, np.int64)
    fix_pos[rows, slot] = cols.astype(np.int32)
    fix_val[rows, slot] = (d[rows, cols] - 255).astype(np.int32)
    d8 = np.minimum(d, 255).astype(np.uint8)
    base = idx[:, 0].astype(np.int32)

    buf_b, meta_b = W.pack_from_shrunk(codes254, d8, base, fix_pos,
                                       fix_val, cfg)
    assert meta_a == meta_b
    np.testing.assert_array_equal(buf_a, buf_b)


@pytest.mark.parametrize("mode", ["fast"])
def test_engine_wire_v2_matches_v1(tmp_path, mode):
    """Engine-level parity: the same pileup through the v1 and v2 wires
    (the compact path is fast mode's): agreement to kernel tolerance with
    identical decisions."""
    import jax

    from demuxlet_jax.host.csr import CsrPileup
    from demuxlet_jax.models import decision as D
    from demuxlet_jax.models.engine import DemuxEngine

    rng = np.random.default_rng(17)
    n_cells, NS, V = 48, 300, 3
    obs = []
    for c in range(n_cells):
        snps = np.sort(rng.choice(NS, size=40, replace=False))
        for j, s in enumerate(snps):
            # PCR-hot slots (~1 per cell, depth ~18) force deep UMI
            # lanes: the fast front's tail scatter-add runs at U >= 16
            depth = 1 + (rng.random() < 0.3) * int(rng.integers(1, 4))
            if j == 7:
                depth += int(rng.integers(12, 20))
            for _ in range(depth):
                obs.append((c, s, int(rng.random() < 0.5),
                            int(rng.integers(13, 41))))
    obs = np.asarray(obs, dtype=np.int64)
    csr = CsrPileup.from_arrays(
        [f"S{i}" for i in range(V)], NS,
        ["B%04d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8),
    )
    gps = rng.dirichlet(np.ones(3), size=(NS, V))
    grid = [0.0, 0.5]

    def run(wire_env):
        os.environ["DEMUX_WIRE"] = wire_env
        try:
            eng = DemuxEngine(gps, grid, cell_block=16, mode=mode)
            llks, llk0s, comp = eng.run_compact(csr, doublet_prior=0.5)
            return llks, llk0s, comp, eng.h2d_bytes
        finally:
            os.environ.pop("DEMUX_WIRE", None)

    l1, l01, c1, bytes1 = run("v1")
    l2, l02, c2, bytes2 = run("v2")
    assert bytes2 < bytes1, (bytes2, bytes1)
    np.testing.assert_allclose(l1, l2, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(c1.i_sing1, c2.i_sing1)
    np.testing.assert_array_equal(c1.best_flat, c2.best_flat)
    np.testing.assert_allclose(c1.sing_col, c2.sing_col, rtol=0, atol=2e-3)


def test_native_pack_v2_matches_python():
    """dmx_pack2_fill emits BYTE-identical wire buffers + identical meta
    to the Python packer across widths, deep tails, escapes, holes,
    markers, and padded rows — on CSR data (the production input)."""
    native = pytest.importorskip("demuxlet_jax.native.prep")
    if not native.available():
        pytest.skip("native prep not built")
    from demuxlet_jax.host.csr import CsrPileup, build_codes_block

    rng = np.random.default_rng(23)
    n_cells, NS = 70, 5000
    obs = []
    for c in range(n_cells):
        # gene-run clusters (tiny deltas + big jumps), deep hot slots,
        # allele==2 holes
        pos = 0
        for _g in range(rng.integers(3, 30)):
            pos += int(rng.integers(1, 400))
            for k in range(int(rng.integers(1, 8))):
                s = pos + k
                depth = 1 + int(rng.random() < 0.2) + (
                    int(rng.integers(4, 30)) if rng.random() < 0.01 else 0)
                for _ in range(depth):
                    obs.append((c, s, int(rng.integers(0, 3)),
                                int(rng.integers(13, 41))))
    obs = np.asarray(obs, dtype=np.int64)
    obs[:, 1] = np.minimum(obs[:, 1], NS - 1)
    csr = CsrPileup.from_arrays(
        ["S0"], NS, ["B%03d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8),
    )
    for cfg in (
        W.choose_cfg(csr, 40),
        W.WireCfg(W.choose_cfg(csr, 40).dict_codes, 6, 16, 2, False),
        W.WireCfg(W.choose_cfg(csr, 40).dict_codes, 8, 6, 1, False),
    ):
        for floors in (None, (2, 64, 32)):
            cells = list(range(n_cells))
            got = native.pack_block_v2(csr, cells, cfg, cap_bq=40,
                                       floors=floors)
            assert got is not None
            buf_n, meta_n = got
            codes_blk = build_codes_block(csr, cells, cap_bq=40)
            buf_p, meta_p = W.pack_wire_block(*codes_blk, cfg,
                                              floors=floors)
            assert meta_n == meta_p, (cfg, floors, meta_n, meta_p)
            np.testing.assert_array_equal(buf_n, buf_p,
                                          err_msg=str((cfg, floors)))


def test_wire_v2_slot_extent_fallback():
    """Blocks whose slot axis exceeds u16 addressing (S > 65535) must
    DECLINE the v2 wire (both packers return None; the engine then
    falls back to the v1 format, which ships i32 fix positions) rather
    than truncate positions mod 65536 (review r5 #1)."""
    n_slots = 66_000
    B = 32
    codes = np.full((B, 66_048, 1), 255, dtype=np.uint8)
    codes[0, :n_slots, 0] = 3
    idx = np.zeros((B, 66_048), dtype=np.int32)
    idx[0, :n_slots] = np.arange(n_slots)
    msk = np.zeros((B, 66_048), dtype=bool)
    msk[0, :n_slots] = True
    cfg = _cfg([3, 44])
    assert W.pack_wire_block(codes, idx, msk, cfg) is None

    native = pytest.importorskip("demuxlet_jax.native.prep")
    if not native.available():
        pytest.skip("native prep not built")
    from demuxlet_jax.host.csr import CsrPileup

    snps = np.arange(n_slots, dtype=np.int64)
    csr = CsrPileup.from_arrays(
        ["S0"], n_slots, ["B%02d" % i for i in range(B)],
        np.zeros(B), np.zeros(B), np.zeros(B),
        np.zeros(n_slots, np.int64), snps,
        np.zeros(n_slots, np.uint8), np.full(n_slots, 30, np.uint8),
    )
    assert native.pack_block_v2(csr, list(range(B)), cfg,
                                cap_bq=40) is None


def test_engine_python_packer_matches_native(tmp_path):
    """DEMUX_NO_NATIVE_PREP=1 routes the engine through
    build_codes_block + pack_wire_block; fast-mode results must be
    BIT-identical to the native pack_block_v2 route (the wire bytes are
    pinned identical by test_native_pack_v2_matches_python; this checks
    the engine plumbing end-to-end)."""
    import jax

    from demuxlet_jax.host.csr import CsrPileup
    from demuxlet_jax.models.engine import DemuxEngine

    rng = np.random.default_rng(31)
    n_cells, NS, V = 40, 250, 3
    obs = []
    for c in range(n_cells):
        snps = np.sort(rng.choice(NS, size=30, replace=False))
        for j, s in enumerate(snps):
            depth = 1 + (j == 5) * int(rng.integers(6, 12))
            for _ in range(depth):
                obs.append((c, s, int(rng.random() < 0.5),
                            int(rng.integers(13, 41))))
    obs = np.asarray(obs, dtype=np.int64)
    csr = CsrPileup.from_arrays(
        [f"S{i}" for i in range(V)], NS,
        ["B%04d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8),
    )
    gps = rng.dirichlet(np.ones(3), size=(NS, V))

    native = pytest.importorskip("demuxlet_jax.native.prep")
    if not native.available():
        pytest.skip("native prep not built — parity arm would be vacuous")

    def run(no_native):
        if no_native:
            os.environ["DEMUX_NO_NATIVE_PREP"] = "1"
        try:
            # the native module caches load state; reset between runs
            from demuxlet_jax.native import prep as nprep

            nprep._LIB = None
            nprep._LOAD_FAILED = False
            eng = DemuxEngine(gps, [0.0, 0.5], cell_block=16,
                              mode="fast")
            return eng.run_compact(csr, doublet_prior=0.5)
        finally:
            os.environ.pop("DEMUX_NO_NATIVE_PREP", None)
            nprep._LIB = None
            nprep._LOAD_FAILED = False

    l_n, l0_n, c_n = run(False)
    l_p, l0_p, c_p = run(True)
    np.testing.assert_array_equal(l_n, l_p)
    np.testing.assert_array_equal(l0_n, l0_p)
    for k in c_n.__dict__:
        np.testing.assert_array_equal(getattr(c_n, k), getattr(c_p, k),
                                      err_msg=k)
