"""IBC (intra block copy): encoder search + syntax round-trip.

Parity targets: skip/ibc_flag signaling (encode_coding_tree.c:1471-1560),
IBC merge candidates + per-CTU-row IBC HMVP (inter.c:1250-1349,
:1841-1899), full-pel MVD (uvg_encode_inter_prediction_unit CU_IBC arms),
copy reconstruction (ibc_recon_cu, inter.c:614-676), validity window
(search_ibc.c:92-101).  Conformance against reference-binary --ibc
streams is in test_ref_decode.py.
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import FramePlanes, SliceEncoder, ibc_bv_valid
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.oracle.decoder import decode_au


def test_bv_validity_window():
    # source must be fully left or fully above, inside the CTU row,
    # within 192 columns, non-positive components
    assert ibc_bv_valid(64, 64, 16, 16, -16, 0)
    assert ibc_bv_valid(64, 80, 16, 16, 0, -16)
    assert not ibc_bv_valid(64, 64, 16, 16, 0, -16)    # above CTU row top
    assert not ibc_bv_valid(64, 64, 16, 16, -8, -8)    # overlaps
    assert not ibc_bv_valid(64, 64, 16, 16, 16, 0)     # positive
    assert not ibc_bv_valid(64, 64, 16, 16, 0, -64)    # above CTU row
    assert ibc_bv_valid(64, 96, 16, 16, 0, -32)        # inside CTU row
    assert not ibc_bv_valid(256, 0, 16, 16, -224, 0)   # beyond buffer
    assert not ibc_bv_valid(16, 0, 16, 16, -32, 0)     # off frame left


def sc_frame(w, h, seed=3):
    """Screen content: repeated 16x16 glyph tiles."""
    rng = np.random.RandomState(seed)
    glyphs = [rng.randint(0, 255, (16, 16)) for _ in range(6)]
    lay = np.random.RandomState(9)
    y = np.zeros((h, w), np.int32)
    for by in range(h // 16):
        for bx in range(w // 16):
            y[by * 16:(by + 1) * 16,
              bx * 16:(bx + 1) * 16] = glyphs[lay.randint(0, 6)]
    u = np.full((h // 2, w // 2), 110, np.int32)
    v = np.full((h // 2, w // 2), 140, np.int32)
    return FramePlanes(y, u, v)


def encode_decode(src, w, h, qp=27, ibc=2, **kw):
    base = dict(width=w, height=h, qp=qp, gop_len=0, intra_period=1,
                sao_type=0, alf_type=0, deblock_enable=False,
                rdoq_enable=False, signhide_enable=True, dep_quant=False,
                wpp=False, ibc=ibc)
    base.update(kw)
    cfg = Config(**base)
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=qp)
    enc = SliceEncoder(cfg, ctrl, open_loop=True)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    np.testing.assert_array_equal(dec_rec.v, rec.v)
    assert info["checksum_ok"] is True
    return au


def test_ibc_screen_content_roundtrip_and_gain():
    """IBC must be selected on screen content, round-trip bit-exactly,
    and reduce the bitrate vs the same encode without IBC."""
    import uvg266_jax.control.encoder as em
    src = sc_frame(256, 128)
    won = [0]
    orig = em.try_ibc_cu

    def spy(cu, *a, **kw):
        orig(cu, *a, **kw)
        if cu.type == 3:
            won[0] += 1
    em.try_ibc_cu = spy
    try:
        au_ibc = encode_decode(src, 256, 128, ibc=2)
    finally:
        em.try_ibc_cu = orig
    au_off = encode_decode(src, 256, 128, ibc=0)
    assert won[0] > 0, "no CU selected IBC on exact-repeat content"
    assert len(au_ibc) < len(au_off), \
        f"IBC did not reduce bits ({len(au_ibc)} vs {len(au_off)})"


def test_ibc_with_filters():
    src = sc_frame(128, 128, seed=5)
    encode_decode(src, 128, 128, ibc=2, deblock_enable=True, sao_type=3)


def test_ibc_with_rdoq():
    src = sc_frame(128, 64, seed=6)
    encode_decode(src, 128, 64, ibc=2, rdoq_enable=True)


def _sc_clip(w, h, n, seed=3):
    """Screen-content clip: scrolling glyph layout (IBC-friendly in both
    intra and inter frames)."""
    rng = np.random.RandomState(seed)
    glyphs = [rng.randint(0, 255, (16, 16)).astype(np.int32)
              for _ in range(6)]
    lay = np.random.RandomState(1)
    grid = lay.randint(0, 6, (h // 16 + 4, w // 16))
    frames = []
    for t in range(n):
        y = np.zeros((h, w), np.int32)
        for by in range(h // 16):
            for bx in range(w // 16):
                y[by * 16:(by + 1) * 16, bx * 16:(bx + 1) * 16] = \
                    glyphs[grid[(by + t) % grid.shape[0], bx]]
        u = np.full((h // 2, w // 2), 110, np.int32)
        v = np.full((h // 2, w // 2), 140, np.int32)
        frames.append(FramePlanes(y, u, v))
    return frames


def test_ibc_lowdelay_inter_slices():
    """IBC in P slices (search_ibc.c + the P/B ibc_flag syntax): CUs
    must select IBC in inter frames, the stream must oracle round-trip,
    and IBC must reduce bits on screen content."""
    import uvg266_jax.control.encoder as em
    from uvg266_jax.consts import SliceType
    from uvg266_jax.control.encoder import Encoder

    w, h, n = 128, 128, 4
    frames = _sc_clip(w, h, n)
    base = dict(width=w, height=h, qp=30, gop_len=4, gop_lowdelay=True,
                intra_period=64, ref_frames=1, sao_type=0, alf_type=0,
                deblock_enable=False, rdoq_enable=False, wpp=False)

    won_inter = [0]
    orig = em.try_ibc_cu

    def spy(cu, *a, **kw):
        t0 = cu.type
        orig(cu, *a, **kw)
        if cu.type == 3 and t0 == 2:
            won_inter[0] += 1

    em.try_ibc_cu = spy
    try:
        cfg = Config(ibc=2, **base)
        enc = Encoder(cfg)
        outs = []
        for f in frames:
            outs.extend(enc.feed(f))
        outs.extend(enc.flush())
    finally:
        em.try_ibc_cu = orig
    dec_dpb = []
    for i, (au, rec, fs, refs, _s) in enumerate(outs):
        if fs.slicetype == SliceType.I:
            dec_dpb = []
        dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=dec_dpb)
        assert info["checksum_ok"], f"frame {i}"
        np.testing.assert_array_equal(dec_rec.y, rec.y)
        dec_rec.motion = rec.motion
        dec_dpb.insert(0, dec_rec)
        del dec_dpb[max(1, cfg.ref_frames):]
    assert won_inter[0] > 0, "IBC never replaced an inter CU"
    # bits win vs ibc off
    enc2 = Encoder(Config(ibc=0, **base))
    outs2 = []
    for f in frames:
        outs2.extend(enc2.feed(f))
    outs2.extend(enc2.flush())
    b_ibc = sum(len(au) for (au, *_r) in outs)
    b_off = sum(len(au) for (au, *_r) in outs2)
    assert b_ibc < b_off, (b_ibc, b_off)


def test_ibc_bv_refinement_near_match():
    """Local BV walk (search_ibc.c:300-700 analog): period-17 texture has
    its repeat displacement (-17, 0) OFF the exact-match hash grid and
    off every whole-block seed; only the refinement walk can land on it
    from the (-16, 0) seed."""
    from uvg266_jax.consts import SliceType
    from uvg266_jax.control.cu import CuInfo, CuMap
    from uvg266_jax.control.encoder import (IbcFrameSearch, try_ibc_cu,
                                            reconstruct_intra_cu)
    from uvg266_jax.control.inter_cand import HmvpIbcState
    from uvg266_jax.control.params import EncoderControl

    rng = np.random.RandomState(7)
    w = h = 128
    tile = rng.randint(0, 255, (17, 17))
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(tile[yy % 17, xx % 17] + rng.randint(-1, 2, (h, w)),
                0, 255).astype(np.int32)
    src = FramePlanes(y, np.full((64, 64), 110, np.int32),
                      np.full((64, 64), 140, np.int32))
    cfg = Config(width=w, height=h, qp=32, gop_len=0, intra_period=1,
                 wpp=False, ibc=2, sao_type=0, deblock_enable=False)
    ctrl = EncoderControl(cfg)
    rec = FramePlanes(np.zeros((h, w), np.int32),
                      np.zeros((64, 64), np.int32),
                      np.zeros((64, 64), np.int32))
    coded = np.zeros((32, 32), dtype=bool)
    cu_map = CuMap(w, h)
    hmvp_ibc = HmvpIbcState()
    search = IbcFrameSearch(src)
    won = 0
    # commit intra 16x16 CUs in coding order within the first CTU row,
    # offering IBC after each — after a few columns the walk must find
    # the (-15, 0)-ish repeat
    for cx in range(0, 64, 16):
        cu = CuInfo(cx, 0, 16, 16, type=1, intra_mode=0,
                    intra_mode_chroma=0, qp=32)
        reconstruct_intra_cu(cu, rec, coded, ctrl, 32, src,
                             signhide=True)
        try_ibc_cu(cu, rec, coded, ctrl, 32, src, 100.0, search, cu_map,
                   hmvp_ibc)
        if cu.type == 3:
            won += 1
            bv = (cu.mv[0][0] >> 4, cu.mv[0][1] >> 4)
            assert bv[0] % 17 == 0 and bv[1] % 17 == 0, bv
        cu_map.set_cu(cu)
    assert won > 0, "refinement walk never found the period-17 repeat"
