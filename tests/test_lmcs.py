"""LMCS (luma mapping with chroma scaling): LUT invariants, APS syntax
round-trip, encoder<->oracle bit-exactness, intra + inter.

Reference parity: /root/reference/src/reshape.c (preanalysis :121,
codeword allocation :495/:840, normative LUT construction :1257, chroma
scale :1452, APS syntax :1360).
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.consts import SliceType
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.ops.lmcs import (build_luts, derive_frame_luts,
                                 scale_chroma_residual_fwd,
                                 scale_chroma_residual_inv)
from uvg266_jax.oracle.decoder import decode_au


def _content(w, h, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(60 + 50 * np.sin(xx / 19) * np.cos(yy / 23)
                + (yy > h // 2) * 60
                + rng.integers(-10, 10, (h, w)) * (xx < w // 2),
                16, 235).astype(np.int32)
    u = np.clip(128 + 20 * np.sin(xx[::2, ::2] / 13), 0, 255).astype(np.int32)
    v = np.clip(128 - 20 * np.cos(yy[::2, ::2] / 17), 0, 255).astype(np.int32)
    return y, u, v


def test_lut_construction_invariants():
    y, u, v = _content(128, 128)
    luts = derive_frame_luts(y, u, v, 8, 27)
    assert luts is not None, "preanalysis disabled reshaping on easy content"
    # mapped pivots monotone non-decreasing, LUTs in range
    assert np.all(np.diff(luts.pivot) >= 0)
    assert luts.fwd_lut.min() >= 0 and luts.fwd_lut.max() <= 255
    assert np.all(np.diff(luts.fwd_lut) >= 0), "fwd LUT must be monotone"
    # inv(fwd(x)) == x wherever the bin has full slope resolution: error
    # bounded by half the codeword ratio
    x = np.arange(256)
    rt = luts.inv_lut[luts.fwd_lut[x]]
    active = (x // 16 >= luts.min_bin) & (x // 16 <= luts.max_bin)
    assert np.abs(rt[active] - x[active]).max() <= 8


def test_chroma_residual_scale_roundtrip():
    rng = np.random.default_rng(3)
    res = rng.integers(-80, 80, (16, 16))
    for adj in (1024, 1500, 2048, 3000):
        f = scale_chroma_residual_fwd(res, adj, 8)
        r = scale_chroma_residual_inv(f, adj, 8)
        # quantization of the scale round-trip is bounded by the step
        assert np.abs(r - res).max() <= max(1, adj // 1024 + 1)


def test_aps_syntax_roundtrip():
    from uvg266_jax.bitstream.bitwriter import (Bitstream, BitstreamReader,
                                                strip_emulation_prevention)
    from uvg266_jax.hls.header_parse import parse_lmcs_aps
    from uvg266_jax.hls.headers import write_lmcs_aps
    y, u, v = _content(128, 128)
    luts = derive_frame_luts(y, u, v, 8, 27)
    bs = Bitstream()
    write_lmcs_aps(bs, luts, True)
    rd = BitstreamReader(strip_emulation_prevention(bs.bytes()))
    aps = parse_lmcs_aps(rd)
    assert aps.min_bin == luts.min_bin and aps.max_bin == luts.max_bin
    np.testing.assert_array_equal(aps.bin_cw(8), luts.bin_cw)
    # parsed codewords rebuild identical LUTs
    luts2 = build_luts(aps.bin_cw(8), 8, crs_offset=aps.crs_offset)
    np.testing.assert_array_equal(luts2.fwd_lut, luts.fwd_lut)
    np.testing.assert_array_equal(luts2.inv_lut, luts.inv_lut)
    np.testing.assert_array_equal(luts2.chroma_scale, luts.chroma_scale)


def _cfg(w, h, qp=27, **kw):
    base = dict(width=w, height=h, qp=qp, gop_len=0, intra_period=1,
                sao_type=3, alf_type=0, deblock_enable=True,
                rdoq_enable=False, signhide_enable=True, dep_quant=False,
                wpp=False, lmcs_enable=True)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("tool_kw", [
    {},                                           # plain
    {"jccr": 1},                                  # joint Cb-Cr residual
    {"cclm": 1},                                  # CCLM chroma from mapped luma
    {"rdoq_enable": True},
])
def test_lmcs_intra_roundtrip(tool_kw):
    w = h = 128
    y, u, v = _content(w, h)
    cfg = _cfg(w, h, **tool_kw)
    enc = Encoder(cfg)
    au, rec, fs, refs = enc.encode_frame(0, FramePlanes(y, u, v))
    assert fs.lmcs is not None, "reshaper unexpectedly disabled"
    dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=[])
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    np.testing.assert_array_equal(dec_rec.v, rec.v)
    assert info["checksum_ok"] is True


def test_lmcs_nonaligned_frame():
    w, h = 176, 144
    y, u, v = _content(w, h)
    cfg = _cfg(w, h)
    enc = Encoder(cfg)
    au, rec, fs, refs = enc.encode_frame(0, FramePlanes(y, u, v))
    assert fs.lmcs is not None
    dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=[])
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    assert info["checksum_ok"] is True


def test_lmcs_lowdelay_roundtrip():
    # run_lp asserts bit-exact recon + checksum per AU with an
    # independent decoder DPB
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_e2e_inter import run_lp
    stats = run_lp(128, 128, n_frames=4, qp=30, lmcs_enable=True)
    assert stats[0][2] == SliceType.I
    assert all(t == SliceType.P for _b, _p, t in stats[1:])
    # inter must still converge under reshaping
    assert stats[3][0] < stats[0][0] * 0.5


def test_lmcs_disabled_for_extreme_histograms():
    # >3% of pixels in the lowest bin trips the preanalysis guard
    rng = np.random.default_rng(9)
    y = rng.integers(0, 14, (64, 64)).astype(np.int32)
    u = np.full((32, 32), 128, np.int32)
    v = np.full((32, 32), 128, np.int32)
    assert derive_frame_luts(y, u, v, 8, 27) is None
