"""ISP (intra sub-partitions): geometry rules + e2e round-trips.

Parity targets: uvg_get_isp_split_dim/_num/_loc
(/root/reference/src/intra.c:1469-1537), uvg_can_use_isp
(/root/reference/src/intra.c:1751 — TR_MAX_WIDTH is 32, global.h:190),
ISP syntax (encode_coding_tree.c:1093-1106, :1667-1687) and the
sequential sub-TU reconstruction (intra.c:1826-1885).  Conformance
against reference-binary --isp streams is in test_ref_decode.py.
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import FramePlanes, SliceEncoder
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.oracle.decoder import decode_au
from uvg266_jax.ops import isp


def test_can_use_isp():
    # >= 16 samples per sub-block and both dims <= 32 (TR_MAX_WIDTH)
    assert not isp.can_use_isp(4, 4)
    assert isp.can_use_isp(4, 8)
    assert isp.can_use_isp(8, 8)
    assert isp.can_use_isp(32, 32)
    assert not isp.can_use_isp(64, 32)
    assert not isp.can_use_isp(32, 64)
    assert not isp.can_use_isp(64, 64)


def test_split_geometry():
    # 8x8 HOR: 4 rows of 8x2; VER: 4 cols of 2x8 (transform blocks)
    assert isp.isp_tu_locs(0, 0, 8, 8, isp.ISP_HOR) == [
        (0, 0, 8, 2), (0, 2, 8, 2), (0, 4, 8, 2), (0, 6, 8, 2)]
    assert isp.isp_tu_locs(0, 0, 8, 8, isp.ISP_VER) == [
        (0, 0, 2, 8), (2, 0, 2, 8), (4, 0, 2, 8), (6, 0, 2, 8)]
    # 4x8 VER: each sub-block needs >= 16 samples -> only 2 splits
    assert isp.isp_split_num(4, 8, isp.ISP_VER, True) == 2
    assert isp.isp_tu_locs(0, 0, 4, 8, isp.ISP_VER) == [
        (0, 0, 2, 8), (2, 0, 2, 8)]
    # 4x16 VER: 4 one-wide transform blocks, 4-wide prediction blocks
    assert isp.isp_tu_locs(0, 0, 4, 16, isp.ISP_VER) == [
        (0, 0, 1, 16), (1, 0, 1, 16), (2, 0, 1, 16), (3, 0, 1, 16)]
    assert isp.isp_split_loc(0, 0, 4, 16, 1, isp.ISP_VER, False) == \
        (0, 0, 4, 16)
    # 32x32: always 4 splits
    assert isp.isp_split_num(32, 32, isp.ISP_HOR, True) == 4


def test_lfnst_compat():
    # every TU must be >= 4x4 for LFNST
    assert isp.can_use_isp_with_lfnst(16, 16, isp.ISP_HOR)
    assert not isp.can_use_isp_with_lfnst(8, 8, isp.ISP_HOR)   # 8x2 TUs
    assert not isp.can_use_isp_with_lfnst(4, 16, isp.ISP_VER)  # 1x16 TUs
    assert isp.can_use_isp_with_lfnst(32, 16, isp.ISP_VER)     # 8x16


def bare_config(w, h, qp=27, **kw):
    base = dict(width=w, height=h, qp=qp, gop_len=0, intra_period=1,
                sao_type=0, alf_type=0, deblock_enable=False,
                rdoq_enable=False, signhide_enable=True, dep_quant=False,
                wpp=False, isp=True)
    base.update(kw)
    return Config(**base)


def synth_frame(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 255 // max(w - 1, 1) + yy * 96 // max(h - 1, 1)) % 256
    # strong diagonal texture: makes directional modes + ISP win often
    y = (y + 40 * np.sin((xx + 2 * yy) / 5.0)).astype(np.int64)
    y += rng.integers(-6, 6, size=(h, w))
    y = np.clip(y, 0, 255).astype(np.int32)
    u = np.clip(128 + (xx[::2, ::2] - w // 2) // 4, 0, 255).astype(np.int32)
    v = np.clip(128 + (yy[::2, ::2] - h // 2) // 4, 0, 255).astype(np.int32)
    return FramePlanes(y, u, v)


def run_e2e(w, h, qp=27, seed=0, **kw):
    cfg = bare_config(w, h, qp, **kw)
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=qp)
    src = synth_frame(w, h, seed)
    enc = SliceEncoder(cfg, ctrl, open_loop=True)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    assert info["headers_ok"]
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    np.testing.assert_array_equal(dec_rec.v, rec.v)
    assert info["checksum_ok"] is True
    return enc


def test_e2e_isp_basic():
    run_e2e(128, 128)


def test_e2e_isp_selected(monkeypatch):
    """The encoder must actually pick ISP somewhere on textured content."""
    import uvg266_jax.control.encoder as enc_mod
    selected = []
    orig = enc_mod.try_isp_modes

    def spy(cu, *a, **kw):
        orig(cu, *a, **kw)
        if cu.isp_mode:
            selected.append((cu.x, cu.y, cu.w, cu.h, cu.isp_mode))
    monkeypatch.setattr(enc_mod, "try_isp_modes", spy)
    cfg = bare_config(128, 128, 27)
    ctrl = EncoderControl(cfg)
    src = synth_frame(128, 128, 1)
    enc = SliceEncoder(cfg, ctrl, open_loop=True)
    au, rec = enc.encode_frame(FrameState(qp=27), src)
    assert selected, "no CU chose ISP on diagonal-texture content"
    dec_rec, info = decode_au(au, cfg, ctrl, FrameState(qp=27))
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    assert info["checksum_ok"] is True


@pytest.mark.parametrize("tool", ["mts", "lfnst", "rdoq", "filters"])
def test_e2e_isp_tools(tool):
    kw = {"mts": dict(mts=1), "lfnst": dict(lfnst=True),
          "rdoq": dict(rdoq_enable=True),
          "filters": dict(deblock_enable=True, sao_type=3)}[tool]
    run_e2e(128, 64, qp=30, seed=2, **kw)


def test_one_and_two_point_transforms():
    """1xN/2xN ISP sub-TUs exercise the 1- and 2-point DCT2 paths."""
    from uvg266_jax.ops.transforms import fwd_transform_2d, inv_transform_2d
    rng = np.random.default_rng(3)
    for (w, h) in [(1, 16), (16, 1), (2, 8), (8, 2), (1, 32), (2, 16)]:
        resid = rng.integers(-64, 64, size=(h, w)).astype(np.int64)
        co = fwd_transform_2d(resid, type_hor=0, type_ver=0, bitdepth=8)
        back = inv_transform_2d(co, type_hor=0, type_ver=0, bitdepth=8)
        err = np.abs(back - resid).max()
        assert err <= 1, f"{w}x{h}: max err {err}"
