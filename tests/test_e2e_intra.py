"""End-to-end all-intra encode -> oracle decode -> bit-exact recon match.

The analogue of the reference's VTM-decode shell tests (tests/util.sh:53):
our spec-mirror decoder plays the VTM role since no external decoder binary
exists in this environment.
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.consts import SliceType
from uvg266_jax.control.encoder import FramePlanes, SliceEncoder
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.oracle.decoder import decode_au


def bare_config(w, h, qp=27, **kw):
    return Config(width=w, height=h, qp=qp, gop_len=0, intra_period=1,
                  sao_type=0, alf_type=0, deblock_enable=False,
                  rdoq_enable=False, signhide_enable=True, dep_quant=False,
                  wpp=False, **kw)


def synth_frame(w, h, seed=0):
    """Synthetic test content: gradients + structure + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 255 // max(w - 1, 1) + yy * 96 // max(h - 1, 1)) % 256
    y = (y + 24 * np.sin(xx / 7.0) + 16 * np.cos(yy / 5.0)).astype(np.int64)
    y += rng.integers(-8, 8, size=(h, w))
    y = np.clip(y, 0, 255).astype(np.int32)
    u = np.clip(128 + (xx[::2, ::2] - w // 2) // 4
                + rng.integers(-4, 4, size=(h // 2, w // 2)), 0, 255).astype(np.int32)
    v = np.clip(128 + (yy[::2, ::2] - h // 2) // 4
                + rng.integers(-4, 4, size=(h // 2, w // 2)), 0, 255).astype(np.int32)
    return FramePlanes(y, u, v)


def run_e2e(w, h, qp=27, seed=0, open_loop=True):
    cfg = bare_config(w, h, qp)
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=qp)
    src = synth_frame(w, h, seed)
    enc = SliceEncoder(cfg, ctrl, open_loop=open_loop)
    au, rec = enc.encode_frame(fs, src)
    assert len(au) > 0

    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    assert info["headers_ok"]
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    np.testing.assert_array_equal(dec_rec.v, rec.v)
    assert info["checksum_ok"] is True

    # encoding must be lossy-but-close: sanity PSNR bound on real area
    err = (rec.y[:h, :w] - src.y.astype(np.int64)) ** 2
    mse = err.mean()
    psnr = 10 * np.log10(255 * 255 / max(mse, 1e-9))
    assert psnr > 28, f"luma PSNR too low: {psnr:.1f} dB"
    return au, psnr


def test_e2e_128x128():
    run_e2e(128, 128)


def test_e2e_192x128_qp32():
    run_e2e(192, 128, qp=32, seed=3)


def test_e2e_nonmultiple_of_64():
    # 176x144 (QCIF): CTU grid has implicit boundary splits
    run_e2e(176, 144, qp=27, seed=1)


def test_e2e_small_frame_high_qp():
    run_e2e(64, 64, qp=37, seed=2)


def test_e2e_low_qp_near_lossless():
    au, psnr = run_e2e(64, 64, qp=8, seed=4)
    assert psnr > 45


def test_e2e_closed_loop_search():
    # reference-faithful sequential search path stays green
    run_e2e(64, 64, qp=27, seed=5, open_loop=False)


def test_e2e_with_deblock():
    cfg = bare_config(128, 128, 27)
    cfg.deblock_enable = True
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=27)
    src = synth_frame(128, 128, 9)
    enc = SliceEncoder(cfg, ctrl)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    assert info["checksum_ok"] is True


def test_e2e_with_sao():
    cfg = bare_config(192, 128, 32)
    cfg.sao_type = 3
    cfg.deblock_enable = True
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=32)
    src = synth_frame(192, 128, 12)
    enc = SliceEncoder(cfg, ctrl)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    np.testing.assert_array_equal(dec_rec.v, rec.v)
    assert info["checksum_ok"] is True


def test_e2e_with_mts():
    cfg = bare_config(128, 128, 30)
    cfg.mts = 1
    cfg.deblock_enable = True
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=30)
    src = synth_frame(128, 128, 21)
    enc = SliceEncoder(cfg, ctrl)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    np.testing.assert_array_equal(dec_rec.u, rec.u)
    assert info["checksum_ok"] is True


def test_e2e_10bit():
    cfg = bare_config(128, 64, 30)
    cfg.input_bitdepth = 10
    cfg.deblock_enable = True
    cfg.sao_type = 3
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=30)
    rng = np.random.default_rng(30)
    src = FramePlanes(
        np.clip(512 + rng.integers(-300, 300, (64, 128)), 0, 1023).astype(np.int32),
        np.full((32, 64), 512, np.int32),
        np.full((32, 64), 512, np.int32))
    enc = SliceEncoder(cfg, ctrl)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    assert info["checksum_ok"] is True


def test_e2e_monochrome():
    from uvg266_jax.consts import ChromaFormat
    cfg = bare_config(128, 64, 30)
    cfg.input_format = ChromaFormat.CSP_400
    cfg.deblock_enable = True
    cfg.sao_type = 3
    ctrl = EncoderControl(cfg)
    fs = FrameState(qp=30)
    rng = np.random.default_rng(8)
    src = FramePlanes(
        np.clip(128 + rng.integers(-90, 90, (64, 128)), 0, 255).astype(np.int32),
        None, None)
    enc = SliceEncoder(cfg, ctrl)
    au, rec = enc.encode_frame(fs, src)
    dec_rec, info = decode_au(au, cfg, ctrl, fs)
    np.testing.assert_array_equal(dec_rec.y, rec.y)
    assert info["checksum_ok"] is True
