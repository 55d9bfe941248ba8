"""MRL (multi-reference-line intra) tests."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.ops.intra import (build_reference, build_reference_mrl,
                                  predict_intra, predict_intra_mrl)
from uvg266_jax.oracle.decoder import decode_au


def test_mrl_line0_equivalence_shape():
    """predict_intra_mrl output shapes and ranges are sane for all
    angular modes on both reference lines."""
    rng = np.random.default_rng(2)
    plane = rng.integers(0, 256, (64, 64)).astype(np.int32)
    mask = np.ones((16, 16), dtype=bool)
    for mrl in (1, 2):
        refs = build_reference_mrl(plane, mask, 16, 16, 8, 8, 64, 64, 8, mrl)
        for mode in (1, 2, 18, 34, 50, 66):
            pr = predict_intra_mrl(mode, 8, 8, refs, mrl, 8)
            assert pr.shape == (8, 8)
            assert pr.min() >= 0 and pr.max() <= 255


def _src(w, h, seed=91):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(110 + 70 * np.sin((2 * xx + yy) / 9)
                + rng.normal(0, 4, (h, w)), 0, 255).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                       (y[::2, ::2] // 3 + 70).astype(np.int32))


def test_mrl_e2e_gain_and_oracle():
    src = _src(192, 128)
    out = {}
    for mrl in (False, True):
        cfg = Config(width=192, height=128, qp=30, intra_period=1,
                     gop_len=0, mrl=mrl)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
        out[mrl] = len(au) * 8
    assert out[True] != out[False], "MRL never engaged"


def test_mrl_with_mip_and_inter():
    cfg = Config(width=192, height=128, qp=32, mrl=True, mip=True)
    enc = Encoder(cfg)
    for i in range(2):
        for au, rec, fs, rl, _s in enc.feed(_src(192, 128, 95 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
            assert np.array_equal(drec.y, rec.y)
