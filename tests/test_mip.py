"""MIP tests: kernel equality (jax vs numpy golden), e2e oracle."""
import jax
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.ops.mip import (make_mip_preds_fn, mip_mode_count,
                                mip_predict_np, mip_size_id)
from uvg266_jax.oracle.decoder import decode_au


def test_size_ids():
    assert mip_size_id(4, 4) == 0
    assert mip_size_id(8, 8) == 1
    assert mip_size_id(16, 16) == 2
    assert mip_mode_count(8, 8) == 8
    assert mip_mode_count(32, 32) == 6


def test_mip_jax_equals_numpy():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (96, 128)).astype(np.int32)
    P = np.pad(src, ((1, 8), (1, 8)), mode="edge")
    for (w, h) in ((8, 8), (16, 16)):
        jfn = jax.jit(make_mip_preds_fn(w, h, 8))
        xs = np.array([16, w], dtype=np.int32)
        ys = np.array([16, h], dtype=np.int32)
        preds = np.asarray(jfn(src, xs, ys))
        nm = mip_mode_count(w, h)
        for b, (x, y) in enumerate(zip(xs, ys)):
            top = P[y, x + 1:x + 1 + w].astype(np.int64)
            left = P[y + 1:y + 1 + h, x].astype(np.int64)
            for t in (0, 1):
                for m in range(nm):
                    ref = mip_predict_np(top, left, w, h, m, bool(t), 8)
                    assert np.array_equal(ref, preds[b, t * nm + m])


def _src(w, h, seed=61):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(120 + 70 * np.sin((xx + yy) / 14) + 30 * np.cos(xx / 5)
                + rng.normal(0, 5, (h, w)), 0, 255).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                       (y[::2, ::2] // 3 + 70).astype(np.int32))


def test_mip_e2e_oracle_and_gain():
    src = _src(192, 128)
    out = {}
    for mip in (False, True):
        cfg = Config(width=192, height=128, qp=30, intra_period=1,
                     gop_len=0, mip=mip)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
        out[mip] = len(au) * 8
    assert out[True] != out[False], "MIP never chosen"


def test_mip_with_cclm_inter():
    cfg = Config(width=192, height=128, qp=32, mip=True, cclm=1)
    enc = Encoder(cfg)
    for i in range(2):
        for au, rec, fs, rl, _s in enc.feed(_src(192, 128, 70 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
