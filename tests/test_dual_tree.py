"""Dual tree (separate luma/chroma partitioning in intra slices)."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def _src(w, h, seed=23):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(110 + 60 * np.sin(xx / 13) + 50 * np.cos(yy / 9)
                + rng.normal(0, 8, (h, w)), 0, 255).astype(np.int32)
    u = np.clip(200 - y[::2, ::2] * 0.4
                + rng.normal(0, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
    v = np.clip(y[::2, ::2] * 0.35 + 40
                + rng.normal(0, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
    return FramePlanes(y, u, v)


def _roundtrip(cfg, src):
    enc = Encoder(cfg)
    (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
    drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
    assert info["headers_ok"] and info["checksum_ok"]
    assert np.array_equal(drec.y, rec.y)
    assert np.array_equal(drec.u, rec.u)
    assert np.array_equal(drec.v, rec.v)
    return au


def test_dual_tree_intra():
    cfg = Config(width=192, height=128, qp=30, intra_period=1, gop_len=0,
                 dual_tree=1)
    _roundtrip(cfg, _src(192, 128))


def test_dual_tree_boundary_frame():
    # non-CTU-multiple dims exercise implicit chroma-tree splits
    cfg = Config(width=200, height=120, qp=32, intra_period=1, gop_len=0,
                 dual_tree=1)
    _roundtrip(cfg, _src(200, 120, seed=31))


def test_dual_tree_with_mip_and_inter():
    cfg = Config(width=192, height=128, qp=32, dual_tree=1, mip=True)
    enc = Encoder(cfg)
    for i in range(2):   # IDR (dual) + P (single tree)
        for au, rec, fs, rl, _s in enc.feed(_src(192, 128, 40 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
            assert np.array_equal(drec.y, rec.y)


def test_dual_tree_cclm_gain_and_roundtrip():
    """CCLM inside the chroma tree: decodable and saves chroma bits on
    luma-correlated content (the per-CTU luma-then-chroma recon order
    makes the co-located luma available on both sides)."""
    rng = np.random.default_rng(17)
    W, H = 192, 128
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    y = np.clip(110 + 55 * np.sin(xx / 11) + 45 * np.cos(yy / 7)
                + rng.normal(0, 14, (H, W)), 0, 255).astype(np.int32)
    u = np.clip(y[::2, ::2] * 0.4 + 50
                + rng.normal(0, 4, (H // 2, W // 2)), 0, 255).astype(np.int32)
    v = np.clip(230 - y[::2, ::2] * 0.35
                + rng.normal(0, 4, (H // 2, W // 2)), 0, 255).astype(np.int32)
    src = FramePlanes(y, u, v)
    bits = {}
    for cclm in (0, 1):
        cfg = Config(width=W, height=H, qp=30, intra_period=1, gop_len=0,
                     dual_tree=1, cclm=cclm)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.u, rec.u)
        assert np.array_equal(drec.v, rec.v)
        bits[cclm] = len(au) * 8
    assert bits[1] < bits[0], f"CCLM saved no bits in dual tree: {bits}"
