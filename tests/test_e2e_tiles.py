"""End-to-end tile tests: tiled encode -> oracle decode round-trip.

Tiles break prediction (intra refs, merge/AMVP availability, HMVP) at
tile boundaries and put each tile in its own CABAC substream with
entry-point offsets (the reference's tile support: encoderstate.c tile
scan + encoder.c tile geometry). Our loop filters run across tile
boundaries (pps_loop_filter_across_tiles_enabled_flag=1), unlike the
reference which disables them.
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def mkframe(w, h, i, maxv=255):
    rng = np.random.default_rng(100 + i)
    y = (rng.integers(0, maxv + 1, (h, w)) * 0.3 + maxv * 0.4).astype(np.int32)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(y + ((xx + 2 * yy + i * 5) % 89), 0, maxv).astype(np.int32)
    u = (y[::2, ::2] // 2 + maxv // 8).astype(np.int32)
    v = (y[::2, ::2] // 3 + maxv // 4).astype(np.int32)
    return FramePlanes(y, u, v)


def roundtrip(cfg, n_frames, maxv=255):
    enc = Encoder(cfg)
    results = []
    for i in range(n_frames):
        results.extend(enc.feed(mkframe(cfg.width, cfg.height, i, maxv)))
    results.extend(enc.flush())
    assert len(results) == n_frames
    for au, rec, fs, rl, src in results:
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"]
        assert info["checksum_ok"], f"checksum poc={fs.poc}"
        assert np.array_equal(drec.y, rec.y)
        if rec.u is not None:
            assert np.array_equal(drec.u, rec.u)
            assert np.array_equal(drec.v, rec.v)
    return results


def test_tiles_allintra_2x2():
    cfg = Config(width=256, height=128, qp=27, intra_period=1, gop_len=0,
                 tiles_width_count=2, tiles_height_count=2)
    roundtrip(cfg, 2)


def test_tiles_geometry_uneven():
    # 320x192 -> 5x3 CTUs; 2x2 tiles gives uneven 2/3 and 1/2 splits
    cfg = Config(width=320, height=192, qp=30, intra_period=1, gop_len=0,
                 tiles_width_count=2, tiles_height_count=2)
    enc = Encoder(cfg)
    ctrl = enc.ctrl
    assert ctrl.tile_col_bd == [0, 2, 5]
    assert ctrl.tile_row_bd == [0, 1, 3]
    assert len(ctrl.ctu_scan_order()) == 15
    assert sorted(ctrl.ctu_scan_order()) == sorted(
        (x, y) for y in range(3) for x in range(5))
    roundtrip(cfg, 1)


def test_tiles_inter_lowdelay():
    cfg = Config(width=256, height=128, qp=30,
                 tiles_width_count=2, tiles_height_count=1)
    roundtrip(cfg, 3)


def test_tiles_ra_bslices():
    cfg = Config(width=192, height=128, qp=32, gop_len=8, gop_lowdelay=False,
                 tiles_width_count=2, tiles_height_count=1)
    roundtrip(cfg, 9)


def test_tiles_10bit():
    cfg = Config(width=192, height=128, qp=27, intra_period=1, gop_len=0, input_bitdepth=10,
                 tiles_width_count=2, tiles_height_count=1)
    roundtrip(cfg, 1, maxv=1023)


def test_tiles_disable_wpp():
    cfg = Config(width=256, height=128, qp=27, wpp=True,
                 tiles_width_count=2, tiles_height_count=1)
    enc = Encoder(cfg)
    assert not cfg.wpp          # tiles win; combined mode unsupported
    roundtrip(cfg, 1)
