"""Rectangular slices (--slices tiles): one VCL NAL per tile.

Mirrors the reference's UVG_SLICES_TILES mode
(/root/reference/src/encoder_state-bitstream.c:1248 'independent'
slices: every slice carries a full PH-in-SH header and no entry
points; tiles map to slices in decode order).
"""
import os
import subprocess

import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.ref_decoder import decode_stream

REF_BIN = "/tmp/uvgbuild/uvg266"

W, H = 320, 192


def _clip(n=4, seed=9):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(n):
        y = np.clip(60 + 50 * np.sin((xx + 3 * t) / 21.0)
                    + 30 * np.cos((yy - 2 * t) / 13.0)
                    + rng.integers(-5, 5, (H, W)), 0, 255)
        u = np.clip(120 + 15 * np.sin((xx[::2, ::2] + 4 * t) / 29.0)
                    + rng.integers(-3, 3, (H // 2, W // 2)), 0, 255)
        v = np.clip(133 + 11 * np.cos((yy[::2, ::2] - t) / 23.0)
                    + rng.integers(-3, 3, (H // 2, W // 2)), 0, 255)
        frames.append(FramePlanes(y.astype(np.int32), u.astype(np.int32),
                                  v.astype(np.int32)))
    return frames


def _encode(slices: int, frames):
    cfg = Config(width=W, height=H, qp=32, gop_len=4, gop_lowdelay=True,
                 tiles_width_count=2, tiles_height_count=2, slices=slices,
                 sao_type=3, deblock_enable=True)
    enc = Encoder(cfg)
    outs = []
    for f in frames:
        outs += enc.feed(f)
    outs += enc.flush()
    return b"".join(t[0] for t in outs)


def _vcl_counts(data: bytes):
    i, counts = 0, []
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        k = j + 3
        t = (data[k + 1] >> 3) & 0x1F
        if t <= 11:
            counts.append(t)
        i = k
    return counts


def test_own_stream_slices_roundtrip():
    frames = _clip()
    d0 = _encode(0, frames)
    d1 = _encode(1, frames)
    # 4 frames x 4 tiles = 16 VCL NALs in slices mode, 4 otherwise
    assert len(_vcl_counts(d0)) == 4
    assert len(_vcl_counts(d1)) == 16
    f0 = decode_stream(d0)
    f1 = decode_stream(d1)
    assert all(f.checksum_ok for f in f0)
    assert all(f.checksum_ok for f in f1)
    for a, b in zip(f0, f1):
        assert np.array_equal(a.rec.y, b.rec.y)
        assert np.array_equal(a.rec.u, b.rec.u)


@pytest.mark.skipif(not os.path.exists(REF_BIN),
                    reason="reference binary not available")
def test_reference_slices_stream_decodes(tmp_path):
    clip = tmp_path / "c.yuv"
    with open(clip, "wb") as f:
        for fr in _clip(3):
            f.write(fr.y.astype(np.uint8).tobytes())
            f.write(fr.u.astype(np.uint8).tobytes())
            f.write(fr.v.astype(np.uint8).tobytes())
    out = tmp_path / "o.bin"
    subprocess.run(
        [REF_BIN, "-i", str(clip), "--input-res", f"{W}x{H}",
         "--frames", "3", "-q", "32", "--preset", "ultrafast",
         "--no-wpp", "--threads", "0", "--tiles", "2x2",
         "--slices", "tiles", "-o", str(out)],
        check=True, capture_output=True)
    frames = decode_stream(out.read_bytes())
    assert len(frames) == 3
    assert all(f.checksum_ok for f in frames)
