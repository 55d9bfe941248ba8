"""Transform skip + TS residual coding tests."""
import numpy as np

from uvg266_jax.bitstream.bitwriter import (Bitstream, BitstreamReader,
                                            strip_emulation_prevention)
from uvg266_jax.bitstream.cabac import Cabac, CabacDecoder
from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.hls.ts_residual import (decode_ts_residual,
                                        encode_ts_residual)
from uvg266_jax.oracle.decoder import decode_au


def test_tsrc_roundtrip_blocks():
    rng = np.random.default_rng(3)
    for trial in range(40):
        for (w, h) in ((4, 4), (8, 8), (16, 16)):
            lv = rng.integers(-8, 9, (h, w)).astype(np.int64)
            lv[rng.random((h, w)) < 0.5] = 0
            if trial % 7 == 0:
                lv = np.abs(lv) * 3          # exercise the remainder pass
            if trial % 11 == 0:
                lv[:] = 0
                lv[h - 1, w - 1] = 1         # inferred-sig corner case
            cab = Cabac(Bitstream())
            cab.init_contexts(27, 2)
            encode_ts_residual(cab, lv)
            cab.encode_bin_trm(1)
            cab.finish()
            cab.stream.align_zero()
            dec = CabacDecoder(BitstreamReader(
                strip_emulation_prevention(cab.stream.bytes())))
            dec.init_contexts(27, 2)
            out = decode_ts_residual(dec, w, h)
            assert np.array_equal(out, lv), (trial, w, h)


def _screen_src(w, h, seed=41):
    rng = np.random.default_rng(seed)
    y = np.full((h, w), 235, dtype=np.int32)
    for _ in range(150):
        x0, y0 = rng.integers(0, w - 12), rng.integers(0, h - 4)
        y[y0:y0 + 3, x0:x0 + rng.integers(3, 12)] = rng.choice([16, 80, 180])
    return FramePlanes(y, (y[::2, ::2] // 2 + 30).astype(np.int32),
                       (y[::2, ::2] // 3 + 60).astype(np.int32))


def test_trskip_e2e_gain_on_screen_content():
    src = _screen_src(192, 128)
    out = {}
    for ts in (False, True):
        cfg = Config(width=192, height=128, qp=30, intra_period=1,
                     gop_len=0, trskip_enable=ts, trskip_max_size=3)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
        mse = np.mean((rec.y - src.y.astype(np.int64)) ** 2)
        out[ts] = (len(au) * 8, 10 * np.log10(255 ** 2 / mse))
    (b0, p0), (b1, p1) = out[False], out[True]
    assert b1 < b0 and p1 >= p0, f"TS not engaging: {out}"


def test_trskip_inter():
    cfg = Config(width=192, height=128, qp=32, trskip_enable=True,
                 trskip_max_size=3)
    enc = Encoder(cfg)
    for i in range(2):
        for au, rec, fs, rl, _s in enc.feed(_screen_src(192, 128, 50 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
            assert np.array_equal(drec.y, rec.y)
