"""Joint Cb-Cr residual coding (mode 2) tests."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def _src(w, h, seed=71):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(120 + 60 * np.sin(xx / 11) + 40 * np.cos(yy / 8)
                + rng.normal(0, 7, (h, w)), 0, 255).astype(np.int32)
    u = np.clip(128 + (y[::2, ::2] - 120) * 0.5
                + rng.normal(0, 2, (h // 2, w // 2)), 0, 255).astype(np.int32)
    v = np.clip(128 - (y[::2, ::2] - 120) * 0.45
                + rng.normal(0, 2, (h // 2, w // 2)), 0, 255).astype(np.int32)
    return FramePlanes(y, u, v)


def test_jccr_e2e_saves_bits():
    src = _src(192, 128)
    out = {}
    for j in (0, 1):
        cfg = Config(width=192, height=128, qp=30, intra_period=1,
                     gop_len=0, jccr=j)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.u, rec.u)
        assert np.array_equal(drec.v, rec.v)
        out[j] = len(au) * 8
    assert out[1] < out[0], f"jccr never saved bits: {out}"


def test_jccr_with_signhide_and_rdoq():
    cfg = Config(width=192, height=128, qp=32, intra_period=1, gop_len=0,
                 jccr=1, rdoq_enable=True, signhide_enable=True)
    enc = Encoder(cfg)
    (au, rec, fs, rl, _s), = enc.feed(_src(192, 128, 80)) + enc.flush()
    drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
    assert info["checksum_ok"]


def test_jccr_inter():
    cfg = Config(width=192, height=128, qp=32, jccr=1)
    enc = Encoder(cfg)
    for i in range(2):
        for au, rec, fs, rl, _s in enc.feed(_src(192, 128, 90 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
