"""CCLM tests: parameter derivation properties + e2e oracle round-trip."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.ops.cclm import derive_cclm_params, predict_cclm
from uvg266_jax.oracle.decoder import decode_au


def _src(w, h, seed=23, slope=0.45):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(110 + 60 * np.sin(xx / 13) + 50 * np.cos(yy / 9)
                + rng.normal(0, 8, (h, w)), 0, 255).astype(np.int32)
    u = np.clip(y[::2, ::2] * slope + 30
                + rng.normal(0, 2, (h // 2, w // 2)), 0, 255).astype(np.int32)
    v = np.clip(255 - y[::2, ::2] * 0.35
                + rng.normal(0, 2, (h // 2, w // 2)), 0, 255).astype(np.int32)
    return FramePlanes(y, u, v)


def test_derive_params_perfect_linear():
    # chroma = luma/2 + 10 exactly -> derived line predicts within rounding
    luma = np.array([40, 80, 120, 200, 60, 100, 140, 180], dtype=np.int32)
    chroma = luma // 2 + 10
    a, b, shift = derive_cclm_params(81, 8, 8, 4, 4, luma, luma,
                                     chroma, chroma, 0, 0, 8)
    for lv in (50, 90, 170):
        pred = ((lv * a) >> shift) + b
        assert abs(pred - (lv // 2 + 10)) <= 2


def test_derive_params_no_refs():
    z = np.zeros(8, dtype=np.int32)
    a, b, shift = derive_cclm_params(81, 8, 8, 0, 0, z, z, z, z, 0, 0, 8)
    assert a == 0 and b == 128 and shift == 0


def test_cclm_e2e_gain_and_oracle():
    src = _src(192, 128)
    out = {}
    for cclm in (0, 1):
        cfg = Config(width=192, height=128, qp=30, intra_period=1,
                     gop_len=0, cclm=cclm)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.u, rec.u)
        assert np.array_equal(drec.v, rec.v)
        mseu = np.mean((rec.u - src.u.astype(np.int64)) ** 2)
        out[cclm] = (len(au) * 8, 10 * np.log10(255 ** 2 / mseu))
    (b0, p0), (b1, p1) = out[0], out[1]
    assert b1 < b0 and p1 > p0 - 0.05, f"cclm not beneficial: {out}"


def test_cclm_inter_and_wpp():
    src0, src1 = _src(192, 128, 5), _src(192, 128, 6)
    cfg = Config(width=192, height=128, qp=32, cclm=1, wpp=True)
    enc = Encoder(cfg)
    for au, rec, fs, rl, _s in (enc.feed(src0) + enc.feed(src1)
                                + enc.flush()):
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
