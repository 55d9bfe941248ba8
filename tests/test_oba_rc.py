"""Frame-level OBA rate control: convergence not worse than R-lambda."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes


def _frames(n, w=192, h=128, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        y = np.clip(110 + 50 * np.sin((xx + 3 * t) / 12)
                    + 40 * np.cos((yy - t) / 9)
                    + rng.normal(0, 6, (h, w)), 0, 255).astype(np.int32)
        out.append(FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                               (y[::2, ::2] // 3 + 70).astype(np.int32)))
    return out


def test_oba_converges():
    frames = _frames(16)
    res = {}
    for algo in ("lambda", "oba"):
        cfg = Config(width=192, height=128, qp=30, target_bitrate=300000,
                     rc_algorithm=algo, framerate_num=30, framerate_denom=1)
        enc = Encoder(cfg)
        bits = 0
        for f in frames:
            for au, *_ in enc.feed(f):
                bits += len(au) * 8
        res[algo] = bits / (len(frames) / 30)
    # both within a reasonable band of the target over a short burst
    for algo, bps in res.items():
        assert 0.5 * 300000 < bps < 2.0 * 300000, (algo, bps)
    # OBA should not be further from target than R-lambda
    err = {a: abs(b - 300000) for a, b in res.items()}
    assert err["oba"] <= err["lambda"] * 1.25, res
