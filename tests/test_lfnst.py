"""LFNST tests: transform invertibility properties + e2e oracle."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.ops.lfnst import _lfnst_mode, fwd_lfnst, inv_lfnst
from uvg266_jax.oracle.decoder import decode_au


def test_lfnst_mode_mapping():
    # planar/DC -> set 0, no transpose; steep vertical modes transpose
    s, t = _lfnst_mode(0, 4, 4)
    assert s == 0 and not t
    s, t = _lfnst_mode(50, 4, 4)     # vertical: mode > 34 -> transpose
    assert t
    s, t = _lfnst_mode(18, 4, 4)     # horizontal: no transpose
    assert not t


def test_lfnst_projection_idempotent():
    """LFNST is a low-rank projection: inv(fwd(x)) lies in the kernel
    subspace, so a second fwd/inv round trip must be (nearly) a no-op."""
    rng = np.random.default_rng(5)
    for (w, h) in ((8, 8), (16, 16)):
        coef = np.zeros((h, w), dtype=np.int64)
        coef[:4, :4] = rng.integers(-200, 200, (4, 4))
        f = fwd_lfnst(coef, 0, w.bit_length() - 1, h.bit_length() - 1, 1)
        # outputs confined to the top-left 4x4 scan region
        assert np.count_nonzero(f[4:, :]) == 0
        assert np.count_nonzero(f[:, 4:]) == 0
        r1 = inv_lfnst(f.astype(np.int64), 0, w.bit_length() - 1,
                       h.bit_length() - 1, 1)
        f2 = fwd_lfnst(r1.astype(np.int64), 0, w.bit_length() - 1,
                       h.bit_length() - 1, 1)
        r2 = inv_lfnst(f2.astype(np.int64), 0, w.bit_length() - 1,
                       h.bit_length() - 1, 1)
        num = float(((r1.astype(np.int64) - r2) ** 2).sum())
        den = float((r1.astype(np.int64) ** 2).sum()) + 1e-9
        assert num / den < 0.02, f"projection not idempotent {num/den}"


def _src(w, h, seed=51, tile=16):
    # randomly-oriented gradient tiles: favors small angular CUs (LFNST's
    # domain) over 64x64 leaves — a global sinusoid is a single DCT
    # coefficient and makes the unsplit CTU legitimately optimal, where
    # LFNST is spec-disallowed (CU larger than the 32x32 max TU)
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.zeros((h, w))
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            a = rng.uniform(0, np.pi)
            g = (np.cos(a) * (xx[ty:ty + tile, tx:tx + tile] - tx)
                 + np.sin(a) * (yy[ty:ty + tile, tx:tx + tile] - ty))
            y[ty:ty + tile, tx:tx + tile] = \
                rng.uniform(60, 190) + g * rng.uniform(-6, 6)
    y = np.clip(y + rng.normal(0, 3, (h, w)), 0, 255).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                       (y[::2, ::2] // 3 + 70).astype(np.int32))


def test_lfnst_e2e_oracle():
    src = _src(192, 128)
    out = {}
    for lf in (False, True):
        cfg = Config(width=192, height=128, qp=30, intra_period=1,
                     gop_len=0, lfnst=lf)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["headers_ok"] and info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
        out[lf] = len(au) * 8
    assert out[True] != out[False], "LFNST never engaged"


def test_lfnst_inter_frames():
    cfg = Config(width=192, height=128, qp=32, lfnst=True)
    enc = Encoder(cfg)
    for i in range(2):
        for au, rec, fs, rl, _s in enc.feed(_src(192, 128, 60 + i)) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
            assert np.array_equal(drec.y, rec.y)
