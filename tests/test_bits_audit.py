"""Estimated-vs-actual bits audit (round-2 ask #1b; SURVEY §4's
check_cabac_state_consistency analog for the model-based design): every
encode path reports per-frame model-estimated coefficient bits, and the
estimate must track the real CABAC AU size within a sane band."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes


def _clip(w, h, n, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = np.clip(120 + 50 * np.sin((xx + 3 * t) / 19.0)
                    + rng.integers(-15, 15, (h, w)), 0, 255)
        u = np.clip(128 + 20 * np.sin(xx[::2, ::2] / 11.0), 0, 255)
        v = np.clip(128 + 20 * np.cos(yy[::2, ::2] / 7.0), 0, 255)
        out.append(FramePlanes(y.astype(np.int32), u.astype(np.int32),
                               v.astype(np.int32)))
    return out


def _run(cfg_kw, n=4, w=128, h=128):
    cfg = Config(width=w, height=h, stats_audit=True, **cfg_kw)
    enc = Encoder(cfg)
    outs = []
    for f in _clip(w, h, n):
        outs.extend(enc.feed(f))
    outs.extend(enc.flush())
    rows = []
    for (au, _rec, fs, *_r) in outs:
        est = getattr(fs, "est_coeff_bits", None)
        assert est is not None, "audit estimate missing"
        rows.append((est, len(au) * 8))
    return rows


def test_audit_lowdelay_native_path():
    rows = _run(dict(qp=30, gop_len=4, gop_lowdelay=True, intra_period=64,
                     ref_frames=1, sao_type=3, deblock_enable=True,
                     rdoq_enable=False, wpp=False))
    tot_est = sum(e for (e, _a) in rows)
    tot_act = sum(a for (_e, a) in rows)
    # coefficient bits are the dominant term: the model must land in the
    # same ballpark as the whole AU (headers/modes/mvs are the rest)
    assert 0.2 < tot_est / tot_act < 1.5, (tot_est, tot_act)


def test_audit_python_path():
    rows = _run(dict(qp=30, gop_len=4, gop_lowdelay=True, intra_period=64,
                     ref_frames=1, sao_type=0, deblock_enable=False,
                     rdoq_enable=True, wpp=False))
    assert all(e >= 0 for (e, _a) in rows)
    assert sum(e for (e, _a) in rows) > 0
