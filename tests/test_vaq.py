"""VAQ (variance adaptive quantization) + cu_qp_delta: encoder writes
per-CTU QPs (encoderstate.c:1797-1879 offsets), the oracle re-derives
them purely from the signaled deltas and must reproduce the recon and
picture hashes (decode side additionally proven against reference-binary
--vaq streams in test_ref_decode.py)."""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.consts import SliceType
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.oracle.decoder import decode_au


def textured_clip(w, h, n, seed=4):
    # high-variance and flat regions so VAQ produces nonzero deltas
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.full((h, w), 100.0)
        y[:, : w // 2] += rng.integers(-60, 60, (h, w // 2))  # busy half
        y += 20 * np.sin((xx + 4 * t) / 17.0)
        u = np.clip(128 + 10 * np.sin(xx[::2, ::2] / 9.0), 0, 255)
        v = np.clip(128 + 10 * np.cos(yy[::2, ::2] / 7.0), 0, 255)
        frames.append(FramePlanes(np.clip(y, 0, 255).astype(np.int32),
                                  u.astype(np.int32), v.astype(np.int32)))
    return frames


def roundtrip(cfg_kw, n_frames=3, w=192, h=128):
    cfg = Config(width=w, height=h, **cfg_kw)
    enc = Encoder(cfg)
    frames = textured_clip(w, h, n_frames)
    outs = []
    for f in frames:
        outs.extend(enc.feed(f))
    outs.extend(enc.flush())
    dec_dpb = []
    n_delta = 0
    for i, (au, rec, fs, refs, _src) in enumerate(outs):
        if fs.slicetype == SliceType.I:
            dec_dpb = []
        dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=dec_dpb)
        assert info["checksum_ok"], f"frame {i} hash"
        np.testing.assert_array_equal(dec_rec.y, rec.y, err_msg=f"f{i} y")
        if rec.u is not None:
            np.testing.assert_array_equal(dec_rec.u, rec.u)
            np.testing.assert_array_equal(dec_rec.v, rec.v)
        dec_rec.motion = rec.motion
        dec_dpb.insert(0, dec_rec)
        del dec_dpb[max(1, cfg.ref_frames):]
    return outs


def test_vaq_intra_roundtrip():
    outs = roundtrip(dict(qp=30, vaq=5, gop_len=0, intra_period=1,
                          sao_type=0, deblock_enable=True,
                          rdoq_enable=False, wpp=False))
    assert len(outs) == 3


def test_vaq_lowdelay_roundtrip():
    roundtrip(dict(qp=30, vaq=5, gop_len=4, gop_lowdelay=True,
                   intra_period=64, ref_frames=1, sao_type=3,
                   deblock_enable=True, rdoq_enable=False, wpp=False),
              n_frames=5)


def test_vaq_wpp_roundtrip():
    roundtrip(dict(qp=32, vaq=8, gop_len=4, gop_lowdelay=True,
                   intra_period=64, ref_frames=1, sao_type=0,
                   deblock_enable=True, rdoq_enable=False, wpp=True),
              n_frames=4)


def test_vaq_offsets_vary():
    # the busy/flat halves must get different QPs
    from uvg266_jax.control.encoder import vaq_ctu_qps
    from uvg266_jax.control.params import EncoderControl
    cfg = Config(width=192, height=128, qp=30, vaq=5)
    ctrl = EncoderControl(cfg)
    src = textured_clip(192, 128, 1)[0]
    qps = vaq_ctu_qps(src, cfg, ctrl, 30)
    assert qps.min() < 30 < qps.max() + 1
    assert len(np.unique(qps)) > 1


def test_rc_per_lcu_bitrate():
    """Per-LCU RC (rate_control.c:1097 analog): --bitrate with
    cu_qp_delta hits the target within tolerance and produces varying
    per-CTU QPs, and the oracle still round-trips."""
    w, h, n = 192, 128, 16
    fps = 25.0
    target = 400_000
    cfg = Config(width=w, height=h, qp=30, gop_len=4, gop_lowdelay=True,
                 intra_period=64, ref_frames=1, sao_type=0,
                 deblock_enable=True, rdoq_enable=False, wpp=False,
                 target_bitrate=target)
    enc = Encoder(cfg)
    frames = textured_clip(w, h, n)
    outs = []
    for f in frames:
        outs.extend(enc.feed(f))
    outs.extend(enc.flush())
    total_bits = sum(len(au) * 8 for (au, *_r) in outs)
    achieved = total_bits * fps / n
    assert abs(achieved - target) / target < 0.30, achieved
    # late frames must carry per-CTU RC QPs
    late = [getattr(fs, "ctu_qps", None) for (_a, _r, fs, *_x) in outs[4:]]
    assert any(q is not None for q in late)
    # oracle roundtrip of the whole stream
    dec_dpb = []
    for i, (au, rec, fs, refs, _src) in enumerate(outs):
        if fs.slicetype == SliceType.I:
            dec_dpb = []
        dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=dec_dpb)
        assert info["checksum_ok"], f"frame {i}"
        np.testing.assert_array_equal(dec_rec.y, rec.y)
        dec_rec.motion = rec.motion
        dec_dpb.insert(0, dec_rec)
        del dec_dpb[max(1, cfg.ref_frames):]
