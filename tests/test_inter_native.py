"""Native whole-frame inter finalize (native/inter.cpp) vs the Python
path (_refine_inter_leaves + _finalize_sequential): byte-identical
streams and bit-exact recon, plus oracle decode of the native stream.

The C++ finalize mirrors inter_cand.py (merge/AMVP/HMVP/TMVP),
ops/inter.py (MC), ops/me_frame.py make_leaf_qpel_fn (49-offset qpel
refine) and the transform/quant round-trip — any divergence shows up as
a stream mismatch here.
"""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.consts import SliceType
from uvg266_jax.control.encoder import Encoder, FramePlanes


def moving_clip(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base_y = np.clip(120 + 60 * np.sin(xx / 23.0) + 40 * np.cos(yy / 17.0)
                     + rng.integers(-20, 20, (h, w)), 0, 255)
    base_u = 128 + 30 * np.sin(xx[::2, ::2] / 19.0)
    base_v = 128 + 30 * np.cos(yy[::2, ::2] / 13.0)
    frames = []
    for t in range(n):
        y = np.roll(np.roll(base_y, 3 * t, axis=1), 2 * t, axis=0) \
            .astype(np.int32)
        u = np.clip(np.roll(base_u, 2 * t, axis=1), 0, 255).astype(np.int32)
        v = np.clip(np.roll(base_v, 2 * t, axis=1), 0, 255).astype(np.int32)
        # a little fresh detail per frame so residuals are nonzero
        y[(7 * t) % h, :] = np.clip(
            y[(7 * t) % h, :] + rng.integers(-30, 30, w), 0, 255)
        frames.append(FramePlanes(y, u, v))
    return frames


def encode_all(cfg, frames, force_python):
    enc = Encoder(cfg)
    if force_python:
        enc.slice_enc.force_python_inter_finalize = True
    outs = []
    for f in frames:
        outs.extend(enc.feed(f))
    outs.extend(enc.flush())
    return outs


def check_parity(base_cfg, n_frames=5, w=128, h=128, seed=11):
    base_cfg = dict(base_cfg, width=w, height=h)
    cfg = Config(**base_cfg)
    frames = moving_clip(w, h, n_frames, seed=seed)
    nat = encode_all(cfg, frames, force_python=False)
    py = encode_all(cfg, frames, force_python=True)
    assert len(nat) == len(py)
    n_inter = 0
    for i, ((au_n, rec_n, fs_n, *_a), (au_p, rec_p, *_b)) in enumerate(
            zip(nat, py)):
        assert au_n == au_p, f"AU {i} bytes differ (poc {fs_n.poc})"
        np.testing.assert_array_equal(rec_n.y, rec_p.y)
        if rec_n.u is not None:
            np.testing.assert_array_equal(rec_n.u, rec_p.u)
            np.testing.assert_array_equal(rec_n.v, rec_p.v)
        if rec_n.motion is not None and rec_p.motion is not None:
            np.testing.assert_array_equal(rec_n.motion.dir,
                                          rec_p.motion.dir)
            np.testing.assert_array_equal(rec_n.motion.mv,
                                          rec_p.motion.mv)
            np.testing.assert_array_equal(rec_n.motion.ref_poc,
                                          rec_p.motion.ref_poc)
        if fs_n.slicetype != SliceType.I:
            n_inter += 1
    assert n_inter > 0, "test clip produced no inter frames"


BASE = dict(width=128, height=128, qp=30, gop_len=4, gop_lowdelay=True,
            intra_period=64, ref_frames=1, sao_type=3, alf_type=0,
            deblock_enable=True, rdoq_enable=False, signhide_enable=True,
            dep_quant=False, wpp=False)


def test_lowdelay_p_parity():
    check_parity(dict(BASE))


def test_lowdelay_p_no_tmvp_no_filters():
    check_parity(dict(BASE, tmvp_enable=False, sao_type=0,
                      deblock_enable=False, signhide_enable=False))


def test_lowdelay_multiref_parity():
    check_parity(dict(BASE, ref_frames=3), n_frames=6, seed=5)


def test_lowdelay_b_bipred_parity():
    check_parity(dict(BASE, bipred=1, ref_frames=2), n_frames=6, seed=9)


def test_lowdelay_wpp_parity():
    check_parity(dict(BASE, wpp=True), w=192, h=128, seed=3)


def test_ra8_parity():
    # random-access B-pyramid: B slices, two lists, per-frame QP offsets
    check_parity(dict(BASE, gop_len=8, gop_lowdelay=False, bipred=1,
                      ref_frames=4), n_frames=9, seed=7)
