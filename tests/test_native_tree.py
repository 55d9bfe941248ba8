"""Native whole-frame tree writer (tree.cpp) vs the Python
CodingTreeWriter: byte-identical access units on the all-intra path."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import FramePlanes, SliceEncoder
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.oracle.decoder import decode_au


def _frame(w, h, seed=3):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(100 + 50 * np.sin(xx / 13) + 45 * np.cos(yy / 9)
                + rng.normal(0, 10, (h, w)), 0, 255).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                       (y[::2, ::2] // 3 + 70).astype(np.int32))


def _encode(cfg, src, force_python):
    enc = SliceEncoder(cfg, EncoderControl(cfg))
    if force_python:
        enc.force_python_tree = True
    fs = FrameState(num=0, qp=cfg.qp)
    au, rec = enc.encode_frame(fs, src)
    return au, rec, enc.ctrl, fs


def test_native_tree_byte_exact():
    for kwargs in (
            dict(sao_type=3, deblock_enable=True, signhide_enable=True),
            dict(sao_type=0, deblock_enable=False, signhide_enable=False),
    ):
        cfg = Config(width=208, height=144, qp=27, gop_len=0, intra_period=1,
                     rdoq_enable=False, dep_quant=False, wpp=False, **kwargs)
        src = _frame(208, 144)
        au_n, rec_n, ctrl, fs = _encode(cfg, src, force_python=False)
        au_p, rec_p, _, _ = _encode(cfg, src, force_python=True)
        assert au_n == au_p, f"writer mismatch for {kwargs}"
        assert np.array_equal(rec_n.y, rec_p.y)
        drec, info = decode_au(au_n, cfg, ctrl, fs)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec_n.y)


def test_native_tree_boundary_frame():
    # non-CTU-aligned dims exercise implicit splits in the C++ writer
    cfg = Config(width=200, height=120, qp=32, gop_len=0, intra_period=1,
                 sao_type=3, deblock_enable=True, wpp=False)
    src = _frame(200, 120, seed=9)
    au_n, rec_n, ctrl, fs = _encode(cfg, src, force_python=False)
    au_p, _, _, _ = _encode(cfg, src, force_python=True)
    assert au_n == au_p
    drec, info = decode_au(au_n, cfg, ctrl, fs)
    assert info["checksum_ok"]

def _clip(w, h, n, seed=3):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    base = 110 + 55 * np.sin(xx / 13) + 45 * np.cos(yy / 9)
    frames = []
    for i in range(n):
        y = np.clip(np.roll(base, i * 3, axis=1)
                    + rng.normal(0, 9, (h, w)), 0, 255).astype(np.int32)
        frames.append(FramePlanes(
            y, (y[::2, ::2] // 2 + 40).astype(np.int32),
            (y[::2, ::2] // 3 + 70).astype(np.int32)))
    return frames


def _encode_seq(cfgkw, frames, force_python):
    from uvg266_jax.control.encoder import Encoder
    cfg = Config(width=frames[0].y.shape[1], height=frames[0].y.shape[0],
                 qp=30, sao_type=3, deblock_enable=True,
                 signhide_enable=True, **cfgkw)
    enc = Encoder(cfg)
    enc.slice_enc.force_python_tree = force_python
    aus = []
    for f in frames:
        aus += [au for au, *_ in enc.feed(f)]
    aus += [au for au, *_ in enc.flush()]
    return aus


import pytest


@pytest.mark.parametrize("cfgkw", [
    dict(gop_len=4, intra_period=64, gop_lowdelay=1),
    dict(gop_len=4, intra_period=64, gop_lowdelay=1, wpp=True),
    dict(gop_len=8, intra_period=64),
    dict(gop_len=4, intra_period=64, gop_lowdelay=1, amvr=1),
], ids=["ld", "ld-wpp", "ra8", "ld-amvr"])
def test_native_inter_tree_byte_exact(cfgkw):
    """P/B-frame C++ writer (tw_write_frame): byte-identical AUs vs the
    Python CodingTreeWriter on LD/RA/WPP/AMVR sequences (skip, merge,
    mvd/AMVP, inter-dir, intra-in-P leaves, inferred luma cbf)."""
    frames = _clip(192, 128, 6)
    a = _encode_seq(cfgkw, frames, force_python=True)
    b = _encode_seq(cfgkw, frames, force_python=False)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"AU {i} differs ({len(x)} vs {len(y)} bytes)"
