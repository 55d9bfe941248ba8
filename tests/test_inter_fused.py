"""Fused whole-frame inter search: end-to-end stream validity.

The fused path (SliceEncoder._dispatch_inter_frame_fused) replaces the
per-class search dispatches for inter frames; these tests encode LD and
RA sequences through it and decode every AU with the oracle, checking
picture hashes and recon equality (the same bar as the per-class path's
soak tests)."""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes

W, H, N = 128, 80, 5


def _clip(seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(N):
        y = (xx * 0.7 + yy * 0.4 + 35 * np.sin((xx + 4 * t) / 9.0)
             + 25 * np.cos((yy - 3 * t) / 7.0))
        y = np.clip(y + rng.integers(-4, 4, (H, W)), 0, 255)
        u = np.clip(128 + 15 * np.sin((xx[::2, ::2] + 2 * t) / 13.0), 0, 255)
        v = np.clip(128 + 15 * np.cos((yy[::2, ::2] + 5 * t) / 17.0), 0, 255)
        out.append(FramePlanes(y.astype(np.int32), u.astype(np.int32),
                               v.astype(np.int32)))
    return out


def _encode_and_verify(cfg, path="_dispatch_inter_frame_fused"):
    from uvg266_jax.consts import SliceType
    from uvg266_jax.control.encoder import RefLists
    from uvg266_jax.oracle.decoder import decode_au
    enc = Encoder(cfg)
    dpb = {}
    used_fused = []
    orig = getattr(type(enc.slice_enc), path)

    def spy(self, *a, **k):
        r = orig(self, *a, **k)
        used_fused.append(r is not None)
        return r

    setattr(type(enc.slice_enc), path, spy)
    try:
        results = []
        for src in _clip():
            results += enc.feed(src)
        results += enc.flush()
        for (au, rec, fs, rl, src) in results:
            pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
            pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
            if fs.slicetype == SliceType.I:
                dpb.clear()
            orl = RefLists(l0=[dpb[q] for q in pocs0],
                           l1=[dpb[q] for q in pocs1],
                           pocs0=pocs0, pocs1=pocs1)
            dec, info = decode_au(au, cfg, enc.ctrl, fs, refs=orl)
            assert info["checksum_ok"], f"poc {fs.poc} hash"
            assert np.array_equal(dec.y, rec.y), f"poc {fs.poc} recon"
            dpb[fs.poc] = dec
    finally:
        setattr(type(enc.slice_enc), path, orig)
    assert any(used_fused), f"{path} never engaged"
    return len(results)


def test_lowdelay_fused_oracle_roundtrip():
    # --me full (ime_algorithm 2) pins the all-device dense search
    cfg = Config(width=W, height=H, qp=30, gop_len=4, gop_lowdelay=True,
                 gop_lp_d=3, gop_lp_t=1, ime_algorithm=2)
    assert _encode_and_verify(cfg) == N


def test_ra_fused_oracle_roundtrip():
    cfg = Config(width=W, height=H, qp=30, gop_len=8, gop_lowdelay=False,
                 ime_algorithm=2)
    assert _encode_and_verify(cfg) == N


def test_lowdelay_hostme_oracle_roundtrip():
    # default path: host C++ hexbs ME + device intra screening
    cfg = Config(width=W, height=H, qp=30, gop_len=4, gop_lowdelay=True,
                 gop_lp_d=3, gop_lp_t=1)
    assert _encode_and_verify(cfg, "_dispatch_inter_frame_hostme") == N


def test_ra_hostme_oracle_roundtrip():
    cfg = Config(width=W, height=H, qp=30, gop_len=8, gop_lowdelay=False)
    assert _encode_and_verify(cfg, "_dispatch_inter_frame_hostme") == N


def test_host_intra_screen_roundtrip():
    """cfg.host_intra_screen: the C++ screen replaces the device
    dispatch for P/B frames (native/inter.cpp fi_host_screen); the
    stream stays self-consistent through the oracle decoder."""
    import numpy as np

    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import Encoder, FramePlanes
    from uvg266_jax.oracle.ref_decoder import decode_stream

    W, H = 192, 120                     # non-16-multiple height
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:H, 0:W]
    cfg = Config(width=W, height=H, qp=30, gop_len=4, gop_lowdelay=True,
                 ref_frames=2, tmvp_enable=True, sao_type=3,
                 deblock_enable=True, host_intra_screen=True)
    enc = Encoder(cfg)
    outs = []
    for t in range(5):
        y = np.clip(120 + 60 * np.sin((xx + 3 * t) / 19.0)
                    + rng.randint(-6, 6, (H, W)), 0, 255).astype(np.int32)
        u = np.clip(128 + rng.randint(-4, 4, (H // 2, W // 2)),
                    0, 255).astype(np.int32)
        v = np.clip(128 + rng.randint(-4, 4, (H // 2, W // 2)),
                    0, 255).astype(np.int32)
        outs += enc.feed(FramePlanes(y, u, v))
    outs += enc.flush()
    frames = decode_stream(b"".join(t[0] for t in outs))
    assert len(frames) == 5
    assert all(f.checksum_ok for f in frames)
