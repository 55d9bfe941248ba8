"""Multi-chip mesh encode: byte-identical to the single-device encode.

The real encoder's phase-1 search runs sharded over a ('gop','tile')
mesh (uvg266_jax.parallel.mesh): each device searches one tile's CU
batch, two frames ride the 'gop' axis per dispatch, per-frame RD stats
are psum'd over 'tile'. Finalize + per-tile CABAC substreams run on host
unchanged, so the output must be byte-identical to the plain Encoder
with the same config (reference analogue: encoder.c tile geometry +
encoderstate.c owf).

Runs on the virtual 8-device CPU mesh from conftest.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.parallel import MeshEncoder, build_mesh


def mkframe(w, h, i):
    rng = np.random.default_rng(40 + i)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip((xx * 2 + yy + i * 17) % 255
                + rng.integers(-20, 21, (h, w)), 0, 255).astype(np.int32)
    u = (y[::2, ::2] // 2 + 40).astype(np.int32)
    v = (y[::2, ::2] // 3 + 60).astype(np.int32)
    return FramePlanes(y, u, v)


def encode_single(cfg, frames):
    enc = Encoder(cfg)
    out = []
    for f in frames:
        for (au, rec, _fs, _rl, _src) in enc.feed(f):
            out.append((au, rec))
    for (au, rec, _fs, _rl, _src) in enc.flush():
        out.append((au, rec))
    return out


@pytest.mark.parametrize("tools", [
    {},
    {"mip": True, "sao_type": 3, "deblock_enable": True},
])
def test_mesh_encode_byte_identical(tools):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = Config(width=256, height=128, qp=32, gop_len=0, intra_period=1,
                 tiles_width_count=2, tiles_height_count=2, wpp=False,
                 **tools)
    frames = [mkframe(256, 128, i) for i in range(3)]

    ref = encode_single(cfg, frames)

    mesh = build_mesh(8)            # ('gop','tile') = (2, 4)
    assert mesh.shape["tile"] == 4 and mesh.shape["gop"] == 2
    menc = MeshEncoder(Config(width=256, height=128, qp=32, gop_len=0, intra_period=1,
                              tiles_width_count=2, tiles_height_count=2,
                              wpp=False, **tools), mesh)
    got = menc.encode(frames)

    assert len(got) == len(ref) == 3
    for i, ((au_m, rec_m), (au_s, rec_s)) in enumerate(zip(got, ref)):
        assert au_m == au_s, f"frame {i}: bitstream differs"
        assert np.array_equal(rec_m.y, rec_s.y)
    # psum'd per-frame RD stats reached the host RC path
    assert len(menc.frame_rd_stats) == 3
    assert all(s > 0 for s in menc.frame_rd_stats)


def _mesh_clip(w, h, n, seed=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.clip(110 + 70 * np.sin((xx + 3 * t) / 21.0)
                    + 40 * np.cos((yy + 2 * t) / 13.0)
                    + rng.integers(-10, 10, (h, w)), 0, 255)
        u = np.clip(128 + 25 * np.sin(xx[::2, ::2] / 11.0), 0, 255)
        v = np.clip(128 + 25 * np.cos(yy[::2, ::2] / 9.0), 0, 255)
        frames.append(FramePlanes(y.astype(np.int32), u.astype(np.int32),
                                  v.astype(np.int32)))
    return frames


def _check_gop_mesh(cfg_kw, G, L, w=128, h=80):
    """MeshGopEncoder output must be byte-identical to encoding each
    closed-GOP run with a plain single-device Encoder."""
    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import Encoder
    from uvg266_jax.parallel import MeshGopEncoder, build_gop_mesh

    cfg = Config(width=w, height=h, **cfg_kw)
    frames = _mesh_clip(w, h, G * L)
    mesh = build_gop_mesh(G)
    menc = MeshGopEncoder(cfg, mesh)
    res = menc.encode(frames)
    assert len(res) == G
    assert menc.disp.errors == [] and menc.disp.sharded_calls > 0
    for g in range(G):
        enc = Encoder(Config(width=w, height=h, **cfg_kw))
        ref_outs = []
        for f in frames[g * L:(g + 1) * L]:
            ref_outs.extend(enc.feed(f))
        ref_outs.extend(enc.flush())
        assert len(res[g]) == len(ref_outs) == L
        for i, ((au_m, *_a), (au_r, *_b)) in enumerate(zip(res[g],
                                                           ref_outs)):
            assert au_m == au_r, f"gop {g} result {i} differs"


def test_gop_mesh_lowdelay_byte_identical():
    _check_gop_mesh(dict(qp=30, gop_len=4, gop_lowdelay=True,
                         intra_period=64, ref_frames=1, sao_type=3,
                         deblock_enable=True, rdoq_enable=False,
                         wpp=False), G=4, L=4)


def test_gop_mesh_ra8_byte_identical():
    _check_gop_mesh(dict(qp=30, gop_len=8, gop_lowdelay=False, bipred=1,
                         intra_period=64, ref_frames=2, sao_type=3,
                         deblock_enable=True, rdoq_enable=False,
                         wpp=False), G=2, L=8)
