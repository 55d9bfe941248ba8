"""Scaling lists: derivation, cqm parser, APS round-trip, e2e oracle."""
import numpy as np
import pytest

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes, SliceEncoder
from uvg266_jax.control.params import EncoderControl, FrameState
from uvg266_jax.oracle.decoder import decode_au
from uvg266_jax.ops.scaling_lists import (DEFAULT_8X8_INTRA, INTRA_Y,
                                          ScalingLists, quant_matrix)


def _src(w, h, seed=23):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(100 + 60 * np.sin(xx / 9) + 50 * np.cos(yy / 13)
                + rng.normal(0, 12, (h, w)), 0, 255).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                       (y[::2, ::2] // 3 + 70).astype(np.int32))


def test_default_matrix_derivation():
    sl = ScalingLists.default()
    # 8x8 intra luma is the base itself
    assert np.array_equal(sl.matrix(8, 8, INTRA_Y), DEFAULT_8X8_INTRA)
    # 4x4 default is flat
    assert (sl.matrix(4, 4, INTRA_Y) == 16).all()
    # 16x16 nearest-neighbour upsample: each base value covers 2x2
    m16 = sl.matrix(16, 16, INTRA_Y)
    assert m16.shape == (16, 16)
    assert m16[2, 2] == DEFAULT_8X8_INTRA[1, 1]
    assert m16[15, 15] == DEFAULT_8X8_INTRA[7, 7]
    assert m16[0, 0] == 16          # DC override
    # rect: 32x8 maps per axis from the 8x8 base of the 32 class
    # (short axis 1:1, long axis subsampled)
    m = sl.matrix(32, 8, INTRA_Y)
    assert m.shape == (8, 32)
    assert m[7, 31] == DEFAULT_8X8_INTRA[7, 7]
    assert m[3, 8] == DEFAULT_8X8_INTRA[3, 2]


def test_quant_dequant_matrix_flat_equivalence():
    """A flat-16 matrix must reproduce the no-matrix path exactly."""
    from uvg266_jax.ops.quant import dequant, quant
    rng = np.random.default_rng(3)
    for (w, h) in ((8, 8), (16, 8), (32, 16)):
        coef = rng.integers(-500, 500, (h, w)).astype(np.int64)
        flat = np.full((h, w), 16, dtype=np.int32)
        for qp in (22, 30, 37):
            q0 = quant(coef, qp)
            q1 = quant(coef, qp, qmat=flat)
            assert np.array_equal(q0, q1), (w, h, qp)
            d0 = dequant(q0, qp)
            d1 = dequant(q0, qp, qmat=flat)
            assert np.array_equal(d0, d1), (w, h, qp)


def test_cqm_file_parser(tmp_path):
    f = tmp_path / "m.cfg"
    vals_8 = " ".join(str(16 + (i % 7)) for i in range(64))
    f.write_text(
        "# comment\nINTRA8X8_LUMA\n" + vals_8
        + "\nINTRA16X16_LUMA_DC\n20\n")
    sl = ScalingLists.from_file(str(f))
    assert sl.base[(1, 0)][0, 1] == 17
    assert sl.dc[(2, 0)] == 20
    # unspecified sections keep defaults
    assert np.array_equal(sl.base[(1, 3)],
                          ScalingLists.default().base[(1, 3)])
    bad = tmp_path / "bad.cfg"
    bad.write_text("INTRA8X8_LUMA\n0 " + vals_8)
    with pytest.raises(ValueError):
        ScalingLists.from_file(str(bad))


def test_scaling_aps_roundtrip():
    from uvg266_jax.bitstream.bitwriter import Bitstream, BitstreamReader
    from uvg266_jax.hls.scaling_list_syntax import (parse_scaling_aps,
                                                    write_scaling_aps)
    sl = ScalingLists.default()
    sl.base[(1, 0)] = np.arange(1, 65, dtype=np.int32).reshape(8, 8)
    sl.dc[(2, 4)] = 23
    bs = Bitstream()
    write_scaling_aps(bs, sl)
    rd = BitstreamReader(bs.bytes())
    out = parse_scaling_aps(rd)
    for key, m in sl.base.items():
        assert np.array_equal(out.base[key], m), key
    for key, dc in sl.dc.items():
        assert out.dc[key] == dc, key


def test_e2e_default_scaling_lists_intra():
    cfg = Config(width=128, height=96, qp=30, intra_period=1, gop_len=0,
                 scaling_list=2)
    enc = SliceEncoder(cfg, EncoderControl(cfg))
    fs = FrameState(num=0, qp=30)
    src = _src(128, 96)
    au, rec = enc.encode_frame(fs, src)
    drec, info = decode_au(au, cfg, enc.ctrl, fs)
    assert info["headers_ok"] and info["checksum_ok"]
    assert info["scaling_aps"], "scaling APS not found in the AU"
    assert np.array_equal(drec.y, rec.y)
    assert np.array_equal(drec.u, rec.u)


def test_e2e_scaling_lists_inter():
    cfg = Config(width=128, height=96, qp=32, scaling_list=2)
    enc = Encoder(cfg)
    res = []
    for i in range(2):
        res += enc.feed(_src(128, 96, seed=50 + i))
    res += enc.flush()
    saw_p = False
    for au, rec, fs, rl, _s in res:
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
        saw_p = saw_p or fs.slicetype != 2
    assert saw_p


def test_scaling_lists_shift_bits_high_freq():
    """Default matrices quantize high frequencies coarser: HF coeff
    levels shrink vs flat at identical input."""
    from uvg266_jax.ops.quant import quant
    sl = ScalingLists.default()
    m = quant_matrix(sl, 8, 8, 0, True)
    coef = np.full((8, 8), 300, dtype=np.int64)
    q_flat = quant(coef, 30)
    q_m = quant(coef, 30, qmat=m)
    assert q_m[7, 7] < q_flat[7, 7]
    assert q_m[0, 1] == q_flat[0, 1]     # m=16 near DC: unchanged
