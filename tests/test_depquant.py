"""Dependent quantization: normative dequant state machine + e2e."""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.ops.depquant import STATE_TRANS, dequant_dep, quant_dep
from uvg266_jax.ops.quant import dequant
from uvg266_jax.ops.transforms import fwd_transform_2d, inv_transform_2d
from uvg266_jax.oracle.decoder import decode_au


def test_state_transition_table():
    # the packed constant 32040 from the spec/reference
    for s in range(4):
        for p in range(2):
            assert STATE_TRANS[s][p] == (32040 >> ((s << 2) + (p << 1))) & 3


def test_dequant_dep_state_walk():
    """Hand-check: a single coefficient at the last position dequantizes
    with state 0 (even quantizer); parity of later-coded coefficients
    shifts the state for earlier ones."""
    q = np.zeros((4, 4), dtype=np.int16)
    q[0, 0] = 2
    out_single = dequant_dep(q, 27, 8)
    assert out_single[0, 0] != 0
    # two coefficients adjacent in scan order: the DC is dequantized
    # under the state set by the parity of the immediately-preceding
    # (in coding order) coefficient at scan index 1 = position (1,0)
    q2 = np.zeros((4, 4), dtype=np.int16)
    q2[0, 0] = 2
    q2[1, 0] = 1          # odd parity -> DC state 2 (offset quantizer)
    out_two = dequant_dep(q2, 27, 8)
    q3 = q2.copy()
    q3[1, 0] = 2          # even parity -> DC state 0 (even quantizer)
    out_three = dequant_dep(q3, 27, 8)
    assert out_two[0, 0] != out_three[0, 0]


def test_trellis_distortion_improves():
    rng = np.random.default_rng(5)
    tot_q = tot_d = 0.0
    for _ in range(15):
        resid = rng.normal(0, 12, (16, 16)).astype(np.int64)
        coef = fwd_transform_2d(resid, bitdepth=8)
        from uvg266_jax.ops.quant import quant
        r1 = inv_transform_2d(dequant(quant(coef, 27, 8), 27, 8), bitdepth=8)
        # small lambda isolates the quantizer-grid effect from rate
        r2 = inv_transform_2d(
            dequant_dep(quant_dep(coef, 27, 8, lam=1.0), 27, 8),
            bitdepth=8)
        tot_q += ((resid - r1) ** 2).sum()
        tot_d += ((resid - r2) ** 2).sum()
    assert tot_d < tot_q     # finer grid must reduce distortion


def test_depquant_e2e_oracle():
    rng = np.random.default_rng(81)
    W, H = 192, 128
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    y = np.clip(120 + 60 * np.sin(xx / 11) + 40 * np.cos(yy / 8)
                + rng.normal(0, 7, (H, W)), 0, 255).astype(np.int32)
    src = FramePlanes(y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                      (y[::2, ::2] // 3 + 70).astype(np.int32))
    cfg = Config(width=W, height=H, qp=30, intra_period=1, gop_len=0,
                 dep_quant=1)
    enc = Encoder(cfg)
    (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
    drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
    assert info["headers_ok"] and info["checksum_ok"]
    assert np.array_equal(drec.y, rec.y)


def test_depquant_inter():
    rng = np.random.default_rng(82)
    cfg = Config(width=128, height=128, qp=32, dep_quant=1)
    enc = Encoder(cfg)
    for i in range(2):
        y = rng.integers(0, 256, (128, 128)).astype(np.int32)
        src = FramePlanes(y, (y[::2, ::2] // 2).astype(np.int32),
                          (y[::2, ::2] // 3).astype(np.int32))
        for au, rec, fs, rl, _s in enc.feed(src) + enc.flush():
            drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
            assert info["checksum_ok"]
