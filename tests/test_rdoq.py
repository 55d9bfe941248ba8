"""RDOQ tests: decodability, RD benefit, sign-hiding interaction.

The vectorized RDOQ (ops/rdoq.py) mirrors the decisions of the
reference's uvg_rdoq (rdo.c:1449) with static rate estimates; levels
only steer the encoder, so the oracle round-trip must stay exact.
"""
import numpy as np

from uvg266_jax.cfg import Config
from uvg266_jax.control.encoder import Encoder, FramePlanes
from uvg266_jax.control.partition import qp_to_lambda
from uvg266_jax.ops.quant import dequant, quant
from uvg266_jax.ops.rdoq import rdoq_levels
from uvg266_jax.ops.transforms import fwd_transform_2d, inv_transform_2d
from uvg266_jax.oracle.decoder import decode_au


def _src(w, h, seed=11):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = np.clip(120 + 60 * np.sin(xx / 17) + 40 * np.cos(yy / 23)
                + rng.normal(0, 12, (h, w)), 0, 255).astype(np.int32)
    return FramePlanes(y, (y[::2, ::2] // 2 + 30).astype(np.int32),
                       (y[::2, ::2] // 3 + 60).astype(np.int32))


def test_rdoq_levels_sane():
    rng = np.random.default_rng(2)
    for qp in (22, 32):
        lam = qp_to_lambda(qp)
        for shape in ((16, 16), (8, 32), (4, 4)):
            resid = rng.normal(0, 14, shape).astype(np.int64)
            coef = fwd_transform_2d(resid, bitdepth=8)
            lv = rdoq_levels(coef, qp, 8, lam)
            assert lv.shape == shape
            # signs must match the coefficients wherever nonzero
            nz = lv != 0
            assert (np.sign(lv[nz]) == np.sign(coef[nz])).all()
            # levels never exceed the ceil candidate
            sc_lv = np.abs(quant(coef, qp, 8).astype(np.int64))
            assert (np.abs(lv.astype(np.int64)) <= sc_lv + 1).all()


def _real_tu_bits(lv):
    """Actual CABAC bits of one TU's residual (fresh engine per TU)."""
    from uvg266_jax.bitstream.bitwriter import Bitstream
    from uvg266_jax.bitstream.cabac import Cabac
    from uvg266_jax.hls.residual import encode_coeff_nxn
    cabac = Cabac(Bitstream())
    cabac.init_contexts(27, 2)
    encode_coeff_nxn(cabac, np.asarray(lv, np.int16), True)
    cabac.finish()
    cabac.stream.align_zero()
    return len(cabac.stream.bytes()) * 8


def test_rdoq_rd_beats_scalar_quant():
    """Realized (SSD + lam*real_cabac_bits) must not regress on average."""
    rng = np.random.default_rng(7)
    qp = 27
    lam = qp_to_lambda(qp)
    deltas = []
    for _ in range(20):
        resid = rng.normal(0, 10, (16, 16)).astype(np.int64)
        coef = fwd_transform_2d(resid, bitdepth=8)
        costs = {}
        for name, lv in (("q", quant(coef, qp, 8)),
                         ("r", rdoq_levels(coef, qp, 8, lam))):
            r = inv_transform_2d(dequant(np.asarray(lv, np.int16), qp, 8),
                                 bitdepth=8)
            ssd = float(np.sum((resid - r) ** 2))
            costs[name] = ssd + lam * _real_tu_bits(lv)
        deltas.append(costs["r"] - costs["q"])
    assert np.mean(deltas) <= 0, f"rdoq worse on average: {np.mean(deltas)}"


def test_rdoq_e2e_oracle_and_gain():
    src = _src(256, 128)
    out = {}
    for rdoq in (False, True):
        cfg = Config(width=256, height=128, qp=27, intra_period=1, gop_len=0,
                     rdoq_enable=rdoq)
        enc = Encoder(cfg)
        (au, rec, fs, rl, _s), = enc.feed(src) + enc.flush()
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
        mse = np.mean((rec.y - src.y.astype(np.int64)) ** 2)
        out[rdoq] = (len(au) * 8, 10 * np.log10(255 ** 2 / mse))
    (b0, p0), (b1, p1) = out[False], out[True]
    # RDOQ trades bits for quality at a better-than-breakeven slope
    # (0.05 dB per 1% bits is the usual BD break-even heuristic)
    gain = (p1 - p0) - 0.05 * 100 * (b1 - b0) / b0
    assert gain > 0, f"rdoq not beneficial: {out}"


def test_rdoq_inter_slice():
    src0, src1 = _src(192, 128, 5), _src(192, 128, 6)
    cfg = Config(width=192, height=128, qp=30, rdoq_enable=True)
    enc = Encoder(cfg)
    results = enc.feed(src0) + enc.feed(src1) + enc.flush()
    for au, rec, fs, rl, _s in results:
        drec, info = decode_au(au, cfg, enc.ctrl, fs, rl)
        assert info["checksum_ok"]
        assert np.array_equal(drec.y, rec.y)
