"""Scan table correctness + residual coding encoder/decoder round-trip."""
import numpy as np
import pytest

from uvg266_jax.bitstream.bitwriter import (Bitstream, BitstreamReader,
    strip_emulation_prevention)
from uvg266_jax.bitstream.cabac import Cabac, CabacDecoder
from uvg266_jax.hls.residual import decode_coeff_nxn, encode_coeff_nxn
from uvg266_jax.ops.scan import cg_scan_table, coeff_scan_table

# Reference tables from /root/reference/src/tables.c (generated file):
REF_DIAG_4x4 = [0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10, 7, 14, 11, 15]
REF_GROUPED_8x8_FIRST32 = [
    0, 8, 1, 16, 9, 2, 24, 17, 10, 3, 25, 18, 11, 26, 19, 27,
    32, 40, 33, 48, 41, 34, 56, 49, 42, 35, 57, 50, 43, 58, 51, 59,
]


def test_diag_scan_4x4():
    assert coeff_scan_table(2, 2).tolist() == REF_DIAG_4x4


def test_grouped_scan_8x8():
    assert coeff_scan_table(3, 3).tolist()[:32] == REF_GROUPED_8x8_FIRST32


def test_cg_scan_8x8():
    # 2x2 CG grid in diagonal order: (0,0), (0,1), (1,0), (1,1)
    assert cg_scan_table(3, 3).tolist() == [0, 2, 1, 3]


def _roundtrip(coef, is_luma, qp=27, dep_quant=False, signhide=False):
    cab = Cabac()
    cab.init_contexts(qp, 2)
    encode_coeff_nxn(cab, coef, is_luma, dep_quant, signhide)
    cab.encode_bin_trm(1)
    cab.finish()
    cab.stream.align_zero()
    data = strip_emulation_prevention(cab.stream.bytes())

    dec = CabacDecoder(BitstreamReader(data))
    dec.init_contexts(qp, 2)
    h, w = coef.shape
    out = decode_coeff_nxn(dec, w, h, is_luma, dep_quant, signhide)
    np.testing.assert_array_equal(out, coef)
    # context states must match exactly after the round trip
    assert dec.s0 == cab.s0 and dec.s1 == cab.s1


SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (16, 4),
         (4, 16), (32, 8), (8, 32), (2, 8), (8, 2), (2, 4), (16, 32)]


@pytest.mark.parametrize("w,h", SIZES)
def test_roundtrip_random_sparse(w, h):
    rng = np.random.default_rng(w * 100 + h)
    for trial in range(8):
        coef = np.zeros((h, w), dtype=np.int32)
        n = rng.integers(1, max(2, w * h // 4))
        idx = rng.choice(w * h, size=n, replace=False)
        coef.reshape(-1)[idx] = rng.integers(-40, 40, size=n)
        if not coef.any():
            coef[0, 0] = 1
        _roundtrip(coef, is_luma=True)
        _roundtrip(coef, is_luma=False)


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32)])
def test_roundtrip_dense_large_values(w, h):
    rng = np.random.default_rng(42 + w)
    coef = rng.integers(-500, 500, size=(h, w)).astype(np.int32)
    if not coef.any():
        coef[0, 0] = 1
    _roundtrip(coef, is_luma=True)
    _roundtrip(coef, is_luma=False)


def test_roundtrip_single_dc():
    coef = np.zeros((8, 8), dtype=np.int32)
    coef[0, 0] = -1
    _roundtrip(coef, is_luma=True)


def test_roundtrip_last_corner():
    coef = np.zeros((16, 16), dtype=np.int32)
    coef[15, 15] = 3
    coef[0, 0] = 7
    _roundtrip(coef, is_luma=True)


def test_roundtrip_multiple_blocks_shared_context():
    """Several TUs through one cabac stream, mirroring slice coding."""
    rng = np.random.default_rng(7)
    blocks = []
    for _ in range(6):
        coef = np.zeros((8, 8), dtype=np.int32)
        idx = rng.choice(64, size=10, replace=False)
        coef.reshape(-1)[idx] = rng.integers(-10, 10, size=10)
        if not coef.any():
            coef[0, 0] = 1
        blocks.append(coef)

    cab = Cabac()
    cab.init_contexts(30, 2)
    for b in blocks:
        encode_coeff_nxn(cab, b, True)
    cab.encode_bin_trm(1)
    cab.finish()
    cab.stream.align_zero()

    dec = CabacDecoder(BitstreamReader(strip_emulation_prevention(cab.stream.bytes())))
    dec.init_contexts(30, 2)
    for b in blocks:
        out = decode_coeff_nxn(dec, 8, 8, True)
        np.testing.assert_array_equal(out, b)
