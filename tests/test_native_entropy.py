"""Native C++ entropy coder vs Python golden engine: byte-identical."""
import numpy as np
import pytest

from uvg266_jax.bitstream.bitwriter import Bitstream
from uvg266_jax.bitstream.cabac import Cabac
from uvg266_jax.hls.residual import encode_coeff_nxn

try:
    from uvg266_jax.native import NativeCabac, get_lib
    get_lib()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="no g++ native lib")


def test_bin_sequences_identical():
    rng = np.random.default_rng(0)
    py = Cabac()
    py.init_contexts(27, 2)
    nc = NativeCabac()
    nc.init_contexts(27, 2)
    for _ in range(5000):
        op = rng.integers(0, 5)
        if op == 0:
            ctx, b = int(rng.integers(0, 300)), int(rng.integers(0, 2))
            py.encode_bin(ctx, b)
            nc.encode_bin(ctx, b)
        elif op == 1:
            b = int(rng.integers(0, 2))
            py.encode_bin_ep(b)
            nc.encode_bin_ep(b)
        elif op == 2:
            n = int(rng.integers(1, 16))
            v = int(rng.integers(0, 1 << n))
            py.encode_bins_ep(v, n)
            nc.encode_bins_ep(v, n)
        elif op == 3:
            mx = int(rng.integers(2, 100))
            v = int(rng.integers(0, mx))
            py.encode_trunc_bin(v, mx)
            nc.encode_trunc_bin(v, mx)
        else:
            r = int(rng.integers(0, 4))
            rem = int(rng.integers(0, 2000))
            py.write_coeff_remain(rem, r, 5)
            nc.write_coeff_remain(rem, r, 5)
    py.encode_bin_trm(1)
    nc.encode_bin_trm(1)
    py.finish()
    nc.finish()
    py.stream.align_zero()
    nc.align_zero()
    assert nc.bytes() == py.stream.bytes()
    s0, s1 = nc.get_context_states()
    assert list(s0) == py.s0 and list(s1) == py.s1


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (8, 4), (16, 32), (2, 8), (8, 2)])
def test_coeff_nxn_identical(w, h):
    rng = np.random.default_rng(w * 7 + h)
    blocks = []
    for _ in range(6):
        coef = np.zeros((h, w), dtype=np.int32)
        n = int(rng.integers(1, max(2, w * h // 3)))
        idx = rng.choice(w * h, size=n, replace=False)
        coef.reshape(-1)[idx] = rng.integers(-300, 300, size=n)
        if not coef.any():
            coef[0, 0] = 1
        blocks.append(coef)

    py = Cabac()
    py.init_contexts(30, 2)
    nc = NativeCabac()
    nc.init_contexts(30, 2)
    for i, b in enumerate(blocks):
        encode_coeff_nxn(py, b, is_luma=(i % 2 == 0))
        encode_coeff_nxn(nc, b, is_luma=(i % 2 == 0))
    py.encode_bin_trm(1)
    nc.encode_bin_trm(1)
    py.finish()
    nc.finish()
    py.stream.align_zero()
    nc.align_zero()
    assert nc.bytes() == py.stream.bytes()
    s0, s1 = nc.get_context_states()
    assert list(s0) == py.s0 and list(s1) == py.s1


def test_emulation_prevention_and_zerocount_splice():
    """Escape state must carry across the header/payload boundary."""
    py = Cabac()
    py.init_contexts(20, 2)
    nc = NativeCabac(zerocount=2)      # as if header ended with 00 00
    nc.init_contexts(20, 2)
    for i in range(200):
        py.encode_bin(5, 0)
        nc.encode_bin(5, 0)
    py.finish()
    nc.finish()
    py.stream.align_zero()
    nc.align_zero()
    # python side with pre-set zerocount
    py2 = Cabac()
    py2.stream.zerocount = 2
    py2.init_contexts(20, 2)
    for i in range(200):
        py2.encode_bin(5, 0)
    py2.finish()
    py2.stream.align_zero()
    assert nc.bytes() == py2.stream.bytes()
