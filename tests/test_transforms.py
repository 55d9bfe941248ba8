import hashlib

import numpy as np
import pytest

from uvg266_jax.ops import tr_matrices as T
from uvg266_jax.ops.quant import dequant, quant
from uvg266_jax.ops.transforms import (
    fwd_transform_2d,
    inv_transform_2d,
    make_fwd_fn,
    make_inv_fn,
)

# sha256[:16] of the reference tables (dct-generic.c), frozen after
# element-exact verification of the generators against them.
MATRIX_HASHES = {
    ("dct2", 2): "e8a896e4b1f5ce51",
    ("dct2", 4): "fb4cd1a55fc62e61",
    ("dct2", 8): "6096e94d843090e2",
    ("dct2", 16): "f8f3979174ac7463",
    ("dct2", 32): "5fe02392e3e43d03",
    ("dct2", 64): "1b41f61adea01069",
    ("dct8", 4): "7f10fab430f9b2fe",
    ("dct8", 8): "29fd3af741cd5d17",
    ("dct8", 16): "b3d02d724dcf19fb",
    ("dct8", 32): "cdeb487227d90ca1",
    ("dst7", 4): "640bfc57ea39d9ed",
    ("dst7", 8): "49782b4a7bef7546",
    ("dst7", 16): "4766cb60aea42101",
    ("dst7", 32): "dbac4eab71f4d877",
}


def test_matrix_hashes():
    gens = {"dct2": T.dct2_matrix, "dst7": T.dst7_matrix, "dct8": T.dct8_matrix}
    for (name, n), want in MATRIX_HASHES.items():
        m = gens[name](n)
        assert hashlib.sha256(m.tobytes()).hexdigest()[:16] == want, (name, n)


def test_dct2_known_rows():
    m4 = T.dct2_matrix(4)
    assert m4.tolist() == [
        [64, 64, 64, 64], [83, 36, -36, -83], [64, -64, -64, 64], [36, -83, 83, -36]]
    m_dst7 = T.dst7_matrix(4)
    assert m_dst7.tolist() == [
        [29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55], [55, -84, 74, -29]]


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8),
                                 (8, 4), (16, 4), (32, 8), (8, 32), (64, 64),
                                 (64, 32), (4, 16)])
def test_fwd_inv_roundtrip_dct2(w, h):
    rng = np.random.RandomState(hash((w, h)) % 2**32)
    if max(w, h) > 32:
        # 64-point dims zero out freqs >= 32: use a smooth input so the
        # round-trip is still near-lossless
        yy, xx = np.mgrid[0:h, 0:w]
        x = (100 * np.sin(yy / 7.0) * np.cos(xx / 9.0)).astype(np.int32)
        tol = 8
    else:
        x = rng.randint(-255, 256, (h, w)).astype(np.int32)
        tol = 8
    c = fwd_transform_2d(x, bitdepth=8)
    y = inv_transform_2d(c.astype(np.int32), bitdepth=8)
    assert np.abs(y.astype(int) - x).max() <= tol, np.abs(y - x).max()


@pytest.mark.parametrize("th,tv", [(T.DST7, T.DST7), (T.DCT8, T.DCT8),
                                   (T.DST7, T.DCT8), (T.DCT2, T.DST7)])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (4, 16), (16, 8)])
def test_fwd_inv_roundtrip_mts(w, h, th, tv):
    rng = np.random.RandomState(1)
    x = rng.randint(-255, 256, (h, w)).astype(np.int32)
    c = fwd_transform_2d(x, th, tv, bitdepth=8)
    y = inv_transform_2d(c.astype(np.int32), th, tv, bitdepth=8)
    assert np.abs(y.astype(int) - x).max() <= 8


def test_mts_32_zero_out():
    rng = np.random.RandomState(2)
    x = rng.randint(-255, 256, (32, 32)).astype(np.int32)
    c = fwd_transform_2d(x, T.DST7, T.DST7, bitdepth=8)
    assert np.all(c[:, 16:] == 0) and np.all(c[16:, :] == 0)
    c2 = fwd_transform_2d(x, T.DCT2, T.DCT2, bitdepth=8)
    assert np.any(c2[:, 16:] != 0)


def test_jax_matches_numpy():
    import jax
    rng = np.random.RandomState(3)
    for (w, h, th, tv) in [(8, 8, T.DCT2, T.DCT2), (16, 4, T.DST7, T.DCT8),
                           (32, 32, T.DCT2, T.DCT2), (4, 4, T.DST7, T.DST7)]:
        x = rng.randint(-512, 512, (5, h, w)).astype(np.int32)
        fwd = jax.jit(jax.vmap(make_fwd_fn(w, h, th, tv)))
        inv = jax.jit(jax.vmap(make_inv_fn(w, h, th, tv)))
        c_jax = np.asarray(fwd(x))
        c_np = np.stack([fwd_transform_2d(xi, th, tv) for xi in x])
        assert np.array_equal(c_jax, c_np), (w, h, th, tv)
        y_jax = np.asarray(inv(c_jax.astype(np.int32)))
        y_np = np.stack([inv_transform_2d(ci.astype(np.int32), th, tv) for ci in c_np])
        assert np.array_equal(y_jax, y_np)


def test_quant_dequant_roundtrip():
    rng = np.random.RandomState(4)
    for qp in (10, 22, 27, 37, 51):
        for (w, h) in [(4, 4), (8, 8), (16, 16), (32, 32), (8, 4)]:
            x = rng.randint(-255, 256, (h, w)).astype(np.int32)
            c = fwd_transform_2d(x)
            q = quant(c.astype(np.int32), qp)
            dq = dequant(q.astype(np.int32), qp)
            # dequantized coeffs approximate original within one quant step
            step = 2 ** (qp / 6.0)
            err = np.abs(dq.astype(float) - c.astype(float))
            assert err.max() <= step * 18, (qp, w, h, err.max())


def test_quant_zero_at_high_qp():
    x = np.ones((8, 8), dtype=np.int32)
    c = fwd_transform_2d(x)
    q = quant(c.astype(np.int32), 51)
    assert np.abs(q).sum() <= 1


def test_jax_quant_matches_numpy():
    import jax
    from uvg266_jax.ops.quant import make_dequant_fn, make_quant_fn
    rng = np.random.RandomState(5)
    c = rng.randint(-3000, 3000, (4, 8, 8)).astype(np.int32)
    for qp in (17, 30, 44):
        qf = jax.jit(make_quant_fn(8, 8), static_argnums=())
        dqf = jax.jit(make_dequant_fn(8, 8))
        q_jax = np.asarray(qf(c, qp))
        q_np = np.stack([quant(ci, qp) for ci in c])
        assert np.array_equal(q_jax, q_np), qp
        dq_jax = np.asarray(dqf(q_jax, qp))
        dq_np = np.stack([dequant(qi.astype(np.int32), qp) for qi in q_np])
        assert np.array_equal(dq_jax, dq_np), qp
