"""Exactness of the f32 search programs on the GPU.

The CPU computes f32 convolutions and matmuls exactly at the default
precision; a GPU may round their operands to TF32 unless the program
asks for HIGHEST. These tests need the card: they skip elsewhere and run
on the GPU through `python chip_smoke.py`.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.chip

H, W, R = 1080, 1920, 16


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; runs on the card via chip_smoke.py")
    return jax


def test_tile_ssd_maps_exact_on_gpu(gpu):
    """Every 8x8 tile SSD map of a 1080p frame at range 16 is exact."""
    from uvg266_jax.ops.me_frame import TILE, tile_ssd_maps, tile_windows
    jnp = gpu.numpy
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref_pad = np.pad(np.roll(src, (3, -2), axis=(0, 1)), R, mode="edge")

    def maps(src, ref_pad):
        tiles = src.astype(jnp.float32).reshape(H // TILE, TILE, W // TILE,
                                                TILE).transpose(0, 2, 1, 3)
        w6 = tile_windows(jnp, ref_pad.astype(jnp.float32), H, W, R)
        return tile_ssd_maps(gpu, jnp, tiles.reshape(-1, 1, TILE, TILE),
                             w6, R)

    dev = np.asarray(gpu.jit(maps)(src, ref_pad))
    TY, TX, n = H // TILE, W // TILE, 2 * R + 1
    s64 = src.astype(np.int64)
    for dy, dx in ((0, 0), (R + 3, R - 2), (2 * R, 0), (5, 2 * R)):
        d = s64 - ref_pad[dy:dy + H, dx:dx + W]
        gold = (d * d).reshape(TY, TILE, TX, TILE).sum(axis=(1, 3))
        np.testing.assert_array_equal(dev[:, dy, dx].reshape(TY, TX), gold)
    assert dev.shape == (TY * TX, n, n)


def test_extract_pred_tiles_exact_on_gpu(gpu):
    """One-hot matmul extraction returns the windows' samples unchanged."""
    from uvg266_jax.ops.me_frame import TILE, extract_pred_tiles
    jnp = gpu.numpy
    rng = np.random.default_rng(6)
    T, s = 4096, TILE + 2 * R
    win = rng.integers(0, 256, (T, s, s)).astype(np.float32)
    dy = rng.integers(-R, R + 1, T).astype(np.int32)
    dx = rng.integers(-R, R + 1, T).astype(np.int32)
    dev = np.asarray(gpu.jit(lambda a, b, c: extract_pred_tiles(
        jnp, a, b, c, R))(win, dy, dx))
    gold = np.stack([win[t, dy[t] + R:dy[t] + R + TILE,
                         dx[t] + R:dx[t] + R + TILE] for t in range(T)])
    np.testing.assert_array_equal(dev, gold)


def test_matmul_predictor_exact_on_gpu(gpu):
    """The f32 HIGHEST angular-prediction matmul equals the gather form
    for 32x32 blocks with full-range references."""
    from uvg266_jax.ops.intra_batch import (REF_LEN, build_mode_tables,
                                            make_predict_fn,
                                            make_predict_matmul_fn)
    rng = np.random.default_rng(7)
    refs = rng.integers(0, 256, (64, 4 * REF_LEN)).astype(np.int32)
    tables = build_mode_tables(32, 32, 8, False)
    mm, A = make_predict_matmul_fn(tables)
    got = np.asarray(gpu.jit(mm)(refs, gpu.device_put(A)))
    want = np.asarray(gpu.jit(make_predict_fn(tables))(refs))
    np.testing.assert_array_equal(got, want)
