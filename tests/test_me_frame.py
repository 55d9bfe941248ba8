"""Whole-frame fused inter search vs brute-force references."""
import numpy as np
import pytest

from uvg266_jax.ops.me_frame import (TILE, make_frame_inter_fn,
                                     make_leaf_qpel_fn, mv_bits_table)

R = 16
H, W = 48, 64


def _pad_ref(ref):
    return np.pad(ref, R, mode="edge")


def _brute_ssd(src, ref_pad, x, y, w, h):
    """[2r+1, 2r+1] SSD map for block (x, y, w, h)."""
    n = 2 * R + 1
    out = np.empty((n, n), dtype=np.float64)
    blk = src[y:y + h, x:x + w].astype(np.int64)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            patch = ref_pad[y + dy + R:y + dy + R + h,
                            x + dx + R:x + dx + R + w].astype(np.int64)
            out[dy + R, dx + R] = ((blk - patch) ** 2).sum()
    return out


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    # correlated ref so argmins aren't pure noise
    ref = np.roll(src, (2, -3), axis=(0, 1))
    ref[20:30, 10:30] = rng.integers(0, 256, (10, 20))
    return src, ref


CLASSES = (
    (8, 8, (0, 0, 8, 8, W // 8, H // 8)),
    (16, 16, (0, 0, 16, 16, W // 16, H // 16)),
    (16, 8, (0, 0, 16, 8, W // 16, H // 8)),
    (8, 16, (0, 0, 8, 16, W // 8, H // 16)),
    # TT-mid-style offset grid: 16x32 blocks at x = 8 + 32*bx
    (16, 32, (8, 0, 32, 32, (W - 8) // 32, H // 32)),
)


def test_fullpel_matches_brute_force(frames):
    src, ref = frames
    from uvg266_jax.control.partition import qp_to_lambda
    from uvg266_jax.ops.fast_cost_tables import FAST_COEFF_WTS
    from uvg266_jax.ops.me import make_mv_penalty
    from uvg266_jax.ops.rd_cost import make_rd_cost_pred_fn
    import jax

    qp, lam = 27, qp_to_lambda(27)
    pen = make_mv_penalty(R, np.sqrt(lam)).reshape(-1)
    bits = mv_bits_table(R)
    fn = jax.jit(make_frame_inter_fn(H, W, CLASSES, n_refs=1))
    wts = FAST_COEFF_WTS[qp]
    flat = np.asarray(fn(src, _pad_ref(ref)[None], pen, bits,
                         np.int32(qp), np.float32(lam), wts))
    ref_pad = _pad_ref(ref)
    off = 0
    for (w, h, grid) in CLASSES:
        x0, y0, sx, sy, gx, gy = grid
        B = gx * gy
        idx = flat[off:off + B].astype(np.int32)
        cost = flat[off + B:off + 2 * B]
        off += 2 * B
        for by in range(gy):
            for bx in range(gx):
                x, y = x0 + bx * sx, y0 + by * sy
                m = _brute_ssd(src, ref_pad, x, y, w, h)
                sel = m.reshape(-1) + pen
                k = int(idx[by * gx + bx])
                # ties can resolve differently; compare the cost value
                assert sel[k] == pytest.approx(sel.min(), rel=1e-6)
                dy, dx = k // (2 * R + 1) - R, k % (2 * R + 1) - R
                pred = ref_pad[y + dy + R:y + dy + R + h,
                               x + dx + R:x + dx + R + w]
                rd = jax.jit(make_rd_cost_pred_fn(w, h, 8))
                expect = np.asarray(rd(
                    pred[None].astype(np.int32),
                    src[y:y + h, x:x + w][None].astype(np.int32),
                    np.int32(qp), np.float32(lam), wts,
                    np.float32(bits[k])[None]))[0]
                assert cost[by * gx + bx] == pytest.approx(expect,
                                                           rel=1e-5)


def test_leaf_qpel_matches_frac_search(frames):
    src, ref = frames
    import jax
    from uvg266_jax.ops.inter import fetch_extended_block
    from uvg266_jax.ops.me import make_frac_search_fn

    w, h = 16, 16
    x, y, mvx, mvy = 16, 8, 3, -2
    fwin = fetch_extended_block(ref, x + mvx, y + mvy, w, h, 5, 5, 5, 5)
    blk = src[y:y + h, x:x + w]
    pen49 = np.zeros(49, dtype=np.float32)
    for k in range(49):
        dxq, dyq = k % 7 - 3, k // 7 - 3
        pen49[k] = 7.3 * ((0.0 if dxq == 0 else 2.0)
                          + (0.0 if dyq == 0 else 2.0))
    frac = jax.jit(make_frac_search_fn(w, h, 8))
    best_ref, _preds, costs_ref = frac(fwin[None], blk[None], pen49)
    costs_ref = np.asarray(costs_ref)[0]

    # tile-decomposed: 4 tiles, one leaf (+ padding to the bucket)
    nt, nl = 8, 3
    tiles = []
    blocks = []
    ids = []
    for i in range(h // TILE):
        for j in range(w // TILE):
            tiles.append(fwin[TILE * i:TILE * i + 18,
                              TILE * j:TILE * j + 18])
            blocks.append(blk[TILE * i:TILE * i + 8,
                              TILE * j:TILE * j + 8])
            ids.append(0)
    while len(tiles) < nt:
        tiles.append(np.zeros((18, 18), dtype=np.int32))
        blocks.append(np.zeros((8, 8), dtype=np.int32))
        ids.append(nl)
    qfn = jax.jit(make_leaf_qpel_fn(nt, nl))
    best, bcost, seg = qfn(np.stack(tiles), np.stack(blocks),
                           np.asarray(ids, dtype=np.int32), pen49)
    seg = np.asarray(seg)
    assert np.allclose(seg[0] + pen49, costs_ref)
    assert int(np.asarray(best)[0]) == int(np.asarray(best_ref)[0])
