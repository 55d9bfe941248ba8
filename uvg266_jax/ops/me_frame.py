"""Whole-frame fused inter search: every size class, one dispatch.

Replaces per-class motion search dispatches (reference: search_inter.c
search_pu_inter per-CU loops) with ONE program that computes the ENTIRE
frame's full-pel motion field for every partition-lattice size class
from one set of device tensors:

1. 8x8 *tile* SSD maps: SSD(tile, dy, dx) for all |dy|,|dx| <= r via a
   grouped convolution (the cross-correlation decomposition of
   ops.me).  Any aligned WxH block's SSD at a full-pel offset is the sum
   of its tiles' SSDs at that offset, so one conv serves every class.
2. per-class block SSD maps by strided tile-map summation (static
   slices, no gathers), + rate penalty, argmin -> full-pel MV per block.
3. prediction extraction at the chosen MV as two one-hot batched
   matmuls per 8x8 tile (a gather expressed as a matmul).
4. the shared fast RD model (ops.rd_cost) on the extracted prediction,
   so inter and intra candidates feed the partition DP in identical
   cost units.

Every f32 convolution and matmul here runs at Precision.HIGHEST, which
keeps them exact at 8-bit on every backend (see tile_ssd_maps).

Quarter-pel refinement runs as a second, leaf-level pass after the
partition decision (make_leaf_qpel_fn): the 49-offset interpolation grid
of ops.me.make_frac_search_fn evaluated on 8x8 tiles and segment-summed
per leaf, so one dispatch refines every chosen leaf regardless of shape.
"""
from __future__ import annotations

import numpy as np

from .me import mv_bits_est

TILE = 8


def mv_bits_table(r: int, extra: float = 4.0) -> np.ndarray:
    """[(2r+1)^2] f32: signaled-bits estimate for each full-pel offset
    (quarter-pel mvd magnitude = 4*offset) + per-CU inter overhead."""
    n = 2 * r + 1
    out = np.empty(n * n, dtype=np.float32)
    for k in range(n * n):
        dy, dx = k // n - r, k % n - r
        out[k] = mv_bits_est(4 * dx) + mv_bits_est(4 * dy) + extra
    return out


def tile_windows(jnp, ref_pad, H: int, W: int, r: int):
    """[T, 8+2r, 8+2r] search windows for every 8x8 tile, from the
    edge-padded reference [H+2r, W+2r]. Static slices only."""
    TY, TX = H // TILE, W // TILE
    n8 = (2 * r) // TILE + 1            # window side in tiles
    rows = []
    for ay in range(n8):
        row = []
        for ax in range(n8):
            sub = ref_pad[TILE * ay:TILE * ay + H,
                          TILE * ax:TILE * ax + W]
            sub = sub.reshape(TY, TILE, TX, TILE).transpose(0, 2, 1, 3)
            row.append(sub)                       # [TY, TX, 8, 8]
        rows.append(jnp.stack(row, axis=2))       # [TY, TX, n8, 8, 8]
    w6 = jnp.stack(rows, axis=2)                  # [TY, TX, n8(ay), n8(ax), 8, 8]
    w6 = w6.transpose(0, 1, 2, 4, 3, 5)           # [TY, TX, ay, i, ax, j]
    side = n8 * TILE
    return w6.reshape(TY * TX, side, side)


def tile_ssd_maps(jax, jnp, src_tiles, windows, r: int):
    """src_tiles [T, 1, 8, 8] f32, windows [T, s, s] f32 ->
    SSD maps [T, 2r+1, 2r+1] f32 (exact for 8-bit: sums < 2^23, and
    HIGHEST keeps the full f32 significand where the backend's default
    would round the operands, e.g. to TF32)."""
    HIGHEST = jax.lax.Precision.HIGHEST
    T = src_tiles.shape[0]
    corr = jax.lax.conv_general_dilated(
        windows[None], src_tiles, (1, 1), "VALID",
        feature_group_count=T, precision=HIGHEST)[0]      # [T, n, n]
    ones = jnp.ones((1, 1, TILE, TILE), dtype=windows.dtype)
    r2 = jax.lax.conv_general_dilated(
        (windows * windows)[:, None], ones, (1, 1), "VALID",
        precision=HIGHEST)[:, 0]
    b2 = (src_tiles * src_tiles).sum(axis=(-2, -1))       # [T, 1]
    return b2[..., None] - 2.0 * corr + r2


def class_block_maps(jnp, ssd_t, grid, w: int, h: int):
    """Sum tile SSD maps into block SSD maps for one size class.

    ssd_t: [TY, TX, n, n]; grid: (x0, y0, sx, sy, gx, gy) in pixels
    (all multiples of 8). Returns [gy, gx, n, n]."""
    x0, y0, sx, sy, gx, gy = grid
    tx0, ty0 = x0 // TILE, y0 // TILE
    sxT, syT = sx // TILE, sy // TILE
    wT, hT = w // TILE, h // TILE
    acc = None
    for i in range(hT):
        for j in range(wT):
            sl = ssd_t[ty0 + i:ty0 + i + (gy - 1) * syT + 1:syT,
                       tx0 + j:tx0 + j + (gx - 1) * sxT + 1:sxT]
            acc = sl if acc is None else acc + sl
    return acc


def spread_to_tiles(jnp, vals, grid, w: int, h: int, TY: int, TX: int,
                    fill=0):
    """Broadcast a per-block [gy, gx] value onto the tiles each block
    covers; uncovered tiles get `fill`. Static reshapes/pads only."""
    x0, y0, sx, sy, gx, gy = grid
    tx0, ty0 = x0 // TILE, y0 // TILE
    sxT, syT = sx // TILE, sy // TILE
    wT, hT = w // TILE, h // TILE
    v = vals[:, None, :, None]                       # [gy, 1, gx, 1]
    v = jnp.broadcast_to(v, (gy, syT, gx, sxT))
    if hT < syT or wT < sxT:                          # offset-grid strides
        mask = jnp.zeros((syT, sxT), dtype=bool)
        mask = mask.at[:hT, :wT].set(True)
        v = jnp.where(mask[None, :, None, :], v, fill)
    v = v.reshape(gy * syT, gx * sxT)
    v = v[:(gy - 1) * syT + hT, :(gx - 1) * sxT + wT]
    eh, ew = v.shape
    return jnp.pad(v, ((ty0, TY - ty0 - eh), (tx0, TX - tx0 - ew)),
                   constant_values=fill)


def extract_pred_tiles(jnp, windows, tile_dy, tile_dx, r: int):
    """Gather-as-matmul prediction: per tile, select the 8x8 patch at
    offset (dy, dx) from its search window via two one-hot matmuls.

    windows [T, s, s] f32, tile_dy/tile_dx [T] i32 in [-r, r].
    Returns [T, 8, 8] f32 (exact: one-hot selection at HIGHEST)."""
    from jax.lax import Precision
    s = windows.shape[-1]
    ii = jnp.arange(TILE, dtype=jnp.int32)[None, :, None]
    jj = jnp.arange(s, dtype=jnp.int32)[None, None, :]
    oh_v = (jj == ii + (tile_dy[:, None, None] + r)).astype(windows.dtype)
    rows = jnp.matmul(oh_v, windows, precision=Precision.HIGHEST,
                      preferred_element_type=windows.dtype)  # [T, 8, s]
    jj2 = jnp.arange(s, dtype=jnp.int32)[None, :, None]
    kk = jnp.arange(TILE, dtype=jnp.int32)[None, None, :]
    oh_h = (jj2 == kk + (tile_dx[:, None, None] + r)).astype(windows.dtype)
    return jnp.matmul(rows, oh_h, precision=Precision.HIGHEST,
                      preferred_element_type=windows.dtype)


def tiles_to_plane(jnp, tiles, H: int, W: int):
    """[T, 8, 8] -> [H, W]."""
    TY, TX = H // TILE, W // TILE
    return tiles.reshape(TY, TX, TILE, TILE).transpose(0, 2, 1, 3) \
        .reshape(H, W)


def blocks_of_plane(jnp, plane, grid, w: int, h: int):
    """Strided-slice block extraction [B, h, w] for a class grid (the
    blocks half of intra_batch.make_refs_blocks_grid_fn)."""
    x0, y0, sx, sy, gx, gy = grid
    blk = plane[y0:y0 + (gy - 1) * sy + h, x0:x0 + (gx - 1) * sx + w]
    # pad the tail so a [gy, sy, gx, sx] reshape is legal for offset grids
    ph = gy * sy - blk.shape[0]
    pw = gx * sx - blk.shape[1]
    if ph or pw:
        blk = jnp.pad(blk, ((0, ph), (0, pw)))
    blk = blk.reshape(gy, sy, gx, sx)[:, :h, :, :w]
    return blk.transpose(0, 2, 1, 3).reshape(gy * gx, h, w)


def make_frame_inter_fn(H: int, W: int, classes, n_refs: int,
                        bitdepth: int = 8, r: int = 16):
    """Whole-frame inter search for every class over n_refs references.

    classes: tuple of (w, h, grid); grid = (x0, y0, sx, sy, gx, gy), all
    multiples of 8. Returns fn(src [H, W] int, refs_pad
    [R, H+2r, W+2r] int, pen_sel [(2r+1)^2] f32, bits_tab [(2r+1)^2] f32,
    qp i32, lam f32, wts [4] f32) -> flat f32 vector: for each ref, for
    each class: (best_offset_idx [B], rd_cost [B])."""
    import jax
    import jax.numpy as jnp

    from .rd_cost import make_rd_cost_pred_fn

    TY, TX = H // TILE, W // TILE
    n = 2 * r + 1
    rd_fns = {}
    for (w, h, _g) in classes:
        if (w, h) not in rd_fns:
            rd_fns[(w, h)] = make_rd_cost_pred_fn(w, h, bitdepth)

    def frame_inter(src, refs_pad, pen_sel, bits_tab, qp, lam, wts):
        srcf = src.astype(jnp.float32)
        src_tiles = srcf.reshape(TY, TILE, TX, TILE) \
            .transpose(0, 2, 1, 3).reshape(TY * TX, 1, TILE, TILE)
        src_i = src.astype(jnp.int32)
        vecs = []
        for ri in range(n_refs):
            windows = refs_pad[ri].astype(jnp.float32)
            w6 = tile_windows(jnp, windows, H, W, r)
            ssd = tile_ssd_maps(jax, jnp, src_tiles, w6, r)
            ssd_t = ssd.reshape(TY, TX, n, n)
            pen = pen_sel.reshape(n, n)
            for (w, h, grid) in classes:
                bm = class_block_maps(jnp, ssd_t, grid, w, h)
                gy, gx = bm.shape[0], bm.shape[1]
                flat = (bm + pen[None, None]).reshape(gy, gx, n * n)
                idx = jnp.argmin(flat, axis=-1).astype(jnp.int32)
                dy = idx // n - r
                dx = idx % n - r
                tdy = spread_to_tiles(jnp, dy, grid, w, h, TY, TX)
                tdx = spread_to_tiles(jnp, dx, grid, w, h, TY, TX)
                pt = extract_pred_tiles(jnp, w6, tdy.reshape(-1),
                                        tdx.reshape(-1), r)
                plane = tiles_to_plane(jnp, pt, H, W).astype(jnp.int32)
                preds = blocks_of_plane(jnp, plane, grid, w, h)
                blocks = blocks_of_plane(jnp, src_i, grid, w, h)
                extra = bits_tab[idx.reshape(-1)]
                cost = rd_fns[(w, h)](preds, blocks, qp, lam, wts, extra)
                vecs.append(idx.reshape(-1).astype(jnp.float32))
                vecs.append(cost)
        return jnp.concatenate(vecs)

    return frame_inter


def make_leaf_qpel_fn(n_tiles: int, n_leaves: int, bitdepth: int = 8):
    """Quarter-pel refinement for a batch of decided leaves, shape-
    agnostic via 8x8 tile decomposition (padded/bucketed sizes).

    fn(windows [n_tiles, 18, 18] int (tile at (5, 5), edge-extended;
    padding tiles = zeros), blocks [n_tiles, 8, 8] int source tiles,
    leaf_ids [n_tiles] i32 (sorted; padding -> n_leaves), pen [49] f32)
    -> (best_off [n_leaves] i32, best_cost [n_leaves] f32,
    satd49 [n_leaves, 49] f32).

    Offset k -> quarter-pel (dx, dy) = (k % 7 - 3, k // 7 - 3), matching
    ops.me.make_frac_search_fn. SATD sums over 8x8 tiles equal the VVC
    block SATD for all w, h >= 8 (satd_bw tiles the same way)."""
    import jax
    import jax.numpy as jnp

    from .inter import LUMA_FILTER

    PAD = 5
    h = w = TILE

    def interp_one(windows, offq_x, offq_y):
        ix = (offq_x * 4) >> 4
        iy = (offq_y * 4) >> 4
        fx = (offq_x * 4) & 15
        fy = (offq_y * 4) & 15
        if fx == 0 and fy == 0:
            return windows[:, PAD + iy:PAD + iy + h,
                           PAD + ix:PAD + ix + w].astype(jnp.int32)
        hf = LUMA_FILTER[fx]
        vf = LUMA_FILTER[fy]
        hor = None
        for t in range(8):
            sl = windows[:, PAD + iy - 3:PAD + iy + h + 4,
                         PAD + ix - 3 + t:PAD + ix - 3 + t + w]
            term = int(hf[t]) * sl
            hor = term if hor is None else hor + term
        hor = hor >> (bitdepth - 8) if bitdepth > 8 else hor
        out = None
        for t in range(8):
            term = int(vf[t]) * hor[:, t:t + h]
            out = term if out is None else out + term
        out = out >> 6
        wp_shift = 14 - bitdepth
        out = (out + (1 << (wp_shift - 1))) >> wp_shift
        return jnp.clip(out, 0, (1 << bitdepth) - 1).astype(jnp.int32)

    hm = np.array([[1]], dtype=np.int64)
    while hm.shape[0] < 8:
        hm = np.block([[hm, hm], [hm, -hm]])

    def satd8(d):
        # [T, C, 8, 8] -> [T, C] (reference 8x8 Hadamard SATD)
        hmj = jnp.asarray(hm.astype(np.int32))
        t = jnp.abs(jnp.matmul(jnp.matmul(hmj, d,
                                          preferred_element_type=jnp.int32),
                               hmj, preferred_element_type=jnp.int32))
        s = t.sum(axis=(-2, -1))
        dc = t[..., 0, 0]
        s = s - dc + (dc >> 2)
        return (s + 2) >> 2

    def refine(windows, blocks, leaf_ids, pen):
        windows = windows.astype(jnp.int32)
        preds = jnp.stack([interp_one(windows, k % 7 - 3, k // 7 - 3)
                           for k in range(49)], axis=1)    # [T, 49, 8, 8]
        d = blocks[:, None].astype(jnp.int32) - preds
        satds = satd8(d).astype(jnp.float32)               # [T, 49]
        seg = jax.ops.segment_sum(satds, leaf_ids,
                                  num_segments=n_leaves + 1,
                                  indices_are_sorted=True)[:n_leaves]
        costs = seg + pen[None]
        best = jnp.argmin(costs, axis=1).astype(jnp.int32)
        return best, jnp.min(costs, axis=1), seg

    return refine
