"""Batched rate-distortion block costing for the partition/mode search.

For a batch of blocks: pick the best intra mode by SATD, then run the
real forward path (DCT2 -> quant -> dequant -> IDCT2, all exact int32
matmuls) and score rd = SSD + lambda * bits_est, with
bits_est from the trained fast coefficient-cost model
(fast_cost_tables.FAST_COEFF_WTS, the reference's --fast-residual-cost
path, quant-generic.c:688).

This is the cost that drives the bottom-up QT partition DP — the batched
replacement of the reference's per-CU recon RD inside search_cu.
"""
from __future__ import annotations

import numpy as np

from .quant import INV_QUANT_SCALES, QUANT_SCALES
from .tr_matrices import DCT2, get_matrix
from .transforms import fwd_shifts, inv_shifts

LOG2 = {4: 2, 8: 3, 16: 4, 32: 5, 64: 6}


def make_rd_cost_pred_fn(w: int, h: int, bitdepth: int = 8,
                         is_intra_slice: bool = False):
    """Like make_rd_cost_fn but for a single given prediction per block
    (the inter path): (pred [B,h,w], src [B,h,w], qp, lam, wts,
    extra_bits [B]) -> rd_cost [B] f32."""
    import jax.numpy as jnp

    log2_w, log2_h = LOG2[w], LOG2[h]
    s1, s2 = fwd_shifts(w, h, bitdepth)
    si1, si2 = inv_shifts(bitdepth)
    mh_t = jnp.asarray(get_matrix(DCT2, w).T, dtype=jnp.int32)
    mv = jnp.asarray(get_matrix(DCT2, h), dtype=jnp.int32)
    mh = jnp.asarray(get_matrix(DCT2, w), dtype=jnp.int32)
    mv_t = jnp.asarray(get_matrix(DCT2, h).T, dtype=jnp.int32)
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    tshift = 15 - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    q_scales = jnp.asarray(QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)
    iq_scales = jnp.asarray(INV_QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)
    tshift_d = 15 - bitdepth - ((log2_w + log2_h) >> 1)
    dq_shift = 20 - 14 - (tshift_d - needs_sqrt2)
    add_base = 171 if is_intra_slice else 85

    def rd(pred, src, qp, lam, wts, extra_bits):
        resid = src.astype(jnp.int32) - pred.astype(jnp.int32)
        t = (jnp.matmul(resid, mh_t, preferred_element_type=jnp.int32)
             + (1 << (s1 - 1))) >> s1
        t = t.astype(jnp.int16).astype(jnp.int32)
        coef = ((jnp.matmul(mv, t, preferred_element_type=jnp.int32)
                 + (1 << (s2 - 1))) >> s2).astype(jnp.int16).astype(jnp.int32)
        q_bits = 14 + qp // 6 + tshift
        scale = q_scales[qp % 6]
        add = add_base << (q_bits - 9)
        a = jnp.abs(coef)
        level = jnp.clip((a * scale + add) >> q_bits, 0, 32767)
        bucket = jnp.minimum(level, 3)
        bits = wts[bucket].sum(axis=(-2, -1))
        iscale = iq_scales[qp % 6] << (qp // 6)
        dq = (jnp.sign(coef) * level * iscale
              + (1 << (dq_shift - 1))) >> dq_shift
        dq = jnp.clip(dq, -32768, 32767)
        u = (jnp.matmul(mv_t, dq, preferred_element_type=jnp.int32)
             + (1 << (si1 - 1))) >> si1
        u = jnp.clip(u, -32768, 32767)
        r = (jnp.matmul(u, mh, preferred_element_type=jnp.int32)
             + (1 << (si2 - 1))) >> si2
        r = jnp.clip(r, -32768, 32767)
        rec = jnp.clip(pred + r, 0, (1 << bitdepth) - 1)
        # int32: a 64x64 SSD stays < 2^31 while RMS |d| < 724 (8-bit: <= 255)
        d = (src - rec).astype(jnp.int32)
        ssd = (d * d).sum(axis=(-2, -1)).astype(jnp.float32)
        return ssd + lam * (bits + extra_bits)

    return rd


def make_rd_cost_fn(w: int, h: int, bitdepth: int = 8,
                    is_intra_slice: bool = True):
    """Returns jittable fn (preds [B,67,h,w] i32, src [B,h,w] i32,
    qp i32, lam f32, wts [4] f32, mode_bits [67] f32)
    -> (best_mode [B] i32, rd_cost [B] f32, satd_best [B] i32)."""
    import jax.numpy as jnp

    from .intra_batch import make_satd67_fn

    log2_w, log2_h = LOG2[w], LOG2[h]
    s1, s2 = fwd_shifts(w, h, bitdepth)
    si1, si2 = inv_shifts(bitdepth)
    mh_t = jnp.asarray(get_matrix(DCT2, w).T, dtype=jnp.int32)
    mv = jnp.asarray(get_matrix(DCT2, h), dtype=jnp.int32)
    mh = jnp.asarray(get_matrix(DCT2, w), dtype=jnp.int32)
    mv_t = jnp.asarray(get_matrix(DCT2, h).T, dtype=jnp.int32)

    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    tshift = 15 - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    q_scales = jnp.asarray(QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)
    iq_scales = jnp.asarray(INV_QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)
    tshift_d = 15 - bitdepth - ((log2_w + log2_h) >> 1)
    dq_shift = 20 - 14 - (tshift_d - needs_sqrt2)
    add_base = 171 if is_intra_slice else 85
    satd67 = make_satd67_fn(w, h)

    def rd(preds, src, qp, lam, wts, mode_bits):
        satds = satd67(preds, src)                    # [B, 67]
        lam_sqrt = jnp.sqrt(lam)
        mode_cost = satds.astype(jnp.float32) + lam_sqrt * mode_bits[None, :]
        best = jnp.argmin(mode_cost, axis=1)
        satd_best = jnp.take_along_axis(satds, best[:, None], axis=1)[:, 0]
        pred = jnp.take_along_axis(
            preds, best[:, None, None, None], axis=1)[:, 0]

        resid = src.astype(jnp.int32) - pred
        t = (jnp.matmul(resid, mh_t, preferred_element_type=jnp.int32)
             + (1 << (s1 - 1))) >> s1
        t = t.astype(jnp.int16).astype(jnp.int32)
        coef = ((jnp.matmul(mv, t, preferred_element_type=jnp.int32)
                 + (1 << (s2 - 1))) >> s2).astype(jnp.int16).astype(jnp.int32)

        q_bits = 14 + qp // 6 + tshift
        scale = q_scales[qp % 6]
        add = add_base << (q_bits - 9)
        # int32 is sufficient here: |coef| <= 2^15 and scale < 2^15; search
        # cost only (the bit-exact path quantizes on the host in int64)
        a = jnp.abs(coef)
        level = ((a * scale + add) >> q_bits).astype(jnp.int32)
        level = jnp.clip(level, 0, 32767)

        # bits estimate: trained bucket weights + mode bits
        bucket = jnp.minimum(level, 3)
        bits = wts[bucket].sum(axis=(-2, -1))

        # distortion: dequant + inverse transform, SSD vs source
        iscale = iq_scales[qp % 6] << (qp // 6)
        dq = (jnp.sign(coef) * level * iscale
              + (1 << (dq_shift - 1))) >> dq_shift
        dq = jnp.clip(dq, -32768, 32767).astype(jnp.int32)
        u = (jnp.matmul(mv_t, dq, preferred_element_type=jnp.int32)
             + (1 << (si1 - 1))) >> si1
        u = jnp.clip(u, -32768, 32767)
        r = (jnp.matmul(u, mh, preferred_element_type=jnp.int32)
             + (1 << (si2 - 1))) >> si2
        r = jnp.clip(r, -32768, 32767)
        rec = jnp.clip(pred + r, 0, (1 << bitdepth) - 1)
        # int32: a 64x64 SSD stays < 2^31 while RMS |d| < 724 (8-bit: <= 255)
        d = (src - rec).astype(jnp.int32)
        ssd = (d * d).sum(axis=(-2, -1)).astype(jnp.float32)

        rd_cost = ssd + lam * (bits + jnp.take(mode_bits, best))
        return best.astype(jnp.int32), rd_cost, satd_best

    return rd


def make_rough_refine_fn(w: int, h: int, bitdepth: int = 8,
                         is_intra_slice: bool = True):
    """Two-stage intra mode search (the reference's rough search,
    search_intra.c search_intra_rough: coarse mode grid then +-1
    refinement), fused into one jittable fn:

    (refs [B, 4*REF_LEN], src [B, h, w], qp, lam, wts, mode_bits [67])
    -> (best_mode [B] i32, rd_cost [B] f32, satd_best [B] i32)

    Stage 1 predicts planar + DC + the EVEN angular modes (35 of 67) and
    scores them by SATD + lambda_sqrt*mode_bits; stage 2 predicts the +-1
    odd neighbors of the two best angular candidates per block (4 modes,
    gather-based dynamic mode indexing); the winner gets the same full
    transform-domain RD cost as make_rd_cost_fn. Cuts predicted modes
    ~67 -> 39 with near-identical decisions (the SATD-vs-mode curve is
    smooth; see test_intra_batch.py::test_rough_refine)."""
    import jax
    import jax.numpy as jnp

    from .intra_batch import (build_mode_tables, make_predict_fn,
                              make_predict_modes_fn, make_satd67_fn,
                              slice_mode_tables)

    tables = build_mode_tables(w, h, bitdepth, False)
    m1 = np.array([0, 1] + list(range(2, 67, 2)), dtype=np.int32)
    predict1 = make_predict_fn(slice_mode_tables(tables, m1))
    predict_m = make_predict_modes_fn(tables)
    satd = make_satd67_fn(w, h)
    rd_tail = make_rd_cost_pred_fn(w, h, bitdepth, is_intra_slice)
    n1 = len(m1)

    def fn(r, src, qp, lam, wts, mode_bits):
        m1j = jnp.asarray(m1)
        p1 = predict1(r)                            # [B, 35, h, w]
        s1 = satd(p1, src)                          # [B, 35]
        lam_sqrt = jnp.sqrt(lam)
        c1 = s1.astype(jnp.float32) + lam_sqrt * mode_bits[m1j][None, :]

        B = r.shape[0]
        ang_c = c1[:, 2:]                           # modes 2,4,...,66
        i1 = jnp.argmin(ang_c, axis=1)
        masked = ang_c + (jax.nn.one_hot(i1, ang_c.shape[1],
                                         dtype=ang_c.dtype) * 1e30)
        i2 = jnp.argmin(masked, axis=1)
        a1 = 2 + 2 * i1
        a2 = 2 + 2 * i2
        refine = jnp.clip(jnp.stack(
            [a1 - 1, a1 + 1, a2 - 1, a2 + 1], axis=1), 2, 66)  # [B, 4]
        p2 = predict_m(r, refine)                   # [B, 4, h, w]
        s2 = satd(p2, src)
        c2 = s2.astype(jnp.float32) + lam_sqrt * mode_bits[refine]

        all_c = jnp.concatenate([c1, c2], axis=1)   # [B, 39]
        all_s = jnp.concatenate([s1, s2], axis=1)
        k = jnp.argmin(all_c, axis=1)
        bidx = jnp.arange(B)
        best_mode = jnp.where(k < n1, m1j[jnp.minimum(k, n1 - 1)],
                              refine[bidx, jnp.maximum(k - n1, 0)])
        all_p = jnp.concatenate([p1, p2], axis=1)
        best_pred = all_p[bidx, k]
        satd_best = all_s[bidx, k]
        rd_cost = rd_tail(best_pred, src, qp, lam, wts,
                          jnp.take(mode_bits, best_mode))
        return best_mode.astype(jnp.int32), rd_cost, satd_best

    return fn


# MTS candidate transform pairs, indexed by tr_idx (cu.h:70-78):
# 0=DCT2/DCT2, (1=skip), 2=DST7/DST7, 3=DCT8/DST7, 4=DST7/DCT8, 5=DCT8/DCT8
from .tr_matrices import DCT8, DST7

MTS_PAIRS = {0: (DCT2, DCT2), 2: (DST7, DST7), 3: (DCT8, DST7),
             4: (DST7, DCT8), 5: (DCT8, DCT8)}


def make_mts_search_fn(w: int, h: int, bitdepth: int = 8,
                       is_intra_slice: bool = True):
    """Evaluate all MTS candidates for given predictions: returns jittable
    (pred [B,h,w], src, qp, lam, wts) -> (best_idx [B] in {0,2..5},
    rd_cost [B], only_dc [B] bool).

    The batched analogue of search_intra_trdepth's MTS loop
    (search_intra.c:281); all five transform pairs are matmuls evaluated
    at once.
    """
    import jax.numpy as jnp

    log2_w, log2_h = LOG2[w], LOG2[h]
    s1, s2 = fwd_shifts(w, h, bitdepth)
    si1, si2 = inv_shifts(bitdepth)
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    tshift = 15 - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    q_scales = jnp.asarray(QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)
    iq_scales = jnp.asarray(INV_QUANT_SCALES[int(needs_sqrt2)],
                            dtype=jnp.int32)
    tshift_d = 15 - bitdepth - ((log2_w + log2_h) >> 1)
    dq_shift = 20 - 14 - (tshift_d - needs_sqrt2)
    add_base = 171 if is_intra_slice else 85
    idx_list = [0, 2, 3, 4, 5]

    mats = []
    for idx in idx_list:
        th, tv = MTS_PAIRS[idx]
        keep_w = 16 if (th != DCT2 and w == 32) else w
        keep_h = 16 if (tv != DCT2 and h == 32) else h
        mask = np.zeros((h, w), dtype=np.int32)
        mask[:keep_h, :keep_w] = 1
        mats.append((jnp.asarray(get_matrix(th, w).T, dtype=jnp.int32),
                     jnp.asarray(get_matrix(tv, h), dtype=jnp.int32),
                     jnp.asarray(get_matrix(th, w), dtype=jnp.int32),
                     jnp.asarray(get_matrix(tv, h).T, dtype=jnp.int32),
                     jnp.asarray(mask)))

    def mts_rd(pred, src, qp, lam, wts):
        resid = src.astype(jnp.int32) - pred.astype(jnp.int32)
        q_bits = 14 + qp // 6 + tshift
        scale = q_scales[qp % 6]
        add = add_base << (q_bits - 9)
        iscale = iq_scales[qp % 6] << (qp // 6)
        costs = []
        dcs = []
        for ci, (mh_t, mv, mh, mv_t, mask) in enumerate(mats):
            t = (jnp.matmul(resid, mh_t, preferred_element_type=jnp.int32)
                 + (1 << (s1 - 1))) >> s1
            t = t.astype(jnp.int16).astype(jnp.int32)
            coef = ((jnp.matmul(mv, t, preferred_element_type=jnp.int32)
                     + (1 << (s2 - 1))) >> s2).astype(jnp.int16).astype(jnp.int32)
            coef = coef * mask[None]
            a = jnp.abs(coef)
            level = jnp.clip((a * scale + add) >> q_bits, 0, 32767)
            bits = wts[jnp.minimum(level, 3)].sum(axis=(-2, -1))
            # mts_idx signaling bits estimate
            bits = bits + (1.0 if ci == 0 else 1.0 + ci)
            dq = (jnp.sign(coef) * level * iscale
                  + (1 << (dq_shift - 1))) >> dq_shift
            dq = jnp.clip(dq, -32768, 32767)
            u = (jnp.matmul(mv_t, dq, preferred_element_type=jnp.int32)
                 + (1 << (si1 - 1))) >> si1
            u = jnp.clip(u, -32768, 32767)
            r = (jnp.matmul(u, mh, preferred_element_type=jnp.int32)
                 + (1 << (si2 - 1))) >> si2
            r = jnp.clip(r, -32768, 32767)
            rec = jnp.clip(pred + r, 0, (1 << bitdepth) - 1)
            # int32: a 32x32 SSD stays < 2^31 at 8- and 10-bit
            d = (src - rec).astype(jnp.int32)
            ssd = (d * d).sum(axis=(-2, -1)).astype(jnp.float32)
            costs.append(ssd + lam * bits)
            # nonzero beyond DC? (mts_last_scan_pos requirement)
            nz = (level != 0)
            n_nz = nz.sum(axis=(-2, -1))
            dc_only = (n_nz - nz[:, 0, 0].astype(n_nz.dtype)) == 0
            dcs.append(dc_only)
        call = jnp.stack(costs, axis=1)               # [B, 5]
        dcall = jnp.stack(dcs, axis=1)
        # candidates whose result cannot signal mts (dc-only / all-zero)
        # are forced to DCT2 by inflating their cost
        call = call + jnp.where(dcall, 1e30, 0.0) \
            * (jnp.arange(len(idx_list))[None, :] > 0)
        best = jnp.argmin(call, axis=1)
        best_cost = jnp.min(call, axis=1)
        tr_idx = jnp.asarray(idx_list, dtype=jnp.int32)[best]
        return tr_idx, best_cost, dcall[:, 0]

    return mts_rd
