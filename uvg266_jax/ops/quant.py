"""Scalar quantization / dequantization, bit-exact with the reference
(quant-generic.c: uvg_quant_generic:51, uvg_dequant_generic:618;
scale tables scalinglist.c:91-97).

Default path only (no custom scaling lists); sign-data hiding is applied as
a separate pass (see signhide further down, quant-generic.c:134-258).
"""
from __future__ import annotations

import numpy as np

QUANT_SCALES = np.array([
    [26214, 23302, 20560, 18396, 16384, 14564],
    [18396, 16384, 14564, 13107, 11651, 10280],
], dtype=np.int64)
INV_QUANT_SCALES = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102],
], dtype=np.int64)

QUANT_SHIFT = 14
MAX_TR_DYNAMIC_RANGE = 15
MIN_QP_PRIME_TS = 2
LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}


def quant_params(qp_scaled: int, log2_w: int, log2_h: int, bitdepth: int = 8,
                 transform_skip: bool = False, is_intra_slice: bool = True):
    """Returns (quant_scale, q_bits, add) for the default quant path."""
    if transform_skip:
        qp_scaled = max(qp_scaled, 4 + 6 * MIN_QP_PRIME_TS)
    needs_sqrt2 = (not transform_skip) and ((log2_w + log2_h) % 2 == 1)
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    q_bits = QUANT_SHIFT + qp_scaled // 6 + (0 if transform_skip else transform_shift)
    add = (171 if is_intra_slice else 85) << (q_bits - 9)
    scale = int(QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6])
    return scale, q_bits, add


def quant(coef: np.ndarray, qp_scaled: int, bitdepth: int = 8,
          transform_skip: bool = False, is_intra_slice: bool = True,
          signhide: bool = False, qmat: np.ndarray | None = None) -> np.ndarray:
    """Quantize an h x w coefficient block (numpy, bit-exact), with
    optional sign-data hiding (quant-generic.c:123-229).

    qmat: optional per-coefficient scaling-list matrix m (flat = 16);
    the per-coefficient quant scale becomes (scale << 4) / m
    (quant-generic.c:74-94)."""
    h, w = coef.shape
    scale, q_bits, add = quant_params(qp_scaled, LOG2[w], LOG2[h], bitdepth,
                                      transform_skip, is_intra_slice)
    if qmat is None:
        qc = scale
    else:
        qc = (scale << 4) // qmat.astype(np.int64)
    a = np.abs(coef.astype(np.int64))
    level = (a * qc + add) >> q_bits
    q = np.clip(np.sign(coef) * level, -32768, 32767).astype(np.int16)
    if signhide and int(level.sum()) >= 2:
        delta_u = ((a * qc - (level << q_bits)) >> (q_bits - 8)).astype(np.int64)
        _sign_hide(q, coef, delta_u, w, h)
    return q


def _sign_hide(q: np.ndarray, coef: np.ndarray, delta_u: np.ndarray,
               w: int, h: int) -> None:
    """In-place sign-data hiding over 16-coefficient scan sets
    (quant-generic.c:151-229)."""
    from .scan import coeff_scan_table
    lw, lh = LOG2[w], LOG2[h]
    scan = coeff_scan_table(lw, lh)
    qf = q.reshape(-1)
    cf = coef.reshape(-1)
    du = delta_u.reshape(-1)
    last_cg = -1
    for subset in range((w * h - 1) >> 4, -1, -1):
        subpos = subset << 4
        sub_scan = scan[subpos:subpos + 16]
        vals = qf[sub_scan]
        nz = np.nonzero(vals)[0]
        if len(nz) == 0:
            if last_cg == 1:
                last_cg = 0
            continue
        first_nz, last_nz = int(nz[0]), int(nz[-1])
        abssum = int(vals[first_nz:last_nz + 1].sum())
        if last_cg == -1:
            last_cg = 1
        if last_nz - first_nz >= 4:
            signbit = 0 if qf[sub_scan[first_nz]] > 0 else 1
            if signbit != (abssum & 1):
                min_cost, min_pos, final_change = 0x7FFFFFFF, -1, 0
                start = last_nz if last_cg == 1 else 15
                for n in range(start, -1, -1):
                    blk = int(sub_scan[n])
                    if qf[blk] != 0:
                        if du[blk] > 0:
                            cur_cost, cur_change = -int(du[blk]), 1
                        elif n == first_nz and abs(int(qf[blk])) == 1:
                            cur_cost, cur_change = 0x7FFFFFFF, 0
                        else:
                            cur_cost, cur_change = int(du[blk]), -1
                    elif n < first_nz and ((0 if cf[blk] >= 0 else 1) != signbit):
                        cur_cost, cur_change = 0x7FFFFFFF, 0
                    else:
                        cur_cost, cur_change = -int(du[blk]), 1
                    if cur_cost < min_cost:
                        min_cost, final_change, min_pos = cur_cost, cur_change, blk
                if qf[min_pos] == 32767 or qf[min_pos] == -32768:
                    final_change = -1
                if cf[min_pos] >= 0:
                    qf[min_pos] += final_change
                else:
                    qf[min_pos] -= final_change
        if last_cg == 1:
            last_cg = 0


def dequant(q: np.ndarray, qp_scaled: int, bitdepth: int = 8,
            transform_skip: bool = False,
            qmat: np.ndarray | None = None) -> np.ndarray:
    """Dequantize an h x w level block (numpy, bit-exact).

    qmat: optional scaling-list matrix; the per-coefficient dequant
    scale becomes inv_scale * m with shift += 4 and the per-6-QP
    doubling folded into the shift (uvg_dequant_generic,
    quant-generic.c:639-660)."""
    h, w = q.shape
    log2_w, log2_h = LOG2[w], LOG2[h]
    if transform_skip:
        qp_scaled = max(qp_scaled, 4 + 6 * MIN_QP_PRIME_TS)
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1)
    needs_sqrt2 = (not transform_skip) and ((log2_w + log2_h) % 2 == 1)
    shift = 20 - QUANT_SHIFT - (0 if transform_skip else transform_shift - needs_sqrt2)
    if qmat is not None:
        shift += 4
        per = qp_scaled // 6
        dq = int(INV_QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6])             * qmat.astype(np.int64)
        if shift > per:
            add = 1 << (shift - per - 1)
            c = (q.astype(np.int64) * dq + add) >> (shift - per)
        else:
            c = np.clip(q.astype(np.int64) * dq, -32768, 32767)                 << (per - shift)
        return np.clip(c, -32768, 32767).astype(np.int16)
    scale = int(INV_QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6]) << (qp_scaled // 6)
    add = 1 << (shift - 1)
    c = (q.astype(np.int64) * scale + add) >> shift
    return np.clip(c, -32768, 32767).astype(np.int16)


# --- JAX versions ---------------------------------------------------------

def make_quant_fn(width: int, height: int, bitdepth: int = 8,
                  is_intra_slice: bool = True):
    """jit-able quant over [..., h, w] int32 coeffs; qp_scaled is traced."""
    import jax.numpy as jnp
    log2_w, log2_h = LOG2[width], LOG2[height]
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    scales = jnp.asarray(QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)
    base = 171 if is_intra_slice else 85

    def qfn(coef, qp_scaled):
        q_bits = QUANT_SHIFT + qp_scaled // 6 + transform_shift
        add = base << (q_bits - 9)
        scale = scales[qp_scaled % 6]
        # int32: |coef| <= 2^15 and scale < 2^15, so a * scale < 2^30
        a = jnp.abs(coef.astype(jnp.int32))
        level = (a * scale + add) >> q_bits
        return jnp.clip(jnp.sign(coef) * level.astype(jnp.int32), -32768, 32767)

    return qfn


def make_dequant_fn(width: int, height: int, bitdepth: int = 8):
    import jax.numpy as jnp
    log2_w, log2_h = LOG2[width], LOG2[height]
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1)
    shift = 20 - QUANT_SHIFT - (transform_shift - needs_sqrt2)
    add = 1 << (shift - 1)
    scales = jnp.asarray(INV_QUANT_SCALES[int(needs_sqrt2)], dtype=jnp.int32)

    def dqfn(q, qp_scaled):
        scale = scales[qp_scaled % 6] << (qp_scaled // 6)
        # int32: |q| * scale < 2^31 for |q| <= 2^15 while qp_scaled < 60
        c = (q.astype(jnp.int32) * scale + add) >> shift
        return jnp.clip(c, -32768, 32767).astype(jnp.int32)

    return dqfn
