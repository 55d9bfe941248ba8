"""Pseudo-reconstruction of a source plane at a given QP.

The two-phase design searches phase 1 open-loop: intra predictions
are built from *source* neighbors, which at high QP are far cleaner than
the real reconstruction the decoder will have.  That bias makes intra
modes (and small CUs) look systematically better than they will code,
inflating bits exactly where the reference's closed-loop search
(search.c search_cu, which predicts from in-loop recon pixels) would
pick merge/skip or larger CUs.

This module provides the cheap counter: a one-pass DC-pred + DCT2 +
quant + dequant + inverse roundtrip of the whole plane on a fixed tile
grid.  The result has the right *noise level* for the QP (it is not the
real recon — it exists only to serve as the neighbor source for the
phase-1 batched intra search, so mode costs are estimated against
realistically-degraded references).  Distortion targets stay the
original source.

Vectorized numpy (einsum over all tiles at once): ~1 ms for 416x240.
"""
from __future__ import annotations

import numpy as np

from .quant import quant_params
from .tr_matrices import DCT2, get_matrix
from .transforms import fwd_shifts, inv_shifts

_LOG2 = {16: 4}


def _rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def pseudo_recon_plane(src: np.ndarray, qp_scaled: int,
                       bitdepth: int = 8, tile: int = 16) -> np.ndarray:
    """Quantization-roundtrip approximation of the recon of `src` at
    `qp_scaled` (luma scale). Returns int32, same shape as src."""
    h, w = src.shape
    ph, pw = -(-h // tile) * tile, -(-w // tile) * tile
    plane = np.empty((ph, pw), dtype=np.int64)
    plane[:h, :w] = src
    if pw > w:
        plane[:h, w:] = src[:, -1:]
    if ph > h:
        plane[h:, :] = plane[h - 1:h, :]
    # tiles (B, t, t)
    t = tile
    blocks = plane.reshape(ph // t, t, pw // t, t).transpose(0, 2, 1, 3) \
        .reshape(-1, t, t)
    # DC prediction per tile (mean), residual roundtrip
    dc = blocks.mean(axis=(1, 2), keepdims=True).round().astype(np.int64)
    res = blocks - dc
    s1, s2 = fwd_shifts(t, t, bitdepth)
    m = get_matrix(DCT2, t).astype(np.int64)
    tmp = _rshift_round(res @ m.T, s1)
    coef = _rshift_round(np.einsum("ij,bjk->bik", m, tmp), s2)
    scale, q_bits, add = quant_params(qp_scaled, _LOG2[t], _LOG2[t],
                                     bitdepth, is_intra_slice=True)
    level = (np.abs(coef) * scale + add) >> q_bits
    q = np.sign(coef) * np.minimum(level, 32767)
    # dequant
    from .quant import INV_QUANT_SCALES, MAX_TR_DYNAMIC_RANGE, QUANT_SHIFT
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - _LOG2[t]
    shift = 20 - QUANT_SHIFT - transform_shift
    dscale = int(INV_QUANT_SCALES[0, qp_scaled % 6]) << (qp_scaled // 6)
    dadd = 1 << (shift - 1)
    dq = np.clip((q * dscale + dadd) >> shift, -32768, 32767)
    i1, i2 = inv_shifts(bitdepth)
    u = np.clip(_rshift_round(np.einsum("ij,bjk->bik", m.T, dq), i1),
                -32768, 32767)
    rec_res = np.clip(_rshift_round(u @ m, i2), -32768, 32767)
    rec = np.clip(rec_res + dc, 0, (1 << bitdepth) - 1)
    out = rec.reshape(ph // t, pw // t, t, t).transpose(0, 2, 1, 3) \
        .reshape(ph, pw)
    return out[:h, :w].astype(np.int32)


def make_pseudo_recon_fn(H: int, W: int, bitdepth: int = 8,
                         tile: int = 16):
    """Jittable (device) twin of pseudo_recon_plane for an H x W plane
    whose dims are multiples of `tile` (the padded frame planes).
    fn(src [H, W] int, qp_scaled i32) -> [H, W] int32, bit-exact with
    the numpy version (asserted in tests)."""
    import jax.numpy as jnp

    from .quant import INV_QUANT_SCALES, MAX_TR_DYNAMIC_RANGE, QUANT_SHIFT
    from .quant import QUANT_SCALES as QS

    t = tile
    lg = _LOG2[t]
    m = jnp.asarray(get_matrix(DCT2, t), dtype=jnp.int32)
    s1, s2 = fwd_shifts(t, t, bitdepth)
    i1, i2 = inv_shifts(bitdepth)
    q_scales = jnp.asarray(QS[0], dtype=jnp.int32)
    iq_scales = jnp.asarray(INV_QUANT_SCALES[0], dtype=jnp.int32)
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - lg
    tshift = transform_shift            # square: no sqrt2
    dq_shift = 20 - QUANT_SHIFT - transform_shift

    def rsh(x, shift):
        return (x + (1 << (shift - 1))) >> shift

    def pseudo(src, qp_scaled):
        plane = src.astype(jnp.int32)
        blocks = plane.reshape(H // t, t, W // t, t).transpose(0, 2, 1, 3) \
            .reshape(-1, t, t)
        # DC per tile: sum/t^2 is exact in f32 (sums < 2^18, /256 exact),
        # round half-even == numpy .mean().round()
        dc = jnp.round(blocks.sum(axis=(1, 2), keepdims=True)
                       .astype(jnp.float32) / (t * t)).astype(jnp.int32)
        res = blocks - dc
        tmp = rsh(jnp.matmul(res, m.T, preferred_element_type=jnp.int32),
                  s1)
        coef = rsh(jnp.matmul(m[None], tmp,
                              preferred_element_type=jnp.int32), s2)
        q_bits = 14 + qp_scaled // 6 + tshift
        scale = q_scales[qp_scaled % 6]
        add = jnp.int32(171) << (q_bits - 9)
        a = jnp.abs(coef)
        level = jnp.minimum((a * scale + add) >> q_bits, 32767)
        q = jnp.sign(coef) * level
        dscale = iq_scales[qp_scaled % 6] << (qp_scaled // 6)
        dadd = 1 << (dq_shift - 1)
        dq = jnp.clip((q * dscale + dadd) >> dq_shift, -32768, 32767)
        u = jnp.clip(rsh(jnp.matmul(m.T[None], dq,
                                    preferred_element_type=jnp.int32), i1),
                     -32768, 32767)
        rec_res = jnp.clip(rsh(jnp.matmul(u, m,
                                          preferred_element_type=jnp.int32),
                               i2), -32768, 32767)
        rec = jnp.clip(rec_res + dc, 0, (1 << bitdepth) - 1)
        return rec.reshape(H // t, W // t, t, t).transpose(0, 2, 1, 3) \
            .reshape(H, W)

    return pseudo
