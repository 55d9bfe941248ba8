"""MIP (matrix-based intra prediction).

Behavioral parity with the reference:
- boundary Haar downsampling, reduced prediction with offset folding,
  two-stage linear upsampling:
  strategies/generic/intra-generic.c uvg_mip_boundary_downsampling_1D:441,
  uvg_mip_reduced_pred:472, uvg_mip_pred_upsampling_1D:527,
  mip_predict_generic:579
- weight matrices: mip_tables.py (spec constants)

`mip_predict_np` is the host-exact golden kernel (used by the sequential
reconstruction); `make_mip_preds_fn` evaluates every (mode, transpose)
candidate of a size class as one batched matmul for the device search.

MIP_SHIFT_MATRIX = 6, MIP_OFFSET_MATRIX = 32 (global constants).
"""
from __future__ import annotations

import numpy as np

from .mip_tables import MIP_4X4, MIP_8X8, MIP_16X16

MIP_SHIFT = 6
MIP_OFFSET = 32


def mip_size_id(w: int, h: int) -> int:
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def mip_mode_count(w: int, h: int) -> int:
    return (16, 8, 6)[mip_size_id(w, h)]


def _downsample(ref: np.ndarray, dst_len: int) -> np.ndarray:
    src_len = ref.shape[-1]
    if dst_len < src_len:
        f = src_len // dst_len
        lg = f.bit_length() - 1
        s = ref.reshape(ref.shape[:-1] + (dst_len, f)).sum(-1)
        return (s + (1 << (lg - 1))) >> lg
    return ref[..., :dst_len]


def _upsample_1d(pred, boundary_row, factor):
    """Linear upsampling along the last axis: before/behind interpolation
    (uvg_mip_pred_upsampling_1D semantics). boundary_row: value before
    sample 0 per row."""
    lg = factor.bit_length() - 1
    rnd = 1 << (lg - 1)
    n = pred.shape[-1]
    before = np.concatenate([boundary_row[..., None], pred[..., :-1]],
                            axis=-1)
    pos = np.arange(1, factor + 1)
    # out[..., i*factor + (pos-1)] = ((f - pos)*before_i + pos*pred_i + rnd) >> lg
    out = ((factor - pos)[None, :] * before[..., :, None]
           + pos[None, :] * pred[..., :, None] + rnd) >> lg
    return out.reshape(pred.shape[:-1] + (n * factor,))


def mip_predict_np(ref_top: np.ndarray, ref_left: np.ndarray, w: int, h: int,
                   mode: int, transpose: bool, bitdepth: int = 8) -> np.ndarray:
    """Exact MIP prediction for one block. ref_top/ref_left: the w / h
    neighboring samples (refs.top[1:1+w], refs.left[1:1+h])."""
    size_id = mip_size_id(w, h)
    red_bdry = 2 if size_id == 0 else 4
    red_pred = 4 if size_id < 2 else 8
    ups_h = w // red_pred
    ups_v = h // red_pred

    top = _downsample(ref_top.astype(np.int64), red_bdry)
    left = _downsample(ref_left.astype(np.int64), red_bdry)
    bdry = np.concatenate([left, top]) if transpose \
        else np.concatenate([top, left])
    in_off = int(bdry[0])
    inp = bdry - in_off
    if size_id < 2:
        inp[0] = (1 << (bitdepth - 1)) - in_off
    else:
        inp[0] = 0
    M = (MIP_4X4, MIP_8X8, MIP_16X16)[size_id][mode].astype(np.int64)
    if size_id == 2:
        # first matrix column dropped for large blocks: weights start at
        # input index 1 (the stored tables already have 8 or 7 columns?
        # reference keeps 8 inputs with inp[0] = 0, identical result)
        pass
    offset = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * int(inp.sum())
    red = ((M @ inp + offset) >> MIP_SHIFT) + in_off
    red = np.clip(red, 0, (1 << bitdepth) - 1).reshape(red_pred, red_pred)
    if transpose:
        red = red.T
    out = red.astype(np.int64)
    if ups_h > 1:
        # horizontal upsampling rows use the LEFT boundary as 'before'
        bl = _downsample(ref_left.astype(np.int64), red_pred) if False \
            else ref_left.astype(np.int64)[ups_v - 1::ups_v][:red_pred]
        out = _upsample_1d(out, bl, ups_h)
    if ups_v > 1:
        bt = ref_top.astype(np.int64)[:w]
        out = _upsample_1d(out.T, bt, ups_v).T
    return out.astype(np.int32)


def make_mip_preds_fn(w: int, h: int, bitdepth: int = 8):
    """jit-able: (src [H,W], xs, ys [B]) -> preds [B, n_cand, h, w] for
    every (mode, transpose) pair of this size class. Reference samples
    use the open-loop availability of the batched search (row above /
    column left of the source plane, edge-replicated)."""
    import jax.numpy as jnp
    size_id = mip_size_id(w, h)
    n_modes = mip_mode_count(w, h)
    red_bdry = 2 if size_id == 0 else 4
    red_pred = 4 if size_id < 2 else 8
    ups_h = w // red_pred
    ups_v = h // red_pred
    M = (MIP_4X4, MIP_8X8, MIP_16X16)[size_id].astype(np.int32)
    Mj = jnp.asarray(M)          # [n_modes, red^2, 2*red_bdry]
    maxv = (1 << bitdepth) - 1

    def ds(ref, dst_len):
        src_len = ref.shape[-1]
        if dst_len < src_len:
            f = src_len // dst_len
            lg = f.bit_length() - 1
            s = ref.reshape(ref.shape[:-1] + (dst_len, f)).sum(-1)
            return (s + (1 << (lg - 1))) >> lg
        return ref[..., :dst_len]

    def ups(pred, boundary, factor):
        if factor == 1:
            return pred
        lg = factor.bit_length() - 1
        rnd = 1 << (lg - 1)
        n = pred.shape[-1]
        before = jnp.concatenate([boundary[..., None], pred[..., :-1]], -1)
        pos = jnp.arange(1, factor + 1)
        out = ((factor - pos)[None, :] * before[..., :, None]
               + pos[None, :] * pred[..., :, None] + rnd) >> lg
        return out.reshape(pred.shape[:-1] + (n * factor,))

    def fn(src, xs, ys):
        # int32: boundary samples < 2^10, weighted sums < 2^23
        P = jnp.pad(src, ((1, 8), (1, 8)), mode="edge").astype(jnp.int32)
        top = P[ys[:, None], xs[:, None] + jnp.arange(w)[None, :] + 1]
        left = P[ys[:, None] + jnp.arange(h)[None, :] + 1, xs[:, None]]
        tt = ds(top, red_bdry)
        ll = ds(left, red_bdry)
        outs = []
        for transpose in (False, True):
            bdry = jnp.concatenate([ll, tt], -1) if transpose \
                else jnp.concatenate([tt, ll], -1)
            in_off = bdry[:, :1]
            inp = bdry - in_off
            if size_id < 2:
                inp = inp.at[:, 0].set((1 << (bitdepth - 1)) - in_off[:, 0])
            else:
                inp = inp.at[:, 0].set(0)
            offset = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * inp.sum(-1)
            red = (jnp.einsum("mki,bi->bmk", Mj, inp)
                   + offset[:, None, None]) >> MIP_SHIFT
            red = jnp.clip(red + in_off[:, :, None], 0, maxv)
            red = red.reshape(-1, n_modes, red_pred, red_pred)
            if transpose:
                red = red.transpose(0, 1, 3, 2)
            out = red
            if ups_h > 1:
                bl = left[:, ups_v - 1::ups_v][:, :red_pred]
                out = ups(out, jnp.repeat(bl[:, None, :], n_modes, 1), ups_h)
            if ups_v > 1:
                bt = top
                out = ups(out.transpose(0, 1, 3, 2),
                          jnp.repeat(bt[:, None, :], n_modes, 1),
                          ups_v).transpose(0, 1, 3, 2)
            outs.append(out)
        return jnp.concatenate(outs, axis=1).astype(jnp.int32)

    return fn
