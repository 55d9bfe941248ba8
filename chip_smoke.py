#!/usr/bin/env python3
"""Smoke test of the encoder's main path on one GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # only the mesh path, on four cards

One card, one process, phases in order:

- identity: the backend must be the GPU; device kind and count; the
  card's name and power limit (nvidia-smi, in a child that stays off
  JAX); the native C++ library must build; the search's device arrays
  must sit on the GPU.
- parity: every device program of the search runs on 1080p frame
  positions, for every size class the partition search uses, and is
  compared with its NumPy golden. Integer outputs must match exactly.
  An f32 RD cost may differ from the golden by RTOL plus the rounding
  bound of its w*h-term f32 sum of fast-cost bucket weights, which XLA
  takes in an order of its own (the golden sums exactly); a best-mode or
  MV difference is allowed only where the golden's cost gap is within
  RTOL, and is counted as a near-tie. Also times the frame search with
  the matmul predictor against the gather predictor.
- e2e: three 1920x1080 encodes through tools.encode.main (all-intra
  QP22, low-delay GOP4 QP27, random-access GOP8 QP27), each twice: a
  cold run with --verify, where the in-repo oracle decodes every AU, and
  a warm run without it for the fps; both must give the same bytes.
- cross-check: the 832x480 all-intra and low-delay encodes on the card
  and in a child process on the CPU must be byte-identical; a differing
  AU is accepted only behind a near-tie the parity phase counted.
- chip tests: the `chip`-marked pytest tests, in this process.

The last line is one JSON object {"ok": true, "device": {...}}. A phase
failure exits non-zero; nothing is caught and hidden. On another backend
the script exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-6             # f32 costs: rounding of the last few f32 operations
SEED = 2026
ME_RANGE = 16           # dense-search range of search_inter_blocks
FULL_W, FULL_H = 1920, 1080
XCHECK_W, XCHECK_H = 832, 480


class ParityError(AssertionError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# --- inputs ------------------------------------------------------------------

def synth_frames(w: int, h: int, n: int, seed: int = SEED):
    """Seeded 8-bit 4:2:0 clip with global motion, a moving object,
    texture and noise: (y, u, v) int32 planes per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = rng.integers(-12, 13, (h + 64, w + 64))
    frames = []
    for t in range(n):
        sx, sy = (3 * t) % 64, t % 64        # pans; wraps past frame 21
        y = (96 + 0.05 * xx + 0.04 * yy
             + 45 * np.sin((xx + sx) / 23.0) * np.cos((yy + sy) / 17.0)
             + 30 * (((xx + sx) // 48 + (yy + sy) // 40) % 2)
             + base[sy:sy + h, sx:sx + w])
        ox, oy = (w // 4 + 7 * t) % w, (h // 3 + 4 * t) % h
        obj = (np.abs(xx - ox) < w // 12) & (np.abs(yy - oy) < h // 10)
        y = np.where(obj, 200 - 0.3 * (xx - ox) + 0.2 * (yy - oy), y)
        y = np.clip(y + rng.integers(-3, 4, (h, w)), 0, 255)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + sx) / 31.0)
                    + rng.integers(-2, 3, (h // 2, w // 2)), 0, 255)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] + sy) / 27.0)
                    + rng.integers(-2, 3, (h // 2, w // 2)), 0, 255)
        frames.append((y.astype(np.int32), u.astype(np.int32),
                       v.astype(np.int32)))
    return frames


def write_yuv(path: str, frames) -> None:
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(p.astype(np.uint8).tobytes())


def search_classes(width: int, height: int, qp: int = 22):
    """(w, h, grid) of every size class the partition search uses for
    this geometry, from the encoder itself."""
    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import SliceEncoder
    from uvg266_jax.control.params import EncoderControl
    from uvg266_jax.control.partition import PartitionSearch
    cfg = Config(width=width, height=height, qp=qp, gop_len=0,
                 intra_period=1, wpp=False)
    ctrl = EncoderControl(cfg)
    se = SliceEncoder(cfg, ctrl)
    entries = se._fused_entries(PartitionSearch(ctrl, cfg, qp=qp))
    return tuple((w, h, g) for (_k, w, h, _p, g) in entries)


def grid_positions(grid):
    x0, y0, sx, sy, gx, gy = grid
    return [(x0 + bx * sx, y0 + by * sy)
            for by in range(gy) for bx in range(gx)]


def sample_idx(n: int, k: int, gx: int, rng) -> np.ndarray:
    """Up to max(k, 4) block indices of an n-block grid gx wide: its four
    corners, then random ones."""
    picked = [c for c in dict.fromkeys((0, gx - 1, n - gx, n - 1))
              if 0 <= c < n]
    for i in rng.permutation(n):
        if len(picked) >= max(k, 4):
            break
        if int(i) not in picked:
            picked.append(int(i))
    return np.array(sorted(picked))


class Ctx:
    """Inputs shared by the parity checks: a source frame, a reference
    frame (the previous frame of the same clip), the size classes and
    the QP."""

    def __init__(self, width, height, classes, qp=22, n_sample=24,
                 seed=SEED):
        frames = synth_frames(width, height, 2, seed)
        self.ref, self.src = frames[0][0], frames[1][0]
        self.H, self.W = height, width
        self.classes = classes
        self.qp = qp
        self.n_sample = n_sample
        self.rng = np.random.default_rng(seed)
        self.near_ties = 0
        from uvg266_jax.control.params import EncoderControl
        from uvg266_jax.cfg import Config
        from uvg266_jax.control.partition import qp_to_lambda
        from uvg266_jax.ops.fast_cost_tables import FAST_COEFF_WTS
        ctrl = EncoderControl(Config(width=width, height=height, qp=qp,
                                     gop_len=0, intra_period=1))
        self.qps = ctrl.luma_qp_scaled(qp)
        self.lam = np.float32(qp_to_lambda(qp))
        self.wts = np.asarray(FAST_COEFF_WTS[qp], dtype=np.float32)
        self._golden_intra = {}

    def samples(self, grid):
        x0, y0, sx, sy, gx, gy = grid
        return sample_idx(gx * gy, self.n_sample, gx, self.rng)


# --- goldens -----------------------------------------------------------------

def _rsr(x, s):
    return (x + (1 << (s - 1))) >> s


def golden_fwd_dct2(resid: np.ndarray, bitdepth: int = 8) -> np.ndarray:
    """transforms.py's numpy forward DCT2 without the 64-point zero-out
    (the search's RD model keeps every coefficient)."""
    from uvg266_jax.ops.tr_matrices import DCT2, get_matrix
    from uvg266_jax.ops.transforms import fwd_shifts
    h, w = resid.shape
    s1, s2 = fwd_shifts(w, h, bitdepth)
    mh = get_matrix(DCT2, w).astype(np.int64)
    mv = get_matrix(DCT2, h).astype(np.int64)
    tmp = _rsr(resid.astype(np.int64) @ mh.T, s1).astype(np.int16)
    return _rsr(mv @ tmp.astype(np.int64), s2).astype(np.int16)


def sum_bound(n_terms: int) -> float:
    """Relative error bound of an f32 sum of n positive terms taken in
    any order: (n - 1) u / (1 - (n - 1) u), u = 2^-24."""
    u = 2.0 ** -24
    return (n_terms - 1) * u / (1 - (n_terms - 1) * u)


def golden_rd(pred, blk, qps, lam, wts, extra, bitdepth=8,
              intra_slice=True):
    """One block's RD cost, ssd + lam * (fast-cost bits + extra), from
    the numpy transform/quant forms (ops.transforms, ops.quant), and the
    absolute tolerance of the device's f32 bits sum."""
    from uvg266_jax.ops.quant import dequant, quant
    from uvg266_jax.ops.transforms import inv_transform_2d
    coef = golden_fwd_dct2(blk.astype(np.int64) - pred, bitdepth)
    q = quant(coef, qps, bitdepth, is_intra_slice=intra_slice)
    level = np.abs(q.astype(np.int64))
    bits = np.asarray(wts, np.float64)[np.minimum(level, 3)].sum()
    r = inv_transform_2d(dequant(q, qps, bitdepth), bitdepth=bitdepth)
    rec = np.clip(pred.astype(np.int64) + r, 0, (1 << bitdepth) - 1)
    ssd = int(((blk.astype(np.int64) - rec) ** 2).sum())
    cost = np.float32(ssd) + np.float32(lam) * (np.float32(bits)
                                                + np.float32(extra))
    return cost, float(lam) * sum_bound(level.size) * float(bits)


def close(dev, gold, what: str, atol=0.0) -> None:
    dev = np.asarray(dev, np.float64)
    gold = np.asarray(gold, np.float64)
    bad = np.abs(dev - gold) > RTOL * np.abs(gold) + atol
    if bad.any():
        i = int(np.argmax(bad))
        raise ParityError(f"{what}: {int(bad.sum())} f32 costs off by more "
                          f"than rtol {RTOL}, first {dev.flat[i]!r} vs "
                          f"{gold.flat[i]!r}")


def same(dev, gold, what: str) -> None:
    dev, gold = np.asarray(dev), np.asarray(gold)
    if dev.shape != gold.shape:
        raise ParityError(f"{what}: shape {dev.shape} vs {gold.shape}")
    if not np.array_equal(dev, gold):
        i = int(np.argmax((dev != gold).reshape(-1)))
        raise ParityError(f"{what}: {int((dev != gold).sum())} of "
                          f"{dev.size} integers differ, first "
                          f"{dev.reshape(-1)[i]} vs {gold.reshape(-1)[i]}")


def check_choice(ctx, dev_k, costs, what) -> None:
    """dev_k must be the golden argmin of costs, or a near-tie with it."""
    gold_k = int(np.argmin(costs))
    if int(dev_k) == gold_k:
        return
    gap = float(costs[int(dev_k)]) - float(costs[gold_k])
    if gap > RTOL * abs(float(costs[gold_k])):
        raise ParityError(f"{what}: device picked {int(dev_k)}, golden "
                          f"{gold_k}, cost gap {gap!r}")
    ctx.near_ties += 1


def golden_intra(ctx, w, h, grid, refsrc=None):
    """Per sampled block of a class: (index, block, [67, h, w] scalar
    predictions from ops.intra.predict_intra, SATD [67] from ops.cost)."""
    key = (w, h, grid, refsrc is not None)
    if key in ctx._golden_intra:
        return ctx._golden_intra[key]
    from uvg266_jax.ops import intra as intra_ops
    from uvg266_jax.ops.cost import satd
    from uvg266_jax.ops.intra_batch import REF_LEN, build_refs_grid
    pos = grid_positions(grid)
    src = ctx.src
    out = []
    for k in ctx.samples(grid):
        x, y = pos[k]
        r = build_refs_grid(src if refsrc is None else refsrc, [(x, y)],
                            w, h)[0]
        preds = np.stack([intra_ops.predict_intra(
            m, w, h, intra_ops.IntraRefs(r[:REF_LEN].copy(),
                                         r[REF_LEN:2 * REF_LEN].copy()),
            8, cu_log2_w=intra_ops.LOG2[w], cu_log2_h=intra_ops.LOG2[h])
            for m in range(67)])
        blk = src[y:y + h, x:x + w]
        out.append((int(k), blk, preds, satd(preds, blk[None])))
    ctx._golden_intra[key] = out
    return out


def check_intra_results(ctx, w, h, grid, best, rd, what, refsrc=None):
    """Device (best mode, rd cost) per block vs the golden."""
    from uvg266_jax.control.encoder import _MODE_BITS
    ls = np.sqrt(np.float32(ctx.lam))
    for k, blk, preds, satds in golden_intra(ctx, w, h, grid, refsrc):
        mode_cost = satds.astype(np.float32) + ls * _MODE_BITS
        b = int(best[k])
        check_choice(ctx, b, mode_cost, f"{what} {w}x{h} block {k} mode")
        gold, atol = golden_rd(preds[b], blk, ctx.qps, ctx.lam, ctx.wts,
                               _MODE_BITS[b])
        close(rd[k], gold, f"{what} {w}x{h} block {k} rd", atol)


# --- parity checks, one per device program -----------------------------------

def parity_refs_blocks(ctx):
    """Gather-free grid refs/blocks (intra_batch.make_refs_blocks_grid_fn)
    vs build_refs_grid + slicing, every block of every class."""
    import jax
    from uvg266_jax.ops.intra_batch import (build_refs_grid,
                                            make_refs_blocks_grid_fn)
    n = 0
    for (w, h, grid) in ctx.classes:
        refs, blocks = jax.jit(make_refs_blocks_grid_fn(w, h, grid))(ctx.src)
        pos = grid_positions(grid)
        same(refs, build_refs_grid(ctx.src, pos, w, h), f"refs {w}x{h}")
        same(blocks, np.stack([ctx.src[y:y + h, x:x + w] for x, y in pos]),
             f"blocks {w}x{h}")
        n += len(pos)
    return {"blocks": n}


def _device_preds(ctx, w, h, grid):
    """Device refs, blocks and all-67-mode matmul predictions of a class."""
    import jax
    from uvg266_jax.ops.intra_batch import (build_mode_tables,
                                            make_predict_matmul_fn,
                                            make_refs_blocks_grid_fn)
    refs, blocks = jax.jit(make_refs_blocks_grid_fn(w, h, grid))(ctx.src)
    mm, A = make_predict_matmul_fn(build_mode_tables(w, h, 8, False))
    return refs, blocks, jax.jit(mm)(refs, jax.device_put(A))


def parity_predict(ctx):
    """All-67-mode angular predictor as one f32 HIGHEST matmul
    (make_predict_matmul_fn): equal to the gather form on every block,
    and to ops.intra.predict_intra on the sampled blocks."""
    import jax
    import jax.numpy as jnp
    from uvg266_jax.ops.intra_batch import build_mode_tables, make_predict_fn
    n = 0
    for (w, h, grid) in ctx.classes:
        refs, _blocks, p_mm = _device_preds(ctx, w, h, grid)
        p_g = jax.jit(make_predict_fn(build_mode_tables(w, h, 8, False)))(refs)
        if not bool(jnp.array_equal(p_mm, p_g)):
            raise ParityError(f"predict {w}x{h}: matmul form != gather form")
        for k, _blk, preds, _s in golden_intra(ctx, w, h, grid):
            same(p_mm[k], preds, f"predict {w}x{h} block {k}")
        n += refs.shape[0]
    return {"blocks": n}


def parity_satd(ctx):
    """67-mode SATD over int32 Hadamard matmuls (make_satd67_fn) vs
    ops.cost.satd, every block of every class."""
    import jax
    from uvg266_jax.ops.cost import satd
    from uvg266_jax.ops.intra_batch import make_satd67_fn
    n = 0
    for (w, h, grid) in ctx.classes:
        _refs, blocks, preds = _device_preds(ctx, w, h, grid)
        s = np.asarray(jax.jit(make_satd67_fn(w, h))(preds, blocks))
        blocks_h = np.asarray(blocks)
        step = max(1, (1 << 22) // (67 * w * h))
        for i in range(0, blocks_h.shape[0], step):
            same(s[i:i + step], satd(np.asarray(preds[i:i + step]),
                                     blocks_h[i:i + step, None]),
                 f"satd {w}x{h} blocks {i}..")
        n += blocks_h.shape[0]
    return {"blocks": n}


def parity_rd_cost(ctx):
    """Intra RD model (rd_cost.make_rd_cost_fn: mode choice + int32
    transform/quant round trip + fast-cost bits) vs the numpy golden."""
    import jax
    from uvg266_jax.control.encoder import _MODE_BITS
    from uvg266_jax.ops.rd_cost import make_rd_cost_fn
    n = 0
    for (w, h, grid) in ctx.classes:
        _refs, blocks, preds = _device_preds(ctx, w, h, grid)
        best, rd, _satd = jax.jit(make_rd_cost_fn(w, h, 8))(
            preds, blocks, np.int32(ctx.qps), ctx.lam, ctx.wts, _MODE_BITS)
        check_intra_results(ctx, w, h, grid, np.asarray(best),
                            np.asarray(rd), "rd")
        n += len(golden_intra(ctx, w, h, grid))
    return {"sampled": n}


def _split_flat(flat, classes):
    out, off = [], 0
    for (_w, _h, grid) in classes:
        B = grid[4] * grid[5]
        out.append((flat[off:off + B].astype(np.int32),
                    flat[off + B:off + 2 * B]))
        off += 2 * B
    return out


def frame_search_gather_fn(classes, bitdepth=8):
    """The fused frame search with the gather predictor (make_predict_fn)
    in place of the matmul: the same program otherwise, for timing."""
    import jax
    import jax.numpy as jnp
    from uvg266_jax.ops.intra_batch import (build_mode_tables,
                                            make_predict_fn,
                                            make_refs_blocks_grid_fn)
    from uvg266_jax.ops.rd_cost import make_rd_cost_fn
    parts = [(make_refs_blocks_grid_fn(w, h, g),
              make_predict_fn(build_mode_tables(w, h, bitdepth, False)),
              make_rd_cost_fn(w, h, bitdepth)) for (w, h, g) in classes]

    def frame(src, qps, lam, wts, mode_bits):
        src = src.astype(jnp.int32)
        vecs = []
        for gather_g, predict, rd in parts:
            refs, blocks = gather_g(src)
            best, rdc, _s = rd(predict(refs), blocks, qps, lam, wts,
                               mode_bits)
            vecs += [best.astype(jnp.float32), rdc]
        return jnp.concatenate(vecs)

    return jax.jit(frame)


def parity_frame_search(ctx):
    """The encoder's fused intra frame search (_get_frame_combo_fn: every
    class in one program) vs the golden on the sampled blocks."""
    from uvg266_jax.control.encoder import _MODE_BITS, _get_frame_combo_fn
    fn = _get_frame_combo_fn(ctx.classes, 8)
    flat = np.asarray(fn(ctx.src.astype(np.uint8), np.int32(ctx.qps),
                         ctx.lam, ctx.wts, _MODE_BITS))
    for (w, h, grid), (best, rd) in zip(ctx.classes,
                                        _split_flat(flat, ctx.classes)):
        check_intra_results(ctx, w, h, grid, best, rd, "frame search")
    return {"values": int(flat.size)}


def parity_pframe_screen(ctx):
    """P/B-frame intra screen (_get_pframe_intra_combo_fn: on-device
    pseudo-recon references) vs the golden with references from
    pseudo_recon.pseudo_recon_plane."""
    from uvg266_jax.control.encoder import (_MODE_BITS,
                                            _get_pframe_intra_combo_fn,
                                            pad_plane)
    from uvg266_jax.ops.pseudo_recon import pseudo_recon_plane
    H16, W16 = -(-ctx.H // 16) * 16, -(-ctx.W // 16) * 16
    src16 = pad_plane(ctx.src, W16, H16)
    fn = _get_pframe_intra_combo_fn(ctx.classes, H16, W16, 8)
    flat = np.asarray(fn(src16.astype(np.uint8), np.int32(ctx.qps),
                         ctx.lam, ctx.wts, _MODE_BITS))
    pseudo = pseudo_recon_plane(src16, ctx.qps, 8)
    for (w, h, grid), (best, rd) in zip(ctx.classes,
                                        _split_flat(flat, ctx.classes)):
        check_intra_results(ctx, w, h, grid, best, rd, "pframe screen",
                            refsrc=pseudo)
    return {"values": int(flat.size)}


def _residual_blocks(ctx, w, h):
    """Residual (src - ref) blocks of one size tiled over the frame."""
    gy, gx = ctx.H // h, ctx.W // w
    d = (ctx.src - ctx.ref)[:gy * h, :gx * w]
    return d.reshape(gy, h, gx, w).transpose(0, 2, 1, 3).reshape(-1, h, w)


TRANSFORM_SHAPES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (16, 8),
                    (8, 32))


def parity_transforms(ctx):
    """Batched int32 forward/inverse transforms (transforms.make_fwd_fn /
    make_inv_fn) vs fwd_transform_2d / inv_transform_2d, DCT2 at every
    size and the MTS kernels up to 32."""
    import jax
    from uvg266_jax.ops.tr_matrices import DCT2, DCT8, DST7
    from uvg266_jax.ops.transforms import (fwd_transform_2d,
                                           inv_transform_2d, make_fwd_fn,
                                           make_inv_fn)
    n = 0
    for (w, h) in TRANSFORM_SHAPES:
        res = _residual_blocks(ctx, w, h)
        kinds = [(DCT2, DCT2)] + ([(DST7, DST7), (DCT8, DST7)]
                                  if max(w, h) <= 32 else [])
        for th, tv in kinds:
            c = np.asarray(jax.jit(make_fwd_fn(w, h, th, tv))(res))
            r = np.asarray(jax.jit(make_inv_fn(w, h, th, tv))(c))
            for k in sample_idx(len(res), ctx.n_sample, ctx.W // w, ctx.rng):
                same(c[k], fwd_transform_2d(res[k], th, tv),
                     f"fwd {w}x{h} ({th},{tv}) block {k}")
                same(r[k], inv_transform_2d(c[k], th, tv),
                     f"inv {w}x{h} ({th},{tv}) block {k}")
            n += len(res)
    return {"blocks": n}


def parity_quant(ctx):
    """Batched quant/dequant (quant.make_quant_fn / make_dequant_fn) vs
    the numpy quant/dequant, at three QPs."""
    import jax
    from uvg266_jax.ops.quant import (dequant, make_dequant_fn,
                                      make_quant_fn, quant)
    from uvg266_jax.ops.transforms import fwd_transform_2d
    n = 0
    for (w, h) in TRANSFORM_SHAPES:
        res = _residual_blocks(ctx, w, h)
        idx = sample_idx(len(res), ctx.n_sample, ctx.W // w, ctx.rng)
        coef = np.stack([fwd_transform_2d(res[k]) for k in idx])
        qf = jax.jit(make_quant_fn(w, h))
        dqf = jax.jit(make_dequant_fn(w, h))
        for qps in (ctx.qps - 10, ctx.qps, ctx.qps + 15):
            q = np.asarray(qf(coef.astype(np.int32), np.int32(qps)))
            dq = np.asarray(dqf(q, np.int32(qps)))
            for i in range(len(idx)):
                gq = quant(coef[i], qps)
                same(q[i], gq, f"quant {w}x{h} qp {qps} block {idx[i]}")
                same(dq[i], dequant(gq, qps),
                     f"dequant {w}x{h} qp {qps} block {idx[i]}")
            n += len(idx)
    return {"blocks": n}


def parity_pseudo_recon(ctx):
    """On-device pseudo-reconstruction (make_pseudo_recon_fn) vs
    pseudo_recon_plane on the whole 16-padded frame."""
    import jax
    from uvg266_jax.control.encoder import pad_plane
    from uvg266_jax.ops.pseudo_recon import (make_pseudo_recon_fn,
                                             pseudo_recon_plane)
    H16, W16 = -(-ctx.H // 16) * 16, -(-ctx.W // 16) * 16
    src16 = pad_plane(ctx.src, W16, H16)
    for qps in (ctx.qps, ctx.qps + 10):
        dev = jax.jit(make_pseudo_recon_fn(H16, W16))(src16, np.int32(qps))
        same(dev, pseudo_recon_plane(src16, qps), f"pseudo recon qp {qps}")
    return {"pixels": 2 * H16 * W16}


def parity_mip(ctx):
    """MIP candidate predictions (mip.make_mip_preds_fn) vs
    mip_predict_np, every (mode, transpose) pair on the sampled blocks."""
    import jax
    from uvg266_jax.ops.mip import (make_mip_preds_fn, mip_mode_count,
                                    mip_predict_np)
    n = 0
    P = np.pad(ctx.src, ((1, 8), (1, 8)), mode="edge")
    for (w, h, grid) in ctx.classes:
        pos = grid_positions(grid)
        xs = np.array([p[0] for p in pos], np.int32)
        ys = np.array([p[1] for p in pos], np.int32)
        preds = np.asarray(jax.jit(make_mip_preds_fn(w, h))(ctx.src, xs, ys))
        nm = mip_mode_count(w, h)
        for k in ctx.samples(grid):
            x, y = pos[k]
            top, left = P[y, x + 1:x + 1 + w], P[y + 1:y + 1 + h, x]
            gold = np.stack([mip_predict_np(top, left, w, h, m, t)
                             for t in (False, True) for m in range(nm)])
            same(preds[k], gold, f"mip {w}x{h} block {k}")
            n += 1
    return {"sampled": n}


def _brute_ssd_maps(src, ref_pad, xs, ys, w, h, r):
    """Exact [B, 2r+1, 2r+1] SSD maps of the blocks at (xs, ys)."""
    n = 2 * r + 1
    blk = np.stack([src[y:y + h, x:x + w] for x, y in zip(xs, ys)]) \
        .astype(np.int64)
    out = np.empty((len(xs), n, n), np.int64)
    for dy in range(n):
        for dx in range(n):
            pat = np.stack([ref_pad[y + dy:y + dy + h, x + dx:x + dx + w]
                            for x, y in zip(xs, ys)])
            out[:, dy, dx] = ((blk - pat) ** 2).sum(axis=(1, 2))
    return out


def parity_fullpel_me(ctx):
    """Dense full-pel search (me.make_fullpel_search_fn, range 16) vs a
    brute-force SSD search. Exact up to 16x16 (sums < 2^24); larger
    blocks round in f32 on every backend, so a different MV must be a
    near-tie within that rounding."""
    import jax
    from uvg266_jax.ops.me import make_fullpel_search_fn, make_mv_penalty
    r = ME_RANGE
    n = 2 * r + 1
    ref_pad = np.pad(ctx.ref, r, mode="edge")
    pen = make_mv_penalty(r, float(np.sqrt(ctx.lam)))
    count = 0
    for (w, h, grid) in ctx.classes:
        pos = grid_positions(grid)
        idx = ctx.samples(grid)
        xs = [pos[k][0] for k in idx]
        ys = [pos[k][1] for k in idx]
        win = np.stack([ref_pad[y:y + h + 2 * r, x:x + w + 2 * r]
                        for x, y in zip(xs, ys)])
        blk = np.stack([ctx.src[y:y + h, x:x + w] for x, y in zip(xs, ys)])
        mvx, mvy, cost = (np.asarray(a) for a in jax.jit(
            make_fullpel_search_fn(w, h, r))(win, blk, pen))
        ssd = _brute_ssd_maps(ctx.src, ref_pad, xs, ys, w, h, r)
        for i in range(len(idx)):
            costs = ssd[i].astype(np.float32) + pen
            k_dev = (int(mvy[i]) + r) * n + int(mvx[i]) + r
            # bound on b2 + |2 corr| + r2 over every window offset
            mag = 2.0 * ((blk[i].astype(np.float64) ** 2).sum()
                         + (win[i].astype(np.float64) ** 2).max() * w * h)
            if mag < (1 << 24):         # every partial sum is exact in f32
                same(np.array([k_dev, cost[i]]),
                     np.array([int(np.argmin(costs)), costs.min()]),
                     f"fullpel {w}x{h} block {idx[i]}")
            elif k_dev != int(np.argmin(costs)):
                # f32 sums of w*h terms round by at most w*h*eps*magnitude
                tol = 2 * w * h * float(np.finfo(np.float32).eps) * mag
                gap = float(costs.reshape(-1)[k_dev]) - float(costs.min())
                if gap > tol:
                    raise ParityError(f"fullpel {w}x{h} block {idx[i]}: "
                                      f"MV cost gap {gap} > f32 bound {tol}")
                ctx.near_ties += 1
        count += len(idx)
    return {"sampled": count}


def _pen49(lam):
    from uvg266_jax.ops.me import mv_bits_est
    ls = float(np.sqrt(lam))
    return np.array([ls * (mv_bits_est(k % 7 - 3) + mv_bits_est(k // 7 - 3))
                     for k in range(49)], np.float32)


def _qpel_golden(ctx, x, y, w, h, mvx, mvy):
    """[49, h, w] mc_luma predictions and [49] SATDs around a full-pel MV."""
    from uvg266_jax.ops.cost import satd
    from uvg266_jax.ops.inter import mc_luma
    preds = np.stack([mc_luma(ctx.ref, x, y, w, h,
                              (mvx * 16 + (k % 7 - 3) * 4,
                               mvy * 16 + (k // 7 - 3) * 4))
                      for k in range(49)])
    return preds, satd(preds, ctx.src[y:y + h, x:x + w][None])


def _sample_mvs(ctx, n):
    return ctx.rng.integers(-6, 7, (n, 2))


def parity_frac_me(ctx):
    """Quarter-pel refinement (me.make_frac_search_fn: 49 offsets, 8-tap
    interpolation, SATD) vs ops.inter.mc_luma + ops.cost.satd."""
    import jax
    from uvg266_jax.ops.inter import fetch_extended_block
    from uvg266_jax.ops.me import make_frac_search_fn
    pen = _pen49(ctx.lam)
    n = 0
    for (w, h, grid) in ctx.classes:
        pos = grid_positions(grid)
        idx = ctx.samples(grid)[:8]
        mvs = _sample_mvs(ctx, len(idx))
        win = np.stack([fetch_extended_block(ctx.ref, pos[k][0] + mv[0],
                                             pos[k][1] + mv[1], w, h,
                                             5, 5, 5, 5)
                        for k, mv in zip(idx, mvs)]).astype(np.int32)
        blk = np.stack([ctx.src[pos[k][1]:pos[k][1] + h,
                                pos[k][0]:pos[k][0] + w] for k in idx])
        best, preds, _c = (np.asarray(a) for a in jax.jit(
            make_frac_search_fn(w, h))(win, blk, pen))
        for i, (k, mv) in enumerate(zip(idx, mvs)):
            gp, gs = _qpel_golden(ctx, pos[k][0], pos[k][1], w, h,
                                  int(mv[0]), int(mv[1]))
            same(preds[i], gp, f"qpel preds {w}x{h} block {k}")
            costs = gs.astype(np.float32) + pen
            same(best[i], np.argmin(costs), f"qpel best {w}x{h} block {k}")
        n += len(idx)
    return {"sampled": n}


def parity_leaf_qpel(ctx):
    """Leaf quarter-pel refine on 8x8 tiles (me_frame.make_leaf_qpel_fn:
    per-leaf segment sums of tile SATDs) vs the whole-block golden."""
    import jax
    from uvg266_jax.ops.inter import fetch_extended_block
    from uvg266_jax.ops.me_frame import TILE, make_leaf_qpel_fn
    pen = _pen49(ctx.lam)
    leaves = []
    for (w, h, grid) in ctx.classes:
        pos = grid_positions(grid)
        for k in ctx.samples(grid)[:4]:
            leaves.append((pos[k][0], pos[k][1], w, h))
    mvs = _sample_mvs(ctx, len(leaves))
    wins, blks, ids = [], [], []
    for li, ((x, y, w, h), mv) in enumerate(zip(leaves, mvs)):
        fw = fetch_extended_block(ctx.ref, x + mv[0], y + mv[1], w, h,
                                  5, 5, 5, 5)
        for i in range(h // TILE):
            for j in range(w // TILE):
                wins.append(fw[TILE * i:TILE * i + 18, TILE * j:TILE * j + 18])
                blks.append(ctx.src[y + TILE * i:y + TILE * i + TILE,
                                    x + TILE * j:x + TILE * j + TILE])
                ids.append(li)
    fn = jax.jit(make_leaf_qpel_fn(len(ids), len(leaves)))
    best, _bc, seg = (np.asarray(a) for a in fn(
        np.stack(wins).astype(np.int32), np.stack(blks),
        np.array(ids, np.int32), pen))
    for li, ((x, y, w, h), mv) in enumerate(zip(leaves, mvs)):
        _gp, gs = _qpel_golden(ctx, x, y, w, h, int(mv[0]), int(mv[1]))
        same(seg[li], gs.astype(np.float32), f"leaf qpel {w}x{h} leaf {li}")
        same(best[li], np.argmin(gs.astype(np.float32) + pen),
             f"leaf qpel best {w}x{h} leaf {li}")
    return {"leaves": len(leaves), "tiles": len(ids)}


def parity_frame_inter_me(ctx):
    """Whole-frame dense ME for every class (me_frame.make_frame_inter_fn:
    8x8-tile SSD maps, per-class sums, argmin, one-hot tile extraction,
    inter RD) vs brute-force tile SSDs summed in the same order."""
    import jax
    from uvg266_jax.ops.me import make_mv_penalty
    from uvg266_jax.ops.me_frame import (TILE, make_frame_inter_fn,
                                         mv_bits_table)
    r = ME_RANGE
    n = 2 * r + 1
    H, W = ctx.H, ctx.W
    ref_pad = np.pad(ctx.ref, r, mode="edge")
    pen = make_mv_penalty(r, float(np.sqrt(ctx.lam))).reshape(-1)
    bits = mv_bits_table(r)
    fn = jax.jit(make_frame_inter_fn(H, W, ctx.classes, 1, 8, r))
    flat = np.asarray(fn(ctx.src, ref_pad[None], pen, bits,
                         np.int32(ctx.qps), ctx.lam, ctx.wts))
    TY, TX = H // TILE, W // TILE
    tiles = np.empty((TY, TX, n, n), np.float32)     # exact: < 2^23
    s64 = ctx.src.astype(np.int64)
    for dy in range(n):
        for dx in range(n):
            d = s64 - ref_pad[dy:dy + H, dx:dx + W]
            tiles[:, :, dy, dx] = (d * d).reshape(TY, TILE, TX, TILE) \
                .sum(axis=(1, 3))
    count = 0
    for (w, h, grid), (idx_dev, cost_dev) in zip(
            ctx.classes, _split_flat(flat, ctx.classes)):
        x0, y0, sx, sy, gx, gy = grid
        acc = None                      # same summation order as the device
        for i in range(h // TILE):
            for j in range(w // TILE):
                ty, tx = y0 // TILE + i, x0 // TILE + j
                sl = tiles[ty:ty + (gy - 1) * (sy // TILE) + 1:sy // TILE,
                           tx:tx + (gx - 1) * (sx // TILE) + 1:sx // TILE]
                acc = sl if acc is None else acc + sl
        gold_idx = np.argmin((acc + pen.reshape(n, n)).reshape(gy * gx, -1),
                             axis=1)
        same(idx_dev, gold_idx, f"frame ME {w}x{h} MVs")
        pos = grid_positions(grid)
        for k in ctx.samples(grid):
            x, y = pos[k]
            kk = int(idx_dev[k])
            dy, dx = kk // n - r, kk % n - r
            pred = ref_pad[y + dy + r:y + dy + r + h,
                           x + dx + r:x + dx + r + w]
            gold, atol = golden_rd(pred, ctx.src[y:y + h, x:x + w], ctx.qps,
                                   ctx.lam, ctx.wts, bits[kk],
                                   intra_slice=False)
            close(cost_dev[k], gold, f"frame ME {w}x{h} block {k} rd", atol)
            count += 1
    return {"mvs": int(sum(g[4] * g[5] for (_w, _h, g) in ctx.classes)),
            "rd_sampled": count}


PARITY = {
    "refs_blocks": parity_refs_blocks,
    "predict": parity_predict,
    "satd": parity_satd,
    "rd_cost": parity_rd_cost,
    "frame_search": parity_frame_search,
    "pframe_screen": parity_pframe_screen,
    "transforms": parity_transforms,
    "quant": parity_quant,
    "pseudo_recon": parity_pseudo_recon,
    "mip": parity_mip,
    "fullpel_me": parity_fullpel_me,
    "frac_me": parity_frac_me,
    "leaf_qpel": parity_leaf_qpel,
    "frame_inter_me": parity_frame_inter_me,
}


# --- phases ------------------------------------------------------------------

class CompileClock:
    """Sums XLA backend compile seconds reported by jax.monitoring."""

    def __init__(self):
        from jax import monitoring
        self.secs = 0.0
        monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_kw):
        if name.endswith("backend_compile_duration"):
            self.secs += secs


def phase_identity():
    import jax
    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import SliceEncoder
    from uvg266_jax.control.params import EncoderControl
    from uvg266_jax.device_info import card_name_and_power_limit
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX's backend is {backend!r}, not "
                         "the GPU; this script runs on the card only")
    devs = jax.devices()
    card = card_name_and_power_limit()
    say("identity", f"backend={backend} kind={devs[0].device_kind} "
        f"count={len(devs)} card={card}")
    cfg = Config(width=FULL_W, height=FULL_H, qp=22, gop_len=0,
                 intra_period=1, wpp=False)
    se = SliceEncoder(cfg, EncoderControl(cfg))
    if not se.native_entropy:
        raise SystemExit("chip_smoke: the native C++ library did not build")
    say("identity", "native C++ library built (native_entropy=True)")
    return devs, card, se


def phase_residency(se, frame):
    """The search's device arrays (prediction matrices, source plane) sit
    on the GPU after a real 1080p frame search."""
    import jax
    from uvg266_jax.control.encoder import _JIT_CACHE, FramePlanes
    from uvg266_jax.control.params import FrameState
    se.dispatch_frame_search(FrameState(num=0, qp=22),
                             FramePlanes(*frame))()
    arrays = [v for k, v in _JIT_CACHE.items()
              if isinstance(k, tuple) and k[0] == "predA"]
    arrays.append(se._src_dev_narrow[1])
    plats = {d.platform for a in arrays for d in a.devices()}
    if plats != {"gpu"} or len(arrays) < 2:
        raise SystemExit(f"chip_smoke: search arrays on {plats}")
    mb = sum(a.nbytes for a in arrays) / 2 ** 20
    say("identity", f"{len(arrays)} search arrays ({mb:.1f} MiB: prediction "
        f"matrices + source plane) resident on {jax.devices()[0]}")


def time_predictors(ctx, reps: int = 5):
    """Time per call of the 1080p frame search (host clock around a call
    that ends in block_until_ready) with the matmul predictor (the
    encoder's) and with the gather predictor, taken in turns."""
    import jax
    from uvg266_jax.control.encoder import _MODE_BITS, _get_frame_combo_fn
    src = jax.device_put(ctx.src.astype(np.uint8))
    args = (np.int32(ctx.qps), ctx.lam, ctx.wts, _MODE_BITS)
    fns = {"matmul": _get_frame_combo_fn(ctx.classes, 8),
           "gather": frame_search_gather_fn(ctx.classes, 8)}
    outs = {k: _split_flat(np.asarray(f(src, *args)), ctx.classes)
            for k, f in fns.items()}
    for (w, h, _g), (b_m, rd_m), (b_g, rd_g) in zip(
            ctx.classes, outs["matmul"], outs["gather"]):
        same(b_m, b_g, f"frame search {w}x{h}: matmul vs gather modes")
        close(rd_m, rd_g, f"frame search {w}x{h}: matmul vs gather rd",
              float(ctx.lam) * sum_bound(w * h) * 8.0 * w * h)
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, f in fns.items():
            t0 = time.perf_counter()
            f(src, *args).block_until_ready()
            times[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    say("parity", f"frame search {ctx.W}x{ctx.H} time per call, median of "
        f"{reps}: matmul predictor {med['matmul']:.3f} ms, gather "
        f"predictor {med['gather']:.3f} ms (all runs: "
        + json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})
        + ")")
    return med


def phase_parity(ctx):
    for name, fn in PARITY.items():
        t0 = time.perf_counter()
        before = ctx.near_ties
        stats = fn(ctx)
        say("parity", f"{name}: ok {json.dumps(stats)} near-ties "
            f"{ctx.near_ties - before} ({time.perf_counter() - t0:.1f} s)")
    say("parity", f"all {len(PARITY)} device programs match their goldens "
        f"at {ctx.W}x{ctx.H}; near-ties {ctx.near_ties}")


_SUMMARY = re.compile(r"Processed (\d+) frames, (\d+) bits AVG PSNR Y "
                      r"([\d.]+) U ([\d.]+) V ([\d.]+)")
_TOTAL = re.compile(r"Total time: ([\d.]+) s")


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def run_encode(argv):
    """tools.encode.main with captured output: (seconds, frames, bits,
    psnr_y, stdout)."""
    from uvg266_jax.tools.encode import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    if rc != 0:
        raise SystemExit(f"chip_smoke: encode {argv} returned {rc}:\n{text}")
    m, t = _SUMMARY.search(text), _TOTAL.search(text)
    return float(t.group(1)), int(m.group(1)), int(m.group(2)), \
        float(m.group(3)), text


E2E = (("all-intra QP22", ["-q", "22", "-p", "1", "-n", "4",
                           "--threads", "3"]),
       ("low-delay GOP4 QP27", ["-q", "27", "-n", "8"]),
       ("random-access GOP8 QP27", ["-q", "27", "--gop", "ra8", "-n", "9"]))


def phase_e2e(tmp, clock):
    import jax
    path = os.path.join(tmp, "clip1080.yuv")
    write_yuv(path, synth_frames(FULL_W, FULL_H, 9, SEED + 1))
    for name, extra in E2E:
        outs = []
        for run, verify in (("cold", ["--verify"]), ("warm", [])):
            out = os.path.join(tmp, f"{run}.vvc")
            c0 = clock.secs
            secs, n, bits, psnr, _ = run_encode(
                ["-i", path, "--input-res", f"{FULL_W}x{FULL_H}", "-o", out,
                 *verify, *extra])
            outs.append((secs, clock.secs - c0, read_bytes(out)))
        (cold_s, compile_s, cold_b), (warm_s, _c, warm_b) = outs
        if cold_b != warm_b:
            raise SystemExit(f"chip_smoke: {name}: the verified and the "
                             "timed run gave different bitstreams")
        say("e2e", f"{name} {FULL_W}x{FULL_H} x{n}: {n / warm_s:.3f} fps "
            f"warm ({warm_s:.2f} s, no oracle); cold run with --verify "
            f"{cold_s:.2f} s incl. {compile_s:.2f} s XLA compile, every AU "
            f"decoded by the oracle; {bits} bits, PSNR Y {psnr:.4f} dB")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    say("e2e", f"device peak_bytes_in_use {peak}"
        + (f" ({peak / 2 ** 30:.2f} GiB)" if peak else "")
        + f"; XLA compile in this process so far {clock.secs:.2f} s (the "
        "parity phase compiled the search programs the encodes reuse)")


XCHECK = (("all-intra", ["-q", "22", "-p", "1", "-n", "2"]),
          ("low-delay", ["-q", "27", "-n", "4"]))


def start_cpu_crosscheck(tmp):
    """Writes the 832x480 clip and starts the CPU encodes in a child
    process (JAX_PLATFORMS=cpu: it never opens the card)."""
    path = os.path.join(tmp, "clip480.yuv")
    write_yuv(path, synth_frames(XCHECK_W, XCHECK_H, 4, SEED + 2))
    cmds = [["-i", path, "--input-res", f"{XCHECK_W}x{XCHECK_H}",
             "-o", os.path.join(tmp, f"cpu_{i}.vvc"),
             "--stats-file", os.path.join(tmp, f"cpu_{i}.jsonl"), *a]
            for i, (_n, a) in enumerate(XCHECK)]
    code = ("import json, sys\n"
            "from uvg266_jax.tools.encode import main\n"
            "for a in json.loads(sys.argv[1]):\n"
            "    assert main(a) == 0\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = open(os.path.join(tmp, "cpu_child.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(cmds)],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    return path, proc, log


def _au_sizes(stats_path):
    with open(stats_path) as f:
        return [json.loads(line)["bits"] // 8 for line in f]


def phase_crosscheck(tmp, path, proc, log, ctx):
    for i, (name, a) in enumerate(XCHECK):
        run_encode(["-i", path, "--input-res", f"{XCHECK_W}x{XCHECK_H}",
                    "-o", os.path.join(tmp, f"gpu_{i}.vvc"),
                    "--stats-file", os.path.join(tmp, f"gpu_{i}.jsonl"), *a])
    t0 = time.perf_counter()
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise SystemExit(f"chip_smoke: CPU child failed ({rc}):\n"
                             + f.read()[-4000:])
    say("cross-check", f"CPU child finished (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    for i, (name, _a) in enumerate(XCHECK):
        g = read_bytes(os.path.join(tmp, f"gpu_{i}.vvc"))
        c = read_bytes(os.path.join(tmp, f"cpu_{i}.vvc"))
        sizes = _au_sizes(os.path.join(tmp, f"gpu_{i}.jsonl"))
        if g == c:
            say("cross-check", f"{name} {XCHECK_W}x{XCHECK_H} x{len(sizes)}: "
                f"GPU and CPU streams byte-identical ({len(g)} bytes)")
            continue
        diff = next((k for k in range(min(len(g), len(c))) if g[k] != c[k]),
                    min(len(g), len(c)))
        au = int(np.searchsorted(np.cumsum(sizes), diff, side="right"))
        say("cross-check", f"{name}: first differing AU {au} (byte {diff}); "
            f"parity near-ties {ctx.near_ties}")
        if ctx.near_ties == 0:
            raise SystemExit("chip_smoke: GPU and CPU streams differ with no "
                             "near-tie behind it")


class _Outcomes:
    def __init__(self):
        self.passed, self.other = [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed.append(report.nodeid)
        elif report.failed or (report.when == "setup" and report.skipped):
            self.other.append((report.nodeid, report.outcome))


def phase_chip_tests():
    """The chip-marked tests, in this process (it already holds the card)."""
    import pytest
    env = dict(os.environ)
    res = _Outcomes()
    try:
        rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-p", "no:xdist",
                          os.path.join(ROOT, "tests")], plugins=[res])
    finally:
        os.environ.clear()
        os.environ.update(env)
    if rc != 0 or res.other or not res.passed:
        raise SystemExit(f"chip_smoke: chip tests rc={rc} "
                         f"passed={len(res.passed)} other={res.other}")
    say("chip tests", f"{len(res.passed)} chip-marked tests passed")


def phase_four(width=FULL_W, height=FULL_H, n_frames=4, gw=XCHECK_W,
               gh=XCHECK_H, g_frames=32):
    """MeshEncoder on a 2x2 ('gop','tile') mesh (all-intra, tiles 2x1) and
    MeshGopEncoder over 4 devices (RA8), each byte-identical to the
    single-card Encoder."""
    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import Encoder, FramePlanes
    from uvg266_jax.parallel import (MeshEncoder, MeshGopEncoder,
                                     build_gop_mesh, build_mesh)

    def single(cfg, frames):
        enc = Encoder(cfg)
        out = []
        for f in frames:
            out += [au for (au, *_r) in enc.feed(f)]
        return out + [au for (au, *_r) in enc.flush()]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    mesh = build_mesh(4)
    say("four", f"tile mesh {dict(mesh.shape)}: " + ", ".join(
        f"(gop {g}, tile {t}) -> {mesh.devices[g, t]}"
        for g in range(mesh.shape["gop"]) for t in range(mesh.shape["tile"])))
    kw = dict(width=width, height=height, qp=22, gop_len=0, intra_period=1,
              tiles_width_count=2, tiles_height_count=1, wpp=False)
    frames = [FramePlanes(*f) for f in synth_frames(width, height, n_frames)]
    # one run: tiled frames take the host's Python finalize on both sides
    # (seconds per 1080p frame), so a second run would only repeat that
    got, t4 = timed(lambda: MeshEncoder(Config(**kw), mesh).encode(frames))
    ref, t1 = timed(lambda: single(Config(**kw), frames))
    if [au for (au, _r) in got] != ref:
        raise SystemExit("chip_smoke: MeshEncoder AUs differ from the "
                         "single-card Encoder")
    say("four", f"MeshEncoder {width}x{height} all-intra x{n_frames}, "
        f"tiles 2x1: byte-identical to 1 card; wall incl. compile 4 cards "
        f"{t4:.2f} s, 1 card {t1:.2f} s")

    gmesh = build_gop_mesh(4)
    say("four", "gop mesh: " + ", ".join(
        f"(gop {g}) -> {d}" for g, d in enumerate(gmesh.devices)))
    gkw = dict(width=gw, height=gh, qp=27, gop_len=8, gop_lowdelay=False,
               bipred=1, intra_period=64, ref_frames=4, sao_type=3,
               deblock_enable=True, rdoq_enable=False, wpp=False)
    gframes = [FramePlanes(*f) for f in synth_frames(gw, gh, g_frames)]
    L = g_frames // 4
    for run in ("cold", "warm"):
        menc = MeshGopEncoder(Config(**gkw), gmesh)
        res, t4 = timed(lambda: menc.encode(gframes))
        refs, t1 = timed(lambda: [single(Config(**gkw),
                                         gframes[g * L:(g + 1) * L])
                                  for g in range(4)])
        if [[au for (au, *_r) in run_] for run_ in res] != refs:
            raise SystemExit("chip_smoke: MeshGopEncoder AUs differ from the "
                             "single-card Encoder")
        d = menc.disp
        if d.errors or d.sharded_calls == 0:
            raise SystemExit(f"chip_smoke: MeshGopEncoder fell back to "
                             f"unsharded dispatch: {d.errors}")
        say("four", f"MeshGopEncoder {gw}x{gh} RA8 x{g_frames} over 4 "
            f"devices, {run}: byte-identical to 1 card, "
            f"{d.sharded_calls} sharded dispatches; wall 4 cards "
            f"{t4:.2f} s, 1 card {t1:.2f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        from uvg266_jax.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the encoder package is not here ({e})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    import jax
    try:
        devs, card, se = phase_identity()
    except SystemExit as e:
        print(e, file=sys.stderr)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    if args.four:
        if len(devs) < 4:
            raise SystemExit(f"chip_smoke --four: {len(devs)} devices")
        phase_four()
    else:
        clock = CompileClock()
        ctx = Ctx(FULL_W, FULL_H, search_classes(FULL_W, FULL_H))
        phase_residency(se, (ctx.src, ctx.src[::2, ::2], ctx.src[1::2, 1::2]))
        with tempfile.TemporaryDirectory() as tmp:
            path, proc, log = start_cpu_crosscheck(tmp)
            try:
                phase_parity(ctx)
                time_predictors(ctx)
                phase_e2e(tmp, clock)
                phase_crosscheck(tmp, path, proc, log, ctx)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        phase_chip_tests()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
