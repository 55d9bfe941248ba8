"""Adaptive Loop Filter: classification, filtering, Wiener design, RD.

Behavioral parity with the reference ALF:
- block classification (4 directional Laplacians over 8x8 windows,
  activity + direction -> 25 classes + transpose):
  strategies/generic/alf-generic.c alf_derive_classification_blk_generic:49
- 7x7 (luma) / 5x5 (chroma) diamond filtering with virtual-boundary row
  remapping and near-boundary attenuation:
  alf-generic.c alf_filter_block_generic:290
- filter design (per-class Wiener solve + greedy class merging),
  coefficient quantization factor 1 << (bd-1): alf.c:458,2880-2990
- clipping values: alf.c:5248-5260 (linear mode uses clip idx 0 =
  1 << bitdepth, i.e. no clipping; alf_luma_clip flag stays 0)

Everything is whole-frame vectorized numpy: Laplacian maps and tap
differences are computed as shifted-array expressions; virtual-boundary
handling is folded into per-row gather index tables (the vectorized
shape of the reference's pointer-swap control flow).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_CLASSES = 25
VB_LUMA = 64 - 4          # virtual boundary offset within a CTU row
VB_CHROMA = 32 - 2

# 7x7 diamond tap pairs (transpose 0): coeff k -> ((dy,dx), (-dy,-dx))
LUMA_TAPS = [(3, 0), (2, 1), (2, 0), (2, -1), (1, 2), (1, 1), (1, 0),
             (1, -1), (1, -2), (0, 3), (0, 2), (0, 1)]
CHROMA_TAPS = [(2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1)]

# coefficient index permutations per transpose (alf-generic.c:386-506)
TR_LUMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
    [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6],
    [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11],
    [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6]], dtype=np.int32)
TR_CHROMA = np.array([
    [0, 1, 2, 3, 4, 5],
    [4, 1, 5, 3, 0, 2],
    [0, 3, 2, 1, 4, 5],
    [4, 3, 5, 1, 0, 2]], dtype=np.int32)

ACT_TH = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                  dtype=np.int32)
TRANSPOSE_TABLE = np.array([0, 1, 0, 2, 2, 3, 1, 3], dtype=np.int32)


def classify_frame(rec_y: np.ndarray, bitdepth: int = 8):
    """Per-4x4 (class_idx, transpose_idx) maps for the luma plane."""
    H, W = rec_y.shape
    shift = bitdepth + 4
    P = np.pad(rec_y.astype(np.int32), 4, mode="edge")

    # subsampled laplacian positions: rows r = -2,0,..., cols c = -2,0,...
    rr = np.arange(-2, H + 2, 2)
    cc = np.arange(-2, W + 2, 2)
    ry = rr[:, None]
    # VB row remapping for the two source rows P(y-1) and P(y+2)
    down = ry - 1
    up2 = ry + 2
    m = np.mod(ry, 64)
    down = np.where((ry > 0) & (m == VB_LUMA), ry, down)
    up2 = np.where((ry > 0) & (m == VB_LUMA - 2), ry + 1, up2)

    def px(y, x):
        return P[y + 4, x + 4]

    cx = cc[None, :]
    y0 = 2 * px(ry, cx)
    y1 = 2 * px(ry + 1, cx + 1)
    ver = np.abs(y0 - px(down, cx) - px(ry + 1, cx)) \
        + np.abs(y1 - px(ry, cx + 1) - px(up2, cx + 1))
    hor = np.abs(y0 - px(ry, cx + 1) - px(ry, cx - 1)) \
        + np.abs(y1 - px(ry + 1, cx + 2) - px(ry + 1, cx))
    d0 = np.abs(y0 - px(down, cx - 1) - px(ry + 1, cx + 1)) \
        + np.abs(y1 - px(ry, cx) - px(up2, cx + 2))
    d1 = np.abs(y0 - px(ry + 1, cx - 1) - px(down, cx + 1)) \
        + np.abs(y1 - px(up2, cx) - px(ry, cx + 2))

    gh, gw = H // 4, W // 4

    def block_sums(L):
        # class block (by,bx): laplacian rows {2by..2by+3}, cols {2bx..2bx+3}
        s = L[:2 * gh + 2, :2 * gw + 2]
        c = np.cumsum(np.cumsum(s, 0), 1)
        cpad = np.zeros((s.shape[0] + 1, s.shape[1] + 1), dtype=np.int64)
        cpad[1:, 1:] = c
        r0 = 2 * np.arange(gh)
        c0 = 2 * np.arange(gw)
        full = (cpad[r0[:, None] + 4, c0[None, :] + 4]
                - cpad[r0[:, None], c0[None, :] + 4]
                - cpad[r0[:, None] + 4, c0[None, :]]
                + cpad[r0[:, None], c0[None, :]])
        # VB variants: skip last laplacian row / first laplacian row
        top3 = (cpad[r0[:, None] + 3, c0[None, :] + 4]
                - cpad[r0[:, None], c0[None, :] + 4]
                - cpad[r0[:, None] + 3, c0[None, :]]
                + cpad[r0[:, None], c0[None, :]])
        bot3 = (cpad[r0[:, None] + 4, c0[None, :] + 4]
                - cpad[r0[:, None] + 1, c0[None, :] + 4]
                - cpad[r0[:, None] + 4, c0[None, :]]
                + cpad[r0[:, None] + 1, c0[None, :]])
        by = 4 * np.arange(gh)[:, None]
        mm = np.mod(by, 64)
        out = np.where(mm == VB_LUMA - 4, top3,
                       np.where(mm == VB_LUMA, bot3, full))
        return out

    sum_v = block_sums(ver)
    sum_h = block_sums(hor)
    sum_d0 = block_sums(d0)
    sum_d1 = block_sums(d1)

    by = 4 * np.arange(gh)[:, None]
    at_vb = (np.mod(by, 64) == VB_LUMA - 4) | (np.mod(by, 64) == VB_LUMA)
    mult = np.where(at_vb, 96, 64)
    temp_act = sum_v + sum_h
    activity = np.clip((temp_act * mult) >> shift, 0, 15)
    class_idx = ACT_TH[activity]

    hv_first = sum_v > sum_h
    hv1 = np.where(hv_first, sum_v, sum_h)
    hv0 = np.where(hv_first, sum_h, sum_v)
    dir_hv = np.where(hv_first, 1, 3)
    d_first = sum_d0 > sum_d1
    dd1 = np.where(d_first, sum_d0, sum_d1)
    dd0 = np.where(d_first, sum_d1, sum_d0)
    dir_d = np.where(d_first, 0, 2)
    d_wins = dd1.astype(np.uint64) * hv0.astype(np.uint64) \
        > hv1.astype(np.uint64) * dd0.astype(np.uint64)
    hvd1 = np.where(d_wins, dd1, hv1)
    hvd0 = np.where(d_wins, dd0, hv0)
    main_dir = np.where(d_wins, dir_d, dir_hv)
    sec_dir = np.where(d_wins, dir_hv, dir_d)
    strength = np.where(hvd1 * 2 > 9 * hvd0, 2,
                        np.where(hvd1 > 2 * hvd0, 1, 0))
    class_idx = class_idx + np.where(
        strength > 0, (((main_dir & 1) << 1) + strength) * 5, 0)
    transpose = TRANSPOSE_TABLE[main_dir * 2 + (sec_dir >> 1)]
    return class_idx.astype(np.int32), transpose.astype(np.int32)


def _vb_row_offsets(vb_pos: int, vb_h: int, n_rows: int):
    """Effective row offsets per |d| in 1..3 for each absolute row
    (alf-generic.c:600-622 pointer swaps, symmetric above/below)."""
    y = np.arange(n_rows)
    m = np.mod(y, vb_h)
    offs = {}
    for d in (1, 2, 3):
        up = np.full(n_rows, d)       # downward offset (+d)
        dn = np.full(n_rows, -d)      # upward offset (-d)
        # above the VB: rows vb-1, vb-2, vb-3 limit reach downward
        dist_dn = vb_pos - 1 - m      # rows until the VB going down
        above = (m < vb_pos) & (m >= vb_pos - 3)
        up[above] = np.minimum(d, np.maximum(dist_dn[above], 0))
        dn[above] = -np.minimum(d, np.maximum(dist_dn[above], 0))
        # below the VB: rows vb, vb+1, vb+2 limit reach upward
        dist_up = m - vb_pos
        below = (m >= vb_pos) & (m <= vb_pos + 2)
        up[below] = np.minimum(d, np.maximum(dist_up[below], 0))
        dn[below] = -np.minimum(d, np.maximum(dist_up[below], 0))
        offs[d] = (up, dn)
    return offs


def alf_clip_values(bitdepth: int):
    """Nonlinear clipping values (alf.c:5248-5260): idx 0 is a no-op."""
    sh = bitdepth - 8
    return [1 << bitdepth, 1 << (5 + sh), 1 << (3 + sh), 1 << (1 + sh)]


def _tap_features(plane: np.ndarray, is_chroma: bool, bitdepth: int,
                  clip: int | None = None):
    """Per-pixel clipped pair-sum features f_k = K(a_k - c) + K(b_k - c)
    for every diamond tap; K clips each one-sided difference to +-clip
    (nonlinear ALF, alf.c filter_blk clipping; None/idx-0 = linear).
    Returns [n_taps, H, W] int32."""
    H, W = plane.shape
    taps = CHROMA_TAPS if is_chroma else LUMA_TAPS
    vb_pos = VB_CHROMA if is_chroma else VB_LUMA
    vb_h = 32 if is_chroma else 64
    P = np.pad(plane.astype(np.int32), 4, mode="edge")
    offs = _vb_row_offsets(vb_pos, vb_h, H)
    ys = np.arange(H)
    cur = plane.astype(np.int32)
    out = np.empty((len(taps), H, W), dtype=np.int32)
    for k, (dy, dx) in enumerate(taps):
        if dy == 0:
            a = P[4:H + 4, 4 + dx:4 + W + dx]
            b = P[4:H + 4, 4 - dx:4 + W - dx]
        else:
            up, dn = offs[dy]
            ya = ys + up
            yb = ys + dn
            a = P[4 + ya[:, None], 4 + dx + np.arange(W)[None, :]]
            b = P[4 + yb[:, None], 4 - dx + np.arange(W)[None, :]]
        if clip is None:
            ck = None
        elif np.isscalar(clip):
            ck = clip
        elif isinstance(clip, np.ndarray) and clip.ndim == 3:
            ck = clip[k]                 # per-pixel clip values
        else:
            ck = int(clip[k])
        if ck is None:
            out[k] = (a - cur) + (b - cur)
        else:
            out[k] = np.clip(a - cur, -ck, ck) \
                + np.clip(b - cur, -ck, ck)
    return out


def _near_vb_rows(H: int, is_chroma: bool):
    vb_pos = VB_CHROMA if is_chroma else VB_LUMA
    vb_h = 32 if is_chroma else 64
    m = np.mod(np.arange(H), vb_h)
    return (m == vb_pos - 1) | (m == vb_pos)


def filter_plane(plane: np.ndarray, coeff_px: np.ndarray,
                 feats: np.ndarray, bitdepth: int,
                 is_chroma: bool) -> np.ndarray:
    """Apply ALF given per-pixel coefficients [n_taps, H, W] and
    precomputed tap features; returns the filtered plane."""
    H, W = plane.shape
    shift = bitdepth - 1
    s = (coeff_px.astype(np.int64) * feats.astype(np.int64)).sum(axis=0)
    near = _near_vb_rows(H, is_chroma)[:, None]
    sum_n = (s + (1 << (shift - 1))) >> shift
    sum_v = (s + (1 << (shift + 2))) >> (shift + 3)
    r = plane.astype(np.int64) + np.where(near, sum_v, sum_n)
    return np.clip(r, 0, (1 << bitdepth) - 1).astype(np.int32)


def _pixel_coeffs_luma(class_map, transpose_map, coeff_tab, filter_map):
    """Expand per-4x4 class/transpose into per-pixel tap coefficients.

    coeff_tab: [n_filters, 12]; filter_map: [25] class -> filter idx.
    Returns [12, H, W] via a (class, transpose) -> permuted-coeff LUT."""
    n_f = coeff_tab.shape[0]
    lut = np.empty((NUM_CLASSES, 4, 12), dtype=np.int32)
    for c in range(NUM_CLASSES):
        f = coeff_tab[filter_map[c]]
        for t in range(4):
            lut[c, t] = f[TR_LUMA[t]]
    per_blk = lut[class_map, transpose_map]          # [gh, gw, 12]
    per_px = np.repeat(np.repeat(per_blk, 4, axis=0), 4, axis=1)
    return per_px.transpose(2, 0, 1)


def _pixel_clips_luma(class_map, transpose_map, clip_tab, filter_map,
                      bitdepth):
    """Per-pixel per-tap clip VALUES for nonlinear luma ALF with
    per-filter per-tap indices (alf_luma_clip_idx), permuted like the
    coefficients. clip_tab: [n_filters, 12] indices; returns
    [12, H, W] int32 (reference alf filter_blk clipping)."""
    clipv = np.asarray(alf_clip_values(bitdepth), dtype=np.int32)
    lut = np.empty((NUM_CLASSES, 4, 12), dtype=np.int32)
    for c in range(NUM_CLASSES):
        f = clip_tab[filter_map[c]]
        for t in range(4):
            lut[c, t] = clipv[f[TR_LUMA[t]]]
    per_blk = lut[class_map, transpose_map]
    per_px = np.repeat(np.repeat(per_blk, 4, axis=0), 4, axis=1)
    return per_px.transpose(2, 0, 1)


def _pixel_coeffs_chroma(H, W, coeff):
    c = np.asarray(coeff, dtype=np.int32)[TR_CHROMA[0]]
    return np.broadcast_to(c[:, None, None], (6, H, W)).copy()


@dataclass
class AlfFrameParams:
    """Per-frame ALF decision (the alf_aps + CTU flag state)."""
    # temporal APS state (alf.c:78-102 aps pool): a frame either signals
    # a new APS (new_aps=True, fresh aps_id) or references a previously
    # transmitted one by id in the slice header
    aps_id: int = 0
    new_aps: bool = True
    luma_enabled: bool = False
    cb_enabled: bool = False
    cr_enabled: bool = False
    num_filters: int = 1
    filter_map: np.ndarray = None       # [25] class -> filter idx
    luma_coeffs: np.ndarray = None      # [n_filters, 12]
    chroma_coeffs: np.ndarray = None    # [6] (alternative 0)
    ctu_flags_y: np.ndarray = None      # [n_ctu] bool
    luma_clip: int = 0                  # uniform clip idx (0 = linear)
    luma_clip_taps: np.ndarray = None   # [n_filters, 12] per-tap idx
    ctu_flags_cb: np.ndarray = None
    ctu_flags_cr: np.ndarray = None
    # chroma alternatives (decode side; this encoder signals one):
    # alf_chroma_num_alts_minus1 + per-CTU alf_ctb_alternatives
    num_chroma_alts: int = 1
    chroma_alts: np.ndarray = None      # [n_alt, 6] coeffs
    chroma_clip: np.ndarray = None      # [n_alt, 6] clip idx (nonlinear)
    ctu_alt_cb: np.ndarray = None       # [n_ctu] chosen alternative
    ctu_alt_cr: np.ndarray = None
    # luma filter-set selection (decode side; this encoder signals one
    # APS and always selects it): per-CTU alf_ctb_filter_index — sets
    # 0..15 are the fixed (pre-defined) sets, 16+i is the i-th slice APS
    num_luma_aps: int = 1
    luma_aps_list: list = None          # [AlfFrameParams] APS set pool
    ctu_filter_set: np.ndarray = None   # [n_ctu] int set idx
    # CC-ALF (alf_type == 2): one filter per chroma component
    cc_cb_enabled: bool = False
    cc_cr_enabled: bool = False
    cc_cb_coeffs: np.ndarray = None     # [7], values in +-{0,1,2,...,64}
    cc_cr_coeffs: np.ndarray = None
    cc_flags_cb: np.ndarray = None      # [n_ctu] bool (filter_control_idc)
    cc_flags_cr: np.ndarray = None


def _solve_filter(A: np.ndarray, b: np.ndarray, bitdepth: int):
    """Wiener solve + quantization (factor 1<<(bd-1), alf.c:458)."""
    factor = 1 << (bitdepth - 1)
    A = A + np.eye(A.shape[0]) * (1e-7 * max(1.0, np.trace(A)))
    try:
        x = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return np.zeros(A.shape[0], dtype=np.int32)
    q = np.round(x * factor).astype(np.int64)
    return np.clip(q, -127, 127).astype(np.int32)


def _class_stats(feats, err, class_map, transpose_map):
    """Per-class (A, b) with transpose-normalized tap ordering."""
    n_t = feats.shape[0]
    A = np.zeros((NUM_CLASSES, n_t, n_t), dtype=np.float64)
    b = np.zeros((NUM_CLASSES, n_t), dtype=np.float64)
    # normalize features to transpose-0 ordering per 4x4 block:
    # feats ordered by spatial tap k; a block with transpose t uses
    # coeff[TR[t][k]] at tap k, so accumulate feature k into slot TR[t][k]
    per_px_cls = np.repeat(np.repeat(class_map, 4, 0), 4, 1)
    per_px_tr = np.repeat(np.repeat(transpose_map, 4, 0), 4, 1)
    H, W = per_px_cls.shape
    f = feats[:, :H, :W].reshape(n_t, -1).astype(np.float64)
    e = err[:H, :W].reshape(-1).astype(np.float64)
    cls = per_px_cls.reshape(-1)
    tr = per_px_tr.reshape(-1)
    TR = TR_LUMA if n_t == 12 else TR_CHROMA
    for c in range(NUM_CLASSES):
        for t in range(4):
            sel = (cls == c) & (tr == t)
            if not sel.any():
                continue
            fs = np.empty((n_t, sel.sum()))
            fs[TR[t]] = f[:, sel]
            A[c] += fs @ fs.T
            b[c] += fs @ e[sel]
    return A, b


def _merge_classes(A, b, bitdepth, max_filters=8):
    """Greedy class merging: repeatedly merge the pair with the least
    SSE increase (alf.c merge_classes behavior, simplified: fixed target
    count rather than per-count RD sweep)."""
    groups = [[c] for c in range(NUM_CLASSES)]
    As = [A[c].copy() for c in range(NUM_CLASSES)]
    bs = [b[c].copy() for c in range(NUM_CLASSES)]

    def sse_gain(Ax, bx):
        Ar = Ax + np.eye(Ax.shape[0]) * (1e-7 * max(1.0, np.trace(Ax)))
        try:
            return float(bx @ np.linalg.solve(Ar, bx))
        except np.linalg.LinAlgError:
            return 0.0

    gains = [sse_gain(As[i], bs[i]) for i in range(len(groups))]
    while len(groups) > max_filters:
        best = None
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                g = sse_gain(As[i] + As[j], bs[i] + bs[j])
                loss = gains[i] + gains[j] - g
                if best is None or loss < best[0]:
                    best = (loss, i, j, g)
        _, i, j, g = best
        groups[i] = groups[i] + groups[j]
        As[i] += As[j]
        bs[i] += bs[j]
        gains[i] = g
        del groups[j], As[j], bs[j], gains[j]
    filter_map = np.zeros(NUM_CLASSES, dtype=np.int32)
    coeffs = np.zeros((len(groups), A.shape[1]), dtype=np.int32)
    for fi, g in enumerate(groups):
        for c in g:
            filter_map[c] = fi
        coeffs[fi] = _solve_filter(As[fi], bs[fi], bitdepth)
    return filter_map, coeffs


def alf_search_frame(src_planes, rec_planes, ctrl, lam: float,
                     bitdepth: int = 8,
                     aps_pool: list | None = None) -> AlfFrameParams:
    """Design filters from whole-frame Wiener stats, then decide per-CTU
    enable flags by SSD + lambda*bits (alf.c uvg_alf_enc_process shape,
    single design iteration).

    aps_pool: previously transmitted AlfFrameParams (encode-side temporal
    APS reuse, alf.c:78-102). Each pooled filter set is evaluated on this
    frame with fresh per-CTU flags; reuse pays only slice-header id bits
    where a new design pays the whole APS."""
    p = AlfFrameParams()
    wl, hl = ctrl.width_in_lcu, ctrl.height_in_lcu
    n_ctu = wl * hl
    H, W = rec_planes.y.shape

    cls, tr = classify_frame(rec_planes.y, bitdepth)
    err = src_planes.y.astype(np.int64) - rec_planes.y.astype(np.int64)
    cy = np.arange(H) // 64
    cx = np.arange(W) // 64
    idx = (cy[:, None] * wl + cx[None, :]).ravel()
    d_off = ((rec_planes.y.astype(np.int64) - src_planes.y) ** 2).ravel()
    ssd_off = np.bincount(idx, weights=d_off, minlength=n_ctu)
    clip_vals = alf_clip_values(bitdepth)

    feats_cache: dict = {}

    def _feats(clip_idx):
        if clip_idx not in feats_cache:
            clip = None if clip_idx == 0 else clip_vals[clip_idx]
            feats_cache[clip_idx] = _tap_features(rec_planes.y, False,
                                                  bitdepth, clip=clip)
        return feats_cache[clip_idx]

    def _ctu_decide(fmap, cfs, clip_idx, extra_bits):
        """Per-CTU on/off decision for one fixed luma filter set."""
        feats_c = _feats(clip_idx)
        cpx = _pixel_coeffs_luma(cls, tr, cfs, fmap)
        filt = filter_plane(rec_planes.y, cpx, feats_c, bitdepth, False)
        d_on = ((filt.astype(np.int64) - src_planes.y) ** 2).ravel()
        ssd_on = np.bincount(idx, weights=d_on, minlength=n_ctu)
        fl = ssd_on + lam * 3.0 < ssd_off + lam * 1.0
        g = float(((ssd_off - ssd_on) * fl).sum()) \
            - lam * (3.0 * fl.sum() + extra_bits)
        return g, fl

    def design(clip_idx):
        """Fit + per-CTU decision for one uniform clip idx; returns
        (gain, flags, filter_map, coeffs) or None."""
        A, b = _class_stats(_feats(clip_idx), err, cls, tr)
        fmap, cfs = _merge_classes(A, b, bitdepth)
        if not cfs.any():
            return None
        extra = cfs.shape[0] * 12 * 2.0 if clip_idx else 0.0
        g, fl = _ctu_decide(fmap, cfs, clip_idx, extra)
        return g, fl, fmap, cfs

    best = None
    best_idx = 0
    # uniform nonlinear clipping candidates (alf.c nonlinear mode; the
    # reference optimizes per-tap indices — uniform is the v1 search)
    for j in (0, 2, 1):
        r = design(j)
        if r is not None and (best is None or r[0] > best[0]):
            best, best_idx = r, j

    # temporal reuse candidates: pooled filter sets with fresh CTU flags
    best_reuse = None
    if aps_pool:
        for entry in aps_pool:
            if not entry.luma_enabled or entry.luma_coeffs is None:
                continue
            g, fl = _ctu_decide(entry.filter_map, entry.luma_coeffs,
                                entry.luma_clip, 0.0)
            if best_reuse is None or g > best_reuse[0]:
                best_reuse = (g, fl, entry)

    # frame-level decision: a new APS + per-CTU signaling must pay for
    # the distortion saved (alf.c RD gate around the aps/slice enables);
    # reuse pays only the slice-header aps-id bits
    new_score = None
    if best is not None:
        gain, flags, filter_map, coeffs = best
        aps_bits_est = 40.0 + coeffs.shape[0] * 12 * 4.0
        if gain >= lam * aps_bits_est and flags.any():
            new_score = gain - lam * aps_bits_est
    reuse_score = None
    if best_reuse is not None:
        g_r, fl_r, entry_r = best_reuse
        if g_r >= lam * 10.0 and fl_r.any():
            reuse_score = g_r - lam * 10.0
    if new_score is None and reuse_score is None:
        return p
    if reuse_score is not None and (new_score is None
                                    or reuse_score >= new_score):
        p.ctu_flags_y = best_reuse[1]
        p.luma_enabled = True
        p.num_filters = entry_r.num_filters
        p.filter_map = entry_r.filter_map
        p.luma_coeffs = entry_r.luma_coeffs
        p.luma_clip = entry_r.luma_clip
        p.new_aps = False
        p.aps_id = entry_r.aps_id
        _chroma_reuse_decide(p, entry_r, src_planes, rec_planes, ctrl,
                             lam, bitdepth)
        return p
    p.ctu_flags_y = flags
    p.luma_enabled = True
    p.num_filters = coeffs.shape[0]
    p.filter_map = filter_map
    p.luma_coeffs = coeffs
    p.luma_clip = best_idx

    if rec_planes.u is not None:
        n_t = len(CHROMA_TAPS)
        Ac = np.zeros((n_t, n_t))
        bc = np.zeros(n_t)
        fu = _tap_features(rec_planes.u, True, bitdepth)
        fv = _tap_features(rec_planes.v, True, bitdepth)
        for fplane, srcp, recp in ((fu, src_planes.u, rec_planes.u),
                                   (fv, src_planes.v, rec_planes.v)):
            fm = fplane.reshape(n_t, -1).astype(np.float64)
            em = (srcp.astype(np.int64) - recp.astype(np.int64)) \
                .reshape(-1).astype(np.float64)
            Ac += fm @ fm.T
            bc += fm @ em
        ccoef = _solve_filter(Ac, bc, bitdepth)
        p.chroma_coeffs = ccoef
        if ccoef.any():
            _chroma_ctu_decide(p, ccoef, (fu, fv), src_planes, rec_planes,
                               ctrl, lam, bitdepth)
    if p.ctu_flags_cb is None:
        p.ctu_flags_cb = np.zeros(n_ctu, dtype=bool)
    if p.ctu_flags_cr is None:
        p.ctu_flags_cr = np.zeros(n_ctu, dtype=bool)
    return p


def _chroma_ctu_decide(p: AlfFrameParams, ccoef, feats_uv, src_planes,
                       rec_planes, ctrl, lam: float, bitdepth: int):
    """Per-CTU chroma on/off for one fixed 5x5 coefficient set."""
    Hc, Wc = rec_planes.u.shape
    wl = ctrl.width_in_lcu
    n_ctu = wl * ctrl.height_in_lcu
    fu, fv = feats_uv
    ccy = np.arange(Hc) // 32
    ccx = np.arange(Wc) // 32
    cidx = (ccy[:, None] * wl + ccx[None, :]).ravel()
    for name, fplane, srcp, recp in (
            ("cb", fu, src_planes.u, rec_planes.u),
            ("cr", fv, src_planes.v, rec_planes.v)):
        cpx = _pixel_coeffs_chroma(Hc, Wc, ccoef)
        filt = filter_plane(recp, cpx, fplane, bitdepth, True)
        doff = ((recp.astype(np.int64) - srcp) ** 2).ravel()
        don = ((filt.astype(np.int64) - srcp) ** 2).ravel()
        soff = np.bincount(cidx, weights=doff, minlength=n_ctu)
        son = np.bincount(cidx, weights=don, minlength=n_ctu)
        fl = son + lam * 2.0 < soff + lam * 1.0
        cgain = float(((soff - son) * fl).sum()) \
            - lam * 2.0 * fl.sum()
        if cgain < lam * 30.0:
            fl = np.zeros(n_ctu, dtype=bool)
        if name == "cb":
            p.ctu_flags_cb = fl
            p.cb_enabled = bool(fl.any())
        else:
            p.ctu_flags_cr = fl
            p.cr_enabled = bool(fl.any())


def _chroma_reuse_decide(p: AlfFrameParams, entry: AlfFrameParams,
                         src_planes, rec_planes, ctrl, lam: float,
                         bitdepth: int):
    """Chroma decision for a temporal-reuse frame: the referenced APS
    only carries chroma coefficients if it signalled them (alf_chroma
    _new_filter), so reuse either adopts that set or disables chroma."""
    n_ctu = ctrl.width_in_lcu * ctrl.height_in_lcu
    p.ctu_flags_cb = np.zeros(n_ctu, dtype=bool)
    p.ctu_flags_cr = np.zeros(n_ctu, dtype=bool)
    if rec_planes.u is None or entry.chroma_coeffs is None \
            or not (entry.cb_enabled or entry.cr_enabled) \
            or not entry.chroma_coeffs.any():
        return
    p.chroma_coeffs = entry.chroma_coeffs
    fu = _tap_features(rec_planes.u, True, bitdepth)
    fv = _tap_features(rec_planes.v, True, bitdepth)
    _chroma_ctu_decide(p, entry.chroma_coeffs, (fu, fv), src_planes,
                       rec_planes, ctrl, lam, bitdepth)


# CC-ALF 3x4 diamond taps on the co-located luma, as (dy, dx) relative to
# (2y, 2x) for 4:2:0 (alf-generic-style filter_blk_cc_alf, alf.c:1626)
CC_TAPS = [(-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0)]
CC_CAND = np.array([0, 1, 2, 4, 8, 16, 32, 64], dtype=np.int64)


def _cc_features(luma: np.ndarray, Hc: int, Wc: int) -> np.ndarray:
    """[7, Hc, Wc] luma tap differences at chroma resolution, with the
    virtual-boundary row remapping of filter_blk_cc_alf (alf.c:1680-1699).
    luma: the SAO-output (pre-ALF) luma plane."""
    H, W = luma.shape
    P = np.pad(luma.astype(np.int64), 2, mode="edge")
    ys = 2 * np.arange(Hc)
    xs = 2 * np.arange(Wc)
    pos = np.mod(ys, 64)
    # row offsets per tap row index {-1, 0, +1, +2}
    off1 = np.full(Hc, 1)      # +1 row
    off2 = np.full(Hc, -1)     # -1 row
    off3 = np.full(Hc, 2)      # +2 rows
    sel_a = (pos == VB_LUMA - 2) | (pos == VB_LUMA + 1)
    off3[sel_a] = 1
    sel_b = (pos == VB_LUMA - 1) | (pos == VB_LUMA)
    off1[sel_b] = 0
    off2[sel_b] = 0
    off3[sel_b] = 0
    cur = P[2 + ys[:, None], 2 + xs[None, :]]
    out = np.empty((7, Hc, Wc), dtype=np.int64)
    rows = {-1: off2, 0: np.zeros(Hc, dtype=np.int64), 1: off1, 2: off3}
    for k, (dy, dx) in enumerate(CC_TAPS):
        ry = ys + rows[dy]
        out[k] = P[2 + ry[:, None], 2 + dx + xs[None, :]] - cur
    return out


def _cc_quantize(x: np.ndarray) -> np.ndarray:
    """Round LMS coefficients (scaled by 128) to the +-power-of-two
    candidate set (alf.c round_filt_coeff_cc_alf:1846)."""
    out = np.zeros(7, dtype=np.int64)
    for i, v in enumerate(x):
        sv = 1 if v > 0 else -1
        errs = (abs(v) * 128.0 - CC_CAND) ** 2
        out[i] = sv * CC_CAND[int(np.argmin(errs))]
    return out


def cc_alf_search(src_planes, rec_planes, pre_alf_luma, p: AlfFrameParams,
                  ctrl, lam: float, bitdepth: int = 8,
                  fixed_from: AlfFrameParams | None = None) -> None:
    """Derive one CC-ALF filter per chroma component and per-CTU flags;
    runs after the ALF chroma decision (input luma = SAO output).

    fixed_from: temporal-reuse mode — the referenced APS's CC
    coefficients are kept (they were transmitted with that APS); only
    the per-CTU control flags are re-searched for this frame."""
    if rec_planes.u is None:
        return
    Hc, Wc = rec_planes.u.shape
    wl = ctrl.width_in_lcu
    n_ctu = wl * ctrl.height_in_lcu
    feats = _cc_features(pre_alf_luma, Hc, Wc)
    f = feats.reshape(7, -1).astype(np.float64)
    A = f @ f.T
    A += np.eye(7) * (1e-6 * max(1.0, np.trace(A)))
    ccy = np.arange(Hc) // 32
    ccx = np.arange(Wc) // 32
    cidx = (ccy[:, None] * wl + ccx[None, :]).ravel()
    for name, srcp, recp in (("cb", src_planes.u, rec_planes.u),
                             ("cr", src_planes.v, rec_planes.v)):
        if fixed_from is not None:
            coef = (fixed_from.cc_cb_coeffs if name == "cb"
                    else fixed_from.cc_cr_coeffs)
            enabled = (fixed_from.cc_cb_enabled if name == "cb"
                       else fixed_from.cc_cr_enabled)
            if not enabled or coef is None or not coef.any():
                continue
        else:
            err = (srcp.astype(np.int64) - recp.astype(np.int64)) \
                .reshape(-1).astype(np.float64)
            try:
                coef = _cc_quantize(np.linalg.solve(A, f @ err))
            except np.linalg.LinAlgError:
                continue
        if not coef.any():
            continue
        delta = ((feats * coef[:, None, None]).sum(0) + 64) >> 7
        off = 1 << (bitdepth - 1)
        delta = np.clip(delta + off, 0, (1 << bitdepth) - 1) - off
        filt = np.clip(recp.astype(np.int64) + delta, 0,
                       (1 << bitdepth) - 1)
        d_off = ((recp.astype(np.int64) - srcp) ** 2).ravel()
        d_on = ((filt - srcp) ** 2).ravel()
        soff = np.bincount(cidx, weights=d_off, minlength=n_ctu)
        son = np.bincount(cidx, weights=d_on, minlength=n_ctu)
        flags = son + lam * 2.0 < soff + lam * 1.0
        gain = float(((soff - son) * flags).sum()) - lam * 2.0 * flags.sum()
        if gain < lam * 40.0 or not flags.any():
            continue
        if name == "cb":
            p.cc_cb_enabled = True
            p.cc_cb_coeffs = coef
            p.cc_flags_cb = flags
        else:
            p.cc_cr_enabled = True
            p.cc_cr_coeffs = coef
            p.cc_flags_cr = flags


def cc_alf_apply(rec_planes, pre_alf_luma, p: AlfFrameParams, ctrl,
                 bitdepth: int = 8) -> None:
    """Apply CC-ALF corrections in place (after ALF)."""
    if rec_planes.u is None or p is None:
        return
    if not (p.cc_cb_enabled or p.cc_cr_enabled):
        return
    Hc, Wc = rec_planes.u.shape
    wl = ctrl.width_in_lcu
    feats = _cc_features(pre_alf_luma, Hc, Wc)
    ccy = np.arange(Hc) // 32
    ccx = np.arange(Wc) // 32
    cmap = ccy[:, None] * wl + ccx[None, :]
    off = 1 << (bitdepth - 1)
    for enabled, coef, flags, plane in (
            (p.cc_cb_enabled, p.cc_cb_coeffs, p.cc_flags_cb, rec_planes.u),
            (p.cc_cr_enabled, p.cc_cr_coeffs, p.cc_flags_cr, rec_planes.v)):
        if not enabled:
            continue
        delta = ((feats * coef[:, None, None]).sum(0) + 64) >> 7
        delta = np.clip(delta + off, 0, (1 << bitdepth) - 1) - off
        filt = np.clip(plane.astype(np.int64) + delta, 0,
                       (1 << bitdepth) - 1).astype(np.int32)
        mask = flags[cmap]
        plane[:] = np.where(mask, filt, plane)


def alf_apply_frame(rec_planes, p: AlfFrameParams, ctrl,
                    bitdepth: int = 8) -> None:
    """Apply the decided ALF in place (shared by encoder and oracle)."""
    if p is None or not (p.luma_enabled or p.cb_enabled or p.cr_enabled):
        return
    wl = ctrl.width_in_lcu
    if p.luma_enabled:
        H, W = rec_planes.y.shape
        cls, tr = classify_frame(rec_planes.y, bitdepth)
        cy = np.arange(H) // 64
        cx = np.arange(W) // 64
        ctu_px = cy[:, None] * wl + cx[None, :]
        mask = p.ctu_flags_y[ctu_px]
        if p.ctu_filter_set is None:
            # single APS set (this encoder's path)
            if getattr(p, "luma_clip_taps", None) is not None:
                clip = _pixel_clips_luma(cls, tr, p.luma_clip_taps,
                                         p.filter_map, bitdepth)
            else:
                clip = alf_clip_values(bitdepth)[p.luma_clip] \
                    if p.luma_clip else None
            feats = _tap_features(rec_planes.y, False, bitdepth, clip=clip)
            coeff_px = _pixel_coeffs_luma(cls, tr, p.luma_coeffs,
                                          p.filter_map)
            filt = filter_plane(rec_planes.y, coeff_px, feats, bitdepth,
                                False)
            rec_planes.y[:] = np.where(mask, filt, rec_planes.y)
        else:
            # per-CTU alf_ctb_filter_index: fixed sets 0..15 + APS sets
            from ..ops.alf_fixed_tables import (CLASS_TO_FIXED_FILTER,
                                                FIXED_FILTER_COEFF)
            set_px = p.ctu_filter_set[ctu_px]
            out = rec_planes.y.copy()
            feats_cache = {}
            for s in np.unique(set_px[mask]):
                if s < 16:
                    coeff_tab = FIXED_FILTER_COEFF
                    fmap = CLASS_TO_FIXED_FILTER[s]
                    clip_idx = 0
                else:
                    aps = p.luma_aps_list[s - 16]
                    coeff_tab = aps.luma_coeffs
                    fmap = aps.filter_map
                    clip_idx = aps.luma_clip
                    if getattr(aps, "luma_clip_taps", None) is not None:
                        clip_px = _pixel_clips_luma(
                            cls, tr, aps.luma_clip_taps, fmap, bitdepth)
                        feats_px = _tap_features(rec_planes.y, False,
                                                 bitdepth, clip=clip_px)
                        coeff_px = _pixel_coeffs_luma(cls, tr, coeff_tab,
                                                      fmap)
                        filt = filter_plane(rec_planes.y, coeff_px,
                                            feats_px, bitdepth, False)
                        sel = mask & (set_px == s)
                        out[sel] = filt[sel]
                        continue
                clip = alf_clip_values(bitdepth)[clip_idx] if clip_idx \
                    else None
                if clip not in feats_cache:
                    feats_cache[clip] = _tap_features(
                        rec_planes.y, False, bitdepth, clip=clip)
                coeff_px = _pixel_coeffs_luma(cls, tr, coeff_tab, fmap)
                filt = filter_plane(rec_planes.y, coeff_px,
                                    feats_cache[clip], bitdepth, False)
                sel = mask & (set_px == s)
                out = np.where(sel, filt, out)
            rec_planes.y[:] = out
    if (p.cb_enabled or p.cr_enabled) and rec_planes.u is not None:
        Hc, Wc = rec_planes.u.shape
        ccy = np.arange(Hc) // 32
        ccx = np.arange(Wc) // 32
        cmap = ccy[:, None] * wl + ccx[None, :]
        n_alt = p.num_chroma_alts if p.chroma_alts is not None else 1
        clipv = alf_clip_values(bitdepth)
        for enabled, flags, alts_map, plane in (
                (p.cb_enabled, p.ctu_flags_cb, p.ctu_alt_cb, rec_planes.u),
                (p.cr_enabled, p.ctu_flags_cr, p.ctu_alt_cr, rec_planes.v)):
            if not enabled:
                continue
            filt_alts = []
            for a in range(n_alt):
                coeff = p.chroma_alts[a] if p.chroma_alts is not None \
                    else p.chroma_coeffs
                clip = None
                if p.chroma_clip is not None:
                    # per-tap clip values, permuted like the coefficients
                    clip = np.asarray(
                        [clipv[int(i)]
                         for i in p.chroma_clip[a][TR_CHROMA[0]]],
                        dtype=np.int64)
                feats = _tap_features(plane, True, bitdepth, clip=clip)
                cpx = _pixel_coeffs_chroma(Hc, Wc, coeff)
                filt_alts.append(
                    filter_plane(plane, cpx, feats, bitdepth, True))
            mask = flags[cmap]
            if n_alt == 1:
                plane[:] = np.where(mask, filt_alts[0], plane)
            else:
                alt_px = (alts_map if alts_map is not None
                          else np.zeros(len(flags), dtype=np.int32))[cmap]
                sel = filt_alts[0]
                for a in range(1, n_alt):
                    sel = np.where(alt_px == a, filt_alts[a], sel)
                plane[:] = np.where(mask, sel, plane)
