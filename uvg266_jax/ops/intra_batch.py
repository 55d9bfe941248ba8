"""Batched intra prediction: all 67 regular modes for a batch of blocks.

Batched reformulation of the reference's per-mode scalar kernels
(strategies/generic/intra-generic.c uvg_angular_pred_generic:55,
uvg_intra_pred_planar:300, intra_pred_dc, uvg_pdpc_planar_dc:410):
all mode-dependent control flow (wide-angle remap, reference extension for
negative angles, 4-tap filter choice, reference smoothing, PDPC weights) is
baked into static per-shape index/weight tables at build time, so the
batched prediction is two gathers + a weighted reduction over pure jnp ops
with no data-dependent branches. Bit-exact vs the scalar path by
construction (asserted in tests against ops.intra.predict_intra).

Unified reference vector layout per block (length 4*REF_LEN):
  [ top_unfiltered | left_unfiltered | top_filtered | left_filtered ]
index 0 of each section is the top-left sample.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .intra import (
    CUBIC_FILTER,
    HOR_VER_DIST_THRES,
    MODEDISP2INVSAMPLEDISP,
    MODEDISP2SAMPLEDISP,
    PRE_SCALE,
    IntraRefs,
    wide_angle_correction,
)

REF_LEN = 3 * 64 + 3          # matches build_reference's max_len
SEC_TOP, SEC_LEFT, SEC_FTOP, SEC_FLEFT = 0, 1, 2, 3
LOG2 = {4: 2, 8: 3, 16: 4, 32: 5, 64: 6}
NUM_MODES = 67


def _sec(section: int, idx):
    return section * REF_LEN + int(idx)


@lru_cache(maxsize=None)
def build_mode_tables(w: int, h: int, bitdepth: int = 8,
                      is_chroma: bool = False):
    """Static tables for all 67 modes of a w x h PU (PU == CU)."""
    log2_w, log2_h = LOG2[w], LOG2[h]
    K = np.zeros((NUM_MODES, h, w, 4), dtype=np.int32)    # gather indices
    W = np.zeros((NUM_MODES, h, w, 4), dtype=np.int32)    # <<6-domain weights
    needs_clip = np.zeros((NUM_MODES,), dtype=bool)
    # gradient PDPC (positive angular): out += (wl*(side - out) + 32) >> 6
    pdpc_on = np.zeros((NUM_MODES,), dtype=bool)
    pdpc_wl = np.zeros((NUM_MODES, h, w), dtype=np.int32)
    pdpc_sidx = np.zeros((NUM_MODES, h, w), dtype=np.int32)
    # pure hor/ver PDPC: out = clip(out + (wl*(side - topleft) + 32) >> 6)
    hv_on = np.zeros((NUM_MODES,), dtype=bool)
    hv_topleft = np.zeros((NUM_MODES,), dtype=np.int32)
    hv_sidx = np.zeros((NUM_MODES, h, w), dtype=np.int32)
    hv_wl = np.zeros((NUM_MODES, h, w), dtype=np.int32)

    for mode in range(2, 67):
        pred_mode = wide_angle_correction(mode, log2_w, log2_h)
        vertical = pred_mode >= 34
        mode_disp = pred_mode - 50 if vertical else -(pred_mode - 18)
        sample_disp = (-1 if mode_disp < 0 else 1) * int(
            MODEDISP2SAMPLEDISP[abs(mode_disp)])
        frac_mode = (abs(sample_disp) & 0x1F) != 0
        side_size_log2 = log2_h if vertical else log2_w
        scale = min(2, side_size_log2 - int(PRE_SCALE[abs(mode_disp)]))

        # reference smoothing + cubic/gauss selection (intra_predict_regular)
        smooth = False
        use_cubic = True
        if not is_chroma and not (w == 4 and h == 4):
            thres = HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1]
            dist = min(abs(pred_mode - 50), abs(pred_mode - 18))
            if dist > thres:
                if frac_mode:
                    use_cubic = False
                else:
                    smooth = True
        main_sec = (SEC_FTOP if smooth else SEC_TOP) if vertical else \
                   (SEC_FLEFT if smooth else SEC_LEFT)
        side_sec = (SEC_FLEFT if smooth else SEC_LEFT) if vertical else \
                   (SEC_FTOP if smooth else SEC_TOP)

        # work orientation: ww columns, hh rows; horizontal modes transpose
        ww, hh = (w, h) if vertical else (h, w)

        def out_pos(work_y, work_x):
            return (work_y, work_x) if vertical else (work_x, work_y)

        # extended main reference map: ext_idx[p] -> r index
        if sample_disp < 0:
            base = hh
            ext_len = base + ww + 8
            ext_idx = np.zeros(ext_len, dtype=np.int64)
            for i in range(min(ww + 2, ext_len - base)):
                ext_idx[base + i] = _sec(main_sec, i)
            inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
            for i in range(-hh, 0):
                ext_idx[base + i] = _sec(side_sec, min((-i * inv + 256) >> 9, hh))
        else:
            base = 0
            ext_len = ((sample_disp * hh) >> 5) + ww + 8
            ext_idx = np.array([_sec(main_sec, min(i, REF_LEN - 1))
                                for i in range(ext_len)], dtype=np.int64)

        for yy in range(hh):
            delta_pos = sample_disp * (yy + 1)
            delta_int = delta_pos >> 5
            delta_fract = delta_pos & 31
            if frac_mode:
                if not is_chroma:
                    if use_cubic:
                        wrow = np.asarray(CUBIC_FILTER[delta_fract])
                    else:
                        wrow = np.array([16 - (delta_fract >> 1),
                                         32 - (delta_fract >> 1),
                                         16 + (delta_fract >> 1),
                                         delta_fract >> 1], dtype=np.int32)
                    toff = 0
                else:
                    d = delta_fract
                    wrow = np.array([2 * (32 - d), 2 * d, 0, 0], dtype=np.int32)
                    toff = 1
            else:
                wrow = np.array([64, 0, 0, 0], dtype=np.int32)
                toff = 1
            for xx in range(ww):
                p0 = base + delta_int + xx + toff
                oy, ox = out_pos(yy, xx)
                K[mode, oy, ox] = [ext_idx[min(max(p0 + t, 0), ext_len - 1)]
                                   for t in range(4)]
                W[mode, oy, ox] = wrow
        needs_clip[mode] = frac_mode and not is_chroma

        # --- PDPC ---
        pdpc_ok = (w >= 4 and h >= 4)
        if 1 < pred_mode < 67:
            if mode_disp < 0:
                pdpc_ok = False
            elif mode_disp > 0:
                pdpc_ok = pdpc_ok and scale >= 0
        if sample_disp != 0:
            if pdpc_ok and sample_disp > 0:
                pdpc_on[mode] = True
                inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
                lim = min(3 << scale, ww)
                for yy in range(hh):
                    inv_angle_sum = 256
                    for xx in range(lim):
                        inv_angle_sum += inv
                        oy, ox = out_pos(yy, xx)
                        pdpc_wl[mode, oy, ox] = 32 >> ((2 * xx) >> scale)
                        pdpc_sidx[mode, oy, ox] = _sec(
                            side_sec, min(yy + (inv_angle_sum >> 9) + 1,
                                          REF_LEN - 1))
        else:
            if pdpc_ok:
                hv_on[mode] = True
                sc2 = (log2_w + log2_h - 2) >> 2
                hv_topleft[mode] = _sec(main_sec, 0)
                for yy in range(hh):
                    for xx in range(min(3 << sc2, ww)):
                        oy, ox = out_pos(yy, xx)
                        hv_wl[mode, oy, ox] = 32 >> ((2 * xx) >> sc2)
                        hv_sidx[mode, oy, ox] = _sec(side_sec, 1 + yy)

    # planar/DC PDPC weights (pdpc_planar_dc)
    scale_pd = (log2_w + log2_h - 2) >> 2
    xs = np.arange(w)
    ys = np.arange(h)
    pd_wl = (32 >> np.minimum(31, (xs * 2) >> scale_pd)).astype(np.int32)
    pd_wt = (32 >> np.minimum(31, (ys * 2) >> scale_pd)).astype(np.int32)

    return {
        "K": K, "W": W, "needs_clip": needs_clip,
        "pdpc_on": pdpc_on, "pdpc_wl": pdpc_wl, "pdpc_sidx": pdpc_sidx,
        "hv_on": hv_on, "hv_topleft": hv_topleft, "hv_sidx": hv_sidx,
        "hv_wl": hv_wl, "pd_wl": pd_wl, "pd_wt": pd_wt,
        "w": w, "h": h, "bitdepth": bitdepth, "is_chroma": is_chroma,
        "log2_w": log2_w, "log2_h": log2_h,
    }


def filtered_refs_np(top: np.ndarray, left: np.ndarray, w: int, h: int):
    """[1 2 1]/4 smoothing over batched refs [B, REF_LEN]."""
    rw = 2 * w + 1
    rh = 2 * h + 1
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    ft = top.copy()
    fl = left.copy()
    fl[:, 0] = (l[:, 1] + 2 * l[:, 0] + t[:, 1] + 2) >> 2
    ft[:, 0] = fl[:, 0]
    fl[:, 1:rh - 1] = (l[:, :rh - 2] + 2 * l[:, 1:rh - 1] + l[:, 2:rh] + 2) >> 2
    ft[:, 1:rw - 1] = (t[:, :rw - 2] + 2 * t[:, 1:rw - 1] + t[:, 2:rw] + 2) >> 2
    fl[:, rh - 1] = left[:, rh - 1]
    ft[:, rw - 1] = top[:, rw - 1]
    return ft, fl


def pack_refs(refs_list: list[IntraRefs], w: int, h: int) -> np.ndarray:
    """Stack per-block references into the unified [B, 4*REF_LEN] layout."""
    B = len(refs_list)
    top = np.stack([r.top for r in refs_list]).astype(np.int32)
    left = np.stack([r.left for r in refs_list]).astype(np.int32)
    ft, fl = filtered_refs_np(top, left, w, h)
    r = np.zeros((B, 4 * REF_LEN), dtype=np.int32)
    r[:, SEC_TOP * REF_LEN:(SEC_TOP + 1) * REF_LEN] = top
    r[:, SEC_LEFT * REF_LEN:(SEC_LEFT + 1) * REF_LEN] = left
    r[:, SEC_FTOP * REF_LEN:(SEC_FTOP + 1) * REF_LEN] = ft
    r[:, SEC_FLEFT * REF_LEN:(SEC_FLEFT + 1) * REF_LEN] = fl
    return r


def predict_one_np(tables, refs: IntraRefs, mode: int) -> np.ndarray:
    """Single-block single-mode prediction via the static tables (numpy).

    Bit-exact with ops.intra.predict_intra but ~20x faster (no Python
    per-row loops) — used by the sequential reconstruction path.
    """
    w, h = tables["w"], tables["h"]
    max_pix = (1 << tables["bitdepth"]) - 1
    r = pack_refs([refs], w, h)[0].astype(np.int64)
    if mode >= 2:
        g = r[tables["K"][mode]]
        out = (g * tables["W"][mode]).sum(-1)
        out = (out + 32) >> 6
        if tables["needs_clip"][mode]:
            out = np.clip(out, 0, max_pix)
        if tables["pdpc_on"][mode]:
            side = r[tables["pdpc_sidx"][mode]]
            out = out + ((tables["pdpc_wl"][mode] * (side - out) + 32) >> 6)
        if tables["hv_on"][mode]:
            side = r[tables["hv_sidx"][mode]]
            tl = r[tables["hv_topleft"][mode]]
            out = np.clip(out + ((tables["hv_wl"][mode] * (side - tl) + 32) >> 6),
                          0, max_pix)
        return np.clip(out, 0, max_pix).astype(np.int32)
    # planar / DC
    log2_w, log2_h = tables["log2_w"], tables["log2_h"]
    planar_filtered = (not tables["is_chroma"]) and (w * h > 32)
    if mode == 0:
        tsec = SEC_FTOP if planar_filtered else SEC_TOP
        lsec = SEC_FLEFT if planar_filtered else SEC_LEFT
        t_w = r[tsec * REF_LEN + 1:tsec * REF_LEN + 1 + w]
        l_h = r[lsec * REF_LEN + 1:lsec * REF_LEN + 1 + h]
        top_right = r[tsec * REF_LEN + w + 1]
        bottom_left = r[lsec * REF_LEN + h + 1]
        xs1 = np.arange(1, w + 1)[None, :]
        ys1 = np.arange(1, h + 1)[:, None]
        hor = (l_h[:, None] << log2_w) + (top_right - l_h[:, None]) * xs1
        ver = (t_w[None, :] << log2_h) + (bottom_left - t_w[None, :]) * ys1
        offset = 1 << (log2_w + log2_h)
        out = ((hor << log2_h) + (ver << log2_w) + offset) >> (1 + log2_w + log2_h)
    else:
        tsec, lsec = SEC_TOP, SEC_LEFT
        s = 0
        if w >= h:
            s += int(r[SEC_TOP * REF_LEN + 1:SEC_TOP * REF_LEN + 1 + w].sum())
        if w <= h:
            s += int(r[SEC_LEFT * REF_LEN + 1:SEC_LEFT * REF_LEN + 1 + h].sum())
        denom = (w << 1) if w == h else max(w, h)
        dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
        out = np.full((h, w), dc, dtype=np.int64)
    if w >= 4 and h >= 4:
        tt = r[tsec * REF_LEN + 1:tsec * REF_LEN + 1 + w][None, :]
        ll = r[lsec * REF_LEN + 1:lsec * REF_LEN + 1 + h][:, None]
        out = out + ((tables["pd_wl"][None, :] * (ll - out)
                      + tables["pd_wt"][:, None] * (tt - out) + 32) >> 6)
    return np.clip(out, 0, max_pix).astype(np.int32)


def make_predict_fn(tables):
    """Returns a jittable fn: r [B, 4*REF_LEN] int32 -> [B, 67, h, w] int32
    predictions for all modes."""
    import jax.numpy as jnp

    w, h = tables["w"], tables["h"]
    bd = tables["bitdepth"]
    log2_w, log2_h = tables["log2_w"], tables["log2_h"]
    max_pix = (1 << bd) - 1
    K = jnp.asarray(tables["K"])
    W = jnp.asarray(tables["W"])
    needs_clip = jnp.asarray(tables["needs_clip"])[None, :, None, None]
    pdpc_on = jnp.asarray(tables["pdpc_on"])[None, :, None, None]
    pdpc_wl = jnp.asarray(tables["pdpc_wl"])[None]
    pdpc_sidx = jnp.asarray(tables["pdpc_sidx"])
    hv_on = jnp.asarray(tables["hv_on"])[None, :, None, None]
    hv_topleft = jnp.asarray(tables["hv_topleft"])
    hv_sidx = jnp.asarray(tables["hv_sidx"])
    hv_wl = jnp.asarray(tables["hv_wl"])[None]
    pd_wl = jnp.asarray(tables["pd_wl"])[None, None, :]
    pd_wt = jnp.asarray(tables["pd_wt"])[None, :, None]
    apply_pd_pdpc = w >= 4 and h >= 4
    planar_filtered = (not tables["is_chroma"]) and (w * h > 32)
    psec_t = SEC_FTOP if planar_filtered else SEC_TOP
    psec_l = SEC_FLEFT if planar_filtered else SEC_LEFT

    def predict(r):
        # --- angular modes (2..66): gather + 4-tap weighted sum ---
        g = r[:, K]                               # [B, 67, h, w, 4]
        ang = (g * W[None]).sum(-1)
        ang = (ang + 32) >> 6
        ang = jnp.where(needs_clip, jnp.clip(ang, 0, max_pix), ang)

        side = r[:, pdpc_sidx]
        corr = (pdpc_wl * (side - ang) + 32) >> 6
        ang = jnp.where(pdpc_on, ang + corr, ang)

        side_hv = r[:, hv_sidx]
        topleft = r[:, hv_topleft][:, :, None, None]
        corr_hv = (hv_wl * (side_hv - topleft) + 32) >> 6
        ang = jnp.where(hv_on, jnp.clip(ang + corr_hv, 0, max_pix), ang)

        # --- planar (mode 0) ---
        t_w = r[:, psec_t * REF_LEN + 1:psec_t * REF_LEN + 1 + w]
        l_h = r[:, psec_l * REF_LEN + 1:psec_l * REF_LEN + 1 + h]
        top_right = r[:, psec_t * REF_LEN + w + 1][:, None, None]
        bottom_left = r[:, psec_l * REF_LEN + h + 1][:, None, None]
        xs1 = jnp.arange(1, w + 1)[None, None, :]
        ys1 = jnp.arange(1, h + 1)[None, :, None]
        hor = (l_h[:, :, None] << log2_w) + (top_right - l_h[:, :, None]) * xs1
        ver = (t_w[:, None, :] << log2_h) + (bottom_left - t_w[:, None, :]) * ys1
        offset = 1 << (log2_w + log2_h)
        planar = ((hor << log2_h) + (ver << log2_w) + offset) >> (1 + log2_w + log2_h)

        # --- DC (mode 1, unfiltered refs) ---
        ut = SEC_TOP * REF_LEN
        ul = SEC_LEFT * REF_LEN
        s = jnp.zeros((r.shape[0],), dtype=r.dtype)
        if w >= h:
            s = s + r[:, ut + 1:ut + 1 + w].sum(-1)
        if w <= h:
            s = s + r[:, ul + 1:ul + 1 + h].sum(-1)
        denom = (w << 1) if w == h else max(w, h)
        dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
        dcp = jnp.broadcast_to(dc[:, None, None], planar.shape)

        if apply_pd_pdpc:
            def pd_pdpc(p, tsec, lsec):
                tt = r[:, tsec * REF_LEN + 1:tsec * REF_LEN + 1 + w][:, None, :]
                ll = r[:, lsec * REF_LEN + 1:lsec * REF_LEN + 1 + h][:, :, None]
                return p + ((pd_wl * (ll - p) + pd_wt * (tt - p) + 32) >> 6)
            planar = pd_pdpc(planar, psec_t, psec_l)
            dcp = pd_pdpc(dcp, SEC_TOP, SEC_LEFT)
        planar = jnp.clip(planar, 0, max_pix)
        dcp = jnp.clip(dcp, 0, max_pix)

        return ang.at[:, 0].set(planar).at[:, 1].set(dcp)

    return predict


_PER_MODE_KEYS = ("K", "W", "needs_clip", "pdpc_on", "pdpc_wl",
                  "pdpc_sidx", "hv_on", "hv_topleft", "hv_sidx", "hv_wl")


def slice_mode_tables(tables: dict, modes) -> dict:
    """Restrict the per-mode prediction tables to a mode subset.

    The subset MUST start with [0, 1] (planar, DC) so the layout
    make_predict_fn assumes (slots 0/1 are planar/DC) still holds."""
    modes = np.asarray(modes)
    assert modes[0] == 0 and modes[1] == 1
    out = dict(tables)
    for k in _PER_MODE_KEYS:
        out[k] = tables[k][modes]
    return out


def make_predict_modes_fn(tables):
    """Returns a jittable fn (r [B, 4*REF_LEN], modes [B, R] int32 in
    [2, 66]) -> [B, R, h, w] int32: per-block ANGULAR predictions for
    dynamically chosen modes (the refine stage of the rough+refine
    search, search_intra.c:custom rough list). Bit-identical to the
    corresponding make_predict_fn slices."""
    import jax.numpy as jnp

    bd = tables["bitdepth"]
    max_pix = (1 << bd) - 1
    K = jnp.asarray(tables["K"])
    W = jnp.asarray(tables["W"])
    needs_clip = jnp.asarray(tables["needs_clip"])
    pdpc_on = jnp.asarray(tables["pdpc_on"])
    pdpc_wl = jnp.asarray(tables["pdpc_wl"])
    pdpc_sidx = jnp.asarray(tables["pdpc_sidx"])
    hv_on = jnp.asarray(tables["hv_on"])
    hv_topleft = jnp.asarray(tables["hv_topleft"])
    hv_sidx = jnp.asarray(tables["hv_sidx"])
    hv_wl = jnp.asarray(tables["hv_wl"])

    def predict_modes(r, modes):
        B = r.shape[0]
        bidx = jnp.arange(B)[:, None, None, None, None]
        Kb = K[modes]                       # [B,R,h,w,4]
        Wb = W[modes]
        g = r[bidx, Kb]
        ang = ((g * Wb).sum(-1) + 32) >> 6
        clip_b = needs_clip[modes][:, :, None, None]
        ang = jnp.where(clip_b, jnp.clip(ang, 0, max_pix), ang)

        side = r[bidx[..., 0], pdpc_sidx[modes]]
        corr = (pdpc_wl[modes] * (side - ang) + 32) >> 6
        ang = jnp.where(pdpc_on[modes][:, :, None, None], ang + corr, ang)

        side_hv = r[bidx[..., 0], hv_sidx[modes]]
        topleft = r[jnp.arange(B)[:, None], hv_topleft[modes]]
        corr_hv = (hv_wl[modes] * (side_hv - topleft[:, :, None, None])
                   + 32) >> 6
        ang = jnp.where(hv_on[modes][:, :, None, None],
                        jnp.clip(ang + corr_hv, 0, max_pix), ang)
        return ang

    return predict_modes


def make_predict_matmul_fn(tables):
    """Bit-exact twin of make_predict_fn with the angular 4-tap
    gather-and-weight replaced by ONE dense matmul.

    The angular prediction before PDPC is linear in the packed reference
    vector: pred[m,y,x] = sum_t refs[K[m,y,x,t]] * W[m,y,x,t], so all 67
    modes collapse into refs [B, 4L] x A [4L, 67hw]. Products are
    < 2^20 and 4-term sums < 2^23, so a float32 matmul at HIGHEST
    precision is exact on every backend (the sums of a column's four
    nonzero terms are integers below 2^24 in any order). Planar/DC and
    the PDPC corrections are identical to make_predict_fn.

    Returns (predict_fn, A_host): A ([4L, nm*h*w] f32, up to ~214 MB for
    32x32) is passed as a device-array ARGUMENT (device_put once by the
    caller) rather than baked into the jitted computation as a constant,
    which would put it into every compiled program."""
    import jax
    import jax.numpy as jnp

    w, h = tables["w"], tables["h"]
    bd = tables["bitdepth"]
    log2_w, log2_h = tables["log2_w"], tables["log2_h"]
    max_pix = (1 << bd) - 1
    K = tables["K"]
    Wt = tables["W"]
    nm = K.shape[0]

    needs_clip = jnp.asarray(tables["needs_clip"])[None, :, None, None]
    pdpc_on = jnp.asarray(tables["pdpc_on"])[None, :, None, None]
    pdpc_wl = jnp.asarray(tables["pdpc_wl"])[None]
    pdpc_sidx = jnp.asarray(tables["pdpc_sidx"])
    hv_on = jnp.asarray(tables["hv_on"])[None, :, None, None]
    hv_topleft = jnp.asarray(tables["hv_topleft"])
    hv_sidx = jnp.asarray(tables["hv_sidx"])
    hv_wl = jnp.asarray(tables["hv_wl"])[None]
    pd_wl = jnp.asarray(tables["pd_wl"])[None, None, :]
    pd_wt = jnp.asarray(tables["pd_wt"])[None, :, None]
    apply_pd_pdpc = w >= 4 and h >= 4
    planar_filtered = (not tables["is_chroma"]) and (w * h > 32)
    psec_t = SEC_FTOP if planar_filtered else SEC_TOP
    psec_l = SEC_FLEFT if planar_filtered else SEC_LEFT

    def predict(r, Aj):
        B = r.shape[0]
        ang = jnp.matmul(r.astype(jnp.float32), Aj,
                         precision=jax.lax.Precision.HIGHEST)
        ang = ang.astype(jnp.int32).reshape(B, nm, h, w)
        ang = (ang + 32) >> 6
        ang = jnp.where(needs_clip, jnp.clip(ang, 0, max_pix), ang)

        side = r[:, pdpc_sidx]
        corr = (pdpc_wl * (side - ang) + 32) >> 6
        ang = jnp.where(pdpc_on, ang + corr, ang)

        side_hv = r[:, hv_sidx]
        topleft = r[:, hv_topleft][:, :, None, None]
        corr_hv = (hv_wl * (side_hv - topleft) + 32) >> 6
        ang = jnp.where(hv_on, jnp.clip(ang + corr_hv, 0, max_pix), ang)

        # --- planar / DC: identical to make_predict_fn ---
        t_w = r[:, psec_t * REF_LEN + 1:psec_t * REF_LEN + 1 + w]
        l_h = r[:, psec_l * REF_LEN + 1:psec_l * REF_LEN + 1 + h]
        top_right = r[:, psec_t * REF_LEN + w + 1][:, None, None]
        bottom_left = r[:, psec_l * REF_LEN + h + 1][:, None, None]
        xs1 = jnp.arange(1, w + 1)[None, None, :]
        ys1 = jnp.arange(1, h + 1)[None, :, None]
        hor = (l_h[:, :, None] << log2_w) + (top_right - l_h[:, :, None]) * xs1
        ver = (t_w[:, None, :] << log2_h) + (bottom_left - t_w[:, None, :]) * ys1
        offset = 1 << (log2_w + log2_h)
        planar = ((hor << log2_h) + (ver << log2_w) + offset) \
            >> (1 + log2_w + log2_h)

        ut = SEC_TOP * REF_LEN
        ul = SEC_LEFT * REF_LEN
        s = jnp.zeros((B,), dtype=r.dtype)
        if w >= h:
            s = s + r[:, ut + 1:ut + 1 + w].sum(-1)
        if w <= h:
            s = s + r[:, ul + 1:ul + 1 + h].sum(-1)
        denom = (w << 1) if w == h else max(w, h)
        dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
        dcp = jnp.broadcast_to(dc[:, None, None], planar.shape)

        if apply_pd_pdpc:
            def pd_pdpc(p, tsec, lsec):
                tt = r[:, tsec * REF_LEN + 1:tsec * REF_LEN + 1 + w][:, None, :]
                ll = r[:, lsec * REF_LEN + 1:lsec * REF_LEN + 1 + h][:, :, None]
                return p + ((pd_wl * (ll - p) + pd_wt * (tt - p) + 32) >> 6)
            planar = pd_pdpc(planar, psec_t, psec_l)
            dcp = pd_pdpc(dcp, SEC_TOP, SEC_LEFT)
        planar = jnp.clip(planar, 0, max_pix)
        dcp = jnp.clip(dcp, 0, max_pix)

        return ang.at[:, 0].set(planar).at[:, 1].set(dcp)

    A = np.zeros((nm * h * w, 4 * REF_LEN), dtype=np.float32)
    rows = np.arange(nm * h * w).repeat(4)
    np.add.at(A, (rows, K.reshape(-1)), Wt.reshape(-1).astype(np.float32))
    return predict, A.T.copy()


def make_satd67_fn(w: int, h: int):
    """Returns jittable fn (preds [B, 67, h, w], src [B, h, w]) -> [B, 67]
    SATD costs (reference-exact Hadamard with DC down-weighting)."""
    import jax.numpy as jnp

    n = 8 if (w >= 8 and h >= 8) else 4
    add, shift = (2, 2) if n == 8 else (1, 1)
    hm = np.array([[1]], dtype=np.int64)
    while hm.shape[0] < n:
        hm = np.block([[hm, hm], [hm, -hm]])
    hmj = jnp.asarray(hm.astype(np.int32))

    def satd67(preds, src):
        # exact int32 matmuls: the 8x8 Hadamard factors are tiny, and
        # an f32 form would only add casts
        d = src[:, None].astype(jnp.int32) - preds
        B, M = d.shape[0], d.shape[1]
        d = d.reshape(B, M, h // n, n, w // n, n)
        d = jnp.swapaxes(d, 3, 4)                 # [B,M,bh,bw,n,n]
        t = jnp.abs(jnp.matmul(jnp.matmul(hmj, d,
                                          preferred_element_type=jnp.int32),
                               hmj, preferred_element_type=jnp.int32))
        s = t.sum(axis=(-2, -1))
        dc = t[..., 0, 0]
        s = s - dc + (dc >> 2)
        s = (s + add) >> shift
        return s.sum(axis=(-2, -1))

    return satd67


def make_refs_blocks_fn(w: int, h: int):
    """jit-able device-side twin of build_refs_grid + block gather.

    (src [H,W] int32 on device, xs, ys [B]) -> (refs [B,4*REF_LEN],
    blocks [B,h,w]). Keeps the whole search input pipeline on device: the
    host transfers the source plane once per frame instead of building
    per-size reference/block tensors."""
    import jax.numpy as jnp
    L = REF_LEN
    Lt = min(3 * w + 3, L)
    Ll = min(3 * h + 3, L)
    pad = max(Lt, Ll) + 2
    rw = 2 * w + 1
    rh = 2 * h + 1

    def fn(src, xs, ys):
        P = jnp.pad(src, ((1, pad), (1, pad)), mode="edge")
        top = P[ys[:, None], xs[:, None] + jnp.arange(Lt)[None, :]]
        left = P[ys[:, None] + jnp.arange(Ll)[None, :], xs[:, None]]
        if Lt < L:
            top = jnp.concatenate(
                [top, jnp.broadcast_to(top[:, -1:], (top.shape[0], L - Lt))],
                axis=1)
        if Ll < L:
            left = jnp.concatenate(
                [left,
                 jnp.broadcast_to(left[:, -1:], (left.shape[0], L - Ll))],
                axis=1)
        # [1 2 1]/4 smoothing (filtered_refs_np twin)
        t = top.astype(jnp.int32)         # 4-tap sums of samples < 2^12
        l = left.astype(jnp.int32)
        f0 = (l[:, 1] + 2 * l[:, 0] + t[:, 1] + 2) >> 2
        fl_mid = (l[:, :-2] + 2 * l[:, 1:-1] + l[:, 2:] + 2) >> 2
        ft_mid = (t[:, :-2] + 2 * t[:, 1:-1] + t[:, 2:] + 2) >> 2
        fl = left.at[:, 1:rh - 1].set(fl_mid[:, :rh - 2].astype(jnp.int32))
        ft = top.at[:, 1:rw - 1].set(ft_mid[:, :rw - 2].astype(jnp.int32))
        fl = fl.at[:, 0].set(f0.astype(jnp.int32))
        ft = ft.at[:, 0].set(f0.astype(jnp.int32))
        fl = fl.at[:, rh - 1].set(left[:, rh - 1])
        ft = ft.at[:, rw - 1].set(top[:, rw - 1])
        refs = jnp.concatenate([top, left, ft, fl], axis=1)
        blocks = src[ys[:, None, None] + jnp.arange(h)[None, :, None],
                     xs[:, None, None] + jnp.arange(w)[None, None, :]]
        return refs, blocks

    return fn


def _smooth_pack(jnp, top, left, w, h):
    """[1 2 1]/4 smoothing + 4-section packing (shared by the gather and
    grid reference builders; twin of filtered_refs_np/pack_refs)."""
    rw = 2 * w + 1
    rh = 2 * h + 1
    t = top.astype(jnp.int32)             # 4-tap sums of samples < 2^12
    l = left.astype(jnp.int32)
    f0 = (l[:, 1] + 2 * l[:, 0] + t[:, 1] + 2) >> 2
    fl_mid = (l[:, :-2] + 2 * l[:, 1:-1] + l[:, 2:] + 2) >> 2
    ft_mid = (t[:, :-2] + 2 * t[:, 1:-1] + t[:, 2:] + 2) >> 2
    fl = left.at[:, 1:rh - 1].set(fl_mid[:, :rh - 2].astype(jnp.int32))
    ft = top.at[:, 1:rw - 1].set(ft_mid[:, :rw - 2].astype(jnp.int32))
    fl = fl.at[:, 0].set(f0.astype(jnp.int32))
    ft = ft.at[:, 0].set(f0.astype(jnp.int32))
    fl = fl.at[:, rh - 1].set(left[:, rh - 1])
    ft = ft.at[:, rw - 1].set(top[:, rw - 1])
    return jnp.concatenate([top, left, ft, fl], axis=1)


def make_refs_blocks_grid_fn(w: int, h: int, grid):
    """Gather-free twin of make_refs_blocks_fn for a STATIC regular grid
    of positions (x0 + bx*sx, y0 + by*sy), raster order.

    All index arithmetic is static, so the whole input pipeline lowers to
    strided slices + reshapes + concats, with no XLA gather. Bit-exact
    with make_refs_blocks_fn on the same positions
    (test_intra_batch.py::test_grid_refs_blocks).

    grid: (x0, y0, sx, sy, gx, gy). Returns fn(src [H,W], refsrc=None) ->
    (refs [gx*gy, 4*REF_LEN], blocks [gx*gy, h, w]). refsrc: optional
    separate plane the top/left references are read from (e.g. the
    QP-matched pseudo-recon in inter slices) while blocks still come
    from src.
    """
    import jax.numpy as jnp

    x0, y0, sx, sy, gx, gy = grid
    L = REF_LEN
    Lt = min(3 * w + 3, L)
    Ll = min(3 * h + 3, L)
    ct = -(-Lt // sx)                   # top chunks of width sx
    cl = -(-Ll // sy)                   # left chunks of height sy
    B = gx * gy

    def fn(src, refsrc=None):
        H, W = src.shape
        # one edge-pad covers refs (top/left at -1, extensions beyond the
        # frame) and the block reshape overshoot for offset grids
        pad_r = y0 + (gy + cl) * sy + 2 - (H + 1)
        pad_c = x0 + (gx + ct) * sx + 2 - (W + 1)
        pads = ((1, max(pad_r, 1)), (1, max(pad_c, 1)))
        Pb = jnp.pad(src, pads, mode="edge")
        P = Pb if refsrc is None else jnp.pad(refsrc, pads, mode="edge")

        # top references: rows y0, y0+sy, ... sliced into sx-wide chunks;
        # the window starting at bx*sx is chunks bx..bx+ct of its row
        rows = P[y0:y0 + gy * sy:sy, x0:x0 + (gx + ct) * sx]
        rows = rows.reshape(gy, gx + ct, sx)
        top = jnp.concatenate(
            [rows[:, k:k + gx, :] for k in range(ct)], axis=2)[:, :, :Lt]
        top = top.reshape(B, Lt)

        # left references: columns x0, x0+sx, ... sliced into sy chunks
        cols = P[y0:y0 + (gy + cl) * sy, x0:x0 + gx * sx:sx]
        cols = cols.reshape(gy + cl, sy, gx)
        left = jnp.concatenate(
            [cols[k:k + gy].transpose(0, 2, 1) for k in range(cl)],
            axis=2)[:, :, :Ll]
        left = left.reshape(B, Ll)

        if Lt < L:
            top = jnp.concatenate(
                [top, jnp.broadcast_to(top[:, -1:], (B, L - Lt))], axis=1)
        if Ll < L:
            left = jnp.concatenate(
                [left, jnp.broadcast_to(left[:, -1:], (B, L - Ll))], axis=1)
        refs = _smooth_pack(jnp, top, left, w, h)

        # blocks: strided-slice + reshape (no gather)
        blk = Pb[1 + y0:1 + y0 + gy * sy, 1 + x0:1 + x0 + gx * sx]
        blk = blk.reshape(gy, sy, gx, sx)[:, :h, :, :w]
        blocks = blk.transpose(0, 2, 1, 3).reshape(B, h, w)
        return refs, blocks

    return fn


def grid_of_positions(positions, w: int, h: int):
    """Detect a raster-ordered regular grid in a position list; returns
    (x0, y0, sx, sy, gx, gy) or None. The partition search always emits
    such grids (full aligned grids and TT offset grids)."""
    if not positions:
        return None
    xs = sorted({p[0] for p in positions})
    ys = sorted({p[1] for p in positions})
    gx, gy = len(xs), len(ys)
    if gx * gy != len(positions):
        return None
    sx = xs[1] - xs[0] if gx > 1 else w
    sy = ys[1] - ys[0] if gy > 1 else h
    if sx <= 0 or sy <= 0:
        return None
    if any(xs[i] != xs[0] + i * sx for i in range(gx)):
        return None
    if any(ys[i] != ys[0] + i * sy for i in range(gy)):
        return None
    expect = [(xs[0] + bx * sx, ys[0] + by * sy)
              for by in range(gy) for bx in range(gx)]
    if expect != list(positions):
        return None
    return (xs[0], ys[0], sx, sy, gx, gy)


def build_refs_grid(src: np.ndarray, positions, w: int, h: int) -> np.ndarray:
    """Vectorized open-loop reference construction for same-size blocks.

    Search-side approximation of build_reference: availability = picture
    bounds (everything left/above), unavailable samples edge-replicated.
    Exact reconstruction still uses the spec-exact per-block path; this
    only feeds the batched mode search. Returns the packed [B, 4*REF_LEN]
    layout of pack_refs.
    """
    B = len(positions)
    Lt = min(3 * w + 3, REF_LEN)
    Ll = min(3 * h + 3, REF_LEN)
    pad = max(Lt, Ll) + 2
    P = np.pad(src, ((1, pad), (1, pad)), mode="edge").astype(np.int32)
    xs = np.asarray([p[0] for p in positions])
    ys = np.asarray([p[1] for p in positions])
    top = np.zeros((B, REF_LEN), dtype=np.int32)
    left = np.zeros((B, REF_LEN), dtype=np.int32)
    # top[i] = orig(y-1, x-1+i) -> P[y, x+i]
    top[:, :Lt] = P[ys[:, None], xs[:, None] + np.arange(Lt)[None, :]]
    # left[i] = orig(y-1+i, x-1) -> P[y+i, x]
    left[:, :Ll] = P[ys[:, None] + np.arange(Ll)[None, :], xs[:, None]]
    # fill tails with the last value (harmless; beyond use)
    top[:, Lt:] = top[:, Lt - 1:Lt]
    left[:, Ll:] = left[:, Ll - 1:Ll]
    ft, fl = filtered_refs_np(top, left, w, h)
    r = np.zeros((B, 4 * REF_LEN), dtype=np.int32)
    r[:, SEC_TOP * REF_LEN:(SEC_TOP + 1) * REF_LEN] = top
    r[:, SEC_LEFT * REF_LEN:(SEC_LEFT + 1) * REF_LEN] = left
    r[:, SEC_FTOP * REF_LEN:(SEC_FTOP + 1) * REF_LEN] = ft
    r[:, SEC_FLEFT * REF_LEN:(SEC_FLEFT + 1) * REF_LEN] = fl
    return r
